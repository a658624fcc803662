// Paged decode attention over a shared KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_attention_pallas (body _paged_kernel): one query row per slot, K/V
// fetched page-wise through the page table, f32 logits and f32
// probabilities into P V (p is never rounded), positions < length valid
// (and >= length - window with a window), optional tanh softcap, output
// acc / max(l, 1e-30) so an empty slot gives exact zeros. Pages wholly past
// the length, or wholly behind the window, are never read.
//
// What bounds it on this card: bytes. A live token costs 2 * hd * 2 bytes
// of K/V per kv head and 4 * G * hd FLOPs, 2 FLOP/byte at G = 8, so the
// design is about reading each live K/V row once, with enough bytes in
// flight on every SM:
//
//  * The pages of a slot are split across CTAs. The grid is (split, kv
//    head, slot); a split owns a fixed run of `pps` logical pages, sized
//    by the host from the table width maxp alone (the host never reads
//    the lengths). A CTA whose run lies wholly past the length, or behind
//    the window, reads no K/V and reports l = 0.
//  * Each CTA runs page / 4 warps, and a warp owns 4 tokens of every page
//    (warp w: tokens 4w .. 4w + 3) with its own online-softmax state
//    (m, l, acc) for the G query rows of the kv head. So the page loop has
//    no CTA barrier: a warp brings its own K/V rows (16-byte cp.async,
//    rows past the length or behind the window zero-filled and not read)
//    through a private ring of kStages pages, and page j + 1 lands while
//    page j is computed.
//  * A lane owns DPL = hd / 32 (rounded up to 2, 4 or 8) contiguous
//    dimensions. The G x 4 logits of a page come from G x 4 partial dot
//    products a lane, summed over the warp by a transpose reduction (31
//    shuffles for 32 sums, after which each lane holds one (row, token)
//    logit); the softmax's max and sum over the 4 tokens take 2 shuffles
//    each, and every lane then reads the 4 probabilities and the rescale
//    of each row from the warp's shared scratch for P V.
//  * int8 pools convert 4 bytes at a time without I2F (a byte permute and
//    one subtraction, as esffn.cu's stream route) and take each row's f32
//    scale once: K's after the dot product, V's on the row.
//  * At the end the warps' states merge in warp order through shared
//    memory. With one split the CTA writes the output. With more, it
//    writes its partial (m, l, acc) in f32 to a workspace, and the last
//    CTA of its (slot, head) to finish (a __threadfence and an atomic
//    ticket per (slot, head)) merges the partials in split order, so the
//    output is bitwise the same from call to call, writes the output and
//    resets the ticket to 0 for the next call. One launch a call.
//
// int8 pools (paged_attention_q_launch; the quantized branch of
// _paged_kernel): K and V pages hold int8 rows, each (row, kv head) with
// its own f32 scale in k_scale / v_scale pools (npages, page, Hkv) paged
// through the same table; a live token then costs 2 * (hd + 4) bytes a kv
// head instead of 2 * 2 * hd.
//
// Plain C interface for ctypes: paged_attention_launch and
// paged_attention_q_launch return cudaGetLastError(), or
// cudaErrorInvalidValue for shapes they refuse.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -2.0e38f;  // NEG_INF of the reference
constexpr int kTPW = 4;              // tokens of a page a warp owns
constexpr int kMaxWarps = 8;         // pages of up to 32 tokens
constexpr int kMaxG = 16;            // query rows of a kv head
constexpr int kMaxSplits = 64;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A warp's stage: kTPW K rows and kTPW V rows of up to 32 * DPL elements,
// then (int8 pools) the kTPW K and kTPW V row scales.
template <typename KV, int DPL>
struct Cfg {
  static constexpr int kHd = 32 * DPL;  // elements of a staged row
  static constexpr int kRowBytes = kHd * (int)sizeof(KV);
  static constexpr bool kQuant = std::is_same<KV, int8_t>::value;
  static constexpr int kStageBytes = 2 * kTPW * kRowBytes + (kQuant ? 2 * kTPW * 4 : 0);
  static constexpr int kRaw = 8192 / kStageBytes;  // about 8 KB in flight a warp
  static constexpr int kStages = kRaw < 2 ? 2 : (kRaw > 4 ? 4 : kRaw);
  static_assert(kRowBytes % 16 == 0, "staged rows are whole 16-byte chunks");
};

// DPL contiguous elements of a staged row, as f32 (int8 exactly, without
// I2F: float(q) = (2^23 + (q ^ 0x80)) - (2^23 + 128)).
template <int DPL>
__device__ __forceinline__ void load_row(const float* p, float (&o)[DPL]) {
#pragma unroll
  for (int i = 0; i < DPL; i += 2) {
    const float2 v = *reinterpret_cast<const float2*>(p + i);
    o[i] = v.x;
    o[i + 1] = v.y;
  }
}
template <int DPL>
__device__ __forceinline__ void load_row(const __nv_bfloat16* p, float (&o)[DPL]) {
#pragma unroll
  for (int i = 0; i < DPL; i += 2) {
    const float2 v = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p + i));
    o[i] = v.x;
    o[i + 1] = v.y;
  }
}
template <int DPL>
__device__ __forceinline__ void load_row(const int8_t* p, float (&o)[DPL]) {
  if constexpr (DPL == 2) {
    const uint32_t w = (uint32_t)*reinterpret_cast<const uint16_t*>(p) ^ 0x8080u;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      o[i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)) - 8388736.0f;
  } else {
#pragma unroll
    for (int j = 0; j < DPL / 4; ++j) {
      const uint32_t w = reinterpret_cast<const uint32_t*>(p)[j] ^ 0x80808080u;
#pragma unroll
      for (int i = 0; i < 4; ++i)
        o[4 * j + i] = __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | i)) - 8388736.0f;
    }
  }
}

// Sums each of the V values of every lane over the warp. Afterwards lane l
// holds the total of value l >> (5 - log2 V) (V <= 32, a power of 2): each
// step hands half of the N values still held to the partner lane O away.
template <int N, int O, int V>
__device__ __forceinline__ void transpose_reduce(float (&v)[V], int lane) {
  static_assert(V <= 32 && (V & (V - 1)) == 0, "V: a power of 2 up to 32");
  if constexpr (O >= 1) {
    if constexpr (N >= 2) {
      const bool up = lane & O;
#pragma unroll
      for (int i = 0; i < N / 2; ++i) {
        const float send = up ? v[i] : v[i + N / 2];
        const float keep = up ? v[i + N / 2] : v[i];
        v[i] = keep + __shfl_xor_sync(kFull, send, O);
      }
      transpose_reduce<N / 2, O / 2>(v, lane);
    } else {
      v[0] += __shfl_xor_sync(kFull, v[0], O);
      transpose_reduce<1, O / 2>(v, lane);
    }
  }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(hopper::smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

struct Args {
  const void* q;
  const void* k_pool;
  const void* v_pool;
  const float* k_scale;
  const float* v_scale;
  const int* page_table;
  const int* lengths;
  void* out;
  float* partials;  // (B, Hkv, splits, G * hd + 2 * G) f32; null at one split
  int* tickets;     // (B, Hkv), 0 between calls; null at one split
  int hq, hkv, hd, page, maxp, pps, window;
  float softcap, scale;
};

// T: q and out; KV: the pools' storage (T, or int8_t with row scales).
// GP >= G query rows a kv head (a power of 2), DPL dimensions a lane.
template <typename T, typename KV, int DPL, int GP>
__global__ void __launch_bounds__(kMaxWarps * 32)
paged_attention_kernel(const Args a) {
  using C = Cfg<KV, DPL>;
  constexpr int kV = GP * kTPW;                 // partial sums a lane, a page
  constexpr int kNch = kV > 32 ? kV / 32 : 1;   // transpose reductions a page
  constexpr int kVpc = kV / kNch;
  constexpr int kGpc = GP / kNch;               // query rows a reduction
  constexpr int kSh = kVpc == 32 ? 0 : kVpc == 16 ? 1 : kVpc == 8 ? 2 : kVpc == 4 ? 3 : 4;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ __align__(16) float pbuf[kMaxWarps][GP][8];  // p of 4 tokens, rescale
  __shared__ float ms[kMaxWarps][GP], ls[kMaxWarps][GP];
  __shared__ float fs[kMaxSplits][GP];       // a split's weight in the merge
  __shared__ float ml_all[kMaxSplits * 2 * GP];
  __shared__ float mg[GP], lg[GP];
  __shared__ int last_s;

  const int s = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int nsplit = gridDim.x;
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  const int hd = a.hd, g_n = a.hq / a.hkv;
  const bool on = lane * DPL < hd;  // this lane's dimensions exist
  const int len = a.lengths[b];
  const int lo = a.window > 0 ? max(len - a.window, 0) : 0;

  // the split's live pages: [j0, j1) of its run [s * pps, (s + 1) * pps)
  const int j_hi = min((len + a.page - 1) / a.page, a.maxp);
  const int j_lo = lo / a.page;
  const int j0 = max(s * a.pps, j_lo);
  const int j1 = min((s + 1) * a.pps, j_hi);
  const int np = max(j1 - j0, 0);

  float qr[GP][DPL], acc[GP][DPL];
  const T* q = reinterpret_cast<const T*>(a.q) + ((size_t)b * a.hq + (size_t)h * g_n) * hd;
#pragma unroll
  for (int g = 0; g < GP; ++g)
#pragma unroll
    for (int i = 0; i < DPL; ++i) {
      qr[g][i] = (g < g_n && on) ? to_f(q[(size_t)g * hd + lane * DPL + i]) : 0.0f;
      acc[g][i] = 0.0f;
    }
  float m_l[kNch], l_l[kNch];
#pragma unroll
  for (int c = 0; c < kNch; ++c) {
    m_l[c] = kNegInf;
    l_l[c] = 0.0f;
  }
  // this lane's (query row, token) after a transpose reduction
  const int vi = lane >> kSh, gi = vi >> 2, tt = vi & 3;

  // The warp's copies of a page, planned once: copy i of this lane is
  // 16-byte chunk c = lane + 32 i of the page's 8 staged rows (rows r < 4
  // are K, r >= 4 V, token r & 3), at element offset src_off[i] from the
  // page's first row of this kv head; only the page's base changes.
  constexpr int kMaxCopies = (2 * kTPW * C::kRowBytes / 16 + 31) / 32;
  const int cpr = hd * (int)sizeof(KV) / 16;  // 16-byte chunks a row
  int src_off[kMaxCopies], dst_off[kMaxCopies], tok[kMaxCopies];
#pragma unroll
  for (int i = 0; i < kMaxCopies; ++i) {
    const int c = lane + 32 * i;
    const int r = c / cpr, ch = c - r * cpr;
    tok[i] = c < 2 * kTPW * cpr ? r : -1;  // row r, or no copy
    src_off[i] = (r & (kTPW - 1)) * a.hkv * hd + ch * (16 / (int)sizeof(KV));
    dst_off[i] = r * C::kRowBytes + ch * 16;
  }
  const KV* k_pool = reinterpret_cast<const KV*>(a.k_pool);
  const KV* v_pool = reinterpret_cast<const KV*>(a.v_pool);
  uint8_t* ring = smem + (size_t)w * C::kStages * C::kStageBytes;

  auto issue = [&](int it) {
    const int j = j0 + it;
    const size_t phys = (size_t)a.page_table[(size_t)b * a.maxp + j];
    uint8_t* st = ring + (it % C::kStages) * C::kStageBytes;
    const size_t row0 = (phys * a.page + kTPW * w) * a.hkv + h;  // token 4w's row
    const int kpos0 = j * a.page + kTPW * w;
    const bool all = kpos0 >= lo && kpos0 + kTPW <= len;  // the warp's 4 tokens live
#pragma unroll
    for (int i = 0; i < kMaxCopies; ++i) {
      if (tok[i] < 0) continue;
      const int t = tok[i] & (kTPW - 1);
      const bool valid = all || (kpos0 + t < len && kpos0 + t >= lo);
      const KV* src = (tok[i] < kTPW ? k_pool : v_pool) + row0 * hd + src_off[i];
      hopper::cp_async16(st + dst_off[i], valid ? src : k_pool, valid);
    }
    if constexpr (C::kQuant) {
      if (lane < 2 * kTPW) {
        const int t = lane & (kTPW - 1);
        const bool valid = all || (kpos0 + t < len && kpos0 + t >= lo);
        const float* sc = lane < kTPW ? a.k_scale : a.v_scale;
        cp_async4(st + 2 * kTPW * C::kRowBytes + lane * 4,
                  valid ? sc + row0 + (size_t)t * a.hkv : a.k_scale, valid);
      }
    }
  };

#pragma unroll
  for (int i = 0; i < C::kStages - 1; ++i) {
    if (i < np) issue(i);
    hopper::cp_async_commit();
  }
  for (int it = 0; it < np; ++it) {
    hopper::cp_async_wait<C::kStages - 2>();
    __syncwarp();  // the page's rows are in; the warp is done with page it - 1
    if (it + C::kStages - 1 < np) issue(it + C::kStages - 1);
    hopper::cp_async_commit();

    const int j = j0 + it;
    const uint8_t* st = ring + (it % C::kStages) * C::kStageBytes;
    const KV* krows = reinterpret_cast<const KV*>(st);
    const KV* vrows = reinterpret_cast<const KV*>(st + kTPW * C::kRowBytes);
    float kf[kTPW][DPL];
#pragma unroll
    for (int t = 0; t < kTPW; ++t) {
      if (on) {
        load_row<DPL>(krows + t * C::kHd + lane * DPL, kf[t]);
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) kf[t][i] = 0.0f;
      }
    }
    const int kpos = j * a.page + kTPW * w + tt;
    const bool valid = kpos < len && kpos >= lo;
    float ksc = 1.0f;
    if constexpr (C::kQuant) ksc = reinterpret_cast<const float*>(st + 2 * kTPW * C::kRowBytes)[tt];
    bool rescale = false;  // some row's max moved on this page
#pragma unroll
    for (int c = 0; c < kNch; ++c) {
      float part[kVpc];
#pragma unroll
      for (int g = 0; g < kGpc; ++g)
#pragma unroll
        for (int t = 0; t < kTPW; ++t) {
          float acc_d = 0.0f;
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc_d = fmaf(qr[c * kGpc + g][i], kf[t][i], acc_d);
          part[g * kTPW + t] = acc_d;
        }
      transpose_reduce<kVpc, 16>(part, lane);
      float sv = part[0];
      if constexpr (C::kQuant) sv *= ksc;
      sv *= a.scale;
      if (a.softcap > 0.0f) sv = tanhf(sv / a.softcap) * a.softcap;
      float mx = valid ? sv : kNegInf;
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1 << kSh));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2 << kSh));
      const float m_new = fmaxf(m_l[c], mx);
      const float alpha = expf(m_l[c] - m_new);
      const float p = valid ? expf(sv - m_new) : 0.0f;
      float psum = p + __shfl_xor_sync(kFull, p, 1 << kSh);
      psum += __shfl_xor_sync(kFull, psum, 2 << kSh);
      l_l[c] = l_l[c] * alpha + psum;
      m_l[c] = m_new;
      rescale |= alpha != 1.0f;
      pbuf[w][c * kGpc + gi][tt] = p;
      if (tt == 0) pbuf[w][c * kGpc + gi][4] = alpha;
    }
    rescale = __any_sync(kFull, rescale);
    __syncwarp();
    float vf[kTPW][DPL];
#pragma unroll
    for (int t = 0; t < kTPW; ++t) {
      if (on) {
        load_row<DPL>(vrows + t * C::kHd + lane * DPL, vf[t]);
        if constexpr (C::kQuant) {
          const float vs = reinterpret_cast<const float*>(st + 2 * kTPW * C::kRowBytes)[kTPW + t];
#pragma unroll
          for (int i = 0; i < DPL; ++i) vf[t][i] *= vs;
        }
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) vf[t][i] = 0.0f;
      }
    }
#pragma unroll
    for (int g = 0; g < GP; ++g) {
      if (g >= g_n) break;
      const float4 p4 = *reinterpret_cast<const float4*>(&pbuf[w][g][0]);
      const float al = rescale ? pbuf[w][g][4] : 1.0f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        float x = rescale ? acc[g][i] * al : acc[g][i];
        x = fmaf(p4.x, vf[0][i], x);
        x = fmaf(p4.y, vf[1][i], x);
        x = fmaf(p4.z, vf[2][i], x);
        acc[g][i] = fmaf(p4.w, vf[3][i], x);
      }
    }
  }
  hopper::cp_async_wait<0>();

  // ---- the warps' states, merged in warp order --------------------------
  float* red = reinterpret_cast<float*>(smem);  // [nw][GP][kHd], over the ring
#pragma unroll
  for (int c = 0; c < kNch; ++c)
    if (tt == 0 && (lane & ((1 << kSh) - 1)) == 0) {
      ms[w][c * kGpc + gi] = m_l[c];
      ls[w][c * kGpc + gi] = l_l[c];
    }
  __syncthreads();  // every warp is past its ring, and ms / ls are in
#pragma unroll
  for (int g = 0; g < GP; ++g) {
    if (g >= g_n) break;
    float mx = kNegInf;
    for (int v = 0; v < nw; ++v) mx = fmaxf(mx, ms[v][g]);
    const float f = expf(ms[w][g] - mx);
#pragma unroll
    for (int i = 0; i < DPL; ++i) red[((size_t)w * GP + g) * C::kHd + lane * DPL + i] = acc[g][i] * f;
  }
  if (threadIdx.x < g_n) {
    const int g = threadIdx.x;
    float mx = kNegInf;
    for (int v = 0; v < nw; ++v) mx = fmaxf(mx, ms[v][g]);
    float l = 0.0f;
    for (int v = 0; v < nw; ++v) l += ls[v][g] * expf(ms[v][g] - mx);
    mg[g] = mx;
    lg[g] = l;
  }
  __syncthreads();

  // the CTA's sum over the warps of 4 consecutive dimensions of row g
  auto warp_sum4 = [&](int g, int d) {
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int v = 0; v < nw; ++v) {
      const float4 r = *reinterpret_cast<const float4*>(&red[((size_t)v * GP + g) * C::kHd + d]);
      x.x += r.x;
      x.y += r.y;
      x.z += r.z;
      x.w += r.w;
    }
    return x;
  };
  T* out = reinterpret_cast<T*>(a.out) + ((size_t)b * a.hq + (size_t)h * g_n) * hd;
  auto store4 = [&](int e0, int g, float4 x) {
    const float l = fmaxf(lg[g], 1e-30f);
    out[e0] = from_f<T>(x.x / l);
    out[e0 + 1] = from_f<T>(x.y / l);
    out[e0 + 2] = from_f<T>(x.z / l);
    out[e0 + 3] = from_f<T>(x.w / l);
  };
  const int gh = g_n * hd;  // elements of a partial acc (hd % 4 == 0)
  if (nsplit == 1) {
    for (int e0 = 4 * threadIdx.x; e0 < gh; e0 += 4 * blockDim.x) {
      const int g = e0 / hd;
      store4(e0, g, warp_sum4(g, e0 - g * hd));
    }
    return;
  }

  // ---- more than one split: the partial, then the last CTA's merge ------
  // partials: acc (B, Hkv, splits, G * hd), then (m, l) (B, Hkv, splits, 2G)
  const size_t bh = (size_t)b * a.hkv + h;
  float* accs = a.partials + bh * nsplit * gh;
  float* mls = a.partials + (size_t)gridDim.z * a.hkv * nsplit * gh + bh * nsplit * 2 * g_n;
  if (np > 0)
    for (int e0 = 4 * threadIdx.x; e0 < gh; e0 += 4 * blockDim.x) {
      const int g = e0 / hd;
      *reinterpret_cast<float4*>(accs + (size_t)s * gh + e0) = warp_sum4(g, e0 - g * hd);
    }
  if (threadIdx.x < g_n) {
    mls[s * 2 * g_n + threadIdx.x] = mg[threadIdx.x];
    mls[s * 2 * g_n + g_n + threadIdx.x] = np > 0 ? lg[threadIdx.x] : 0.0f;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last_s = atomicAdd(a.tickets + bh, 1) == nsplit - 1;
  __syncthreads();
  if (!last_s) return;
  __threadfence();

  for (int i = threadIdx.x; i < nsplit * 2 * g_n; i += blockDim.x) ml_all[i] = __ldcg(mls + i);
  __syncthreads();
  if (threadIdx.x < g_n) {
    // each split's weight exp(m_s - M) (0 for a split with no live page)
    const int g = threadIdx.x;
    float mx = kNegInf;
    for (int v = 0; v < nsplit; ++v)
      if (ml_all[v * 2 * g_n + g_n + g] > 0.0f) mx = fmaxf(mx, ml_all[v * 2 * g_n + g]);
    float l = 0.0f;
    for (int v = 0; v < nsplit; ++v) {
      const float lv = ml_all[v * 2 * g_n + g_n + g];
      const float f = lv > 0.0f ? expf(ml_all[v * 2 * g_n + g] - mx) : 0.0f;
      fs[v][g] = f;
      l += f * lv;
    }
    lg[g] = l;
  }
  __syncthreads();
  // split order; the loads of 8 splits (for two groups of 4 elements) in
  // flight at once
  for (int base = 4 * threadIdx.x; base < gh; base += 8 * blockDim.x) {
    const int e1 = base + 4 * blockDim.x;
    const bool two = e1 < gh;
    const int g0 = base / hd, g1 = two ? e1 / hd : g0;
    float4 x0 = make_float4(0.0f, 0.0f, 0.0f, 0.0f), x1 = x0;
    for (int v0 = 0; v0 < nsplit; v0 += 8) {
      float4 r0[8], r1[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int v = v0 + u;
        const bool on0 = v < nsplit && fs[v][g0] != 0.0f;
        const bool on1 = two && v < nsplit && fs[v][g1] != 0.0f;
        const float* p = accs + (size_t)v * gh;
        r0[u] = on0 ? __ldcg(reinterpret_cast<const float4*>(p + base)) : make_float4(0.f, 0.f, 0.f, 0.f);
        r1[u] = on1 ? __ldcg(reinterpret_cast<const float4*>(p + e1)) : make_float4(0.f, 0.f, 0.f, 0.f);
      }
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        const int v = v0 + u;
        if (v >= nsplit) break;
        const float f0 = fs[v][g0], f1 = fs[v][g1];
        x0 = make_float4(fmaf(f0, r0[u].x, x0.x), fmaf(f0, r0[u].y, x0.y),
                         fmaf(f0, r0[u].z, x0.z), fmaf(f0, r0[u].w, x0.w));
        x1 = make_float4(fmaf(f1, r1[u].x, x1.x), fmaf(f1, r1[u].y, x1.y),
                         fmaf(f1, r1[u].z, x1.z), fmaf(f1, r1[u].w, x1.w));
      }
    }
    store4(base, g0, x0);
    if (two) store4(e1, g1, x1);
  }
  if (threadIdx.x == 0) a.tickets[bh] = 0;  // ready for the next call
}

template <typename T, typename KV, int DPL, int GP>
int launch_g(const Args& a, int b, int nsplit, cudaStream_t stream) {
  using C = Cfg<KV, DPL>;
  const int nw = a.page / kTPW;
  const size_t ring = (size_t)nw * C::kStages * C::kStageBytes;
  const size_t red = (size_t)nw * GP * C::kHd * sizeof(float);
  const size_t bytes = ring > red ? ring : red;
  auto kernel = paged_attention_kernel<T, KV, DPL, GP>;
  // the static arrays and the dynamic part may pass 48 KB together
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(nsplit, a.hkv, b), nw * 32, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

template <typename T, typename KV, int DPL>
int launch_d(const Args& a, int b, int nsplit, cudaStream_t stream) {
  const int g = a.hq / a.hkv;
  if (g <= 1) return launch_g<T, KV, DPL, 1>(a, b, nsplit, stream);
  if (g <= 2) return launch_g<T, KV, DPL, 2>(a, b, nsplit, stream);
  if (g <= 4) return launch_g<T, KV, DPL, 4>(a, b, nsplit, stream);
  if (g <= 8) return launch_g<T, KV, DPL, 8>(a, b, nsplit, stream);
  return launch_g<T, KV, DPL, 16>(a, b, nsplit, stream);
}

template <typename T, typename KV>
int launch(const Args& a, int b, cudaStream_t stream) {
  const int g = a.hq / a.hkv;
  if (b < 1 || a.hkv < 1 || a.hq % a.hkv || g > kMaxG || a.hd % 16 || a.hd < 16 ||
      a.hd > 256 || a.page % kTPW || a.page < kTPW || a.page > kTPW * kMaxWarps ||
      a.maxp < 1 || a.pps < 1)
    return (int)cudaErrorInvalidValue;
  const int nsplit = (a.maxp + a.pps - 1) / a.pps;
  if (nsplit > kMaxSplits || (nsplit > 1 && (a.partials == nullptr || a.tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  if (a.hd <= 64) return launch_d<T, KV, 2>(a, b, nsplit, stream);
  if (a.hd <= 128) return launch_d<T, KV, 4>(a, b, nsplit, stream);
  return launch_d<T, KV, 8>(a, b, nsplit, stream);
}

}  // namespace

// q, out: (B, 1, Hq, hd); pools: (npages, page, Hkv, hd); page_table:
// (B, maxp) int32; lengths: (B,) int32. dtype: 0 = float32, 1 = bfloat16.
// window <= 0 means no window; softcap <= 0 means no softcap. pps: logical
// pages a split, so ceil(maxp / pps) splits (at most 64); with more than
// one, partials (B, Hkv, splits, G * hd + 2 G) f32 and tickets (B, Hkv)
// int32, all 0 before the first call, are the workspace (left at 0).
// Takes hd a multiple of 16 up to 256, G = Hq / Hkv up to 16 and pages
// of 4 to 32 tokens, a multiple of 4.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* page_table,
                                      const void* lengths, void* out,
                                      void* partials, void* tickets, int b,
                                      int hq, int hkv, int hd, int page,
                                      int maxp, int pps, int window,
                                      float softcap, float scale, int dtype,
                                      void* stream) {
  const Args a{q, k_pool, v_pool, nullptr, nullptr, (const int*)page_table,
               (const int*)lengths, out, (float*)partials, (int*)tickets,
               hq, hkv, hd, page, maxp, pps, window, softcap, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16, __nv_bfloat16>(a, b, s);
  if (dtype == 0) return launch<float, float>(a, b, s);
  return (int)cudaErrorInvalidValue;
}

// The int8 pools: k_pool / v_pool (npages, page, Hkv, hd) int8 and
// k_scale / v_scale (npages, page, Hkv) f32; q and out in dtype (0 =
// float32, 1 = bfloat16); everything else as paged_attention_launch.
extern "C" int paged_attention_q_launch(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* k_scale,
                                        const void* v_scale,
                                        const void* page_table,
                                        const void* lengths, void* out,
                                        void* partials, void* tickets, int b,
                                        int hq, int hkv, int hd, int page,
                                        int maxp, int pps, int window,
                                        float softcap, float scale, int dtype,
                                        void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return (int)cudaErrorInvalidValue;
  const Args a{q, k_pool, v_pool, (const float*)k_scale, (const float*)v_scale,
               (const int*)page_table, (const int*)lengths, out,
               (float*)partials, (int*)tickets, hq, hkv, hd, page, maxp, pps,
               window, softcap, scale};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) return launch<__nv_bfloat16, int8_t>(a, b, s);
  if (dtype == 0) return launch<float, int8_t>(a, b, s);
  return (int)cudaErrorInvalidValue;
}
