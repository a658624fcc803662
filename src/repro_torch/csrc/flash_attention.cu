// Flash attention forward, causal or full, GQA, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel) and its GQA wrapper
// flash_attention: out = softmax(q k^T * hd^-0.5 [causal mask]) v per
// (batch, query head), q (B, S, Hq, hd), k and v (B, S, Hkv, hd), query
// head h reading kv head h / (Hq / Hkv) (the TPU wrapper's jnp.repeat).
// q, k, v and p are f32 in the products (the TPU kernel upcasts them before
// its dots; the wgmma route's bf16 products of q and k are exact in f32,
// and it carries p in two bf16 parts), the running max m, sum l and
// accumulator are f32, masked logits are -2e38, and the output is
// acc / max(l, 1e-30) in q's dtype.
//
// It computes the function, not the Pallas grid: the TPU walks (bq, bk)
// blocks of 512 with the kv axis sequential in VMEM scratch; here a CTA
// walks the kv tiles of its query rows in ascending order itself. Tile 0
// holds key 0, which every row may see, so each row's m is finite after it
// and a masked logit's exp is exactly 0 from then on. Causal: only the
// tiles up to the diagonal run, only the tiles that cross it (or pass S)
// are masked, and the q blocks run longest first. K and V are read in
// their (B, S, Hkv, hd) layout: no transpose, no repeat.
//
// What bounds it on this card: operations. 4 S^2 hd flops per (batch,
// query head) (half that when causal) against S hd elements of q and the
// output per query head and of k and v per kv head: some 460 flops a byte
// at qwen3-moe-30b-a3b's width (B 4, S 1024, 32 / 4 heads, hd 128, bf16,
// causal), above the 295 where the tensor cores' 989 TFLOP/s (bf16)
// outrun the 3.35 TB/s. Two routes, chosen by the wrapper
// (kernels/flash_attention.py::_route) from the dtype alone:
//
// wgmma (bf16, hd 64, 128 or 256; flash_attention_wgmma_launch):
//  * A CTA owns 64 NC query rows of one (batch, query head): NC = 2
//    consumer warpgroups of 64 rows at hd 64 and 128, one at hd 256 (its
//    64 x 256 f32 output takes 128 registers a thread). A producer warp
//    brings the q rows once and the 64-key K and V tiles through a ring of
//    mbarrier stages (3, or 2 at hd 256) with TMA. The tensor maps run
//    over (B, S, H, hd) directly, in boxes of 64 hd values (128 bytes, the
//    128-byte swizzle) by 64 NC or 64 rows; rows past S read as zeros,
//    and kv head h / (Hq / Hkv) is a coordinate of the map.
//  * S = q k^T: hd / 16 m64n64k16 wgmma, both operands K-major from
//    shared memory, into 32 f32 registers a thread. The products of two
//    bf16 values are exact in f32, so S is the f32 reference's dot in
//    another order.
//  * Online softmax in registers: a thread holds two rows' 16 logits each
//    (the accumulator's fragment map); the row max is a shuffle over the
//    4 lanes of a row; m, l and the rescale of O stay f32, and l sums the
//    f32 p.
//  * O += P V in split bf16: p_hi = bf16(p), p_lo = bf16(p - p_hi), and
//    two m64n{hd}k16 wgmma a 16-key step, P_hi V and P_lo V, with P from
//    registers (the RS form: the S accumulator's registers are, in pairs,
//    the A fragment) and V MN-major in shared memory (the transpose bit).
//    p_hi + p_lo carries p to about 2^-17, so the output stays within one
//    bf16 ulp of the f32 reference; p in bf16 alone (what fused library
//    kernels do) misses it by up to 26 x, and TF32 (which wgmma takes
//    K-major only) by about 2 x. The split costs 1.5 x the tensor work of
//    a plain bf16 P V.
//  * The epilogue divides by max(l, 1e-30) and stores the rows below S.
//
// simt (f32; flash_attention_launch): the f32 products of the TPU kernel
// on FMA from shared memory. A CTA owns 64 query rows; its 256 threads are
// 16 row groups x 16 column lanes (rows ty + 16 i, logits of columns tx +
// 16 j, output columns tx * 4 + 64 c); the row max and sum are shuffles
// over a half-warp; p goes through shared memory to the PV product. The
// kv tile is 64 keys at hd 64, 32 at hd 128 and 16 at hd 256, so that two
// CTAs fit an SM's shared memory.
//
// Plain C interface for ctypes: both entry points return
// cudaGetLastError(), or cudaErrorInvalidValue for operands their route
// does not take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 256;      // 16 row groups x 16 column lanes
constexpr int kBM = 64;            // query rows of a CTA
constexpr int kRows = kBM / 16;    // query rows of a thread
constexpr float kNegInf = -2.0e38f;  // NEG_INF of the reference

// Keys of a kv tile for a head dim (see the note above).
__host__ __device__ constexpr int kv_tile(int hd) {
  return hd == 64 ? 64 : hd == 128 ? 32 : 16;
}

// Shared memory floats of one CTA: q rows, K tile (rows padded by 4 so
// that 8 lanes reading 8 rows hit 32 distinct banks), V tile, p.
__host__ __device__ constexpr int smem_floats(int hd) {
  return kBM * (hd + 4) + kv_tile(hd) * (hd + 4) + kv_tile(hd) * hd +
         kBM * (kv_tile(hd) + 4);
}

// rows x HD floats (row stride `stride` in global memory) into shared
// memory with row stride ld; rows at or past `valid` are zeros.
template <int HD>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const float* __restrict__ src,
                                           size_t stride, int rows,
                                           int valid) {
  constexpr int kChunks = HD / 4;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        r < valid ? __ldg(reinterpret_cast<const float4*>(
                        src + (size_t)r * stride + c))
                  : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, float* __restrict__ out, int s, int hq,
             int hkv, int causal, float scale) {
  constexpr int BN = kv_tile(HD);
  constexpr int kCols = BN / 16;   // logit columns of a thread
  constexpr int kOut = HD / 64;    // float4 output column groups of a thread
  constexpr int LDQ = HD + 4, LDK = HD + 4, LDP = BN + 4;
  extern __shared__ __align__(16) float sm[];
  float* q_s = sm;
  float* k_s = q_s + kBM * LDQ;
  float* v_s = k_s + BN * LDK;
  float* p_s = v_s + BN * HD;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kBM;
  const int hk = h / (hq / hkv);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const size_t q_stride = (size_t)hq * HD, kv_stride = (size_t)hkv * HD;
  const float* q_base = q + ((size_t)b * s + q0) * q_stride + (size_t)h * HD;
  const size_t kv_off = (size_t)b * s * kv_stride + (size_t)hk * HD;

  stage_rows<HD>(q_s, LDQ, q_base, q_stride, kBM, min(kBM, s - q0));

  float m[kRows], l[kRows], acc[kRows][kOut][4];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
#pragma unroll
    for (int c = 0; c < kOut; ++c)
#pragma unroll
      for (int u = 0; u < 4; ++u) acc[i][c][u] = 0.0f;
  }

  const int kv_end = causal ? min(s, q0 + kBM) : s;
  for (int kv0 = 0; kv0 < kv_end; kv0 += BN) {
    __syncthreads();  // the previous tile's K, V and p are consumed
    const int valid = min(BN, s - kv0);
    stage_rows<HD>(k_s, LDK, k + kv_off + (size_t)kv0 * kv_stride,
                      kv_stride, BN, valid);
    stage_rows<HD>(v_s, HD, v + kv_off + (size_t)kv0 * kv_stride,
                      kv_stride, BN, valid);
    __syncthreads();

    float sc[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) sc[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[kRows], kv[kCols];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (ty + 16 * i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(k_s + (tx + 16 * j) * LDK + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          float a = sc[i][j];
          a = fmaf(qv[i].x, kv[j].x, a);
          a = fmaf(qv[i].y, kv[j].y, a);
          a = fmaf(qv[i].z, kv[j].z, a);
          a = fmaf(qv[i].w, kv[j].w, a);
          sc[i][j] = a;
        }
    }

    const bool edge = kv0 + BN > s || (causal && kv0 + BN - 1 > q0);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty + 16 * i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        float x = sc[i][j] * scale;
        if (edge) {
          const int key = kv0 + tx + 16 * j;
          if (key >= s || (causal && key > row)) x = kNegInf;
        }
        sc[i][j] = x;
        mx = fmaxf(mx, x);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.0f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const float p = expf(sc[i][j] - m_new);
        p_s[(ty + 16 * i) * LDP + tx + 16 * j] = p;
        sum += p;
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, off);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kOut; ++c)
#pragma unroll
        for (int u = 0; u < 4; ++u) acc[i][c][u] *= alpha;
    }
    __syncthreads();

#pragma unroll 2
    for (int n = 0; n < BN; n += 4) {
      float4 pv[kRows];
#pragma unroll
      for (int i = 0; i < kRows; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (ty + 16 * i) * LDP + n);
#pragma unroll
      for (int nn = 0; nn < 4; ++nn) {
#pragma unroll
        for (int c = 0; c < kOut; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(
              v_s + (n + nn) * HD + tx * 4 + 64 * c);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            const float p = nn == 0 ? pv[i].x : nn == 1 ? pv[i].y
                          : nn == 2 ? pv[i].z : pv[i].w;
            acc[i][c][0] = fmaf(p, vv.x, acc[i][c][0]);
            acc[i][c][1] = fmaf(p, vv.y, acc[i][c][1]);
            acc[i][c][2] = fmaf(p, vv.z, acc[i][c][2]);
            acc[i][c][3] = fmaf(p, vv.w, acc[i][c][3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int r = ty + 16 * i;
    if (q0 + r >= s) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int c = 0; c < kOut; ++c)
      *reinterpret_cast<float4*>(out + ((size_t)b * s + q0 + r) * q_stride +
                                 (size_t)h * HD + tx * 4 + 64 * c) =
          make_float4(acc[i][c][0] / den, acc[i][c][1] / den,
                      acc[i][c][2] / den, acc[i][c][3] / den);
  }
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int hq, int hkv, int causal, float scale,
           cudaStream_t stream) {
  const int bytes = (int)sizeof(float) * smem_floats(HD);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(hq, b, (s + kBM - 1) / kBM);
  flash_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)out, s, hq,
      hkv, causal, scale);
  return (int)cudaGetLastError();
}

int launch_simt(const void* q, const void* k, const void* v, void* out,
                int b, int s, int hq, int hkv, int hd, int causal,
                float scale, cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<64>(q, k, v, out, b, s, hq, hkv, causal, scale, stream);
    case 128:
      return launch<128>(q, k, v, out, b, s, hq, hkv, causal, scale, stream);
    case 256:
      return launch<256>(q, k, v, out, b, s, hq, hkv, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// ---- wgmma route (bf16) -----------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct FlashWg {
  static constexpr int kNC = HD == 256 ? 1 : 2;   // consumer warpgroups
  static constexpr int kBM = 64 * kNC;            // query rows of a CTA
  static constexpr int kBN = 64;                  // keys of a kv tile
  static constexpr int kStages = HD == 256 ? 2 : 3;
  static constexpr int kBoxes = HD / 64;          // 64-wide hd boxes a row
  static constexpr int kQBox = kBM * 128;
  static constexpr int kKVBox = kBN * 128;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kTileBytes = kBoxes * kKVBox;  // a K or a V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kThreads = kNC * 128 + 32;     // + one producer warp
  static constexpr int kSmem =
      kQBytes + kStages * kStageBytes + 1024 + (2 * kStages + 1) * 8;
};

template <int HD>
__global__ void __launch_bounds__(FlashWg<HD>::kThreads, 1)
flash_wgmma_kernel(__grid_constant__ const CUtensorMap q_map,
                   __grid_constant__ const CUtensorMap k_map,
                   __grid_constant__ const CUtensorMap v_map,
                   __nv_bfloat16* __restrict__ out, int s, int hq, int hkv,
                   int causal, float scale) {
  using C = FlashWg<HD>;
  constexpr int kBN = C::kBN;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* q_s = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* ring = q_s + C::kQBytes;
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  uint64_t* qbar = empty + C::kStages;

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * C::kBM;
  const int hk = h / (hq / hkv);
  const int kv_end = causal ? min(s, q0 + C::kBM) : s;
  const int ntiles = (kv_end + kBN - 1) / kBN;
  const int warp = threadIdx.x / 32;

  if (threadIdx.x == 0) {
    for (int st = 0; st < C::kStages; ++st) {
      hopper::mbar_init(&full[st], 1);
      hopper::mbar_init(&empty[st], C::kNC * 128);
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * C::kNC) {             // producer warp: one lane loads
    if (threadIdx.x % 32 == 0) {
      hopper::mbar_arrive_expect_tx(qbar, C::kQBytes);
      for (int j = 0; j < C::kBoxes; ++j)
        hopper::tma_load_4d(q_s + j * C::kQBox, &q_map, qbar, 64 * j, h, q0, b);
      for (int it = 0; it < ntiles; ++it) {
        const int st = it % C::kStages;
        if (it >= C::kStages) hopper::mbar_wait(&empty[st], ((it / C::kStages) - 1) & 1);
        uint8_t* kt = ring + st * C::kStageBytes;
        uint8_t* vt = kt + C::kTileBytes;
        hopper::mbar_arrive_expect_tx(&full[st], C::kStageBytes);
        for (int j = 0; j < C::kBoxes; ++j) {
          hopper::tma_load_4d(kt + j * C::kKVBox, &k_map, &full[st], 64 * j, hk, it * kBN, b);
          hopper::tma_load_4d(vt + j * C::kKVBox, &v_map, &full[st], 64 * j, hk, it * kBN, b);
        }
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  const int qw = q0 + 64 * wg;          // the warpgroup's first query row
  const int row_lo = qw + hopper::frag_row(t, 0), row_hi = row_lo + 8;
  const uint8_t* qa = q_s + wg * 64 * 128;
  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.0f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.0f, 0.0f};

  hopper::mbar_wait(qbar, 0);
  for (int it = 0; it < ntiles; ++it) {
    const int st = it % C::kStages;
    hopper::mbar_wait(&full[st], (it / C::kStages) & 1);
    const int kv0 = it * kBN;
    if (causal && kv0 > qw + 63) {      // above every row of this warpgroup
      hopper::mbar_arrive(&empty[st]);
      continue;
    }
    const uint8_t* kt = ring + st * C::kStageBytes;
    const uint8_t* vt = kt + C::kTileBytes;

    // S = q k^T (64 x 64, f32)
    float sc[kBN / 2];
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) sc[i] = 0.0f;
    hopper::fence_acc(sc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      hopper::Wgmma<kBN, 0, 0>::ss(
          sc,
          hopper::make_desc(qa + (kk / 4) * C::kQBox + (kk % 4) * 32, 16, 1024),
          hopper::make_desc(kt + (kk / 4) * C::kKVBox + (kk % 4) * 32, 16, 1024),
          1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(sc);

    // online softmax: sc[i] lies in row row_lo ((i / 2) even) or row_hi
    const bool edge = kv0 + kBN > s || (causal && kv0 + kBN - 1 > qw);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int hh = (i / 2) % 2;
      float x = sc[i] * scale;
      if (edge) {
        const int key = kv0 + hopper::frag_col(t, i);
        if (key >= s || (causal && key > (hh ? row_hi : row_lo))) x = kNegInf;
      }
      sc[i] = x;
      mx[hh] = fmaxf(mx[hh], x);
    }
    float alpha[2], sum[2] = {0.0f, 0.0f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
      const float m_new = fmaxf(m[hh], mx[hh]);
      alpha[hh] = exp2f((m[hh] - m_new) * kLog2e);
      m[hh] = m_new;
    }
#pragma unroll
    for (int i = 0; i < kBN / 2; ++i) {
      const int hh = (i / 2) % 2;
      sc[i] = exp2f((sc[i] - m[hh]) * kLog2e);
      sum[hh] += sc[i];
    }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) l[hh] = l[hh] * alpha[hh] + sum[hh];
#pragma unroll
    for (int i = 0; i < HD / 2; ++i) o[i] *= alpha[(i / 2) % 2];

    // p = p_hi + p_lo in bf16, as the RS A fragments of the 16-key steps
    uint32_t ph[kBN / 16][4], pl[kBN / 16][4];
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p0 = sc[8 * kk + 2 * j], p1 = sc[8 * kk + 2 * j + 1];
        const __nv_bfloat162 hi = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(p0 - hf.x, p1 - hf.y);
        ph[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[kk][j] = *reinterpret_cast<const uint32_t*>(&lo);
      }

    // O += P_hi V + P_lo V
    hopper::fence_acc(o);
    hopper::fence_regs(ph);
    hopper::fence_regs(pl);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kBN / 16; ++kk) {
      const uint64_t dv = hopper::make_desc(vt + kk * 2048, C::kKVBox, 1024);
      hopper::Wgmma<HD, 0, 1>::rs(o, ph[kk], dv, 1);
      hopper::Wgmma<HD, 0, 1>::rs(o, pl[kk], dv, 1);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_acc(o);
    hopper::fence_regs(ph);
    hopper::fence_regs(pl);
    hopper::mbar_arrive(&empty[st]);
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 1);
    l[hh] += __shfl_xor_sync(0xffffffffu, l[hh], 2);
    l[hh] = fmaxf(l[hh], 1e-30f);
  }
  const size_t q_stride = (size_t)hq * HD;
#pragma unroll
  for (int i = 0; i < HD / 2; i += 2) {
    const int hh = (i / 2) % 2;
    const int row = hh ? row_hi : row_lo;
    if (row < s)
      *reinterpret_cast<__nv_bfloat162*>(
          &out[((size_t)b * s + row) * q_stride + (size_t)h * HD +
               hopper::frag_col(t, i)]) =
          __floats2bfloat162_rn(o[i] / l[hh], o[i + 1] / l[hh]);
  }
}

template <int HD>
int launch_wgmma(const void* q, const void* k, const void* v, void* out,
                 int b, int s, int hq, int hkv, int causal, float scale,
                 cudaStream_t stream) {
  using C = FlashWg<HD>;
  // (B, S, H, hd) as 4-D maps, hd innermost: boxes of 64 hd x 1 head x
  // rows x 1 batch; rows past S read as zeros.
  CUtensorMap q_map, k_map, v_map;
  const uint64_t q_dims[4] = {(uint64_t)HD, (uint64_t)hq, (uint64_t)s, (uint64_t)b};
  const uint64_t q_strides[3] = {(uint64_t)HD * 2, (uint64_t)hq * HD * 2,
                                 (uint64_t)s * hq * HD * 2};
  const uint32_t q_box[4] = {64, 1, (uint32_t)C::kBM, 1};
  const uint64_t kv_dims[4] = {(uint64_t)HD, (uint64_t)hkv, (uint64_t)s, (uint64_t)b};
  const uint64_t kv_strides[3] = {(uint64_t)HD * 2, (uint64_t)hkv * HD * 2,
                                  (uint64_t)s * hkv * HD * 2};
  const uint32_t kv_box[4] = {64, 1, (uint32_t)C::kBN, 1};
  if (!hopper::encode_bf16_map(&q_map, q, 4, q_dims, q_strides, q_box) ||
      !hopper::encode_bf16_map(&k_map, k, 4, kv_dims, kv_strides, kv_box) ||
      !hopper::encode_bf16_map(&v_map, v, 4, kv_dims, kv_strides, kv_box))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;       // one attribute set per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_wgmma_kernel<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        C::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(hq, b, (s + C::kBM - 1) / C::kBM);
  flash_wgmma_kernel<HD><<<grid, C::kThreads, C::kSmem, stream>>>(
      q_map, k_map, v_map, (__nv_bfloat16*)out, s, hq, hkv, causal, scale);
  return (int)cudaGetLastError();
}

bool shapes_ok(const void* q, const void* k, const void* v, const void* out,
               int b, int s, int hq, int hkv) {
  return b > 0 && s > 0 && hkv > 0 && hq % hkv == 0 &&
         ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)out) % 16 == 0;
}

}  // namespace

// The simt route: q, out (B, S, Hq, hd) and k, v (B, S, Hkv, hd), float32,
// contiguous and 16-byte aligned, Hq a multiple of Hkv, hd 64, 128 or 256.
// dtype must be 0 (float32): bf16 takes the wgmma route. causal: 0 or 1.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int s,
                                      int hq, int hkv, int hd, int causal,
                                      float scale, int dtype, void* stream) {
  if (dtype != 0 || !shapes_ok(q, k, v, out, b, s, hq, hkv))
    return (int)cudaErrorInvalidValue;
  return launch_simt(q, k, v, out, b, s, hq, hkv, hd, causal, scale,
                     (cudaStream_t)stream);
}

// The wgmma route: the same operands in bfloat16, hd 64, 128 or 256.
extern "C" int flash_attention_wgmma_launch(const void* q, const void* k,
                                            const void* v, void* out, int b,
                                            int s, int hq, int hkv, int hd,
                                            int causal, float scale,
                                            void* stream) {
  if (!shapes_ok(q, k, v, out, b, s, hq, hkv))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (hd) {
    case 64:
      return launch_wgmma<64>(q, k, v, out, b, s, hq, hkv, causal, scale, st);
    case 128:
      return launch_wgmma<128>(q, k, v, out, b, s, hq, hkv, causal, scale, st);
    case 256:
      return launch_wgmma<256>(q, k, v, out, b, s, hq, hkv, causal, scale, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
