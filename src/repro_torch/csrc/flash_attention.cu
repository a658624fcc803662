// Flash attention forward, causal or full, GQA, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::
// flash_attention_pallas (body _flash_kernel) and its GQA wrapper
// flash_attention: out = softmax(q k^T * hd^-0.5 [causal mask]) v per
// (batch, query head), q (B, S, Hq, hd), k and v (B, S, Hkv, hd), query
// head h reading kv head h / (Hq / Hkv) (the TPU wrapper's jnp.repeat).
// q, k, v and p are f32 in the products (the TPU kernel upcasts them before
// its dots), the running max m, sum l and accumulator are f32, masked
// logits are -2e38, and the output is acc / max(l, 1e-30) in q's dtype.
//
// It computes the function, not the Pallas grid: the TPU walks (bq, bk)
// blocks of 512 with the kv axis sequential in VMEM scratch; here
//
//  * A CTA owns 64 query rows of one (batch, query head), reads q, k, v in
//    their (B, S, H, hd) layout (no transpose, no repeat of K/V), holds its
//    q rows in shared memory as f32 and walks the kv tiles in ascending
//    order, each staged once in shared memory as f32. Tile 0 holds key 0,
//    which every row may see, so each row's m is finite after it and a
//    masked logit's exp is exactly 0 from then on.
//  * Its 256 threads are 16 row groups x 16 column lanes: a thread owns
//    rows ty + 16 i (i < 4), the logits of columns tx + 16 j of each kv
//    tile, and the output columns tx * 4 + 64 c. The row max and sum are
//    shuffles over the 16 lanes of a half-warp; m, l and the accumulator
//    stay in registers; p goes through shared memory to the PV product.
//  * Causal: only the tiles up to the diagonal run, and only the tiles
//    that cross it (or pass S) are masked. The q blocks run longest first.
//  * The kv tile is 64 keys at hd 64, 32 at hd 128 and 16 at hd 256, so
//    that two CTAs fit an SM's shared memory (68.6, 76.3 and 104.7 KB, set
//    with cudaFuncAttributeMaxDynamicSharedMemorySize); __launch_bounds__
//    holds a thread to the 128 registers that two CTAs leave it.
//
// What bounds it on this card: operations. 4 S^2 hd flops per (batch,
// query head) (half that when causal) against S hd elements of q and the
// output per query head and of k and v per kv head: some 460 flops a byte
// at qwen3-moe-30b-a3b's width (B 4, S 1024, 32 / 4 heads, hd 128, bf16,
// causal), above the 295 where the tensor cores' 989 TFLOP/s (bf16)
// outrun the 3.35 TB/s. The products run on f32 FMA from shared memory,
// as the TPU kernel's f32 dots ask, so this kernel is far from that bound;
// tensor cores are for a later redesign.
//
// Plain C interface for ctypes: flash_attention_launch returns
// cudaGetLastError() (or cudaErrorInvalidValue for a head dim it has no
// instance for).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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

// 16 bytes of a row as f32.
__device__ __forceinline__ void load16(const float* p, float* f) {
  const float4 v = __ldg(reinterpret_cast<const float4*>(p));
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float* f) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  *reinterpret_cast<uint2*>(p) = make_uint2(
      *reinterpret_cast<const unsigned*>(&lo),
      *reinterpret_cast<const unsigned*>(&hi));
}

// rows x HD elements (row stride `stride` in global memory) into shared
// memory as f32 with row stride ld; rows at or past `valid` are zeros.
template <typename T, int HD>
__device__ __forceinline__ void stage_rows(float* dst, int ld,
                                           const T* __restrict__ src,
                                           size_t stride, int rows,
                                           int valid) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kChunks = HD / kVec;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * kVec;
    float f[kVec];
    if (r < valid) {
      load16(src + (size_t)r * stride + c, f);
    } else {
#pragma unroll
      for (int u = 0; u < kVec; ++u) f[u] = 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kVec; u += 4)
      *reinterpret_cast<float4*>(dst + r * ld + c + u) =
          make_float4(f[u], f[u + 1], f[u + 2], f[u + 3]);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, T* __restrict__ out, int s, int hq,
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
  const T* q_base = q + ((size_t)b * s + q0) * q_stride + (size_t)h * HD;
  const size_t kv_off = (size_t)b * s * kv_stride + (size_t)hk * HD;

  stage_rows<T, HD>(q_s, LDQ, q_base, q_stride, kBM, min(kBM, s - q0));

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
    stage_rows<T, HD>(k_s, LDK, k + kv_off + (size_t)kv0 * kv_stride,
                      kv_stride, BN, valid);
    stage_rows<T, HD>(v_s, HD, v + kv_off + (size_t)kv0 * kv_stride,
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
      store4(out + ((size_t)b * s + q0 + r) * q_stride + (size_t)h * HD +
                 tx * 4 + 64 * c,
             make_float4(acc[i][c][0] / den, acc[i][c][1] / den,
                         acc[i][c][2] / den, acc[i][c][3] / den));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int b,
           int s, int hq, int hkv, int causal, float scale,
           cudaStream_t stream) {
  const int bytes = (int)sizeof(float) * smem_floats(HD);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_kernel<T, HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(hq, b, (s + kBM - 1) / kBM);
  flash_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, s, hq, hkv, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(const void* q, const void* k, const void* v, void* out, int b,
              int s, int hq, int hkv, int hd, int causal, float scale,
              cudaStream_t stream) {
  switch (hd) {
    case 64:
      return launch<T, 64>(q, k, v, out, b, s, hq, hkv, causal, scale, stream);
    case 128:
      return launch<T, 128>(q, k, v, out, b, s, hq, hkv, causal, scale, stream);
    case 256:
      return launch<T, 256>(q, k, v, out, b, s, hq, hkv, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, out: (B, S, Hq, hd); k, v: (B, S, Hkv, hd); all contiguous and 16-byte
// aligned, Hq a multiple of Hkv, hd 64, 128 or 256. dtype: 0 = float32,
// 1 = bfloat16. causal: 0 or 1.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* out, int b, int s,
                                      int hq, int hkv, int hd, int causal,
                                      float scale, int dtype, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_hd<__nv_bfloat16>(q, k, v, out, b, s, hq, hkv, hd, causal,
                                    scale, st);
  return launch_hd<float>(q, k, v, out, b, s, hq, hkv, hd, causal, scale, st);
}
