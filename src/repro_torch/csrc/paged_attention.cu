// Paged decode attention over a shared KV page pool, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/paged_attention.py::
// paged_attention_pallas (body _paged_kernel): one query row per slot, K/V
// fetched page-wise through the page table, f32 online softmax, positions
// < length valid (and >= length - window with a window), optional tanh
// softcap, output acc / max(l, 1e-30) so an empty slot gives exact zeros.
//
// One CTA per (slot, kv head) holds the G = Hq / Hkv query rows of that
// head and walks the slot's logical pages in order: each page's K and V
// rows for the head are copied to shared memory once and serve all G query
// rows. Pages wholly past the length, or wholly behind the window, are
// skipped, so the bytes moved are the live pages of each slot.
//
// What bounds it on this card: bytes. A live token costs 2 * hd * 2 bytes
// of K/V per kv head and 4 * G * hd FLOPs, 2 FLOP/byte at G = 8 — far
// below the tensor cores' 295 FLOP/byte — so plain f32 FMA from shared
// memory is no limit; what matters is reading each live K/V row once
// (done: the G query rows of a kv head share one CTA) and having enough
// CTAs in flight (B * Hkv = 32 at 8 slots of qwen3, each a few pages long
// at serving lengths, so at these sizes launch latency dominates).
//
// int8 pools (paged_attention_q_launch; the quantized branch of
// _paged_kernel): K and V pages hold int8 rows, each (row, kv head) with
// its own f32 scale in k_scale / v_scale pools (npages, page, Hkv) paged
// through the same table. A CTA reads a page's int8 rows and their scales
// and multiplies as they land in the f32 k_s / v_s tiles, as the TPU
// kernel dequantizes its gathered page in VMEM; everything after is the
// same code. A live token then costs 2 * (hd + 4) bytes a kv head instead
// of 2 * 2 * hd.
//
// Plain C interface for ctypes: paged_attention_launch and
// paged_attention_q_launch return cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 128;
constexpr float kNegInf = -2.0e38f;  // NEG_INF of the reference

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Shared memory floats of one CTA.
__host__ __device__ inline int smem_floats(int g, int hd, int page) {
  return g * hd            // q
         + page * (hd + 1) // K page, rows padded against bank conflicts
         + page * hd       // V page
         + g * page        // logits, then probabilities
         + g * hd          // acc
         + 3 * g;          // m, l, per-page rescale
}

// KV: the pools' storage, T or int8_t; with int8_t the f32 k_scale /
// v_scale pools (npages, page, Hkv) scale each row (null otherwise).
template <typename T, typename KV>
__global__ void __launch_bounds__(kThreads)
paged_attention_kernel(const T* __restrict__ q, const KV* __restrict__ k_pool,
                       const KV* __restrict__ v_pool,
                       const float* __restrict__ k_scale,
                       const float* __restrict__ v_scale,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths, T* __restrict__ out,
                       int hq, int hkv, int hd, int page, int maxp, int window,
                       float softcap, float scale) {
  extern __shared__ float sm[];
  const int b = blockIdx.x, h = blockIdx.y;
  const int g = hq / hkv;
  float* q_s = sm;
  float* k_s = q_s + g * hd;
  float* v_s = k_s + page * (hd + 1);
  float* p_s = v_s + page * hd;
  float* acc_s = p_s + g * page;
  float* m_s = acc_s + g * hd;
  float* l_s = m_s + g;
  float* a_s = l_s + g;
  const int tid = threadIdx.x;
  const size_t qbase = ((size_t)b * hq + (size_t)h * g) * hd;
  const int len = lengths[b];

  for (int idx = tid; idx < g * hd; idx += kThreads) {
    q_s[idx] = to_f(q[qbase + idx]);
    acc_s[idx] = 0.0f;
  }
  for (int i = tid; i < g; i += kThreads) {
    m_s[i] = kNegInf;
    l_s[i] = 0.0f;
  }

  const int npages = min((len + page - 1) / page, maxp);
  for (int j = 0; j < npages; ++j) {
    if (window > 0 && (j + 1) * page <= len - window) continue;  // behind window
    const size_t phys = (size_t)page_table[(size_t)b * maxp + j];
    __syncthreads();  // the previous page is fully consumed
    for (int idx = tid; idx < page * hd; idx += kThreads) {
      const int t = idx / hd, dd = idx % hd;
      const size_t row = (phys * page + t) * hkv + h;
      const size_t src = row * hd + dd;
      float kv = to_f(k_pool[src]), vv = to_f(v_pool[src]);
      if constexpr (std::is_same<KV, int8_t>::value) {
        kv *= k_scale[row];
        vv *= v_scale[row];
      }
      k_s[t * (hd + 1) + dd] = kv;
      v_s[idx] = vv;
    }
    __syncthreads();
    for (int idx = tid; idx < g * page; idx += kThreads) {
      const int gi = idx / page, t = idx % page;
      float s = 0.0f;
      for (int dd = 0; dd < hd; ++dd)
        s = fmaf(q_s[gi * hd + dd], k_s[t * (hd + 1) + dd], s);
      s *= scale;
      if (softcap > 0.0f) s = tanhf(s / softcap) * softcap;
      const int kpos = j * page + t;
      const bool valid = kpos < len && (window <= 0 || kpos >= len - window);
      p_s[idx] = valid ? s : kNegInf;
    }
    __syncthreads();
    for (int gi = tid; gi < g; gi += kThreads) {
      float mx = kNegInf;
      for (int t = 0; t < page; ++t) mx = fmaxf(mx, p_s[gi * page + t]);
      const float m_new = fmaxf(m_s[gi], mx);
      const float alpha = expf(m_s[gi] - m_new);
      float sum = 0.0f;
      for (int t = 0; t < page; ++t) {
        const float p = expf(p_s[gi * page + t] - m_new);
        p_s[gi * page + t] = p;
        sum += p;
      }
      l_s[gi] = l_s[gi] * alpha + sum;
      m_s[gi] = m_new;
      a_s[gi] = alpha;
    }
    __syncthreads();
    for (int idx = tid; idx < g * hd; idx += kThreads) {
      const int gi = idx / hd, dd = idx % hd;
      float a = acc_s[idx] * a_s[gi];
      for (int t = 0; t < page; ++t) a = fmaf(p_s[gi * page + t], v_s[t * hd + dd], a);
      acc_s[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < g * hd; idx += kThreads) {
    const int gi = idx / hd;
    out[qbase + idx] = from_f<T>(acc_s[idx] / fmaxf(l_s[gi], 1e-30f));
  }
}

template <typename T, typename KV>
int launch(const void* q, const void* k_pool, const void* v_pool,
           const void* k_scale, const void* v_scale, const void* page_table,
           const void* lengths, void* out, int b, int hq, int hkv, int hd,
           int page, int maxp, int window, float softcap, float scale,
           cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (size_t)smem_floats(hq / hkv, hd, page);
  if (bytes > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        paged_attention_kernel<T, KV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return (int)err;
  }
  paged_attention_kernel<T, KV><<<dim3(b, hkv), kThreads, bytes, stream>>>(
      (const T*)q, (const KV*)k_pool, (const KV*)v_pool,
      (const float*)k_scale, (const float*)v_scale, (const int*)page_table,
      (const int*)lengths, (T*)out, hq, hkv, hd, page, maxp, window, softcap,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, out: (B, 1, Hq, hd); pools: (npages, page, Hkv, hd); page_table:
// (B, maxp) int32; lengths: (B,) int32. dtype: 0 = float32, 1 = bfloat16.
// window <= 0 means no window; softcap <= 0 means no softcap.
extern "C" int paged_attention_launch(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const void* page_table,
                                      const void* lengths, void* out, int b,
                                      int hq, int hkv, int hd, int page,
                                      int maxp, int window, float softcap,
                                      float scale, int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(
        q, k_pool, v_pool, nullptr, nullptr, page_table, lengths, out, b, hq,
        hkv, hd, page, maxp, window, softcap, scale, s);
  return launch<float, float>(q, k_pool, v_pool, nullptr, nullptr, page_table,
                              lengths, out, b, hq, hkv, hd, page, maxp,
                              window, softcap, scale, s);
}

// The int8 pools: k_pool / v_pool (npages, page, Hkv, hd) int8 and
// k_scale / v_scale (npages, page, Hkv) f32; q and out in dtype (0 =
// float32, 1 = bfloat16); everything else as paged_attention_launch.
extern "C" int paged_attention_q_launch(const void* q, const void* k_pool,
                                        const void* v_pool,
                                        const void* k_scale,
                                        const void* v_scale,
                                        const void* page_table,
                                        const void* lengths, void* out, int b,
                                        int hq, int hkv, int hd, int page,
                                        int maxp, int window, float softcap,
                                        float scale, int dtype, void* stream) {
  if (k_scale == nullptr || v_scale == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16, int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                         page_table, lengths, out, b, hq, hkv,
                                         hd, page, maxp, window, softcap,
                                         scale, s);
  if (dtype == 0)
    return launch<float, int8_t>(q, k_pool, v_pool, k_scale, v_scale,
                                 page_table, lengths, out, b, hq, hkv, hd,
                                 page, maxp, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}
