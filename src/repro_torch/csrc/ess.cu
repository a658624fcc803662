// Expert-specific summation (ESS) over the expert-sorted layout, for Hopper
// (sm_90a).
//
// Replaces the TPU kernel repro/kernels/ess.py::ess_pallas (body
// _ess_kernel): db[e] = sum over the rows r of expert e of x[r], in f32,
// (E, D); an expert with padded_counts[e] == 0 gets exactly 0 (the TPU
// wrapper's mask, ess.py:83). The unfused backward of the biased MLP expert
// FFN (the paper's Fig. 12 ablation: ESTMM for dW, ESS for db) computes db1
// and db2 with it.
//
// What bounds it on this card: the bytes. It reads Np D elements once and
// does one add per element. The TPU grid walks the blocks in order and
// flushes a sum when block_expert changes; GPU blocks run in no order, so:
//
//  * A CTA owns one (expert, 32-column D tile) and sums that expert's
//    contiguous run of rows, which starts at the sum of padded_counts
//    before e; tail blocks past the last group belong to expert E-1, as
//    block_expert clamps them. Each output has one writer: no atomics, and
//    the same summation order on every run.
//  * Its 1024 threads are 32 columns x 32 row lanes: a warp reads 32
//    neighbouring elements of one row, the 32 warps stride over the run's
//    rows, each thread keeping 4 loads in flight. The 32 partial sums of a
//    column are then added in a fixed order through shared memory.
//  * An empty expert's CTAs write zeros and read nothing.
//
// Plain C interface for ctypes: ess_launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kCols = 32;    // D columns of a CTA (one warp's width)
constexpr int kLanes = 32;   // row lanes (warps) of a CTA
constexpr int kUnroll = 4;   // loads in flight per thread

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kCols * kLanes)
ess_kernel(const T* __restrict__ x, const int* __restrict__ padded_counts,
           float* __restrict__ out, int np_rows, int d, int num_experts) {
  __shared__ float part[kLanes][kCols + 1];
  __shared__ int run[2];

  const int e = blockIdx.y;
  const int col = blockIdx.x * kCols + threadIdx.x % kCols;
  const int lane = threadIdx.x / kCols;
  if (threadIdx.x < 32) {
    int s = 0;
    for (int i = threadIdx.x; i < e; i += 32) s += padded_counts[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (threadIdx.x == 0) {
      const int count = padded_counts[e];
      run[0] = s;
      run[1] = count == 0 ? s : (e == num_experts - 1 ? np_rows : s + count);
    }
  }
  __syncthreads();
  const int lo = run[0], hi = run[1];

  float acc = 0.0f;
  if (col < d) {
    int r = lo + lane;
    for (; r + (kUnroll - 1) * kLanes < hi; r += kUnroll * kLanes) {
      float v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) v[u] = to_f(x[(size_t)(r + u * kLanes) * d + col]);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) acc += v[u];
    }
    for (; r < hi; r += kLanes) acc += to_f(x[(size_t)r * d + col]);
  }
  part[lane][threadIdx.x % kCols] = acc;
  __syncthreads();
  if (lane == 0 && col < d) {
    float s = 0.0f;
    for (int l = 0; l < kLanes; ++l) s += part[l][threadIdx.x];
    out[(size_t)e * d + col] = s;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x (Np, D); padded_counts (E,) int32
// (multiples of blk summing to at most Np); out (E, D) f32, every element
// written.
extern "C" int ess_launch(const void* x, const void* padded_counts, void* out,
                          int np_rows, int d, int num_experts, int dtype,
                          void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((d + kCols - 1) / kCols, num_experts);
  if (dtype == 1)
    ess_kernel<__nv_bfloat16><<<grid, kCols * kLanes, 0, s>>>(
        (const __nv_bfloat16*)x, (const int*)padded_counts, (float*)out,
        np_rows, d, num_experts);
  else
    ess_kernel<float><<<grid, kCols * kLanes, 0, s>>>(
        (const float*)x, (const int*)padded_counts, (float*)out, np_rows, d,
        num_experts);
  return (int)cudaGetLastError();
}
