// Expert-specific transposed matrix multiplication (ESTMM) over the
// expert-sorted layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/estmm.py::estmm_pallas (body
// _estmm_kernel): dW[e] = sum over the rows r of expert e of x1[r]^T x2[r],
// in f32, (E, D1, D2); an expert with padded_counts[e] == 0 gets exactly 0
// (the TPU wrapper's mask, estmm.py:96). The backward of the GLU expert FFN
// computes dWg, dWu (x1 = xs, x2 = dg / du) and dWd (x1 = h, x2 = dys) with
// it.
//
// What bounds it on this card: at training shapes (Np ~ 49k rows, D1 2048,
// D2 768) it reads (D1 + D2) Np elements and writes E D1 D2 f32 values for
// 2 Np D1 D2 FLOPs: the operations bound it, at the f32 FMA rate this
// kernel uses (tensor cores come later). Design:
//
//  * The TPU grid walks the blocks in order and carries the f32 sum of one
//    expert's run in VMEM, writing it when block_expert changes. Blocks run
//    in no order on a GPU, so a CTA owns one (expert, 64-row D1 tile,
//    64-column D2 tile) output tile and loops over that expert's run of
//    rows itself: the run is contiguous (the layout is sorted by expert)
//    and starts at the sum of padded_counts before e. Tail blocks past the
//    last group belong to expert E-1, as block_expert clamps them. Each
//    output tile has exactly one writer, so no atomics are needed and the
//    sum is taken in the same row order on every run.
//  * The row loop stages 16 rows of the x1 and x2 tiles in shared memory
//    as f32; each of the 256 threads keeps a 4 x 4 register tile of sums,
//    rows and columns strided by 16 so a warp's shared-memory reads hit
//    distinct banks or broadcast.
//  * An empty expert's CTAs write zeros and read nothing.
//
// Plain C interface for ctypes: estmm_launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;   // D1 rows of an output tile
constexpr int kBN = 64;   // D2 columns of an output tile
constexpr int kBK = 16;   // sorted rows staged per step
constexpr int kT = 4;     // a thread's rows and columns, strided by 16

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
estmm_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
             const int* __restrict__ padded_counts, float* __restrict__ out,
             int np_rows, int d1, int d2, int num_experts) {
  __shared__ float as[kBK][kBM + 4];
  __shared__ float bs[kBK][kBN + 4];
  __shared__ int run[2];

  const int e = blockIdx.z;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int tid = threadIdx.x;
  if (tid < 32) {
    int s = 0;
    for (int i = tid; i < e; i += 32) s += padded_counts[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
    if (tid == 0) {
      const int count = padded_counts[e];
      run[0] = s;
      run[1] = count == 0 ? s : (e == num_experts - 1 ? np_rows : s + count);
    }
  }
  __syncthreads();
  const int lo = run[0], hi = run[1];
  const int ty = tid / 16, tx = tid % 16;

  float acc[kT][kT];
#pragma unroll
  for (int i = 0; i < kT; ++i)
#pragma unroll
    for (int j = 0; j < kT; ++j) acc[i][j] = 0.0f;

  for (int r0 = lo; r0 < hi; r0 += kBK) {
    for (int idx = tid; idx < kBK * kBM; idx += kThreads) {
      const int kk = idx / kBM, c = idx % kBM;
      as[kk][c] = (r0 + kk < hi && m0 + c < d1)
                      ? to_f(x1[(size_t)(r0 + kk) * d1 + m0 + c]) : 0.0f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int kk = idx / kBN, c = idx % kBN;
      bs[kk][c] = (r0 + kk < hi && n0 + c < d2)
                      ? to_f(x2[(size_t)(r0 + kk) * d2 + n0 + c]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float a[kT], b[kT];
#pragma unroll
      for (int i = 0; i < kT; ++i) a[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < kT; ++j) b[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < kT; ++i)
#pragma unroll
        for (int j = 0; j < kT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < kT; ++i) {
    const int row = m0 + ty + 16 * i;
    if (row >= d1) continue;
#pragma unroll
    for (int j = 0; j < kT; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < d2) out[((size_t)e * d1 + row) * d2 + col] = acc[i][j];
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x1 and x2). x1 (Np, D1), x2 (Np, D2),
// padded_counts (E,) int32 (multiples of blk summing to at most Np), out
// (E, D1, D2) f32, every element written.
extern "C" int estmm_launch(const void* x1, const void* x2,
                            const void* padded_counts, void* out, int np_rows,
                            int d1, int d2, int num_experts, int dtype,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((d2 + kBN - 1) / kBN, (d1 + kBM - 1) / kBM, num_experts);
  if (dtype == 1)
    estmm_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x1, (const __nv_bfloat16*)x2,
        (const int*)padded_counts, (float*)out, np_rows, d1, d2, num_experts);
  else
    estmm_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x1, (const float*)x2, (const int*)padded_counts,
        (float*)out, np_rows, d1, d2, num_experts);
  return (int)cudaGetLastError();
}
