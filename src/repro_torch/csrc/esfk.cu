// Expert-specific fused backward kernel (ESFK) over the expert-sorted layout,
// for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/esfk.py::esfk_pallas (body
// _esfk_kernel): in one pass over the rows,
//   dW[e] = sum over the rows r of expert e of x1[r]^T x2[r]   (E, D1, D2)
//   db[e] = sum over the rows r of expert e of x2[r]           (E, D2)
// both in f32; an expert with padded_counts[e] == 0 gets exactly 0 (the TPU
// wrapper's mask, esfk.py:161). The biased MLP expert FFN's backward
// computes (dW2, db2) (x1 = h, x2 = dys) and (dW1, db1) (x1 = xs, x2 = dz)
// with it.
//
// What bounds it on this card: at training shapes (Swin-MoE-Small, stage 2
// of 0-3: Np 26,112 rows, D1 384, D2 1536) it reads (D1 + D2) Np elements
// and writes E D1 D2 + E D2 f32 values for 2 Np D1 D2 FLOPs: the operations
// bound it, at the f32 FMA rate this kernel uses. The design is that of
// csrc/estmm.cu, with db added:
//
//  * A CTA owns one (expert, 64-row D1 tile, 64-column D2 tile) output tile
//    and loops over that expert's contiguous run of rows, which starts at
//    the sum of padded_counts before e; tail blocks past the last group
//    belong to expert E-1, as block_expert clamps them. Every output has
//    one writer, so no atomics are needed and sums are taken in the same
//    order on every run. The TPU kernel instead walks the blocks in order
//    and flushes when block_expert changes, and parks the db writes of its
//    D1 tiles past the first on a junk row because Pallas writes a
//    revisited output block back on every visit; a GPU CTA writes once, so
//    neither is needed here.
//  * db: the CTAs of D1 tile 0 also sum the x2 columns they stage. Each
//    thread stages one fixed column of the x2 tile (every fourth row of a
//    step) and adds what it loads, so db reads no extra byte and every
//    thread does the same four adds a step; the four partial sums of a
//    column are combined in a fixed order through shared memory at the end.
//  * The row loop stages 16 rows of the x1 and x2 tiles in shared memory as
//    f32; each of the 256 threads keeps a 4 x 4 register tile of sums, rows
//    and columns strided by 16 so a warp's shared-memory reads hit distinct
//    banks or broadcast.
//  * An empty expert's CTAs write zeros and read nothing.
//
// Plain C interface for ctypes: esfk_launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 64;   // D1 rows of an output tile
constexpr int kBN = 64;   // D2 columns of an output tile
constexpr int kBK = 16;   // sorted rows staged per step
constexpr int kT = 4;     // a thread's rows and columns, strided by 16
static_assert(kThreads % kBN == 0, "a thread stages one fixed x2 column");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
esfk_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
            const int* __restrict__ padded_counts, float* __restrict__ dw,
            float* __restrict__ db, int np_rows, int d1, int d2,
            int num_experts) {
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
  const bool sums_db = blockIdx.y == 0;  // uniform across the CTA

  float acc[kT][kT], bsum = 0.0f;  // bsum: column tid % kBN of db
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
    // kThreads is a multiple of kBN: a thread always stages column tid % kBN
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      const int kk = idx / kBN, c = idx % kBN;
      const float v = (r0 + kk < hi && n0 + c < d2)
                          ? to_f(x2[(size_t)(r0 + kk) * d2 + n0 + c]) : 0.0f;
      bs[kk][c] = v;
      bsum += v;
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
      if (col < d2) dw[((size_t)e * d1 + row) * d2 + col] = acc[i][j];
    }
  }
  if (sums_db) {
    // the loop ended on a barrier, so bs is free: the kThreads / kBN
    // partial sums of each column, added in row-lane order
    constexpr int kLanes = kThreads / kBN;
    float* part = &bs[0][0];
    part[(tid / kBN) * kBN + tid % kBN] = bsum;
    __syncthreads();
    if (tid < kBN && n0 + tid < d2) {
      float sum = 0.0f;
#pragma unroll
      for (int l = 0; l < kLanes; ++l) sum += part[l * kBN + tid];
      db[(size_t)e * d2 + n0 + tid] = sum;
    }
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x1 and x2). x1 (Np, D1), x2 (Np, D2),
// padded_counts (E,) int32 (multiples of blk summing to at most Np), dw
// (E, D1, D2) f32 and db (E, D2) f32, every element written.
extern "C" int esfk_launch(const void* x1, const void* x2,
                           const void* padded_counts, void* dw, void* db,
                           int np_rows, int d1, int d2, int num_experts,
                           int dtype, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((d2 + kBN - 1) / kBN, (d1 + kBM - 1) / kBM, num_experts);
  if (dtype == 1)
    esfk_kernel<__nv_bfloat16><<<grid, kThreads, 0, s>>>(
        (const __nv_bfloat16*)x1, (const __nv_bfloat16*)x2,
        (const int*)padded_counts, (float*)dw, (float*)db, np_rows, d1, d2,
        num_experts);
  else
    esfk_kernel<float><<<grid, kThreads, 0, s>>>(
        (const float*)x1, (const float*)x2, (const int*)padded_counts,
        (float*)dw, (float*)db, np_rows, d1, d2, num_experts);
  return (int)cudaGetLastError();
}
