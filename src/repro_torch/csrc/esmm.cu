// Expert-specific matrix multiplication (ESMM) over the expert-sorted
// layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/esmm.py::esmm_pallas (body
// _esmm_kernel): ys = xs W[e] (+ b[e]) for every BLK-row block of the
// sorted layout, where e = block_expert[block], with W (E, K, N), or
// (E, N, K) read transposed (transpose_rhs: the dX and t = dy Wd^T
// orientation of the backward). Products accumulate in f32 from the bias
// (or 0; the bias is read as f32 whatever T is, as the TPU kernel casts it)
// and the output is rounded once to T, as the TPU kernel does.
//
// What bounds it on this card: at training shapes (Np ~ 49k rows, K 2048,
// N 768, or K 768, N 2048) it is a dense GEMM of 2 Np K N FLOPs against
// (Np K + E K N + Np N) elements: some 150 FLOP/byte, so the operations
// bound it, at the f32 FMA rate this kernel uses (tensor cores come later).
// The design therefore keeps the FMA units fed from shared memory:
//
//  * A CTA owns a BM x 64 output tile (BM = 64 at BLK 128, else the largest
//    of 32, 16, 8 that divides BLK), so its rows lie in one BLK block and
//    the CTA reads one expert's weight slice; the TPU kernel's BlockSpec
//    index map on block_expert becomes one load of block_expert in the CTA.
//  * The K loop stages a BM x 16 tile of xs and a 16 x 64 tile of W[e] in
//    shared memory as f32 (bf16 converted once on the way in); each of the
//    256 threads keeps a (BM/16) x 4 register tile of sums, columns strided
//    by 16 so the shared-memory reads of a warp hit distinct banks.
//  * The TPU kernel carries its f32 accumulator across the sequential K
//    grid axis in VMEM; here the K loop runs inside the CTA, so nothing
//    carries between CTAs and no atomics are needed.
//
// Plain C interface for ctypes: esmm_launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;   // output columns of a CTA
constexpr int kBK = 16;   // K slice staged per step
constexpr int kTN = 4;    // columns of a thread, strided by 16

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int BM, bool kTrans>
__global__ void __launch_bounds__(kThreads)
esmm_kernel(const T* __restrict__ xs, const T* __restrict__ w,
            const float* __restrict__ b, const int* __restrict__ block_expert,
            T* __restrict__ ys, int k, int n, int blk) {
  constexpr int TM = BM >= 16 ? BM / 16 : 1;
  constexpr int kRowThreads = BM / TM;  // 16, or 8 at BM 8
  __shared__ float as[kBK][BM + 4];     // xs tile, K-major
  __shared__ float bs[kBK][kBN + 4];    // W[e] tile, K-major

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int e = block_expert[m0 / blk];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const bool active = ty < kRowThreads;
  const T* we = w + (size_t)e * k * n;

  float acc[TM][kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int col = n0 + tx + 16 * j;
    const float bv = (b != nullptr && col < n) ? b[(size_t)e * n + col] : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = bv;
  }

  for (int k0 = 0; k0 < k; k0 += kBK) {
    for (int idx = tid; idx < BM * kBK; idx += kThreads) {
      const int r = idx / kBK, kk = idx % kBK;
      as[kk][r] = k0 + kk < k ? to_f(xs[(size_t)(m0 + r) * k + k0 + kk]) : 0.0f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      // neighbouring threads on neighbouring addresses of W
      const int kk = kTrans ? idx % kBK : idx / kBN;
      const int c = kTrans ? idx / kBK : idx % kBN;
      float v = 0.0f;
      if (k0 + kk < k && n0 + c < n)
        v = kTrans ? to_f(we[(size_t)(n0 + c) * k + k0 + kk])
                   : to_f(we[(size_t)(k0 + kk) * n + n0 + c]);
      bs[kk][c] = v;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kBK; ++kk) {
        float a[TM], bv[kTN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = as[kk][ty + kRowThreads * i];
#pragma unroll
        for (int j = 0; j < kTN; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kTN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const size_t row = (size_t)(m0 + ty + kRowThreads * i);
#pragma unroll
    for (int j = 0; j < kTN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col < n) ys[row * n + col] = from_f<T>(acc[i][j]);
    }
  }
}

template <typename T, int BM>
int launch_bm(const void* xs, const void* w, const void* b,
              const void* block_expert, void* ys, int np_rows, int k, int n,
              int blk, int transpose, cudaStream_t stream) {
  const dim3 grid(np_rows / BM, (n + kBN - 1) / kBN);
  if (transpose)
    esmm_kernel<T, BM, true><<<grid, kThreads, 0, stream>>>(
        (const T*)xs, (const T*)w, (const float*)b, (const int*)block_expert,
        (T*)ys, k, n, blk);
  else
    esmm_kernel<T, BM, false><<<grid, kThreads, 0, stream>>>(
        (const T*)xs, (const T*)w, (const float*)b, (const int*)block_expert,
        (T*)ys, k, n, blk);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* xs, const void* w, const void* b,
           const void* block_expert, void* ys, int np_rows, int k, int n,
           int blk, int transpose, cudaStream_t stream) {
  if (blk % 64 == 0)
    return launch_bm<T, 64>(xs, w, b, block_expert, ys, np_rows, k, n, blk, transpose, stream);
  if (blk % 32 == 0)
    return launch_bm<T, 32>(xs, w, b, block_expert, ys, np_rows, k, n, blk, transpose, stream);
  if (blk % 16 == 0)
    return launch_bm<T, 16>(xs, w, b, block_expert, ys, np_rows, k, n, blk, transpose, stream);
  return launch_bm<T, 8>(xs, w, b, block_expert, ys, np_rows, k, n, blk, transpose, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xs, w and ys alike). xs (Np, K);
// w (E, K, N), or (E, N, K) when transpose != 0; b (E, N) f32 or null;
// block_expert (Np / blk,); ys (Np, N). Requires blk % 8 == 0 and
// Np % blk == 0 (the wrapper checks).
extern "C" int esmm_launch(const void* xs, const void* w, const void* b,
                           const void* block_expert, void* ys, int np_rows,
                           int k, int n, int blk, int transpose, int dtype,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(xs, w, b, block_expert, ys, np_rows, k, n,
                                 blk, transpose, s);
  return launch<float>(xs, w, b, block_expert, ys, np_rows, k, n, blk,
                       transpose, s);
}
