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
// The TPU grid walks the blocks in order and carries the f32 sum of one
// expert's run in VMEM, writing it when block_expert changes. Blocks run
// in no order on a GPU, so here a unit of work is one (expert, D1 tile,
// D2 tile) output tile, which loops over that expert's run of rows
// itself: the run is contiguous (the layout is sorted by expert) and
// starts at the sum of padded_counts before e. Tail blocks past the last
// group belong to expert E-1, as block_expert clamps them. Each output
// tile has exactly one writer, so there are no atomics and the sum is
// taken in the same row order on every run. An empty expert's tiles are
// written 0 and read nothing.
//
// What bounds it on this card: at the LM train head case (Np 49,024 rows,
// D1 2048, D2 768: 154 GFLOP) it reads 276 MB of x1 and x2 but writes
// 805 MB of f32 dW, so the bytes bound it at 0.323 ms (the store alone
// 0.24 ms), and each expert's run is only about 383 rows. In f32 the same
// shape reads 552 MB and is bound by its operations: 2.30 ms at the f32
// FMA rate, 0.935 ms as 3xTF32. Three routes, chosen by the wrapper
// (kernels/estmm.py::_route) before the launch; this file holds two, and
// f32 with whole 16-byte rows (D1 and D2 % 4 == 0) runs on the third,
// mma_tf32x3: esfk.cu's tensor-core kernel without db (esfk_dw_launch),
// 3xTF32 products promoted into f32 accumulators each k step, an
// expert's rows split over CTAs as kernels/esfk.py::_plan says and merged
// in split order, so repeated calls give the same bits and the unfused
// backward's dW (ESTMM + ESS) is the fused one's (ESFK) bit for bit.
//
// wgmma (route 1: bf16, blk % 64 == 0, D1 and D2 % 8 == 0):
//  * Persistent CTAs, two an SM, walk the tile list (128 D1 x 128 D2
//    tiles, ordered by expert, D2 tiles fastest) in a fixed stride, so the
//    CTAs in flight share an expert's rows in L2.
//  * A producer warp keeps a ring of 3 stages of TMA loads in flight: per
//    64-row K step, two 64 x 64 boxes of x1 (A = x1^T, MN-major) and two
//    of x2 (B, MN-major), 128-byte swizzle. The ring runs on across tiles,
//    so the next tile's loads overlap this tile's store.
//  * Two consumer warpgroups (64 D1 rows each) run four m64n128k16 wgmma
//    per stage, both transpose bits set, into 64 f32 registers a thread,
//    keep one wgmma group in flight, and store the tile with 8-byte f32
//    pair stores.
//
// simt (route 0: f32 rows that are not whole 16-byte copies, and bf16
// off the wgmma route): plain FMA, f32 sums: a CTA owns one (expert, 64 x 64) tile,
// stages 16 rows of the x1 and x2 tiles in shared memory as f32, and each
// of the 256 threads keeps a 4 x 4 register tile of sums, rows and columns
// strided by 16 so a warp's shared-memory reads hit distinct banks or
// broadcast.
//
// Plain C interface for ctypes: estmm_launch returns cudaGetLastError(), or
// cudaErrorInvalidValue for a route the operands cannot take.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

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


// ---- wgmma route --------------------------------------------------------

constexpr int kWgTile = 128;                   // D1 rows, D2 columns
constexpr int kWgStages = 3;
constexpr int kWgStageBytes = 4 * hopper::kBoxBytes64;  // 2 x1 + 2 x2 boxes
constexpr int kWgThreads = 2 * 128 + 32;       // + one producer warp
constexpr int kWgSmem = kWgStages * kWgStageBytes + 1024 + 2 * kWgStages * 8;

// [lo, hi) of expert e's rows, computed by a whole warp.
__device__ __forceinline__ int2 expert_run(const int* __restrict__ pc, int e,
                                           int np_rows, int num_experts) {
  int s = 0;
  for (int i = threadIdx.x % 32; i < e; i += 32) s += pc[i];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  const int count = pc[e];
  return make_int2(s, count == 0 ? s : (e == num_experts - 1 ? np_rows : s + count));
}

__global__ void __launch_bounds__(kWgThreads, 2)
estmm_wgmma_kernel(__grid_constant__ const CUtensorMap x1_map,
                   __grid_constant__ const CUtensorMap x2_map,
                   const int* __restrict__ padded_counts,
                   float* __restrict__ out, int np_rows, int d1, int d2,
                   int num_experts, int n_tiles, int tiles_per_expert) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + kWgStages * kWgStageBytes);
  uint64_t* empty = full + kWgStages;
  const int warp = threadIdx.x / 32;
  const int total = num_experts * tiles_per_expert;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kWgStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 2 * 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp == 8) {                      // producer warp: one lane loads
    int it = 0;                         // K steps issued over all tiles
    for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
      const int e = tile / tiles_per_expert;
      const int r = tile % tiles_per_expert;
      const int m0 = (r / n_tiles) * kWgTile, n0 = (r % n_tiles) * kWgTile;
      const int2 run = expert_run(padded_counts, e, np_rows, num_experts);
      if (threadIdx.x % 32 != 0) continue;
      for (int r0 = run.x; r0 < run.y; r0 += hopper::kTileK, ++it) {
        const int s = it % kWgStages;
        if (it >= kWgStages) hopper::mbar_wait(&empty[s], ((it / kWgStages) - 1) & 1);
        uint8_t* st = smem + s * kWgStageBytes;
        hopper::mbar_arrive_expect_tx(&full[s], kWgStageBytes);
        hopper::tma_load_2d(st, &x1_map, &full[s], m0, r0);
        hopper::tma_load_2d(st + hopper::kBoxBytes64, &x1_map, &full[s], m0 + 64, r0);
        hopper::tma_load_2d(st + 2 * hopper::kBoxBytes64, &x2_map, &full[s], n0, r0);
        hopper::tma_load_2d(st + 3 * hopper::kBoxBytes64, &x2_map, &full[s], n0 + 64, r0);
      }
    }
    return;
  }

  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  int it = 0;                           // K steps consumed over all tiles
  for (int tile = blockIdx.x; tile < total; tile += gridDim.x) {
    const int e = tile / tiles_per_expert;
    const int r = tile % tiles_per_expert;
    const int m0 = (r / n_tiles) * kWgTile, n0 = (r % n_tiles) * kWgTile;
    const int2 run = expert_run(padded_counts, e, np_rows, num_experts);
    float acc[64];
#pragma unroll
    for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
    if (run.x < run.y) {
      int prev = 0;
      for (int r0 = run.x; r0 < run.y; r0 += hopper::kTileK, ++it) {
        const int s = it % kWgStages;
        hopper::mbar_wait(&full[s], (it / kWgStages) & 1);
        const uint8_t* a = smem + s * kWgStageBytes + wg * hopper::kBoxBytes64;
        const uint8_t* b = smem + s * kWgStageBytes + 2 * hopper::kBoxBytes64;
        hopper::fence_acc(acc);
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
          hopper::Wgmma<128, 1, 1>::ss(
              acc, hopper::make_desc(a + kk * 2048, hopper::kBoxBytes64, 1024),
              hopper::make_desc(b + kk * 2048, hopper::kBoxBytes64, 1024), 1);
        hopper::wgmma_commit();
        hopper::fence_acc(acc);
        hopper::wgmma_wait<1>();        // the group before this one is done
        if (r0 > run.x) hopper::mbar_arrive(&empty[prev]);
        prev = s;
      }
      hopper::wgmma_wait<0>();
      hopper::fence_acc(acc);
      hopper::mbar_arrive(&empty[prev]);
    }
    const int row0 = m0 + 64 * wg;
    float* oe = out + (size_t)e * d1 * d2;
#pragma unroll
    for (int i = 0; i < 64; i += 2) {
      const int row = row0 + hopper::frag_row(t, i);
      const int col = n0 + hopper::frag_col(t, i);
      if (row < d1 && col < d2)
        *reinterpret_cast<float2*>(&oe[(size_t)row * d2 + col]) =
            make_float2(acc[i], acc[i + 1]);
    }
  }
}

int launch_wgmma(const void* x1, const void* x2, const void* padded_counts,
                 void* out, int np_rows, int d1, int d2, int num_experts,
                 int blk, cudaStream_t stream) {
  // Runs start and end on multiples of blk, so every 64-row K step lies
  // inside one expert's run.
  if ((blk != 64 && blk != 128) || d1 % 8 || d2 % 8 || np_rows % blk ||
      ((uintptr_t)x1 | (uintptr_t)x2) % 16)
    return (int)cudaErrorInvalidValue;
  CUtensorMap x1_map, x2_map;
  const uint32_t box[2] = {64, 64};
  const uint64_t x1_dims[2] = {(uint64_t)d1, (uint64_t)np_rows};
  const uint64_t x1_strides[1] = {(uint64_t)d1 * 2};
  const uint64_t x2_dims[2] = {(uint64_t)d2, (uint64_t)np_rows};
  const uint64_t x2_strides[1] = {(uint64_t)d2 * 2};
  if (!hopper::encode_bf16_map(&x1_map, x1, 2, x1_dims, x1_strides, box) ||
      !hopper::encode_bf16_map(&x2_map, x2, 2, x2_dims, x2_strides, box))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        estmm_wgmma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kWgSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int m_tiles = (d1 + kWgTile - 1) / kWgTile;
  const int n_tiles = (d2 + kWgTile - 1) / kWgTile;
  const int total = num_experts * m_tiles * n_tiles;
  const int grid = total < 2 * hopper::num_sms() ? total : 2 * hopper::num_sms();
  estmm_wgmma_kernel<<<grid, kWgThreads, kWgSmem, stream>>>(
      x1_map, x2_map, (const int*)padded_counts, (float*)out, np_rows, d1, d2,
      num_experts, n_tiles, m_tiles * n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x1 and x2). x1 (Np, D1), x2 (Np, D2),
// padded_counts (E,) int32 (multiples of blk summing to at most Np), out
// (E, D1, D2) f32, every element written. route: 0 = simt, 1 = wgmma
// (bf16, blk 64 or 128, D1 and D2 % 8 == 0, x1 and x2 16-byte aligned;
// anything else is refused).
extern "C" int estmm_launch(const void* x1, const void* x2,
                            const void* padded_counts, void* out, int np_rows,
                            int d1, int d2, int num_experts, int dtype,
                            int route, int blk, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_wgmma(x1, x2, padded_counts, out, np_rows, d1, d2,
                        num_experts, blk, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
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
