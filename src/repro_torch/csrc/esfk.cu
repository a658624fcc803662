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
// with it. Its kernel without db (a compile-time switch: no db sums,
// partials or merge) is estmm's f32 route, esfk_dw_launch below: the same
// mainloop and merge, so at the same splits (both wrappers take
// kernels/esfk.py::_plan's) ESTMM's dW is the same bits as ESFK's.
//
// What bounds it on this card: at training shapes (Swin-MoE-Small, stage 2
// of 0-3: Np 26,112 rows, D1 384, D2 1536) it reads (D1 + D2) Np elements
// and writes E D1 D2 + E D2 f32 values for 2 Np D1 D2 FLOPs: the operations
// bound it, 0.460 ms at the f32 FMA rate and 0.187 ms as 3xTF32 on the
// tensor cores. The route (1 = mma_tf32x3 for f32 x1 and x2, 2 = mma_bf16
// for bf16) is chosen by the wrapper (kernels/esfk.py::_route) from the
// dtype before the launch.
//
// Both routes need D1 and D2 rows of whole 16-byte multiples and x1 and x2
// 16-byte aligned; the wrapper refuses other operands (no configuration of
// either package has such widths). esfk_mma_kernel, on mma_sync.cuh's
// mainloop: dW[e] is a GEMM with M = D1, N = D2 and K = the expert's rows.
//  * A CTA owns one (expert, 128-row D1 tile, 128-column D2 tile) output
//    tile and walks its expert's contiguous run of rows, which starts at
//    the sum of padded_counts before e; tail blocks past the last group
//    belong to expert E-1, as block_expert clamps them. The TPU kernel
//    instead walks the blocks in order and flushes when block_expert
//    changes, and parks the db writes of its D1 tiles past the first on a
//    junk row because Pallas writes a revisited output block back on every
//    visit; a GPU CTA writes once, so neither is needed here.
//  * The rows run in 32-deep slices through a 3-stage cp.async ring (bf16:
//    16-byte loads a stage ahead, converted to f32 as they are stored): A
//    = x1^T is staged M-major as x1's rows lie (contiguous in D1), B = x2
//    N-major; neither is transposed in memory. 3xTF32 products (one bf16
//    pass for bf16), each k step's products promoted into the f32
//    accumulators by a rounded add, so the error does not grow with the
//    thousands of rows an expert has (mma_sync.cuh).
//  * Waves: 128 x 128 tiles give 3 x 12 x 8 = 288 CTAs at stage 2, just over
//    the 264 that fit the card at two an SM, each walking ~3,260 rows, so a
//    second, nearly empty wave would cost close to half the launch. So an
//    expert's rows may be split over `splits` CTAs of the same tile (the
//    wrapper's _plan picks it from the shapes and the SM count; on the card 6
//    splits beat both 1 and 64-row tiles at stage 2, and one split is best at
//    stage 3's 1,152 tiles: PERF.md): each writes its f32 partial to a
//    workspace, and the last CTA of a tile to finish (a __threadfence and an
//    atomic ticket per tile, reset by that CTA) sums the partials in split
//    order, its own from registers. Every output has one writer and one
//    summation order, so each output is the same bits on every call; no
//    atomic touches a value.
//  * db: the CTAs of D1 tile 0 also sum x2's columns from the staged B
//    tile in shared memory, in a fixed order (thread t sums column t % 128
//    over rows 16 (t / 128) .. + 15 of each slice; the two halves are then
//    added in order), and the split partials of db merge as dW's do. x2
//    reaches shared memory by cp.async, so this reads no extra byte from
//    device memory.
//  * An empty expert's CTAs of split 0 write zeros and read nothing (the
//    TPU wrapper's mask, esfk.py:161); its other splits do nothing.
//
// Plain C interface for ctypes: esfk_launch returns cudaGetLastError(), or
// cudaErrorInvalidValue for a route or operands it refuses.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

// The run [lo, hi) of expert e's rows: padded_counts summed before e, to
// np_rows for the last expert (the tail blocks), empty when its count is
// 0. Read by warp 0; ends with a barrier.
__device__ __forceinline__ void expert_run(const int* __restrict__ padded_counts,
                                           int e, int np_rows, int num_experts,
                                           int (&run)[2]) {
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
}

constexpr int kMmaFlags = mma::kAMajorM | mma::kPromote;
// D1 rows of an output tile. 128; scripts/torch_kernel_times.py also
// builds 64 (-DESFK_TILE_M=64) to time that choice against it.
#ifndef ESFK_TILE_M
#define ESFK_TILE_M 128
#endif
constexpr int kMmaBM = ESFK_TILE_M;

// One (expert, kMmaBM x 128) tile of dW (and, with kDb, of db on D1 tile
// 0) over split `sp` of the expert's rows, on the tensor cores; with
// splits > 1 the last CTA of the tile merges the splits' partials (see the
// note). Without kDb (estmm's f32 route) db is null and untouched, and
// the dW sums are the same bits as with it.
template <typename T, bool kDb>
__global__ void __launch_bounds__(mma::kThreads, mma::kMinBlocks)
esfk_mma_kernel(const T* __restrict__ x1, const T* __restrict__ x2,
                const int* __restrict__ padded_counts, float* __restrict__ dw,
                float* __restrict__ db, float* __restrict__ partials,
                int* __restrict__ tickets, int np_rows, int d1, int d2,
                int num_experts, int splits) {
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  constexpr int BM = kMmaBM;
  using Tl = mma::Tile<BM, kBf16, kMmaFlags>;
  constexpr int BK = mma::kBK, BN = mma::kBN, NT = mma::kThreads, S = mma::kStages;
  constexpr int kHalves = NT / BN;           // row lanes of the db sums
  constexpr int kTiles = Tl::kMT * Tl::kNT;  // a thread's m16n8 tiles
  // register-staged 8-element chunks a thread a stage (bf16)
  constexpr int kARc = kBf16 ? BK * (BM / 8) / NT : 1;
  constexpr int kBRc = kBf16 ? BK * (BN / 8) / NT : 1;
  static_assert(NT % BN == 0 && BK % kHalves == 0, "db row lanes");
  extern __shared__ __align__(16) float sm[];
  __shared__ int run[2];
  __shared__ float dbs[kDb ? kHalves : 1][BN];
  __shared__ int last;

  const int tid = threadIdx.x;
  const int n_tiles = gridDim.x, m_tiles = gridDim.y;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;
  const int e = blockIdx.z / splits, sp = blockIdx.z % splits;
  const bool sums_db = kDb && blockIdx.y == 0;  // uniform across the CTA
  expert_run(padded_counts, e, np_rows, num_experts, run);
  if (run[0] == run[1]) {  // an empty expert: zeros, nothing read
    if (sp != 0) return;
    for (int idx = tid; idx < BM * BN; idx += NT) {
      const int r = m0 + idx / BN, c = n0 + idx % BN;
      if (r < d1 && c < d2) dw[((size_t)e * d1 + r) * d2 + c] = 0.0f;
    }
    if (sums_db && tid < BN && n0 + tid < d2) db[(size_t)e * d2 + n0 + tid] = 0.0f;
    return;
  }
  // this split's rows: whole 32-row slices but the run's last
  const int len = run[1] - run[0];
  const int chunk = ((len + splits - 1) / splits + BK - 1) / BK * BK;
  const int lo = min(run[1], run[0] + sp * chunk);
  const int hi = min(run[1], lo + chunk);

  mma::Warp<BM, kBf16, kMmaFlags> wp;
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Tl::kNT; ++nt)
#pragma unroll
      for (int i = 0; i < 4; ++i) wp.acc[mt][nt][i] = 0.0f;
  float bsum = 0.0f;  // db: column tid % BN over row lane tid / BN

  const int nk = (hi - lo + BK - 1) / BK;
  uint4 ra[kARc], rb[kBRc];
  auto stage_a = [&](int st) { return sm + st * Tl::kStageF; };
  auto stage_b = [&](int st) { return sm + st * Tl::kStageF + Tl::kAF; };
  // slice kt: A [BK][BM] from x1's rows, B [BK][BN] from x2's; rows past
  // hi and columns past the widths are zeros
  auto load_async = [&](int kt, int st) {
    if constexpr (!kBf16) {
      const int r0 = lo + kt * BK;
      float* as = stage_a(st);
      float* bs = stage_b(st);
      for (int idx = tid; idx < BK * BM / 4; idx += NT) {
        const int kk = idx / (BM / 4), c = idx % (BM / 4) * 4;
        const bool v = r0 + kk < hi && m0 + c < d1;
        hopper::cp_async16(as + kk * Tl::kAS + c,
                           v ? x1 + (size_t)(r0 + kk) * d1 + m0 + c : x1, v);
      }
      for (int idx = tid; idx < BK * BN / 4; idx += NT) {
        const int kk = idx / (BN / 4), c = idx % (BN / 4) * 4;
        const bool v = r0 + kk < hi && n0 + c < d2;
        hopper::cp_async16(bs + kk * Tl::kBS + c,
                           v ? x2 + (size_t)(r0 + kk) * d2 + n0 + c : x2, v);
      }
    }
  };
  auto load_regs = [&](int kt) {
    if constexpr (kBf16) {
      const int r0 = lo + kt * BK;
#pragma unroll
      for (int i = 0; i < kARc; ++i) {
        const int idx = tid + i * NT, kk = idx / (BM / 8), c = idx % (BM / 8) * 8;
        ra[i] = (r0 + kk < hi && m0 + c < d1) ? mma::ld8(x1 + (size_t)(r0 + kk) * d1 + m0 + c)
                                              : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int i = 0; i < kBRc; ++i) {
        const int idx = tid + i * NT, kk = idx / (BN / 8), c = idx % (BN / 8) * 8;
        rb[i] = (r0 + kk < hi && n0 + c < d2) ? mma::ld8(x2 + (size_t)(r0 + kk) * d2 + n0 + c)
                                              : make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto store_regs = [&](int st) {
    if constexpr (kBf16) {
      float v[8];
#pragma unroll
      for (int i = 0; i < kARc; ++i) {
        const int idx = tid + i * NT, kk = idx / (BM / 8), c = idx % (BM / 8) * 8;
        mma::cvt8(ra[i], v, T());
        mma::st8(stage_a(st) + kk * Tl::kAS + c, v);
      }
#pragma unroll
      for (int i = 0; i < kBRc; ++i) {
        const int idx = tid + i * NT, kk = idx / (BN / 8), c = idx % (BN / 8) * 8;
        mma::cvt8(rb[i], v, T());
        mma::st8(stage_b(st) + kk * Tl::kBS + c, v);
      }
    }
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) {
      load_async(s, s);
      load_regs(s);
      store_regs(s);
    }
    hopper::cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    hopper::cp_async_wait<S - 2>();
    __syncthreads();  // slice kt is in; every warp is done with slice kt - 1
    const int nx = kt + S - 1;
    if (nx < nk) {
      load_async(nx, nx % S);
      load_regs(nx);
    }
    hopper::cp_async_commit();
    const float* bs = stage_b(kt % S);
    wp.step(stage_a(kt % S), bs);
    if (sums_db) {
      const float* p = bs + (tid / BN) * (BK / kHalves) * Tl::kBS + tid % BN;
#pragma unroll
      for (int j = 0; j < BK / kHalves; ++j) bsum += p[j * Tl::kBS];
    }
    if (nx < nk) store_regs(nx % S);
  }
  hopper::cp_async_wait<0>();
  float dbp = 0.0f;  // this CTA's db of column tid (tid < BN)
  if (sums_db) {
    dbs[tid / BN][tid % BN] = bsum;
    __syncthreads();
    if (tid < BN) {
#pragma unroll
      for (int h = 0; h < kHalves; ++h) dbp += dbs[h][tid];
    }
  }

  const int tile = (e * m_tiles + blockIdx.y) * n_tiles + blockIdx.x;
  // partials: (tiles, splits, kTiles, NT) float4 of dW (a thread's m16n8
  // tiles, BM x BN floats a split), then (E, n_tiles, splits, BN) f32 of db
  float4* part = reinterpret_cast<float4*>(partials);
  float* dbpart = partials + (size_t)num_experts * m_tiles * n_tiles * splits * BM * BN;
  auto part_at = [&](int j, int i) { return part + (((size_t)tile * splits + j) * kTiles + i) * NT + tid; };
  auto dbpart_at = [&](int j) {
    return dbpart + (((size_t)e * n_tiles + blockIdx.x) * splits + j) * BN + tid;
  };
  if (splits > 1) {
#pragma unroll
    for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
      for (int nt = 0; nt < Tl::kNT; ++nt) {
        const float* a = wp.acc[mt][nt];
        __stcg(part_at(sp, mt * Tl::kNT + nt), make_float4(a[0], a[1], a[2], a[3]));
      }
    if (sums_db && tid < BN) __stcg(dbpart_at(sp), dbp);
    __threadfence();
    __syncthreads();
    if (tid == 0) last = atomicAdd(tickets + tile, 1) == splits - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
  }

  // the sum over the splits in split order, this CTA's own from registers
#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int nt = 0; nt < Tl::kNT; ++nt) {
      const float* a = wp.acc[mt][nt];
      const float4 mine = make_float4(a[0], a[1], a[2], a[3]);
      float4 v = sp == 0 ? mine : __ldcg(part_at(0, mt * Tl::kNT + nt));
      for (int j = 1; j < splits; ++j) {
        const float4 p = j == sp ? mine : __ldcg(part_at(j, mt * Tl::kNT + nt));
        v.x += p.x, v.y += p.y, v.z += p.z, v.w += p.w;
      }
      const int c = n0 + wp.col(nt);
      if (c >= d2) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = m0 + wp.row(mt, half);
        if (r < d1)
          *reinterpret_cast<float2*>(dw + ((size_t)e * d1 + r) * d2 + c) =
              half ? make_float2(v.z, v.w) : make_float2(v.x, v.y);
      }
    }
  if (sums_db && tid < BN && n0 + tid < d2) {
    float v = sp == 0 ? dbp : __ldcg(dbpart_at(0));
    for (int j = 1; j < splits; ++j) v += j == sp ? dbp : __ldcg(dbpart_at(j));
    db[(size_t)e * d2 + n0 + tid] = v;
  }
  if (splits > 1 && tid == 0) tickets[tile] = 0;  // ready for the next call
}

template <typename T, bool kDb>
int launch_mma(const void* x1, const void* x2, const void* padded_counts,
               void* dw, void* db, void* partials, void* tickets, int np_rows,
               int d1, int d2, int num_experts, int splits,
               cudaStream_t stream) {
  constexpr int kAlign = 16 / sizeof(T);
  if (splits < 1 || d1 % kAlign || d2 % kAlign || (kDb && db == nullptr) ||
      ((uintptr_t)x1 | (uintptr_t)x2) % 16 ||
      (splits > 1 && (partials == nullptr || tickets == nullptr)))
    return (int)cudaErrorInvalidValue;
  constexpr int smem = mma::Tile<kMmaBM, std::is_same<T, __nv_bfloat16>::value,
                                 kMmaFlags>::kSmem;
  auto kernel = esfk_mma_kernel<T, kDb>;
  static bool configured = false;       // one attribute set per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((d2 + mma::kBN - 1) / mma::kBN, (d1 + kMmaBM - 1) / kMmaBM,
                  num_experts * splits);
  kernel<<<grid, mma::kThreads, smem, stream>>>(
      (const T*)x1, (const T*)x2, (const int*)padded_counts, (float*)dw,
      (float*)db, (float*)partials, (int*)tickets, np_rows, d1, d2,
      num_experts, splits);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x1 and x2). x1 (Np, D1), x2 (Np, D2),
// padded_counts (E,) int32 (multiples of blk summing to at most Np), dw
// (E, D1, D2) f32 and db (E, D2) f32, every element written. route: 1 =
// mma_tf32x3 (float32) or 2 = mma_bf16 (bfloat16), with D1 and D2 rows
// 16-byte multiples, x1 and x2 16-byte aligned and splits >= 1 CTAs an
// expert's rows; with splits > 1, partials holds ceil(D1 / BM) *
// ceil(D2 / 128) * E * splits * BM * 128 + E * ceil(D2 / 128) * splits *
// 128 f32 and tickets ceil(D1 / BM) * ceil(D2 / 128) * E int32 (BM =
// ESFK_TILE_M, 128), the tickets 0 before the first call (each call leaves
// them 0). Anything else is refused.
extern "C" int esfk_launch(const void* x1, const void* x2,
                           const void* padded_counts, void* dw, void* db,
                           void* partials, void* tickets, int np_rows, int d1,
                           int d2, int num_experts, int dtype, int route,
                           int splits, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1 && dtype == 0)
    return launch_mma<float, true>(x1, x2, padded_counts, dw, db, partials,
                                   tickets, np_rows, d1, d2, num_experts,
                                   splits, s);
  if (route == 2 && dtype == 1)
    return launch_mma<__nv_bfloat16, true>(x1, x2, padded_counts, dw, db,
                                           partials, tickets, np_rows, d1, d2,
                                           num_experts, splits, s);
  return (int)cudaErrorInvalidValue;
}

// estmm's mma_tf32x3 route (kernels/estmm.py): dW alone, f32 x1 and x2, on
// the same kernel without db. The operands as esfk_launch's; partials need
// only the dW part (ceil(D1 / BM) * ceil(D2 / 128) * E * splits * BM * 128
// f32 with splits > 1) and the tickets are shared with esfk's calls on the
// same stream (each call leaves them 0).
extern "C" int esfk_dw_launch(const void* x1, const void* x2,
                              const void* padded_counts, void* dw,
                              void* partials, void* tickets, int np_rows,
                              int d1, int d2, int num_experts, int splits,
                              void* stream) {
  return launch_mma<float, false>(x1, x2, padded_counts, dw, nullptr,
                                  partials, tickets, np_rows, d1, d2,
                                  num_experts, splits,
                                  (cudaStream_t)stream);
}
