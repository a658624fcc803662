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
// What bounds it on this card: a dense grouped GEMM. At the LM train head
// case (Np 49,024 rows, K 2048, N 768, blk 128: 154.2 GFLOP, about 680 MB
// of xs, the W of the experts with rows, and ys) the bytes take 0.203 ms
// at 3.35 TB/s and the operations 0.156 ms at 989 TFLOP/s, so only the
// tensor cores come near the bound. At the Swin-MoE-Small stage-2 shapes
// in f32 (Np 26,112, K 384 -> N 1536 and back: 30.8 GFLOP) the f32 FMA
// bound is 0.460 ms and the 3xTF32 one 0.187. Three routes, chosen by the
// wrapper (kernels/esmm.py::_route) before the launch and passed in
// `route`; a route refuses operands it cannot take, none gives way:
//
// wgmma (route 1: bf16, blk % 64 == 0, K and N % 8 == 0):
//  * A CTA owns one BLK block's rows (BM = blk: two consumer warpgroups of
//    64 rows at blk 128, one at blk 64) and a 128-column N tile, so it
//    reads one expert's W. A producer warp keeps a ring of TMA loads in
//    flight (3 stages at blk 128, 4 at blk 64; K steps of 64, 128-byte
//    swizzle): the BM x 64 xs tile (K-major A) and the 64 x 128 W tile,
//    K-major B with transpose_rhs (one 128 x 64 box of W (E, N, K)) or
//    MN-major B without it (two 64-column boxes of W (E, K, N); the
//    wgmma transpose bit reads it, the weights are not transposed in
//    memory). W is a 3-D tensor map with the expert as its outer
//    coordinate, so a tile past K or N reads zeros, never the next
//    expert's rows.
//  * Each consumer warpgroup runs four m64n128k16 wgmma per stage into 64
//    f32 registers a thread, started from the f32 bias, keeps one wgmma
//    group in flight and releases a stage when the group before it is
//    done. The epilogue rounds once to bf16 and stores bf16 pairs. This
//    mainloop is hopper.cuh's SortedGemm, which esffn.cu's down product
//    shares.
//  * CTA order: the N tiles of one block are neighbours, and neighbouring
//    blocks share their expert (the layout is sorted), so the CTAs in
//    flight read each xs block once from device memory and each W[e] tile
//    about once, then from L2. Two CTAs an SM (97 KB of shared memory
//    each), so one's epilogue overlaps the other's loads.
//
// mma_tf32x3 (route 2: f32 xs and W with K and N % 4; and every 8-bit W,
// with f32 or bf16 xs, K and N % 8; xs and W 16-byte aligned): the Swin
// slice's f32 z, t and dX products and the 8-bit weights, on the tensor
// cores through mma_sync.cuh's mainloop (esmm_mma_kernel):
//  * A CTA owns BM rows of one block (BM = 128 at blk 128, else the
//    largest of 64, 32, 16 that divides blk; at blk 8 a 16-row tile holds
//    the block's 8 rows and zeros, never written) and 128 columns, so it
//    reads one expert's W. The N tiles of one row tile are neighbours in
//    launch order, as on the wgmma route.
//  * K runs in 32-deep slices through a 3-stage ring. f32 xs and W come by
//    16-byte cp.async; with transpose_rhs W (E, N, K) is staged K-major
//    as stored (its rows are contiguous in K), so W is never transposed.
//    8-bit W comes by 8-byte loads a stage ahead and is dequantized as it
//    is stored, float(q) * s with one scale lookup per 8-element chunk
//    where the chunk lies in one scale block, so only the 8-bit bytes
//    cross HBM and the products are the f32 ones of the TPU kernel's
//    dequantized tile; bf16 xs comes by 16-byte loads, converted.
//  * 3xTF32 products (f32 results within a few ulps of an FMA sum) with
//    each k step's products promoted into the f32 accumulators by a
//    rounded add, so the error does not grow with K (mma_sync.cuh). With
//    bf16 xs, hi(x) = x and lo(x) = 0, so the lo(x) hi(w) product is
//    skipped: two products, the same bits. The accumulators start from
//    the f32 bias; the output is rounded once to T.
//
// simt (route 0: only what the other two refuse: bf16 at blk 8..32, and
// widths whose rows are not 16-byte multiples), f32 FMA from shared
// memory:
//  * A CTA owns a BM x 64 output tile (BM = 64 at BLK 128, else the largest
//    of 32, 16, 8 that divides BLK), so its rows lie in one BLK block and
//    the CTA reads one expert's weight slice.
//  * The K loop stages a BM x 16 tile of xs and a 16 x 64 tile of W[e] in
//    shared memory as f32 (bf16 and 8-bit converted once on the way in,
//    8-bit times its block scale); each of the 256 threads keeps a
//    (BM/16) x 4 register tile of sums, columns strided by 16 so the
//    shared-memory reads of a warp hit distinct banks.
//
// The TPU kernel carries its f32 accumulator across the sequential K grid
// axis in VMEM; here the K loop runs inside the CTA on every route, so
// nothing carries between CTAs and no atomics are needed.
//
// 8-bit weights (esmm_q_launch; the has_scale branch of the TPU kernel,
// quant.core.dequant_tile): W is an int8 or fp8 e4m3 payload with f32
// block scales s on W's own two axes, (E, K / ta, N / tb), or (E, N / ta,
// K / tb) with transpose_rhs, each element dequantized where it is
// staged, float(q) * s[e][row / ta][col / tb], on the mma_tf32x3 or simt
// route.
//
// Plain C interface for ctypes: esmm_launch and esmm_q_launch return
// cudaGetLastError(), or cudaErrorInvalidValue for a route or operands
// they refuse.

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kBN = 64;   // output columns of a CTA
constexpr int kBK = 16;   // K slice staged per step
constexpr int kTN = 4;    // columns of a thread, strided by 16

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) { return float(v); }

// Block scales of an 8-bit W (E, rows, cols) on its own axes: f32 s (E,
// rows / ta, cols / tb), s[e][r / ta][c / tb] scaling element (r, c) of
// W[e]. Unused (s null) when W is stored in the activation dtype.
struct Scales {
  const float* s;
  int rows, cols, ta, tb;
  // the scale of block (rb, cb) of W[e]
  __device__ __forceinline__ float block(int e, int rb, int cb) const {
    return s[((size_t)e * (rows / ta) + rb) * (cols / tb) + cb];
  }
};

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, typename W, int BM, bool kTrans>
__global__ void __launch_bounds__(kThreads)
esmm_kernel(const T* __restrict__ xs, const W* __restrict__ w, Scales sw,
            const float* __restrict__ b, const int* __restrict__ block_expert,
            T* __restrict__ ys, int k, int n, int blk) {
  constexpr bool kQuant = !std::is_same<T, W>::value;
  constexpr int TM = BM >= 16 ? BM / 16 : 1;
  constexpr int kRowThreads = BM / TM;  // 16, or 8 at BM 8
  __shared__ float as[kBK][BM + 4];     // xs tile, K-major
  __shared__ float bs[kBK][kBN + 4];    // W[e] tile, K-major
  // 8-bit W: the block-scale index of each N column of the tile and of
  // each K row of the step, so staging an element divides nothing
  __shared__ int sn[kBN], sk[kBK];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kBN;
  const int e = block_expert[m0 / blk];
  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const bool active = ty < kRowThreads;
  const W* we = w + (size_t)e * k * n;
  if constexpr (kQuant) {
    for (int c = tid; c < kBN; c += kThreads) sn[c] = (n0 + c) / (kTrans ? sw.ta : sw.tb);
  }

  float acc[TM][kTN];
#pragma unroll
  for (int j = 0; j < kTN; ++j) {
    const int col = n0 + tx + 16 * j;
    const float bv = (b != nullptr && col < n) ? b[(size_t)e * n + col] : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = bv;
  }

  for (int k0 = 0; k0 < k; k0 += kBK) {
    if constexpr (kQuant) {
      if (tid < kBK) sk[tid] = (k0 + tid) / (kTrans ? sw.tb : sw.ta);
      __syncthreads();
    }
    for (int idx = tid; idx < BM * kBK; idx += kThreads) {
      const int r = idx / kBK, kk = idx % kBK;
      as[kk][r] = k0 + kk < k ? to_f(xs[(size_t)(m0 + r) * k + k0 + kk]) : 0.0f;
    }
    for (int idx = tid; idx < kBK * kBN; idx += kThreads) {
      // neighbouring threads on neighbouring addresses of W
      const int kk = kTrans ? idx % kBK : idx / kBN;
      const int c = kTrans ? idx / kBK : idx % kBN;
      float v = 0.0f;
      if (k0 + kk < k && n0 + c < n) {
        // element (r, c) of W[e]: (n0 + c, k0 + kk) with transpose_rhs
        const int wr = kTrans ? n0 + c : k0 + kk;
        const int wc = kTrans ? k0 + kk : n0 + c;
        v = to_f(we[(size_t)wr * (kTrans ? k : n) + wc]);
        if constexpr (kQuant)
          v *= kTrans ? sw.block(e, sn[c], sk[kk]) : sw.block(e, sk[kk], sn[c]);
      }
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

template <typename T, typename W, int BM>
int launch_bm(const void* xs, const void* w, Scales sw, const void* b,
              const void* block_expert, void* ys, int np_rows, int k, int n,
              int blk, int transpose, cudaStream_t stream) {
  const dim3 grid(np_rows / BM, (n + kBN - 1) / kBN);
  if (transpose)
    esmm_kernel<T, W, BM, true><<<grid, kThreads, 0, stream>>>(
        (const T*)xs, (const W*)w, sw, (const float*)b,
        (const int*)block_expert, (T*)ys, k, n, blk);
  else
    esmm_kernel<T, W, BM, false><<<grid, kThreads, 0, stream>>>(
        (const T*)xs, (const W*)w, sw, (const float*)b,
        (const int*)block_expert, (T*)ys, k, n, blk);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch(const void* xs, const void* w, Scales sw, const void* b,
           const void* block_expert, void* ys, int np_rows, int k, int n,
           int blk, int transpose, cudaStream_t stream) {
  if (blk % 64 == 0)
    return launch_bm<T, W, 64>(xs, w, sw, b, block_expert, ys, np_rows, k, n, blk, transpose, stream);
  if (blk % 32 == 0)
    return launch_bm<T, W, 32>(xs, w, sw, b, block_expert, ys, np_rows, k, n, blk, transpose, stream);
  if (blk % 16 == 0)
    return launch_bm<T, W, 16>(xs, w, sw, b, block_expert, ys, np_rows, k, n, blk, transpose, stream);
  return launch_bm<T, W, 8>(xs, w, sw, b, block_expert, ys, np_rows, k, n, blk, transpose, stream);
}



// ---- mma_tf32x3 route -----------------------------------------------------

// The flags of the mainloop for xs of type T: W K-major with transpose_rhs,
// bf16 xs exact in TF32 (two products), and every k step promoted.
template <typename T, bool kTrans>
constexpr int kMmaFlags = mma::kPromote | (kTrans ? mma::kBMajorK : 0) |
                          (std::is_same<T, float>::value ? 0 : mma::kAExact);

// One BM x 128 tile of ys on the tensor cores (mma_sync.cuh): `rows` <= BM
// rows of one block (rows < BM only at blk 8, where the tile's other rows
// are zeros and never written) and 128 columns, on expert e =
// block_expert of the block. T: xs and ys (bf16 only with an 8-bit W); W:
// T itself (f32) or int8 / e4m3, dequantized with sw as it is staged.
template <typename T, typename W, int BM, bool kTrans>
__global__ void __launch_bounds__(mma::kThreads, mma::kMinBlocks)
esmm_mma_kernel(const T* __restrict__ xs, const W* __restrict__ w, Scales sw,
                const float* __restrict__ b, const int* __restrict__ block_expert,
                T* __restrict__ ys, int k, int n, int blk, int rows) {
  constexpr bool kQuant = !std::is_same<T, W>::value;
  constexpr bool kAsyncA = std::is_same<T, float>::value;
  constexpr bool kAsyncB = std::is_same<W, float>::value;
  constexpr int kFlags = kMmaFlags<T, kTrans>;
  using Tl = mma::Tile<BM, false, kFlags>;
  constexpr int BK = mma::kBK, BN = mma::kBN, NT = mma::kThreads, S = mma::kStages;
  // register-staged 8-element chunks a thread a stage
  constexpr int kARc = kAsyncA ? 1 : (BM * (BK / 8) + NT - 1) / NT;
  constexpr int kBRc = kAsyncB ? 1 : BK * (BN / 8) / NT;
  extern __shared__ __align__(16) float sm[];
  // 8-bit W: the scale block of each of the tile's 128 N indices (W's
  // columns, or its rows with transpose_rhs)
  __shared__ int sn[BN];

  const int tid = threadIdx.x;
  const int n0 = blockIdx.x * BN;
  const int m0 = blockIdx.y * rows;
  const int e = block_expert[m0 / blk];
  const W* we = w + (size_t)e * k * n;
  if constexpr (kQuant) {
    for (int c = tid; c < BN; c += NT) sn[c] = min(n0 + c, n - 1) / (kTrans ? sw.ta : sw.tb);
    __syncthreads();
  }

  mma::Warp<BM, false, kFlags> wp;
#pragma unroll
  for (int nt = 0; nt < Tl::kNT; ++nt) {
    const int c = n0 + wp.col(nt);
    const bool on = b != nullptr && c < n;
    const float b0 = on ? b[(size_t)e * n + c] : 0.0f;
    const float b1 = on ? b[(size_t)e * n + c + 1] : 0.0f;
#pragma unroll
    for (int mt = 0; mt < Tl::kMT; ++mt) {
      wp.acc[mt][nt][0] = wp.acc[mt][nt][2] = b0;
      wp.acc[mt][nt][1] = wp.acc[mt][nt][3] = b1;
    }
  }

  const int nk = (k + BK - 1) / BK;
  uint4 ra[kARc], rb[kBRc];
  auto stage_a = [&](int st) { return sm + st * Tl::kStageF; };
  auto stage_b = [&](int st) { return sm + st * Tl::kStageF + Tl::kAF; };
  // cp.async part of K slice kt (f32 operands)
  auto load_async = [&](int kt, int st) {
    const int k0 = kt * BK;
    if constexpr (kAsyncA) {
      float* as = stage_a(st);
      for (int idx = tid; idx < BM * (BK / 4); idx += NT) {
        const int r = idx / (BK / 4), c = idx % (BK / 4) * 4;
        const bool v = r < rows && k0 + c < k;
        hopper::cp_async16(as + r * Tl::kAS + c, v ? xs + (size_t)(m0 + r) * k + k0 + c : xs, v);
      }
    }
    if constexpr (kAsyncB) {
      float* bs = stage_b(st);
      for (int idx = tid; idx < BK * BN / 4; idx += NT) {
        if constexpr (kTrans) {   // [BN][BK]: row r of W (E, N, K)
          const int r = idx / (BK / 4), c = idx % (BK / 4) * 4;
          const bool v = n0 + r < n && k0 + c < k;
          hopper::cp_async16(bs + r * Tl::kBS + c,
                             v ? we + (size_t)(n0 + r) * k + k0 + c : we, v);
        } else {                  // [BK][BN]: row k0 + r of W (E, K, N)
          const int r = idx / (BN / 4), c = idx % (BN / 4) * 4;
          const bool v = k0 + r < k && n0 + c < n;
          hopper::cp_async16(bs + r * Tl::kBS + c,
                             v ? we + (size_t)(k0 + r) * n + n0 + c : we, v);
        }
      }
    }
  };
  // register part of K slice kt (bf16 xs, 8-bit W)
  auto load_regs = [&](int kt) {
    const int k0 = kt * BK;
    if constexpr (!kAsyncA) {
#pragma unroll
      for (int i = 0; i < kARc; ++i) {
        const int idx = tid + i * NT, r = idx / (BK / 8), c = idx % (BK / 8) * 8;
        ra[i] = (idx < BM * (BK / 8) && r < rows && k0 + c < k)
                    ? mma::ld8(xs + (size_t)(m0 + r) * k + k0 + c) : make_uint4(0, 0, 0, 0);
      }
    }
    if constexpr (!kAsyncB) {
#pragma unroll
      for (int i = 0; i < kBRc; ++i) {
        const int idx = tid + i * NT;
        if constexpr (kTrans) {
          const int r = idx / (BK / 8), c = idx % (BK / 8) * 8;
          rb[i] = (n0 + r < n && k0 + c < k) ? mma::ld8(we + (size_t)(n0 + r) * k + k0 + c)
                                             : make_uint4(0, 0, 0, 0);
        } else {
          const int r = idx / (BN / 8), c = idx % (BN / 8) * 8;
          rb[i] = (k0 + r < k && n0 + c < n) ? mma::ld8(we + (size_t)(k0 + r) * n + n0 + c)
                                             : make_uint4(0, 0, 0, 0);
        }
      }
    }
  };
  auto store_regs = [&](int kt, int st) {
    const int k0 = kt * BK;
    if constexpr (!kAsyncA) {
      float* as = stage_a(st);
#pragma unroll
      for (int i = 0; i < kARc; ++i) {
        const int idx = tid + i * NT, r = idx / (BK / 8), c = idx % (BK / 8) * 8;
        if (idx >= BM * (BK / 8)) continue;
        float v[8];
        mma::cvt8(ra[i], v, T());
        mma::st8(as + r * Tl::kAS + c, v);
      }
    }
    if constexpr (!kAsyncB) {
      float* bs = stage_b(st);
#pragma unroll
      for (int i = 0; i < kBRc; ++i) {
        const int idx = tid + i * NT;
        float v[8];
        mma::cvt8(rb[i], v, W());
        if constexpr (kTrans) {
          // 8 K elements of W row n0 + r: one scale row block, and one
          // column block unless the chunk straddles two
          const int r = idx / (BK / 8), c = idx % (BK / 8) * 8;
          if (k0 + c < k) {
            const int cb = (k0 + c) / sw.tb;
            if (cb == (k0 + c + 7) / sw.tb) {
              const float sc = sw.block(e, sn[r], cb);
#pragma unroll
              for (int j = 0; j < 8; ++j) v[j] *= sc;
            } else {
#pragma unroll
              for (int j = 0; j < 8; ++j) v[j] *= sw.block(e, sn[r], (k0 + c + j) / sw.tb);
            }
          }
          mma::st8(bs + r * Tl::kBS + c, v);
        } else {
          // 8 N elements of W row k0 + r
          const int r = idx / (BN / 8), c = idx % (BN / 8) * 8;
          if (k0 + r < k) {
            const int rbk = (k0 + r) / sw.ta;
            if (sn[c] == sn[c + 7]) {
              const float sc = sw.block(e, rbk, sn[c]);
#pragma unroll
              for (int j = 0; j < 8; ++j) v[j] *= sc;
            } else {
#pragma unroll
              for (int j = 0; j < 8; ++j) v[j] *= sw.block(e, rbk, sn[c + j]);
            }
          }
          mma::st8(bs + r * Tl::kBS + c, v);
        }
      }
    }
  };

#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) {
      load_async(s, s);
      load_regs(s);
      store_regs(s, s);
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
    wp.step(stage_a(kt % S), stage_b(kt % S));
    if (nx < nk) store_regs(nx, nx % S);
  }
  hopper::cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = wp.row(mt, half);
      if (r >= rows) continue;  // the zero rows of a 16-row tile at blk 8
      T* out = ys + (size_t)(m0 + r) * n;
#pragma unroll
      for (int nt = 0; nt < Tl::kNT; ++nt) {
        const int c = n0 + wp.col(nt);
        if (c >= n) continue;
        const float v0 = wp.acc[mt][nt][2 * half], v1 = wp.acc[mt][nt][2 * half + 1];
        if constexpr (std::is_same<T, float>::value)
          *reinterpret_cast<float2*>(out + c) = make_float2(v0, v1);
        else
          *reinterpret_cast<__nv_bfloat162*>(out + c) = __floats2bfloat162_rn(v0, v1);
      }
    }
}

template <typename T, typename W, int BM, bool kTrans>
int mma_launch_one(const void* xs, const void* w, Scales sw, const void* b,
                   const void* block_expert, void* ys, int np_rows, int k,
                   int n, int blk, int rows, cudaStream_t stream) {
  constexpr int smem = mma::Tile<BM, false, kMmaFlags<T, kTrans>>::kSmem;
  auto kernel = esmm_mma_kernel<T, W, BM, kTrans>;
  static bool configured = false;       // one attribute set per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid((n + mma::kBN - 1) / mma::kBN, np_rows / rows);
  kernel<<<grid, mma::kThreads, smem, stream>>>(
      (const T*)xs, (const W*)w, sw, (const float*)b,
      (const int*)block_expert, (T*)ys, k, n, blk, rows);
  return (int)cudaGetLastError();
}

// A tile is BM rows of one block, BM the largest of 128, 64, 32, 16 that
// divides blk; at blk % 16 != 0 a 16-row tile holds one 8-row block.
template <typename T, typename W>
int mma_launch(const void* xs, const void* w, Scales sw, const void* b,
               const void* block_expert, void* ys, int np_rows, int k, int n,
               int blk, int transpose, cudaStream_t stream) {
  constexpr int kAlign = std::is_same<W, float>::value ? 4 : 8;
  if (blk % 8 || blk < 8 || blk > 128 || np_rows % blk || k % kAlign ||
      n % kAlign || ((uintptr_t)xs | (uintptr_t)w) % 16)
    return (int)cudaErrorInvalidValue;
#define ESMM_MMA(BM, ROWS)                                                     \
  return transpose ? mma_launch_one<T, W, BM, true>(xs, w, sw, b, block_expert, \
                                                    ys, np_rows, k, n, blk,    \
                                                    ROWS, stream)              \
                   : mma_launch_one<T, W, BM, false>(xs, w, sw, b,             \
                                                     block_expert, ys,         \
                                                     np_rows, k, n, blk, ROWS, \
                                                     stream)
  if (blk % 128 == 0) ESMM_MMA(128, 128);
  if (blk % 64 == 0) ESMM_MMA(64, 64);
  if (blk % 32 == 0) ESMM_MMA(32, 32);
  if (blk % 16 == 0) ESMM_MMA(16, 16);
  ESMM_MMA(16, 8);
#undef ESMM_MMA
}

// An 8-bit W (wdtype 1 = int8, 2 = fp8 e4m3) on route 0 (simt) or 2
// (mma_tf32x3).
template <typename T>
int launch_q(const void* xs, const void* w, Scales sw, const void* b,
             const void* block_expert, void* ys, int np_rows, int k, int n,
             int blk, int transpose, int wdtype, int route,
             cudaStream_t stream) {
#define ESMM_Q(W)                                                             \
  return route == 2 ? mma_launch<T, W>(xs, w, sw, b, block_expert, ys,        \
                                       np_rows, k, n, blk, transpose, stream) \
                    : launch<T, W>(xs, w, sw, b, block_expert, ys, np_rows,   \
                                   k, n, blk, transpose, stream)
  if (route != 0 && route != 2) return (int)cudaErrorInvalidValue;
  if (wdtype == 1) ESMM_Q(int8_t);
  if (wdtype == 2) ESMM_Q(__nv_fp8_e4m3);
#undef ESMM_Q
  return (int)cudaErrorInvalidValue;
}

// ---- wgmma route --------------------------------------------------------

template <int NC, bool kTrans>
__global__ void __launch_bounds__(hopper::SortedGemm<NC, kTrans>::kThreads, 2)
esmm_wgmma_kernel(__grid_constant__ const CUtensorMap xs_map,
                  __grid_constant__ const CUtensorMap w_map,
                  const float* __restrict__ b,
                  const int* __restrict__ block_expert,
                  __nv_bfloat16* __restrict__ ys, int k, int n, int n_tiles) {
  using G = hopper::SortedGemm<NC, kTrans>;
  extern __shared__ uint8_t smem_raw[];
  uint64_t *full, *empty;
  uint8_t* smem = G::setup(smem_raw, full, empty);

  const int blk_m = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * G::kBN;
  const int m0 = blk_m * G::kBM;
  const int e = block_expert[blk_m];
  const int nk = (k + hopper::kTileK - 1) / hopper::kTileK;
  const int warp = threadIdx.x / 32;

  if (warp == G::kProducerWarp) {
    G::produce(smem, full, empty, &xs_map, &w_map, m0, n0, e, nk);
    return;
  }

  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    const int col = n0 + hopper::frag_col(t, i);
    acc[i] = (b != nullptr && col < n) ? b[(size_t)e * n + col] : 0.0f;
  }
  G::consume(smem, full, empty, wg, nk, acc);

  const size_t row0 = (size_t)m0 + 64 * wg;
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int col = n0 + hopper::frag_col(t, i);
    if (col < n)
      *reinterpret_cast<__nv_bfloat162*>(
          &ys[(row0 + hopper::frag_row(t, i)) * n + col]) =
          __floats2bfloat162_rn(acc[i], acc[i + 1]);
  }
}

template <int NC, bool kTrans>
int launch_wgmma(const void* xs, const void* w, const void* b,
                 const void* block_expert, void* ys, int np_rows, int k, int n,
                 int num_experts, cudaStream_t stream) {
  using C = hopper::SortedGemm<NC, kTrans>;
  // xs (Np, K): boxes of 64 K x BM rows. W (E, K, N) or (E, N, K) as a 3-D
  // map, so a tile past K or N reads zeros, never the next expert's rows.
  CUtensorMap xs_map, w_map;
  const uint64_t xs_dims[2] = {(uint64_t)k, (uint64_t)np_rows};
  const uint64_t xs_strides[1] = {(uint64_t)k * 2};
  const uint32_t xs_box[2] = {64, (uint32_t)C::kBM};
  const uint64_t inner = kTrans ? k : n, outer = kTrans ? n : k;
  const uint64_t w_dims[3] = {inner, outer, (uint64_t)num_experts};
  const uint64_t w_strides[2] = {inner * 2, inner * outer * 2};
  const uint32_t w_box[3] = {64, kTrans ? (uint32_t)C::kBN : 64u, 1};
  if (!hopper::encode_bf16_map(&xs_map, xs, 2, xs_dims, xs_strides, xs_box) ||
      !hopper::encode_bf16_map(&w_map, w, 3, w_dims, w_strides, w_box))
    return (int)cudaErrorInvalidValue;
  auto kernel = esmm_wgmma_kernel<NC, kTrans>;
  static bool configured = false;       // one attribute set per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int n_tiles = (n + C::kBN - 1) / C::kBN;
  kernel<<<(np_rows / C::kBM) * n_tiles, C::kThreads, C::kSmem, stream>>>(
      xs_map, w_map, (const float*)b, (const int*)block_expert,
      (__nv_bfloat16*)ys, k, n, n_tiles);
  return (int)cudaGetLastError();
}

int launch_wgmma_route(const void* xs, const void* w, const void* b,
                       const void* block_expert, void* ys, int np_rows, int k,
                       int n, int blk, int transpose, int num_experts,
                       cudaStream_t stream) {
  // The wrapper's _route decides; refuse what the tiles cannot take.
  if ((blk != 64 && blk != 128) || k % 8 || n % 8 || np_rows % blk ||
      num_experts < 1 || ((uintptr_t)xs | (uintptr_t)w) % 16)
    return (int)cudaErrorInvalidValue;
  if (blk == 128)
    return transpose ? launch_wgmma<2, true>(xs, w, b, block_expert, ys, np_rows, k, n, num_experts, stream)
                     : launch_wgmma<2, false>(xs, w, b, block_expert, ys, np_rows, k, n, num_experts, stream);
  return transpose ? launch_wgmma<1, true>(xs, w, b, block_expert, ys, np_rows, k, n, num_experts, stream)
                   : launch_wgmma<1, false>(xs, w, b, block_expert, ys, np_rows, k, n, num_experts, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (xs, w and ys alike). xs (Np, K);
// w (E, K, N), or (E, N, K) when transpose != 0; b (E, N) f32 or null;
// block_expert (Np / blk,); ys (Np, N). Requires blk % 8 == 0 and
// Np % blk == 0 (the wrapper checks). route: 0 = simt; 1 = wgmma (bf16,
// blk 64 or 128, K and N % 8 == 0, xs and w 16-byte aligned); 2 =
// mma_tf32x3 (float32, K and N % 4 == 0, xs and w 16-byte aligned);
// anything else is refused. num_experts = E, the extent of w's tensor map.
extern "C" int esmm_launch(const void* xs, const void* w, const void* b,
                           const void* block_expert, void* ys, int np_rows,
                           int k, int n, int blk, int transpose, int dtype,
                           int route, int num_experts, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (route == 1) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    return launch_wgmma_route(xs, w, b, block_expert, ys, np_rows, k, n, blk,
                              transpose, num_experts, s);
  }
  if (route == 2) {
    if (dtype != 0) return (int)cudaErrorInvalidValue;
    return mma_launch<float, float>(xs, w, Scales{}, b, block_expert, ys,
                                    np_rows, k, n, blk, transpose, s);
  }
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(xs, w, Scales{}, b,
                                                 block_expert, ys, np_rows, k,
                                                 n, blk, transpose, s);
  return launch<float, float>(xs, w, Scales{}, b, block_expert, ys, np_rows,
                              k, n, blk, transpose, s);
}

// esmm with an 8-bit W: wdtype 1 = int8, 2 = fp8 e4m3; sw the f32 block
// scales on W's own axes, (E, K / ta, N / tb), or (E, N / ta, K / tb) when
// transpose != 0. dtype (0 = float32, 1 = bfloat16) is that of xs and ys.
// route: 0 = simt, 2 = mma_tf32x3 (K and N % 8 == 0, xs and w 16-byte
// aligned); everything else as esmm_launch.
extern "C" int esmm_q_launch(const void* xs, const void* w, const void* sw,
                             const void* b, const void* block_expert,
                             void* ys, int np_rows, int k, int n, int blk,
                             int transpose, int dtype, int wdtype, int ta,
                             int tb, int route, void* stream) {
  const int rows = transpose ? n : k, cols = transpose ? k : n;
  if (sw == nullptr || ta <= 0 || tb <= 0 || rows % ta || cols % tb)
    return (int)cudaErrorInvalidValue;
  const Scales sc{(const float*)sw, rows, cols, ta, tb};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_q<__nv_bfloat16>(xs, w, sc, b, block_expert, ys, np_rows,
                                   k, n, blk, transpose, wdtype, route, s);
  if (dtype == 0)
    return launch_q<float>(xs, w, sc, b, block_expert, ys, np_rows, k, n, blk,
                           transpose, wdtype, route, s);
  return (int)cudaErrorInvalidValue;
}
