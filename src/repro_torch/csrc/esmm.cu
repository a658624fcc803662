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
// tensor cores come near the bound. Two routes, chosen by the wrapper
// (kernels/esmm.py::_route) before the launch and passed in `route`:
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
// simt (route 0: float32, the Swin slice's path; bf16 at blk 8..32 or at
// widths not % 8, which TMA's 16-byte strides refuse): TF32 would move the f32 results off the f32 reference, and the
// tensor cores take no f32, so it stays plain f32 FMA from shared memory:
//  * A CTA owns a BM x 64 output tile (BM = 64 at BLK 128, else the largest
//    of 32, 16, 8 that divides BLK), so its rows lie in one BLK block and
//    the CTA reads one expert's weight slice.
//  * The K loop stages a BM x 16 tile of xs and a 16 x 64 tile of W[e] in
//    shared memory as f32 (bf16 converted once on the way in); each of the
//    256 threads keeps a (BM/16) x 4 register tile of sums, columns strided
//    by 16 so the shared-memory reads of a warp hit distinct banks.
//  * The TPU kernel carries its f32 accumulator across the sequential K
//    grid axis in VMEM; here the K loop runs inside the CTA, so nothing
//    carries between CTAs and no atomics are needed (both routes).
//
// 8-bit weights (esmm_q_launch; the has_scale branch of the TPU kernel,
// quant.core.dequant_tile): W is an int8 or fp8 e4m3 payload with f32
// block scales s on W's own two axes, (E, K / ta, N / tb), or (E, N / ta,
// K / tb) with transpose_rhs. The simt kernel dequantizes each W element
// as it is staged into shared memory, float(q) * s[e][row / ta][col / tb],
// so only the 8-bit bytes cross HBM and the products are the f32 ones of
// the TPU kernel's dequantized tile. Only the simt route takes them: a TMA
// box of int8 and a dequant stage before wgmma are later work.
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

template <typename T>
int launch_q(const void* xs, const void* w, Scales sw, const void* b,
             const void* block_expert, void* ys, int np_rows, int k, int n,
             int blk, int transpose, int wdtype, cudaStream_t stream) {
  if (wdtype == 1)
    return launch<T, int8_t>(xs, w, sw, b, block_expert, ys, np_rows, k, n, blk, transpose, stream);
  if (wdtype == 2)
    return launch<T, __nv_fp8_e4m3>(xs, w, sw, b, block_expert, ys, np_rows, k, n, blk, transpose, stream);
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
// Np % blk == 0 (the wrapper checks). route: 0 = simt, 1 = wgmma (bf16,
// blk 64 or 128, K and N % 8 == 0, xs and w 16-byte aligned; anything
// else is refused). num_experts = E, the extent of w's tensor map.
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
  if (route != 0) return (int)cudaErrorInvalidValue;
  if (dtype == 1)
    return launch<__nv_bfloat16, __nv_bfloat16>(xs, w, Scales{}, b,
                                                 block_expert, ys, np_rows, k,
                                                 n, blk, transpose, s);
  return launch<float, float>(xs, w, Scales{}, b, block_expert, ys, np_rows,
                              k, n, blk, transpose, s);
}

// esmm with an 8-bit W on the simt route: wdtype 1 = int8, 2 = fp8 e4m3;
// sw the f32 block scales on W's own axes, (E, K / ta, N / tb), or (E,
// N / ta, K / tb) when transpose != 0. dtype (0 = float32, 1 = bfloat16)
// is that of xs and ys; everything else as esmm_launch.
extern "C" int esmm_q_launch(const void* xs, const void* w, const void* sw,
                             const void* b, const void* block_expert,
                             void* ys, int np_rows, int k, int n, int blk,
                             int transpose, int dtype, int wdtype, int ta,
                             int tb, void* stream) {
  const int rows = transpose ? n : k, cols = transpose ? k : n;
  if (sw == nullptr || ta <= 0 || tb <= 0 || rows % ta || cols % tb)
    return (int)cudaErrorInvalidValue;
  const Scales sc{(const float*)sw, rows, cols, ta, tb};
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch_q<__nv_bfloat16>(xs, w, sc, b, block_expert, ys, np_rows,
                                   k, n, blk, transpose, wdtype, s);
  if (dtype == 0)
    return launch_q<float>(xs, w, sc, b, block_expert, ys, np_rows, k, n, blk,
                           transpose, wdtype, s);
  return (int)cudaErrorInvalidValue;
}
