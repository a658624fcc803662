// Fused GLU expert FFN over the expert-sorted layout, for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/esffn.py::esffn_glu_pallas (body
// _esffn_glu_kernel): per BLK-row block of the sorted layout, gather the
// block's token rows straight from the UNSORTED activations x through
// row_token, compute h = act(x Wg[e]) * (x Wu[e]) and write
// (h Wd[e]) * row_gate, where e = block_expert[block].
//
// Rounding follows the TPU kernel: the gate and up products accumulate in
// f32 and are rounded to T (the activation dtype), act(g) is rounded to T,
// h = act(g) * u is rounded to T, the down product accumulates in f32 and
// the output is (acc * gate) rounded to T.
//
// What bounds it on this card: at serving shapes the expert weight tiles.
// Decode with 8 slots routes 64 token copies over 128 experts, so at most
// 64 blocks are live and each reads its expert's 3 * D * F weights (9.4 MB in
// bf16 at qwen3 width) for one or two real rows: some 0.6 GB a layer,
// 6 FLOP per weight element and row, far below the 295 FLOP/byte where the
// tensor cores would become the limit. The design therefore aims at moving
// each needed weight byte once and nothing else:
//
//  * Rows whose gate is 0 (the sentinel padding rows, which are 15 of 16
//    rows of a block at decode) are written as 0 and never computed. The TPU
//    kernel writes acc * 0, which is the same value for every finite acc.
//    A block with no live row (all tail blocks) reads no weight tile at all.
//  * Two launches split the work so that enough CTAs stream weights at
//    once: esffn_up_kernel on a (block, 64-column F tile) grid computes h
//    for the live rows, each CTA reading its D x 64 slices of Wg and Wu
//    once; esffn_down_kernel on a (block, 256-column D tile) grid reads its
//    F x 256 slice of Wd once. h (live rows x F, at most N*k*F elements:
//    98 KB at decode) passes between the two through device memory, where
//    it stays in the 50 MB L2; the (Np, D) f32 accumulator never exists.
//  * Plain FMA in f32, not tensor cores: with one or two live rows a block
//    the products are matrix-vector shaped and the FLOPs are small beside
//    the bytes (wgmma/TMA pipelines come in a later change).
//
// Plain C interface for ctypes: esffn_glu_launch returns cudaGetLastError().

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 16;                     // live rows per pass (registers)
constexpr int kMaxBlk = 128;                  // largest accepted BLK
constexpr int kUpCols = 64;                   // F columns of one up-kernel CTA
constexpr int kUpSplit = kThreads / kUpCols;  // D reduction split 4 ways
constexpr int kUpDTile = 256;                 // x columns staged per step
constexpr int kDownCols = kThreads;           // D columns of one down CTA
constexpr int kDownFTile = 256;               // h columns staged per step

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// v rounded to T and back (identity for f32).
template <typename T> __device__ __forceinline__ float round_t(float v) {
  return to_f(from_f<T>(v));
}

// ACT_IDS of repro_torch/common.py; gelu is the tanh approximation.
__device__ __forceinline__ float act_fn(int act, float v) {
  switch (act) {
    case 0: return v / (1.0f + expf(-v));
    case 1: return 0.5f * v * (1.0f + tanhf(0.7978845608028654f * (v + 0.044715f * v * v * v)));
    case 2: return fmaxf(v, 0.0f);
    default: return tanhf(v);
  }
}

// The block's live rows (gate != 0) in row order: live[i] is the row within
// the block, tok[i] its token (clamped like the TPU gather), flag[r] marks
// row r live. Needs blockDim.x >= blk; ends with a barrier.
__device__ void collect_live(const float* __restrict__ row_gate,
                             const int* __restrict__ row_token, int base,
                             int blk, int n, int* live, int* tok,
                             unsigned char* flag, int* warp_cnt, int* nlive) {
  const int r = threadIdx.x;
  const bool on = r < blk && row_gate[base + r] != 0.0f;
  const unsigned mask = __ballot_sync(0xffffffffu, on);
  const int lane = r & 31, warp = r >> 5;
  if (lane == 0 && warp < kMaxBlk / 32) warp_cnt[warp] = __popc(mask);
  if (r < blk) flag[r] = on;
  __syncthreads();
  if (on) {
    int off = 0;
    for (int w = 0; w < warp; ++w) off += warp_cnt[w];
    off += __popc(mask & ((1u << lane) - 1u));
    live[off] = r;
    tok[off] = min(row_token[base + r], n - 1);
  }
  if (r == 0) {
    int total = 0;
    for (int w = 0; w < (blk + 31) / 32; ++w) total += warp_cnt[w];
    *nlive = total;
  }
  __syncthreads();
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
esffn_up_kernel(const T* __restrict__ x, const int* __restrict__ row_token,
                const float* __restrict__ row_gate,
                const int* __restrict__ block_expert, const T* __restrict__ wg,
                const T* __restrict__ wu, T* __restrict__ h, int n, int d,
                int f, int blk, int act) {
  __shared__ int live[kMaxBlk], tok[kMaxBlk], warp_cnt[kMaxBlk / 32], nlive_s;
  __shared__ unsigned char flag[kMaxBlk];
  // x tile [kRows][kUpDTile] during the D loop, then the partial sums
  // [2][kUpSplit][kRows][kUpCols] of g and u.
  __shared__ float smem[2 * kUpSplit * kRows * kUpCols];

  const int m = blockIdx.x;
  const int base = m * blk;
  collect_live(row_gate, row_token, base, blk, n, live, tok, flag, warp_cnt, &nlive_s);
  const int nlive = nlive_s;
  if (nlive == 0) return;  // padding block: no weight is read

  const int e = block_expert[m];
  const int col = threadIdx.x % kUpCols;
  const int part = threadIdx.x / kUpCols;
  const int f0 = blockIdx.y * kUpCols;
  const bool col_ok = f0 + col < f;
  const size_t wbase = (size_t)e * d * f + f0 + col;
  float* xs = smem;
  float* red = smem;
  constexpr int kSlice = kUpDTile / kUpSplit;

  for (int r0 = 0; r0 < nlive; r0 += kRows) {
    const int nr = min(kRows, nlive - r0);
    float g[kRows], u[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) { g[i] = 0.0f; u[i] = 0.0f; }

    for (int d0 = 0; d0 < d; d0 += kUpDTile) {
      const int dt = min(kUpDTile, d - d0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * kUpDTile; idx += kThreads) {
        const int i = idx / kUpDTile, dd = idx % kUpDTile;
        xs[idx] = dd < dt ? to_f(x[(size_t)tok[r0 + i] * d + d0 + dd]) : 0.0f;
      }
      __syncthreads();
      if (col_ok) {
        const int lo = part * kSlice, hi = min(lo + kSlice, dt);
        const T* pg = wg + wbase + (size_t)d0 * f;
        const T* pu = wu + wbase + (size_t)d0 * f;
#pragma unroll 4
        for (int dd = lo; dd < hi; ++dd) {
          const float a = to_f(pg[(size_t)dd * f]);
          const float b = to_f(pu[(size_t)dd * f]);
#pragma unroll
          for (int i = 0; i < kRows; ++i) {
            if (i < nr) {
              const float xv = xs[i * kUpDTile + dd];
              g[i] = fmaf(xv, a, g[i]);
              u[i] = fmaf(xv, b, u[i]);
            }
          }
        }
      }
    }

    __syncthreads();  // every thread is done reading the x tile
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      red[((0 * kUpSplit + part) * kRows + i) * kUpCols + col] = g[i];
      red[((1 * kUpSplit + part) * kRows + i) * kUpCols + col] = u[i];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nr * kUpCols; idx += kThreads) {
      const int i = idx / kUpCols, c = idx % kUpCols;
      if (f0 + c >= f) continue;
      float gs = 0.0f, us = 0.0f;
      for (int p = 0; p < kUpSplit; ++p) {
        gs += red[((0 * kUpSplit + p) * kRows + i) * kUpCols + c];
        us += red[((1 * kUpSplit + p) * kRows + i) * kUpCols + c];
      }
      const float gr = round_t<T>(gs), ur = round_t<T>(us);
      const float hv = round_t<T>(act_fn(act, gr)) * ur;
      h[(size_t)(base + live[r0 + i]) * f + f0 + c] = from_f<T>(hv);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
esffn_down_kernel(const T* __restrict__ h, const int* __restrict__ row_token,
                  const float* __restrict__ row_gate,
                  const int* __restrict__ block_expert,
                  const T* __restrict__ wd, T* __restrict__ out, int n, int d,
                  int f, int blk) {
  __shared__ int live[kMaxBlk], tok[kMaxBlk], warp_cnt[kMaxBlk / 32], nlive_s;
  __shared__ unsigned char flag[kMaxBlk];
  __shared__ float hs[kRows * kDownFTile];

  const int m = blockIdx.x;
  const int base = m * blk;
  const int dcol = blockIdx.y * kDownCols + threadIdx.x;
  const bool col_ok = dcol < d;
  collect_live(row_gate, row_token, base, blk, n, live, tok, flag, warp_cnt, &nlive_s);
  const int nlive = nlive_s;

  if (col_ok) {
    for (int r = 0; r < blk; ++r)
      if (!flag[r]) out[(size_t)(base + r) * d + dcol] = from_f<T>(0.0f);
  }
  if (nlive == 0) return;

  const int e = block_expert[m];
  const T* pw = wd + (size_t)e * f * d + dcol;
  for (int r0 = 0; r0 < nlive; r0 += kRows) {
    const int nr = min(kRows, nlive - r0);
    float acc[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[i] = 0.0f;

    for (int f0 = 0; f0 < f; f0 += kDownFTile) {
      const int ft = min(kDownFTile, f - f0);
      __syncthreads();
      for (int idx = threadIdx.x; idx < nr * kDownFTile; idx += kThreads) {
        const int i = idx / kDownFTile, ff = idx % kDownFTile;
        hs[idx] = ff < ft ? to_f(h[(size_t)(base + live[r0 + i]) * f + f0 + ff]) : 0.0f;
      }
      __syncthreads();
      if (col_ok) {
#pragma unroll 4
        for (int ff = 0; ff < ft; ++ff) {
          const float w = to_f(pw[(size_t)(f0 + ff) * d]);
#pragma unroll
          for (int i = 0; i < kRows; ++i)
            if (i < nr) acc[i] = fmaf(hs[i * kDownFTile + ff], w, acc[i]);
        }
      }
    }
    if (col_ok) {
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        if (i < nr) {
          const int r = base + live[r0 + i];
          out[(size_t)r * d + dcol] = from_f<T>(acc[i] * row_gate[r]);
        }
      }
    }
  }
}

template <typename T>
int launch(const void* x, const void* row_token, const void* row_gate,
           const void* block_expert, const void* wg, const void* wu,
           const void* wd, void* h, void* out, int n, int d, int f,
           int np_rows, int blk, int act, cudaStream_t stream) {
  const int nblk = np_rows / blk;
  const dim3 up_grid(nblk, (f + kUpCols - 1) / kUpCols);
  const dim3 down_grid(nblk, (d + kDownCols - 1) / kDownCols);
  esffn_up_kernel<T><<<up_grid, kThreads, 0, stream>>>(
      (const T*)x, (const int*)row_token, (const float*)row_gate,
      (const int*)block_expert, (const T*)wg, (const T*)wu, (T*)h, n, d, f,
      blk, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  esffn_down_kernel<T><<<down_grid, kThreads, 0, stream>>>(
      (const T*)h, (const int*)row_token, (const float*)row_gate,
      (const int*)block_expert, (const T*)wd, (T*)out, n, d, f, blk);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. act: ACT_IDS. h: (Np, F) scratch of
// dtype T; out: (Np, D). Requires 8 <= blk <= 128 (the wrapper checks).
extern "C" int esffn_glu_launch(const void* x, const void* row_token,
                                const void* row_gate, const void* block_expert,
                                const void* wg, const void* wu, const void* wd,
                                void* h, void* out, int n, int d, int f,
                                int np_rows, int blk, int dtype, int act,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, row_token, row_gate, block_expert, wg, wu,
                                 wd, h, out, n, d, f, np_rows, blk, act, s);
  return launch<float>(x, row_token, row_gate, block_expert, wg, wu, wd, h,
                       out, n, d, f, np_rows, blk, act, s);
}
