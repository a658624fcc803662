// Fused expert FFNs over the expert-sorted layout, for Hopper (sm_90a): the
// GLU form (esffn_glu_launch) and the biased 2-MLP form (esffn_mlp_launch).
//
// === GLU form ===
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
// === 2-MLP form ===
//
// Replaces the TPU kernel repro/kernels/esffn.py::esffn_mlp_pallas (body
// _esffn_mlp_kernel): per BLK-row block, out = (act(x[tok] W1[e] + b1[e])
// W2[e] + b2[e]) * row_gate. Rounding follows the TPU kernel: z = x W1 sums
// in f32, b1 is added in f32, z is rounded to T, h = act(z) is T; the down
// accumulator starts from b2 (once per row, not once per F tile) and sums
// h W2 in f32, and the output is (acc * gate) rounded to T. Biases are f32.
//
// What bounds it on this card: at training shapes (Swin-MoE-Small, stage 2
// of 0-3: Np 26,112 rows, D 384, F 1536, 8 experts; every row of a block
// but the group's last is live) it is two dense GEMMs of 2 Np D F FLOPs each
// against (Np D + E D F + Np F) elements, some 140 FLOP/byte in f32: the
// operations bound it, at the f32 FMA rate this kernel uses. So the design
// is the shared-memory-tiled GEMM of csrc/esmm.cu, twice:
//
//  * The up launch (esffn_mlp_kernel<kUp>) runs on a (BM-row tile, 64-column
//    F tile) grid, BM = 64 at BLK 128 (else the largest of 32, 16, 8 that
//    divides BLK), so a tile lies in one block and reads one expert's W1.
//    Its A rows are gathered straight from the UNSORTED x through
//    row_token; its epilogue adds b1, rounds, applies act and writes h
//    (Np x F, T) for the live rows only.
//  * The down launch (esffn_mlp_kernel<!kUp>) runs on a (BM-row tile,
//    64-column D tile) grid over h, its accumulators seeded with b2[e];
//    the epilogue multiplies by the gate. The TPU kernel keeps the (BLK, D)
//    f32 accumulator in VMEM across the sequential F axis; here each CTA
//    loops over F itself, so nothing carries between CTAs.
//  * Rows whose gate is 0 (padding) are staged as 0, never read from x or
//    h, and written as 0; a tile with no live row reads no weight.
//
// Plain C interface for ctypes: esffn_glu_launch and esffn_mlp_launch return
// cudaGetLastError().

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

// ---------------------------------------------------------------------------
// 2-MLP form
// ---------------------------------------------------------------------------

constexpr int kMlpBN = 64;  // output columns of a CTA
constexpr int kMlpBK = 16;  // contraction slice staged per step
constexpr int kMlpTN = 4;   // columns of a thread, strided by 16

// One BM x 64 output tile of either product, on expert e = block_expert of
// the tile's block. kUp: a = x (N, K = D) gathered through row_token, w =
// W1 (E, D, F), out = h (Np, F) on live rows. !kUp: a = h (Np, K = F), w =
// W2 (E, F, D), out (Np, D) on every row.
template <typename T, int BM, bool kUp>
__global__ void __launch_bounds__(kThreads)
esffn_mlp_kernel(const T* __restrict__ a, const int* __restrict__ row_token,
                 const float* __restrict__ row_gate,
                 const int* __restrict__ block_expert, const T* __restrict__ w,
                 const float* __restrict__ bias, T* __restrict__ out, int n,
                 int k, int ncols, int blk, int act) {
  constexpr int TM = BM >= 16 ? BM / 16 : 1;
  constexpr int kRowThreads = BM / TM;  // 16, or 8 at BM 8
  __shared__ float as[kMlpBK][BM + 4];  // A tile, K-major
  __shared__ float bs[kMlpBK][kMlpBN + 4];
  __shared__ int src[BM];               // row of `a` feeding each tile row; -1: dead
  __shared__ float gate[BM];

  const int m0 = blockIdx.x * BM;
  const int n0 = blockIdx.y * kMlpBN;
  const int tid = threadIdx.x;
  bool live = false;
  if (tid < BM) {
    const float g = row_gate[m0 + tid];
    live = g != 0.0f;
    gate[tid] = g;
    src[tid] = !live ? -1 : (kUp ? min(row_token[m0 + tid], n - 1) : m0 + tid);
  }
  const int ty = tid / 16, tx = tid % 16;
  const bool active = ty < kRowThreads;
  if (!__syncthreads_or(live)) {  // padding tile: no weight is read
    if (!kUp && active) {
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < kMlpTN; ++j) {
          const int col = n0 + tx + 16 * j;
          if (col < ncols)
            out[(size_t)(m0 + ty + kRowThreads * i) * ncols + col] = from_f<T>(0.0f);
        }
    }
    return;
  }

  const int e = block_expert[m0 / blk];
  const T* we = w + (size_t)e * k * ncols;
  float acc[TM][kMlpTN];
#pragma unroll
  for (int j = 0; j < kMlpTN; ++j) {
    const int col = n0 + tx + 16 * j;
    // b2 seeds the down accumulator once per row
    const float bv = (!kUp && bias != nullptr && col < ncols) ? bias[(size_t)e * ncols + col] : 0.0f;
#pragma unroll
    for (int i = 0; i < TM; ++i) acc[i][j] = bv;
  }

  for (int k0 = 0; k0 < k; k0 += kMlpBK) {
    for (int idx = tid; idx < BM * kMlpBK; idx += kThreads) {
      const int r = idx / kMlpBK, kk = idx % kMlpBK;
      const int s = src[r];
      as[kk][r] = (s >= 0 && k0 + kk < k) ? to_f(a[(size_t)s * k + k0 + kk]) : 0.0f;
    }
    for (int idx = tid; idx < kMlpBK * kMlpBN; idx += kThreads) {
      const int kk = idx / kMlpBN, c = idx % kMlpBN;
      bs[kk][c] = (k0 + kk < k && n0 + c < ncols)
                      ? to_f(we[(size_t)(k0 + kk) * ncols + n0 + c]) : 0.0f;
    }
    __syncthreads();
    if (active) {
#pragma unroll
      for (int kk = 0; kk < kMlpBK; ++kk) {
        float av[TM], bv[kMlpTN];
#pragma unroll
        for (int i = 0; i < TM; ++i) av[i] = as[kk][ty + kRowThreads * i];
#pragma unroll
        for (int j = 0; j < kMlpTN; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < kMlpTN; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  if (!active) return;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = ty + kRowThreads * i;
    const size_t row = (size_t)(m0 + r);
    const bool on = src[r] >= 0;
#pragma unroll
    for (int j = 0; j < kMlpTN; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= ncols) continue;
      if (kUp) {
        if (!on) continue;  // h of a dead row is never read
        const float z = acc[i][j] + (bias != nullptr ? bias[(size_t)e * ncols + col] : 0.0f);
        out[row * ncols + col] = from_f<T>(act_fn(act, round_t<T>(z)));
      } else {
        out[row * ncols + col] = on ? from_f<T>(acc[i][j] * gate[r]) : from_f<T>(0.0f);
      }
    }
  }
}

template <typename T, int BM>
int mlp_launch_bm(const void* x, const void* row_token, const void* row_gate,
                  const void* block_expert, const void* w1, const void* b1,
                  const void* w2, const void* b2, void* h, void* out, int n,
                  int d, int f, int np_rows, int blk, int act,
                  cudaStream_t stream) {
  const dim3 up_grid(np_rows / BM, (f + kMlpBN - 1) / kMlpBN);
  esffn_mlp_kernel<T, BM, true><<<up_grid, kThreads, 0, stream>>>(
      (const T*)x, (const int*)row_token, (const float*)row_gate,
      (const int*)block_expert, (const T*)w1, (const float*)b1, (T*)h, n, d,
      f, blk, act);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 down_grid(np_rows / BM, (d + kMlpBN - 1) / kMlpBN);
  esffn_mlp_kernel<T, BM, false><<<down_grid, kThreads, 0, stream>>>(
      (const T*)h, (const int*)row_token, (const float*)row_gate,
      (const int*)block_expert, (const T*)w2, (const float*)b2, (T*)out, n,
      f, d, blk, act);
  return (int)cudaGetLastError();
}

template <typename T>
int mlp_launch(const void* x, const void* row_token, const void* row_gate,
               const void* block_expert, const void* w1, const void* b1,
               const void* w2, const void* b2, void* h, void* out, int n,
               int d, int f, int np_rows, int blk, int act,
               cudaStream_t stream) {
#define ESFFN_MLP_BM(BM)                                                      \
  return mlp_launch_bm<T, BM>(x, row_token, row_gate, block_expert, w1, b1,  \
                              w2, b2, h, out, n, d, f, np_rows, blk, act,     \
                              stream)
  if (blk % 64 == 0) ESFFN_MLP_BM(64);
  if (blk % 32 == 0) ESFFN_MLP_BM(32);
  if (blk % 16 == 0) ESFFN_MLP_BM(16);
  ESFFN_MLP_BM(8);
#undef ESFFN_MLP_BM
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

// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2, h and out). b1 (E, F) and b2
// (E, D) are f32 or null. h: (Np, F) scratch of dtype T (live rows
// written); out: (Np, D). Requires blk % 8 == 0 (the wrapper checks).
extern "C" int esffn_mlp_launch(const void* x, const void* row_token,
                                const void* row_gate, const void* block_expert,
                                const void* w1, const void* b1, const void* w2,
                                const void* b2, void* h, void* out, int n,
                                int d, int f, int np_rows, int blk, int dtype,
                                int act, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1)
    return mlp_launch<__nv_bfloat16>(x, row_token, row_gate, block_expert, w1,
                                     b1, w2, b2, h, out, n, d, f, np_rows, blk,
                                     act, s);
  return mlp_launch<float>(x, row_token, row_gate, block_expert, w1, b1, w2,
                           b2, h, out, n, d, f, np_rows, blk, act, s);
}
