// Fused expert FFNs over the expert-sorted layout, for Hopper (sm_90a): the
// GLU form (esffn_glu_launch, esffn_glu_wgmma_launch) and the biased 2-MLP
// form (esffn_mlp_launch, on the tensor cores through mma_sync.cuh).
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
// Both routes write rows whose gate is 0 (the sentinel padding rows, 15 of
// 16 rows of a block at decode) as 0 and never compute them (the TPU kernel
// writes acc * 0, the same value for every finite acc), and a block with
// no live row (all tail blocks) reads no weight at all. Two launches, up
// and down, pass h (Np, F, T; live rows only) through device memory; the
// (Np, D) f32 accumulator never exists. The wrapper
// (kernels/esffn.py::_route) picks the route from the dtype and shapes:
//
// wgmma (bf16 x and weights, blk 64 or 128, D and F % 8 == 0;
// esffn_glu_wgmma_launch): the LM train path at blk 128, where every row
// of a block but its group's last is live and the FFN is two dense GEMMs
// (6 Np D F flops against about E 3 D F + Np (D + F) bf16 elements: far
// above the 295 flops a byte where the tensor cores bound it).
//  * Up: a CTA owns one block (BM = blk rows: one consumer warpgroup of 64
//    rows per 64) and 128 F columns. Hopper's TMA cannot gather rows, so
//    the producer warp gathers the block's x rows straight from the
//    unsorted x through row_token with 16-byte cp.async into the 128-byte
//    swizzled layout wgmma's descriptor reads (chunk c of row r at
//    c ^ (r & 7); dead rows zero-filled), and brings the 64 x 128 Wg[e]
//    and Wu[e] tiles by TMA, MN-major (the transpose bit; the weights are
//    not transposed in memory), through a 4-stage mbarrier ring. Two f32
//    accumulators (g and u, 64 registers each) take two m64n128k16 wgmma
//    per 16-deep step; the epilogue rounds g and u, applies act, rounds
//    and writes h for the live rows.
//  * Down: esmm's mainloop (hopper.cuh, SortedGemm) over h (TMA) and
//    Wd[e], with an epilogue that multiplies by row_gate and writes zeros
//    on dead rows.
//
// stream (everything else: the serve path at blk 16, 8-bit weights, f32;
// esffn_glu_launch, esffn_glu_q_launch): at serving shapes the weight
// bytes bound it. Decode with 8 slots routes 64 token copies over 128
// experts, so at most 64 blocks are live and each reads its expert's
// 3 * D * F weights (9.4 MB in bf16 at qwen3 width) for one or two live
// rows: 6 flops per weight element and row, far below the tensor cores'
// line. So each needed weight byte moves once, at the memory's rate:
//  * A CTA owns one block and a 128-byte column slice of the weights (64
//    bf16, 128 int8/fp8 or 32 f32 columns: 12, 6 or 24 CTAs a block for
//    Wg/Wu at F 768, 32, 16 or 64 for Wd at D 2048), so 50 live experts
//    give 300-1,600 CTAs.
//  * Weight rows stream through a 4-stage cp.async ring of 64-row stages
//    (16-byte copies; 64 KB in flight a CTA up, 32 KB down, two or more
//    CTAs an SM). Each stage also brings the same 64 contraction elements
//    of up to 4 live rows, so shared memory stays under 70 KB at any D
//    and F (mixtral-8x7b's F 14336 included); each thread sums an
//    8-column group over a lane of the stage's rows, and the lanes are
//    summed by shuffles and once through shared memory at the end.
//  * 8-bit weights convert exactly without I2F, which runs at a quarter
//    of the FMA rate (int8: a byte permute and one add; fp8: the
//    hardware's pairwise convert), and take one block scale per run of
//    rows that share it, looked up without a division per element.
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
// operations bound it. So both launches run on the tensor cores through
// mma_sync.cuh's mainloop: 3xTF32 for f32 operands (f32 accuracy at 3 x
// the TF32 work; one TF32 pass would move f32 results off the reference),
// one bf16 pass for bf16 operands (esffn_mlp_mma_kernel):
//
//  * The up launch (kUp) runs on a (BM-row tile, 128-column F tile) grid,
//    BM = 128 at BLK 128 (else the largest of 64, 32, 16 that divides BLK;
//    at BLK 8 a 16-row tile holds the block's 8 rows and zeros), so a tile
//    lies in one block and reads one expert's W1. Its A rows are gathered
//    straight from the UNSORTED x through row_token with 16-byte cp.async;
//    its epilogue adds b1, rounds, applies act and writes h (Np x F, T)
//    for the live rows only.
//  * The down launch (!kUp) runs on a (BM-row tile, 128-column D tile)
//    grid over h, its accumulators seeded with b2[e]; the epilogue
//    multiplies by the gate. The TPU kernel keeps the (BLK, D) f32
//    accumulator in VMEM across the sequential F axis; here each CTA loops
//    over F itself, so nothing carries between CTAs.
//  * Rows whose gate is 0 (padding) are staged as 0, never read from x or
//    h, and written as 0; a tile with no live row reads no weight.
//  * W tiles (f32) come by 16-byte cp.async through a 3-stage ring; bf16
//    and 8-bit operands by 16- and 8-byte loads a stage ahead, converted
//    to f32 as they are stored.
//
// === 8-bit weights ===
//
// Replaces the quantized branch of both TPU kernels (w_scales; _wtile /
// quant.core.dequant_tile): the expert weights are int8 or fp8 e4m3
// payloads with f32 block scales s (E, rows / ta, cols / tb) on each
// weight's own two axes, (ta, tb) = block_tiles' 128 clamped to the dim.
// Every weight element is dequantized where it is read, float(q) *
// s[e][row / ta][col / tb], and enters the same f32 products (the GLU
// form's FMAs on its stream route, the 2-MLP form's 3xTF32 tiles); the
// activations stay in T, so only the 8-bit bytes (and the scales) cross
// HBM. Rounding is the TPU kernel's: its f32 dequantized tile meets x
// promoted to f32. The same kernels run, instantiated for W = int8_t or
// __nv_fp8_e4m3.
// What bounds it: the weight bytes, now half of bf16's (decode reads
// 3 * D * F bytes an expert: 4.7 MB at qwen3 width).
//
// Plain C interface for ctypes: esffn_glu_launch, esffn_mlp_launch and
// their 8-bit forms esffn_glu_q_launch and esffn_mlp_q_launch return
// cudaGetLastError(), or cudaErrorInvalidValue for operands they refuse.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "mma_sync.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlk = 128;                  // largest accepted BLK

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(int8_t v) { return (float)v; }
__device__ __forceinline__ float to_f(__nv_fp8_e4m3 v) { return float(v); }

// Block scales of an 8-bit expert weight W (E, rows, cols): f32 s (E,
// rows / ta, cols / tb), s[e][r / ta][c / tb] scaling element (r, c) of
// W[e]. Unused (s null) when W is stored in the activation dtype.
struct Scales {
  const float* s;
  int rows, cols, ta, tb;
  __device__ __forceinline__ float at(int e, int r, int c) const {
    return block(e, r / ta, c / tb);
  }
  // the scale of block (rb, cb) of W[e]
  __device__ __forceinline__ float block(int e, int rb, int cb) const {
    return s[((size_t)e * (rows / ta) + rb) * (cols / tb) + cb];
  }
};

// W is an 8-bit payload (dequantized on read) rather than T itself.
template <typename T, typename W>
constexpr bool kQuant = !std::is_same<T, W>::value;

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

// ---- GLU form, stream route --------------------------------------------------

constexpr int kStreamR = 4;           // live rows of a pass
constexpr int kStreamDT = 64;         // contraction rows of a stage

// A stage of the ring: kStreamDT rows of a kLine-byte column slice of each
// weight, and the same kStreamDT contraction elements of the pass's live
// rows of a.
template <typename T, typename W, bool kUp>
struct StreamCfg {
  static constexpr int kLine = 128;                     // bytes of a weight row
  static constexpr int kStages = 4;
  static constexpr int kNMat = kUp ? 2 : 1;
  static constexpr int kCols = kLine / (int)sizeof(W);  // 64 bf16, 128 8-bit, 32 f32
  static constexpr int kChunks = kLine / 16;            // 16-byte copies a row
  static constexpr int kCG = kCols / 8;                 // 8-column groups
  static constexpr int kRL = kThreads / kCG;            // row lanes
  static constexpr int kMatBytes = kStreamDT * kLine;   // a matrix's stage
  static constexpr int kActChunks = kStreamDT * (int)sizeof(T) / 16;
  static constexpr int kStageBytes = kNMat * kMatBytes + kStreamR * kActChunks * 16;
  static constexpr int kSmem = kStages * kStageBytes;
  static_assert(kStreamDT % kRL == 0, "a stage is whole rows of row lanes");
  static_assert(kStreamR * kActChunks <= kThreads, "one activation copy a thread");
  static_assert(kThreads / 32 * kNMat * kStreamR * kCols * 4 <= kSmem,
                "the row-lane sums fit in the ring");
};

// The 8 weights of a thread's column group, as f32 (exact conversions).
__device__ __forceinline__ void load_w8(const uint8_t* p, float (&w)[8], float) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  const float4 b = *reinterpret_cast<const float4*>(p + 16);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}
__device__ __forceinline__ void load_w8(const uint8_t* p, float (&w)[8], __nv_bfloat16) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load_w8(const uint8_t* p, float (&w)[8], int8_t) {
  // float(q) = (2^23 + (q ^ 0x80)) - (2^23 + 128), exactly, per byte
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const uint32_t words[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = __uint_as_float(__byte_perm(words[i / 4], 0x4B000000u, 0x7440 | (i % 4))) -
           8388736.0f;
}
__device__ __forceinline__ void load_w8(const uint8_t* p, float (&w)[8], __nv_fp8_e4m3) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const uint32_t words[2] = {raw.x, raw.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
        (__nv_fp8x2_storage_t)(words[i / 2] >> (16 * (i % 2))), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}

// One CTA streams a kLine-byte column slice of its block's expert weights:
// kUp: g = a Wg[e], u = a Wu[e] with a the block's live token rows of x
// (N, K = D), and writes h = round(act(round(g))) * round(u) (Np, ncols =
// F) for them; !kUp: acc = a Wd[e] with a the live rows of h (Np, K = F),
// and writes out (Np, ncols = D) = round(acc * gate), 0 on dead rows. The
// weight rows move through a kStages-deep cp.async ring of kStreamDT-row
// stages (16-byte copies, 32 KB or 64 KB in flight a CTA); each stage also
// brings the same kStreamDT elements of kStreamR live rows of a, so shared
// memory does not grow with K. Each thread sums one 8-column group over a
// row lane of the stage's rows.
template <typename T, typename W, bool kUp>
__global__ void __launch_bounds__(kThreads)
esffn_stream_kernel(const T* __restrict__ a_src,
                    const int* __restrict__ row_token,
                    const float* __restrict__ row_gate,
                    const int* __restrict__ block_expert,
                    const W* __restrict__ w0, const W* __restrict__ w1,
                    Scales s0, Scales s1, T* __restrict__ dst, int n, int k,
                    int ncols, int blk, int act) {
  using C = StreamCfg<T, W, kUp>;
  constexpr int NMAT = C::kNMat;
  constexpr int R = kStreamR;
  __shared__ int live[kMaxBlk], tok[kMaxBlk], warp_cnt[kMaxBlk / 32], nlive_s;
  __shared__ unsigned char flag[kMaxBlk];
  extern __shared__ __align__(16) uint8_t wbuf[];

  const int m = blockIdx.x;
  const int base = m * blk;
  const int c0 = blockIdx.y * C::kCols;
  collect_live(row_gate, row_token, base, blk, n, live, tok, flag, warp_cnt, &nlive_s);
  const int nlive = nlive_s;
  if constexpr (!kUp) {
    for (int idx = threadIdx.x; idx < blk * C::kCols; idx += kThreads) {
      const int r = idx / C::kCols, c = c0 + idx % C::kCols;
      if (!flag[r] && c < ncols) dst[(size_t)(base + r) * ncols + c] = from_f<T>(0.0f);
    }
  }
  if (nlive == 0) return;  // padding block: no weight is read

  const int e = block_expert[m];
  const int nsteps = (k + kStreamDT - 1) / kStreamDT;
  const W* we[2] = {w0 + (size_t)e * k * ncols, kUp ? w1 + (size_t)e * k * ncols : nullptr};
  const int cg = threadIdx.x % C::kCG, rl = threadIdx.x / C::kCG;
  const int col_blk = kQuant<T, W> ? (c0 + cg * 8) / s0.tb : 0;
  // this thread's activation copy of every stage: live row ai of the pass,
  // 16 bytes at element ak of the stage
  const int ai = threadIdx.x / C::kActChunks;
  const int ak = threadIdx.x % C::kActChunks * (16 / (int)sizeof(T));

  // stage `step`: the weight rows, and from `arow` (the pass's live row of
  // a this thread copies, or -1) its activation elements
  auto issue = [&](int step, int arow) {
    uint8_t* buf = wbuf + (step % C::kStages) * C::kStageBytes;
    for (int idx = threadIdx.x; idx < NMAT * kStreamDT * C::kChunks; idx += kThreads) {
      const int mat = idx / (kStreamDT * C::kChunks), rem = idx % (kStreamDT * C::kChunks);
      const int row = rem / C::kChunks, ch = rem % C::kChunks;
      const int kk = step * kStreamDT + row;
      const int col = c0 + ch * (16 / (int)sizeof(W));
      const bool valid = kk < k && col < ncols;
      const W* src = valid ? we[mat] + (size_t)kk * ncols + col : we[0];
      hopper::cp_async16(buf + (mat * kStreamDT + row) * C::kLine + ch * 16, src, valid);
    }
    if (ai < R) {
      const int kk = step * kStreamDT + ak;
      const bool valid = arow >= 0 && kk < k;
      hopper::cp_async16(buf + NMAT * C::kMatBytes + (ai * kStreamDT + ak) * (int)sizeof(T),
                         valid ? a_src + (size_t)arow * k + kk : a_src, valid);
    }
  };

  for (int r0 = 0; r0 < nlive; r0 += R) {
    const int nr = min(R, nlive - r0);
    const int arow = ai >= nr ? -1 : kUp ? tok[r0 + ai] : base + live[r0 + ai];
    __syncthreads();  // the previous pass is done with the ring
    for (int step = 0; step < C::kStages - 1; ++step) {
      if (step < nsteps) issue(step, arow);
      hopper::cp_async_commit();
    }

    float acc[NMAT][R][8];
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int v = 0; v < 8; ++v) acc[mat][i][v] = 0.0f;
    // 8-bit weights: the block scales of the rows in hand, read again only
    // where a run of rows sharing them ends
    int scale_end = -1;
    float sc[NMAT];
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat) sc[mat] = 1.0f;

    for (int step = 0; step < nsteps; ++step) {
      hopper::cp_async_wait<C::kStages - 2>();
      __syncthreads();  // stage `step` landed; stage step - 1 is consumed
      if (step + C::kStages - 1 < nsteps) issue(step + C::kStages - 1, arow);
      hopper::cp_async_commit();
      const uint8_t* buf = wbuf + (step % C::kStages) * C::kStageBytes;
      const T* as = reinterpret_cast<const T*>(buf + NMAT * C::kMatBytes);
#pragma unroll
      for (int j = 0; j < kStreamDT / C::kRL; ++j) {
        const int row = rl + C::kRL * j;
        const int kk = step * kStreamDT + row;
        if (kk >= k) break;
        if constexpr (kQuant<T, W>) {
          if (kk >= scale_end) {
            const int rb = kk / s0.ta;
            scale_end = (rb + 1) * s0.ta;
            sc[0] = s0.block(e, rb, col_blk);
            if constexpr (kUp) sc[NMAT - 1] = s1.block(e, rb, col_blk);
          }
        }
        float xv[R];
#pragma unroll
        for (int i = 0; i < R; ++i) xv[i] = to_f(as[i * kStreamDT + row]);
#pragma unroll
        for (int mat = 0; mat < NMAT; ++mat) {
          float w[8];
          load_w8(buf + (mat * kStreamDT + row) * C::kLine + cg * 8 * (int)sizeof(W), w, W());
          if constexpr (kQuant<T, W>) {
#pragma unroll
            for (int v = 0; v < 8; ++v) w[v] *= sc[mat];
          }
#pragma unroll
          for (int i = 0; i < R; ++i) {
            if (i < nr) {
#pragma unroll
              for (int v = 0; v < 8; ++v) acc[mat][i][v] = fmaf(xv[i], w[v], acc[mat][i][v]);
            }
          }
        }
      }
    }

    // sum the row lanes: across a warp's lanes of one column group, then
    // across the 8 warps in shared memory (the ring is free by now)
#pragma unroll
    for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
      for (int i = 0; i < R; ++i)
#pragma unroll
        for (int v = 0; v < 8; ++v)
#pragma unroll
          for (int off = C::kCG; off < 32; off <<= 1)
            acc[mat][i][v] += __shfl_xor_sync(0xffffffffu, acc[mat][i][v], off);
    hopper::cp_async_wait<0>();
    __syncthreads();
    float* red = reinterpret_cast<float*>(wbuf);  // [warp][mat][i][kCols]
    const int warp = threadIdx.x / 32;
    if (threadIdx.x % 32 < C::kCG) {
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat)
#pragma unroll
        for (int i = 0; i < R; ++i)
#pragma unroll
          for (int v = 0; v < 8; ++v)
            red[((warp * NMAT + mat) * R + i) * C::kCols + cg * 8 + v] = acc[mat][i][v];
    }
    __syncthreads();
    for (int idx = threadIdx.x; idx < nr * C::kCols; idx += kThreads) {
      const int i = idx / C::kCols, c = idx % C::kCols;
      if (c0 + c >= ncols) continue;
      float sum[NMAT];
#pragma unroll
      for (int mat = 0; mat < NMAT; ++mat) {
        sum[mat] = 0.0f;
        for (int w = 0; w < kThreads / 32; ++w)
          sum[mat] += red[((w * NMAT + mat) * R + i) * C::kCols + c];
      }
      const int r = base + live[r0 + i];
      if constexpr (kUp) {
        const float gr = round_t<T>(sum[0]), ur = round_t<T>(sum[NMAT - 1]);
        dst[(size_t)r * ncols + c0 + c] = from_f<T>(round_t<T>(act_fn(act, gr)) * ur);
      } else {
        dst[(size_t)r * ncols + c0 + c] = from_f<T>(sum[0] * row_gate[r]);
      }
    }
  }
}

template <typename T, typename W, bool kUp>
int launch_stream_kernel(const void* a_src, const void* row_token,
                         const void* row_gate, const void* block_expert,
                         const void* w0, const void* w1, Scales s0, Scales s1,
                         void* dst, int n, int k, int ncols, int nblk, int blk,
                         int act, cudaStream_t stream) {
  using C = StreamCfg<T, W, kUp>;
  auto kernel = esffn_stream_kernel<T, W, kUp>;
  static bool configured = false;       // one attribute set per instance
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const dim3 grid(nblk, (ncols + C::kCols - 1) / C::kCols);
  kernel<<<grid, kThreads, C::kSmem, stream>>>(
      (const T*)a_src, (const int*)row_token, (const float*)row_gate,
      (const int*)block_expert, (const W*)w0, (const W*)w1, s0, s1, (T*)dst,
      n, k, ncols, blk, act);
  return (int)cudaGetLastError();
}

template <typename T, typename W>
int launch(const void* x, const void* row_token, const void* row_gate,
           const void* block_expert, const void* wg, const void* wu,
           const void* wd, Scales sg, Scales su, Scales sd, void* h, void* out,
           int n, int d, int f, int np_rows, int blk, int act,
           cudaStream_t stream) {
  // 16-byte copies: rows of the weights, x and h start on 16 bytes when
  // D and F are multiples of 16 (and the bases are aligned); an 8-bit
  // thread's 8 columns share one block scale when tb % 8 == 0.
  if (d % 16 || f % 16 || blk < 1 || blk > kMaxBlk || np_rows % blk ||
      ((uintptr_t)x | (uintptr_t)wg | (uintptr_t)wu | (uintptr_t)wd |
       (uintptr_t)h) % 16 ||
      (kQuant<T, W> && (sg.tb % 8 || sd.tb % 8)))
    return (int)cudaErrorInvalidValue;
  const int nblk = np_rows / blk;
  const int err = launch_stream_kernel<T, W, true>(
      x, row_token, row_gate, block_expert, wg, wu, sg, su, h, n, d, f, nblk,
      blk, act, stream);
  if (err) return err;
  return launch_stream_kernel<T, W, false>(
      h, row_token, row_gate, block_expert, wd, nullptr, sd, Scales{}, out,
      n, f, d, nblk, blk, act, stream);
}

// ---- GLU form, wgmma route ----------------------------------------------------

constexpr int kUpFT = 128;     // F columns of a wgmma up CTA

template <int NC>              // consumer warpgroups: BM = 64 NC rows
struct GluUp {
  static constexpr int kBM = 64 * NC;
  static constexpr int kStages = 4;
  static constexpr int kABytes = kBM * 128;                  // kBM rows x 64 D
  static constexpr int kWBytes = 2 * hopper::kBoxBytes64;    // 64 D x 128 F
  static constexpr int kStageBytes = kABytes + 2 * kWBytes;  // x, Wg, Wu
  static constexpr int kProducers = 64;                      // two warps
  static constexpr int kLag = 2;        // gathered stages in flight
  static constexpr int kThreads = NC * 128 + kProducers;
  static constexpr int kSmem = kStages * kStageBytes + 1024 + 2 * kStages * 8;
};

// h = round(act(round(x Wg[e]))) * round(x Wu[e]) for the live rows of one
// BM-row tile (one block, expert e) and 128 F columns. The producer warp
// gathers x rows through row_token with 16-byte cp.async into the 128-byte
// swizzled layout TMA would give (chunk c of row r at c ^ (r & 7); dead
// rows zeros) and brings the Wg and Wu tiles by TMA, MN-major.
template <int NC>
__global__ void __launch_bounds__(GluUp<NC>::kThreads, 1)
esffn_up_wgmma_kernel(const __nv_bfloat16* __restrict__ x,
                      const int* __restrict__ row_token,
                      const float* __restrict__ row_gate,
                      const int* __restrict__ block_expert,
                      __grid_constant__ const CUtensorMap wg_map,
                      __grid_constant__ const CUtensorMap wu_map,
                      __nv_bfloat16* __restrict__ h, int n, int d, int f,
                      int f_tiles, int act) {
  using C = GluUp<NC>;
  __shared__ int src_row[C::kBM];       // token of each tile row; -1: dead
  extern __shared__ uint8_t smem_raw[];
  const int m_blk = blockIdx.x / f_tiles;
  const int f0 = (blockIdx.x % f_tiles) * kUpFT;
  const int m0 = m_blk * C::kBM;
  bool on = false;
  if (threadIdx.x < C::kBM) {
    on = row_gate[m0 + threadIdx.x] != 0.0f;
    src_row[threadIdx.x] = on ? min(row_token[m0 + threadIdx.x], n - 1) : -1;
  }
  if (!__syncthreads_or(on)) return;    // a block with no live row reads nothing

  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kStages * C::kStageBytes);
  uint64_t* empty = full + C::kStages;
  const int e = block_expert[m_blk];
  const int nk = (d + hopper::kTileK - 1) / hopper::kTileK;
  const int warp = threadIdx.x / 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hopper::mbar_init(&full[s], C::kProducers + 1);  // + the TMA arrival
      hopper::mbar_init(&empty[s], NC * 128);
    }
    hopper::mbar_init_fence();
  }
  __syncthreads();

  if (warp >= NC * 4) {                 // producer warps
    const int pt = threadIdx.x - NC * 128;  // 0 .. kProducers - 1
    for (int kt = 0; kt < nk; ++kt) {
      const int s = kt % C::kStages;
      if (kt >= C::kStages) hopper::mbar_wait(&empty[s], ((kt / C::kStages) - 1) & 1);
      uint8_t* a = smem + s * C::kStageBytes;
      uint8_t* wgt = a + C::kABytes;
      uint8_t* wut = wgt + C::kWBytes;
      const int k0 = kt * hopper::kTileK;
      if (pt == 0) {
        hopper::mbar_arrive_expect_tx(&full[s], 2 * C::kWBytes);
        hopper::tma_load_3d(wgt, &wg_map, &full[s], f0, k0, e);
        hopper::tma_load_3d(wgt + hopper::kBoxBytes64, &wg_map, &full[s], f0 + 64, k0, e);
        hopper::tma_load_3d(wut, &wu_map, &full[s], f0, k0, e);
        hopper::tma_load_3d(wut + hopper::kBoxBytes64, &wu_map, &full[s], f0 + 64, k0, e);
      }
      for (int idx = pt; idx < C::kBM * 8; idx += C::kProducers) {
        const int r = idx / 8, c = idx % 8;
        const int tok_r = src_row[r], col = k0 + 8 * c;
        const bool valid = tok_r >= 0 && col < d;
        hopper::cp_async16(a + r * 128 + ((c ^ (r & 7)) << 4),
                           valid ? x + (size_t)tok_r * d + col : x, valid);
      }
      hopper::cp_async_commit();
      // the gather of stage kt - kLag has landed: publish it (kLag stages
      // of gathers stay in flight; kLag <= kStages - 2, or the ring stalls)
      if (kt >= C::kLag) {
        hopper::cp_async_wait<C::kLag>();
        hopper::fence_proxy_async();
        hopper::mbar_arrive(&full[(kt - C::kLag) % C::kStages]);
      }
    }
    hopper::cp_async_wait<0>();
    hopper::fence_proxy_async();
    for (int kt = nk > C::kLag ? nk - C::kLag : 0; kt < nk; ++kt)
      hopper::mbar_arrive(&full[kt % C::kStages]);
    return;
  }

  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  float ag[64], au[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) {
    ag[i] = 0.0f;
    au[i] = 0.0f;
  }
  int prev = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % C::kStages;
    hopper::mbar_wait(&full[s], (kt / C::kStages) & 1);
    const uint8_t* a = smem + s * C::kStageBytes + wg * hopper::kBoxBytes64;
    const uint8_t* wgt = smem + s * C::kStageBytes + C::kABytes;
    const uint8_t* wut = wgt + C::kWBytes;
    hopper::fence_acc(ag);
    hopper::fence_acc(au);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint64_t da = hopper::make_desc(a + kk * 32, 16, 1024);
      hopper::Wgmma<128, 0, 1>::ss(
          ag, da, hopper::make_desc(wgt + kk * 2048, hopper::kBoxBytes64, 1024), 1);
      hopper::Wgmma<128, 0, 1>::ss(
          au, da, hopper::make_desc(wut + kk * 2048, hopper::kBoxBytes64, 1024), 1);
    }
    hopper::wgmma_commit();
    hopper::fence_acc(ag);
    hopper::fence_acc(au);
    hopper::wgmma_wait<1>();            // the group before this one is done
    if (kt > 0) hopper::mbar_arrive(&empty[prev]);
    prev = s;
  }
  hopper::wgmma_wait<0>();
  hopper::fence_acc(ag);
  hopper::fence_acc(au);

#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int r = 64 * wg + hopper::frag_row(t, i);
    const int col = f0 + hopper::frag_col(t, i);
    if (src_row[r] < 0 || col >= f) continue;  // h of a dead row is never read
    float hv[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const float gr = round_t<__nv_bfloat16>(ag[i + u]);
      const float ur = round_t<__nv_bfloat16>(au[i + u]);
      hv[u] = round_t<__nv_bfloat16>(act_fn(act, gr)) * ur;
    }
    *reinterpret_cast<__nv_bfloat162*>(&h[(size_t)(m0 + r) * f + col]) =
        __floats2bfloat162_rn(hv[0], hv[1]);
  }
}

// out = round((h Wd[e]) * gate) on the sorted layout: hopper::SortedGemm's
// mainloop over h (TMA) and Wd[e] (MN-major), rows whose gate is 0
// written as 0, and a block with no live row writing zeros and reading
// nothing.
template <int NC>
__global__ void __launch_bounds__(hopper::SortedGemm<NC, false>::kThreads, 2)
esffn_down_wgmma_kernel(__grid_constant__ const CUtensorMap h_map,
                        __grid_constant__ const CUtensorMap wd_map,
                        const float* __restrict__ row_gate,
                        const int* __restrict__ block_expert,
                        __nv_bfloat16* __restrict__ out, int d, int f,
                        int n_tiles) {
  using G = hopper::SortedGemm<NC, false>;
  const int m_blk = blockIdx.x / n_tiles;
  const int n0 = (blockIdx.x % n_tiles) * G::kBN;
  const int m0 = m_blk * G::kBM;
  const bool on = threadIdx.x < G::kBM && row_gate[m0 + threadIdx.x] != 0.0f;
  if (!__syncthreads_or(on)) {
    for (int idx = threadIdx.x; idx < G::kBM * G::kBN; idx += G::kThreads) {
      const int col = n0 + idx % G::kBN;
      if (col < d) out[(size_t)(m0 + idx / G::kBN) * d + col] = __float2bfloat16(0.0f);
    }
    return;
  }
  extern __shared__ uint8_t smem_raw[];
  uint64_t *full, *empty;
  uint8_t* smem = G::setup(smem_raw, full, empty);
  const int e = block_expert[m_blk];
  const int nk = (f + hopper::kTileK - 1) / hopper::kTileK;
  const int warp = threadIdx.x / 32;
  if (warp == G::kProducerWarp) {
    G::produce(smem, full, empty, &h_map, &wd_map, m0, n0, e, nk);
    return;
  }
  const int wg = warp / 4;
  const int t = threadIdx.x % 128;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.0f;
  G::consume(smem, full, empty, wg, nk, acc);
#pragma unroll
  for (int i = 0; i < 64; i += 2) {
    const int row = m0 + 64 * wg + hopper::frag_row(t, i);
    const int col = n0 + hopper::frag_col(t, i);
    if (col >= d) continue;
    const float gate = row_gate[row];
    *reinterpret_cast<__nv_bfloat162*>(&out[(size_t)row * d + col]) =
        gate != 0.0f ? __floats2bfloat162_rn(acc[i] * gate, acc[i + 1] * gate)
                     : __floats2bfloat162_rn(0.0f, 0.0f);
  }
}

template <int NC>
int launch_wgmma_nc(const void* x, const void* row_token, const void* row_gate,
                    const void* block_expert, const void* wg, const void* wu,
                    const void* wd, void* h, void* out, int n, int d, int f,
                    int np_rows, int num_experts, int act,
                    cudaStream_t stream) {
  using U = GluUp<NC>;
  using G = hopper::SortedGemm<NC, false>;
  // Wg, Wu (E, D, F) and Wd (E, F, D): 3-D maps, the expert outermost, in
  // 64 x 64 boxes; h (Np, F): 64 F x BM rows.
  CUtensorMap wg_map, wu_map, wd_map, h_map;
  const uint64_t up_dims[3] = {(uint64_t)f, (uint64_t)d, (uint64_t)num_experts};
  const uint64_t up_strides[2] = {(uint64_t)f * 2, (uint64_t)f * d * 2};
  const uint64_t dn_dims[3] = {(uint64_t)d, (uint64_t)f, (uint64_t)num_experts};
  const uint64_t dn_strides[2] = {(uint64_t)d * 2, (uint64_t)f * d * 2};
  const uint32_t w_box[3] = {64, 64, 1};
  const uint64_t h_dims[2] = {(uint64_t)f, (uint64_t)np_rows};
  const uint64_t h_strides[1] = {(uint64_t)f * 2};
  const uint32_t h_box[2] = {64, (uint32_t)G::kBM};
  if (!hopper::encode_bf16_map(&wg_map, wg, 3, up_dims, up_strides, w_box) ||
      !hopper::encode_bf16_map(&wu_map, wu, 3, up_dims, up_strides, w_box) ||
      !hopper::encode_bf16_map(&wd_map, wd, 3, dn_dims, dn_strides, w_box) ||
      !hopper::encode_bf16_map(&h_map, h, 2, h_dims, h_strides, h_box))
    return (int)cudaErrorInvalidValue;
  static bool configured = false;       // one attribute set per instance
  if (!configured) {
    cudaError_t err = cudaFuncSetAttribute(
        esffn_up_wgmma_kernel<NC>, cudaFuncAttributeMaxDynamicSharedMemorySize, U::kSmem);
    if (err == cudaSuccess)
      err = cudaFuncSetAttribute(esffn_down_wgmma_kernel<NC>,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, G::kSmem);
    if (err != cudaSuccess) return (int)err;
    configured = true;
  }
  const int nblk = np_rows / U::kBM;
  const int f_tiles = (f + kUpFT - 1) / kUpFT;
  esffn_up_wgmma_kernel<NC><<<nblk * f_tiles, U::kThreads, U::kSmem, stream>>>(
      (const __nv_bfloat16*)x, (const int*)row_token, (const float*)row_gate,
      (const int*)block_expert, wg_map, wu_map, (__nv_bfloat16*)h, n, d, f,
      f_tiles, act);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_tiles = (d + G::kBN - 1) / G::kBN;
  esffn_down_wgmma_kernel<NC><<<nblk * n_tiles, G::kThreads, G::kSmem, stream>>>(
      h_map, wd_map, (const float*)row_gate, (const int*)block_expert,
      (__nv_bfloat16*)out, d, f, n_tiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// 2-MLP form
// ---------------------------------------------------------------------------

// One BM x 128 output tile of either product, on the tensor cores
// (mma_sync.cuh: 3xTF32, or one bf16 pass for bf16 x and weights), on
// expert e = block_expert of the tile's block. The tile is `rows` <= BM
// rows of one block (rows < BM only at blk 8, where the m16 tile's other 8
// rows are zeros and never written). kUp: a = x (N, K = D) gathered through
// row_token, w = W1 (E, D, F), out = h (Np, F) on live rows, b1 added in
// f32 before z rounds to T. !kUp: a = h (Np, K = F), w = W2 (E, F, D), the
// accumulators start from b2, out (Np, D) = (acc * gate) on every row of
// the tile, 0 on dead rows.
//
// Staging: f32 x / h rows and f32 W rows come by 16-byte cp.async (dead
// rows and rows past K zero-filled, nothing read); bf16 and 8-bit operands
// by 16- or 8-byte loads into registers a stage ahead, converted (8-bit:
// times their block scale, looked up once per 8-column chunk where the
// chunk lies in one scale block) and stored as f32 after the stage's
// products. Every operand lands in the f32 tiles the mainloop reads.
template <typename T, typename W, int BM, bool kUp>
__global__ void __launch_bounds__(mma::kThreads, mma::kMinBlocks)
esffn_mlp_mma_kernel(const T* __restrict__ a, const int* __restrict__ row_token,
                     const float* __restrict__ row_gate,
                     const int* __restrict__ block_expert, const W* __restrict__ w,
                     Scales sw, const float* __restrict__ bias, T* __restrict__ out,
                     int n, int k, int ncols, int blk, int rows, int act) {
  using Tl = mma::Tile<BM>;
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value &&
                         std::is_same<W, __nv_bfloat16>::value;
  constexpr bool kAsyncA = std::is_same<T, float>::value;
  constexpr bool kAsyncB = std::is_same<W, float>::value;
  constexpr int BK = mma::kBK, BN = mma::kBN, NT = mma::kThreads, S = mma::kStages;
  // register-staged 8-element chunks a thread a stage
  constexpr int kARc = kAsyncA ? 1 : (BM * (BK / 8) + NT - 1) / NT;
  constexpr int kBRc = kAsyncB ? 1 : BK * (BN / 8) / NT;
  extern __shared__ __align__(16) float sm[];
  __shared__ int srow[BM];   // row of `a` feeding each tile row; -1: dead
  __shared__ float gate[BM];
  __shared__ int sn[BN];     // 8-bit W: the scale block of each tile column

  const int tid = threadIdx.x;
  const int m0 = blockIdx.x * rows;
  const int n0 = blockIdx.y * BN;
  bool live = false;
  if (tid < BM) {
    const float g = tid < rows ? row_gate[m0 + tid] : 0.0f;
    live = g != 0.0f;
    gate[tid] = g;
    srow[tid] = !live ? -1 : (kUp ? min(row_token[m0 + tid], n - 1) : m0 + tid);
  }
  if (!__syncthreads_or(live)) {  // padding tile: no weight is read
    if (!kUp)
      for (int idx = tid; idx < rows * BN; idx += NT) {
        const int c = n0 + idx % BN;
        if (c < ncols) out[(size_t)(m0 + idx / BN) * ncols + c] = from_f<T>(0.0f);
      }
    return;
  }
  const int e = block_expert[m0 / blk];
  const W* we = w + (size_t)e * k * ncols;
  if constexpr (kQuant<T, W>) {
    for (int c = tid; c < BN; c += NT) sn[c] = min(n0 + c, ncols - 1) / sw.tb;
    __syncthreads();
  }

  mma::Warp<BM, kBf16> wp;
#pragma unroll
  for (int nt = 0; nt < Tl::kNT; ++nt) {
    // b2 seeds the down accumulators, once per row
    const int c = n0 + wp.col(nt);
    const bool seed = !kUp && bias != nullptr && c < ncols;
    const float b0 = seed ? bias[(size_t)e * ncols + c] : 0.0f;
    const float b1 = seed ? bias[(size_t)e * ncols + c + 1] : 0.0f;
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
        const int s = srow[r];
        const bool v = s >= 0 && k0 + c < k;
        hopper::cp_async16(as + r * Tl::kAS + c, v ? a + (size_t)s * k + k0 + c : a, v);
      }
    }
    if constexpr (kAsyncB) {
      float* bs = stage_b(st);
      for (int idx = tid; idx < BK * (BN / 4); idx += NT) {
        const int r = idx / (BN / 4), c = idx % (BN / 4) * 4;
        const bool v = k0 + r < k && n0 + c < ncols;
        hopper::cp_async16(bs + r * Tl::kBS + c,
                           v ? we + (size_t)(k0 + r) * ncols + n0 + c : we, v);
      }
    }
  };
  // register part of K slice kt (bf16 and 8-bit operands)
  auto load_regs = [&](int kt) {
    const int k0 = kt * BK;
    if constexpr (!kAsyncA) {
#pragma unroll
      for (int i = 0; i < kARc; ++i) {
        const int idx = tid + i * NT, r = idx / (BK / 8), c = idx % (BK / 8) * 8;
        const int s = idx < BM * (BK / 8) ? srow[r] : -1;
        ra[i] = (s >= 0 && k0 + c < k) ? mma::ld8(a + (size_t)s * k + k0 + c) : make_uint4(0, 0, 0, 0);
      }
    }
    if constexpr (!kAsyncB) {
#pragma unroll
      for (int i = 0; i < kBRc; ++i) {
        const int idx = tid + i * NT, r = idx / (BN / 8), c = idx % (BN / 8) * 8;
        rb[i] = (k0 + r < k && n0 + c < ncols) ? mma::ld8(we + (size_t)(k0 + r) * ncols + n0 + c)
                                               : make_uint4(0, 0, 0, 0);
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
        *reinterpret_cast<float4*>(as + r * Tl::kAS + c) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(as + r * Tl::kAS + c + 4) = make_float4(v[4], v[5], v[6], v[7]);
      }
    }
    if constexpr (!kAsyncB) {
      float* bs = stage_b(st);
#pragma unroll
      for (int i = 0; i < kBRc; ++i) {
        const int idx = tid + i * NT, r = idx / (BN / 8), c = idx % (BN / 8) * 8;
        float v[8];
        mma::cvt8(rb[i], v, W());
        if constexpr (kQuant<T, W>) {
          if (k0 + r < k) {
            const int rbk = (k0 + r) / sw.ta;
            if (sn[c] == sn[c + 7]) {
              const float s = sw.block(e, rbk, sn[c]);
#pragma unroll
              for (int j = 0; j < 8; ++j) v[j] *= s;
            } else {
#pragma unroll
              for (int j = 0; j < 8; ++j) v[j] *= sw.block(e, rbk, sn[c + j]);
            }
          }
        }
        *reinterpret_cast<float4*>(bs + r * Tl::kBS + c) = make_float4(v[0], v[1], v[2], v[3]);
        *reinterpret_cast<float4*>(bs + r * Tl::kBS + c + 4) = make_float4(v[4], v[5], v[6], v[7]);
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
      if (r >= rows) continue;  // the next block's row (blk 8)
      const size_t row = (size_t)(m0 + r);
      const bool on = srow[r] >= 0;
      if (kUp && !on) continue;  // h of a dead row is never read
#pragma unroll
      for (int nt = 0; nt < Tl::kNT; ++nt) {
        const int c = n0 + wp.col(nt);
        if (c >= ncols) continue;
        float v0 = wp.acc[mt][nt][2 * half], v1 = wp.acc[mt][nt][2 * half + 1];
        if (kUp) {
          if (bias != nullptr) {
            v0 += bias[(size_t)e * ncols + c];
            v1 += bias[(size_t)e * ncols + c + 1];
          }
          v0 = act_fn(act, round_t<T>(v0));
          v1 = act_fn(act, round_t<T>(v1));
        } else {
          v0 = on ? v0 * gate[r] : 0.0f;
          v1 = on ? v1 * gate[r] : 0.0f;
        }
        if constexpr (std::is_same<T, float>::value) {
          *reinterpret_cast<float2*>(out + row * ncols + c) = make_float2(v0, v1);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(out + row * ncols + c) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
}

template <typename T, typename W, int BM>
int mlp_launch_bm(const void* x, const void* row_token, const void* row_gate,
                  const void* block_expert, const void* w1, Scales s1,
                  const void* b1, const void* w2, Scales s2, const void* b2,
                  void* h, void* out, int n, int d, int f, int np_rows,
                  int blk, int rows, int act, cudaStream_t stream) {
  constexpr int smem = mma::Tile<BM>::kSmem;
  auto up = esffn_mlp_mma_kernel<T, W, BM, true>;
  auto down = esffn_mlp_mma_kernel<T, W, BM, false>;
  cudaError_t err = cudaFuncSetAttribute(up, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(down, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 up_grid(np_rows / rows, (f + mma::kBN - 1) / mma::kBN);
  up<<<up_grid, mma::kThreads, smem, stream>>>(
      (const T*)x, (const int*)row_token, (const float*)row_gate,
      (const int*)block_expert, (const W*)w1, s1, (const float*)b1, (T*)h, n,
      d, f, blk, rows, act);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 down_grid(np_rows / rows, (d + mma::kBN - 1) / mma::kBN);
  down<<<down_grid, mma::kThreads, smem, stream>>>(
      (const T*)h, (const int*)row_token, (const float*)row_gate,
      (const int*)block_expert, (const W*)w2, s2, (const float*)b2, (T*)out,
      n, f, d, blk, rows, act);
  return (int)cudaGetLastError();
}

// A tile is BM rows of one block, BM the largest of 128, 64, 32, 16 that
// divides blk; at blk % 16 != 0 a 16-row tile holds one 8-row block.
template <typename T, typename W>
int mlp_launch(const void* x, const void* row_token, const void* row_gate,
               const void* block_expert, const void* w1, Scales s1,
               const void* b1, const void* w2, Scales s2, const void* b2,
               void* h, void* out, int n, int d, int f, int np_rows, int blk,
               int act, cudaStream_t stream) {
  if (blk % 8 || blk < 8 || blk > kMaxBlk || np_rows % blk || d % 8 || f % 8 ||
      n < 1 ||
      ((uintptr_t)x | (uintptr_t)w1 | (uintptr_t)w2 | (uintptr_t)h | (uintptr_t)out) % 16)
    return (int)cudaErrorInvalidValue;
#define ESFFN_MLP_BM(BM, ROWS)                                                \
  return mlp_launch_bm<T, W, BM>(x, row_token, row_gate, block_expert, w1,   \
                                 s1, b1, w2, s2, b2, h, out, n, d, f,         \
                                 np_rows, blk, ROWS, act, stream)
  if (blk % 128 == 0) ESFFN_MLP_BM(128, 128);
  if (blk % 64 == 0) ESFFN_MLP_BM(64, 64);
  if (blk % 32 == 0) ESFFN_MLP_BM(32, 32);
  if (blk % 16 == 0) ESFFN_MLP_BM(16, 16);
  ESFFN_MLP_BM(16, 8);
#undef ESFFN_MLP_BM
}

// Returns CALL(T, W) for the activation dtype (0 = float32, 1 = bfloat16)
// and the weight storage (wdtype 0 = T itself, 1 = int8, 2 = fp8 e4m3);
// refuses anything else.
#define ESFFN_DISPATCH(dtype, wdtype, CALL)                                 \
  do {                                                                      \
    if ((dtype) == 1) {                                                     \
      if ((wdtype) == 0) return CALL(__nv_bfloat16, __nv_bfloat16);         \
      if ((wdtype) == 1) return CALL(__nv_bfloat16, int8_t);                \
      if ((wdtype) == 2) return CALL(__nv_bfloat16, __nv_fp8_e4m3);         \
    } else if ((dtype) == 0) {                                              \
      if ((wdtype) == 0) return CALL(float, float);                         \
      if ((wdtype) == 1) return CALL(float, int8_t);                        \
      if ((wdtype) == 2) return CALL(float, __nv_fp8_e4m3);                 \
    }                                                                       \
    return (int)cudaErrorInvalidValue;                                      \
  } while (0)

bool tiles_ok(int rows, int cols, int ta, int tb) {
  return ta > 0 && tb > 0 && rows % ta == 0 && cols % tb == 0;
}

}  // namespace

// The GLU form on the stream route. dtype: 0 = float32, 1 = bfloat16. act:
// ACT_IDS. h: (Np, F) scratch of dtype T; out: (Np, D). Requires 8 <= blk
// <= 128, D and F multiples of 16 and 16-byte aligned weights (anything
// else is refused).
extern "C" int esffn_glu_launch(const void* x, const void* row_token,
                                const void* row_gate, const void* block_expert,
                                const void* wg, const void* wu, const void* wd,
                                void* h, void* out, int n, int d, int f,
                                int np_rows, int blk, int dtype, int act,
                                void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define GLU(T, W)                                                            \
  launch<T, W>(x, row_token, row_gate, block_expert, wg, wu, wd, Scales{},    \
               Scales{}, Scales{}, h, out, n, d, f, np_rows, blk, act, s)
  ESFFN_DISPATCH(dtype, 0, GLU);
#undef GLU
}

// The GLU form on the wgmma route: bf16 x, weights, h and out; blk 64 or
// 128, D and F multiples of 8, x, the weights and h 16-byte aligned
// (anything else is refused). num_experts = E, the extent of the weights'
// tensor maps; the other arguments as esffn_glu_launch.
extern "C" int esffn_glu_wgmma_launch(const void* x, const void* row_token,
                                      const void* row_gate,
                                      const void* block_expert, const void* wg,
                                      const void* wu, const void* wd, void* h,
                                      void* out, int n, int d, int f,
                                      int np_rows, int blk, int act,
                                      int num_experts, void* stream) {
  if ((blk != 64 && blk != 128) || d % 8 || f % 8 || np_rows % blk ||
      num_experts < 1 || n < 1 ||
      ((uintptr_t)x | (uintptr_t)wg | (uintptr_t)wu | (uintptr_t)wd |
       (uintptr_t)h) % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (blk == 128)
    return launch_wgmma_nc<2>(x, row_token, row_gate, block_expert, wg, wu, wd,
                              h, out, n, d, f, np_rows, num_experts, act, s);
  return launch_wgmma_nc<1>(x, row_token, row_gate, block_expert, wg, wu, wd,
                            h, out, n, d, f, np_rows, num_experts, act, s);
}

// The GLU form with 8-bit weights, on the stream route: wdtype 1 = int8,
// 2 = fp8 e4m3 (wg, wu, wd alike); sg, su (E, D / ta_up, F / tb_up) and
// sd (E, F / ta_dn, D / tb_dn) their f32 block scales, tb_up and tb_dn
// multiples of 8. x, h and out as esffn_glu_launch.
extern "C" int esffn_glu_q_launch(const void* x, const void* row_token,
                                  const void* row_gate,
                                  const void* block_expert, const void* wg,
                                  const void* wu, const void* wd,
                                  const void* sg, const void* su,
                                  const void* sd, void* h, void* out, int n,
                                  int d, int f, int np_rows, int blk,
                                  int dtype, int wdtype, int act, int ta_up,
                                  int tb_up, int ta_dn, int tb_dn,
                                  void* stream) {
  if (wdtype == 0 || !tiles_ok(d, f, ta_up, tb_up) ||
      !tiles_ok(f, d, ta_dn, tb_dn) || !sg || !su || !sd)
    return (int)cudaErrorInvalidValue;
  const Scales g{(const float*)sg, d, f, ta_up, tb_up};
  const Scales u{(const float*)su, d, f, ta_up, tb_up};
  const Scales dn{(const float*)sd, f, d, ta_dn, tb_dn};
  cudaStream_t s = (cudaStream_t)stream;
#define GLU(T, W)                                                            \
  launch<T, W>(x, row_token, row_gate, block_expert, wg, wu, wd, g, u, dn, h, \
               out, n, d, f, np_rows, blk, act, s)
  ESFFN_DISPATCH(dtype, wdtype, GLU);
#undef GLU
}

// dtype: 0 = float32, 1 = bfloat16 (x, w1, w2, h and out). b1 (E, F) and b2
// (E, D) are f32 or null. h: (Np, F) scratch of dtype T (live rows
// written); out: (Np, D). Requires 8 <= blk <= 128 a multiple of 8, D and
// F multiples of 8 and 16-byte aligned x, weights, h and out (anything
// else is refused).
extern "C" int esffn_mlp_launch(const void* x, const void* row_token,
                                const void* row_gate, const void* block_expert,
                                const void* w1, const void* b1, const void* w2,
                                const void* b2, void* h, void* out, int n,
                                int d, int f, int np_rows, int blk, int dtype,
                                int act, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define MLP(T, W)                                                            \
  mlp_launch<T, W>(x, row_token, row_gate, block_expert, w1, Scales{}, b1,    \
                   w2, Scales{}, b2, h, out, n, d, f, np_rows, blk, act, s)
  ESFFN_DISPATCH(dtype, 0, MLP);
#undef MLP
}

// The 2-MLP form with 8-bit weights: wdtype 1 = int8, 2 = fp8 e4m3 (w1 and
// w2 alike); s1 (E, D / ta1, F / tb1) and s2 (E, F / ta2, D / tb2) their
// f32 block scales. The biases stay f32 (or null).
extern "C" int esffn_mlp_q_launch(const void* x, const void* row_token,
                                  const void* row_gate,
                                  const void* block_expert, const void* w1,
                                  const void* s1, const void* b1,
                                  const void* w2, const void* s2,
                                  const void* b2, void* h, void* out, int n,
                                  int d, int f, int np_rows, int blk,
                                  int dtype, int wdtype, int act, int ta1,
                                  int tb1, int ta2, int tb2, void* stream) {
  if (wdtype == 0 || !tiles_ok(d, f, ta1, tb1) || !tiles_ok(f, d, ta2, tb2) ||
      !s1 || !s2)
    return (int)cudaErrorInvalidValue;
  const Scales q1{(const float*)s1, d, f, ta1, tb1};
  const Scales q2{(const float*)s2, f, d, ta2, tb2};
  cudaStream_t s = (cudaStream_t)stream;
#define MLP(T, W)                                                            \
  mlp_launch<T, W>(x, row_token, row_gate, block_expert, w1, q1, b1, w2, q2,  \
                   b2, h, out, n, d, f, np_rows, blk, act, s)
  ESFFN_DISPATCH(dtype, wdtype, MLP);
#undef MLP
}
