// The f32 tensor-core mainloop of the sorted-layout GEMMs, for Hopper
// (sm_90a): mma.sync products over f32 tiles in shared memory, either
// 3xTF32 (f32 operands, and 8-bit weights dequantized to f32 as they are
// staged) or one bf16 pass (bf16 operands). esffn.cu's 2-MLP kernel,
// esmm.cu's mma_tf32x3 route and esfk.cu's tensor-core kernel run on it.
//
// Why mma.sync and not wgmma: TF32 wgmma reads both operands K-major from
// shared memory, and the expert weights W (E, K, N) are N-major as stored.
// mma.sync fragments are loaded by hand, so a padded tile of either
// orientation serves as it is and no operand is transposed in memory.
//
// 3xTF32: each f32 operand x is split as hi = tf32(x) (round to nearest)
// and lo = x - hi (which the tensor core reads truncated to TF32), and a
// product sums lo*hi + hi*lo + hi*hi in f32 (lo*lo, about 2^-22 of the
// product, is left out). The f32 result then lands within a few f32 ulps
// of an f32 FMA sum, where one TF32 pass would be off by about 2^-11
// relative: 3 x the tensor work for f32 accuracy. The split is three
// integer and float operations a value; two cvt.rna.tf32.f32 a value took
// more issue slots than the products hide. An operand whose values are
// bf16 (kAExact) is exact in TF32: lo = 0, and its lo*hi product is
// skipped, which changes no bit of the sum.
//
// Promotion (kPromote): the tensor core adds its products into the f32
// accumulator with truncation, so over a long K the error of each mma
// adds up toward zero (some 2^-24 of |acc| an mma). With kPromote each
// k step's products go into a fresh m16n8 register tile and are added
// into the accumulator by an f32 add, rounded to nearest, as an FMA loop
// would: 4 adds a thread for every 3 (or 1) mma, and an error that no
// longer grows with K.
//
// Two CTAs share an SM (at most 128 registers a thread; the 128-row tiles
// spill a few dozen bytes a thread), so one's loads and epilogue overlap
// the other's products.
//
// The tile: a CTA of kThreads = 256 (8 warps) computes BM x kBN = BM x 128
// outputs over a kBK = 32 deep K slice a stage, kStages stages in a ring.
// The warps lie kWM x kWN over the tile; a warp owns kMT x kNT m16n8
// accumulator tiles. Operand layouts of a stage (flags of Tile and Warp):
//   A row-major  [BM][kBK + 4]          rows of A contiguous in K (default)
//   A M-major    [kBK][BM + 8 | 4]      kAMajorM: a K row contiguous in M
//                                       (esfk's x1, contracted over rows)
//   B N-major    [kBK][kBN + 8]         W (E, K, N) as stored (default)
//   B K-major    [kBN][kBK + 4]         kBMajorK: W (E, N, K) as stored
//                                       (3xTF32 only: no bf16 kernel reads
//                                       B K-major)
// The row pads put every fragment load of a warp on 32 distinct banks:
// a 3xTF32 load reads (row g, col t) pairs, so a K-contiguous stride is 4
// mod 32 and an M- or N-contiguous one 8 mod 32; a bf16 load reads (2t,
// 2t+1) pairs, as two floats of an M-major row 4 mod 16 apart.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <stdint.h>

namespace mma {

constexpr int kBN = 128;      // output columns of a CTA
constexpr int kBK = 32;       // K slice of a stage
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kMinBlocks = 2;  // CTAs an SM

// Flags of Tile and Warp (or-ed): operand layouts, and the arithmetic.
constexpr int kAMajorM = 1;  // A tile M-major, [kBK][BM + pad]
constexpr int kBMajorK = 2;  // B tile K-major, [kBN][kBK + pad]
constexpr int kAExact = 4;   // A values exact in TF32 (bf16): no lo part
constexpr int kPromote = 8;  // each k step's products added to acc in f32

template <int BM, bool kBf16 = false, int kFlags = 0>
struct Tile {
  static_assert(BM == 16 || BM == 32 || BM == 64 || BM == 128, "BM: 16 .. 128");
  static constexpr bool kAT = kFlags & kAMajorM, kBT = kFlags & kBMajorK;
  static_assert(!(kBf16 && kBT), "the bf16 step reads B N-major only");
  static constexpr int kWM = BM >= 32 ? 2 : 1;  // warps along M
  static constexpr int kWN = 8 / kWM;           // warps along N
  static constexpr int kWarpM = BM / kWM;
  static constexpr int kWarpN = kBN / kWN;
  static constexpr int kMT = kWarpM / 16;       // m16 tiles of a warp
  static constexpr int kNT = kWarpN / 8;        // n8 tiles of a warp
  // row strides (floats) and tile sizes of A and B
  static constexpr int kAS = kAT ? BM + (kBf16 ? 4 : 8) : kBK + 4;
  static constexpr int kBS = kBT ? kBK + 4 : kBN + 8;
  static constexpr int kAF = (kAT ? kBK : BM) * kAS;
  static constexpr int kBF = (kBT ? kBN : kBK) * kBS;
  static constexpr int kStageF = kAF + kBF;
  static constexpr int kSmem = kStages * kStageF * (int)sizeof(float);
};

// x split for 3xTF32: hi = tf32(x), rounded to nearest (ties away from
// zero, as cvt.rna.tf32.f32, in two integer operations), and lo = x - hi,
// exact in f32 and passed whole: the tensor core reads the top 19 bits of
// a TF32 operand, so lo enters truncated to TF32, 2^-21 of x or less.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b, m16n8k8, TF32 operands, f32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// d += a b, m16n8k16, bf16 operands, f32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// two values that are bf16 already, packed (lo in the low half)
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 8 values of a staged chunk (16 bytes of bf16, 8 of int8 / fp8), as f32
// (exact conversions; int8 by a byte permute and one add, without I2F).
__device__ __forceinline__ void cvt8(const uint4& raw, float (&w)[8], __nv_bfloat16) {
  const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h2[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void cvt8(const uint4& raw, float (&w)[8], int8_t) {
  const uint32_t words[2] = {raw.x ^ 0x80808080u, raw.y ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 8; ++i)
    w[i] = __uint_as_float(__byte_perm(words[i / 4], 0x4B000000u, 0x7440 | (i % 4))) -
           8388736.0f;
}
__device__ __forceinline__ void cvt8(const uint4& raw, float (&w)[8], __nv_fp8_e4m3) {
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

// 8 contiguous elements from global memory (16 bytes of bf16, 8 of an
// 8-bit type), raw.
template <typename X>
__device__ __forceinline__ uint4 ld8(const X* p) {
  if constexpr (sizeof(X) == 2) {
    return *reinterpret_cast<const uint4*>(p);
  } else {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    return make_uint4(v.x, v.y, 0u, 0u);
  }
}

// 8 f32 values into a staged tile (16-byte aligned)
__device__ __forceinline__ void st8(float* p, const float (&v)[8]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  *reinterpret_cast<float4*>(p + 4) = make_float4(v[4], v[5], v[6], v[7]);
}

// A warp's accumulators over the CTA tile and the mainloop step over one
// stage. Accumulator (mt, nt, i) holds output row row(mt, i >> 1) and
// column col(nt) + (i & 1) of the tile. kFlags: Tile's layouts, kAExact,
// kPromote (see the note at the top).
template <int BM, bool kBf16, int kFlags = 0>
struct Warp {
  using Tl = Tile<BM, kBf16, kFlags>;
  static constexpr bool kAExactF = kFlags & kAExact, kPromoteF = kFlags & kPromote;
  float acc[Tl::kMT][Tl::kNT][4];
  int wm, wn, g, t;

  __device__ __forceinline__ Warp() {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    wm = warp / Tl::kWN;
    wn = warp % Tl::kWN;
    g = lane >> 2;
    t = lane & 3;
  }
  __device__ __forceinline__ int row(int mt, int half) const {
    return wm * Tl::kWarpM + mt * 16 + g + 8 * half;
  }
  __device__ __forceinline__ int col(int nt) const {
    return wn * Tl::kWarpN + nt * 8 + 2 * t;
  }

  // acc += As Bs over the stage's kBK
  __device__ __forceinline__ void step(const float* __restrict__ as,
                                       const float* __restrict__ bs) {
    constexpr int AS = Tl::kAS, BS = Tl::kBS;
    if constexpr (!kBf16) {
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 8) {
        uint32_t ah[Tl::kMT][4], al[Tl::kMT][4], bh[Tl::kNT][2], bl[Tl::kNT][2];
#pragma unroll
        for (int mt = 0; mt < Tl::kMT; ++mt) {
          // fragment (g, t), (g + 8, t), (g, t + 4), (g + 8, t + 4)
          if constexpr (!Tl::kAT && !kAExactF) {
            const float* p = as + row(mt, 0) * AS + ks + t;
            split(p[0], ah[mt][0], al[mt][0]);
            split(p[8 * AS], ah[mt][1], al[mt][1]);
            split(p[4], ah[mt][2], al[mt][2]);
            split(p[8 * AS + 4], ah[mt][3], al[mt][3]);
          } else {
            float v[4];
            if constexpr (!Tl::kAT) {
              const float* p = as + row(mt, 0) * AS + ks + t;
              v[0] = p[0], v[1] = p[8 * AS], v[2] = p[4], v[3] = p[8 * AS + 4];
            } else {
              const float* p = as + (ks + t) * AS + row(mt, 0);
              v[0] = p[0], v[1] = p[8], v[2] = p[4 * AS], v[3] = p[4 * AS + 8];
            }
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              if constexpr (kAExactF) ah[mt][i] = __float_as_uint(v[i]);
              else split(v[i], ah[mt][i], al[mt][i]);
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < Tl::kNT; ++nt) {
          // fragment (k t, n g), (k t + 4, n g)
          if constexpr (!Tl::kBT) {
            const float* p = bs + (ks + t) * BS + wn * Tl::kWarpN + nt * 8 + g;
            split(p[0], bh[nt][0], bl[nt][0]);
            split(p[4 * BS], bh[nt][1], bl[nt][1]);
          } else {
            const float* p = bs + (wn * Tl::kWarpN + nt * 8 + g) * BS + ks + t;
            split(p[0], bh[nt][0], bl[nt][0]);
            split(p[4], bh[nt][1], bl[nt][1]);
          }
        }
#pragma unroll
        for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < Tl::kNT; ++nt) {
            if constexpr (kPromoteF) {
              float tmp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              if constexpr (!kAExactF) mma_tf32(tmp, al[mt], bh[nt]);
              mma_tf32(tmp, ah[mt], bl[nt]);
              mma_tf32(tmp, ah[mt], bh[nt]);
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[mt][nt][i] += tmp[i];
            } else {
              if constexpr (!kAExactF) mma_tf32(acc[mt][nt], al[mt], bh[nt]);
              mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
              mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
            }
          }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        uint32_t a[Tl::kMT][4], b[Tl::kNT][2];
#pragma unroll
        for (int mt = 0; mt < Tl::kMT; ++mt) {
          // pairs (g, 2t..2t+1), (g + 8, ..), (g, 2t+8..2t+9), (g + 8, ..)
          if constexpr (!Tl::kAT) {
            const float* p = as + row(mt, 0) * AS + ks + 2 * t;
            a[mt][0] = pack_bf16(p[0], p[1]);
            a[mt][1] = pack_bf16(p[8 * AS], p[8 * AS + 1]);
            a[mt][2] = pack_bf16(p[8], p[9]);
            a[mt][3] = pack_bf16(p[8 * AS + 8], p[8 * AS + 9]);
          } else {
            const float* p = as + (ks + 2 * t) * AS + row(mt, 0);
            a[mt][0] = pack_bf16(p[0], p[AS]);
            a[mt][1] = pack_bf16(p[8], p[AS + 8]);
            a[mt][2] = pack_bf16(p[8 * AS], p[9 * AS]);
            a[mt][3] = pack_bf16(p[8 * AS + 8], p[9 * AS + 8]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < Tl::kNT; ++nt) {
          // pairs (k 2t..2t+1, n g), (k 2t+8..2t+9, n g)
          const float* p = bs + (ks + 2 * t) * BS + wn * Tl::kWarpN + nt * 8 + g;
          b[nt][0] = pack_bf16(p[0], p[BS]);
          b[nt][1] = pack_bf16(p[8 * BS], p[9 * BS]);
        }
#pragma unroll
        for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < Tl::kNT; ++nt) {
            if constexpr (kPromoteF) {
              float tmp[4] = {0.0f, 0.0f, 0.0f, 0.0f};
              mma_bf16(tmp, a[mt], b[nt]);
#pragma unroll
              for (int i = 0; i < 4; ++i) acc[mt][nt][i] += tmp[i];
            } else {
              mma_bf16(acc[mt][nt], a[mt], b[nt]);
            }
          }
      }
    }
  }
};

}  // namespace mma
