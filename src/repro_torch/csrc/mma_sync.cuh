// The f32 tensor-core mainloop of the sorted-layout GEMMs, for Hopper
// (sm_90a): mma.sync products over f32 tiles in shared memory, either
// 3xTF32 (f32 operands, and 8-bit weights dequantized to f32 as they are
// staged) or one bf16 pass (bf16 operands). esffn.cu's 2-MLP kernel runs
// on it; it takes nothing from that kernel, so other sorted-layout GEMMs
// (esmm's f32 and 8-bit routes) can run on it too.
//
// Why mma.sync and not wgmma: TF32 wgmma reads both operands K-major from
// shared memory, and the expert weights W (E, K, N) are N-major as stored.
// mma.sync fragments are loaded by hand, so a padded N-major tile serves
// as it is and W is never transposed.
//
// 3xTF32: each f32 operand x is split as hi = tf32(x) (round to nearest)
// and lo = x - hi (which the tensor core reads truncated to TF32), and a
// product sums lo*hi + hi*lo + hi*hi in f32 (lo*lo, about 2^-22 of the
// product, is left out). The f32 result then lands within a few f32 ulps
// of an f32 FMA sum, where one TF32 pass would be off by about 2^-11
// relative: 3 x the tensor work for f32 accuracy. The split is three
// integer and float operations a value; two cvt.rna.tf32.f32 a value took
// more issue slots than the products hide.
//
// Two CTAs share an SM (at most 128 registers a thread; the 128-row tiles
// spill a few dozen bytes a thread), so one's loads and epilogue overlap
// the other's products.
//
// The tile: a CTA of kThreads = 256 (8 warps) computes BM x kBN = BM x 128
// outputs; A is BM rows of a kBK = 32 deep K slice ([BM][kBK + 4] f32) and
// B is the slice's 32 rows of W ([kBK][kBN + 8] f32), kStages of each in a
// ring. The row pads put the 8 x 4 fragment loads of a warp on 32
// distinct banks. The warps lie kWM x kWN over the tile; a warp owns
// kMT x kNT m16n8 accumulator tiles.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma {

constexpr int kBN = 128;      // output columns of a CTA
constexpr int kBK = 32;       // K slice of a stage
constexpr int kThreads = 256;
constexpr int kStages = 3;
constexpr int kMinBlocks = 2;  // CTAs an SM

template <int BM>
struct Tile {
  static_assert(BM == 16 || BM == 32 || BM == 64 || BM == 128, "BM: 16 .. 128");
  static constexpr int kWM = BM >= 32 ? 2 : 1;  // warps along M
  static constexpr int kWN = 8 / kWM;           // warps along N
  static constexpr int kWarpM = BM / kWM;
  static constexpr int kWarpN = kBN / kWN;
  static constexpr int kMT = kWarpM / 16;       // m16 tiles of a warp
  static constexpr int kNT = kWarpN / 8;        // n8 tiles of a warp
  static constexpr int kAS = kBK + 4;           // A row stride (floats)
  static constexpr int kBS = kBN + 8;           // B row stride (floats)
  static constexpr int kAF = BM * kAS;
  static constexpr int kStageF = kAF + kBK * kBS;
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

// A warp's accumulators over the CTA tile and the mainloop step over one
// stage. Accumulator (mt, nt, i) holds output row row(mt, i >> 1) and
// column col(nt) + (i & 1) of the tile.
template <int BM, bool kBf16>
struct Warp {
  using Tl = Tile<BM>;
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
          const float* p = as + row(mt, 0) * AS + ks + t;
          split(p[0], ah[mt][0], al[mt][0]);
          split(p[8 * AS], ah[mt][1], al[mt][1]);
          split(p[4], ah[mt][2], al[mt][2]);
          split(p[8 * AS + 4], ah[mt][3], al[mt][3]);
        }
#pragma unroll
        for (int nt = 0; nt < Tl::kNT; ++nt) {
          const float* p = bs + (ks + t) * BS + wn * Tl::kWarpN + nt * 8 + g;
          split(p[0], bh[nt][0], bl[nt][0]);
          split(p[4 * BS], bh[nt][1], bl[nt][1]);
        }
#pragma unroll
        for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < Tl::kNT; ++nt) {
            mma_tf32(acc[mt][nt], al[mt], bh[nt]);
            mma_tf32(acc[mt][nt], ah[mt], bl[nt]);
            mma_tf32(acc[mt][nt], ah[mt], bh[nt]);
          }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < kBK; ks += 16) {
        uint32_t a[Tl::kMT][4], b[Tl::kNT][2];
#pragma unroll
        for (int mt = 0; mt < Tl::kMT; ++mt) {
          const float* p = as + row(mt, 0) * AS + ks + 2 * t;
          a[mt][0] = pack_bf16(p[0], p[1]);
          a[mt][1] = pack_bf16(p[8 * AS], p[8 * AS + 1]);
          a[mt][2] = pack_bf16(p[8], p[9]);
          a[mt][3] = pack_bf16(p[8 * AS + 8], p[8 * AS + 9]);
        }
#pragma unroll
        for (int nt = 0; nt < Tl::kNT; ++nt) {
          const float* p = bs + (ks + 2 * t) * BS + wn * Tl::kWarpN + nt * 8 + g;
          b[nt][0] = pack_bf16(p[0], p[BS]);
          b[nt][1] = pack_bf16(p[8 * BS], p[9 * BS]);
        }
#pragma unroll
        for (int mt = 0; mt < Tl::kMT; ++mt)
#pragma unroll
          for (int nt = 0; nt < Tl::kNT; ++nt) mma_bf16(acc[mt][nt], a[mt], b[nt]);
      }
    }
  }
};

}  // namespace mma
