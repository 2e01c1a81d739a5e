// The decode schedule of the GPTQ-INT4 products, shared by K1
// (csrc/int4_matmul.cu) and the fused MLP M1 (csrc/int4_mlp.cu).
//
// y^T = W^T x^T over a block of kSub 128-column sub-blocks of W and BM rows
// of x, for the K tiles [t0, t1) of one split: the converted weight is
// mma.sync's A (16 columns of each sub-block a warp, 8 warps), the x rows
// its n8 tiles. Weights enter the tensor cores as the exact integers
// q - zero - 1 (the magic-number conversion below, zero points from
// qzeros), each group's product is accumulated in fp32 and folded into the
// total with the column's scale. 16-byte cp.async copies of the words, of
// each tile's group parameters (scales and zero-point words) and of the x
// tile go into a ring of kStages stages. The tile's k order is permuted so
// that a thread reads 4 words a tile and sub-block and converts a pair of
// nibbles with one shift and mask.
//
// Sub-block u covers the W columns n0 + u * sub_stride + [0, 128), of which
// those below lim + u * lim_step exist (K1: sub-blocks side by side, lim =
// N; M1's gate/up block: the gate columns i0 + [0, 128) below I and the
// matching up columns I + i0 + [0, 128) below 2I).

#pragma once

#include <type_traits>

#include "hopper.cuh"

// Internal linkage, as hopper.cuh: several libraries built from this header
// may live in one process.
namespace {
namespace int4dec {

using hopper::smem_u32;

constexpr int kBK = 64;                 // K rows a tile (inside one group)
constexpr int kWordRows = kBK / 8;      // word rows a tile
constexpr int kBN = 128;                // W columns a sub-block
constexpr int kThreads = 256;           // 8 warps of 16 columns
// a sub-block's group parameters in a stage: its scales and packed zero
// points
constexpr int kScBytes = kBN * 4;
constexpr int kZeroBytes = kBN / 8 * 4;
constexpr int kParamBytes = kScBytes + kZeroBytes;

// The tensor-core operand type of an x type and the magic of its nibble
// conversion (the mantissa of 128 in bf16, of 1024 in fp16, in both halves)
template <typename XT>
struct Op {
  using MT = __nv_bfloat16;
  static constexpr bool kSplit = false;     // fp32 x: hi and lo terms
  static constexpr uint32_t kMagic = 0x4300u;
};
template <>
struct Op<__half> {
  using MT = __half;
  static constexpr bool kSplit = false;
  static constexpr uint32_t kMagic = 0x6400u;
};
template <>
struct Op<float> {
  using MT = __nv_bfloat16;
  static constexpr bool kSplit = true;
  static constexpr uint32_t kMagic = 0x4300u;
};

// The packed pair (magic + zero + 1) that turns (magic + q) into q - zero - 1,
// for column `col` of a sub-block from its staged zero-point words
template <typename XT>
__device__ __forceinline__ uint32_t zero_pair(const uint32_t* zeros, int col) {
  const uint32_t z =
      Op<XT>::kMagic + ((zeros[col / 8] >> (4 * (col % 8))) & 0xFu) + 1u;
  return z | (z << 16);
}

// r (two magic + q halves) minus zpair, in MT: q - zero - 1 each, exactly
template <typename MT>
__device__ __forceinline__ uint32_t sub_pair(uint32_t r, uint32_t zpair) {
  uint32_t out;
  if constexpr (Op<MT>::kMagic == 0x6400u) {
    const __half2 d = __hsub2(*reinterpret_cast<const __half2*>(&r),
                              *reinterpret_cast<const __half2*>(&zpair));
    out = *reinterpret_cast<const uint32_t*>(&d);
  } else {
    const __nv_bfloat162 d =
        __hsub2(*reinterpret_cast<const __nv_bfloat162*>(&r),
                *reinterpret_cast<const __nv_bfloat162*>(&zpair));
    out = *reinterpret_cast<const uint32_t*>(&d);
  }
  return out;
}

// Nibbles s and s + 4 of w (k rows s and s + 4 of the word) as two
// operands of type MT, q - zero - 1 each, exactly: one shift and one mask
template <typename MT>
__device__ __forceinline__ uint32_t nib_pair4(uint32_t w, int s,
                                              uint32_t zpair, uint32_t magic2) {
  return sub_pair<MT>(((w >> (4 * s)) & 0x000F000Fu) | magic2, zpair);
}

template <typename MT>
__device__ __forceinline__ void mma16816(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  if constexpr (Op<MT>::kMagic == 0x6400u) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  } else {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// an fp32 pair as two bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split_pair(float2 f, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(f.x, f.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = bf16_pair(f.x - __low2float(h), f.y - __high2float(h));
}

template <typename XT>
__device__ __forceinline__ XT from_float(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}
template <>
__device__ __forceinline__ __half from_float<__half>(float v) {
  return __float2half(v);
}
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// Copies group `grp`'s scales and zero-point words of the 128 columns
// [n0, n0 + 128) (row stride N) to dst_sc (512 bytes) and dst_zero (64
// bytes), as thread `lane` of 32; columns at or past `lim` read as 0.
__device__ __forceinline__ void copy_group_params(unsigned char* dst_sc,
                                                  unsigned char* dst_zero,
                                                  const float* scales,
                                                  const int32_t* qzeros,
                                                  int N, int n0, int lim,
                                                  int grp, int lane) {
  const int n = n0 + 4 * lane;
  const bool ok = n < lim;
  cp_async_16(dst_sc + 16 * lane, ok ? scales + (size_t)grp * N + n : scales,
              ok ? 16 : 0);
  if (lane < kBN / 8) {
    const int w = n0 / 8 + lane;
    const bool okz = 8 * w < lim;
    cp_async_4(dst_zero + 4 * lane,
               okz ? qzeros + (size_t)grp * (N / 8) + w : qzeros, okz ? 4 : 0);
  }
}

// The columns a block's sub-blocks cover (see the head of this file)
struct Cols {
  int n0, sub_stride, lim, lim_step;
};

// a stage of a block of kSub x 128 columns: words (rows padded by 4 words:
// a thread's four word reads are free of bank conflicts), the group
// parameters of each sub-block (scales, then zero points), the x tile
template <typename XT, int BM, int kSub, int kStages>
struct Layout {
  static constexpr int kCols = kSub * kBN;
  static constexpr int kWLd = kCols + 4;
  static constexpr int kParamOff = kWordRows * kWLd * 4;
  static constexpr int kXLd = kBK + 16 / (int)sizeof(XT);   // padded x row
  static constexpr int kXBytes = BM * kXLd * (int)sizeof(XT);
  static constexpr int kXOff = kParamOff + kSub * kParamBytes;
  static constexpr int kStage = kXOff + kXBytes;
  static constexpr int kSmem = kStages * kStage;
};

// no wait before the x tiles
struct NoWait {
  __device__ __forceinline__ void operator()() const {}
};

// tot[u][j][e] = sum over the K tiles [t0, t1) of x[rows, k] W[k, col]:
// D rows are W columns (c_a = warp * 16 + lane / 4 and c_a + 8 of sub-block
// u), D columns x rows 8j + 2 (lane % 4) + (e & 1). x holds `rows` rows
// (row stride ldx; later rows read as 0); W is [K/8, N] words with scales
// [K/gs, N] and qzeros [K/gs, N/8]. Every thread of the block calls it; it
// leaves no copy in flight and ends with the ring free for reuse after a
// __syncthreads. With a wait_x, every thread calls it after the first
// stages' words and group parameters are in flight and before any x copy
// starts (M1's down items wait there for their slices of `a`); without one,
// each first stage's words and x tile are one commit group (on an H100,
// K1's decode products ran 3-5% faster so than with all the words first).
template <typename XT, int BM, int kSub, int kStages, typename WaitX = NoWait>
__device__ __forceinline__ void decode_tiles(
    unsigned char* smem, const XT* __restrict__ x, int rows, int ldx,
    const int32_t* __restrict__ qweight, const float* __restrict__ scales,
    const int32_t* __restrict__ qzeros, int N, Cols cols, int gs, int t0,
    int t1, float (&tot)[kSub][BM / 8][4], WaitX wait_x = WaitX()) {
  using O = Op<XT>;
  using MT = typename O::MT;
  using L = Layout<XT, BM, kSub, kStages>;
  constexpr int kNT = BM / 8;                       // n8 tiles of x rows
  constexpr int kXChunks = kBK * (int)sizeof(XT) / 16;   // copies an x row
  constexpr int kWChunks = kWordRows * L::kCols / 4;     // copies of words
  constexpr uint32_t kMagic2 = O::kMagic | (O::kMagic << 16);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  // sub-block u: A rows g and g + 8 are columns u * 128 + warp * 16 + g, + 8
  const int c_a = warp * 16 + g;

  // tile t into stage st: its words and its group's scales and zero
  // points, then its x tile (rows past `rows` zero-filled)
  auto load_weights = [&](int t, int st) {
    unsigned char* sb = smem + st * L::kStage;
#pragma unroll
    for (int k = 0; k < kWChunks / kThreads; ++k) {
      const int i = tid + k * kThreads;
      const int r = i / (L::kCols / 4);             // word row
      const int c = i % (L::kCols / 4);             // 4 columns a copy
      const int u = c / (kBN / 4);
      const int n = cols.n0 + u * cols.sub_stride + 4 * (c % (kBN / 4));
      const bool ok = n < cols.lim + u * cols.lim_step;
      const int32_t* src =
          ok ? qweight + (size_t)(t * kWordRows + r) * N + n : qweight;
      cp_async_16(sb + (r * L::kWLd + 4 * c) * 4, src, ok ? 16 : 0);
    }
    if (warp < kSub)
      copy_group_params(sb + L::kParamOff + warp * kScBytes,
                        sb + L::kParamOff + kSub * kScBytes + warp * kZeroBytes,
                        scales, qzeros, N, cols.n0 + warp * cols.sub_stride,
                        cols.lim + warp * cols.lim_step, t * kBK / gs, lane);
  };
  auto load_x = [&](int t, int st) {
    unsigned char* sb = smem + st * L::kStage;
    for (int i = tid; i < BM * kXChunks; i += kThreads) {
      const int r = i / kXChunks;
      const int c = i % kXChunks;
      const bool ok = r < rows;
      const XT* src =
          ok ? x + (size_t)r * ldx + t * kBK + c * (16 / (int)sizeof(XT)) : x;
      cp_async_16(sb + L::kXOff + (r * L::kXLd) * (int)sizeof(XT) + c * 16,
                  src, ok ? 16 : 0);
    }
  };

  if constexpr (std::is_same_v<WaitX, NoWait>) {
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (t0 + i < t1) {
        load_weights(t0 + i, i);
        load_x(t0 + i, i);
      }
      cp_async_commit();
    }
  } else {
    // every first stage's weights, then the x tiles, one commit group a
    // stage (the first group also holds all the weights)
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i)
      if (t0 + i < t1) load_weights(t0 + i, i);
    wait_x();
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (t0 + i < t1) load_x(t0 + i, i);
      cp_async_commit();
    }
  }

  float acc[kSub][kNT][4];
#pragma unroll
  for (int u = 0; u < kSub; ++u)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[u][j][e] = tot[u][j][e] = 0.f;
  float sc[kSub][2] = {};             // the scales of the tiles in acc
  auto fold = [&]() {
#pragma unroll
    for (int u = 0; u < kSub; ++u)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          tot[u][j][e] = fmaf(acc[u][j][e], sc[u][e / 2], tot[u][j][e]);
          acc[u][j][e] = 0.f;
        }
  };

  int grp = t0 * kBK / gs;
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();                  // tile t landed; tile t - 1 consumed
    {
      const int tn = t + kStages - 1;
      if (tn < t1) {
        load_weights(tn, (tn - t0) % kStages);
        load_x(tn, (tn - t0) % kStages);
      }
      cp_async_commit();
    }
    const unsigned char* sb = smem + ((t - t0) % kStages) * L::kStage;
    const int gt = t * kBK / gs;
    if (gt != grp) {                  // the group of tile t - 1 is complete
      fold();
      grp = gt;
    }
    // The tile's k order is permuted (the same in A and B; the product sums
    // over k): quad q takes k 16q .. 16q + 15, word rows 2q and 2q + 1, and
    // step s pairs nibbles s and s + 4 of each, k = 16q + 8h + s (+ 4)
    // (h = 0 for the A registers 0, 1 and B's b0; 1 for 2, 3 and b1). So a
    // thread reads four words a tile and sub-block, converts a pair with
    // one shift and mask, and reads its x values as 32 contiguous bytes of
    // a row.
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(sb);
    uint32_t af[kSub][kBK / 16][4];
#pragma unroll
    for (int u = 0; u < kSub; ++u) {
      // this tile's group parameters, in registers (the stage of tile t - 1
      // is already being refilled)
      const float* scs =
          reinterpret_cast<const float*>(sb + L::kParamOff + u * kScBytes);
      const uint32_t* zs = reinterpret_cast<const uint32_t*>(
          sb + L::kParamOff + kSub * kScBytes + u * kZeroBytes);
      sc[u][0] = scs[c_a];
      sc[u][1] = scs[c_a + 8];
      const uint32_t zp0 = zero_pair<XT>(zs, c_a);
      const uint32_t zp1 = zero_pair<XT>(zs, c_a + 8);
      const int c = u * kBN + c_a;
      const uint32_t w0a = ws[(2 * q) * L::kWLd + c];
      const uint32_t w1a = ws[(2 * q + 1) * L::kWLd + c];
      const uint32_t w0b = ws[(2 * q) * L::kWLd + c + 8];
      const uint32_t w1b = ws[(2 * q + 1) * L::kWLd + c + 8];
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s) {
        af[u][s][0] = nib_pair4<MT>(w0a, s, zp0, kMagic2);
        af[u][s][1] = nib_pair4<MT>(w0b, s, zp1, kMagic2);
        af[u][s][2] = nib_pair4<MT>(w1a, s, zp0, kMagic2);
        af[u][s][3] = nib_pair4<MT>(w1b, s, zp1, kMagic2);
      }
    }
    const XT* xs = reinterpret_cast<const XT*>(sb + L::kXOff);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      // x row 8j + g, k 16q .. 16q + 15: 8 pairs (bf16 / fp16) or 16 floats
      constexpr int kXWords = O::kSplit ? 16 : 8;
      uint32_t xw[kXWords];
      const uint4* src = reinterpret_cast<const uint4*>(
          xs + (8 * j + g) * L::kXLd + 16 * q);
#pragma unroll
      for (int c = 0; c < kXWords / 4; ++c) {
        const uint4 v = src[c];
        xw[4 * c] = v.x;
        xw[4 * c + 1] = v.y;
        xw[4 * c + 2] = v.z;
        xw[4 * c + 3] = v.w;
      }
#pragma unroll
      for (int s = 0; s < kBK / 16; ++s) {
        if constexpr (O::kSplit) {
          uint32_t h0, l0, h1, l1;
          split_pair(make_float2(__uint_as_float(xw[s]),
                                 __uint_as_float(xw[s + 4])), h0, l0);
          split_pair(make_float2(__uint_as_float(xw[8 + s]),
                                 __uint_as_float(xw[12 + s])), h1, l1);
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            mma16816<MT>(acc[u][j], af[u][s], h0, h1);
            mma16816<MT>(acc[u][j], af[u][s], l0, l1);
          }
        } else {
          // elements s and s + 4 (b0), 8 + s and 12 + s (b1)
          const uint32_t sel = (s & 1) ? 0x7632u : 0x5410u;
          const uint32_t b0 = __byte_perm(xw[s / 2], xw[2 + s / 2], sel);
          const uint32_t b1 = __byte_perm(xw[4 + s / 2], xw[6 + s / 2], sel);
#pragma unroll
          for (int u = 0; u < kSub; ++u) mma16816<MT>(acc[u][j], af[u][s], b0, b1);
        }
      }
    }
  }
  cp_async_wait<0>();
  fold();
}

}  // namespace int4dec
}  // namespace
