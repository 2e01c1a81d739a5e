// GPTQ INT4 dequant-GEMM for sm_90a (kernel K1):
//   y = x @ W,  W[k, n] = scale[g, n] * (q[k, n] - zero[g, n] - 1),  g = k / gs
//
// Replaces: the JAX package's ops/pallas/int4_matmul.py
//   int4_matmul_s4_stacked (`_kernel_s4_stacked`, pallas_call at :453),
//   int4_matmul_s4         (`_kernel_s4`,         pallas_call at :572),
//   int4_matmul            (`_kernel`,            pallas_call at :637).
// The three read other TPU layouts of the same weight (native s4, blocked
// scales, the packed int32 words); on the GPU the GPTQ packing is the
// natural one, so one source serves all three. A layer of a stacked weight
// is a pointer offset (the wrapper passes the layer's view).
//
// Inputs, as the loader stores them: x [M, K] in bf16, fp16 or fp32 (already
// gathered by the act-order perm); qweight [K/8, N] int32 (eight 4-bit rows
// a word, little-endian), qzeros [K/gs, N/8] int32 (eight 4-bit zero points
// a word, stored zero - 1), scales [K/gs, N] f32. Output y [M, N] in x's
// dtype. Nibbles are read unsigned.
//
// The group-dot form (the JAX kernels' `y = sum_g sc_g (x_g . q_g) - ...`):
// the weight enters the tensor cores as the exact integer q - zero - 1, in
// [-16, 15], which bf16 and fp16 hold exactly; each group's product is
// accumulated in fp32 and folded into the total with the column's scale.
// The zero point is subtracted from the integer, so no x-sum term is
// needed: the cancellation JAX's s4 form keeps small does not arise. The
// conversion is the magic-number trick: a nibble or'ed into the mantissa of
// 128 (bf16 0x4300) or 1024 (fp16 0x6400) is 128 + q exactly, and one
// packed subtraction of (128 + zero + 1) gives q - zero - 1 for two
// elements. Operand types by x: bf16 x on bf16 products, fp16 x on fp16
// products, fp32 x split into two bf16 terms (hi = bf16(x), lo = bf16(x -
// hi)), both through the tensor cores, so every route computes x . W to
// fp32 accuracy up to summation order (JAX's packed kernel computes in f32).
//
// What bounds it on an H100: at decode (M <= 64 rows) the product does 2 M
// flops per weight nibble, far below the 295 flops a byte the card needs to
// leave the memory bound: it is bound by the packed weight bytes at 3.35
// TB/s. At prefill (M in the thousands) it is bound by operations (989
// TFLOP/s bf16, reached only through wgmma).
//
// Two schedules, picked from M (and fp32 x, which always takes the first):
//   Decode (M <= 64): the operands are swapped, y^T = W^T x^T, so the
//     converted weight is mma.sync's A (16 columns of W a warp and 128-
//     column sub-block, 8 warps; two sub-blocks a block up to 32 rows, so
//     that each x fragment serves two A fragments) and the x rows are its
//     n8 tiles. The tile's k order is permuted (`k1_decode_kernel`) so that
//     a thread reads 4 words a tile and sub-block. 16-byte cp.async
//     copies of the words (4 columns x 8 k-rows a copy), of the tile's group
//     parameters (scales and zero points: read in the loop from global
//     memory they stalled every group on a DRAM latency) and of the x tile
//     go into a ring of kStages stages (4 KB of words a stage, ~20 KB a
//     block in flight, two or three blocks an SM). K is split over blocks
//     by a plan from (N, K) alone (the wrapper's `split_plan`), never M,
//     so a row's result is the same bits at any batch size; each split
//     writes fp32 partials to a fixed per-device workspace and the last
//     block to arrive at the column block's counter adds them in split
//     order, writes y and resets the counter: one launch a product.
//     fp32 x past 64 rows runs this schedule over 64-row tiles, unsplit.
//   Prefill (M > 64, bf16 or fp16): wgmma, 128 x-rows by 128 columns a
//     block (one pass over the weight tile for every 128 rows), the blocks
//     ordered row tiles first so that a weight column block is read from
//     device memory once and x stays in L2. A producer warpgroup keeps a
//     ring of stages full by TMA (x tiles [128][64], 128-byte swizzled, and
//     the words [8][128]; one warp copies the group parameters by cp.async,
//     arriving on the same barrier) with full / empty mbarriers; two consumer
//     warpgroups each convert 64 columns of words into wgmma's register A
//     operand (y^T = W^T x^T, as CUTLASS's mixed-input GEMMs do) and run
//     m64n128k16 with B = the x tile (K-major). The A registers are double
//     buffered across tiles so that one tile's conversion runs while the
//     previous tile's products are in flight; at a group's end the products
//     are drained and folded into the total with the scales.
// Not yet: a persistent grid, a TMA store of y, clusters with multicast.

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBK = 64;                 // K rows a tile (inside one group)
constexpr int kWordRows = kBK / 8;      // word rows a tile
constexpr int kBN = 128;                // W columns a block (both schedules)
constexpr int kMaxSplits = 16;
constexpr int kDecodeRows = 64;         // rows the decode schedule takes

// decode schedule
constexpr int kDecThreads = 256;        // 8 warps of 16 columns
constexpr int kDecStages = 6;
constexpr int kWBytes = kWordRows * kBN * 4;    // a stage's words
// a stage also holds its tile's group parameters: the scales and the
// packed zero points of the block's 128 columns
constexpr int kScBytes = kBN * 4;
constexpr int kZeroBytes = kBN / 8 * 4;
constexpr int kParamBytes = kScBytes + kZeroBytes;

// prefill schedule
constexpr int kPreThreads = 384;        // two consumer warpgroups + producer
constexpr int kPreBM = 128;             // x rows a block (wgmma's N)
constexpr int kPreStages = 8;
constexpr int kXTile = kPreBM * kBK * 2;        // [128 rows][64] 16-bit
// x tile, words, group parameters; 1024-aligned for the x tiles' swizzle
constexpr int kPreStage = (kXTile + kWBytes + kParamBytes + 1023) / 1024 * 1024;
constexpr int kPreSmem = kPreStages * kPreStage + 1024;

enum XType { kXBf16 = 0, kXFp16 = 1, kXFp32 = 2 };

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
// for column `col` of a block from its staged zero-point words
template <typename XT>
__device__ __forceinline__ uint32_t zero_pair(const uint32_t* zeros, int col) {
  const uint32_t z =
      Op<XT>::kMagic + ((zeros[col / 8] >> (4 * (col % 8))) & 0xFu) + 1u;
  return z | (z << 16);
}

// Nibbles `shift / 4` and `shift / 4 + 1` of w as two operands of type MT,
// q - zero - 1 each, exactly
template <typename MT>
__device__ __forceinline__ uint32_t nib_pair(uint32_t w, int shift,
                                             uint32_t zpair, uint32_t magic2) {
  const uint32_t t = w >> shift;
  const uint32_t r = (t & 0xFu) | ((t & 0xF0u) << 12) | magic2;
  uint32_t out;
  if constexpr (sizeof(MT) == 2 && Op<MT>::kMagic == 0x6400u) {
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
  const uint32_t r = ((w >> (4 * s)) & 0x000F000Fu) | magic2;
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

// the barrier sees one arrival when this thread's earlier cp.async copies
// have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}

// Copies group `grp`'s scales and zero-point words of the 128 columns
// [n0, n0 + 128) to dst_sc (512 bytes) and dst_zero (64 bytes), as thread
// `lane` of 32 (out-of-range columns read as 0).
__device__ __forceinline__ void copy_group_params(unsigned char* dst_sc,
                                                  unsigned char* dst_zero,
                                                  const float* scales,
                                                  const int32_t* qzeros,
                                                  int N, int n0, int grp,
                                                  int lane) {
  const int n = n0 + 4 * lane;
  const bool ok = n < N;
  cp_async_16(dst_sc + 16 * lane, ok ? scales + (size_t)grp * N + n : scales,
              ok ? 16 : 0);
  if (lane < kBN / 8) {
    const int w = n0 / 8 + lane;
    const bool okz = w < N / 8;
    cp_async_4(dst_zero + 4 * lane,
               okz ? qzeros + (size_t)grp * (N / 8) + w : qzeros, okz ? 4 : 0);
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

struct Args {
  const void* x;                 // [M, K] in XT
  const int32_t* qweight;        // [K/8, N]
  const int32_t* qzeros;         // [K/gs, N/8]
  const float* scales;           // [K/gs, N]
  void* y;                       // [M, N] in XT
  float* partial;                // [splits, M, N] (splits > 1)
  unsigned int* arrivals;        // [ceil(N / 128)], all zero
  int M, N, K, gs, splits;
};

// --- decode schedule ----------------------------------------------------------

// a decode stage of a block of kSub x 128 columns: words (rows padded by 4
// words: a thread's four word reads are free of bank conflicts), the group
// parameters of each 128 columns (scales, then zero points), the x tile
template <typename XT, int BM, int kSub>
struct DecLayout {
  static constexpr int kCols = kSub * kBN;
  static constexpr int kWLd = kCols + 4;
  static constexpr int kParamOff = kWordRows * kWLd * 4;
  static constexpr int kXLd = kBK + 16 / (int)sizeof(XT);   // padded x row
  static constexpr int kXBytes = BM * kXLd * (int)sizeof(XT);
  static constexpr int kXOff = kParamOff + kSub * kParamBytes;
  static constexpr int kStage = kXOff + kXBytes;
  static constexpr int kSmem = kDecStages * kStage;
};

// kSub: 128-column sub-blocks a block takes (each warp 16 columns of each),
// 2 up to 32 rows, where a warp's x fragments then serve two A fragments;
// the split plan counts 128-column units either way, so a row's summation
// order does not depend on kSub
template <typename XT, int BM, int kSub>
__global__ void __launch_bounds__(kDecThreads)
k1_decode_kernel(const Args a) {
  using O = Op<XT>;
  using MT = typename O::MT;
  using L = DecLayout<XT, BM, kSub>;
  constexpr int kNT = BM / 8;                       // n8 tiles of x rows
  constexpr int kXChunks = kBK * (int)sizeof(XT) / 16;   // copies an x row
  constexpr int kWChunks = kWordRows * L::kCols / 4;     // copies of words
  constexpr uint32_t kMagic2 = O::kMagic | (O::kMagic << 16);
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last_s;

  const XT* x = static_cast<const XT*>(a.x);
  const int n0 = blockIdx.x * L::kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * BM;
  const int tiles = a.K / kBK;
  const int t0 = (int)((long long)tiles * split / a.splits);
  const int t1 = (int)((long long)tiles * (split + 1) / a.splits);
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  // sub-block u: A rows g and g + 8 are columns u * 128 + warp * 16 + g, + 8
  const int c_a = warp * 16 + g;

  // tile t into stage st: its words, its group's scales and zero points,
  // its x tile (rows past M zero-filled)
  auto load_tile = [&](int t, int st) {
    unsigned char* sb = smem + st * L::kStage;
#pragma unroll
    for (int k = 0; k < kWChunks / kDecThreads; ++k) {
      const int i = tid + k * kDecThreads;
      const int r = i / (L::kCols / 4);             // word row
      const int c = i % (L::kCols / 4);             // 4 columns a copy
      const int n = n0 + 4 * c;
      const bool ok = n < a.N;
      const int32_t* src =
          ok ? a.qweight + (size_t)(t * kWordRows + r) * a.N + n : a.qweight;
      cp_async_16(sb + (r * L::kWLd + 4 * c) * 4, src, ok ? 16 : 0);
    }
    if (warp < kSub)
      copy_group_params(sb + L::kParamOff + warp * kScBytes,
                        sb + L::kParamOff + kSub * kScBytes + warp * kZeroBytes,
                        a.scales, a.qzeros, a.N, n0 + warp * kBN,
                        t * kBK / a.gs, lane);
    for (int i = tid; i < BM * kXChunks; i += kDecThreads) {
      const int r = i / kXChunks;
      const int c = i % kXChunks;
      const bool ok = m0 + r < a.M;
      const XT* src = ok ? x + (size_t)(m0 + r) * a.K + t * kBK +
                               c * (16 / (int)sizeof(XT))
                         : x;
      cp_async_16(sb + L::kXOff + (r * L::kXLd) * (int)sizeof(XT) + c * 16,
                  src, ok ? 16 : 0);
    }
  };

#pragma unroll
  for (int i = 0; i < kDecStages - 1; ++i) {
    if (t0 + i < t1) load_tile(t0 + i, i);
    cp_async_commit();
  }

  float acc[kSub][kNT][4], tot[kSub][kNT][4];
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

  int grp = t0 * kBK / a.gs;
  for (int t = t0; t < t1; ++t) {
    cp_async_wait<kDecStages - 2>();
    __syncthreads();                  // tile t landed; tile t - 1 consumed
    {
      const int tn = t + kDecStages - 1;
      if (tn < t1) load_tile(tn, (tn - t0) % kDecStages);
      cp_async_commit();
    }
    const unsigned char* sb = smem + ((t - t0) % kDecStages) * L::kStage;
    const int gt = t * kBK / a.gs;
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

  // D rows are W columns (c_a, c_a + 8 of each sub-block), D columns x rows
  // 8j + 2q + {0, 1}
  XT* y = static_cast<XT*>(a.y);
  const bool direct = a.splits == 1;
#pragma unroll
  for (int u = 0; u < kSub; ++u)
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = m0 + 8 * j + 2 * q + (e & 1);
        const int n = n0 + u * kBN + c_a + (e < 2 ? 0 : 8);
        if (m >= a.M || n >= a.N) continue;
        if (direct) y[(size_t)m * a.N + n] = from_float<XT>(tot[u][j][e]);
        else a.partial[((size_t)split * a.M + m) * a.N + n] = tot[u][j][e];
      }
  if (direct) return;

  // the last split of this column block to arrive adds them in split order
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned int prev = atomicAdd(&a.arrivals[blockIdx.x], 1u);
    last_s = prev == (unsigned int)(a.splits - 1);
    if (last_s) a.arrivals[blockIdx.x] = 0u;   // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  // four columns a thread (N % 8 == 0: all or none of them exist), every
  // split's partials loaded before they are added in split order
  for (int i = tid; i < a.M * (L::kCols / 4); i += kDecThreads) {
    const int m = i / (L::kCols / 4);
    const int n = n0 + 4 * (i % (L::kCols / 4));
    if (n >= a.N) continue;
    float4 p[kMaxSplits];
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < a.splits)
        p[sp] = __ldcg(reinterpret_cast<const float4*>(
            a.partial + ((size_t)sp * a.M + m) * a.N + n));
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int sp = 0; sp < kMaxSplits; ++sp)
      if (sp < a.splits) {
        v.x += p[sp].x;
        v.y += p[sp].y;
        v.z += p[sp].z;
        v.w += p[sp].w;
      }
    XT* yr = y + (size_t)m * a.N + n;
    yr[0] = from_float<XT>(v.x);
    yr[1] = from_float<XT>(v.y);
    yr[2] = from_float<XT>(v.z);
    yr[3] = from_float<XT>(v.w);
  }
}

// --- prefill schedule ---------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kPreThreads, 1)
k1_prefill_kernel(const __grid_constant__ CUtensorMap tm_x,   // x [M, K]
                  const __grid_constant__ CUtensorMap tm_w,   // qweight
                  const int32_t* __restrict__ qzeros,
                  const float* __restrict__ scales,
                  T* __restrict__ y, int M, int N, int K, int gs) {
  // full: the TMA thread's arrival with the x and word bytes, and one
  // arrival from each lane of the parameter warp when its copies land;
  // empty: one arrival from each consumer warp
  constexpr int kParamOff = kXTile + kWBytes;
  constexpr uint32_t kMagic2 = Op<T>::kMagic | (Op<T>::kMagic << 16);
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[kPreStages];
  __shared__ __align__(8) uint64_t empty_bar[kPreStages];
  // the swizzle atoms want 1024-byte aligned tiles
  unsigned char* base =
      smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw));
  const int m0 = blockIdx.x * kPreBM;          // row tiles first
  const int n0 = blockIdx.y * kBN;
  const int nk = K / kBK;
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < kPreStages; ++st) {
      mbar_init(&full_bar[st], 1 + 32);
      mbar_init(&empty_bar[st], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform for the compiler (otherwise ptxas serializes every wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 2) {
    // --- producer warpgroup: one thread starts the TMA loads of x and the
    // words; warp 1 copies each tile's group parameters with cp.async ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    const int pw = (tid - 256) / 32;
    const int lane = tid % 32;
    if (pw == 0 && lane == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kPreStages;
        const int use = kt / kPreStages;
        if (use > 0) mbar_wait(&empty_bar[st], (use - 1) & 1);
        mbar_expect_tx(&full_bar[st], kXTile + kWBytes);
        unsigned char* sb = base + st * kPreStage;
        tma_load_2d(sb, &tm_x, &full_bar[st], kt * kBK, m0);
        tma_load_2d(sb + kXTile, &tm_w, &full_bar[st], n0, kt * kWordRows);
      }
    } else if (pw == 1) {
      for (int kt = 0; kt < nk; ++kt) {
        const int st = kt % kPreStages;
        const int use = kt / kPreStages;
        if (use > 0) mbar_wait(&empty_bar[st], (use - 1) & 1);
        unsigned char* pb = base + st * kPreStage + kParamOff;
        copy_group_params(pb, pb + kScBytes, scales, qzeros, N, n0,
                          kt * kBK / gs, lane);
        cp_async_arrive(&full_bar[st]);
      }
      cp_async_wait<0>();
    }
    return;
  }
  // --- consumer warpgroups: 64 columns each --------------------------------
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  const int wtid = tid % 128;
  const int warp = wtid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int q = lane % 4;
  const int c_a = wg * 64 + warp * 16 + g;      // column in the block
  const int col_a = n0 + c_a;
  const int col_b = col_a + 8;

  float acc[64], tot[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = tot[i] = 0.f;
  uint32_t a_even[4][4], a_odd[4][4];
  int pending = -1;                 // a stage whose products may be in flight

  auto tile = [&](int kt, uint32_t (&af)[4][4]) {
    const int st = kt % kPreStages;
    const bool first = (kt * kBK) % gs == 0;
    const bool last = ((kt + 1) * kBK) % gs == 0 || kt + 1 == nk;
    mbar_wait(&full_bar[st], (kt / kPreStages) & 1);
    const unsigned char* sb = base + st * kPreStage;
    const uint32_t* ws = reinterpret_cast<const uint32_t*>(sb + kXTile);
    const float* scs = reinterpret_cast<const float*>(sb + kParamOff);
    const uint32_t* zs =
        reinterpret_cast<const uint32_t*>(sb + kParamOff + kScBytes);
    const float sc[2] = {scs[c_a], scs[c_a + 8]};
    const uint32_t zp[2] = {zero_pair<T>(zs, c_a), zero_pair<T>(zs, c_a + 8)};
    uint32_t wa[kWordRows], wb[kWordRows];
#pragma unroll
    for (int r = 0; r < kWordRows; ++r) {
      wa[r] = ws[r * kBN + c_a];
      wb[r] = ws[r * kBN + c_a + 8];
    }
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      af[s][0] = nib_pair<T>(wa[2 * s], 8 * q, zp[0], kMagic2);
      af[s][1] = nib_pair<T>(wb[2 * s], 8 * q, zp[1], kMagic2);
      af[s][2] = nib_pair<T>(wa[2 * s + 1], 8 * q, zp[0], kMagic2);
      af[s][3] = nib_pair<T>(wb[2 * s + 1], 8 * q, zp[1], kMagic2);
    }
    const uint32_t x_addr = smem_u32(base + st * kPreStage);
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s)
      wgmma_rs_k_n128<T>(acc, af[s], desc_k_major(x_addr + 32 * s),
                         (first && s == 0) ? 0 : 1);
    wgmma_commit();
    fence_regs(acc);
    if (last) {
      wgmma_wait<0>();
      fence_regs(acc);
      if (lane == 0) {
        if (pending >= 0) mbar_arrive(&empty_bar[pending]);
        mbar_arrive(&empty_bar[st]);
      }
      pending = -1;
      // D rows are W columns (col_a, col_b), D columns x rows 8j + 2q + {0, 1}
#pragma unroll
      for (int i = 0; i < 64; ++i) tot[i] = fmaf(acc[i], sc[(i / 2) % 2], tot[i]);
    } else {
      // the previous tile's products are done; this tile's stay in flight
      // (their accumulators are not touched until the group's drain)
      wgmma_wait<1>();
      if (lane == 0 && pending >= 0) mbar_arrive(&empty_bar[pending]);
      pending = st;
    }
  };
  // pairs of tiles alternate the two A register sets; no branch inside a
  // pair, so the accumulators are never moved while products are in flight
  int kt = 0;
  for (; kt + 1 < nk; kt += 2) {
    tile(kt, a_even);
    tile(kt + 1, a_odd);
  }
  if (kt < nk) tile(kt, a_even);

#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int m = m0 + 8 * j + 2 * q + (e & 1);
      const int n = e < 2 ? col_a : col_b;
      if (m < M && n < N) y[(size_t)m * N + n] = from_float<T>(tot[4 * j + e]);
    }
}

// a 2-D tensor map (innermost dim first), 128-byte swizzle for x
bool make_map_2d(CUtensorMap* map, const void* ptr, CUtensorMapDataType type,
                 int elem_bytes, cuuint64_t d0, cuuint64_t d1, cuuint32_t b0,
                 cuuint32_t b1, CUtensorMapSwizzle swizzle) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {d0, d1};
  const cuuint64_t strides[1] = {d0 * elem_bytes};
  const cuuint32_t box[2] = {b0, b1};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename K>
cudaError_t allow_smem(K kernel, int bytes, bool (&attr_set)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  return cudaSuccess;
}

template <typename XT, int BM, int kSub>
cudaError_t launch_decode(const Args& a, cudaStream_t stream) {
  using L = DecLayout<XT, BM, kSub>;
  static bool attr_set[64] = {};
  const cudaError_t err =
      allow_smem(k1_decode_kernel<XT, BM, kSub>, L::kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + L::kCols - 1) / L::kCols, a.splits, (a.M + BM - 1) / BM);
  k1_decode_kernel<XT, BM, kSub><<<grid, kDecThreads, L::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_decode_rows(const Args& a, cudaStream_t stream) {
  if (a.M <= 16) return launch_decode<XT, 16, 2>(a, stream);
  if (a.M <= 32) return launch_decode<XT, 32, 2>(a, stream);
  return launch_decode<XT, 64, 1>(a, stream);
}

template <typename T>
cudaError_t launch_prefill(const Args& a, cudaStream_t stream) {
  CUtensorMap tm_x, tm_w;
  const CUtensorMapDataType xt = Op<T>::kMagic == 0x6400u
                                     ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
  if (!make_map_2d(&tm_x, a.x, xt, 2, a.K, a.M, kBK, kPreBM,
                   CU_TENSOR_MAP_SWIZZLE_128B) ||
      !make_map_2d(&tm_w, a.qweight, CU_TENSOR_MAP_DATA_TYPE_INT32, 4, a.N,
                   a.K / 8, kBN, kWordRows, CU_TENSOR_MAP_SWIZZLE_NONE))
    return cudaErrorInvalidValue;
  static bool attr_set[64] = {};
  const cudaError_t err = allow_smem(k1_prefill_kernel<T>, kPreSmem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.M + kPreBM - 1) / kPreBM, (a.N + kBN - 1) / kBN);
  k1_prefill_kernel<T><<<grid, kPreThreads, kPreSmem, stream>>>(
      tm_x, tm_w, a.qzeros, a.scales, static_cast<T*>(a.y), a.M, a.N, a.K,
      a.gs);
  return cudaGetLastError();
}

}  // namespace

// y = x @ dequant(W). dtype of x and y: 0 bf16, 1 fp16, 2 fp32. splits: the
// wrapper's plan from (N, K) (split_plan in ops/cuda/int4_matmul.py); above
// 1 only at M <= 64, with the [splits, M, N] f32 workspace `partial` and the
// [ceil(N / 128)] uint32 counters `arrivals` (all zero; the kernel leaves
// them zero). M <= 64 and fp32 x take the decode schedule, the rest the
// prefill schedule.
extern "C" int tgi_int4_matmul(const void* x, const void* qweight,
                               const void* qzeros, const void* scales, void* y,
                               void* partial, void* arrivals, int M, int N,
                               int K, int gs, int splits, int dtype,
                               void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int tiles = K / kBK;
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % kBK || gs <= 0 ||
      gs % kBK || K % gs || splits < 1 || splits > kMaxSplits ||
      splits > tiles || (splits > 1 && (M > kDecodeRows || !partial)) ||
      !arrivals || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(qweight) % 16)
    return (int)cudaErrorInvalidValue;
  Args a{x, static_cast<const int32_t*>(qweight),
         static_cast<const int32_t*>(qzeros), static_cast<const float*>(scales),
         y, static_cast<float*>(partial), static_cast<unsigned int*>(arrivals),
         M, N, K, gs, splits};
  switch (dtype) {
    case kXBf16:
      return (int)(M <= kDecodeRows ? launch_decode_rows<__nv_bfloat16>(a, st)
                                    : launch_prefill<__nv_bfloat16>(a, st));
    case kXFp16:
      return (int)(M <= kDecodeRows ? launch_decode_rows<__half>(a, st)
                                    : launch_prefill<__half>(a, st));
    case kXFp32:
      return (int)launch_decode_rows<float>(a, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tgi_int4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
