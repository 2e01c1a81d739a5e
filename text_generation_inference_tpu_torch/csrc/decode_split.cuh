// One-query decode attention split across blocks, for sm_90a: the kernel body
// shared by csrc/paged_attention.cu (the paged kernel, and K2, its stats mode
// over int8 pools) and csrc/slot_attention.cu (S1 over the slot cache, and
// S2, which adds the ring buffer and the current token).
//
// The ports compute the same thing for each (slot s, kv head kh): the
// softmax of the G query heads' scores over the slot's live keys, times the
// values, either normalized (out in q's dtype) or as the unnormalized fp32
// accumulator with the softmax row max m (natural-log units) and normalizer
// l, for a flash-decoding merge with keys held elsewhere (ctx == 0 gives
// m = -inf, l = 0, acc = 0). They differ in where a key's row comes from:
//
//   row source  kPaged:  pools [KH, R, D]; position p of slot s lives in page
//                        block_table[s, p / page] at row p % page; a page id
//                        outside [0, num_pages) (the sentinel) is skipped
//               !kPaged: the slot cache [S, KH, T, D] with any strides over
//                        S, KH and T and a contiguous head dim; rows >= ctx
//                        are never read, nor rows below lo[s] when the
//                        caller gives per-slot lower bounds (S1 under a
//                        sliding window: lo = ctx - W); in the ring mode
//                        also the ring buffer [S, KH, C, D] (contiguous),
//                        columns < step, as splits of their own after the
//                        cache's, and the current token's k / v [S, KH, D]
//   element     T:       q, and the rows when not int8: bf16 or fp16 (the
//                        mma body), fp32 (split_kernel_f32, below)
//               kInt8:   int8 rows with one f32 dequant factor per (kv head,
//                        pool row) in k_scale / v_scale [KH, R] (paged only)
//   ALiBi                with `slopes` ([KH, G] f32, null for none), slope *
//                        p is added to the scaled score of the key at
//                        position p of the slot's sequence (paged: the
//                        block-table position, not the pool row), as the
//                        JAX model's decode bias; the stats mode's m then
//                        carries the bias (natural-log units), as the ring
//                        merge of models/paged_core.py expects
//   shapes               bf16 / fp16: any head dim D that is a multiple of
//                        16 and is instantiated by `launch_d` (16, 64, 80,
//                        96, 128, 192, 256: the JAX package's families and
//                        the test fixtures); fp32: any multiple of 16 up to
//                        256, at run time;
//                        any group G: the grid takes the query heads of
//                        a kv head 16 at a time (the 16 rows of the mma's A)
//
// int8 math, as the JAX kernel's `_flash_page_update` with ks / vs
// (ops/pallas/paged_attention.py:34-76): scores = (q . k) * scale * ks,
// p = exp(scores - m), l sums the unscaled p, acc += (p * vs) . v. The int8
// values lie in [-127, 127] (models/core.py `quantize_kv`), which bf16, fp16
// and tf32 hold exactly, so the int8 conversion is exact and no scale enters
// a product: ks multiplies the fp32 scores, vs the probabilities before they
// are rounded to T for the value product (the rounding the bf16 kernel
// makes of p; the fp32 body splits them in two tf32 terms instead).
//
// What bounds it on an H100: each live K/V row is read once and takes
// 4 * G * D flops, well under one flop per byte. At G = 1 the mma fills 1 of
// its 16 A rows: a 64-key tile at D = 128 is about 0.5 MFLOP of tensor-core
// work against 16 KB of int8 rows, about 0.07 us of one SM's tensor rate
// against about 0.65 us of its share of 3.35 TB/s. So it is bound by bytes;
// the design is about blocks and bytes in flight.
//
// Design (flash-decoding in one launch):
//   - The grid is (S, KH * chunks, splits), chunks = ceil(G / 16). A split
//     covers a FIXED number of keys: whole pages (`pages_per_split`, from
//     the page size alone) or `rows_per_split` cache rows (from T alone), so
//     split boundaries sit at fixed positions and a slot's result never
//     depends on S or on the other slots (bit-identical whatever the batch).
//     A split past the slot's live keys exits at once. With lower bounds,
//     a slot's splits are numbered from the one that holds row lo[s], whose
//     first tile starts at lo[s]: the rows below it are never read.
//   - A paged block reads its split's block-table entries into shared memory
//     first, then every block keeps tiles of 64 keys in flight in a ring of
//     kStages stages: 16-byte cp.async copies of raw rows (T rows padded to
//     keep ldmatrix free of bank conflicts; int8 rows unpadded), with the 64
//     k and v scales of an int8 tile copied beside it; dead keys (past ctx,
//     or on a sentinel page) are zero-filled by the copy itself (src-size
//     0). One block barrier per tile.
//   - Each of the 4 warps takes 16 keys of a tile. Scores and the value
//     product run on mma.sync m16n8k16 (T in, fp32 accumulate): the block's
//     query heads are the A rows (rows 8-15 only when it has more than 8),
//     and the probabilities go from the score accumulators to A fragments
//     without leaving registers. Over T rows, K fragments come from ldmatrix
//     and V fragments from ldmatrix.trans. Over int8 rows each lane reads the
//     staged bytes its fragments need (the head dim and the keys permuted to
//     make those reads contiguous, 16-byte chunks swizzled against bank
//     conflicts at D = 128) and converts them in registers, exactly: byte
//     permutes into the exponent trick of the type (2^23 for bf16 through
//     fp32, 1024 for fp16); V's key pairs come from byte permutes across
//     rows. (A per-warp bf16 shadow of the tile read by ldmatrix measured
//     19-23% slower at 7B widths, 4% faster at D = 64, G = 8.) Each warp
//     keeps its own online softmax (fp32, exp2 with the scale folded in);
//     the block merges its 4 warps in shared memory.
//   - A slot with one live split writes its result directly. Otherwise each
//     split writes (acc, m, l) to the caller's fp32 scratch, fences, and
//     bumps the (slot, kv head, chunk)'s arrival counter; the block that
//     arrives last merges every split IN SPLIT ORDER (deterministic),
//     writes the output or the merged stats, and resets the counter to 0
//     for the next launch. One launch per call, no memset.
//   - kRing (S2): the cache's live splits, then the ring's (the same
//     rows_per_split over columns < step), then the current token, whose
//     score the merging block computes: one softmax over the three sources
//     in one launch. A slot with no live cache row and no live ring column
//     gives the current token's v.

#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Internal linkage: several libraries built from this header may live in one
// process (tools/kernel_ab.py loads versions side by side), and kernels of
// the same name must not bind across them.
namespace {
namespace decode_split {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // keys per stage, 16 per warp
constexpr int kStages = 3;           // tiles in flight
constexpr int kMaxGroup = 16;        // query heads a block (the mma's rows)
constexpr int kMaxSplitPages = 64;   // block-table entries a split reads
constexpr float kLn2 = 0.6931471805599453f;
constexpr float kLog2e = 1.4426950408889634f;
// dynamic shared memory a launch may ask for: the 227 KB a block may use,
// less 1 KB for the body's static arrays
constexpr size_t kMaxDynSmem = 232448 - 1024;

// kOut: normalized output; kStats: (acc, m, l); kRing: S2, normalized, the
// ring buffer and the current token folded in
enum Mode { kOut, kStats, kRing };

// Everything a launch reads; the fields of the other row source are unused.
struct Args {
  const void* q;                 // [S, KH, G, D] in T
  const void* k;                 // paged: [KH, R, D] pool; slot: the cache
  const void* v;                 // same layout as k
  const float* k_scale;          // int8: [KH, R]
  const float* v_scale;          // int8: [KH, R]
  const int32_t* block_table;    // paged: [S, max_pages]
  const int32_t* ctx;            // [S] live keys
  const int32_t* lo;             // slot: [S] first live row, or null for 0
  const float* slopes;           // [KH, G] ALiBi slopes, or null for none
  void* out;                     // T [S, KH, G, D], or f32 acc (stats)
  float* m_out;                  // stats: [S, KH, G]
  float* l_out;                  // stats: [S, KH, G]
  float* part;                   // [S, KH * chunks, splits, GS, D + 2]
  unsigned int* arrivals;        // [S * KH * chunks], all zero
  int KH, G;
  int R, page, max_pages, num_pages, pages_per_split;   // paged
  long long st_s, st_k, st_t;                          // slot, in elements
  int T, rows_per_split;                               // slot
  // kRing: the ring [S, KH, C, D] and the current token's k / v [S, KH, D]
  // in T; the grid's first cache_splits splits are the cache's
  const void* kr;
  const void* vr;
  const void* k_new;
  const void* v_new;
  int C, step, cache_splits;
  float scale_log2;              // 1 / sqrt(D) * log2(e)
};

// Where a split stands among the live splits of its (slot, kv head, chunk):
// n of them, the live split i in scratch row row(i) (the ring's splits sit
// after all of the cache's grid rows).
struct SplitMap {
  int n, gap_at, gap;
  __device__ __forceinline__ int row(int i) const {
    return i < gap_at ? i : i + gap;
  }
};

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_4(void* smem, const void* gmem,
                                           int bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(dst), "l"(gmem), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(a));
}

// What the body needs of its element type T: the mma, packing two floats
// into an A fragment register, and four int8 values to four T, exactly.
template <typename T>
struct Elem;

template <>
struct Elem<__nv_bfloat16> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ __nv_bfloat16 from_float(float x) {
    return __float2bfloat16(x);
  }
  static __device__ __forceinline__ float to_float(__nv_bfloat16 x) {
    return __bfloat162float(x);
  }
  // Each byte, offset by 128, becomes the low mantissa byte of 2^23
  // (0x4B0000xx); minus 2^23 + 128 gives the value as a float, whose top 16
  // bits are its bf16 (a value of at most 8 significant bits). lo holds
  // elements 0, 1 and hi elements 2, 3, lower element in the lower half.
  static __device__ __forceinline__ void i8x4(uint32_t w, uint32_t& lo,
                                              uint32_t& hi) {
    const uint32_t u = w ^ 0x80808080u;
    constexpr uint32_t kMagic = 0x4B000000u;
    const float f0 = __uint_as_float(__byte_perm(u, kMagic, 0x7650)) - 8388736.f;
    const float f1 = __uint_as_float(__byte_perm(u, kMagic, 0x7651)) - 8388736.f;
    const float f2 = __uint_as_float(__byte_perm(u, kMagic, 0x7652)) - 8388736.f;
    const float f3 = __uint_as_float(__byte_perm(u, kMagic, 0x7653)) - 8388736.f;
    lo = __byte_perm(__float_as_uint(f0), __float_as_uint(f1), 0x7632);
    hi = __byte_perm(__float_as_uint(f2), __float_as_uint(f3), 0x7632);
  }
};

template <>
struct Elem<__half> {
  static __device__ __forceinline__ void mma(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
        "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
  }
  static __device__ __forceinline__ uint32_t pack(float lo, float hi) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
  static __device__ __forceinline__ __half from_float(float x) {
    return __float2half(x);
  }
  static __device__ __forceinline__ float to_float(__half x) {
    return __half2float(x);
  }
  // Each byte, offset by 128, becomes the low mantissa byte of the fp16
  // 1024 (0x64xx); minus 1024 + 128 (0x6480) gives the value, exactly.
  static __device__ __forceinline__ void i8x4(uint32_t w, uint32_t& lo,
                                              uint32_t& hi) {
    const uint32_t u = w ^ 0x80808080u;
    constexpr uint32_t kMagic = 0x64646464u;
    const uint32_t a = __byte_perm(u, kMagic, 0x4140);
    const uint32_t b = __byte_perm(u, kMagic, 0x4342);
    const __half2 bias = __halves2half2(__ushort_as_half(0x6480),
                                        __ushort_as_half(0x6480));
    const __half2 x = __hsub2(*reinterpret_cast<const __half2*>(&a), bias);
    const __half2 y = __hsub2(*reinterpret_cast<const __half2*>(&b), bias);
    lo = *reinterpret_cast<const uint32_t*>(&x);
    hi = *reinterpret_cast<const uint32_t*>(&y);
  }
};

// float32 runs on split_kernel_f32 (3xTF32): only the conversions are
// needed.
template <>
struct Elem<float> {
  static __device__ __forceinline__ float from_float(float x) { return x; }
  static __device__ __forceinline__ float to_float(float x) { return x; }
};

// Shared-memory layout of one block.
template <int D, bool kInt8>
struct Layout {
  static constexpr int kElem = kInt8 ? 1 : 2;        // bytes an element
  static constexpr int kRow = D + 8;                 // T row, padded
  static constexpr int kRowBytes = kInt8 ? D : kRow * 2;    // a staged row
  static constexpr size_t kStage = (size_t)kTile * kRowBytes;   // K or V
  static constexpr size_t kScales =
      kInt8 ? (size_t)2 * kStages * kTile * sizeof(float) : 0;
  static constexpr size_t kBytes = 2 * kStages * kStage + kScales;
  static_assert(kBytes >= (size_t)kWarps * kMaxGroup * D * sizeof(float),
                "the warp merge reuses the stages");
  // int8 rows: the 16-byte chunk c of tile row j sits at chunk c ^ swz(j),
  // which keeps both fragment reads free of bank conflicts at D = 128
  static __device__ __forceinline__ int chunk(int c, int j) {
    return kInt8 && D == 128 ? c ^ ((j & 1) ^ (((j >> 2) & 3) << 1)) : c;
  }
};

// The N = D / 8 bytes a lane reads of a staged int8 V row, as N / 4 words
// (rounded up; the missing bytes of a last half word read as 0), with the
// widest loads the row offset allows.
template <int N>
__device__ __forceinline__ void load_row_bytes(uint32_t (&w)[(N + 3) / 4],
                                               const unsigned char* src) {
  if constexpr (N % 16 == 0) {
#pragma unroll
    for (int i = 0; i < N / 16; ++i) {
      const uint4 x = reinterpret_cast<const uint4*>(src)[i];
      w[4 * i] = x.x; w[4 * i + 1] = x.y; w[4 * i + 2] = x.z; w[4 * i + 3] = x.w;
    }
  } else if constexpr (N % 8 == 0) {
#pragma unroll
    for (int i = 0; i < N / 8; ++i) {
      const uint2 x = reinterpret_cast<const uint2*>(src)[i];
      w[2 * i] = x.x; w[2 * i + 1] = x.y;
    }
  } else if constexpr (N % 4 == 0) {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) w[i] = reinterpret_cast<const uint32_t*>(src)[i];
  } else {
    const uint16_t* h = reinterpret_cast<const uint16_t*>(src);
#pragma unroll
    for (int i = 0; i < (N + 3) / 4; ++i)
      w[i] = (uint32_t)h[2 * i] | (2 * i + 1 < N / 2 ? (uint32_t)h[2 * i + 1] << 16 : 0u);
  }
}

// Writes one query head's result: out in T, or acc / m (natural log) / l.
// `m2` is the merged max in log2 units; `head` the query head's index in
// [S * KH * G].
template <typename T, Mode M>
__device__ __forceinline__ void write_result(const Args& a, size_t head, int D,
                                             int d, float acc, float m2,
                                             float l) {
  if constexpr (M == kStats) {
    static_cast<float*>(a.out)[head * D + d] = acc;
    if (d == 0) {
      a.m_out[head] = m2 == -INFINITY ? -INFINITY : m2 * kLn2;
      a.l_out[head] = l;
    }
  } else {
    static_cast<T*>(a.out)[head * D + d] =
        Elem<T>::from_float(acc / fmaxf(l, 1e-30f));
  }
}

// kRing: the current token's scaled score (log2 units) for each of the
// block's query heads into sn [kMaxGroup], one warp a head, in fp32 over q
// and k_new as stored. Every thread of the block calls it.
template <typename T>
__device__ __forceinline__ void current_scores(const Args& a, int D, int s,
                                               int kh, int g0, int gb,
                                               float* sn) {
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const T* kn = static_cast<const T*>(a.k_new) + ((size_t)s * a.KH + kh) * D;
  for (int g = warp; g < gb; g += kWarps) {
    const T* qg = static_cast<const T*>(a.q) +
                  (((size_t)s * a.KH + kh) * a.G + g0 + g) * D;
    float dot = 0.f;
    for (int d = lane; d < D; d += 32)
      dot = fmaf(Elem<T>::to_float(qg[d]), Elem<T>::to_float(kn[d]), dot);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      dot += __shfl_xor_sync(0xffffffffu, dot, off);
    if (lane == 0) sn[g] = dot * a.scale_log2;
  }
  __syncthreads();
}

// The end of every split kernel: the 4 warps' softmax states (o_w [kWarps]
// [kMaxGroup][D], m_w / l_w [kWarps][kMaxGroup], in shared memory and
// complete) are merged; a slot with one live split writes its result,
// otherwise the split writes (acc, m, l) to its scratch row and the last
// split of the (slot, kv head, chunk) to arrive merges every live split in
// split order (map.row(i): the i-th live split's scratch row) and resets the
// counter. In kRing the merging block folds in the current token last
// (sn: kMaxGroup floats of shared memory).
template <typename T, Mode M>
__device__ __forceinline__ void finish_split(const Args& a, int D, int s,
                                             int kh, int g0, int gb,
                                             int split, const SplitMap& map,
                                             const float* o_w,
                                             float (*m_w)[kMaxGroup],
                                             float (*l_w)[kMaxGroup],
                                             float* sn, bool& last_s) {
  constexpr Mode kWrite = M == kStats ? kStats : kOut;
  const int tid = threadIdx.x;
  const size_t sk = (size_t)s * gridDim.y + blockIdx.y;
  const size_t head0 = ((size_t)s * a.KH + kh) * a.G + g0;
  const int splits = gridDim.z;
  const int gs = min(a.G, kMaxGroup);  // rows a split's scratch holds
  const bool direct = map.n == 1;
  // kRing: the current token's value at dim d
  auto v_new = [&](int d) {
    return Elem<T>::to_float(
        static_cast<const T*>(a.v_new)[((size_t)s * a.KH + kh) * D + d]);
  };
  if (M == kRing && direct) current_scores<T>(a, D, s, kh, g0, gb, sn);
  for (int i = tid; i < gb * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mx = M == kRing && direct ? sn[g] : -INFINITY;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_w[w][g]);
    const float m_safe = mx == -INFINITY ? 0.f : mx;
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float wt = m_w[w][g] == -INFINITY ? 0.f : exp2f(m_w[w][g] - m_safe);
      acc += wt * o_w[(w * kMaxGroup + g) * D + d];
      l += wt * l_w[w][g];
    }
    if (direct) {
      if constexpr (M == kRing) {
        const float wt = exp2f(sn[g] - m_safe);
        acc += wt * v_new(d);
        l += wt;
      }
      write_result<T, kWrite>(a, head0 + g, D, d, acc, mx, l);
    } else {
      float* row = a.part + ((sk * splits + split) * gs + g) * (D + 2);
      row[d] = acc;
      if (d == 0) {
        row[D] = mx;
        row[D + 1] = l;
      }
    }
  }
  if (direct) return;

  // the last split of this (slot, kv head, chunk) to arrive merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned int prev = atomicAdd(&a.arrivals[sk], 1u);
    last_s = prev == (unsigned int)(map.n - 1);
    if (last_s) a.arrivals[sk] = 0u;     // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  if (M == kRing) current_scores<T>(a, D, s, kh, g0, gb, sn);
  const float* base = a.part + sk * splits * gs * (D + 2);
  for (int i = tid; i < gb * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mx = M == kRing ? sn[g] : -INFINITY;
    for (int sp = 0; sp < map.n; ++sp)
      mx = fmaxf(mx, __ldcg(base + (map.row(sp) * gs + g) * (D + 2) + D));
    const float m_safe = mx == -INFINITY ? 0.f : mx;
    float acc = 0.f, l = 0.f;
    for (int sp = 0; sp < map.n; ++sp) {
      const float* row = base + (map.row(sp) * gs + g) * (D + 2);
      const float m = __ldcg(row + D);
      const float wt = m == -INFINITY ? 0.f : exp2f(m - m_safe);
      acc += wt * __ldcg(row + d);
      l += wt * __ldcg(row + D + 1);
    }
    if constexpr (M == kRing) {
      const float wt = exp2f(sn[g] - m_safe);
      acc += wt * v_new(d);
      l += wt;
    }
    write_result<T, kWrite>(a, head0 + g, D, d, acc, mx, l);
  }
}

// The split's positions [p0, p1), the base addresses of its rows and its
// place among the live splits (`map`), as every split kernel finds them (a
// paged block also reads its split's block-table entries into pid_s: -1 for
// a page that is not mapped). Returns false when the split is not live.
template <bool kPaged, Mode M>
__device__ __forceinline__ bool split_range(const Args& a, int D, int elem,
                                            int s, int kh, int split,
                                            int* pid_s, SplitMap& map,
                                            int& p0, int& p1,
                                            const unsigned char*& kbase,
                                            const unsigned char*& vbase,
                                            size_t& row_bytes) {
  const int tid = threadIdx.x;
  if constexpr (kPaged) {
    const int n_pages =
        min((max(a.ctx[s], 0) + a.page - 1) / a.page, a.max_pages);
    const int ctx = min(max(a.ctx[s], 0), n_pages * a.page);
    const int n_splits =
        max(1, (n_pages + a.pages_per_split - 1) / a.pages_per_split);
    map = SplitMap{n_splits, n_splits, 0};
    if (split >= n_splits) return false;
    const int first_page = split * a.pages_per_split;
    p0 = first_page * a.page;
    p1 = min(p0 + a.pages_per_split * a.page, ctx);
    for (int i = tid; i < a.pages_per_split; i += kThreads) {
      int pid = -1;
      if (first_page + i < n_pages) {
        pid = a.block_table[(size_t)s * a.max_pages + first_page + i];
        if (pid < 0 || pid >= a.num_pages) pid = -1;
      }
      pid_s[i] = pid;
    }
    const size_t head = (size_t)kh * a.R * D * elem;
    kbase = static_cast<const unsigned char*>(a.k) + head;
    vbase = static_cast<const unsigned char*>(a.v) + head;
    row_bytes = (size_t)D * elem;
    __syncthreads();
  } else {
    const int rps = a.rows_per_split;
    const int ctx = min(max(a.ctx[s], 0), a.T);
    const int lo = a.lo != nullptr ? min(max(a.lo[s], 0), ctx) : 0;
    const int first = lo / rps;     // the split that holds lo
    const int cache_live = (ctx + rps - 1) / rps - first;
    if (M == kRing && split >= a.cache_splits) {
      // a ring split: columns [p0, p1) of the ring, after every cache split
      const int ring_live = (a.step + rps - 1) / rps;
      const int r = split - a.cache_splits;
      map = SplitMap{cache_live + ring_live, cache_live,
                     a.cache_splits - cache_live};
      if (r >= ring_live) return false;
      p0 = r * rps;
      p1 = min(p0 + rps, a.step);
      const size_t head = ((size_t)s * a.KH + kh) * a.C * D * elem;
      kbase = static_cast<const unsigned char*>(a.kr) + head;
      vbase = static_cast<const unsigned char*>(a.vr) + head;
      row_bytes = (size_t)D * elem;
      return true;
    }
    // kRing: a slot with no live cache row and no live ring column keeps
    // one (empty) cache split, which writes the current token alone
    const int ring_live = M == kRing ? (a.step + rps - 1) / rps : 0;
    const int n_cache = max(cache_live, cache_live + ring_live == 0 ? 1 : 0);
    map = SplitMap{n_cache + ring_live, n_cache, a.cache_splits - n_cache};
    if (split >= n_cache) return false;
    p0 = (first + split) * rps;
    p1 = min(p0 + rps, ctx);
    p0 = max(p0, lo);
    const size_t head = ((size_t)s * a.st_s + (size_t)kh * a.st_k) * elem;
    kbase = static_cast<const unsigned char*>(a.k) + head;
    vbase = static_cast<const unsigned char*>(a.v) + head;
    row_bytes = (size_t)a.st_t * elem;
  }
  return true;
}

template <typename T, int D, bool kPaged, bool kInt8, Mode M>
__global__ void __launch_bounds__(kThreads, 1)
    split_kernel(const Args a) {
  using L = Layout<D, kInt8>;
  using E = Elem<T>;
  constexpr int kRow = L::kRow;
  constexpr int kSteps = D / 16;       // k16 steps over the head dim
  constexpr int kOutTiles = D / 8;     // n8 tiles of the output
  constexpr int kChunks = D * L::kElem / 16;   // 16-byte copies a row
  static_assert(D % 16 == 0, "the head dim is a multiple of 16");
  static_assert(kPaged || !kInt8, "int8 rows come from paged pools");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* k_st = smem_raw;
  unsigned char* v_st = smem_raw + kStages * L::kStage;
  float* ksc_s = reinterpret_cast<float*>(smem_raw + 2 * kStages * L::kStage);
  float* vsc_s = ksc_s + kStages * kTile;
  __shared__ int pid_s[kMaxSplitPages];
  __shared__ float m_w[kWarps][kMaxGroup], l_w[kWarps][kMaxGroup];
  __shared__ float sn_s[kMaxGroup];
  __shared__ bool last_s;

  const int chunks = (a.G + kMaxGroup - 1) / kMaxGroup;
  const int s = blockIdx.x;
  const int kh = blockIdx.y / chunks;
  const int g0 = (blockIdx.y % chunks) * kMaxGroup;   // first query head
  const int gb = min(kMaxGroup, a.G - g0);            // query heads here
  const bool hi = gb > 8;                             // A rows 8-15 in use
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = lane / 4;
  const int quad = lane % 4;

  // the split's positions [p0, p1)
  SplitMap map;
  int p0, p1;
  const unsigned char* kbase;
  const unsigned char* vbase;
  size_t row_bytes;                    // bytes from one row to the next
  if (!split_range<kPaged, M>(a, D, L::kElem, s, kh, split, pid_s, map, p0,
                              p1, kbase, vbase, row_bytes))
    return;
  const int n_tiles = p1 > p0 ? (p1 - p0 + kTile - 1) / kTile : 0;

  // the row (pool row, or cache row) of position p; false for a dead key
  auto row_of = [&](int p, size_t& row) -> bool {
    if (p >= p1) return false;
    if constexpr (kPaged) {
      const int pid = pid_s[(p - p0) / a.page];
      if (pid < 0) return false;
      row = (size_t)pid * a.page + p % a.page;
    } else {
      row = (size_t)p;
    }
    return true;
  };
  auto load_tile = [&](int t, int st) {
    for (int idx = tid; idx < kTile * kChunks; idx += kThreads) {
      const int j = idx / kChunks;
      const int c = idx % kChunks;
      size_t row = 0;
      const bool live = row_of(p0 + t * kTile + j, row);
      const size_t off = live ? row * row_bytes + (size_t)c * 16 : 0;
      const size_t dst =
          st * L::kStage + (size_t)j * L::kRowBytes + L::chunk(c, j) * 16;
      cp_async_16(k_st + dst, kbase + off, live ? 16 : 0);
      cp_async_16(v_st + dst, vbase + off, live ? 16 : 0);
    }
    if constexpr (kInt8) {
      // thread j < 64: key j's k scale; thread 64 + j: its v scale
      const int j = tid % kTile;
      size_t row = 0;
      const bool live = row_of(p0 + t * kTile + j, row);
      const float* src = (tid < kTile ? a.k_scale : a.v_scale) +
                         (size_t)kh * a.R + (live ? row : 0);
      cp_async_4((tid < kTile ? ksc_s : vsc_s) + st * kTile + j, src,
                 live ? 4 : 0);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t, t);
    cp_async_commit();
  }

  // q as A fragments: row r < gb is query head g0 + r, the other rows zero.
  // Over int8 rows the head dim is permuted: k step st of lane quad holds
  // d = quad * D / 4 + 4 st + {0, 1} and {2, 3}, the 4 bytes the lane reads
  // from a staged int8 row for that step.
  uint32_t qa[kSteps][4];
  {
    const T* qb = static_cast<const T*>(a.q) +
                  (((size_t)s * a.KH + kh) * a.G + g0) * D;
    const T* q_lo = qb + (size_t)group * D;
    const T* q_hi = qb + (size_t)(group + 8) * D;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int c = kInt8 ? quad * (D / 4) + 4 * st : st * 16 + quad * 2;
      const int c2 = kInt8 ? c + 2 : c + 8;
      const bool lo_live = group < gb, hi_live = group + 8 < gb;
      qa[st][0] = lo_live ? *reinterpret_cast<const uint32_t*>(q_lo + c) : 0u;
      qa[st][2] = lo_live ? *reinterpret_cast<const uint32_t*>(q_lo + c2) : 0u;
      qa[st][1] = hi_live ? *reinterpret_cast<const uint32_t*>(q_hi + c) : 0u;
      qa[st][3] = hi_live ? *reinterpret_cast<const uint32_t*>(q_hi + c2) : 0u;
    }
  }
  float o[kOutTiles][4];
#pragma unroll
  for (int t = 0; t < kOutTiles; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  // this lane's rows are query heads group (h = 0) and group + 8 (h = 1)
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};   // this lane's partial row sums
  // their ALiBi slopes in exp2 units (0 without slopes: the score is then
  // the scaled product alone)
  float slope[2] = {0.f, 0.f};
  if (a.slopes != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (group + 8 * h < gb)
        slope[h] = a.slopes[(size_t)kh * a.G + g0 + group + 8 * h] * kLog2e;
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile t landed; every warp is done with tile t - 1
    if (t + kStages - 1 < n_tiles)
      load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    const int key0 = p0 + t * kTile + warp * 16;
    if (key0 >= p1) continue;          // warp-uniform: no live key here
    const int st = t % kStages;
    // key (in the tile) of score accumulators e and e + 2 of n8 tile nt:
    // T tiles keep the keys in order; int8 fragments make score column n of
    // tile nt key (n / 2) * 4 + n % 2 + 2 nt, so that lane quad's
    // accumulators hold keys quad * 4 + 2 nt + e, the 4 rows it reads for
    // P V
    auto key_of = [&](int nt, int e) {
      return warp * 16 + (kInt8 ? quad * 4 + 2 * nt + e : nt * 8 + quad * 2 + e);
    };
    const unsigned char* kt = k_st + st * L::kStage;
    const unsigned char* vt = v_st + st * L::kStage;

    // scores of 16 keys: two n8 tiles
    float sc[2][4];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    if constexpr (kInt8) {
      // lane group n reads key row (n / 2) * 4 + n % 2 + 2 nt, the D / 4
      // bytes of lane quad's head dims, and converts them in registers
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = warp * 16 + (group >> 1) * 4 + (group & 1) + 2 * nt;
        if constexpr (D % 64 == 0) {
#pragma unroll
          for (int h = 0; h < D / 64; ++h) {
            const uint4 w = *reinterpret_cast<const uint4*>(
                kt + j * D + L::chunk(quad * (D / 64) + h, j) * 16);
            const uint32_t ws[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              uint32_t b0, b1;
              E::i8x4(ws[i], b0, b1);
              E::mma(sc[nt], qa[h * 4 + i], b0, b1);
            }
          }
        } else {
#pragma unroll
          for (int st2 = 0; st2 < kSteps; ++st2) {
            uint32_t b0, b1;
            E::i8x4(*reinterpret_cast<const uint32_t*>(
                        kt + j * D + quad * (D / 4) + 4 * st2), b0, b1);
            E::mma(sc[nt], qa[st2], b0, b1);
          }
        }
      }
    } else {
      // ldmatrix rows are keys
      const T* kw = reinterpret_cast<const T*>(kt) + warp * 16 * kRow;
#pragma unroll
      for (int st2 = 0; st2 < kSteps; ++st2) {
        uint32_t b[4];
        ldmatrix_x4(b, kw + ((lane / 16) * 8 + lane % 8) * kRow + st2 * 16 +
                           ((lane / 8) & 1) * 8);
        E::mma(sc[0], qa[st2], b[0], b[1]);
        E::mma(sc[1], qa[st2], b[2], b[3]);
      }
    }

    // mask, scale (times the k scale over int8 rows), ALiBi at the key's
    // position, online softmax for row group (accumulators 0, 1 of each n8
    // tile) and, when the block has more than 8 query heads, row group + 8
    // (accumulators 2, 3)
    // the key positions: one conversion, then constants of the loop
    const float pos0 = (float)(p0 + t * kTile + key_of(0, 0));
    float f[2][2], pos[2][2];
    bool live[2][2];
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = key_of(nt, e);
        const int key = p0 + t * kTile + j;
        pos[nt][e] = pos0 + (float)(kInt8 ? 2 * nt + e : 8 * nt + e);
        live[nt][e] = key < p1;
        if constexpr (kPaged)
          live[nt][e] = live[nt][e] && pid_s[(key - p0) / a.page] >= 0;
        f[nt][e] = a.scale_log2;
        if constexpr (kInt8) f[nt][e] *= ksc_s[st * kTile + j];
      }
    }
    float alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !hi) break;
      float tmax = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nt][2 * h + e];
          x = live[nt][e] ? fmaf(slope[h], pos[nt][e], x * f[nt][e])
                          : -INFINITY;
          tmax = fmaxf(tmax, x);
        }
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_row[h], tmax);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = m_row[h] == -INFINITY ? 0.f : exp2f(m_row[h] - m_safe);
      m_row[h] = m_new;
      l_row[h] *= alpha[h];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nt][2 * h + e];
          const float p = x == -INFINITY ? 0.f : exp2f(x - m_safe);
          l_row[h] += p;
          x = p;
          if constexpr (kInt8) x = p * vsc_s[st * kTile + key_of(nt, e)];
        }
      }
    }
#pragma unroll
    for (int t2 = 0; t2 < kOutTiles; ++t2) {
      o[t2][0] *= alpha[0];
      o[t2][1] *= alpha[0];
      o[t2][2] *= alpha[1];
      o[t2][3] *= alpha[1];
    }

    // O += P V: P as the A fragment (rows 8-15 zero unless in use)
    const uint32_t pa[4] = {E::pack(sc[0][0], sc[0][1]),
                            hi ? E::pack(sc[0][2], sc[0][3]) : 0u,
                            E::pack(sc[1][0], sc[1][1]),
                            hi ? E::pack(sc[1][2], sc[1][3]) : 0u};
    if constexpr (kInt8) {
      // lane (group, quad) reads rows quad * 4 + r, bytes [group * D / 8,
      // (group + 1) * D / 8): column n * D / 8 + t2 of n8 tile t2 comes from
      // lane group n; byte permutes pair rows (0, 1) and (2, 3) per column
      constexpr int kCols = D / 8;         // bytes of a row a lane reads
      constexpr int kWords = (kCols + 3) / 4;
      uint32_t vw[4][kWords];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = warp * 16 + quad * 4 + r;
        load_row_bytes<kCols>(
            vw[r], vt + j * D + (D == 128 ? L::chunk(group, j) * 16 : group * kCols));
      }
#pragma unroll
      for (int i = 0; i < kWords; ++i) {
        uint32_t b0[4], b1[4];
        E::i8x4(__byte_perm(vw[0][i], vw[1][i], 0x5140), b0[0], b0[1]);
        E::i8x4(__byte_perm(vw[0][i], vw[1][i], 0x7362), b0[2], b0[3]);
        E::i8x4(__byte_perm(vw[2][i], vw[3][i], 0x5140), b1[0], b1[1]);
        E::i8x4(__byte_perm(vw[2][i], vw[3][i], 0x7362), b1[2], b1[3]);
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (4 * i + b < kCols) E::mma(o[4 * i + b], pa, b0[b], b1[b]);
      }
    } else {
      // V by ldmatrix.trans
      const T* vw = reinterpret_cast<const T*>(vt) + warp * 16 * kRow;
#pragma unroll
      for (int n2 = 0; n2 < D / 16; ++n2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, vw + (((lane / 8) & 1) * 8 + lane % 8) * kRow +
                                 n2 * 16 + (lane / 16) * 8);
        E::mma(o[2 * n2], pa, b[0], b[1]);
        E::mma(o[2 * n2 + 1], pa, b[2], b[3]);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the stages are free: reuse them for the warp merge

  // merge the 4 warps' softmax states in shared memory
  float* o_w = reinterpret_cast<float*>(smem_raw);     // [kWarps][16][D]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 1);
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 2);
    const int r = group + 8 * h;
    if (r >= gb) continue;
#pragma unroll
    for (int t2 = 0; t2 < kOutTiles; ++t2) {
      // column of accumulator e: t2 * 8 + quad * 2 + e, or over int8 rows
      // (quad * 2 + e) * D / 8 + t2
      const int d0 = kInt8 ? quad * 2 * (D / 8) + t2 : t2 * 8 + quad * 2;
      const int d1 = kInt8 ? d0 + D / 8 : d0 + 1;
      o_w[(warp * kMaxGroup + r) * D + d0] = o[t2][2 * h];
      o_w[(warp * kMaxGroup + r) * D + d1] = o[t2][2 * h + 1];
    }
    if (quad == 0) {
      m_w[warp][r] = m_row[h];
      l_w[warp][r] = l_row[h];
    }
  }
  __syncthreads();

  finish_split<T, M>(a, D, s, kh, g0, gb, split, map, o_w, m_w, l_w, sn_s,
                     last_s);
}

// The float32 body (`dtype` 2): the same grid, split plan, scratch, merge
// and modes as split_kernel, with the head dim at run time (any multiple of
// 16 up to 256). The JAX kernels cast q, k and v to f32 and compute in f32;
// one TF32 product keeps 10 of the 23 mantissa bits and misses a 1e-4
// tolerance. So both products run on the tensor cores in 3xTF32, as flash
// prefill's fp32 body does (csrc/flash_prefill.cu): every operand split in
// two TF32 terms, hi = rna(x) and lo = rna(x - hi), each product the three
// mma.sync m16n8k8 .tf32 products lo.hi + hi.lo + hi.hi with fp32 sums
// (lo.lo is below fp32's rounding). int8 rows are exact in TF32 (lo = 0):
// two products, lo.b + hi.b.
//
// What bounds it: bytes, twice the mma body's over fp32 rows (a row's
// 4 * G * D flops, three times over at the TF32 rate, stay far under the
// card's flops for a byte). The design follows the mma body:
//   - A ring of `stages` tiles of 4 * kKpw keys (kKpw keys a warp, 8 or 16)
//     by 16-byte cp.async, dead keys zero-filled, int8 tiles with their k
//     and v scales. Tile keys and stages come from the wrapper's plan
//     (ops/cuda/paged_attention.py `tile_plan`, from D, G and the row type:
//     two blocks an SM where they fit). fp32 K rows are strided D + 8
//     floats, V rows D + 4, int8 rows D + 16 bytes, which keeps the fragment
//     loads below free of bank conflicts (int8: up to D = 128).
//   - The block's query heads are the A rows (rows 8-15 only past 8 heads),
//     split once into hi / lo fragments in shared memory (q_s: per query
//     head, k step and lane quad one 16-byte {hi, hi, lo, lo}). The head dim inside
//     a k8 step is permuted (k position q <-> d 2q, q + 4 <-> d 2q + 1, the
//     same in q and K), so a lane reads its K pair as one 8-byte load; over
//     int8 rows lane quad's step st holds d = quad * D / 4 + 2 st + {0, 1},
//     so that it reads its D / 4 bytes of a row once for every step.
//   - Each warp keeps its own online softmax over its keys of every tile
//     (exp2, the scale folded in) with O in registers (o [D / 8][4],
//     rescaled once a tile). For P V the keys are permuted as in flash
//     prefill's body, so the score accumulators are P's A fragments in
//     place; V's B fragments are two 4-byte loads over fp32 rows, or the
//     D / 8 bytes of lane group's dims of each of two int8 rows (output dim
//     group * D / 8 + n8 tile), converted in registers.
//   - The 4 warps merge in shared memory and the split ends in finish_split,
//     as in the mma body.
// kMaxD: the head dims the registers are sized for (64, 128 or 256).
constexpr int kMaxDim = 256;

// Shared memory of the fp32 body, in bytes: the ring of `stages` K and V
// tiles of `tile` rows (int8: with their scales), which the warp merge
// reuses, then q_s for the block's query heads (at most 16). The wrapper's plan computes
// the same (ops/cuda/paged_attention.py `f32_smem`).
struct F32Smem {
  int ldk, ldv;        // row strides: floats (fp32 rows) or bytes (int8)
  int ldq;             // q_s row stride, in 32-bit words
  size_t k_tile, v_tile, stage, ring, total;
  __host__ __device__ F32Smem(int D, int G, int tile, int stages, bool int8) {
    const size_t elem = int8 ? 1 : 4;
    ldk = int8 ? D + 16 : D + 8;
    ldv = int8 ? D + 16 : D + 4;
    ldq = 2 * D + 16;
    k_tile = (size_t)tile * ldk * elem;
    v_tile = (size_t)tile * ldv * elem;
    stage = k_tile + v_tile + (int8 ? (size_t)2 * tile * sizeof(float) : 0);
    const size_t merge = (size_t)kWarps * kMaxGroup * D * sizeof(float);
    ring = (size_t)stages * stage > merge ? (size_t)stages * stage : merge;
    const int rows = G < kMaxGroup ? G : kMaxGroup;
    total = ring + (size_t)rows * ldq * sizeof(uint32_t);
  }
};

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo, both TF32 (round to nearest, ties away)
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// not volatile: the compiler may interleave independent products
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[i] += a b[i] to fp32 accuracy from the split terms, for kN B fragments
// (b[i][0], b[i][1]): the small terms first, each over all kN accumulators
// before the next
template <int kN>
__device__ __forceinline__ void mma_3xtf32(float (*d)[4],
                                           const uint32_t (&a_hi)[4],
                                           const uint32_t (&a_lo)[4],
                                           const float (&b)[kN][2]) {
  uint32_t bh[kN][2], bl[kN][2];
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    split_tf32(b[i][0], bh[i][0], bl[i][0]);
    split_tf32(b[i][1], bh[i][1], bl[i][1]);
  }
#pragma unroll
  for (int i = 0; i < kN; ++i) mma_tf32(d[i], a_lo, bh[i][0], bh[i][1]);
#pragma unroll
  for (int i = 0; i < kN; ++i) mma_tf32(d[i], a_hi, bl[i][0], bl[i][1]);
#pragma unroll
  for (int i = 0; i < kN; ++i) mma_tf32(d[i], a_hi, bh[i][0], bh[i][1]);
}

// byte b of w, an int8, as its exact float, whose bits are also its TF32:
// offset by 128 it becomes the low mantissa byte of 2^23
__device__ __forceinline__ uint32_t i8_tf32(uint32_t w, int b) {
  return __float_as_uint(
      __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                  0x7650u | (uint32_t)b)) - 8388736.f);
}

template <int kMaxD, int kKpw, bool kPaged, bool kInt8, Mode M>
__global__ void __launch_bounds__(kThreads)
    split_kernel_f32(const Args a, int D, int stages) {
  constexpr int kTileK = kWarps * kKpw;      // keys a tile
  constexpr int kNK = kKpw / 8;              // n8 score tiles a warp
  constexpr int kMaxSteps = kMaxD / 8;       // k8 steps, n8 output tiles
  static_assert(kKpw % 8 == 0 && kMaxD % 32 == 0, "tiles of 8 keys, 8 dims");
  static_assert(kPaged || !kInt8, "int8 rows come from paged pools");
  const F32Smem L(D, a.G, kTileK, stages, kInt8);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  uint32_t* q_s = reinterpret_cast<uint32_t*>(smem_raw + L.ring);
  __shared__ int pid_s[kMaxSplitPages];
  __shared__ float m_w[kWarps][kMaxGroup], l_w[kWarps][kMaxGroup];
  __shared__ float sn_s[kMaxGroup];
  __shared__ bool last_s;
  const int elem = kInt8 ? 1 : 4;
  const int nsteps = D / 8;                  // k8 steps, n8 output tiles

  const int chunks = (a.G + kMaxGroup - 1) / kMaxGroup;
  const int s = blockIdx.x;
  const int kh = blockIdx.y / chunks;
  const int g0 = (blockIdx.y % chunks) * kMaxGroup;   // first query head
  const int gb = min(kMaxGroup, a.G - g0);            // query heads here
  const bool rows_hi = gb > 8;                        // A rows 8-15 in use
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = lane / 4;
  const int quad = lane % 4;

  SplitMap map;
  int p0, p1;
  const unsigned char* kbase;
  const unsigned char* vbase;
  size_t row_bytes;
  if (!split_range<kPaged, M>(a, D, elem, s, kh, split, pid_s, map, p0, p1,
                              kbase, vbase, row_bytes))
    return;
  const int n_tiles = p1 > p0 ? (p1 - p0 + kTileK - 1) / kTileK : 0;

  // the row (pool row, or cache row) of position p; false for a dead key
  // (a page of a power-of-two size: shifts, not divisions)
  const bool pow2 = kPaged && (a.page & (a.page - 1)) == 0;
  const int pshift = pow2 ? __ffs(a.page) - 1 : 0;
  auto row_of = [&](int p, size_t& row) -> bool {
    if (p >= p1) return false;
    if constexpr (kPaged) {
      const int rel = p - p0;                // p0 is a page's first position
      const int pid = pid_s[pow2 ? rel >> pshift : rel / a.page];
      if (pid < 0) return false;
      row = (size_t)pid * a.page + (pow2 ? rel & (a.page - 1) : rel % a.page);
    } else {
      row = (size_t)p;
    }
    return true;
  };
  // this thread's 16-byte copies of a tile: chunk lc of rows lj, lj + rpp,
  // ... (the divisions once, not a copy)
  const int cpr = D * elem / 16;             // 16-byte copies a row
  const int rpp = kThreads / cpr;            // rows a pass of the block
  const int lc = tid % cpr;
  const int lj = tid < rpp * cpr ? tid / cpr : kTileK;
  auto load_tile = [&](int t, int st) {
    unsigned char* kt = smem_raw + st * L.stage;
    unsigned char* vt = kt + L.k_tile;
    for (int j = lj; j < kTileK; j += rpp) {
      size_t row = 0;
      const bool live = row_of(p0 + t * kTileK + j, row);
      const size_t off = live ? row * row_bytes + (size_t)lc * 16 : 0;
      cp_async_16(kt + (size_t)j * L.ldk * elem + lc * 16, kbase + off,
                  live ? 16 : 0);
      cp_async_16(vt + (size_t)j * L.ldv * elem + lc * 16, vbase + off,
                  live ? 16 : 0);
    }
    if constexpr (kInt8) {
      // the tile's k scales, then its v scales
      float* sc = reinterpret_cast<float*>(vt + L.v_tile);
      for (int i = tid; i < 2 * kTileK; i += kThreads) {
        const int j = i % kTileK;
        size_t row = 0;
        const bool live = row_of(p0 + t * kTileK + j, row);
        const float* src = (i < kTileK ? a.k_scale : a.v_scale) +
                           (size_t)kh * a.R + (live ? row : 0);
        cp_async_4(sc + i, src, live ? 4 : 0);
      }
    }
  };
  for (int t = 0; t < stages - 1; ++t) {
    if (t < n_tiles) load_tile(t, t);
    cp_async_commit();
  }

  // q's split fragments: row r < gb is query head g0 + r (the A rows past
  // gb are zero, not stored); entry (r, k step, quad) holds the hi and lo
  // terms of the lane's two dims of that step
  {
    const float* qb = static_cast<const float*>(a.q) +
                      (((size_t)s * a.KH + kh) * a.G + g0) * D;
    const int pairs = D / 2;
    for (int i = tid; i < gb * pairs; i += kThreads) {
      const int r = i / pairs;
      const int pr = i - r * pairs;          // k step pr / 4, quad pr % 4
      const int d0 = kInt8 ? (pr & 3) * (D / 4) + 2 * (pr >> 2) : 2 * pr;
      const float2 x = *reinterpret_cast<const float2*>(qb + (size_t)r * D + d0);
      uint4 w;
      split_tf32(x.x, w.x, w.z);
      split_tf32(x.y, w.y, w.w);
      *reinterpret_cast<uint4*>(q_s + r * L.ldq + 4 * pr) = w;
    }
  }
  const bool lo_live = group < gb, hi_live = group + 8 < gb;
  auto q_frags = [&](int st, uint32_t (&ah)[4], uint32_t (&al)[4]) {
    uint4 x = make_uint4(0u, 0u, 0u, 0u), y = x;
    if (lo_live)
      x = *reinterpret_cast<const uint4*>(q_s + group * L.ldq + 4 * (4 * st + quad));
    if (hi_live)
      y = *reinterpret_cast<const uint4*>(
          q_s + (group + 8) * L.ldq + 4 * (4 * st + quad));
    ah[0] = x.x; ah[2] = x.y; al[0] = x.z; al[2] = x.w;
    ah[1] = y.x; ah[3] = y.y; al[1] = y.z; al[3] = y.w;
  };

  float o[kMaxSteps][4];
#pragma unroll
  for (int i = 0; i < kMaxSteps; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  // this lane's rows are query heads group (h = 0) and group + 8 (h = 1)
  float m_row[2] = {-INFINITY, -INFINITY};
  float l_row[2] = {0.f, 0.f};   // this lane's partial row sums
  float slope[2] = {0.f, 0.f};   // ALiBi slopes in exp2 units
  if (a.slopes != nullptr) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (group + 8 * h < gb)
        slope[h] = a.slopes[(size_t)kh * a.G + g0 + group + 8 * h] * kLog2e;
  }

  for (int t = 0; t < n_tiles; ++t) {
    if (stages == 3) cp_async_wait<1>();
    else cp_async_wait<0>();
    __syncthreads();   // tile t landed; every warp is done with tile t - 1
    if (t + stages - 1 < n_tiles)
      load_tile(t + stages - 1, (t + stages - 1) % stages);
    cp_async_commit();
    const int kw0 = warp * kKpw;       // the warp's first key in the tile
    const int key0 = p0 + t * kTileK + kw0;
    if (key0 >= p1) continue;          // warp-uniform: no live key here
    const unsigned char* kt = smem_raw + (t % stages) * L.stage;
    const unsigned char* vt = kt + L.k_tile;
    const float* ksc = reinterpret_cast<const float*>(vt + L.v_tile);

    // scores of kKpw keys: n8 tile nt holds keys kw0 + 8 nt + n, n = group
    // in the B fragments. Every step of the largest head dim runs, with no
    // branch: a step past D reads inside the row and adds 0 (its q
    // fragment zero; over int8 rows its K bytes)
    float sc[kNK][4];
#pragma unroll
    for (int nt = 0; nt < kNK; ++nt) sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
    if constexpr (kInt8) {
      uint32_t kw[kNK][kMaxD / 16];    // the lane's D / 4 bytes of each row
#pragma unroll
      for (int nt = 0; nt < kNK; ++nt) {
        const uint32_t* src = reinterpret_cast<const uint32_t*>(
            kt + (size_t)(kw0 + 8 * nt + group) * L.ldk + quad * (D / 4));
#pragma unroll
        for (int w = 0; w < kMaxD / 16; ++w) kw[nt][w] = w < D / 16 ? src[w] : 0u;
      }
#pragma unroll
      for (int st = 0; st < kMaxSteps; ++st) {
        uint32_t ah[4], al[4];
        q_frags(min(st, nsteps - 1), ah, al);
        uint32_t b[kNK][2];
#pragma unroll
        for (int nt = 0; nt < kNK; ++nt) {
          b[nt][0] = i8_tf32(kw[nt][st >> 1], 2 * (st & 1));
          b[nt][1] = i8_tf32(kw[nt][st >> 1], 2 * (st & 1) + 1);
        }
#pragma unroll
        for (int nt = 0; nt < kNK; ++nt) mma_tf32(sc[nt], al, b[nt][0], b[nt][1]);
#pragma unroll
        for (int nt = 0; nt < kNK; ++nt) mma_tf32(sc[nt], ah, b[nt][0], b[nt][1]);
      }
    } else {
      const float* kf = reinterpret_cast<const float*>(kt);
#pragma unroll
      for (int st = 0; st < kMaxSteps; ++st) {
        const int sr = min(st, nsteps - 1);
        uint32_t ah[4], al[4];
        q_frags(sr, ah, al);
        if (st >= nsteps) {
#pragma unroll
          for (int e = 0; e < 4; ++e) ah[e] = al[e] = 0u;
        }
        float kb[kNK][2];
#pragma unroll
        for (int nt = 0; nt < kNK; ++nt) {
          const float2 x = *reinterpret_cast<const float2*>(
              kf + (size_t)(kw0 + 8 * nt + group) * L.ldk + 8 * sr + 2 * quad);
          kb[nt][0] = x.x;
          kb[nt][1] = x.y;
        }
        mma_3xtf32<kNK>(sc, ah, al, kb);
      }
    }

    // mask, scale (times the k scale over int8 rows), ALiBi at the key's
    // position, online softmax for row group (accumulators 0, 1 of each n8
    // tile: keys 2 quad, 2 quad + 1) and, past 8 query heads, row group + 8
    // (accumulators 2, 3)
    const float pos0 = (float)(key0 + 2 * quad);
    float f[kNK][2], pos[kNK][2];
    bool live[kNK][2];
#pragma unroll
    for (int nt = 0; nt < kNK; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int j = kw0 + 8 * nt + 2 * quad + e;
        const int key = p0 + t * kTileK + j;
        pos[nt][e] = pos0 + (float)(8 * nt + e);
        live[nt][e] = key < p1;
        if constexpr (kPaged)
          live[nt][e] = live[nt][e] && pid_s[(key - p0) / a.page] >= 0;
        f[nt][e] = a.scale_log2;
        if constexpr (kInt8) f[nt][e] *= ksc[j];
      }
    }
    float alpha[2] = {1.f, 1.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (h == 1 && !rows_hi) break;
      float tmax = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < kNK; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nt][2 * h + e];
          x = live[nt][e] ? fmaf(slope[h], pos[nt][e], x * f[nt][e])
                          : -INFINITY;
          tmax = fmaxf(tmax, x);
        }
      }
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
      tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
      const float m_new = fmaxf(m_row[h], tmax);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      alpha[h] = m_row[h] == -INFINITY ? 0.f : exp2f(m_row[h] - m_safe);
      m_row[h] = m_new;
      l_row[h] *= alpha[h];
#pragma unroll
      for (int nt = 0; nt < kNK; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[nt][2 * h + e];
          const float p = x == -INFINITY ? 0.f : exp2f(x - m_safe);
          l_row[h] += p;
          x = p;
          if constexpr (kInt8) x = p * ksc[kTileK + kw0 + 8 * nt + 2 * quad + e];
        }
      }
    }
#pragma unroll
    for (int i = 0; i < kMaxSteps; ++i) {
      o[i][0] *= alpha[0];
      o[i][1] *= alpha[0];
      o[i][2] *= alpha[1];
      o[i][3] *= alpha[1];
    }

    // O += P V, one k8 step a score tile: its accumulators are P's A
    // fragment (keys 2 quad, 2 quad + 1 at k positions quad, quad + 4)
#pragma unroll
    for (int j8 = 0; j8 < kNK; ++j8) {
      uint32_t ph[4], pl[4];
      split_tf32(sc[j8][0], ph[0], pl[0]);
      split_tf32(sc[j8][1], ph[2], pl[2]);
      ph[1] = pl[1] = ph[3] = pl[3] = 0u;
      if (rows_hi) {
        split_tf32(sc[j8][2], ph[1], pl[1]);
        split_tf32(sc[j8][3], ph[3], pl[3]);
      }
      const int r0 = kw0 + 8 * j8 + 2 * quad;   // the lane's two key rows
      if constexpr (kInt8) {
        // bytes [group * D / 8, (group + 1) * D / 8) of rows r0, r0 + 1:
        // n8 tile i's column group is dim group * D / 8 + i
        constexpr int kW = kMaxD / 32;          // words of D / 8 bytes
        const unsigned char* v0 = vt + (size_t)r0 * L.ldv + group * (D / 8);
        const unsigned char* v1 = v0 + L.ldv;
        uint32_t w0[kW], w1[kW];
        if ((D & 31) == 0) {
#pragma unroll
          for (int w = 0; w < kW; ++w) {
            w0[w] = w < D / 32 ? reinterpret_cast<const uint32_t*>(v0)[w] : 0u;
            w1[w] = w < D / 32 ? reinterpret_cast<const uint32_t*>(v1)[w] : 0u;
          }
        } else {                                // D / 8 bytes, 2-aligned
          const uint16_t* h0 = reinterpret_cast<const uint16_t*>(v0);
          const uint16_t* h1 = reinterpret_cast<const uint16_t*>(v1);
          const int nh = D / 16;
#pragma unroll
          for (int w = 0; w < kW; ++w) {
            w0[w] = (2 * w < nh ? (uint32_t)h0[2 * w] : 0u) |
                    (2 * w + 1 < nh ? (uint32_t)h0[2 * w + 1] << 16 : 0u);
            w1[w] = (2 * w < nh ? (uint32_t)h1[2 * w] : 0u) |
                    (2 * w + 1 < nh ? (uint32_t)h1[2 * w + 1] << 16 : 0u);
          }
        }
#pragma unroll
        for (int i = 0; i < kMaxSteps; ++i) {      // past D: bytes 0, adds 0
          const uint32_t b0 = i8_tf32(w0[i >> 2], i & 3);
          const uint32_t b1 = i8_tf32(w1[i >> 2], i & 3);
          mma_tf32(o[i], pl, b0, b1);
          mma_tf32(o[i], ph, b0, b1);
        }
      } else {
        // n8 tile i's column group is dim 8 i + group; the tiles past D
        // read the last one again (their accumulators are never written)
        const float* v0 =
            reinterpret_cast<const float*>(vt) + (size_t)r0 * L.ldv + group;
#pragma unroll
        for (int i0 = 0; i0 < kMaxSteps; i0 += 2) {
          float vb[2][2];
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int c = 8 * min(i0 + i, nsteps - 1);
            vb[i][0] = v0[c];
            vb[i][1] = v0[L.ldv + c];
          }
          mma_3xtf32<2>(o + i0, ph, pl, vb);
        }
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the stages are free: reuse them for the warp merge

  // merge the 4 warps' softmax states in shared memory
  float* o_w = reinterpret_cast<float*>(smem_raw);     // [kWarps][16][D]
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 1);
    l_row[h] += __shfl_xor_sync(0xffffffffu, l_row[h], 2);
    const int r = group + 8 * h;
    if (r >= gb) continue;
#pragma unroll
    for (int i = 0; i < kMaxSteps; ++i) {
      if (i >= nsteps) break;
      // column of accumulator e: 8 i + 2 quad + e, or over int8 rows
      // (2 quad + e) * D / 8 + i
      const int d0 = kInt8 ? 2 * quad * (D / 8) + i : 8 * i + 2 * quad;
      const int d1 = kInt8 ? d0 + D / 8 : d0 + 1;
      o_w[(warp * kMaxGroup + r) * D + d0] = o[i][2 * h];
      o_w[(warp * kMaxGroup + r) * D + d1] = o[i][2 * h + 1];
    }
    if (quad == 0) {
      m_w[warp][r] = m_row[h];
      l_w[warp][r] = l_row[h];
    }
  }
  __syncthreads();
  finish_split<float, M>(a, D, s, kh, g0, gb, split, map, o_w, m_w, l_w, sn_s,
                         last_s);
}

// Opts a kernel into `bytes` of dynamic shared memory, once per device and
// size (`set` holds the largest size set on each device).
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, size_t (&set)[64]) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (bytes > set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)bytes);
    if (err != cudaSuccess) return err;
    set[dev] = bytes;
  }
  return cudaSuccess;
}

template <int kMaxD, int kKpw, bool kPaged, bool kInt8, Mode M>
cudaError_t launch_f32_k(const Args& a, int S, int D, int splits, int stages,
                         size_t smem, cudaStream_t stream) {
  static size_t attr_set[64] = {};
  const cudaError_t err = allow_smem(
      split_kernel_f32<kMaxD, kKpw, kPaged, kInt8, M>, smem, attr_set);
  if (err != cudaSuccess) return err;
  const int chunks = (a.G + kMaxGroup - 1) / kMaxGroup;
  split_kernel_f32<kMaxD, kKpw, kPaged, kInt8, M>
      <<<dim3(S, a.KH * chunks, splits), kThreads, smem, stream>>>(a, D,
                                                                   stages);
  return cudaGetLastError();
}

// The fp32 body at head dim D (a multiple of 16 up to 256) with the plan's
// tile keys (32 or 64; int8 rows 64) and stages (2 or 3).
template <bool kPaged, bool kInt8, Mode M>
cudaError_t launch_f32(const Args& a, int S, int D, int splits, int tile,
                       int stages, cudaStream_t st) {
  if (D <= 0 || D > kMaxDim || D % 16 || (tile != 32 && tile != 64) ||
      (kInt8 && tile != 64) || stages < 2 || stages > 3)
    return cudaErrorInvalidValue;
  const size_t smem = F32Smem(D, a.G, tile, stages, kInt8).total;
  if (smem > kMaxDynSmem) return cudaErrorInvalidValue;
  const int md = D <= 64 ? 64 : D <= 128 ? 128 : 256;
#define TGI_F32_CASE(MD, KPW)                                            \
  if (md == MD && tile == 4 * KPW)                                       \
    return launch_f32_k<MD, KPW, kPaged, kInt8, M>(a, S, D, splits, stages, \
                                                   smem, st);
  TGI_F32_CASE(64, 16) TGI_F32_CASE(128, 16) TGI_F32_CASE(256, 16)
  if constexpr (!kInt8) {
    TGI_F32_CASE(64, 8) TGI_F32_CASE(128, 8) TGI_F32_CASE(256, 8)
  }
#undef TGI_F32_CASE
  return cudaErrorInvalidValue;
}

template <typename T, int D, bool kPaged, bool kInt8, Mode M>
cudaError_t launch(const Args& a, int S, int splits, cudaStream_t stream) {
  constexpr size_t smem = Layout<D, kInt8>::kBytes;
  // above 48 KB of dynamic shared memory: opt in once per device
  static size_t attr_set[64] = {};
  const cudaError_t err =
      allow_smem(split_kernel<T, D, kPaged, kInt8, M>, smem, attr_set);
  if (err != cudaSuccess) return err;
  const int chunks = (a.G + kMaxGroup - 1) / kMaxGroup;
  split_kernel<T, D, kPaged, kInt8, M>
      <<<dim3(S, a.KH * chunks, splits), kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, bool kPaged, bool kInt8, Mode M>
cudaError_t launch_d(const Args& a, int S, int D, int splits,
                     cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16, kPaged, kInt8, M>(a, S, splits, st);
    case 64: return launch<T, 64, kPaged, kInt8, M>(a, S, splits, st);
    case 80: return launch<T, 80, kPaged, kInt8, M>(a, S, splits, st);
    case 96: return launch<T, 96, kPaged, kInt8, M>(a, S, splits, st);
    case 128: return launch<T, 128, kPaged, kInt8, M>(a, S, splits, st);
    case 192: return launch<T, 192, kPaged, kInt8, M>(a, S, splits, st);
    case 256: return launch<T, 256, kPaged, kInt8, M>(a, S, splits, st);
    default: return cudaErrorInvalidValue;
  }
}

// Element types of q (and of rows that are not int8), as the entries take
// them: bf16 and fp16 on the mma body, fp32 on the 3xTF32 body.
enum DType { kBf16 = 0, kFp16 = 1, kFp32 = 2 };

// Checks what every entry shares and launches at the head dim D (16, 64, 80,
// 96, 128, 192 or 256 for bf16 / fp16; any multiple of 16 up to 256 for fp32)
// with q (and rows that are not int8) of element type `dtype`, over the
// wrapper's tile plan: `tile` keys a stage and `stages` (the mma body's are
// fixed: kTile, kStages).
template <bool kPaged, bool kInt8, Mode M>
int dispatch(const Args& a, int S, int D, int dtype, int splits, int tile,
             int stages, void* stream) {
  const long long chunks = (a.G + kMaxGroup - 1) / kMaxGroup;
  if (S <= 0 || a.KH <= 0 || a.G <= 0 || a.KH * chunks > 65535 ||
      splits <= 0 || splits > 65535 ||
      (splits > 1 && (!a.part || !a.arrivals)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype != kFp32 && (tile != kTile || stages != kStages))
    return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case kBf16:
      return (int)launch_d<__nv_bfloat16, kPaged, kInt8, M>(a, S, D, splits, st);
    case kFp16: return (int)launch_d<__half, kPaged, kInt8, M>(a, S, D, splits, st);
    case kFp32:
      return (int)launch_f32<kPaged, kInt8, M>(a, S, D, splits, tile, stages,
                                               st);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace decode_split
}  // namespace
