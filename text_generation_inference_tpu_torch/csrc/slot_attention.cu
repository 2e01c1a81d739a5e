// One-query decode attention over the slot KV cache, for sm_90a. Two entry
// points:
//   tgi_slot_decode  S1: out[s, kh, g] = softmax(q . k) v over cache rows
//                    in [lo[s], ctx[s]) (lo null: from row 0; a sliding
//                    window W gives lo = ctx - W, as the JAX model's decode
//                    mask; the Pallas kernel takes no window), with slope *
//                    row added to each scaled score given ALiBi slopes
//                    ([KH, G] f32, or null; the JAX rule sends ALiBi to its
//                    einsum, ops/attention.py:67); the split
//                    body of csrc/decode_split.cuh (its
//                    design, the shapes it takes and what bounds it are
//                    written there) with the slot cache as its row source:
//                    fixed 256-row splits of T, cp.async stages, mma.sync,
//                    the splits merged in split order in the same launch
//   tgi_ring_decode  S2: the same softmax over three sources at once: cache
//                    rows < ctx[s] (ctx = the chunk's start position),
//                    ring-buffer columns < step, and the current token's k/v
//                    (no ALiBi: its one caller, the decode probe, serves
//                    none); the split body in its ring mode, one launch
//
// Replaces: the JAX package's
//   ops/pallas/decode_attention.py      decode_attention (`_kernel`,
//                                       pallas_call at :142), S1;
//   ops/pallas/ring_decode_attention.py ring_decode_attention (`_kernel`,
//                                       pallas_call at :239), S2.
//
// Layouts (the JAX layouts): q [S, KH, G, D] in T (the entry's `dtype`:
// 0 bf16, 1 fp16, 2 fp32, the last on the split body's 3xTF32 kernel); the
// cache k/v [S, KH, T, D] in T with the head
// dim contiguous and any strides over S, KH and T (a layer view
// `cache.k[l]`, or a view narrowed to the first T rows of a longer cache,
// costs no copy); ring buffers [S, KH, C, D] and the current k/v [S, KH, D]
// in T, contiguous; ctx [S] int32; out [S, KH, G, D] in T. A slot with
// ctx == 0 and no ring source gives 0 (the JAX kernel clamps the denominator
// at 1e-30; its XLA reference gives NaN). Rows at or past ctx are never read.
//
// S2's design: the ring columns < step are one more row source of the split
// body, split as the cache (rows_per_split columns a split) into grid splits
// after the cache's. Every live split of either source writes its (acc, m,
// l); the last to arrive merges the cache's splits, then the ring's, in
// order, folds in the current token (its score one warp sum a query head)
// and normalizes. So the ring's scores and values run on the split body's
// tensor-core path, in parallel with the cache's splits, and S2 is one
// launch.

#include "decode_split.cuh"

namespace {

constexpr int kMaxRing = 1024;   // ring-buffer columns

bool slot_args(decode_split::Args& a, const void* q, const void* k,
               const void* v, const int32_t* ctx, const int32_t* lo,
               const float* slopes, void* out, float* part,
               unsigned int* arrivals, int KH, int G, int T, long long st_s,
               long long st_k, long long st_t, int rows_per_split, int splits,
               float scale) {
  if (T <= 0 || rows_per_split <= 0 ||
      (long long)splits * rows_per_split < T || st_s % 8 || st_k % 8 ||
      st_t % 8)
    return false;
  a = decode_split::Args{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.ctx = ctx;
  a.lo = lo;
  a.slopes = slopes;
  a.out = out;
  a.part = part;
  a.arrivals = arrivals;
  a.KH = KH;
  a.G = G;
  a.st_s = st_s;
  a.st_k = st_k;
  a.st_t = st_t;
  a.T = T;
  a.rows_per_split = rows_per_split;
  a.scale_log2 = scale * 1.4426950408889634f;
  return true;
}

}  // namespace

// S1: the split body of csrc/decode_split.cuh over the slot cache. lo:
// [S] int32 first live row of each slot, or null for 0 (a row below it is
// never read; the splits are numbered from the one that holds it). slopes:
// [KH, G] f32 ALiBi slopes, or null. part:
// [S, KH * chunks, splits, min(G, 16), D + 2] f32 scratch, chunks =
// ceil(G / 16); arrivals: [S * KH * chunks] uint32, all zero (the kernel
// leaves them zero); both may be null when splits == 1. Strides are in
// elements. tile, stages: the wrapper's tile plan.
extern "C" int tgi_slot_decode(const void* q, const void* k, const void* v,
                               const int32_t* ctx, const int32_t* lo,
                               const float* slopes, void* out, float* part,
                               unsigned int* arrivals, int S, int KH, int G,
                               int D, int T, long long st_s, long long st_k,
                               long long st_t, int rows_per_split, int splits,
                               int tile, int stages, int dtype, float scale,
                               void* stream) {
  decode_split::Args a;
  if (!slot_args(a, q, k, v, ctx, lo, slopes, out, part, arrivals, KH, G, T,
                 st_s, st_k, st_t, rows_per_split, splits, scale))
    return (int)cudaErrorInvalidValue;
  return decode_split::dispatch<false, false, decode_split::kOut>(
      a, S, D, dtype, splits, tile, stages, stream);
}

// S2: kbuf / vbuf [S, KH, C, D], k_new / v_new [S, KH, D]; ring columns <
// step are live. The grid's splits are the cache's `cache_splits` (S1's
// plan over T), then the ring's `ring_splits` (the same rows_per_split over
// C); part: [S, KH * chunks, cache_splits + ring_splits, min(G, 16), D + 2]
// f32 scratch and arrivals as S1's, both required.
extern "C" int tgi_ring_decode(const void* q, const void* k, const void* v,
                               const int32_t* ctx, const void* kbuf,
                               const void* vbuf, const void* k_new,
                               const void* v_new, void* out, float* part,
                               unsigned int* arrivals, int S, int KH, int G,
                               int D, int T, long long st_s, long long st_k,
                               long long st_t, int rows_per_split,
                               int cache_splits, int ring_splits, int C,
                               int step, int tile, int stages, int dtype,
                               float scale, void* stream) {
  decode_split::Args a;
  if (C <= 0 || C > kMaxRing || step < 0 || step > C || cache_splits <= 0 ||
      ring_splits <= 0 || (long long)ring_splits * rows_per_split < C ||
      !kbuf || !vbuf || !k_new || !v_new || !part || !arrivals ||
      ((uintptr_t)kbuf | (uintptr_t)vbuf) % 16 ||
      !slot_args(a, q, k, v, ctx, nullptr, nullptr, out, part, arrivals, KH,
                 G, T, st_s, st_k, st_t, rows_per_split, cache_splits, scale))
    return (int)cudaErrorInvalidValue;
  a.kr = kbuf;
  a.vr = vbuf;
  a.k_new = k_new;
  a.v_new = v_new;
  a.C = C;
  a.step = step;
  a.cache_splits = cache_splits;
  return decode_split::dispatch<false, false, decode_split::kRing>(
      a, S, D, dtype, cache_splits + ring_splits, tile, stages, stream);
}

extern "C" const char* tgi_slot_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
