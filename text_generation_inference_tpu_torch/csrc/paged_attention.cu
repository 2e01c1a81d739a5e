// One-query decode attention over a paged KV pool, for sm_90a. One kernel
// body, `decode_split::split_kernel` (csrc/decode_split.cuh, which holds the
// design, the shapes it takes and what bounds it), in three entries:
//
//   tgi_paged_decode           pools in q's dtype (bf16 or fp16), normalized:
//                              out[s, kh, g] = softmax(q . k) v over the
//                              slot's live keys
//   tgi_paged_decode_stats     the same pools, stats: the unnormalized fp32
//                              accumulator plus the softmax row max m and
//                              normalizer l, for a flash-decoding merge with
//                              keys held elsewhere (ctx == 0 gives m = -inf,
//                              l = 0, acc = 0)
//   tgi_paged_decode_stats_i8  K2: the stats mode over int8 pools with f32
//                              per-row-per-head scale pools (k_scale /
//                              v_scale [KH, R], indexed by the same pool rows)
//
// Every entry takes `dtype`, the element type of q and of pools that are not
// int8: 0 bf16, 1 fp16 (the mma body), 2 fp32 (the 3xTF32 body,
// `split_kernel_f32`; K2 then takes fp32 q over its int8 pools), and
// `slopes`, [KH, G] f32 ALiBi slopes or null: slope * p joins the scaled
// score of the key at sequence position p (the JAX package sends ALiBi to
// the kernel's plain twin, models/paged_core.py:152,276; here it is one FMA
// a score).
//
// Replaces: the JAX package's ops/pallas/paged_attention.py
//   normalized: paged_decode_attention (`_kernel_all_heads` +
//               `_flash_page_update`, pallas_call at :261);
//   stats:      paged_decode_attention_partial (`_kernel_all_heads_stats`,
//               :319) and paged_decode_attention_partial_stacked
//               (`_kernel_all_heads_stats_stacked`, :407): the caller passes
//               the layer's pool view `pools[layer]`, which is free in torch;
//   int8 stats: the same call with scale pools
//               (`_kernel_all_heads_stats_stacked_i8`, :153, pallas_call :407).
//
// Pools are [KH, P * page, D] (head-major, as in the JAX package); the block
// table [S, max_pages] names each slot's pages in position order; entries
// that are not mapped hold the sentinel `num_pages`. The kernel walks pages
// b = 0 .. min(ceil(ctx / page), max_pages) - 1 and SKIPS any page id outside
// [0, num_pages): on the TPU the block index was clamped, on the GPU the
// sentinel would read out of bounds. A split covers `pages_per_split` pages,
// chosen by the wrapper from the page size alone (256 keys), so a slot's
// result is the same at any batch size.
//
// Still left: at G = 1 the query heads fill 1 of the mma's 16 rows; TMA
// instead of cp.async.

#include "decode_split.cuh"

namespace {

using decode_split::Args;

// Checks the paged entries share and fills their arguments.
bool paged_args(Args& a, const void* q, const void* k_pool, const void* v_pool,
                const int32_t* block_table, const int32_t* ctx,
                const float* slopes, void* out,
                float* m_out, float* l_out, float* part,
                unsigned int* arrivals, int KH, int G, int R, int page,
                int max_pages, int num_pages, int pages_per_split, int splits,
                float scale) {
  if (page <= 0 || max_pages <= 0 || R <= 0 || R % page ||
      pages_per_split <= 0 || pages_per_split > decode_split::kMaxSplitPages ||
      (long long)splits * pages_per_split < max_pages)
    return false;
  a = Args{};
  a.q = q;
  a.k = k_pool;
  a.v = v_pool;
  a.block_table = block_table;
  a.ctx = ctx;
  a.slopes = slopes;
  a.out = out;
  a.m_out = m_out;
  a.l_out = l_out;
  a.part = part;
  a.arrivals = arrivals;
  a.KH = KH;
  a.G = G;
  a.R = R;
  a.page = page;
  a.max_pages = max_pages;
  a.num_pages = num_pages;
  a.pages_per_split = pages_per_split;
  a.scale_log2 = scale * 1.4426950408889634f;
  return true;
}

}  // namespace

// part: [S, KH * chunks, splits, min(G, 16), D + 2] f32 scratch, chunks =
// ceil(G / 16); arrivals: [S * KH * chunks] uint32, all zero (the kernel
// leaves them zero). Both may be null when splits == 1. tile, stages: the
// wrapper's tile plan (ops/cuda/paged_attention.py `tile_plan`).
extern "C" int tgi_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const int32_t* block_table,
                                const int32_t* ctx, const float* slopes,
                                void* out, float* part,
                                unsigned int* arrivals, int S, int KH, int G,
                                int D, int R, int page, int max_pages,
                                int num_pages, int pages_per_split, int splits,
                                int tile, int stages, int dtype, float scale,
                                void* stream) {
  Args a;
  if (!paged_args(a, q, k_pool, v_pool, block_table, ctx, slopes, out, nullptr,
                  nullptr, part, arrivals, KH, G, R, page, max_pages,
                  num_pages, pages_per_split, splits, scale))
    return (int)cudaErrorInvalidValue;
  return decode_split::dispatch<true, false, decode_split::kOut>(
      a, S, D, dtype, splits, tile, stages, stream);
}

extern "C" int tgi_paged_decode_stats(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const int32_t* block_table,
                                      const int32_t* ctx, const float* slopes,
                                      float* acc,
                                      float* m_out, float* l_out, float* part,
                                      unsigned int* arrivals, int S, int KH,
                                      int G, int D, int R, int page,
                                      int max_pages, int num_pages,
                                      int pages_per_split, int splits,
                                      int tile, int stages, int dtype,
                                      float scale, void* stream) {
  Args a;
  if (!paged_args(a, q, k_pool, v_pool, block_table, ctx, slopes, acc, m_out,
                  l_out, part, arrivals, KH, G, R, page, max_pages, num_pages,
                  pages_per_split, splits, scale))
    return (int)cudaErrorInvalidValue;
  return decode_split::dispatch<true, false, decode_split::kStats>(
      a, S, D, dtype, splits, tile, stages, stream);
}

// K2: the stats mode over int8 pools; k_scale / v_scale are the layer's
// [KH, R] f32 scale pools
extern "C" int tgi_paged_decode_stats_i8(
    const void* q, const void* k_pool, const void* v_pool,
    const float* k_scale, const float* v_scale, const int32_t* block_table,
    const int32_t* ctx, const float* slopes, float* acc, float* m_out,
    float* l_out, float* part,
    unsigned int* arrivals, int S, int KH, int G, int D, int R, int page,
    int max_pages, int num_pages, int pages_per_split, int splits, int tile,
    int stages, int dtype, float scale, void* stream) {
  Args a;
  if (!k_scale || !v_scale ||
      !paged_args(a, q, k_pool, v_pool, block_table, ctx, slopes, acc, m_out,
                  l_out, part, arrivals, KH, G, R, page, max_pages, num_pages,
                  pages_per_split, splits, scale))
    return (int)cudaErrorInvalidValue;
  a.k_scale = k_scale;
  a.v_scale = v_scale;
  return decode_split::dispatch<true, true, decode_split::kStats>(
      a, S, D, dtype, splits, tile, stages, stream);
}

extern "C" const char* tgi_paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
