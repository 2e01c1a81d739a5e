// One-query decode attention over a paged KV pool, for sm_90a. Two kernels:
//
//   paged_split_kernel (bf16 pools; entries tgi_paged_decode and
//     tgi_paged_decode_stats), in two compile-time modes:
//       normalized: out[s, kh, g] = softmax(q . k) v over the slot's live keys
//       stats:      the unnormalized fp32 accumulator plus the softmax row max
//                   m and normalizer l, for a flash-decoding merge with keys
//                   held elsewhere (ctx == 0 gives m = -inf, l = 0, acc = 0)
//   paged_i8_kernel (K2; entry tgi_paged_decode_stats_i8): the stats mode
//     over int8 pools with f32 per-row-per-head scale pools (k_scale /
//     v_scale [KH, R], indexed by the same pool rows).
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
// that are not mapped hold the sentinel `num_pages`. Both kernels walk pages
// b = 0 .. min(ceil(ctx / page), max_pages) - 1 and SKIP any page id outside
// [0, num_pages): on the TPU the block index was clamped, on the GPU the
// sentinel would read out of bounds. m is written in natural-log units.
//
// What bounds it on an H100: a decode step reads every live K/V row once and
// does 4 * G * D flops per row (G <= 8), well under one flop per byte, so it
// is bound by bytes (3.35 TB/s): the design is about blocks and bytes in
// flight.
//
// paged_split_kernel design (flash-decoding in one launch):
//   - The grid is (S, KH, splits). A split covers a FIXED number of pages
//     (`pages_per_split`, chosen by the wrapper from the page size alone:
//     256 keys), so split boundaries sit at fixed positions and a slot's
//     result never depends on S or on the other slots (bit-identical
//     whatever the batch). A split past the slot's pages exits at once.
//   - A block reads its split's block-table entries into shared memory
//     first, then keeps K/V tiles of 64 keys in flight in a ring of
//     kStages stages: 16-byte cp.async copies, staged in bf16 (rows padded
//     to keep ldmatrix free of bank conflicts), dead keys (past ctx or on a
//     sentinel page) zero-filled by the copy itself; one block barrier per
//     tile.
//   - Each of the 4 warps takes 16 keys of a tile. Scores and the value
//     product run on mma.sync m16n8k16 (bf16 in, fp32 accumulate): the G
//     query heads are the A rows (padded to 16), K fragments come from
//     ldmatrix, V fragments from ldmatrix.trans, and the probabilities go
//     from the score accumulators to A fragments without leaving registers.
//     Each warp keeps its own online softmax (fp32, exp2 with the scale
//     folded in); the block merges its 4 warps in shared memory.
//   - A slot with one split writes its result directly. Otherwise each split
//     writes (acc, m, l) to the wrapper's fp32 scratch, fences, and bumps the
//     (slot, kv head)'s arrival counter; the block that arrives last merges
//     every split IN SPLIT ORDER (deterministic), writes the output or the
//     merged stats, and resets the counter to 0 for the next launch. One
//     launch per call, no memset.
// Still left: the G <= 8 query heads fill half of the mma's 16 rows; TMA
// instead of cp.async; K2 (below) does not share this design yet.
//
// paged_i8_kernel (K2) design: one block per (slot, kv head); the G query
// heads share each K/V row the block reads. Keys are staged in shared memory
// 32 at a time with 8-byte loads, widened to fp32 with each row's scale
// folded in (k * k_scale, v * v_scale: the same product as
// `_flash_page_update` with ks / vs, paged_attention.py:34-76, in another
// order); each thread scores (g, key) pairs, one warp per query head runs the
// online-softmax update, and each thread owns G*D/128 accumulator entries in
// fp32 registers. Its grid under-fills the card at 16 x 32 = 512 blocks of
// long serial walks; moving it onto the split design is its next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxGroup = 8;   // query heads per kv head handled by a block
constexpr float kLn2 = 0.6931471805599453f;

// --- paged_split_kernel (bf16 pools) ---------------------------------------

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 64;            // keys per stage, 16 per warp
constexpr int kStages = 3;           // tiles in flight
constexpr int kMaxSplitPages = 64;   // block-table entries a split reads

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int bytes) {
  const uint32_t dst = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
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

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

template <int D>
constexpr size_t split_smem_bytes() {
  return (size_t)2 * kStages * kTile * (D + 8) * sizeof(__nv_bfloat16);
}

// Writes one (slot, kv head)'s result: bf16 out, or acc / m (natural log) /
// l. `m2` is the merged max in log2 units.
template <int D, bool kStats>
__device__ __forceinline__ void write_result(void* out, float* m_out,
                                             float* l_out, size_t head, int g,
                                             int d, float acc, float m2,
                                             float l) {
  if (kStats) {
    static_cast<float*>(out)[(head + g) * D + d] = acc;
    if (d == 0) {
      m_out[head + g] = m2 == -INFINITY ? -INFINITY : m2 * kLn2;
      l_out[head + g] = l;
    }
  } else {
    static_cast<__nv_bfloat16*>(out)[(head + g) * D + d] =
        __float2bfloat16(acc / fmaxf(l, 1e-30f));
  }
}

template <int D, bool kStats>
__global__ void __launch_bounds__(kThreads)
paged_split_kernel(const __nv_bfloat16* __restrict__ q,       // [S, KH, G, D]
                   const __nv_bfloat16* __restrict__ k_pool,  // [KH, R, D]
                   const __nv_bfloat16* __restrict__ v_pool,  // [KH, R, D]
                   const int32_t* __restrict__ block_table,   // [S, maxp]
                   const int32_t* __restrict__ ctx_len,       // [S]
                   void* __restrict__ out,   // bf16 [S,KH,G,D] or f32 acc
                   float* __restrict__ m_out,                 // [S, KH, G]
                   float* __restrict__ l_out,                 // [S, KH, G]
                   float* __restrict__ part,  // [S, KH, splits, G, D + 2]
                   unsigned int* __restrict__ arrivals,       // [S * KH]
                   int KH, int G, int R, int page, int max_pages,
                   int num_pages, int pages_per_split, float scale_log2) {
  constexpr int kRow = D + 8;          // padded smem row (bf16)
  constexpr int kSteps = D / 16;       // k16 steps over the head dim
  constexpr int kOutTiles = D / 8;     // n8 tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* vs = ks + kStages * kTile * kRow;
  __shared__ int pid_s[kMaxSplitPages];
  __shared__ float m_w[kWarps][kMaxGroup], l_w[kWarps][kMaxGroup];
  __shared__ bool last_s;

  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = lane / 4;
  const int quad = lane % 4;

  const int n_pages = min((max(ctx_len[s], 0) + page - 1) / page, max_pages);
  const int ctx = min(max(ctx_len[s], 0), n_pages * page);
  const int n_splits = max(1, (n_pages + pages_per_split - 1) / pages_per_split);
  if (split >= n_splits) return;
  const int first_page = split * pages_per_split;
  const int p0 = first_page * page;                        // first position
  const int p1 = min(p0 + pages_per_split * page, ctx);    // past the last
  const int n_tiles = p1 > p0 ? (p1 - p0 + kTile - 1) / kTile : 0;

  // read ahead: the split's block-table entries (-1: not mapped)
  for (int i = tid; i < pages_per_split; i += kThreads) {
    int pid = -1;
    if (first_page + i < n_pages) {
      pid = block_table[(size_t)s * max_pages + first_page + i];
      if (pid < 0 || pid >= num_pages) pid = -1;
    }
    pid_s[i] = pid;
  }
  __syncthreads();

  const __nv_bfloat16* kbase = k_pool + (size_t)kh * R * D;
  const __nv_bfloat16* vbase = v_pool + (size_t)kh * R * D;
  auto load_tile = [&](int t, int st) {
    for (int idx = tid; idx < kTile * (D / 8); idx += kThreads) {
      const int j = idx / (D / 8);
      const int c = (idx % (D / 8)) * 8;
      const int p = p0 + t * kTile + j;
      const __nv_bfloat16* ksrc = kbase;
      const __nv_bfloat16* vsrc = vbase;
      int bytes = 0;                    // 0: the copy zero-fills the row
      if (p < p1) {
        const int pid = pid_s[(p - p0) / page];
        if (pid >= 0) {
          const size_t off = ((size_t)pid * page + (p - p0) % page) * D + c;
          ksrc = kbase + off;
          vsrc = vbase + off;
          bytes = 16;
        }
      }
      const int dst = (st * kTile + j) * kRow + c;
      cp_async_16(ks + dst, ksrc, bytes);
      cp_async_16(vs + dst, vsrc, bytes);
    }
  };
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < n_tiles) load_tile(t, t);
    cp_async_commit();
  }

  // q as A fragments: rows are the query heads (group < G), rows 8-15 zero
  uint32_t qa[kSteps][4];
  {
    const __nv_bfloat16* qrow = q + (((size_t)s * KH + kh) * G + group) * D;
#pragma unroll
    for (int st = 0; st < kSteps; ++st) {
      const int c = st * 16 + quad * 2;
      qa[st][0] = group < G ? *reinterpret_cast<const uint32_t*>(qrow + c) : 0u;
      qa[st][2] = group < G ? *reinterpret_cast<const uint32_t*>(qrow + c + 8)
                            : 0u;
      qa[st][1] = qa[st][3] = 0u;
    }
  }
  float o[kOutTiles][4];
#pragma unroll
  for (int t = 0; t < kOutTiles; ++t) o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m_row = -INFINITY;   // this lane's row is query head `group`
  float l_row = 0.f;         // this lane's partial row sum

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();
    __syncthreads();   // tile t landed; every warp is done with tile t - 1
    if (t + kStages - 1 < n_tiles) load_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    cp_async_commit();
    const int key0 = p0 + t * kTile + warp * 16;
    if (key0 >= p1) continue;          // warp-uniform: no live key here
    const int st = t % kStages;
    const __nv_bfloat16* kt = ks + (st * kTile + warp * 16) * kRow;
    const __nv_bfloat16* vt = vs + (st * kTile + warp * 16) * kRow;

    // scores of 16 keys: two n8 tiles; ldmatrix rows are keys
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
#pragma unroll
    for (int st2 = 0; st2 < kSteps; ++st2) {
      uint32_t b[4];
      ldmatrix_x4(b, kt + ((lane / 16) * 8 + lane % 8) * kRow + st2 * 16 +
                         ((lane / 8) & 1) * 8);
      mma_bf16(sc[0], qa[st2], b[0], b[1]);
      mma_bf16(sc[1], qa[st2], b[2], b[3]);
    }

    // mask, scale, online softmax for row `group` (elements 0, 1 of a tile)
    float tmax = -INFINITY;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = key0 + n * 8 + quad * 2 + e;
        const bool live = key < p1 && pid_s[(key - p0) / page] >= 0;
        sc[n][e] = live ? sc[n][e] * scale_log2 : -INFINITY;
        tmax = fmaxf(tmax, sc[n][e]);
      }
    }
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
    tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
    const float m_new = fmaxf(m_row, tmax);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = m_row == -INFINITY ? 0.f : exp2f(m_row - m_safe);
    m_row = m_new;
    l_row *= alpha;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const float p = sc[n][e] == -INFINITY ? 0.f : exp2f(sc[n][e] - m_safe);
        sc[n][e] = p;
        l_row += p;
      }
    }
#pragma unroll
    for (int t2 = 0; t2 < kOutTiles; ++t2) {
      o[t2][0] *= alpha;
      o[t2][1] *= alpha;
    }

    // O += P V: P as the A fragment (rows 8-15 zero), V by ldmatrix.trans
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), 0u,
                            pack_bf16(sc[1][0], sc[1][1]), 0u};
#pragma unroll
    for (int n2 = 0; n2 < D / 16; ++n2) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, vt + (((lane / 8) & 1) * 8 + lane % 8) * kRow +
                               n2 * 16 + (lane / 16) * 8);
      mma_bf16(o[2 * n2], pa, b[0], b[1]);
      mma_bf16(o[2 * n2 + 1], pa, b[2], b[3]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();   // the stages are free: reuse them for the warp merge

  // merge the 4 warps' softmax states in shared memory
  l_row += __shfl_xor_sync(0xffffffffu, l_row, 1);
  l_row += __shfl_xor_sync(0xffffffffu, l_row, 2);
  float* o_w = reinterpret_cast<float*>(smem_raw);     // [kWarps][8][D]
  if (group < G) {
#pragma unroll
    for (int t2 = 0; t2 < kOutTiles; ++t2) {
      const int d = t2 * 8 + quad * 2;
      o_w[(warp * kMaxGroup + group) * D + d] = o[t2][0];
      o_w[(warp * kMaxGroup + group) * D + d + 1] = o[t2][1];
    }
    if (quad == 0) {
      m_w[warp][group] = m_row;
      l_w[warp][group] = l_row;
    }
  }
  __syncthreads();

  const size_t sk = (size_t)s * KH + kh;
  const int splits = gridDim.z;
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mx = -INFINITY;
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
    if (n_splits == 1) {
      write_result<D, kStats>(out, m_out, l_out, sk * G, g, d, acc, mx, l);
    } else {
      float* row = part + ((sk * splits + split) * G + g) * (D + 2);
      row[d] = acc;
      if (d == 0) {
        row[D] = mx;
        row[D + 1] = l;
      }
    }
  }
  if (n_splits == 1) return;

  // the last split of this (slot, kv head) to arrive merges them all
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    const unsigned int prev = atomicAdd(&arrivals[sk], 1u);
    last_s = prev == (unsigned int)(n_splits - 1);
    if (last_s) arrivals[sk] = 0u;     // ready for the next launch
  }
  __syncthreads();
  if (!last_s) return;
  __threadfence();
  const float* base = part + sk * splits * G * (D + 2);
  for (int i = tid; i < G * D; i += kThreads) {
    const int g = i / D;
    const int d = i % D;
    float mx = -INFINITY;
    for (int sp = 0; sp < n_splits; ++sp)
      mx = fmaxf(mx, __ldcg(base + (sp * G + g) * (D + 2) + D));
    const float m_safe = mx == -INFINITY ? 0.f : mx;
    float acc = 0.f, l = 0.f;
    for (int sp = 0; sp < n_splits; ++sp) {
      const float* row = base + (sp * G + g) * (D + 2);
      const float m = __ldcg(row + D);
      const float wt = m == -INFINITY ? 0.f : exp2f(m - m_safe);
      acc += wt * __ldcg(row + d);
      l += wt * __ldcg(row + D + 1);
    }
    write_result<D, kStats>(out, m_out, l_out, sk * G, g, d, acc, mx, l);
  }
}

template <int D, bool kStats>
cudaError_t launch_split(const void* q, const void* k_pool, const void* v_pool,
                         const int32_t* block_table, const int32_t* ctx,
                         void* out, float* m_out, float* l_out, float* part,
                         unsigned int* arrivals, int S, int KH, int G, int R,
                         int page, int max_pages, int num_pages,
                         int pages_per_split, int splits, float scale,
                         cudaStream_t stream) {
  constexpr size_t smem = split_smem_bytes<D>();
  // above 48 KB of dynamic shared memory: opt in once per device
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(paged_split_kernel<D, kStats>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  const dim3 grid(S, KH, splits);
  paged_split_kernel<D, kStats><<<grid, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k_pool),
      static_cast<const __nv_bfloat16*>(v_pool), block_table, ctx, out, m_out,
      l_out, part, arrivals, KH, G, R, page, max_pages, num_pages,
      pages_per_split, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

template <bool kStats>
int dispatch_split(const void* q, const void* k_pool, const void* v_pool,
                   const int32_t* block_table, const int32_t* ctx, void* out,
                   float* m_out, float* l_out, float* part,
                   unsigned int* arrivals, int S, int KH, int G, int D, int R,
                   int page, int max_pages, int num_pages, int pages_per_split,
                   int splits, float scale, void* stream) {
  if (S <= 0 || KH <= 0 || G <= 0 || G > kMaxGroup || page <= 0 ||
      max_pages <= 0 || pages_per_split <= 0 ||
      pages_per_split > kMaxSplitPages || splits <= 0 || splits > 65535 ||
      (long long)splits * pages_per_split < max_pages ||
      (splits > 1 && (!part || !arrivals)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_split<64, kStats>(
        q, k_pool, v_pool, block_table, ctx, out, m_out, l_out, part,
        arrivals, S, KH, G, R, page, max_pages, num_pages, pages_per_split,
        splits, scale, st);
  if (D == 128)
    return (int)launch_split<128, kStats>(
        q, k_pool, v_pool, block_table, ctx, out, m_out, l_out, part,
        arrivals, S, KH, G, R, page, max_pages, num_pages, pages_per_split,
        splits, scale, st);
  return (int)cudaErrorInvalidValue;
}

// --- paged_i8_kernel (K2: int8 pools, stats mode) --------------------------

constexpr int kKeys = 32;      // keys staged per tile

template <int D>
__global__ void __launch_bounds__(kThreads)
paged_i8_kernel(const __nv_bfloat16* __restrict__ q,       // [S, KH, G, D]
                const int8_t* __restrict__ k_pool,         // [KH, R, D]
                const int8_t* __restrict__ v_pool,         // [KH, R, D]
                const float* __restrict__ k_scale,         // [KH, R]
                const float* __restrict__ v_scale,         // [KH, R]
                const int32_t* __restrict__ block_table,   // [S, maxp]
                const int32_t* __restrict__ ctx_len,       // [S]
                float* __restrict__ acc_out,               // [S, KH, G, D]
                float* __restrict__ m_out,                 // [S, KH, G]
                float* __restrict__ l_out,                 // [S, KH, G]
                int KH, int G, int R, int page, int max_pages,
                int num_pages, float scale_log2) {
  constexpr int kStride = D + 1;                  // padded smem row
  constexpr int kOutPerThread = kMaxGroup * D / kThreads;
  __shared__ float qs[kMaxGroup * D];
  __shared__ float ks[kKeys * kStride];
  __shared__ float vs[kKeys * kStride];
  __shared__ float ps[kMaxGroup * kKeys];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];

  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ctx = ctx_len[s];
  const size_t head_off = ((size_t)s * KH + kh) * G;   // row of [S*KH*G]

  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = __bfloat162float(q[head_off * D + i]) * scale_log2;
  if (tid < kMaxGroup) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kOutPerThread];
#pragma unroll
  for (int i = 0; i < kOutPerThread; ++i) acc[i] = 0.f;

  int n_pages = ctx > 0 ? (ctx + page - 1) / page : 0;
  n_pages = min(n_pages, max_pages);
  const size_t pool_off = (size_t)kh * R * D;

  for (int b = 0; b < n_pages; ++b) {
    const int pid = block_table[(size_t)s * max_pages + b];
    if (pid < 0 || pid >= num_pages) continue;   // sentinel: not mapped
    for (int c0 = 0; c0 < page && b * page + c0 < ctx; c0 += kKeys) {
      __syncthreads();   // previous tile consumed (and qs / stats ready)
      for (int idx = tid; idx < kKeys * D / 8; idx += kThreads) {
        const int j = idx / (D / 8);
        const int c = (idx % (D / 8)) * 8;
        const int in_page = c0 + j;
        const bool live = in_page < page && b * page + in_page < ctx;
        float kf[8], vf[8];
        if (live) {
          const size_t row = (size_t)pid * page + in_page;
          const size_t off = pool_off + row * D + c;
          const uint2 kraw = *reinterpret_cast<const uint2*>(k_pool + off);
          const uint2 vraw = *reinterpret_cast<const uint2*>(v_pool + off);
          const float ksc = k_scale[(size_t)kh * R + row];
          const float vsc = v_scale[(size_t)kh * R + row];
          const int8_t* k8 = reinterpret_cast<const int8_t*>(&kraw);
          const int8_t* v8 = reinterpret_cast<const int8_t*>(&vraw);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kf[e] = (float)k8[e] * ksc;
            vf[e] = (float)v8[e] * vsc;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 8; ++e) { kf[e] = 0.f; vf[e] = 0.f; }
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          ks[j * kStride + c + e] = kf[e];
          vs[j * kStride + c + e] = vf[e];
        }
      }
      __syncthreads();

      // scores: thread -> key j = lane, query heads g = warp, warp + 4, ...
      {
        const int j = lane;
        const int in_page = c0 + j;
        const bool live = in_page < page && b * page + in_page < ctx;
        for (int g = warp; g < G; g += kWarps) {
          float dot = 0.f;
          const float* qg = qs + g * D;
          const float* kr = ks + j * kStride;
#pragma unroll 16
          for (int d = 0; d < D; ++d) dot += qg[d] * kr[d];
          ps[g * kKeys + j] = live ? dot : -INFINITY;
        }
      }
      __syncthreads();

      // online-softmax update: one warp per query head, lane = key
      for (int g = warp; g < G; g += kWarps) {
        const float sc = ps[g * kKeys + lane];
        float cmax = sc;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          cmax = fmaxf(cmax, __shfl_xor_sync(0xffffffffu, cmax, off));
        const float m_prev = m_s[g];
        const float m_new = fmaxf(m_prev, cmax);
        const float m_safe = (m_new == -INFINITY) ? 0.f : m_new;
        const float p = (sc == -INFINITY) ? 0.f : exp2f(sc - m_safe);
        float psum = p;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          psum += __shfl_xor_sync(0xffffffffu, psum, off);
        const float alpha = (m_prev == -INFINITY) ? 0.f : exp2f(m_prev - m_safe);
        ps[g * kKeys + lane] = p;
        __syncwarp();
        if (lane == 0) {
          l_s[g] = l_s[g] * alpha + psum;
          m_s[g] = m_new;
          alpha_s[g] = alpha;
        }
      }
      __syncthreads();

      // value product: thread owns outputs o = tid + i * 128 of [G, D]
#pragma unroll
      for (int i = 0; i < kOutPerThread; ++i) {
        const int o = tid + i * kThreads;
        if (o < G * D) {
          const int g = o / D;
          const int d = o % D;
          float a = acc[i] * alpha_s[g];
          const float* pg = ps + g * kKeys;
#pragma unroll 8
          for (int j = 0; j < kKeys; ++j) a += pg[j] * vs[j * kStride + d];
          acc[i] = a;
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < kOutPerThread; ++i) {
    const int o = tid + i * kThreads;
    if (o < G * D) acc_out[head_off * D + o] = acc[i];
  }
  if (tid < G) {
    // m is kept in log2 units (scale_log2 folded into q): back to natural
    m_out[head_off + tid] = m_s[tid] == -INFINITY ? -INFINITY : m_s[tid] * kLn2;
    l_out[head_off + tid] = l_s[tid];
  }
}

template <int D>
cudaError_t launch_i8(const void* q, const void* k_pool, const void* v_pool,
                      const float* k_scale, const float* v_scale,
                      const int32_t* block_table, const int32_t* ctx,
                      float* acc, float* m_out, float* l_out, int S, int KH,
                      int G, int R, int page, int max_pages, int num_pages,
                      float scale, cudaStream_t stream) {
  const dim3 grid(S, KH);
  paged_i8_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const int8_t*>(k_pool), static_cast<const int8_t*>(v_pool),
      k_scale, v_scale, block_table, ctx, acc, m_out, l_out, KH, G, R, page,
      max_pages, num_pages, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

// part: [S, KH, splits, G, D + 2] f32 scratch; arrivals: [S * KH] uint32,
// all zero (the kernel leaves them zero). Both may be null when splits == 1.
extern "C" int tgi_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const int32_t* block_table,
                                const int32_t* ctx, void* out, float* part,
                                unsigned int* arrivals, int S, int KH, int G,
                                int D, int R, int page, int max_pages,
                                int num_pages, int pages_per_split, int splits,
                                float scale, void* stream) {
  return dispatch_split<false>(q, k_pool, v_pool, block_table, ctx, out,
                               nullptr, nullptr, part, arrivals, S, KH, G, D,
                               R, page, max_pages, num_pages, pages_per_split,
                               splits, scale, stream);
}

extern "C" int tgi_paged_decode_stats(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const int32_t* block_table,
                                      const int32_t* ctx, float* acc,
                                      float* m_out, float* l_out, float* part,
                                      unsigned int* arrivals, int S, int KH,
                                      int G, int D, int R, int page,
                                      int max_pages, int num_pages,
                                      int pages_per_split, int splits,
                                      float scale, void* stream) {
  return dispatch_split<true>(q, k_pool, v_pool, block_table, ctx, acc, m_out,
                              l_out, part, arrivals, S, KH, G, D, R, page,
                              max_pages, num_pages, pages_per_split, splits,
                              scale, stream);
}

// stats mode over int8 pools: k_scale / v_scale are the layer's [KH, R] f32
// scale pools
extern "C" int tgi_paged_decode_stats_i8(const void* q, const void* k_pool,
                                         const void* v_pool,
                                         const float* k_scale,
                                         const float* v_scale,
                                         const int32_t* block_table,
                                         const int32_t* ctx, float* acc,
                                         float* m_out, float* l_out, int S,
                                         int KH, int G, int D, int R, int page,
                                         int max_pages, int num_pages,
                                         float scale, void* stream) {
  if (S <= 0 || KH <= 0 || G <= 0 || G > kMaxGroup || page <= 0 ||
      max_pages <= 0 || !k_scale || !v_scale)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch_i8<64>(q, k_pool, v_pool, k_scale, v_scale,
                              block_table, ctx, acc, m_out, l_out, S, KH, G,
                              R, page, max_pages, num_pages, scale, st);
  if (D == 128)
    return (int)launch_i8<128>(q, k_pool, v_pool, k_scale, v_scale,
                               block_table, ctx, acc, m_out, l_out, S, KH, G,
                               R, page, max_pages, num_pages, scale, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tgi_paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
