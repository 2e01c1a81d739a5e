// Causal flash attention over right-padded prefill buckets, for sm_90a.
//
// Replaces: the JAX package's ops/pallas/flash_prefill.py
//           flash_prefill (the Pallas `_kernel`, pallas_call at :143).
//
// q, k, v and out are bf16 or fp16 (the entry's `dtype` 0 or 1: the wgmma
// kernel, templated on the element type T; only the wgmma type, the tensor
// maps' type and the rounding of P and of the output differ), or fp32
// (`dtype` 2: `flash_prefill_f32_kernel`, mma.sync in 3xTF32, at the end of
// this file).
//
// Computes, per (sequence n, kv head kh, query head g of the kv group):
//   out[n, i, kh, g] = softmax_j(q[n, i, kh, g] . k[n, j, kh] * scale) v[n, j, kh]
// over keys j <= i and j < lengths[n], and with a sliding window W > 0 (the
// entry's `window`; 0 is none) only over keys j > i - W for the real query
// rows (i < lengths[n]), as the JAX model's mask (models/core.py prefill; the
// Pallas kernel takes no window). With ALiBi slopes (the entry's `slopes`,
// [KH, G] f32, null for none) the scaled score of key j for query row i
// takes slope[kh, g] * (j - i): the JAX model's bias slope * j less a
// constant a row, which the softmax cancels (the JAX rule sends ALiBi to its
// einsum; here it is one FMA a score). Padded query rows (i >= lengths[n]) still
// attend over every live key (causally); rows of a sequence with lengths[n]
// == 0 give 0; value rows at or past the length are zeroed before the product
// (as the Pallas kernel does at flash_prefill.py:79-83: the padding may hold
// NaN, and P = 0 does not cancel it).
//
// What bounds it on an H100: at prefill lengths (128..2048) the causal score
// and value products are ~T^2/2 * H * D * 4 flops against O(T*H*D) bytes, so
// it is bound by operations: 989 TFLOP/s bf16, reached only through wgmma.
//
// Design:
//   - Rows. The G query heads of a kv head are folded into rows; a block
//     takes a tile of kBlockM rows of one (sequence, kv head): tpb tokens x
//     gs query heads (row = token * gs + head), gs the sub-group of the kv
//     group that `row_tile(G, kBlockM)` picks in ops/cuda/flash_prefill.py
//     (the largest divisor of G that divides kBlockM, so every tile is
//     whole: at 128 rows G = 48 takes 16 heads x 8 tokens, G = 71 one head x
//     128 tokens; a G that divides kBlockM keeps gs = G). Consumer
//     warpgroups of 64 rows each (three at D = 64, where a warpgroup's
//     softmax outlasts another's products; two above) plus one producer
//     warpgroup, of which one thread starts every load. setmaxnreg moves
//     registers from the producer (24) to the consumers (160 with three,
//     240 with two). blockIdx.x runs over (row tile, sub-group) pairs,
//     sub-group fastest and row tiles from the last tokens down, so the
//     longest tiles start first, and the blocks of one (sequence, kv head)
//     sit side by side in launch order: they run together and read its K/V
//     tiles from L2, not each from device memory.
//   - Loads. TMA with mbarriers: Q once per block (a 5-D map over (D, G, KH,
//     T, N), box {64, gs, 1, tpb, 1} at head g0), then K and V tiles of
//     kBlockN keys (128 up to D = 128, 80 at D = 192 and 256, where Q takes
//     48 or 64 KB; 4-D maps over (D, KH, T, N); a tile past T is
//     zero-filled by the hardware), 128-byte swizzled in [D / 64] column
//     blocks of [rows][64]. K and V have rings of their own (kKStages,
//     kVStages), each stage with full / empty barriers: a K stage is
//     released as soon as every warpgroup's score product has read it, a V
//     stage after their value products, so the producer (issuing K_kt+1
//     before V_kt, the order in which stages come free) runs further ahead
//     than one shared stage a tile allowed (at D = 256, with two stages,
//     the load of tile kt + 1 waited for tile kt - 1's value products). The
//     maps are encoded per call on the host through cudaGetDriverEntryPoint
//     (no link flag) and passed as __grid_constant__ parameters.
//   - Products. Both on wgmma with fp32 accumulators in registers:
//     S = Q K^T (m64n128k16, m64n80k16 over 80-key tiles; A = Q and B = the
//     K tile from shared memory, both K-major), then O += P V (m64nDk16,
//     D up to 256: 128 accumulators a thread; A = P from registers, rounded
//     to T, B = the V tile straight from its row-major [keys, D] layout
//     as an MN-major operand: no transpose).
//   - Overlap within a warpgroup. Tile kt's S product is started together
//     with tile kt-1's value product (P_{kt-1} stays in registers), and
//     kt's softmax runs while that value product is in flight. Each
//     product has its own fence and commit and no wgmma sits under a
//     branch ptxas cannot prove uniform (the warpgroup index is broadcast
//     with a shuffle): otherwise ptxas serializes every wgmma.
//   - Ping-pong between the warpgroups. They take turns in order (a named
//     barrier each) to start their products, so the others' softmax runs
//     while one's products hold the tensor cores.
//   - Masks only where needed. A block walks key tiles up to its causal and
//     length limit, from the tile of its first visible key (`window_floor`:
//     0 without a window); a warpgroup masks a tile only when the tile
//     crosses its diagonal, the length or its window's lower edge, releases
//     unread the tiles that lie wholly above its diagonal or wholly below
//     its window, and on the length-edge tile zeroes the dead V rows in
//     shared memory before its value product.
//   - Softmax. Online, in fp32: the row max on the raw scores, then one
//     FFMA and one ex2.approx a score with the scale folded in; row max and
//     sum reduced within the quad; the output is written once in T. With
//     ALiBi the max-then-scale shortcut does not hold: each score is first
//     scaled and biased (two FFMA: slope * log2(e) * (j - i), with j - i a
//     per-tile base plus a constant of the unrolled loop, so no integer
//     conversion a score), and the row max and the exponent read the
//     biased scores.
// Tried on the card and left out (PERF.md, Findings): two-block clusters that
// share each K / V tile by TMA multicast (slower: the pair runs in lock
// step, and cross-block stage releases cost more than the L2 reads they
// save), a persistent grid (spills at 160 registers a consumer thread),
// three warpgroups at D = 128 (80-key tiles to fit 160 registers: faster
// at StarCoder's heads, slower with ALiBi and at Qwen2's groups), 192-key
// tiles at D = 128 (slower with a window), a conditional O rescale.
// Still left: at StarCoder's (G = 48, D = 128) and Falcon-7B's (G = 71,
// D = 64) heads the kernel stays behind SDPA (PERF.md); each block pays its
// own prologue (barrier set-up, the Q load); the output leaves through
// 4-byte stores rather than a TMA store.

#include <limits.h>
#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kMaxBlockM = 192;              // rows of the largest row tile
constexpr uint32_t kRowBytes = 128;          // one swizzled row of 64 T

// Rows a block, keys a tile and the depth of the K and V rings: three
// consumer warpgroups (192 rows) at D = 64, where a warpgroup's softmax
// outlasts another's products; two (128 rows) above, where a third
// warpgroup's registers (160) do not hold its accumulators, scores and P
// of a 128-key tile. 128-key tiles up to D = 128; 80 at D = 192 and 256,
// where two stages of 128-key K and V tiles do not fit beside Q (48 or
// 64 KB).
template <int D>
struct Config {
  static constexpr int kConsumers = D == 64 ? 3 : 2;   // warpgroups of 64 rows
  static constexpr int kBlockM = 64 * kConsumers;      // rows (token * gs + head)
  static constexpr int kThreads = (kConsumers + 1) * 128;
  // registers a consumer thread after setmaxnreg: what the launch gives the
  // block (65536 / kThreads a thread, in steps of 8) less the producer's 24,
  // capped at 240; setmaxnreg.inc waits forever for registers past that
  static constexpr int kPoolRegs =
      ((65536 / kThreads) / 8 * 8 * kThreads - 24 * 128) / (128 * kConsumers) /
      8 * 8;
  static constexpr int kConsumerRegs = kPoolRegs < 240 ? kPoolRegs : 240;
  static constexpr int kQBox = kBlockM * 64 * 2;       // one [rows][64] box of T
  static constexpr int kCols = D / 64;       // 64-column blocks of the head dim
  static constexpr int kBlockN = D <= 128 ? 128 : 80;
  static constexpr int kKvBox = kBlockN * 64 * 2;      // one [keys][64] box
  static constexpr int kKStages = D == 64 ? 4 : (D == 128 ? 3 : 2);
  static constexpr int kVStages = D == 64 ? 4 : (D == 128 ? 3 : 2);
  static constexpr int kQBytes = kCols * kQBox;
  static constexpr int kTileBytes = kCols * kKvBox;    // one K or one V tile
  // 153 / 225 / 169 / 225 KB at D = 64 / 128 / 192 / 256
  static constexpr int kSmem =
      kQBytes + (kKStages + kVStages) * kTileBytes + 1024;
};

// The first key any row of tokens first_tok..last_tok sees: 0 without a
// window or when a row lies past the length (a padded row's mask has no lower
// edge), else first_tok - window + 1.
__device__ __forceinline__ int window_floor(int first_tok, int last_tok,
                                            int len, int window) {
  return window > 0 && last_tok < len ? max(0, first_tok - window + 1) : 0;
}

// The largest first visible key among the real rows of tokens up to
// last_tok: a key tile that starts below it crosses some row's window edge.
// INT_MIN without a window.
__device__ __forceinline__ int window_edge(int last_tok, int len, int window) {
  return window > 0 ? min(last_tok, len - 1) - window + 1 : INT_MIN;
}

// MN-major operand (V): the 64-column blocks `box` bytes apart, 8-key groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t box) {
  return smem_desc(addr, box, 1024);
}

// S = Q K^T over a tile of kBlockN keys
template <typename T, int N>
__device__ __forceinline__ void wgmma_scores(float (&s)[N / 2], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  if constexpr (N == 80) wgmma_ss_n80<T>(s, desc_a, desc_b, accumulate);
  else wgmma_ss_n128<T>(s, desc_a, desc_b, accumulate);
}

// O += P V, N = D
template <typename T, int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 64) wgmma_rs_mn_n64<T>(o, a, desc_b, 1);
  else if constexpr (D == 128) wgmma_rs_mn_n128<T>(o, a, desc_b, 1);
  else if constexpr (D == 192) wgmma_rs_mn_n192<T>(o, a, desc_b, 1);
  else wgmma_rs_mn_n256<T>(o, a, desc_b, 1);
}

// A ring of tiles in shared memory: tile kt's stage and the parity of its
// use of it, counted from the block's first tile
template <int kStages>
struct Ring {
  int first;
  __device__ __forceinline__ int stage(int kt) const {
    return (kt - first) % kStages;
  }
  __device__ __forceinline__ uint32_t phase(int kt) const {
    return ((kt - first) / kStages) & 1;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(Config<D>::kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const int32_t* __restrict__ lengths,   // [N]
                     const float* __restrict__ slopes,      // [KH, G] or null
                     T* __restrict__ out,                   // [N, T, KH, G, D]
                     int T_len, int KH, int G, int gs, int window,
                     float scale_log2) {
  using C = Config<D>;
  constexpr int kBlockN = C::kBlockN;
  constexpr int kConsumers = C::kConsumers;
  constexpr int kQBox = C::kQBox;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t k_full[C::kKStages];
  __shared__ __align__(8) uint64_t k_empty[C::kKStages];
  __shared__ __align__(8) uint64_t v_full[C::kVStages];
  __shared__ __align__(8) uint64_t v_empty[C::kVStages];
  __shared__ __align__(8) uint64_t q_bar;
  // the swizzle atoms want 1024-byte aligned tiles
  unsigned char* base =
      smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw));
  unsigned char* qs = base;
  unsigned char* ks = base + C::kQBytes;                  // + stage * kTileBytes
  unsigned char* vs = ks + C::kKStages * C::kTileBytes;

  const int kh = blockIdx.y;
  const int n = blockIdx.z;
  const int subs = G / gs;                                // sub-groups of G
  const int g0 = (blockIdx.x % subs) * gs;                // first query head
  const int tpb = C::kBlockM / gs;                        // tokens a block
  const int tok0 = (gridDim.x / subs - 1 - blockIdx.x / subs) * tpb;  // last first
  const int rows = tpb * gs;
  const int len = max(0, min(lengths[n], T_len));
  const int tok_last = min(tok0 + tpb - 1, T_len - 1);
  // -1 when len == 0: no key tile
  const int last_tile =
      min(tok_last / kBlockN, (len + kBlockN - 1) / kBlockN - 1);
  // the block's first key tile: the lower of its warpgroups' (the last
  // token of warpgroup 1 is the block's last)
  const int first_tile =
      window_floor(tok0, tok0 + tpb - 1, len, window) / kBlockN;
  const Ring<C::kKStages> kr{first_tile};
  const Ring<C::kVStages> vr{first_tile};
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < C::kKStages; ++st) {
      mbar_init(&k_full[st], 1);
      mbar_init(&k_empty[st], kConsumers * 4);   // one arrival per warp
    }
#pragma unroll
    for (int st = 0; st < C::kVStages; ++st) {
      mbar_init(&v_full[st], 1);
      mbar_init(&v_empty[st], kConsumers * 4);
    }
    mbar_init(&q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform for the compiler (a plain tid / 128 reads as divergent,
  // and ptxas then serializes every wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == kConsumers) {
    // --- producer warpgroup: one thread keeps both rings full -------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      mbar_expect_tx(&q_bar, C::kCols * rows * kRowBytes);
#pragma unroll
      for (int cb = 0; cb < C::kCols; ++cb)
        tma_load_5d(qs + cb * kQBox, &tm_q, &q_bar, cb * 64, g0, kh, tok0,
                    n);
      // tile kt of one ring, once its stage's earlier tile is released
      auto load = [&](const CUtensorMap* map, unsigned char* ring,
                      uint64_t* full, uint64_t* empty, int st, int use,
                      int kt) {
        if (use > 0) mbar_wait(&empty[st], (use - 1) & 1);
        mbar_expect_tx(&full[st], C::kTileBytes);
#pragma unroll
        for (int cb = 0; cb < C::kCols; ++cb)
          tma_load_4d(ring + st * C::kTileBytes + cb * C::kKvBox, map,
                      &full[st], cb * 64, kh, kt * kBlockN, n);
      };
      auto load_k = [&](int kt) {
        load(&tm_k, ks, k_full, k_empty, kr.stage(kt),
             (kt - first_tile) / C::kKStages, kt);
      };
      auto load_v = [&](int kt) {
        load(&tm_v, vs, v_full, v_empty, vr.stage(kt),
             (kt - first_tile) / C::kVStages, kt);
      };
      // K_kt+1 before V_kt: a warpgroup reads K_kt+1 beside V_kt and
      // releases K stages a product earlier than V stages
      if (first_tile <= last_tile) load_k(first_tile);
      for (int kt = first_tile; kt <= last_tile; ++kt) {
        if (kt < last_tile) load_k(kt + 1);
        load_v(kt);
      }
    }
  } else {
    // --- consumer warpgroups: 64 rows each ---------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n"
                 :: "n"(C::kConsumerRegs) : "memory");
    const int wtid = tid % 128;
    const int warp = wtid / 32;
    const int lane = tid % 32;
    const int group = lane / 4;
    const int quad = lane % 4;
    const int r_wg = wg * 64;                     // first row of the warpgroup
    const int wg_first_tok = tok0 + r_wg / gs;
    const int wg_last_tok = tok0 + min(r_wg + 63, rows - 1) / gs;
    // the tiles this warpgroup computes: later ones lie wholly above its
    // diagonal, earlier ones wholly below its window
    const int my_last = min(last_tile, wg_last_tok / kBlockN);
    const int my_first =
        window_floor(wg_first_tok, wg_last_tok, len, window) / kBlockN;
    const int edge = window_edge(wg_last_tok, len, window);
    int row[2], tok[2];
    // ALiBi: the rows' slopes in exp2 units; the scores are then scaled
    // before the row max (mul = 1), else after it (mul = the scale)
    const bool alibi = slopes != nullptr;
    const float mul = alibi ? 1.f : scale_log2;
    float slope[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = r_wg + warp * 16 + group + 8 * h;
      tok[h] = tok0 + row[h] / gs;
      slope[h] = alibi ? slopes[kh * G + g0 + row[h] % gs] * 1.4426950408889634f
                       : 0.f;
    }
    auto release = [&](uint64_t* empty, int st) {
      if (lane == 0) mbar_arrive(&empty[st]);
    };
    // a tile this warpgroup does not compute: wait for both of its loads
    // (a stage is reloaded only after they land), then release them
    auto release_unread = [&](int kt) {
      mbar_wait(&k_full[kr.stage(kt)], kr.phase(kt));
      release(k_empty, kr.stage(kt));
      mbar_wait(&v_full[vr.stage(kt)], vr.phase(kt));
      release(v_empty, vr.stage(kt));
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float s[kBlockN / 2];
    uint32_t pa[kBlockN / 16][4];                 // P of the previous tile
    float m[2] = {-INFINITY, -INFINITY};          // row max, scaled log2 units
    float l[2] = {0.f, 0.f};                      // this lane's partial sums
    const uint32_t q_addr = smem_u32(qs) + r_wg * kRowBytes;
    mbar_wait(&q_bar, 0);

    // Tile kt: wait for its K stage, start S_kt = Q K_kt^T (uncommitted
    // groups stay in flight).
    auto start_scores = [&](int kt) {
      const int st = kr.stage(kt);
      mbar_wait(&k_full[st], kr.phase(kt));
      const uint32_t k_addr = smem_u32(ks + st * C::kTileBytes);
      fence_regs(s);
      wgmma_fence();
#pragma unroll
      for (int ks16 = 0; ks16 < D / 16; ++ks16) {
        const uint32_t sub = (ks16 % 4) * 32;
        wgmma_scores<T, kBlockN>(
            s, desc_k_major(q_addr + (ks16 / 4) * kQBox + sub),
            desc_k_major(k_addr + (ks16 / 4) * C::kKvBox + sub), ks16 > 0);
      }
      wgmma_commit();
      fence_regs(s);
    };
    // Tile kt: wait for its V stage, zero its dead V rows on the
    // length-edge tile, start O += P_kt V_kt from the P registers (left in
    // flight)
    auto start_values = [&](int kt) {
      const int st = vr.stage(kt);
      const int key0 = kt * kBlockN;
      mbar_wait(&v_full[st], vr.phase(kt));
      if (key0 + kBlockN > len) {
        // 16 bytes a store; the swizzle only permutes chunks within a row
        unsigned char* v_tile = vs + st * C::kTileBytes;
        const int dead0 = len - key0;
        for (int i = wtid; i < (kBlockN - dead0) * C::kCols * 8; i += 128) {
          const int r = dead0 + i / (C::kCols * 8);
          const int c = i % (C::kCols * 8);
          *reinterpret_cast<uint4*>(v_tile + (c / 8) * C::kKvBox +
                                    r * kRowBytes + (c % 8) * 16) =
              make_uint4(0u, 0u, 0u, 0u);
        }
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
      }
      const uint32_t v_addr = smem_u32(vs + st * C::kTileBytes);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kBlockN / 16; ++k16)
        wgmma_pv<T, D>(o, pa[k16], desc_mn_major(v_addr + k16 * 2048, C::kKvBox));
      wgmma_commit();
      fence_regs(o);
    };
    // online softmax of tile kt's scores: masks only across the diagonal,
    // the length or the window's lower edge; returns the rescale factors of
    // O and leaves P in s
    auto softmax = [&](int kt, float (&alpha)[2]) {
      const int key0 = kt * kBlockN;
      if (alibi) {
        // key - token = base[h] + c with c a constant of the unrolled loop:
        // one int-to-float conversion a row and tile, two FFMA a score
        float base[2];
#pragma unroll
        for (int h = 0; h < 2; ++h)
          base[h] = slope[h] * (float)(key0 + quad * 2 - tok[h]);
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          const int h = (i / 2) % 2;
          const float c = (float)((i / 4) * 8 + (i % 2));
          s[i] = fmaf(s[i], scale_log2, fmaf(slope[h], c, base[h]));
        }
      }
      if (key0 + kBlockN > min(wg_first_tok + 1, len) || key0 < edge) {
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          const int key = key0 + (i / 4) * 8 + quad * 2 + (i % 2);
          const int tk = tok[(i / 2) % 2];
          if (key > tk || key >= len || (window > 0 && tk < len && key <= tk - window))
            s[i] = -INFINITY;
        }
      }
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) tmax[(i / 2) % 2] = fmaxf(tmax[(i / 2) % 2], s[i]);
      float m_safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
        tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
        const float m_new = fmaxf(m[h], tmax[h] * mul);
        m_safe[h] = m_new == -INFINITY ? 0.f : m_new;
        alpha[h] = fast_exp2(m[h] - m_safe[h]);   // 0 while m is -inf
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        const int h = (i / 2) % 2;
        s[i] = fast_exp2(fmaf(s[i], mul, -m_safe[h]));   // -inf -> 0
        l[h] += s[i];
      }
    };
    auto pack_p = [&]() {
#pragma unroll
      for (int k16 = 0; k16 < kBlockN / 16; ++k16) {
        pa[k16][0] = pack2<T>(s[8 * k16 + 0], s[8 * k16 + 1]);
        pa[k16][1] = pack2<T>(s[8 * k16 + 2], s[8 * k16 + 3]);
        pa[k16][2] = pack2<T>(s[8 * k16 + 4], s[8 * k16 + 5]);
        pa[k16][3] = pack2<T>(s[8 * k16 + 6], s[8 * k16 + 7]);
      }
    };

    // Ping-pong: the warpgroups take turns in order to start their products
    // (warpgroup w waits on named barrier kTurn + w and passes to the next),
    // so the others' softmax runs while one's products hold the tensor
    // cores. All run last_tile - first_tile + 2 turns (one empty turn a tile
    // wholly below the window; the first tile's S; S_kt with P_{kt-1}
    // V_{kt-1}; the last value product; one empty turn a tile wholly above
    // the diagonal), so every wait is met; the last warpgroup lets
    // warpgroup 0 go first and skips its very last signal.
    constexpr int kTurn = 1 + kConsumers;         // after the warpgroups' own
    const int turns = last_tile - first_tile + 2;
    int turn = 0;
    auto take_turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" :: "r"(kTurn + wg) : "memory");
    };
    auto pass_turn = [&]() {
      if (++turn < turns || wg != kConsumers - 1)
        asm volatile("bar.arrive %0, 256;\n"
                     :: "r"(kTurn + (wg + 1) % kConsumers) : "memory");
    };
    if (wg == kConsumers - 1 && last_tile >= 0)
      asm volatile("bar.arrive %0, 256;\n" :: "n"(kTurn) : "memory");

    for (int kt = first_tile; kt < my_first; ++kt) {
      // wholly below this warpgroup's window: release the stages unread
      take_turn();
      pass_turn();
      release_unread(kt);
    }
    // The first tile alone; then each tile starts S_kt together with the
    // value product of tile kt - 1, and its softmax runs while that product
    // is in flight. K_kt is released once S_kt is done, V_kt once
    // P_kt V_kt is.
    if (my_last >= 0) {
      float alpha[2];
      take_turn();
      start_scores(my_first);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(s);
      release(k_empty, kr.stage(my_first));
      softmax(my_first, alpha);
      pack_p();
    }
    for (int kt = my_first + 1; kt <= my_last; ++kt) {
      float alpha[2];
      take_turn();
      start_scores(kt);
      start_values(kt - 1);
      pass_turn();
      wgmma_wait<1>();                            // S_kt is done
      fence_regs(s);
      release(k_empty, kr.stage(kt));
      softmax(kt, alpha);
      wgmma_wait<0>();                            // P_{kt-1} V_{kt-1} is in O
      fence_regs(o);
      release(v_empty, vr.stage(kt - 1));
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
      pack_p();
    }
    if (my_last >= 0) {                           // the last value product
      take_turn();
      start_values(my_last);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(o);
      release(v_empty, vr.stage(my_last));
    }
    for (int kt = my_last + 1; kt <= last_tile; ++kt) {
      // wholly above this warpgroup's diagonal: release the stages unread
      take_turn();
      pass_turn();
      release_unread(kt);
    }

    // full row sums across the quad, normalize, store pairs of T
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
      l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
      l[h] = 1.f / fmaxf(l[h], 1e-30f);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (row[h] >= rows || tok[h] >= T_len) continue;
      T* dst = out + ((((size_t)n * T_len + tok[h]) * KH + kh) * G + g0 +
                      row[h] % gs) * D;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<uint32_t*>(dst + j * 8 + quad * 2) =
            pack2<T>(o[4 * j + 2 * h] * l[h], o[4 * j + 2 * h + 1] * l[h]);
    }
  }
}

// a tensor map of 16-bit elements (fp16 when `half`, else bf16) over `rank`
// dims (innermost first), 128-byte swizzle
bool make_map(CUtensorMap* map, const void* ptr, int rank,
              const cuuint64_t* dims, const cuuint32_t* box, bool half) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  cuuint64_t strides[4];   // bytes, dims 1..rank-1
  cuuint64_t stride = 2;
  for (int i = 0; i + 1 < rank; ++i) {
    stride *= dims[i];
    strides[i] = stride;
  }
  const cuuint32_t elem[5] = {1, 1, 1, 1, 1};
  return encode(map,
                half ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16
                     : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* lengths, const float* slopes, void* out,
                   int N, int T_len, int KH, int G, int gs, int window,
                   float scale, cudaStream_t stream) {
  using C = Config<D>;
  if (gs > C::kBlockM) return cudaErrorInvalidValue;
  const int tpb = C::kBlockM / gs;
  CUtensorMap tm_q, tm_k, tm_v;
  const cuuint64_t q_dims[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)KH,
                                (cuuint64_t)T_len, (cuuint64_t)N};
  const cuuint32_t q_box[5] = {64, (cuuint32_t)gs, 1, (cuuint32_t)tpb, 1};
  const cuuint64_t kv_dims[4] = {(cuuint64_t)D, (cuuint64_t)KH, (cuuint64_t)T_len,
                                 (cuuint64_t)N};
  const cuuint32_t kv_box[4] = {64, 1, C::kBlockN, 1};
  constexpr bool half = kIsHalf<T>;
  if (!make_map(&tm_q, q, 5, q_dims, q_box, half) ||
      !make_map(&tm_k, k, 4, kv_dims, kv_box, half) ||
      !make_map(&tm_v, v, 4, kv_dims, kv_box, half))
    return cudaErrorInvalidValue;
  // above 48 KB of dynamic shared memory: opt in once per device
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_prefill_kernel<T, D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  // (row tile, sub-group) pairs, kv heads, sequences
  const long long blocks = (long long)((T_len + tpb - 1) / tpb) * (G / gs);
  if (blocks > INT_MAX) return cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, KH, N);
  flash_prefill_kernel<T, D><<<grid, C::kThreads, C::kSmem, stream>>>(
      tm_q, tm_k, tm_v, lengths, slopes, static_cast<T*>(out), T_len, KH, G,
      gs, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The float32 kernel (`dtype` 2), on the tensor cores in 3xTF32. The JAX
// kernel casts q, k and v to f32 and computes both products in f32; one
// TF32 pass keeps 10 of the 23 mantissa bits and misses a 1e-4 tolerance.
// So every operand is split into two TF32 terms, hi = rna(x) and
// lo = rna(x - hi), and each product is three tensor-core products with
// fp32 accumulation, lo.hi + hi.lo + hi.hi (lo.lo is below fp32's
// rounding): both S = Q K^T and O += P V, with P split the same way.
//
// Design:
//   - mma.sync m16n8k8 in .tf32 (wgmma takes .tf32 operands only K-major,
//     and V is MN-major in the value product; mma.sync reads B fragments
//     from registers, so V stays in its row-major [keys, D] layout). Each
//     operand is split in registers as its fragment is loaded.
//   - Rows are folded as in the wgmma kernel (row = token * G + g), in flat
//     tiles of kRows rows of one (sequence, kv head), so K and V are staged
//     once for all G query heads and any G runs; each warp takes 16 rows.
//   - Fragment orders: the head dim inside a k8 step is permuted (k
//     position q <-> d 2q, q + 4 <-> d 2q + 1, the same in Q and K), so a
//     thread reads its Q and K pairs as 8-byte loads; for P V the keys are
//     permuted the same way, so the S accumulators are P's A fragments in
//     place, and V's B fragments are two 4-byte loads. Row strides D + 8
//     (Q, K) and D + 4 (V) make every such load free of bank conflicts.
//   - Q once and K / V tiles of kKeys keys by 16-byte cp.async into two
//     stages; keys at or past the length are zero-filled (the padding may
//     hold NaN), so the length-edge tile's dead value rows are 0.
//   - The online softmax in exp2 units as the wgmma kernel's (with ALiBi,
//     each score scaled and biased before the row max); masks only on
//     the tiles that cross a warp's diagonal, the length or its window's
//     lower edge; a block loads from the tile of its first visible key, and
//     a warp skips the tiles wholly above its diagonal or wholly below its
//     window; the longest row tiles start first; lengths[n] == 0 gives 0.
// Bound by its tensor-core products (three a product) and the splits.
template <int D>
struct F32Config {
  static constexpr int kWarps = D <= 128 ? 8 : 4;
  static constexpr int kThreads = 32 * kWarps;
  static constexpr int kRows = 16 * kWarps;        // rows a block
  static constexpr int kKeys = D <= 128 ? 64 : 32; // keys a tile
  static constexpr int kLdK = D + 8;               // Q and K row stride
  static constexpr int kLdV = D + 4;               // V row stride
  // 109 KB at D = 64 (two blocks an SM), 207 / 153 / 202 KB at 128 / 192 /
  // 256
  static constexpr int kSmem =
      4 * (kRows * kLdK + 2 * kKeys * (kLdK + kLdV));
  static constexpr int kMinBlocks = D == 64 ? 2 : 1;
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
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d[i] += a b[i] to fp32 accuracy from the split terms, for kN B fragments
// (b[i][0], b[i][1]): the small terms first, and each term over all kN
// accumulators before the next, so that no product waits on the one
// before it
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

__device__ __forceinline__ void cp_async_16(void* smem, const void* gmem,
                                            int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(bytes) : "memory");
}

template <int D>
__global__ void __launch_bounds__(F32Config<D>::kThreads,
                                  F32Config<D>::kMinBlocks)
flash_prefill_f32_kernel(const float* __restrict__ q,   // [N, T, KH, G, D]
                         const float* __restrict__ k,   // [N, T, KH, D]
                         const float* __restrict__ v,
                         const int32_t* __restrict__ lengths,
                         const float* __restrict__ slopes,  // [KH, G] or null
                         float* __restrict__ out,       // [N, T, KH, G, D]
                         int T_len, int KH, int G, int window,
                         float scale_log2) {
  using C = F32Config<D>;
  constexpr int kKeys = C::kKeys;
  extern __shared__ __align__(16) float smf[];
  float* qs = smf;                                     // [kRows][kLdK]
  float* ks = qs + C::kRows * C::kLdK;                 // [2][kKeys][kLdK]
  float* vs = ks + 2 * kKeys * C::kLdK;                // [2][kKeys][kLdV]

  const int kh = blockIdx.y;
  const int n = blockIdx.z;
  const int rows_total = T_len * G;
  // the last row tiles first: the longest walks start first
  const int r0 = (gridDim.x - 1 - blockIdx.x) * C::kRows;
  const int len = max(0, min(lengths[n], T_len));
  const int tok_last = (min(r0 + C::kRows, rows_total) - 1) / G;
  // -1 when len == 0: no key tile
  const int last_tile = min(tok_last / kKeys, (len + kKeys - 1) / kKeys - 1);
  const int first_tile = window_floor(r0 / G, tok_last, len, window) / kKeys;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int qd = lane % 4;

  for (int i = tid; i < C::kRows * (D / 4); i += C::kThreads) {
    const int r = i / (D / 4);
    const int c = 4 * (i % (D / 4));
    const int row = r0 + r;
    const bool ok = row < rows_total;
    const float* src =
        q + ((((size_t)n * T_len + row / G) * KH + kh) * G + row % G) * D + c;
    cp_async_16(qs + r * C::kLdK + c, ok ? src : q, ok ? 16 : 0);
  }
  auto load_kv = [&](int kt, int st) {
    for (int i = tid; i < kKeys * (D / 4); i += C::kThreads) {
      const int r = i / (D / 4);
      const int c = 4 * (i % (D / 4));
      const int key = kt * kKeys + r;
      const bool ok = key < len;
      const size_t off = (((size_t)n * T_len + key) * KH + kh) * D + c;
      cp_async_16(ks + (st * kKeys + r) * C::kLdK + c, ok ? k + off : k,
                  ok ? 16 : 0);
      cp_async_16(vs + (st * kKeys + r) * C::kLdV + c, ok ? v + off : v,
                  ok ? 16 : 0);
    }
  };
  if (last_tile >= 0) load_kv(first_tile, first_tile % 2);
  asm volatile("cp.async.commit_group;\n" ::: "memory");

  // this warp's rows: g and g + 8 of the 16 from wr
  const int wr = r0 + warp * 16;
  const int tok[2] = {(wr + g) / G, (wr + g + 8) / G};
  // ALiBi, as the wgmma kernel: the rows' slopes in exp2 units, scores
  // scaled before the row max (mul = 1) with slopes, after it without
  const bool alibi = slopes != nullptr;
  const float mul = alibi ? 1.f : scale_log2;
  const float slope[2] = {
      alibi ? slopes[kh * G + (wr + g) % G] * 1.4426950408889634f : 0.f,
      alibi ? slopes[kh * G + (wr + g + 8) % G] * 1.4426950408889634f : 0.f};
  const int w_first_tok = wr / G;
  const int w_last_tok = min(wr + 15, rows_total - 1) / G;
  // the tiles this warp computes: later ones lie wholly above its diagonal
  // (-1 for a warp past the rows), earlier ones wholly below its window
  const int my_last = wr < rows_total ? min(last_tile, w_last_tok / kKeys) : -1;
  const int my_first = window_floor(w_first_tok, w_last_tok, len, window) / kKeys;
  const int edge = window_edge(w_last_tok, len, window);
  const float* q_a = qs + (warp * 16 + g) * C::kLdK + 2 * qd;

  float o[D / 8][4];
#pragma unroll
  for (int i = 0; i < D / 8; ++i) o[i][0] = o[i][1] = o[i][2] = o[i][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};      // row max, scaled log2 units
  float l[2] = {0.f, 0.f};                  // this lane's partial sums

  for (int kt = first_tile; kt <= last_tile; ++kt) {
    if (kt < last_tile) load_kv(kt + 1, (kt + 1) % 2);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
    __syncthreads();                        // tile kt (and Q) landed
    if (kt >= my_first && kt <= my_last) {
      const float* kt_s = ks + (kt % 2) * kKeys * C::kLdK;
      const float* vt_s = vs + (kt % 2) * kKeys * C::kLdV;
      // S = Q K^T
      float s[kKeys / 8][4];
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll 2
      for (int d8 = 0; d8 < D / 8; ++d8) {
        const float2 qa = *reinterpret_cast<const float2*>(q_a + 8 * d8);
        const float2 qb =
            *reinterpret_cast<const float2*>(q_a + 8 * C::kLdK + 8 * d8);
        uint32_t ah[4], al[4];
        split_tf32(qa.x, ah[0], al[0]);
        split_tf32(qb.x, ah[1], al[1]);
        split_tf32(qa.y, ah[2], al[2]);
        split_tf32(qb.y, ah[3], al[3]);
        float kb[kKeys / 8][2];
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j) {
          const float2 b = *reinterpret_cast<const float2*>(
              kt_s + (8 * j + g) * C::kLdK + 8 * d8 + 2 * qd);
          kb[j][0] = b.x;
          kb[j][1] = b.y;
        }
        mma_3xtf32<kKeys / 8>(s, ah, al, kb);
      }
      // masks only on a tile that crosses this warp's diagonal, the length
      // or its window's lower edge
      const int key0 = kt * kKeys;
      if (alibi) {
        // as the wgmma kernel: key - token = base[h] + a loop constant
        const float base[2] = {slope[0] * (float)(key0 + 2 * qd - tok[0]),
                               slope[1] * (float)(key0 + 2 * qd - tok[1])};
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float c = (float)(8 * j + (e & 1));
            s[j][e] = fmaf(s[j][e], scale_log2,
                           fmaf(slope[e / 2], c, base[e / 2]));
          }
      }
      if (key0 + kKeys > min(w_first_tok + 1, len) || key0 < edge) {
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = key0 + 8 * j + 2 * qd + (e & 1);
            const int tk = tok[e / 2];
            if (key > tk || key >= len || (window > 0 && tk < len && key <= tk - window))
              s[j][e] = -INFINITY;
          }
      }
      // online softmax in exp2 units; row h is accumulators 2h, 2h + 1
      float alpha[2], m_safe[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float tmax = -INFINITY;
#pragma unroll
        for (int j = 0; j < kKeys / 8; ++j)
          tmax = fmaxf(tmax, fmaxf(s[j][2 * h], s[j][2 * h + 1]));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 1));
        tmax = fmaxf(tmax, __shfl_xor_sync(0xffffffffu, tmax, 2));
        const float m_new = fmaxf(m[h], tmax * mul);
        m_safe[h] = m_new == -INFINITY ? 0.f : m_new;
        alpha[h] = exp2f(m[h] - m_safe[h]);       // 0 while m is -inf
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = exp2f(fmaf(s[j][e], mul, -m_safe[e / 2]));  // -inf -> 0
          l[e / 2] += s[j][e];
        }
#pragma unroll
      for (int i = 0; i < D / 8; ++i) {
        o[i][0] *= alpha[0];
        o[i][1] *= alpha[0];
        o[i][2] *= alpha[1];
        o[i][3] *= alpha[1];
      }
      // O += P V: key step j's A fragment is S tile j's accumulators (keys
      // 2q, 2q + 1 at k positions q, q + 4)
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        uint32_t ph[4], pl[4];
        split_tf32(s[j][0], ph[0], pl[0]);
        split_tf32(s[j][2], ph[1], pl[1]);
        split_tf32(s[j][1], ph[2], pl[2]);
        split_tf32(s[j][3], ph[3], pl[3]);
        const float* v0 = vt_s + (8 * j + 2 * qd) * C::kLdV + g;
        // four value fragments at a time
#pragma unroll
        for (int i0 = 0; i0 < D / 8; i0 += 4) {
          float vb[4][2];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            vb[i][0] = v0[8 * (i0 + i)];
            vb[i][1] = v0[C::kLdV + 8 * (i0 + i)];
          }
          mma_3xtf32<4>(o + i0, ph, pl, vb);
        }
      }
    }
    __syncthreads();                        // stage kt % 2 is free
  }
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");

  // full row sums across the quad, normalize, store pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = 1.f / fmaxf(l[h], 1e-30f);
    const int row = wr + g + 8 * h;
    if (row >= rows_total) continue;
    float* dst =
        out + ((((size_t)n * T_len + row / G) * KH + kh) * G + row % G) * D +
        2 * qd;
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
      *reinterpret_cast<float2*>(dst + 8 * i) =
          make_float2(o[i][2 * h] * l[h], o[i][2 * h + 1] * l[h]);
  }
}

template <int D>
cudaError_t launch_f32_d(const void* q, const void* k, const void* v,
                         const int32_t* lengths, const float* slopes,
                         void* out, int N, int T_len, int KH, int G,
                         int window, float scale, cudaStream_t stream) {
  using C = F32Config<D>;
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(flash_prefill_f32_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kSmem);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  const long long rows = (long long)T_len * G;
  const dim3 grid((unsigned)((rows + C::kRows - 1) / C::kRows), KH, N);
  flash_prefill_f32_kernel<D><<<grid, C::kThreads, C::kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lengths, slopes, static_cast<float*>(out),
      T_len, KH, G, window, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int32_t* lengths, const float* slopes, void* out,
                       int N, int T_len, int KH, int G, int D, int window,
                       float scale, cudaStream_t stream) {
#define TGI_FLASH_F32(DV)                                                     \
    case DV:                                                                \
      return launch_f32_d<DV>(q, k, v, lengths, slopes, out, N, T_len, KH, G, \
                              window, scale, stream);
  switch (D) {
    TGI_FLASH_F32(64) TGI_FLASH_F32(128) TGI_FLASH_F32(192) TGI_FLASH_F32(256)
#undef TGI_FLASH_F32
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 bf16 and 1 fp16 (the wgmma kernel), 2 fp32 (the 3xTF32
// mma.sync kernel); D 64, 128, 192 or 256; gs: the query heads of a row
// tile of the wgmma kernel (a divisor of G, at most 128; its row tiles
// hold 128 / gs tokens; the fp32 kernel tiles rows its own way); window:
// the sliding window in keys, 0 for none; slopes: [KH, G] f32 ALiBi
// slopes, or null for none
extern "C" int tgi_flash_prefill(const void* q, const void* k, const void* v,
                                 const int32_t* lengths, const float* slopes,
                                 void* out, int N, int T, int KH, int G,
                                 int gs, int D, int window, int dtype,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // TMA wants 16-byte aligned bases; a block holds at least one token
  if (N <= 0 || T <= 0 || KH <= 0 || G <= 0 || gs <= 0 || gs > kMaxBlockM ||
      G % gs != 0 || KH > 65535 || N > 65535 || window < 0 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
#define TGI_FLASH_D(TY)                                                        \
  switch (D) {                                                                 \
    case 64: return (int)launch<TY, 64>(q, k, v, lengths, slopes, out, N, T, KH, G, gs, window, scale, s);   \
    case 128: return (int)launch<TY, 128>(q, k, v, lengths, slopes, out, N, T, KH, G, gs, window, scale, s); \
    case 192: return (int)launch<TY, 192>(q, k, v, lengths, slopes, out, N, T, KH, G, gs, window, scale, s); \
    case 256: return (int)launch<TY, 256>(q, k, v, lengths, slopes, out, N, T, KH, G, gs, window, scale, s); \
    default: return (int)cudaErrorInvalidValue;                                \
  }
  switch (dtype) {
    case 0: TGI_FLASH_D(__nv_bfloat16)
    case 1: TGI_FLASH_D(__half)
    case 2: return (int)launch_f32(q, k, v, lengths, slopes, out, N, T, KH, G, D, window, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TGI_FLASH_D
}

extern "C" const char* tgi_flash_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
