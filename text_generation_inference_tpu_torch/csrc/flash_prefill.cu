// Causal flash attention over right-padded prefill buckets, for sm_90a.
//
// Replaces: the JAX package's ops/pallas/flash_prefill.py
//           flash_prefill (the Pallas `_kernel`, pallas_call at :143).
//
// q, k, v and out are bf16 or fp16 (the entry's `dtype` 0 or 1: the wgmma
// kernel, templated on the element type T; only the wgmma type, the tensor
// maps' type and the rounding of P and of the output differ), or fp32
// (`dtype` 2: a CUDA-core kernel in fp32 FMA, `flash_prefill_f32_kernel`).
//
// Computes, per (sequence n, kv head kh, query head g of the kv group):
//   out[n, i, kh, g] = softmax_j(q[n, i, kh, g] . k[n, j, kh] * scale) v[n, j, kh]
// over keys j <= i and j < lengths[n]. Padded query rows (i >= lengths[n])
// still attend over every live key; rows of a sequence with lengths[n] == 0
// give 0; value rows at or past the length are zeroed before the product
// (as the Pallas kernel does at flash_prefill.py:79-83: the padding may hold
// NaN, and P = 0 does not cancel it).
//
// What bounds it on an H100: at prefill lengths (128..2048) the causal score
// and value products are ~T^2/2 * H * D * 4 flops against O(T*H*D) bytes, so
// it is bound by operations: 989 TFLOP/s bf16, reached only through wgmma.
//
// Design:
//   - Rows. The G query heads of a kv head are folded into rows (row =
//     token * G + g); a block takes 128 rows (128 / G tokens) of one
//     (sequence, kv head): two consumer warpgroups of 64 rows each plus one
//     producer warpgroup, of which one thread starts every load.
//     setmaxnreg moves registers from the producer (24) to the consumers
//     (240). blockIdx.x runs over the row tiles from the last tokens down,
//     so the longest tiles start first, and the row tiles of one (sequence,
//     kv head) sit side by side in launch order: they run together and
//     read its K/V tiles from L2, not each from device memory.
//   - Loads. TMA with mbarriers: Q once per block (a 5-D map over (D, G, KH,
//     T, N)), then K and V tiles of 128 keys, 64 at D = 192 and 256, where
//     Q takes 48 or 64 KB (4-D maps over (D, KH, T, N);
//     a tile past T is zero-filled by the hardware) into a ring of kStages
//     stages with full / empty barriers, 128-byte swizzled in [D / 64]
//     column blocks of [rows][64]. The maps are encoded per call on the
//     host through cudaGetDriverEntryPoint (no link flag) and passed as
//     __grid_constant__ parameters.
//   - Products. Both on wgmma with fp32 accumulators in registers:
//     S = Q K^T (m64n128k16, m64n64k16 over 64-key tiles; A = Q and B = the
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
//   - Ping-pong between the warpgroups. They take turns (two named
//     barriers) to start their products, so one warpgroup's softmax runs
//     while the other's products hold the tensor cores.
//   - Masks only where needed. A block walks key tiles up to its causal and
//     length limit; a warpgroup masks a tile only when the tile crosses its
//     diagonal or the length, releases unread the tiles that lie wholly
//     above its diagonal, and on the length-edge tile zeroes the dead V
//     rows in shared memory before its value product.
//   - Softmax. Online, in fp32: the row max on the raw scores, then one
//     FFMA and one ex2.approx a score with the scale folded in; row max and
//     sum reduced within the quad; the output is written once in T.
// Still left: at D = 64 the softmax (one ex2 a score) weighs as much as the
// products, and three consumer warpgroups of rows would hide more of it;
// each block pays its own prologue (barrier set-up, the Q load) where a
// persistent grid would overlap it with the previous tile's epilogue; the
// output leaves through 4-byte stores rather than a TMA store.

#include <math.h>

#include "hopper.cuh"

namespace {

using namespace hopper;

constexpr int kBlockM = 128;                 // rows (token * G + g) a block
constexpr int kConsumers = 2;                // warpgroups of 64 rows
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kQBox = 128 * 64 * 2;          // one [128 rows][64] box of T
constexpr uint32_t kRowBytes = 128;          // one swizzled row of 64 T

// Keys a tile: 128 up to D = 128; 64 at D = 192 and 256, where Q (48 or
// 64 KB) and two stages of 128-key K and V tiles would not fit beside it.
template <int D>
struct Config {
  static constexpr int kCols = D / 64;       // 64-column blocks of the head dim
  static constexpr int kBlockN = D <= 128 ? 128 : 64;
  static constexpr int kKvBox = kBlockN * 64 * 2;      // one [keys][64] box
  static constexpr int kStages = D == 64 ? 4 : (D == 256 ? 2 : 3);
  static constexpr int kQBytes = kCols * kQBox;
  static constexpr int kTileBytes = kCols * kKvBox;    // one K or one V tile
  // 225 KB at D = 128, 193 KB at D = 192 and 256
  static constexpr int kSmem = kQBytes + 2 * kStages * kTileBytes + 1024;
};

// MN-major operand (V): the 64-column blocks `box` bytes apart, 8-key groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr, uint32_t box) {
  return smem_desc(addr, box, 1024);
}

// S = Q K^T over a tile of kBlockN keys
template <typename T, int N>
__device__ __forceinline__ void wgmma_scores(float (&s)[N / 2], uint64_t desc_a,
                                             uint64_t desc_b, int accumulate) {
  if constexpr (N == 64) wgmma_ss_n64<T>(s, desc_a, desc_b, accumulate);
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

template <typename T, int D>
__global__ void __launch_bounds__(kThreads, 1)
flash_prefill_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v,
                     const int32_t* __restrict__ lengths,   // [N]
                     T* __restrict__ out,                   // [N, T, KH, G, D]
                     int T_len, int KH, int G, float scale_log2) {
  using C = Config<D>;
  constexpr int kBlockN = C::kBlockN;
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[C::kStages];
  __shared__ __align__(8) uint64_t empty_bar[C::kStages];
  __shared__ __align__(8) uint64_t q_bar;
  // the swizzle atoms want 1024-byte aligned tiles
  unsigned char* base =
      smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw));
  unsigned char* qs = base;
  unsigned char* ks = base + C::kQBytes;                  // + stage * kTileBytes
  unsigned char* vs = ks + C::kStages * C::kTileBytes;

  const int kh = blockIdx.y;
  const int n = blockIdx.z;
  const int tpb = kBlockM / G;                            // tokens a block
  const int tok0 = (gridDim.x - 1 - blockIdx.x) * tpb;    // last tiles first
  const int rows = tpb * G;
  const int len = max(0, min(lengths[n], T_len));
  const int tok_last = min(tok0 + tpb - 1, T_len - 1);
  // -1 when len == 0: no key tile
  const int last_tile =
      min(tok_last / kBlockN, (len + kBlockN - 1) / kBlockN - 1);
  const int tid = threadIdx.x;

  if (tid == 0) {
#pragma unroll
    for (int st = 0; st < C::kStages; ++st) {
      mbar_init(&full_bar[st], 1);
      mbar_init(&empty_bar[st], kConsumers * 4);   // one arrival per warp
    }
    mbar_init(&q_bar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // warp-uniform for the compiler (a plain tid / 128 reads as divergent,
  // and ptxas then serializes every wgmma)
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == kConsumers) {
    // --- producer warpgroup: one thread keeps the ring full ---------------
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (tid == kConsumers * 128) {
      mbar_expect_tx(&q_bar, C::kCols * rows * kRowBytes);
#pragma unroll
      for (int cb = 0; cb < C::kCols; ++cb)
        tma_load_5d(qs + cb * kQBox, &tm_q, &q_bar, cb * 64, 0, kh, tok0,
                    n);
      for (int kt = 0; kt <= last_tile; ++kt) {
        const int st = kt % C::kStages;
        const int use = kt / C::kStages;
        if (use > 0) mbar_wait(&empty_bar[st], (use - 1) & 1);
        mbar_expect_tx(&full_bar[st], 2 * C::kTileBytes);
#pragma unroll
        for (int cb = 0; cb < C::kCols; ++cb) {
          const int off = st * C::kTileBytes + cb * C::kKvBox;
          tma_load_4d(ks + off, &tm_k, &full_bar[st], cb * 64, kh,
                      kt * kBlockN, n);
          tma_load_4d(vs + off, &tm_v, &full_bar[st], cb * 64, kh,
                      kt * kBlockN, n);
        }
      }
    }
  } else {
    // --- consumer warpgroups: 64 rows each ---------------------------------
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int wtid = tid % 128;
    const int warp = wtid / 32;
    const int lane = tid % 32;
    const int group = lane / 4;
    const int quad = lane % 4;
    const int r_wg = wg * 64;                     // first row of the warpgroup
    const int wg_first_tok = tok0 + r_wg / G;
    const int wg_last_tok = tok0 + min(r_wg + 63, rows - 1) / G;
    // the last tile this warpgroup computes: later ones lie wholly above
    // its diagonal
    const int my_last = min(last_tile, wg_last_tok / kBlockN);
    int row[2], tok[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      row[h] = r_wg + warp * 16 + group + 8 * h;
      tok[h] = tok0 + row[h] / G;
    }

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float s[kBlockN / 2];
    uint32_t pa[kBlockN / 16][4];                 // P of the previous tile
    float m[2] = {-INFINITY, -INFINITY};          // row max, scaled log2 units
    float l[2] = {0.f, 0.f};                      // this lane's partial sums
    const uint32_t q_addr = smem_u32(qs) + r_wg * kRowBytes;
    mbar_wait(&q_bar, 0);

    // Tile kt: wait for its stage, zero its dead V rows on the length-edge
    // tile, start S_kt = Q K_kt^T (uncommitted groups stay in flight).
    auto start_scores = [&](int kt) {
      const int st = kt % C::kStages;
      const int key0 = kt * kBlockN;
      mbar_wait(&full_bar[st], (kt / C::kStages) & 1);
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
    // O += P_kt V_kt from the P registers (left in flight)
    auto start_values = [&](int kt) {
      const uint32_t v_addr =
          smem_u32(vs + (kt % C::kStages) * C::kTileBytes);
      fence_regs(o);
      wgmma_fence();
#pragma unroll
      for (int k16 = 0; k16 < kBlockN / 16; ++k16)
        wgmma_pv<T, D>(o, pa[k16], desc_mn_major(v_addr + k16 * 2048, C::kKvBox));
      wgmma_commit();
      fence_regs(o);
    };
    // online softmax of tile kt's scores: masks only across the diagonal or
    // the length; returns the rescale factors of O and leaves P in s
    auto softmax = [&](int kt, float (&alpha)[2]) {
      const int key0 = kt * kBlockN;
      if (key0 + kBlockN > min(wg_first_tok + 1, len)) {
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          const int key = key0 + (i / 4) * 8 + quad * 2 + (i % 2);
          if (key > tok[(i / 2) % 2] || key >= len) s[i] = -INFINITY;
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
        const float m_new = fmaxf(m[h], tmax[h] * scale_log2);
        m_safe[h] = m_new == -INFINITY ? 0.f : m_new;
        alpha[h] = fast_exp2(m[h] - m_safe[h]);   // 0 while m is -inf
        m[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        const int h = (i / 2) % 2;
        s[i] = fast_exp2(fmaf(s[i], scale_log2, -m_safe[h]));   // -inf -> 0
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

    // Ping-pong: the two warpgroups take turns to start their products
    // (named barriers 3 and 4), so one warpgroup's softmax runs while the
    // other's products hold the tensor cores. Both run last_tile + 2 turns
    // (tile 0's S; S_kt with P_{kt-1} V_{kt-1}; the last value product; one
    // empty turn a tile wholly above the diagonal), so every wait is met;
    // warpgroup 1 lets warpgroup 0 go first and skips its very last signal.
    const int turns = last_tile + 2;
    int turn = 0;
    auto take_turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" :: "r"(3 + wg) : "memory");
    };
    auto pass_turn = [&]() {
      if (++turn < turns || wg == 0)
        asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - wg) : "memory");
    };
    if (wg == 1 && last_tile >= 0)
      asm volatile("bar.arrive 3, 256;\n" ::: "memory");

    // Tile 0 alone; then each tile starts S_kt together with the value
    // product of tile kt - 1, and its softmax runs while that product is
    // in flight.
    if (my_last >= 0) {
      float alpha[2];
      take_turn();
      start_scores(0);
      pass_turn();
      wgmma_wait<0>();
      fence_regs(s);
      softmax(0, alpha);
      pack_p();
    }
    for (int kt = 1; kt <= my_last; ++kt) {
      float alpha[2];
      take_turn();
      start_scores(kt);
      start_values(kt - 1);
      pass_turn();
      wgmma_wait<1>();                            // S_kt is done
      fence_regs(s);
      softmax(kt, alpha);
      wgmma_wait<0>();                            // P_{kt-1} V_{kt-1} is in O
      fence_regs(o);
      if (lane == 0) mbar_arrive(&empty_bar[(kt - 1) % C::kStages]);
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
      if (lane == 0) mbar_arrive(&empty_bar[my_last % C::kStages]);
    }
    for (int kt = my_last + 1; kt <= last_tile; ++kt) {
      // wholly above this warpgroup's diagonal: release the stage unread
      take_turn();
      pass_turn();
      const int st = kt % C::kStages;
      mbar_wait(&full_bar[st], (kt / C::kStages) & 1);
      if (lane == 0) mbar_arrive(&empty_bar[st]);
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
      T* dst =
          out + ((((size_t)n * T_len + tok[h]) * KH + kh) * G + row[h] % G) * D;
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
                   const int32_t* lengths, void* out, int N, int T_len, int KH,
                   int G, float scale, cudaStream_t stream) {
  using C = Config<D>;
  const int tpb = kBlockM / G;
  CUtensorMap tm_q, tm_k, tm_v;
  const cuuint64_t q_dims[5] = {(cuuint64_t)D, (cuuint64_t)G, (cuuint64_t)KH,
                                (cuuint64_t)T_len, (cuuint64_t)N};
  const cuuint32_t q_box[5] = {64, (cuuint32_t)G, 1, (cuuint32_t)tpb, 1};
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
  const dim3 grid((T_len + tpb - 1) / tpb, KH, N);
  flash_prefill_kernel<T, D><<<grid, kThreads, C::kSmem, stream>>>(
      tm_q, tm_k, tm_v, lengths, static_cast<T*>(out), T_len, KH, G,
      scale * 1.4426950408889634f);
  return cudaGetLastError();
}

// The float32 kernel, on the CUDA cores in fp32 FMA (the JAX kernel casts q,
// k and v to f32 and computes in f32; a single TF32 pass would keep 10 of
// the 23 mantissa bits). A block takes kF32Rows query tokens of one query
// head; each token's row is held by kF32Lanes neighbouring threads, each
// with the dims lane + kF32Lanes * i of q and of the accumulator in
// registers. K and V tiles of kF32Keys keys go through shared memory by
// 16-byte loads (value rows at or past the length zeroed), a score is
// summed across the row's threads by shuffles, and the online softmax runs
// in exp2 units as the wgmma kernel's does. Bound by its FMAs and shuffles:
// no family the port serves runs fp32 on the card.
constexpr int kF32Threads = 256;
constexpr int kF32Lanes = 8;                        // threads a query row
constexpr int kF32Rows = kF32Threads / kF32Lanes;   // query tokens a block
// keys a tile: 32, or 16 at D 192 / 256 (the static 48 KB of K and V)
template <int D>
constexpr int kF32Keys = D <= 128 ? 32 : 16;

template <int D>
__global__ void __launch_bounds__(kF32Threads)
flash_prefill_f32_kernel(const float* __restrict__ q,   // [N, T, KH, G, D]
                         const float* __restrict__ k,   // [N, T, KH, D]
                         const float* __restrict__ v,
                         const int32_t* __restrict__ lengths,
                         float* __restrict__ out,       // [N, T, KH, G, D]
                         int T_len, int KH, int G, float scale_log2) {
  constexpr int kDims = D / kF32Lanes;                 // dims a thread holds
  constexpr int kVecs = kF32Keys<D> * D / 4 / kF32Threads;   // float4 a thread
  __shared__ __align__(16) float k_s[kF32Keys<D> * D];
  __shared__ __align__(16) float v_s[kF32Keys<D> * D];
  const int n = blockIdx.z;
  const int kh = blockIdx.y / G;
  const int g = blockIdx.y % G;
  const int tid = threadIdx.x;
  const int r = tid / kF32Lanes;
  const int j = tid % kF32Lanes;
  // the last row tiles first: the longest walks start first
  const int tok0 = (gridDim.x - 1 - blockIdx.x) * kF32Rows;
  const int tok = tok0 + r;
  const int len = max(0, min(lengths[n], T_len));
  const int last_key = min(min(tok0 + kF32Rows - 1, T_len - 1), len - 1);
  const size_t q_row = ((((size_t)n * T_len + tok) * KH + kh) * G + g) * D;

  float qv[kDims], acc[kDims];
#pragma unroll
  for (int i = 0; i < kDims; ++i) {
    qv[i] = tok < T_len ? q[q_row + j + kF32Lanes * i] * scale_log2 : 0.f;
    acc[i] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int key0 = 0; key0 <= last_key; key0 += kF32Keys<D>) {
    __syncthreads();                          // the last tile is consumed
#pragma unroll
    for (int i = 0; i < kVecs; ++i) {
      const int e = (tid + i * kF32Threads) * 4;
      const int key = key0 + e / D;
      const bool live = key < len;
      const size_t off = (((size_t)n * T_len + key) * KH + kh) * D + e % D;
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(k_s + e) =
          live ? *reinterpret_cast<const float4*>(k + off) : zero;
      *reinterpret_cast<float4*>(v_s + e) =
          live ? *reinterpret_cast<const float4*>(v + off) : zero;
    }
    __syncthreads();
    float sc[kF32Keys<D>];
    float tmax = -INFINITY;
#pragma unroll
    for (int jj = 0; jj < kF32Keys<D>; ++jj) {
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        dot = fmaf(qv[i], k_s[jj * D + j + kF32Lanes * i], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      dot += __shfl_xor_sync(0xffffffffu, dot, 4);
      const int key = key0 + jj;
      sc[jj] = (key <= tok && key < len) ? dot : -INFINITY;
      tmax = fmaxf(tmax, sc[jj]);
    }
    const float m_new = fmaxf(m, tmax);
    const float m_safe = m_new == -INFINITY ? 0.f : m_new;
    const float alpha = m == -INFINITY ? 0.f : exp2f(m - m_safe);
    m = m_new;
    l *= alpha;
#pragma unroll
    for (int i = 0; i < kDims; ++i) acc[i] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kF32Keys<D>; ++jj) {
      const float p = sc[jj] == -INFINITY ? 0.f : exp2f(sc[jj] - m_safe);
      l += p;
#pragma unroll
      for (int i = 0; i < kDims; ++i)
        acc[i] = fmaf(p, v_s[jj * D + j + kF32Lanes * i], acc[i]);
    }
  }
  if (tok >= T_len) return;
  const float inv = 1.f / fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kDims; ++i) out[q_row + j + kF32Lanes * i] = acc[i] * inv;
}

template <int D>
cudaError_t launch_f32_d(const void* q, const void* k, const void* v,
                         const int32_t* lengths, void* out, int N, int T_len,
                         int KH, int G, float scale, cudaStream_t stream) {
  const dim3 grid((T_len + kF32Rows - 1) / kF32Rows, KH * G, N);
  flash_prefill_f32_kernel<D><<<grid, kF32Threads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), lengths, static_cast<float*>(out), T_len,
      KH, G, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

cudaError_t launch_f32(const void* q, const void* k, const void* v,
                       const int32_t* lengths, void* out, int N, int T_len,
                       int KH, int G, int D, float scale, cudaStream_t stream) {
  if ((long long)KH * G > 65535) return cudaErrorInvalidValue;
  switch (D) {
    case 64: return launch_f32_d<64>(q, k, v, lengths, out, N, T_len, KH, G, scale, stream);
    case 128: return launch_f32_d<128>(q, k, v, lengths, out, N, T_len, KH, G, scale, stream);
    case 192: return launch_f32_d<192>(q, k, v, lengths, out, N, T_len, KH, G, scale, stream);
    case 256: return launch_f32_d<256>(q, k, v, lengths, out, N, T_len, KH, G, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 bf16 and 1 fp16 (the wgmma kernel), 2 fp32 (the CUDA-core
// kernel); D 64, 128, 192 or 256
extern "C" int tgi_flash_prefill(const void* q, const void* k, const void* v,
                                 const int32_t* lengths, void* out, int N,
                                 int T, int KH, int G, int D, int dtype,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // TMA wants 16-byte aligned bases; a block holds at least one token
  if (N <= 0 || T <= 0 || KH <= 0 || G <= 0 || G > kBlockM || KH > 65535 ||
      N > 65535 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
#define TGI_FLASH_D(TY)                                                        \
  switch (D) {                                                                 \
    case 64: return (int)launch<TY, 64>(q, k, v, lengths, out, N, T, KH, G, scale, s);   \
    case 128: return (int)launch<TY, 128>(q, k, v, lengths, out, N, T, KH, G, scale, s); \
    case 192: return (int)launch<TY, 192>(q, k, v, lengths, out, N, T, KH, G, scale, s); \
    case 256: return (int)launch<TY, 256>(q, k, v, lengths, out, N, T, KH, G, scale, s); \
    default: return (int)cudaErrorInvalidValue;                                \
  }
  switch (dtype) {
    case 0: TGI_FLASH_D(__nv_bfloat16)
    case 1: TGI_FLASH_D(__half)
    case 2: return (int)launch_f32(q, k, v, lengths, out, N, T, KH, G, D, scale, s);
    default: return (int)cudaErrorInvalidValue;
  }
#undef TGI_FLASH_D
}

extern "C" const char* tgi_flash_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
