// Causal flash attention over right-padded prefill buckets, for sm_90a.
//
// Replaces: the JAX package's ops/pallas/flash_prefill.py
//           flash_prefill (the Pallas `_kernel`, pallas_call at :143).
//
// q, k, v and out are bf16, or fp16 when the entry's `half` is nonzero (the
// kernel is templated on the element type T; only the wgmma type, the
// tensor maps' type and the rounding of P and of the output differ).
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
//     T, N)), then K and V tiles of 128 keys (4-D maps over (D, KH, T, N);
//     a tile past T is zero-filled by the hardware) into a ring of kStages
//     stages with full / empty barriers, 128-byte swizzled in [D / 64]
//     column blocks of [rows][64]. The maps are encoded per call on the
//     host through cudaGetDriverEntryPoint (no link flag) and passed as
//     __grid_constant__ parameters.
//   - Products. Both on wgmma with fp32 accumulators in registers:
//     S = Q K^T (m64n128k16, A = Q and B = the K tile from shared memory,
//     both K-major), then O += P V (m64nDk16, A = P from registers, rounded
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

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockM = 128;                 // rows (token * G + g) a block
constexpr int kBlockN = 128;                 // keys a tile
constexpr int kConsumers = 2;                // warpgroups of 64 rows
constexpr int kThreads = (kConsumers + 1) * 128;
constexpr int kBoxBytes = 128 * 64 * 2;      // one [128 rows][64] box of T
constexpr uint32_t kRowBytes = 128;          // one swizzled row of 64 T

template <int D>
struct Config {
  static constexpr int kCols = D / 64;       // 64-column blocks of the head dim
  static constexpr int kStages = D == 64 ? 4 : 3;   // 225 KB at D = 128
  static constexpr int kTileBytes = kCols * kBoxBytes;   // Q, one K, one V
  static constexpr int kSmem = kTileBytes * (1 + 2 * kStages) + 1024;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
      :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      :: "r"(smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1,
                                            int c2, int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      :: "r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
         "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(c4)
      : "memory");
}

// wgmma shared-memory matrix descriptor, 128-byte swizzle: start address,
// leading and stride byte offsets (16-byte units)
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFFu) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// K-major operand (Q, K): 8-row groups of 128-byte rows, 1024 bytes apart
__device__ __forceinline__ uint64_t desc_k_major(uint32_t addr) {
  return smem_desc(addr, 16, 1024);
}

// MN-major operand (V): the 64-column blocks kBoxBytes apart, 8-key groups
// 1024 bytes apart
__device__ __forceinline__ uint64_t desc_mn_major(uint32_t addr) {
  return smem_desc(addr, kBoxBytes, 1024);
}

// 2^x on the special-function unit (2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// wait until at most N committed wgmma groups are still in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}

// keeps the compiler from touching accumulators across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i]) :: "memory");
}

// the wgmma element type of T, for the instruction strings below
template <typename T>
constexpr bool kIsHalf = false;
template <>
constexpr bool kIsHalf<__half> = true;

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]; A and B from shared memory, both
// K-major (128B swizzle); accumulate == 0 overwrites D
#define TGI_WGMMA_SS_N128(TY)                                                 \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "     \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "      \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "      \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "      \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, "    \
      "1, 0, 0;\n}\n"                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),         \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),         \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),         \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),         \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),         \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),         \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),         \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),         \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),         \
      "+f"(d[62]), "+f"(d[63])                                                 \
      : "l"(desc_a), "l"(desc_b), "r"(accumulate))

template <typename T>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t desc_a,
                                              uint64_t desc_b, int accumulate) {
  if constexpr (kIsHalf<T>) TGI_WGMMA_SS_N128("f16");
  else TGI_WGMMA_SS_N128("bf16");
}
#undef TGI_WGMMA_SS_N128

// D[64 x 64] += A[64 x 16] B[16 x 64]; A from registers, B from shared
// memory MN-major (128B swizzle)
#define TGI_WGMMA_RS_N64(TY)                                                  \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " "              \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"      \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),         \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),         \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),         \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])          \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  if constexpr (kIsHalf<T>) TGI_WGMMA_RS_N64("f16");
  else TGI_WGMMA_RS_N64("bf16");
}
#undef TGI_WGMMA_RS_N64

// D[64 x 128] += A[64 x 16] B[16 x 128]; A from registers, B from shared
// memory MN-major (128B swizzle)
#define TGI_WGMMA_RS_N128(TY)                                                 \
  asm volatile(                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                            \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " "             \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "    \
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "     \
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "     \
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "     \
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, "   \
      "%67}, %68, p, 1, 1, 1;\n}\n"                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), \
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]),         \
      "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),         \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]),         \
      "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),         \
      "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),         \
      "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),         \
      "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]),         \
      "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),         \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]),         \
      "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]),         \
      "+f"(d[62]), "+f"(d[63])                                                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1))

template <typename T>
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                              const uint32_t (&a)[4],
                                              uint64_t desc_b) {
  if constexpr (kIsHalf<T>) TGI_WGMMA_RS_N128("f16");
  else TGI_WGMMA_RS_N128("bf16");
}
#undef TGI_WGMMA_RS_N128

template <typename T, int D>
__device__ __forceinline__ void wgmma_pv(float (&o)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (D == 64) wgmma_rs_n64<T>(o, a, desc_b);
  else wgmma_rs_n128<T>(o, a, desc_b);
}

// two floats rounded to T, lower element in the lower half
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kIsHalf<T>) {
    const __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  } else {
    const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
    return *reinterpret_cast<const uint32_t*>(&v);
  }
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
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full_bar[C::kStages];
  __shared__ __align__(8) uint64_t empty_bar[C::kStages];
  __shared__ __align__(8) uint64_t q_bar;
  // the swizzle atoms want 1024-byte aligned tiles
  unsigned char* base =
      smem_raw + (((smem_u32(smem_raw) + 1023u) & ~1023u) - smem_u32(smem_raw));
  unsigned char* qs = base;
  unsigned char* ks = base + C::kTileBytes;               // + stage * kTileBytes
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
        tma_load_5d(qs + cb * kBoxBytes, &tm_q, &q_bar, cb * 64, 0, kh, tok0,
                    n);
      for (int kt = 0; kt <= last_tile; ++kt) {
        const int st = kt % C::kStages;
        const int use = kt / C::kStages;
        if (use > 0) mbar_wait(&empty_bar[st], (use - 1) & 1);
        mbar_expect_tx(&full_bar[st], 2 * C::kTileBytes);
#pragma unroll
        for (int cb = 0; cb < C::kCols; ++cb) {
          const int off = st * C::kTileBytes + cb * kBoxBytes;
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
    float s[64];
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
          *reinterpret_cast<uint4*>(v_tile + (c / 8) * kBoxBytes +
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
        const uint32_t off = (ks16 / 4) * kBoxBytes + (ks16 % 4) * 32;
        wgmma_ss_n128<T>(s, desc_k_major(q_addr + off),
                      desc_k_major(k_addr + off), ks16 > 0);
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
        wgmma_pv<T, D>(o, pa[k16], desc_mn_major(v_addr + k16 * 2048));
      wgmma_commit();
      fence_regs(o);
    };
    // online softmax of tile kt's scores: masks only across the diagonal or
    // the length; returns the rescale factors of O and leaves P in s
    auto softmax = [&](int kt, float (&alpha)[2]) {
      const int key0 = kt * kBlockN;
      if (key0 + kBlockN > min(wg_first_tok + 1, len)) {
#pragma unroll
        for (int i = 0; i < 64; ++i) {
          const int key = key0 + (i / 4) * 8 + quad * 2 + (i % 2);
          if (key > tok[(i / 2) % 2] || key >= len) s[i] = -INFINITY;
        }
      }
      float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int i = 0; i < 64; ++i) tmax[(i / 2) % 2] = fmaxf(tmax[(i / 2) % 2], s[i]);
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
      for (int i = 0; i < 64; ++i) {
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

using EncodeTiled = decltype(&cuTensorMapEncodeTiled);

// cuTensorMapEncodeTiled from the driver, without linking libcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err != cudaSuccess || found != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
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
  const cuuint32_t kv_box[4] = {64, 1, kBlockN, 1};
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

}  // namespace

extern "C" int tgi_flash_prefill(const void* q, const void* k, const void* v,
                                 const int32_t* lengths, void* out, int N,
                                 int T, int KH, int G, int D, int half,
                                 float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // TMA wants 16-byte aligned bases; a block holds at least one token
  if (N <= 0 || T <= 0 || KH <= 0 || G <= 0 || G > kBlockM || KH > 65535 ||
      N > 65535 ||
      ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16)
    return (int)cudaErrorInvalidValue;
  if (half) {
    if (D == 64) return (int)launch<__half, 64>(q, k, v, lengths, out, N, T, KH, G, scale, s);
    if (D == 128) return (int)launch<__half, 128>(q, k, v, lengths, out, N, T, KH, G, scale, s);
  } else {
    if (D == 64) return (int)launch<__nv_bfloat16, 64>(q, k, v, lengths, out, N, T, KH, G, scale, s);
    if (D == 128) return (int)launch<__nv_bfloat16, 128>(q, k, v, lengths, out, N, T, KH, G, scale, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tgi_flash_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
