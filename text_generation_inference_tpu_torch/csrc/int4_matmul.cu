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
//   Decode (M <= 64; its main loop is csrc/int4_decode.cuh, shared with
//     the fused MLP M1): the operands are swapped, y^T = W^T x^T, so the
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

#include "int4_decode.cuh"

namespace {

using namespace hopper;
using namespace int4dec;

constexpr int kMaxSplits = 16;
constexpr int kDecodeRows = 64;         // rows the decode schedule takes

// decode schedule: the ring's depth (csrc/int4_decode.cuh)
constexpr int kDecStages = 6;
constexpr int kWBytes = kWordRows * kBN * 4;    // a prefill stage's words

// prefill schedule
constexpr int kPreThreads = 384;        // two consumer warpgroups + producer
constexpr int kPreBM = 128;             // x rows a block (wgmma's N)
constexpr int kPreStages = 8;
constexpr int kXTile = kPreBM * kBK * 2;        // [128 rows][64] 16-bit
// x tile, words, group parameters; 1024-aligned for the x tiles' swizzle
constexpr int kPreStage = (kXTile + kWBytes + kParamBytes + 1023) / 1024 * 1024;
constexpr int kPreSmem = kPreStages * kPreStage + 1024;

enum XType { kXBf16 = 0, kXFp16 = 1, kXFp32 = 2 };

// Nibbles `shift / 4` and `shift / 4 + 1` of w as two operands of type MT,
// q - zero - 1 each, exactly
template <typename MT>
__device__ __forceinline__ uint32_t nib_pair(uint32_t w, int shift,
                                             uint32_t zpair, uint32_t magic2) {
  const uint32_t t = w >> shift;
  return sub_pair<MT>((t & 0xFu) | ((t & 0xF0u) << 12) | magic2, zpair);
}

// the barrier sees one arrival when this thread's earlier cp.async copies
// have landed
__device__ __forceinline__ void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
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

// kSub: 128-column sub-blocks a block takes (each warp 16 columns of each),
// 2 up to 32 rows, where a warp's x fragments then serve two A fragments;
// the split plan counts 128-column units either way, so a row's summation
// order does not depend on kSub
template <typename XT, int BM, int kSub>
__global__ void __launch_bounds__(kThreads)
k1_decode_kernel(const Args a) {
  using L = Layout<XT, BM, kSub, kDecStages>;
  constexpr int kNT = BM / 8;                       // n8 tiles of x rows
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last_s;

  const int n0 = blockIdx.x * L::kCols;
  const int split = blockIdx.y;
  const int m0 = blockIdx.z * BM;
  const int tiles = a.K / kBK;
  const int t0 = (int)((long long)tiles * split / a.splits);
  const int t1 = (int)((long long)tiles * (split + 1) / a.splits);
  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int q = lane % 4;
  const int c_a = (tid / 32) * 16 + lane / 4;

  float tot[kSub][kNT][4];
  decode_tiles<XT, BM, kSub, kDecStages>(
      smem, static_cast<const XT*>(a.x) + (size_t)m0 * a.K, a.M - m0, a.K,
      a.qweight, a.scales, a.qzeros, a.N, Cols{n0, kBN, a.N, 0}, a.gs, t0, t1,
      tot);

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
  for (int i = tid; i < a.M * (L::kCols / 4); i += kThreads) {
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
        copy_group_params(pb, pb + kScBytes, scales, qzeros, N, n0, N,
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
  using L = Layout<XT, BM, kSub, kDecStages>;
  static bool attr_set[64] = {};
  const cudaError_t err =
      allow_smem(k1_decode_kernel<XT, BM, kSub>, L::kSmem, attr_set);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.N + L::kCols - 1) / L::kCols, a.splits, (a.M + BM - 1) / BM);
  k1_decode_kernel<XT, BM, kSub><<<grid, kThreads, L::kSmem, stream>>>(a);
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
