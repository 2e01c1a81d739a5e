// Fused GPTQ-INT4 GLU MLP for sm_90a (kernel M1), decode rows only:
//   y = a @ dequant(down),  a = act(x @ dequant(gate)) * (x @ dequant(up))
// for one layer of a layer-stacked pair, S <= 64 rows.
//
// Replaces: the JAX package's ops/pallas/int4_matmul.py
//   int4_mlp_s4_stacked (`_kernel_mlp_s4_stacked`, pallas_call at :366).
// The TPU kernel walked blocks of the intermediate dim in order and kept the
// [S, H] sum in VMEM. On the GPU the blocks run in parallel, so the launch is
// one block for each work item over K1's decode schedule
// (csrc/int4_decode.cuh), with no grid-wide barrier:
//   - gate/up items: a block of 128 intermediate columns (its 128 gate
//     columns of w_gu and the matching 128 up columns, the two 128-column
//     sub-blocks of the schedule), one K split of H, one tile of rows. The
//     last split to arrive at the column block adds the splits' fp32
//     partials in split order, applies the activation in fp32, writes
//     a = act(g) * u rounded to x's dtype (the compute dtype) and raises
//     the slice's ready flag;
//   - down items: 256 columns of H, one K split of I, one row tile. An item
//     waits only on the ready flags of the slices of I its split reads;
//     the last split to arrive at the column block adds the partials in
//     split order and writes y in x's dtype.
// A block takes its item from a ticket counter as it starts, so items are
// taken in order, every gate/up item before any down item: a block waiting
// on a flag waits on gate/up items that running blocks hold, never on an
// item no block has taken, whatever order the card starts blocks in.
// The splits come from (N, K) alone (the wrapper's split plans), never M,
// and every sum runs in one fixed order: a row's result is the same bits
// alone or in a batch, run to run. Every counter and flag is reset by the
// kernel (the last arrival, the last reader), so no memset runs; the
// partials and `a` live in the wrapper's per-device workspace.
//
// Layouts, as the loader stores them (GPTQ natural layout): x [S, H] in
// bf16, fp16 or fp32; y [S, H] in x's dtype; gu qweight [H/8, 2I] int32 (gate
// columns [0, I), up columns [I, 2I), models/fuse.py), qzeros [H/gs, 2I/8],
// scales [H/gs, 2I] f32; down qweight [I/8, H], qzeros [I/gs, H/8], scales
// [I/gs, H]. The weights enter the tensor cores as the exact integers
// q - zero - 1, as in K1; fp32 x (and fp32 a) as two bf16 terms.
//
// What bounds it on an H100: 2 * S flops per weight nibble at S <= 64, far
// below the 295 flops a byte the card needs to leave the memory bound: it is
// bound by the ~73 MB of words, scales and zero points of a 7B layer (3.35
// TB/s, ~0.022 ms). The partials and `a` stay in L2.

#include "int4_decode.cuh"

namespace {

using namespace int4dec;

constexpr int kStages = 4;
constexpr int kSub = 2;                 // gate + up, or 256 columns of H
constexpr int kMaxSplits = 16;
constexpr int kSiluGlu = 0;
constexpr int kGeluGlu = 1;

template <int ACT>
__device__ __forceinline__ float glu(float g, float u) {
  if (ACT == kSiluGlu) return g / (1.f + expf(-g)) * u;
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f)) * u;   // erf GELU
}

__device__ __forceinline__ unsigned int load_acquire(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];\n"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void store_release(unsigned int* p,
                                              unsigned int v) {
  asm volatile("st.release.gpu.global.u32 [%0], %1;\n"
               :: "l"(p), "r"(v) : "memory");
}

struct Args {
  const void* x;                          // [M, H] in XT
  const int32_t* gu_q;                    // [H/8, 2I]
  const int32_t* gu_z;                    // [H/gs_gu, 2I/8]
  const float* gu_s;                      // [H/gs_gu, 2I]
  const int32_t* d_q;                     // [I/8, H]
  const int32_t* d_z;                     // [I/gs_down, H/8]
  const float* d_s;                       // [I/gs_down, H]
  float* part_gu;                         // [splits_gu, M, 2I]
  float* part_d;                          // [splits_down, M, H]
  void* a;                                // [M, I] in XT
  // per (column block, row tile), all zero: gate/up arrivals, ready flags,
  // readers of each ready flag, down arrivals; then the ticket
  unsigned int* arrive_gu;
  unsigned int* ready;
  unsigned int* readers;
  unsigned int* arrive_d;
  unsigned int* ticket;
  void* y;                                // [M, H] in XT
  int M, H, I, gs_gu, gs_down, splits_gu, splits_down, row_tiles;
};

int block_rows(int M) { return M <= 16 ? 16 : (M <= 32 ? 32 : 64); }

// the K tiles [t0, t1) of split s of `splits` over `tiles`
__device__ __forceinline__ int split_begin(int tiles, int s, int splits) {
  return (int)((long long)tiles * s / splits);
}

// The last block to arrive at counter `c` (of `total` arrivals) sees true
// and resets it; every thread of the block returns the same.
__device__ __forceinline__ bool last_arrival(unsigned int* c, int total,
                                             bool* last_s) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const unsigned int prev = atomicAdd(c, 1u);
    *last_s = prev == (unsigned int)(total - 1);
    if (*last_s) *c = 0u;                 // ready for the next launch
  }
  __syncthreads();
  const bool last = *last_s;
  if (last) __threadfence();
  return last;
}

template <typename XT, int BM, int ACT>
__global__ void __launch_bounds__(kThreads)
int4_mlp_kernel(const Args a) {
  using L = Layout<XT, BM, kSub, kStages>;
  constexpr int kNT = BM / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last_s;
  __shared__ int item_s;

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int q = lane % 4;
  const int c_a = (tid / 32) * 16 + lane / 4;
  const int M = a.M, H = a.H, I = a.I;
  const int rt = a.row_tiles;
  const int blocks_gu = (I + kBN - 1) / kBN;
  const int blocks_d = (H + kSub * kBN - 1) / (kSub * kBN);
  const int items_gu = blocks_gu * a.splits_gu * rt;
  const int items = items_gu + blocks_d * a.splits_down * rt;
  const XT* x = static_cast<const XT*>(a.x);
  XT* abuf = static_cast<XT*>(a.a);
  XT* y = static_cast<XT*>(a.y);
  float tot[kSub][kNT][4];

  if (tid == 0) {
    const unsigned int t = atomicAdd(a.ticket, 1u);
    // the last ticket: every block holds its own, reset for the next launch
    if (t == (unsigned int)(items - 1)) *a.ticket = 0u;
    item_s = (int)t;
  }
  __syncthreads();
  const int item = item_s;
  if (item < items_gu) {
    // --- gate/up: columns i0 + [0, 128) of a, split s of H, row tile r
    const int r = item % rt;
    const int s = (item / rt) % a.splits_gu;
    const int cb = item / rt / a.splits_gu;
    const int i0 = cb * kBN;
    const int m0 = r * BM;
    const int tiles = H / kBK;
    decode_tiles<XT, BM, kSub, kStages>(
        smem, x + (size_t)m0 * H, M - m0, H, a.gu_q, a.gu_s, a.gu_z, 2 * I,
        Cols{i0, I, I, I}, a.gs_gu, split_begin(tiles, s, a.splits_gu),
        split_begin(tiles, s + 1, a.splits_gu), tot);
    const int slot = cb * rt + r;
    bool raise = true;                  // this block writes the slice
    if (a.splits_gu == 1) {
      // the gate and up columns c_a (+ 8) are this thread's sub-blocks
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + 8 * j + 2 * q + (e & 1);
          const int i = i0 + c_a + (e < 2 ? 0 : 8);
          if (m < M && i < I)
            abuf[(size_t)m * I + i] =
                from_float<XT>(glu<ACT>(tot[0][j][e], tot[1][j][e]));
        }
    } else {
#pragma unroll
      for (int u = 0; u < kSub; ++u)
#pragma unroll
        for (int j = 0; j < kNT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = m0 + 8 * j + 2 * q + (e & 1);
            const int i = i0 + c_a + (e < 2 ? 0 : 8);
            if (m < M && i < I)
              a.part_gu[((size_t)s * M + m) * 2 * I + u * I + i] =
                  tot[u][j][e];
          }
      raise = last_arrival(&a.arrive_gu[slot], a.splits_gu, &last_s);
      if (raise) {
        // four columns a thread: every split's gate and up partials
        // loaded, added in split order, the activation in fp32
        for (int idx = tid; idx < BM * (kBN / 4); idx += kThreads) {
          const int m = m0 + idx / (kBN / 4);
          const int i = i0 + 4 * (idx % (kBN / 4));
          if (m >= M || i >= I) continue;
          float4 g = make_float4(0.f, 0.f, 0.f, 0.f), u = g;
          for (int sp = 0; sp < a.splits_gu; ++sp) {
            const float* p = a.part_gu + ((size_t)sp * M + m) * 2 * I + i;
            const float4 pg = __ldcg(reinterpret_cast<const float4*>(p));
            const float4 pu = __ldcg(reinterpret_cast<const float4*>(p + I));
            g.x += pg.x; g.y += pg.y; g.z += pg.z; g.w += pg.w;
            u.x += pu.x; u.y += pu.y; u.z += pu.z; u.w += pu.w;
          }
          XT* dst = abuf + (size_t)m * I + i;
          dst[0] = from_float<XT>(glu<ACT>(g.x, u.x));
          dst[1] = from_float<XT>(glu<ACT>(g.y, u.y));
          dst[2] = from_float<XT>(glu<ACT>(g.z, u.z));
          dst[3] = from_float<XT>(glu<ACT>(g.w, u.w));
        }
      }
    }
    if (raise) {
      // a[rows of r, i0 + [0, 128)] is written: raise the slice's flag
      __threadfence();
      __syncthreads();
      if (tid == 0) store_release(&a.ready[slot], 1u);
    }
  } else {
    // --- down: columns h0 + [0, 256) of y, split s of I, row tile r
    const int d = item - items_gu;
    const int r = d % rt;
    const int cb = (d / rt) % blocks_d;
    const int s = d / rt / blocks_d;
    const int h0 = cb * kSub * kBN;
    const int m0 = r * BM;
    const int tiles = I / kBK;
    const int t0 = split_begin(tiles, s, a.splits_down);
    const int t1 = split_begin(tiles, s + 1, a.splits_down);
    // Wait for the slices of a this split reads (two K tiles a slice), a
    // lane of warp 0 a slice, once the first stages' weights are in
    // flight; then count this item among each flag's readers: the last
    // reader lowers the flag for the next launch.
    auto wait_slices = [&]() {
      if (tid < 32) {
        for (int j = t0 / 2 + lane; j <= (t1 - 1) / 2; j += 32) {
          unsigned int* flag = &a.ready[j * rt + r];
          // a flag never raised is a fault: trap (a launch error) after
          // seconds rather than hang the card
          for (long long spins = 0; load_acquire(flag) == 0u; ++spins) {
            if (spins > (1ll << 26)) __trap();
            __nanosleep(64);
          }
          unsigned int readers = 0;
          for (int sp = 0; sp < a.splits_down; ++sp)
            readers += split_begin(tiles, sp, a.splits_down) < 2 * j + 2 &&
                       split_begin(tiles, sp + 1, a.splits_down) > 2 * j;
          readers *= blocks_d;
          if (atomicAdd(&a.readers[j * rt + r], 1u) + 1u == readers) {
            a.readers[j * rt + r] = 0u;
            *flag = 0u;
          }
        }
        __threadfence();
      }
      __syncthreads();
    };
    decode_tiles<XT, BM, kSub, kStages>(
        smem, abuf + (size_t)m0 * I, M - m0, I, a.d_q, a.d_s, a.d_z, H,
        Cols{h0, kBN, H, 0}, a.gs_down, t0, t1, tot, wait_slices);
    const bool direct = a.splits_down == 1;
#pragma unroll
    for (int u = 0; u < kSub; ++u)
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = m0 + 8 * j + 2 * q + (e & 1);
          const int n = h0 + u * kBN + c_a + (e < 2 ? 0 : 8);
          if (m >= M || n >= H) continue;
          if (direct) y[(size_t)m * H + n] = from_float<XT>(tot[u][j][e]);
          else a.part_d[((size_t)s * M + m) * H + n] = tot[u][j][e];
        }
    if (!direct &&
        last_arrival(&a.arrive_d[cb * rt + r], a.splits_down, &last_s)) {
      for (int idx = tid; idx < BM * (L::kCols / 4); idx += kThreads) {
        const int m = m0 + idx / (L::kCols / 4);
        const int n = h0 + 4 * (idx % (L::kCols / 4));
        if (m >= M || n >= H) continue;
        float4 p[kMaxSplits];
#pragma unroll
        for (int sp = 0; sp < kMaxSplits; ++sp)
          if (sp < a.splits_down)
            p[sp] = __ldcg(reinterpret_cast<const float4*>(
                a.part_d + ((size_t)sp * M + m) * H + n));
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int sp = 0; sp < kMaxSplits; ++sp)
          if (sp < a.splits_down) {
            v.x += p[sp].x;
            v.y += p[sp].y;
            v.z += p[sp].z;
            v.w += p[sp].w;
          }
        XT* yr = y + (size_t)m * H + n;
        yr[0] = from_float<XT>(v.x);
        yr[1] = from_float<XT>(v.y);
        yr[2] = from_float<XT>(v.z);
        yr[3] = from_float<XT>(v.w);
      }
    }
  }
}

template <typename XT, int BM, int ACT>
cudaError_t launch(Args a, cudaStream_t stream) {
  using L = Layout<XT, BM, kSub, kStages>;
  auto kernel = int4_mlp_kernel<XT, BM, ACT>;
  static bool attr_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (!attr_set[dev]) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kSmem);
    if (err != cudaSuccess) return err;
    attr_set[dev] = true;
  }
  const int items =
      ((a.I + kBN - 1) / kBN * a.splits_gu +
       (a.H + kSub * kBN - 1) / (kSub * kBN) * a.splits_down) * a.row_tiles;
  kernel<<<items, kThreads, L::kSmem, stream>>>(a);
  return cudaGetLastError();
}

template <typename XT>
cudaError_t launch_dtype(const Args& a, int act, cudaStream_t st) {
  const bool silu = act == kSiluGlu;
  if (block_rows(a.M) == 16)
    return silu ? launch<XT, 16, kSiluGlu>(a, st) : launch<XT, 16, kGeluGlu>(a, st);
  if (block_rows(a.M) == 32)
    return silu ? launch<XT, 32, kSiluGlu>(a, st) : launch<XT, 32, kGeluGlu>(a, st);
  return silu ? launch<XT, 64, kSiluGlu>(a, st) : launch<XT, 64, kGeluGlu>(a, st);
}

}  // namespace

// y = the fused MLP of x [M, H] (M <= 64). act: 0 silu_glu, 1 gelu_glu (the
// erf GELU). dtype of x, a and y: 0 bf16, 1 fp16, 2 fp32. splits_gu and
// splits_down: the wrapper's split plans (ops/cuda/int4_matmul.py
// split_plan of (2I, H) and (H, I)). workspace: fp32, at least
// splits_gu * M * 2I (when splits_gu > 1) + splits_down * M * H (when
// splits_down > 1) + M * I floats, 16-byte aligned. counters: uint32, at
// least (3 * ceil(I / 128) + ceil(H / 256)) * row tiles + 1 (row tiles of
// 16 rows up to 16, of 32 up to 32, else one of 64), all zero; the kernel
// leaves them zero.
extern "C" int tgi_int4_mlp(const void* x, const void* gu_q, const void* gu_z,
                            const void* gu_s, const void* d_q, const void* d_z,
                            const void* d_s, void* workspace, void* counters,
                            void* y, int M, int H, int I, int gs_gu,
                            int gs_down, int splits_gu, int splits_down,
                            int act, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || M > 64 || H <= 0 || I <= 0 || H % kBK || I % kBK ||
      gs_gu <= 0 || gs_gu % kBK || H % gs_gu || gs_down <= 0 ||
      gs_down % kBK || I % gs_down || splits_gu < 1 ||
      splits_gu > kMaxSplits || splits_gu > H / kBK || splits_down < 1 ||
      splits_down > kMaxSplits || splits_down > I / kBK ||
      (act != kSiluGlu && act != kGeluGlu) || !workspace || !counters ||
      reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(workspace) % 16)
    return (int)cudaErrorInvalidValue;
  const int bm = block_rows(M);
  const int rt = (M + bm - 1) / bm;
  const int blocks_gu = (I + kBN - 1) / kBN;
  float* ws = static_cast<float*>(workspace);
  float* part_gu = ws;
  float* part_d = part_gu + (splits_gu > 1 ? (size_t)splits_gu * M * 2 * I : 0);
  float* abuf = part_d + (splits_down > 1 ? (size_t)splits_down * M * H : 0);
  unsigned int* c = static_cast<unsigned int*>(counters);
  Args a{x, static_cast<const int32_t*>(gu_q), static_cast<const int32_t*>(gu_z),
         static_cast<const float*>(gu_s), static_cast<const int32_t*>(d_q),
         static_cast<const int32_t*>(d_z), static_cast<const float*>(d_s),
         part_gu, part_d, abuf, c, c + blocks_gu * rt, c + 2 * blocks_gu * rt,
         c + 3 * blocks_gu * rt,
         c + (3 * blocks_gu + (H + kSub * kBN - 1) / (kSub * kBN)) * rt, y, M,
         H, I, gs_gu, gs_down, splits_gu, splits_down, rt};
  switch (dtype) {
    case 0: return (int)launch_dtype<__nv_bfloat16>(a, act, st);
    case 1: return (int)launch_dtype<__half>(a, act, st);
    case 2: return (int)launch_dtype<float>(a, act, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" const char* tgi_int4_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
