// Fused GPTQ-INT4 GLU MLP for sm_90a (kernel M1), decode rows only:
//   y = dequant(down)[act(x @ dequant(gate)) * (x @ dequant(up))]
// for one layer of a layer-stacked weight, S <= 64 rows.
//
// Replaces: the JAX package's ops/pallas/int4_matmul.py
//   int4_mlp_s4_stacked (`_kernel_mlp_s4_stacked`, pallas_call at :366).
// The TPU kernel walked blocks of the intermediate dim in order and kept the
// [S, H] sum in VMEM. On the GPU the blocks run in parallel and none can
// hold [S, H] f32, so the one launch runs three phases separated by grid-wide
// barriers (a cooperative launch, so that every block is resident):
//   1. gate/up: a work item is 32 intermediate columns: their 32 gate and 32
//      up columns of w_gu are one 64-column tile of a dequant-GEMM over H;
//      the epilogue applies the activation in fp32 and writes
//      a = bf16(act(g) * u) to a scratch [S, I] (352 KB at S = 16: it stays
//      in L2).
//   2. down: a work item is (64 columns of H, one of `splits` fixed slices of
//      I); it writes an fp32 partial [S, 64] to a scratch [splits, S, H].
//   3. the partials are added in split order and rounded to bf16.
// Every output element is summed in one fixed order, whatever the grid size
// or the other rows: the result is bit-identical run to run (no atomics on
// data; the barrier counter is the only atomic).
//
// Layouts, as the loader stores them (GPTQ natural layout, no TPU blocking):
// x [S, H] bf16; gu qweight [H/8, 2I] int32 (gate columns [0, I), up
// columns [I, 2I), models/fuse.py), scales / zbias [H/gs_gu, 2I] f32;
// down qweight [I/8, H], scales / zbias [I/gs_down, H]. Dequant is
// fma(q, scale, -zbias) with the nibble read unsigned, as K1 does
// (csrc/int4_matmul.cu), rounded to bf16 for the tensor cores (mma.sync
// m16n8k16, fp32 accumulation). Rows past S are zero (padded to 16, 32 or
// 64 inside the kernel).
//
// What bounds it on an H100: 2 * S flops per weight nibble at S <= 64, far
// below the 295 flops a byte the card needs to leave the memory bound: it is
// bound by the ~76 MB of weights, scales and zbias of a 7B layer (3.35 TB/s,
// ~0.023 ms). Each phase keeps 300+ blocks of weight loads in flight; the
// scratch traffic (a, partials) stays in L2.
// Not yet: cp.async / TMA pipelines, ldmatrix, wgmma, overlap of the phases.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 64;             // output columns of a tile
constexpr int kHalf = kBN / 2;      // intermediate columns of a phase-1 item
constexpr int kBK = 64;             // K rows per tile (inside one group)
constexpr int kLd = kBK + 8;        // padded shared-memory row (bf16)
constexpr int kMaxSplits = 16;
constexpr int kSiluGlu = 0;
constexpr int kGeluGlu = 1;

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

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int ACT>
__device__ __forceinline__ float glu(float g, float u) {
  if (ACT == kSiluGlu) return g / (1.f + expf(-g)) * u;
  return 0.5f * g * (1.f + erff(g * 0.70710678118654752f)) * u;   // erf GELU
}

int block_rows(int M) { return M <= 16 ? 16 : (M <= 32 ? 32 : 64); }

template <int BM>
struct Layout {
  static constexpr int kWarpsM = BM / 16;                 // 1, 2, 4
  static constexpr int kWarpsN = kWarps / kWarpsM;        // 4, 2, 1
  static constexpr int kWarpCols = kBN / kWarpsN;         // 16, 32, 64
  static constexpr int kNTiles = kWarpCols / 8;           // n8 tiles a warp
  static constexpr int kXVecs = BM * kBK / 8 / kThreads;  // 16-byte A loads
};

// acc = a[0:BM, k-tiles t_begin..t_end) @ dequant(w)[.., this tile], for a
// 64-column tile of w whose column for this thread's load slot (tid % 64) is
// `n`. `a` is [M, K] bf16 (rows >= M read as 0) and is read through L2
// (__ldcg): in phase 2 it was written by other blocks of this launch.
template <int BM>
__device__ __forceinline__ void dequant_gemm(
    const __nv_bfloat16* a, int M, int K, const int32_t* __restrict__ qweight,
    const float* __restrict__ scales, const float* __restrict__ zbias, int N,
    int n, int gs, int t_begin, int t_end, __nv_bfloat16 (*xs)[kLd],
    __nv_bfloat16 (*wt)[kLd], float (&acc)[Layout<BM>::kNTiles][4]) {
  using L = Layout<BM>;
  constexpr int kWordRows = kBK / 8;                  // 8 word rows a tile
  constexpr int kWords = kWordRows * kBN / kThreads;  // 4 words a thread
  constexpr int kRowStep = kThreads / kBN;            // 2
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = lane / 4;
  const int quad = lane % 4;
  const int wm = warp / L::kWarpsN;
  const int wn = warp % L::kWarpsN;
  const int wcol = tid % kBN;
  const int wrow = tid / kBN;

  uint4 xr[L::kXVecs];
  uint32_t qr[kWords];
  float sc = 0.f, zb = 0.f;

  auto load_tile = [&](int t) {
    const int k0 = t * kBK;
#pragma unroll
    for (int i = 0; i < L::kXVecs; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBK / 8);
      const int c = (idx % (kBK / 8)) * 8;
      xr[i] = r < M ? __ldcg(reinterpret_cast<const uint4*>(a + (size_t)r * K + k0 + c))
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const int kw = k0 / 8 + wrow + i * kRowStep;
      qr[i] = static_cast<uint32_t>(qweight[(size_t)kw * N + n]);
    }
    const size_t g = (size_t)(k0 / gs) * N + n;
    sc = scales[g];
    zb = zbias[g];
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < L::kXVecs; ++i) {
      const int idx = tid + i * kThreads;
      *reinterpret_cast<uint4*>(&xs[idx / (kBK / 8)][(idx % (kBK / 8)) * 8]) = xr[i];
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const uint32_t w = qr[i];
      uint32_t p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float lo = (float)((w >> (8 * e)) & 0xFu);
        const float hi = (float)((w >> (8 * e + 4)) & 0xFu);
        p[e] = pack_bf16(fmaf(lo, sc, -zb), fmaf(hi, sc, -zb));
      }
      *reinterpret_cast<uint4*>(&wt[wcol][(wrow + i * kRowStep) * 8]) =
          make_uint4(p[0], p[1], p[2], p[3]);
    }
  };

#pragma unroll
  for (int j = 0; j < L::kNTiles; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;

  if (t_begin < t_end) load_tile(t_begin);
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();     // the previous tile (or work item) is fully consumed
    store_tile();
    __syncthreads();
    if (t + 1 < t_end) load_tile(t + 1);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      const __nv_bfloat16* xa = &xs[wm * 16 + group][kk + quad * 2];
      uint32_t af[4];
      af[0] = load_pair(xa);
      af[1] = load_pair(xa + 8 * kLd);
      af[2] = load_pair(xa + 8);
      af[3] = load_pair(xa + 8 * kLd + 8);
#pragma unroll
      for (int j = 0; j < L::kNTiles; ++j) {
        const __nv_bfloat16* wb = &wt[wn * L::kWarpCols + j * 8 + group][kk + quad * 2];
        mma_bf16(acc[j], af, load_pair(wb), load_pair(wb + 8));
      }
    }
  }
}

// Grid-wide barrier of a cooperative launch: the counter is zeroed before the
// launch and the k-th barrier waits for k * gridDim.x arrivals.
__device__ __forceinline__ void grid_barrier(unsigned int* counter,
                                             unsigned int target) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    atomicAdd(counter, 1u);
    while (*reinterpret_cast<volatile unsigned int*>(counter) < target)
      __nanosleep(64);
    __threadfence();
  }
  __syncthreads();
}

template <int BM, int ACT>
__global__ void __launch_bounds__(kThreads, 4)
int4_mlp_kernel(const __nv_bfloat16* __restrict__ x,   // [M, H]
                const int32_t* __restrict__ gu_q,      // [H/8, 2I]
                const float* __restrict__ gu_s,        // [H/gs_gu, 2I]
                const float* __restrict__ gu_z,
                const int32_t* __restrict__ d_q,       // [I/8, H]
                const float* __restrict__ d_s,         // [I/gs_down, H]
                const float* __restrict__ d_z,
                __nv_bfloat16* abuf,                   // [M, I] scratch
                float* partial,                        // [splits, M, H] scratch
                unsigned int* counter,
                __nv_bfloat16* __restrict__ y,         // [M, H]
                int M, int H, int I, int gs_gu, int gs_down, int splits) {
  using L = Layout<BM>;
  __shared__ __align__(16) __nv_bfloat16 xs[BM][kLd];
  __shared__ __align__(16) __nv_bfloat16 wt[kBN][kLd];
  __shared__ float stage[BM][kBN + 4];

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = lane / 4;
  const int quad = lane % 4;
  const int wm = warp / L::kWarpsN;
  const int wn = warp % L::kWarpsN;
  float acc[L::kNTiles][4];

  // phase 1: a[:, i0:i0+32] = bf16(act(x @ gate) * (x @ up))
  const int items1 = I / kHalf;
  for (int item = blockIdx.x; item < items1; item += gridDim.x) {
    const int i0 = item * kHalf;
    const int wcol = tid % kBN;
    const int n = wcol < kHalf ? i0 + wcol : I + i0 + (wcol - kHalf);
    dequant_gemm<BM>(x, M, H, gu_q, gu_s, gu_z, 2 * I, n, gs_gu, 0, H / kBK,
                     xs, wt, acc);
#pragma unroll
    for (int j = 0; j < L::kNTiles; ++j) {
      const int col = wn * L::kWarpCols + j * 8 + quad * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 16 + group + 8 * h;
        stage[r][col] = acc[j][2 * h];
        stage[r][col + 1] = acc[j][2 * h + 1];
      }
    }
    __syncthreads();
    for (int idx = tid; idx < M * kHalf; idx += kThreads) {
      const int r = idx / kHalf;
      const int c = idx % kHalf;
      abuf[(size_t)r * I + i0 + c] =
          __float2bfloat16(glu<ACT>(stage[r][c], stage[r][kHalf + c]));
    }
    __syncthreads();
  }
  grid_barrier(counter, gridDim.x);

  // phase 2: partial[split][:, h0:h0+64] = a[:, slice] @ dequant(down)[slice, ..]
  const int tiles_h = H / kBN;
  const int tiles_i = I / kBK;
  for (int item = blockIdx.x; item < tiles_h * splits; item += gridDim.x) {
    const int h0 = (item % tiles_h) * kBN;
    const int split = item / tiles_h;
    const int t_begin = (int)((long long)tiles_i * split / splits);
    const int t_end = (int)((long long)tiles_i * (split + 1) / splits);
    dequant_gemm<BM>(abuf, M, I, d_q, d_s, d_z, H, h0 + tid % kBN, gs_down,
                     t_begin, t_end, xs, wt, acc);
#pragma unroll
    for (int j = 0; j < L::kNTiles; ++j) {
      const int col = h0 + wn * L::kWarpCols + j * 8 + quad * 2;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wm * 16 + group + 8 * h;
        if (row >= M) continue;
        *reinterpret_cast<float2*>(partial + ((size_t)split * M + row) * H + col) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
  grid_barrier(counter, 2u * gridDim.x);

  // phase 3: y = bf16(sum over splits, in split order)
  const size_t mh = (size_t)M * H;
  for (size_t i = (size_t)blockIdx.x * kThreads + tid; i < mh;
       i += (size_t)gridDim.x * kThreads) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += __ldcg(partial + (size_t)k * mh + i);
    y[i] = __float2bfloat16(s);
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      sms <= 0)
    return 132;
  return sms;
}

template <int BM, int ACT>
cudaError_t launch(const void* x, const void* gu_q, const void* gu_s,
                   const void* gu_z, const void* d_q, const void* d_s,
                   const void* d_z, void* abuf, void* partial, void* counter,
                   void* y, int M, int H, int I, int gs_gu, int gs_down,
                   int splits, cudaStream_t stream) {
  const void* kernel = reinterpret_cast<const void*>(&int4_mlp_kernel<BM, ACT>);
  int per_sm = 0;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, int4_mlp_kernel<BM, ACT>, kThreads, 0);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int items1 = I / kHalf;
  const int items2 = (H / kBN) * splits;
  const int items = items1 > items2 ? items1 : items2;
  const int resident = per_sm * sm_count();
  const int grid = items < resident ? items : resident;
  err = cudaMemsetAsync(counter, 0, sizeof(unsigned int), stream);
  if (err != cudaSuccess) return err;
  auto xp = static_cast<const __nv_bfloat16*>(x);
  auto guq = static_cast<const int32_t*>(gu_q);
  auto gus = static_cast<const float*>(gu_s);
  auto guz = static_cast<const float*>(gu_z);
  auto dq = static_cast<const int32_t*>(d_q);
  auto ds = static_cast<const float*>(d_s);
  auto dz = static_cast<const float*>(d_z);
  auto ab = static_cast<__nv_bfloat16*>(abuf);
  auto pp = static_cast<float*>(partial);
  auto cp = static_cast<unsigned int*>(counter);
  auto yp = static_cast<__nv_bfloat16*>(y);
  void* args[] = {&xp, &guq, &gus, &guz, &dq, &ds, &dz, &ab, &pp, &cp, &yp,
                  &M, &H, &I, &gs_gu, &gs_down, &splits};
  return cudaLaunchCooperativeKernel(kernel, dim3(grid), dim3(kThreads), args,
                                     0, stream);
}

template <int ACT>
cudaError_t launch_rows(const void* x, const void* gu_q, const void* gu_s,
                        const void* gu_z, const void* d_q, const void* d_s,
                        const void* d_z, void* abuf, void* partial,
                        void* counter, void* y, int M, int H, int I, int gs_gu,
                        int gs_down, int splits, cudaStream_t st) {
  const int bm = block_rows(M);
  if (bm == 16)
    return launch<16, ACT>(x, gu_q, gu_s, gu_z, d_q, d_s, d_z, abuf, partial,
                           counter, y, M, H, I, gs_gu, gs_down, splits, st);
  if (bm == 32)
    return launch<32, ACT>(x, gu_q, gu_s, gu_z, d_q, d_s, d_z, abuf, partial,
                           counter, y, M, H, I, gs_gu, gs_down, splits, st);
  return launch<64, ACT>(x, gu_q, gu_s, gu_z, d_q, d_s, d_z, abuf, partial,
                         counter, y, M, H, I, gs_gu, gs_down, splits, st);
}

}  // namespace

// Number of fixed slices of I the down product is split into: enough
// (64-column of H, slice) items to give every SM two, at most 16 and at most
// one per 64-deep tile of I. It depends on H, I and the card only, so a row's
// result does not depend on the batch. The caller allocates the
// [splits, M, H] f32 partial buffer.
extern "C" int tgi_int4_mlp_splits(int H, int I) {
  if (H < kBN || I < kBK) return 1;
  const int tiles_h = H / kBN;
  int s = (2 * sm_count() + tiles_h - 1) / tiles_h;
  s = s < kMaxSplits ? s : kMaxSplits;
  s = s < I / kBK ? s : I / kBK;
  return s > 1 ? s : 1;
}

// act: 0 silu_glu, 1 gelu_glu (the erf GELU). abuf is [M, I] bf16, partial
// [splits, M, H] f32, counter one uint32 (zeroed here, on the stream).
extern "C" int tgi_int4_mlp(const void* x, const void* gu_q, const void* gu_s,
                            const void* gu_z, const void* d_q, const void* d_s,
                            const void* d_z, void* abuf, void* partial,
                            void* counter, void* y, int M, int H, int I,
                            int gs_gu, int gs_down, int splits, int act,
                            void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || M > 64 || H <= 0 || I <= 0 || H % kBN || I % kBK ||
      gs_gu <= 0 || gs_gu % kBK || H % gs_gu || gs_down <= 0 ||
      gs_down % kBK || I % gs_down || splits < 1 || splits > I / kBK ||
      (act != kSiluGlu && act != kGeluGlu) || !abuf || !partial || !counter)
    return (int)cudaErrorInvalidValue;
  if (act == kSiluGlu)
    return (int)launch_rows<kSiluGlu>(x, gu_q, gu_s, gu_z, d_q, d_s, d_z, abuf,
                                      partial, counter, y, M, H, I, gs_gu,
                                      gs_down, splits, st);
  return (int)launch_rows<kGeluGlu>(x, gu_q, gu_s, gu_z, d_q, d_s, d_z, abuf,
                                    partial, counter, y, M, H, I, gs_gu,
                                    gs_down, splits, st);
}

extern "C" const char* tgi_int4_mlp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
