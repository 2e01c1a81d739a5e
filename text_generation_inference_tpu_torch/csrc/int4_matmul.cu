// GPTQ INT4 dequant-GEMM for sm_90a: y = x @ (q * scale - zbias).
//
// Replaces: the JAX package's ops/pallas/int4_matmul.py
//   int4_matmul_s4_stacked (`_kernel_s4_stacked`, pallas_call at :453),
//   int4_matmul_s4         (`_kernel_s4`,         pallas_call at :572),
//   int4_matmul            (`_kernel`,            pallas_call at :637).
// The three read other TPU layouts of the same weight (native s4, blocked
// scales, the packed int32 words); on the GPU the GPTQ packing is the
// natural one, so one kernel serves all three. A layer of a stacked weight
// is a pointer offset (the wrapper passes the layer's view).
//
// Inputs: x [M, K] bf16 (already gathered by the act-order perm),
// qweight [K/8, N] int32 (eight 4-bit rows per word, little-endian),
// scales and zbias [K/gs, N] f32 with zbias = (zero + 1) * scale (GPTQ
// stores zero - 1). Output y [M, N] bf16, accumulated in fp32. Nibbles are
// read unsigned: the word is shifted as a uint32_t and masked.
//
// What bounds it on an H100: at decode (M = 16 slots) the product does
// 2*M flops per weight nibble, far below the 295 flops a byte the card needs
// to leave the memory bound, so it is bound by the packed weight bytes
// (3.35 TB/s). At prefill (M in the thousands) it is bound by operations
// (989 TFLOP/s bf16 on the tensor cores).
//
// Design: one block of 4 warps per (64-column tile, BM-row tile, K split).
// Each 64-deep K tile lies inside one quantization group (gs is a multiple
// of 64), so one scale row applies. A thread loads four qweight words of one
// column (consecutive threads on consecutive columns: coalesced along N),
// dequantizes the 32 nibbles with fma(q, scale, -zbias) and stores them as
// bf16, transposed, in shared memory; x rows are staged beside them (rows
// past M are zero: M is padded inside the kernel). Both products run on the
// tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate). The next
// tile's words and x rows are loaded into registers while the tensor cores
// work on the current one. BM is 16, 32 or 64 by M; when the (N, M) tiles
// are too few to fill the 132 SMs twice over (decode), K is split across
// blocks into fp32 partial sums that a second kernel adds up and rounds.
// Not yet: cp.async / TMA pipelines, ldmatrix, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBN = 64;             // output columns per block
constexpr int kBK = 64;             // K rows per tile (inside one group)
constexpr int kLd = kBK + 8;        // padded shared-memory row (bf16)
constexpr int kSms = 132;
constexpr int kMaxSplits = 16;

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

int block_rows(int M) { return M <= 16 ? 16 : (M <= 32 ? 32 : 64); }

template <int BM>
__global__ void __launch_bounds__(kThreads)
int4_matmul_kernel(const __nv_bfloat16* __restrict__ x,  // [M, K]
                   const int32_t* __restrict__ qweight,  // [K/8, N]
                   const float* __restrict__ scales,     // [K/gs, N]
                   const float* __restrict__ zbias,      // [K/gs, N]
                   __nv_bfloat16* __restrict__ y,        // [M, N] (splits == 1)
                   float* __restrict__ partial,          // [splits, M, N]
                   int M, int N, int K, int gs, int splits) {
  constexpr int kWarpsM = BM / 16;              // warps along M: 1, 2, 4
  constexpr int kWarpsN = kWarps / kWarpsM;     // warps along N: 4, 2, 1
  constexpr int kWarpCols = kBN / kWarpsN;      // 16, 32, 64
  constexpr int kNTiles = kWarpCols / 8;        // n8 tiles per warp
  constexpr int kXVecs = BM * kBK / 8 / kThreads;    // 16-byte x loads
  constexpr int kWordRows = kBK / 8;                 // 8 word rows a tile
  constexpr int kWords = kWordRows * kBN / kThreads; // 4 words a thread
  constexpr int kRowStep = kThreads / kBN;           // 2
  __shared__ __align__(16) __nv_bfloat16 xs[BM][kLd];
  __shared__ __align__(16) __nv_bfloat16 wt[kBN][kLd];  // [n][k]

  const int n0 = blockIdx.x * kBN;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int tiles = K / kBK;
  const int t_begin = (int)((long long)tiles * split / splits);
  const int t_end = (int)((long long)tiles * (split + 1) / splits);

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = lane / 4;
  const int quad = lane % 4;
  const int wm = warp / kWarpsN;
  const int wn = warp % kWarpsN;

  // this thread's weight column and first word row of a tile
  const int wcol = tid % kBN;
  const int wrow = tid / kBN;
  const int n = n0 + wcol;
  const bool n_ok = n < N;

  uint4 xr[kXVecs];
  uint32_t qr[kWords];
  float sc = 0.f, zb = 0.f;

  auto load_tile = [&](int t) {
    const int k0 = t * kBK;
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / (kBK / 8);
      const int c = (idx % (kBK / 8)) * 8;
      const int m = m0 + r;
      xr[i] = m < M ? *reinterpret_cast<const uint4*>(x + (size_t)m * K + k0 + c)
                    : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int i = 0; i < kWords; ++i) {
      const int kw = k0 / 8 + wrow + i * kRowStep;
      qr[i] = n_ok ? static_cast<uint32_t>(qweight[(size_t)kw * N + n]) : 0u;
    }
    const size_t g = (size_t)(k0 / gs) * N + n;
    sc = n_ok ? scales[g] : 0.f;
    zb = n_ok ? zbias[g] : 0.f;
  };

  auto store_tile = [&]() {
#pragma unroll
    for (int i = 0; i < kXVecs; ++i) {
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

  float acc[kNTiles][4];
#pragma unroll
  for (int t = 0; t < kNTiles; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  if (t_begin < t_end) load_tile(t_begin);
  for (int t = t_begin; t < t_end; ++t) {
    __syncthreads();     // the previous tile is fully consumed
    store_tile();
    __syncthreads();
    if (t + 1 < t_end) load_tile(t + 1);   // in flight during the products
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      const __nv_bfloat16* xa = &xs[wm * 16 + group][kk + quad * 2];
      uint32_t a[4];
      a[0] = load_pair(xa);
      a[1] = load_pair(xa + 8 * kLd);
      a[2] = load_pair(xa + 8);
      a[3] = load_pair(xa + 8 * kLd + 8);
#pragma unroll
      for (int j = 0; j < kNTiles; ++j) {
        const __nv_bfloat16* wb = &wt[wn * kWarpCols + j * 8 + group][kk + quad * 2];
        mma_bf16(acc[j], a, load_pair(wb), load_pair(wb + 8));
      }
    }
  }

  // epilogue: rows group / group + 8 of the warp, columns quad*2, quad*2+1
#pragma unroll
  for (int j = 0; j < kNTiles; ++j) {
    const int col = n0 + wn * kWarpCols + j * 8 + quad * 2;
    if (col >= N) continue;   // N % 8 == 0: col + 1 < N as well
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = m0 + wm * 16 + group + 8 * h;
      if (row >= M) continue;
      if (splits == 1) {
        *reinterpret_cast<uint32_t*>(y + (size_t)row * N + col) =
            pack_bf16(acc[j][2 * h], acc[j][2 * h + 1]);
      } else {
        *reinterpret_cast<float2*>(partial + ((size_t)split * M + row) * N + col) =
            make_float2(acc[j][2 * h], acc[j][2 * h + 1]);
      }
    }
  }
}

// y = bf16(sum over splits of partial): the second pass of split-K
__global__ void sum_splits_kernel(const float* __restrict__ partial,
                                  __nv_bfloat16* __restrict__ y, size_t mn,
                                  int splits) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < mn;
       i += (size_t)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += partial[(size_t)k * mn + i];
    y[i] = __float2bfloat16(s);
  }
}

template <int BM>
cudaError_t launch(const void* x, const void* qweight, const void* scales,
                   const void* zbias, void* y, void* partial, int M, int N,
                   int K, int gs, int splits, cudaStream_t stream) {
  const dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  int4_matmul_kernel<BM><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const int32_t*>(qweight),
      static_cast<const float*>(scales), static_cast<const float*>(zbias),
      static_cast<__nv_bfloat16*>(y), static_cast<float*>(partial), M, N, K, gs,
      splits);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t mn = (size_t)M * N;
  const int blocks = (int)((mn + 255) / 256 < 4 * kSms ? (mn + 255) / 256 : 4 * kSms);
  sum_splits_kernel<<<blocks, 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<__nv_bfloat16*>(y), mn,
      splits);
  return cudaGetLastError();
}

}  // namespace

// Number of K splits the kernel uses for an [M, K] x [K, N] product: 1 when
// the (N, M) tiles fill the SMs twice over, else enough splits to do so
// (at most 16, at most one per 64-deep K tile). The caller allocates the
// [splits, M, N] f32 partial buffer when this is above 1.
extern "C" int tgi_int4_matmul_splits(int M, int N, int K) {
  if (M <= 0 || N <= 0 || K < kBK) return 1;
  const int bm = block_rows(M);
  const long long blocks = (long long)((N + kBN - 1) / kBN) * ((M + bm - 1) / bm);
  if (blocks >= 2 * kSms) return 1;
  int s = (int)((2 * kSms + blocks - 1) / blocks);
  s = s < kMaxSplits ? s : kMaxSplits;
  return s < K / kBK ? s : K / kBK;
}

extern "C" int tgi_int4_matmul(const void* x, const void* qweight,
                               const void* scales, const void* zbias, void* y,
                               void* partial, int M, int N, int K, int gs,
                               int splits, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M <= 0 || N <= 0 || K <= 0 || N % 8 || K % kBK || gs <= 0 || gs % kBK ||
      K % gs || splits < 1 || splits > K / kBK || (splits > 1 && !partial))
    return (int)cudaErrorInvalidValue;
  const int bm = block_rows(M);
  if (bm == 16)
    return (int)launch<16>(x, qweight, scales, zbias, y, partial, M, N, K, gs, splits, st);
  if (bm == 32)
    return (int)launch<32>(x, qweight, scales, zbias, y, partial, M, N, K, gs, splits, st);
  return (int)launch<64>(x, qweight, scales, zbias, y, partial, M, N, K, gs, splits, st);
}

extern "C" const char* tgi_int4_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
