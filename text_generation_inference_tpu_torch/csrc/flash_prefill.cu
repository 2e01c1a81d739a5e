// Causal flash attention over right-padded prefill buckets, for sm_90a.
//
// Replaces: the JAX package's ops/pallas/flash_prefill.py
//           flash_prefill (the Pallas `_kernel`, pallas_call at :143).
//
// Computes, per (sequence n, kv head kh, query head g of the kv group):
//   out[n, i, kh, g] = softmax_j(q[n, i, kh, g] . k[n, j, kh] * scale) v[n, j, kh]
// over keys j <= i and j < lengths[n]; rows with lengths[n] == 0 give 0, and
// value rows at or past the length are zeroed before the product (as the
// Pallas kernel does at flash_prefill.py:79-83).
//
// What bounds it on an H100: at prefill lengths (128..2048) the causal
// score and value products are ~T^2/2 * H * D * 4 flops against O(T*H*D)
// bytes, so it is bound by operations (989 TFLOP/s bf16 on the tensor
// cores).
//
// Design: the G query heads of a kv head are folded into the rows: row
// r = token * G + g of the (n, kv head) problem. One block of 4 warps per
// (n, kv head, 64-row tile); each warp owns 16 rows. Both products run on
// the tensor cores with mma.sync m16n8k16 (bf16 in, fp32 accumulate): q
// fragments stay in registers for the whole key walk, the scores of a
// 64-key tile come out in the accumulator layout, are masked (k <= q_pos,
// k < len), folded into the online softmax (fp32, exp2 with the scale
// folded in) and reused as bf16 A fragments of the value product without
// leaving registers. K tiles are staged row-major and V tiles transposed in
// shared memory (padded rows), zero past the length. A block walks key
// tiles only up to min(its last token / 64, ceil(len / 64) - 1), so tiles
// above the diagonal and past the length are never read. Not yet done:
// ldmatrix, cp.async / TMA double buffering, wgmma.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // flattened (token, head) rows per block
constexpr int kBlockK = 64;    // keys per shared-memory tile
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 8;        // bf16 padding per smem row

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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_prefill_kernel(const __nv_bfloat16* __restrict__ q,  // [N, T, KH, G, D]
                     const __nv_bfloat16* __restrict__ k,  // [N, T, KH, D]
                     const __nv_bfloat16* __restrict__ v,  // [N, T, KH, D]
                     const int32_t* __restrict__ lengths,  // [N]
                     __nv_bfloat16* __restrict__ out,      // [N, T, KH, G, D]
                     int T, int KH, int G, float scale_log2) {
  constexpr int kSteps = D / 16;      // k16 steps over the head dim
  constexpr int kOutTiles = D / 8;    // n8 tiles of the output
  constexpr int kKeyTiles = kBlockK / 8;
  __shared__ __align__(16) __nv_bfloat16 ks[kBlockK][D + kPad];
  __shared__ __align__(16) __nv_bfloat16 vt[D][kBlockK + kPad];

  const int n = blockIdx.z;
  const int kh = blockIdx.y;
  const int row0 = blockIdx.x * kRows;
  const int len = max(0, min(lengths[n], T));
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int group = lane / 4;        // row within the 8-row half
  const int quad = lane % 4;         // column pair within an n8 tile

  // this lane's two rows: r[0] = warp row + group, r[1] = r[0] + 8
  int tok[2];
  bool row_ok[2];
  size_t q_off[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + warp * 16 + group + 8 * h;
    tok[h] = r / G;
    row_ok[h] = tok[h] < T;
    q_off[h] = ((((size_t)n * T + tok[h]) * KH + kh) * G + r % G) * D;
  }
  uint32_t qa[kSteps][4];
#pragma unroll
  for (int s = 0; s < kSteps; ++s) {
    const int c = s * 16 + quad * 2;
    qa[s][0] = row_ok[0] ? load_pair(q + q_off[0] + c) : 0u;
    qa[s][1] = row_ok[1] ? load_pair(q + q_off[1] + c) : 0u;
    qa[s][2] = row_ok[0] ? load_pair(q + q_off[0] + c + 8) : 0u;
    qa[s][3] = row_ok[1] ? load_pair(q + q_off[1] + c + 8) : 0u;
  }

  float o[kOutTiles][4];
#pragma unroll
  for (int t = 0; t < kOutTiles; ++t)
    o[t][0] = o[t][1] = o[t][2] = o[t][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};
  float l[2] = {0.f, 0.f};          // this lane's partial row sums

  const int tok_last = min((row0 + kRows - 1) / G, T - 1);
  const int last_tile = min(tok_last / kBlockK, (len + kBlockK - 1) / kBlockK - 1);

  for (int tile = 0; tile <= last_tile; ++tile) {
    __syncthreads();   // the previous tile is fully consumed
    for (int idx = tid; idx < kBlockK * D / 8; idx += kThreads) {
      const int j = idx / (D / 8);
      const int c = (idx % (D / 8)) * 8;
      const int key = tile * kBlockK + j;
      uint4 kraw = make_uint4(0u, 0u, 0u, 0u);
      uint4 vraw = make_uint4(0u, 0u, 0u, 0u);
      if (key < len) {
        const size_t off = (((size_t)n * T + key) * KH + kh) * D + c;
        kraw = *reinterpret_cast<const uint4*>(k + off);
        vraw = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(&ks[j][c]) = kraw;
      const __nv_bfloat16* ve = reinterpret_cast<const __nv_bfloat16*>(&vraw);
#pragma unroll
      for (int e = 0; e < 8; ++e) vt[c + e][j] = ve[e];
    }
    __syncthreads();

    // scores S[16 rows x 64 keys] in the accumulator layout
    float sc[kKeyTiles][4];
#pragma unroll
    for (int t = 0; t < kKeyTiles; ++t) {
      sc[t][0] = sc[t][1] = sc[t][2] = sc[t][3] = 0.f;
      const __nv_bfloat16* krow = &ks[t * 8 + group][quad * 2];
#pragma unroll
      for (int s = 0; s < kSteps; ++s)
        mma_bf16(sc[t], qa[s], load_pair(krow + s * 16),
                 load_pair(krow + s * 16 + 8));
    }

    // mask, scale and the online-softmax update for rows h = 0, 1
    float tmax[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int t = 0; t < kKeyTiles; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const int key = tile * kBlockK + t * 8 + quad * 2 + (e & 1);
        const bool ok = key <= tok[h] && key < len;
        sc[t][e] = ok ? sc[t][e] * scale_log2 : -INFINITY;
        tmax[h] = fmaxf(tmax[h], sc[t][e]);
      }
    }
    float alpha[2], m_safe[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 1));
      tmax[h] = fmaxf(tmax[h], __shfl_xor_sync(0xffffffffu, tmax[h], 2));
      const float m_new = fmaxf(m[h], tmax[h]);
      m_safe[h] = (m_new == -INFINITY) ? 0.f : m_new;
      alpha[h] = (m[h] == -INFINITY) ? 0.f : exp2f(m[h] - m_safe[h]);
      m[h] = m_new;
      l[h] *= alpha[h];
    }
#pragma unroll
    for (int t = 0; t < kKeyTiles; ++t) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e / 2;
        const float p = (sc[t][e] == -INFINITY) ? 0.f
                                                : exp2f(sc[t][e] - m_safe[h]);
        sc[t][e] = p;
        l[h] += p;
      }
    }
#pragma unroll
    for (int t = 0; t < kOutTiles; ++t) {
      o[t][0] *= alpha[0];
      o[t][1] *= alpha[0];
      o[t][2] *= alpha[1];
      o[t][3] *= alpha[1];
    }

    // O += P V: P from the score registers, V^T staged in shared memory
#pragma unroll
    for (int s = 0; s < kBlockK / 16; ++s) {
      uint32_t pa[4];
      pa[0] = pack_bf16(sc[2 * s][0], sc[2 * s][1]);
      pa[1] = pack_bf16(sc[2 * s][2], sc[2 * s][3]);
      pa[2] = pack_bf16(sc[2 * s + 1][0], sc[2 * s + 1][1]);
      pa[3] = pack_bf16(sc[2 * s + 1][2], sc[2 * s + 1][3]);
#pragma unroll
      for (int t = 0; t < kOutTiles; ++t) {
        const __nv_bfloat16* vrow = &vt[t * 8 + group][s * 16 + quad * 2];
        mma_bf16(o[t], pa, load_pair(vrow), load_pair(vrow + 8));
      }
    }
  }

  // full row sums across the quad, normalize, store bf16 pairs
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = 1.f / fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int t = 0; t < kOutTiles; ++t) {
    const int c = t * 8 + quad * 2;
    if (row_ok[0])
      *reinterpret_cast<uint32_t*>(out + q_off[0] + c) =
          pack_bf16(o[t][0] * l[0], o[t][1] * l[0]);
    if (row_ok[1])
      *reinterpret_cast<uint32_t*>(out + q_off[1] + c) =
          pack_bf16(o[t][2] * l[1], o[t][3] * l[1]);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* lengths, void* out, int N, int T, int KH,
                   int G, float scale, cudaStream_t stream) {
  const long long rows = (long long)T * G;
  const dim3 grid((unsigned)((rows + kRows - 1) / kRows), KH, N);
  const float scale_log2 = scale * 1.4426950408889634f;
  flash_prefill_kernel<D><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), lengths,
      static_cast<__nv_bfloat16*>(out), T, KH, G, scale_log2);
  return cudaGetLastError();
}

}  // namespace

extern "C" int tgi_flash_prefill(const void* q, const void* k, const void* v,
                                 const int32_t* lengths, void* out, int N,
                                 int T, int KH, int G, int D, float scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (N <= 0 || T <= 0 || KH <= 0 || G <= 0) return (int)cudaErrorInvalidValue;
  if (D == 64) return (int)launch<64>(q, k, v, lengths, out, N, T, KH, G, scale, s);
  if (D == 128) return (int)launch<128>(q, k, v, lengths, out, N, T, KH, G, scale, s);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* tgi_flash_prefill_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
