// One-query decode attention over the slot KV cache, for sm_90a. Two entry
// points share one design:
//   tgi_slot_decode  out[s, kh, g] = softmax(q . k) v over cache rows < ctx[s]
//   tgi_ring_decode  the same softmax over three sources at once: cache rows
//                    < ctx[s] (ctx = the chunk's start position), ring-buffer
//                    columns < step, and the current token's k/v
//
// Replaces: the JAX package's
//   ops/pallas/decode_attention.py      decode_attention (`_kernel`,
//                                       pallas_call at :142), S1;
//   ops/pallas/ring_decode_attention.py ring_decode_attention (`_kernel`,
//                                       pallas_call at :239), S2.
//
// Layouts (the JAX layouts): q [S, KH, G, D] bf16; the cache k/v [S, KH, T, D]
// bf16 with the head dim contiguous and any strides over S, KH and T (a layer
// view `cache.k[l]`, or a view narrowed to the first T rows of a longer cache,
// costs no copy); ring buffers [S, KH, C, D] and the current k/v [S, KH, D]
// bf16, contiguous; ctx [S] int32; out [S, KH, G, D] bf16. A slot with
// ctx == 0 and no ring source gives 0 (the JAX kernel clamps the denominator
// at 1e-30; its XLA reference gives NaN).
//
// What bounds it on an H100: one decode step reads each live K/V row once and
// does 4 * G * D flops per row (G <= 8), well under one flop per byte, so it
// is bound by bytes (3.35 TB/s). Design: the TPU kernel ran one program per
// slot over the T blocks in order and clamped the index map of dead blocks so
// that their DMA was elided. Here phase 1 runs one block per (slot, kv head,
// split of T): the G query heads of the kv head share each K/V row the block
// reads, and a block streams only the rows of its split below ctx (a split
// past ctx exits at once), so dead rows are never read. Splitting T gives the
// grid enough blocks for the 132 SMs at serving shapes (TinyLlama: 16 slots x
// 4 kv heads = 64 blocks without it). Each block keeps an fp32 online softmax
// (max and sum in log2 units) and writes its unnormalized accumulator and
// stats. Phase 2 (one block per (slot, kv head)) merges the splits
// flash-decoding style; the ring entry also scores the ring columns and the
// current token there, folds them into the same softmax, and normalizes.
// Keys are staged in shared memory 32 at a time with 16-byte loads, as in
// csrc/paged_attention.cu; keeping several tiles in flight (cp.async / TMA)
// is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;        // cache rows staged per tile
constexpr int kMaxGroup = 8;     // query heads per kv head
constexpr int kMaxSplits = 32;   // splits of T per (slot, kv head)
constexpr int kMaxRing = 1024;   // ring-buffer columns

// Phase 1: softmax stats of one (slot, kv head) over the cache rows
// [split * rows_per_split, min((split + 1) * rows_per_split, ctx)).
template <int D>
__global__ void __launch_bounds__(kThreads)
slot_partial_kernel(const __nv_bfloat16* __restrict__ q,   // [S, KH, G, D]
                    const __nv_bfloat16* __restrict__ k,   // strided [S,KH,T,D]
                    const __nv_bfloat16* __restrict__ v,   // same strides as k
                    const int32_t* __restrict__ ctx_len,   // [S]
                    float* __restrict__ acc_out,   // [S, KH, splits, G, D]
                    float* __restrict__ m_out,     // [S, KH, splits, G] log2
                    float* __restrict__ l_out,     // [S, KH, splits, G]
                    int KH, int G, int T, int rows_per_split, long long st_s,
                    long long st_k, long long st_t, float scale_log2) {
  constexpr int kStride = D + 1;                  // padded smem row
  constexpr int kOutPerThread = kMaxGroup * D / kThreads;
  __shared__ float qs[kMaxGroup * D];
  __shared__ float ks[kKeys * kStride];
  __shared__ float vs[kKeys * kStride];
  __shared__ float ps[kMaxGroup * kKeys];
  __shared__ float m_s[kMaxGroup], l_s[kMaxGroup], alpha_s[kMaxGroup];

  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int split = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int ctx = min(ctx_len[s], T);
  const int r0 = split * rows_per_split;
  const int r1 = min(r0 + rows_per_split, ctx);
  const size_t q_off = ((size_t)s * KH + kh) * G * D;
  const size_t kv_off = (size_t)s * st_s + (size_t)kh * st_k;

  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = __bfloat162float(q[q_off + i]) * scale_log2;
  if (tid < kMaxGroup) {
    m_s[tid] = -INFINITY;
    l_s[tid] = 0.f;
  }
  float acc[kOutPerThread];
#pragma unroll
  for (int i = 0; i < kOutPerThread; ++i) acc[i] = 0.f;

  for (int c0 = r0; c0 < r1; c0 += kKeys) {
    __syncthreads();   // previous tile consumed (and qs / stats ready)
    for (int idx = tid; idx < kKeys * D / 8; idx += kThreads) {
      const int j = idx / (D / 8);
      const int c = (idx % (D / 8)) * 8;
      const int row = c0 + j;
      float kf[8], vf[8];
      if (row < r1) {
        const size_t off = kv_off + (size_t)row * st_t + c;
        const uint4 kraw = *reinterpret_cast<const uint4*>(k + off);
        const uint4 vraw = *reinterpret_cast<const uint4*>(v + off);
        const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kraw);
        const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&vraw);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 a = __bfloat1622float2(k2[e]);
          const float2 b = __bfloat1622float2(v2[e]);
          kf[2 * e] = a.x; kf[2 * e + 1] = a.y;
          vf[2 * e] = b.x; vf[2 * e + 1] = b.y;
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
      const bool live = c0 + j < r1;
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
  __syncthreads();

  const size_t head = (((size_t)s * KH + kh) * gridDim.z + split) * G;
#pragma unroll
  for (int i = 0; i < kOutPerThread; ++i) {
    const int o = tid + i * kThreads;
    if (o < G * D) acc_out[head * D + o] = acc[i];
  }
  if (tid < G) {
    m_out[head + tid] = m_s[tid];
    l_out[head + tid] = l_s[tid];
  }
}

// Phase 2: merge the splits of one (slot, kv head); with kRing, also the ring
// columns < step and the current token; normalize and round to bf16.
template <int D, bool kRing>
__global__ void __launch_bounds__(kThreads)
slot_merge_kernel(const __nv_bfloat16* __restrict__ q,      // [S, KH, G, D]
                  const float* __restrict__ acc_in,  // [S, KH, splits, G, D]
                  const float* __restrict__ m_in,    // [S, KH, splits, G]
                  const float* __restrict__ l_in,
                  const __nv_bfloat16* __restrict__ kbuf,   // [S, KH, C, D]
                  const __nv_bfloat16* __restrict__ vbuf,
                  const __nv_bfloat16* __restrict__ k_new,  // [S, KH, D]
                  const __nv_bfloat16* __restrict__ v_new,
                  __nv_bfloat16* __restrict__ out,          // [S, KH, G, D]
                  int KH, int G, int splits, int C, int step,
                  float scale_log2) {
  extern __shared__ float ring_s[];   // kRing: q [G * D], then p [G * (C+1)]
  __shared__ float w_s[kMaxGroup * kMaxSplits];
  __shared__ float l_s[kMaxGroup];

  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t sk = (size_t)s * KH + kh;
  const size_t head_p = sk * splits * G;     // row (split, g) = head_p + split*G + g
  const int ncol = C + 1;                    // ring columns, then the current token
  float* qs = ring_s;
  float* ps = ring_s + G * D;

  if (kRing) {
    for (int i = tid; i < G * D; i += kThreads)
      qs[i] = __bfloat162float(q[sk * G * D + i]) * scale_log2;
    __syncthreads();
    for (int idx = tid; idx < G * ncol; idx += kThreads) {
      const int g = idx / ncol;
      const int c = idx % ncol;
      const __nv_bfloat16* kr = nullptr;
      if (c < step) kr = kbuf + (sk * C + c) * D;
      else if (c == C) kr = k_new + sk * D;
      float sc = -INFINITY;
      if (kr != nullptr) {
        sc = 0.f;
        const float* qg = qs + g * D;
#pragma unroll 8
        for (int d = 0; d < D; ++d) sc += qg[d] * __bfloat162float(kr[d]);
      }
      ps[idx] = sc;
    }
    __syncthreads();
  }

  // one warp per query head: the merged max, each split's weight, the sum
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int sp = lane; sp < splits; sp += 32)
      mx = fmaxf(mx, m_in[head_p + sp * G + g]);
    if (kRing)
      for (int c = lane; c < ncol; c += 32) mx = fmaxf(mx, ps[g * ncol + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_safe = (mx == -INFINITY) ? 0.f : mx;
    float lsum = 0.f;
    for (int sp = lane; sp < splits; sp += 32) {
      const float m = m_in[head_p + sp * G + g];
      const float w = (m == -INFINITY) ? 0.f : exp2f(m - m_safe);
      w_s[g * kMaxSplits + sp] = w;
      lsum += w * l_in[head_p + sp * G + g];
    }
    if (kRing) {
      for (int c = lane; c < ncol; c += 32) {
        const float x = ps[g * ncol + c];
        const float p = (x == -INFINITY) ? 0.f : exp2f(x - m_safe);
        ps[g * ncol + c] = p;
        lsum += p;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    if (lane == 0) l_s[g] = lsum;
  }
  __syncthreads();

  for (int o = tid; o < G * D; o += kThreads) {
    const int g = o / D;
    const int d = o % D;
    float a = 0.f;
    for (int sp = 0; sp < splits; ++sp) {
      const float w = w_s[g * kMaxSplits + sp];
      if (w != 0.f) a += w * acc_in[(head_p + sp * G + g) * D + d];
    }
    if (kRing) {
      const float* pg = ps + g * ncol;
      for (int c = 0; c < step; ++c)
        a += pg[c] * __bfloat162float(vbuf[(sk * C + c) * D + d]);
      a += pg[C] * __bfloat162float(v_new[sk * D + d]);
    }
    out[(sk * G + g) * D + d] = __float2bfloat16(a / fmaxf(l_s[g], 1e-30f));
  }
}

template <int D, bool kRing>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const int32_t* ctx, const void* kbuf, const void* vbuf,
                   const void* k_new, const void* v_new, float* acc, float* m,
                   float* l, void* out, int S, int KH, int G, int T,
                   long long st_s, long long st_k, long long st_t, int splits,
                   int rows_per_split, int C, int step, float scale,
                   cudaStream_t stream) {
  const float scale_log2 = scale * 1.4426950408889634f;
  const auto* qb = static_cast<const __nv_bfloat16*>(q);
  slot_partial_kernel<D><<<dim3(S, KH, splits), kThreads, 0, stream>>>(
      qb, static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), ctx, acc, m, l, KH, G, T,
      rows_per_split, st_s, st_k, st_t, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const size_t smem = kRing ? (size_t)G * (D + C + 1) * sizeof(float) : 0;
  slot_merge_kernel<D, kRing><<<dim3(S, KH), kThreads, smem, stream>>>(
      qb, acc, m, l, static_cast<const __nv_bfloat16*>(kbuf),
      static_cast<const __nv_bfloat16*>(vbuf),
      static_cast<const __nv_bfloat16*>(k_new),
      static_cast<const __nv_bfloat16*>(v_new),
      static_cast<__nv_bfloat16*>(out), KH, G, splits, C, step, scale_log2);
  return cudaGetLastError();
}

template <bool kRing>
int dispatch(const void* q, const void* k, const void* v, const int32_t* ctx,
             const void* kbuf, const void* vbuf, const void* k_new,
             const void* v_new, float* acc, float* m, float* l, void* out,
             int S, int KH, int G, int D, int T, long long st_s,
             long long st_k, long long st_t, int splits, int rows_per_split,
             int C, int step, float scale, void* stream) {
  if (S <= 0 || KH <= 0 || G <= 0 || G > kMaxGroup || T <= 0 ||
      splits <= 0 || splits > kMaxSplits || rows_per_split <= 0 ||
      (long long)splits * rows_per_split < T || st_s % 8 || st_k % 8 ||
      st_t % 8 || (kRing && (C <= 0 || C > kMaxRing || step < 0 || step > C)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return (int)launch<64, kRing>(q, k, v, ctx, kbuf, vbuf, k_new, v_new, acc,
                                  m, l, out, S, KH, G, T, st_s, st_k, st_t,
                                  splits, rows_per_split, C, step, scale, st);
  if (D == 128)
    return (int)launch<128, kRing>(q, k, v, ctx, kbuf, vbuf, k_new, v_new, acc,
                                   m, l, out, S, KH, G, T, st_s, st_k, st_t,
                                   splits, rows_per_split, C, step, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// S1: acc / m / l are [S, KH, splits, G, D] / [S, KH, splits, G] f32 scratch
extern "C" int tgi_slot_decode(const void* q, const void* k, const void* v,
                               const int32_t* ctx, float* acc, float* m,
                               float* l, void* out, int S, int KH, int G, int D,
                               int T, long long st_s, long long st_k,
                               long long st_t, int splits, int rows_per_split,
                               float scale, void* stream) {
  return dispatch<false>(q, k, v, ctx, nullptr, nullptr, nullptr, nullptr, acc,
                         m, l, out, S, KH, G, D, T, st_s, st_k, st_t, splits,
                         rows_per_split, 0, 0, scale, stream);
}

// S2: kbuf / vbuf [S, KH, C, D], k_new / v_new [S, KH, D]; ring columns
// < step are live
extern "C" int tgi_ring_decode(const void* q, const void* k, const void* v,
                               const int32_t* ctx, const void* kbuf,
                               const void* vbuf, const void* k_new,
                               const void* v_new, float* acc, float* m,
                               float* l, void* out, int S, int KH, int G, int D,
                               int T, long long st_s, long long st_k,
                               long long st_t, int splits, int rows_per_split,
                               int C, int step, float scale, void* stream) {
  return dispatch<true>(q, k, v, ctx, kbuf, vbuf, k_new, v_new, acc, m, l,
                        out, S, KH, G, D, T, st_s, st_k, st_t, splits,
                        rows_per_split, C, step, scale, stream);
}

extern "C" const char* tgi_slot_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
