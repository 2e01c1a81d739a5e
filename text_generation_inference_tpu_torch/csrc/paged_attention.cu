// One-query decode attention over a paged KV pool, for sm_90a. One source,
// two compile-time modes:
//   normalized: out[s, kh, g] = softmax(q . k) v over the slot's live keys
//   stats:      the unnormalized fp32 accumulator plus the softmax row max m
//               and normalizer l, for a flash-decoding merge with keys held
//               elsewhere (ctx == 0 gives m = -inf, l = 0, acc = 0)
// and, in stats mode, two pool types: bf16, or int8 with f32 per-row-per-head
// scale pools (k_scale / v_scale [KH, R], indexed by the same pool rows).
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
// int8 math, as `_flash_page_update` with ks / vs (paged_attention.py:34-76):
// scores = (q . k_int8) * scale * k_scale[row]; l sums the unscaled p;
// acc += (p * v_scale[row]) v_int8. The kernel folds each row's scale into
// the row as it stages it in fp32 (k * k_scale, v * v_scale), which is the
// same product in another order.
//
// Pools are [KH, P * page, D] (head-major, as in the JAX package); the block
// table [S, max_pages] names each slot's pages in position order; entries
// that are not mapped hold the sentinel `num_pages`. The kernel walks pages
// b = 0 .. min(ceil(ctx / page), max_pages) - 1 and SKIPS any page id outside
// [0, num_pages): on the TPU the block index was clamped, on the GPU the
// sentinel would read out of bounds.
//
// What bounds it on an H100: a decode step reads every live K/V row once and
// does 4 * G * D flops per row (G <= 8), well under one flop per byte, so it
// is bound by bytes (3.35 TB/s); int8 pools halve those bytes (plus 8 scale
// bytes a row). Design: one block per (slot, kv head); the
// G query heads of the kv head share each K/V row the block reads. Keys are
// staged in shared memory 32 at a time with 16-byte loads; each thread
// scores (g, key) pairs, one warp per query head runs the online-softmax
// update, and each thread owns G*D/128 accumulator entries in fp32
// registers. Known limit: at S x KH = 16 x 4 = 64 blocks (TinyLlama widths)
// the grid under-fills the 132 SMs, and each block streams its pages one
// after another; splitting a slot's pages across blocks (flash-decoding
// split-K) and keeping several tiles in flight (cp.async / TMA) are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kKeys = 32;      // keys staged per tile
constexpr int kMaxGroup = 8;   // query heads per kv head handled by a block

template <int D, bool kStats, bool kInt8>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const __nv_bfloat16* __restrict__ q,       // [S, KH, G, D]
                    const void* __restrict__ k_pool,   // [KH, R, D] bf16 / int8
                    const void* __restrict__ v_pool,   // [KH, R, D] bf16 / int8
                    const float* __restrict__ k_scale,         // [KH, R] (int8)
                    const float* __restrict__ v_scale,         // [KH, R] (int8)
                    const int32_t* __restrict__ block_table,   // [S, maxp]
                    const int32_t* __restrict__ ctx_len,       // [S]
                    void* __restrict__ out,   // bf16 [S,KH,G,D] or f32 acc
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
        if (live && kInt8) {
          const size_t row = (size_t)pid * page + in_page;
          const size_t off = pool_off + row * D + c;
          const uint2 kraw = *reinterpret_cast<const uint2*>(
              static_cast<const int8_t*>(k_pool) + off);
          const uint2 vraw = *reinterpret_cast<const uint2*>(
              static_cast<const int8_t*>(v_pool) + off);
          const float ksc = k_scale[(size_t)kh * R + row];
          const float vsc = v_scale[(size_t)kh * R + row];
          const int8_t* k8 = reinterpret_cast<const int8_t*>(&kraw);
          const int8_t* v8 = reinterpret_cast<const int8_t*>(&vraw);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            kf[e] = (float)k8[e] * ksc;
            vf[e] = (float)v8[e] * vsc;
          }
        } else if (live) {
          const size_t off = pool_off + ((size_t)pid * page + in_page) * D + c;
          const uint4 kraw = *reinterpret_cast<const uint4*>(
              static_cast<const __nv_bfloat16*>(k_pool) + off);
          const uint4 vraw = *reinterpret_cast<const uint4*>(
              static_cast<const __nv_bfloat16*>(v_pool) + off);
          const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&kraw);
          const __nv_bfloat162* v2 = reinterpret_cast<const __nv_bfloat162*>(&vraw);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 a = __bfloat1622float2(k2[e]);
            const float2 bb = __bfloat1622float2(v2[e]);
            kf[2 * e] = a.x; kf[2 * e + 1] = a.y;
            vf[2 * e] = bb.x; vf[2 * e + 1] = bb.y;
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

  constexpr float kLn2 = 0.6931471805599453f;
#pragma unroll
  for (int i = 0; i < kOutPerThread; ++i) {
    const int o = tid + i * kThreads;
    if (o < G * D) {
      const int g = o / D;
      if (kStats) {
        static_cast<float*>(out)[head_off * D + o] = acc[i];
      } else {
        static_cast<__nv_bfloat16*>(out)[head_off * D + o] =
            __float2bfloat16(acc[i] / fmaxf(l_s[g], 1e-30f));
      }
    }
  }
  if (kStats && tid < G) {
    // m is kept in log2 units (scale_log2 folded into q): back to natural
    m_out[head_off + tid] = m_s[tid] == -INFINITY ? -INFINITY : m_s[tid] * kLn2;
    l_out[head_off + tid] = l_s[tid];
  }
}

template <int D, bool kStats, bool kInt8>
cudaError_t launch(const void* q, const void* k_pool, const void* v_pool,
                   const float* k_scale, const float* v_scale,
                   const int32_t* block_table, const int32_t* ctx, void* out,
                   float* m_out, float* l_out, int S, int KH, int G, int R,
                   int page, int max_pages, int num_pages, float scale,
                   cudaStream_t stream) {
  const dim3 grid(S, KH);
  const float scale_log2 = scale * 1.4426950408889634f;
  paged_decode_kernel<D, kStats, kInt8><<<grid, kThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), k_pool, v_pool, k_scale, v_scale,
      block_table, ctx, out, m_out, l_out, KH, G, R, page, max_pages,
      num_pages, scale_log2);
  return cudaGetLastError();
}

template <bool kStats, bool kInt8>
int dispatch(const void* q, const void* k_pool, const void* v_pool,
             const float* k_scale, const float* v_scale,
             const int32_t* block_table, const int32_t* ctx, void* out,
             float* m_out, float* l_out, int S, int KH, int G, int D, int R,
             int page, int max_pages, int num_pages, float scale,
             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S <= 0 || KH <= 0 || G <= 0 || G > kMaxGroup || page <= 0 ||
      max_pages <= 0 || (kInt8 && (!k_scale || !v_scale)))
    return (int)cudaErrorInvalidValue;
  if (D == 64)
    return (int)launch<64, kStats, kInt8>(
        q, k_pool, v_pool, k_scale, v_scale, block_table, ctx, out, m_out,
        l_out, S, KH, G, R, page, max_pages, num_pages, scale, st);
  if (D == 128)
    return (int)launch<128, kStats, kInt8>(
        q, k_pool, v_pool, k_scale, v_scale, block_table, ctx, out, m_out,
        l_out, S, KH, G, R, page, max_pages, num_pages, scale, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" int tgi_paged_decode(const void* q, const void* k_pool,
                                const void* v_pool, const int32_t* block_table,
                                const int32_t* ctx, void* out, int S, int KH,
                                int G, int D, int R, int page, int max_pages,
                                int num_pages, float scale, void* stream) {
  return dispatch<false, false>(q, k_pool, v_pool, nullptr, nullptr,
                                block_table, ctx, out, nullptr, nullptr, S, KH,
                                G, D, R, page, max_pages, num_pages, scale,
                                stream);
}

extern "C" int tgi_paged_decode_stats(const void* q, const void* k_pool,
                                      const void* v_pool,
                                      const int32_t* block_table,
                                      const int32_t* ctx, float* acc,
                                      float* m_out, float* l_out, int S,
                                      int KH, int G, int D, int R, int page,
                                      int max_pages, int num_pages,
                                      float scale, void* stream) {
  return dispatch<true, false>(q, k_pool, v_pool, nullptr, nullptr,
                               block_table, ctx, acc, m_out, l_out, S, KH, G,
                               D, R, page, max_pages, num_pages, scale, stream);
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
  return dispatch<true, true>(q, k_pool, v_pool, k_scale, v_scale,
                              block_table, ctx, acc, m_out, l_out, S, KH, G, D,
                              R, page, max_pages, num_pages, scale, stream);
}

extern "C" const char* tgi_paged_decode_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
