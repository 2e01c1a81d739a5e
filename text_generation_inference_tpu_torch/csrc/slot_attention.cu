// One-query decode attention over the slot KV cache, for sm_90a. Two entry
// points:
//   tgi_slot_decode  S1: out[s, kh, g] = softmax(q . k) v over cache rows
//                    in [lo[s], ctx[s]) (lo null: from row 0; a sliding
//                    window W gives lo = ctx - W, as the JAX model's decode
//                    mask; the Pallas kernel takes no window), with slope *
//                    row added to each scaled score given ALiBi slopes
//                    ([KH, G] f32, or null; the JAX rule sends ALiBi to its
//                    einsum, ops/attention.py:67); the split
//                    body of csrc/decode_split.cuh (its
//                    design, the shapes it takes and what bounds it are
//                    written there) with the slot cache as its row source:
//                    fixed 256-row splits of T, cp.async stages, mma.sync,
//                    the splits merged in split order in the same launch
//   tgi_ring_decode  S2: the same softmax over three sources at once: cache
//                    rows < ctx[s] (ctx = the chunk's start position),
//                    ring-buffer columns < step, and the current token's k/v
//                    (no ALiBi: its one caller, the decode probe, serves
//                    none)
//
// Replaces: the JAX package's
//   ops/pallas/decode_attention.py      decode_attention (`_kernel`,
//                                       pallas_call at :142), S1;
//   ops/pallas/ring_decode_attention.py ring_decode_attention (`_kernel`,
//                                       pallas_call at :239), S2.
//
// Layouts (the JAX layouts): q [S, KH, G, D] in T (the entry's `dtype`:
// 0 bf16, 1 fp16, 2 fp32, the last on the split body's fp32 CUDA-core
// kernel); the cache k/v [S, KH, T, D] in T with the head
// dim contiguous and any strides over S, KH and T (a layer view
// `cache.k[l]`, or a view narrowed to the first T rows of a longer cache,
// costs no copy); ring buffers [S, KH, C, D] and the current k/v [S, KH, D]
// in T, contiguous; ctx [S] int32; out [S, KH, G, D] in T. A slot with
// ctx == 0 and no ring source gives 0 (the JAX kernel clamps the denominator
// at 1e-30; its XLA reference gives NaN). Rows at or past ctx are never read.
//
// S2's design: phase 1 is the split body in its partials mode, the splits
// of S1's plan each writing their (acc, m, l) to the scratch; phase 2 (one
// block per (slot, kv head)) merges the slot's live splits in split order,
// scores the ring columns and the current token on CUDA cores, folds them
// into the same softmax, and normalizes.

#include "decode_split.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRing = 1024;   // ring-buffer columns

__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(float x) { return x; }

// Phase 2 of S2: merge the live splits of one (slot, kv head), the ring
// columns < step and the current token; normalize and round to T. part is
// the split body's scratch [S, KH * chunks, splits, min(G, 16), D + 2].
// kD: the head dim, or 0 to take it at run time (`D_rt`, the fp32 entry)
template <typename T, int kD>
__global__ void __launch_bounds__(kThreads)
ring_merge_kernel(const T* __restrict__ q,              // [S, KH, G, D]
                  const float* __restrict__ part,
                  const int32_t* __restrict__ ctx_len,  // [S]
                  const T* __restrict__ kbuf,           // [S, KH, C, D]
                  const T* __restrict__ vbuf,
                  const T* __restrict__ k_new,          // [S, KH, D]
                  const T* __restrict__ v_new,
                  T* __restrict__ out,                  // [S, KH, G, D]
                  int KH, int G, int D_rt, int T_rows, int rows_per_split,
                  int splits, int C, int step, float scale_log2) {
  const int D = kD ? kD : D_rt;
  // q [G * D], p [G * (C + 1)], the merged max and sum [G] each
  extern __shared__ float ring_s[];
  constexpr int kMaxGroup = decode_split::kMaxGroup;
  const int s = blockIdx.x;
  const int kh = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const size_t sk = (size_t)s * KH + kh;
  const int ncol = C + 1;                    // ring columns, then the current token
  const int chunks = (G + kMaxGroup - 1) / kMaxGroup;
  const int gs = min(G, kMaxGroup);
  const int ctx = min(max(ctx_len[s], 0), T_rows);
  const int n_live = max(1, (ctx + rows_per_split - 1) / rows_per_split);
  float* qs = ring_s;
  float* ps = ring_s + G * D;
  float* mx_s = ps + G * ncol;
  float* l_s = mx_s + G;
  // split sp's row of query head g
  auto row = [&](int sp, int g) {
    return part + (((sk * chunks + g / kMaxGroup) * splits + sp) * gs +
                   g % kMaxGroup) * (D + 2);
  };

  for (int i = tid; i < G * D; i += kThreads)
    qs[i] = to_float(q[sk * G * D + i]) * scale_log2;
  __syncthreads();
  for (int idx = tid; idx < G * ncol; idx += kThreads) {
    const int g = idx / ncol;
    const int c = idx % ncol;
    const T* kr = nullptr;
    if (c < step) kr = kbuf + (sk * C + c) * D;
    else if (c == C) kr = k_new + sk * D;
    float sc = -INFINITY;
    if (kr != nullptr) {
      sc = 0.f;
      const float* qg = qs + g * D;
#pragma unroll 8
      for (int d = 0; d < D; ++d) sc += qg[d] * to_float(kr[d]);
    }
    ps[idx] = sc;
  }
  __syncthreads();

  // one warp per query head: the merged max (log2 units), the sum
  for (int g = warp; g < G; g += kWarps) {
    float mx = -INFINITY;
    for (int sp = lane; sp < n_live; sp += 32) mx = fmaxf(mx, row(sp, g)[D]);
    for (int c = lane; c < ncol; c += 32) mx = fmaxf(mx, ps[g * ncol + c]);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    const float m_safe = (mx == -INFINITY) ? 0.f : mx;
    float lsum = 0.f;
    for (int sp = lane; sp < n_live; sp += 32) {
      const float m = row(sp, g)[D];
      if (m != -INFINITY) lsum += exp2f(m - m_safe) * row(sp, g)[D + 1];
    }
    for (int c = lane; c < ncol; c += 32) {
      const float x = ps[g * ncol + c];
      const float p = (x == -INFINITY) ? 0.f : exp2f(x - m_safe);
      ps[g * ncol + c] = p;
      lsum += p;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      lsum += __shfl_xor_sync(0xffffffffu, lsum, off);
    if (lane == 0) {
      mx_s[g] = m_safe;
      l_s[g] = lsum;
    }
  }
  __syncthreads();

  for (int o = tid; o < G * D; o += kThreads) {
    const int g = o / D;
    const int d = o % D;
    float a = 0.f;
    for (int sp = 0; sp < n_live; ++sp) {        // in split order
      const float* r = row(sp, g);
      const float m = r[D];
      if (m != -INFINITY) a += exp2f(m - mx_s[g]) * r[d];
    }
    const float* pg = ps + g * ncol;
    for (int c = 0; c < step; ++c)
      a += pg[c] * to_float(vbuf[(sk * C + c) * D + d]);
    a += pg[C] * to_float(v_new[sk * D + d]);
    out[(sk * G + g) * D + d] =
        decode_split::Elem<T>::from_float(a / fmaxf(l_s[g], 1e-30f));
  }
}

template <typename T, int kD>
cudaError_t launch_merge(const decode_split::Args& a, int S, int D,
                         const void* kbuf, const void* vbuf,
                         const void* k_new, const void* v_new, int splits,
                         int C, int step, cudaStream_t stream) {
  const size_t smem = (size_t)a.G * (D + C + 3) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        ring_merge_kernel<T, kD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
  }
  ring_merge_kernel<T, kD><<<dim3(S, a.KH), kThreads, smem, stream>>>(
      static_cast<const T*>(a.q), a.part, a.ctx, static_cast<const T*>(kbuf),
      static_cast<const T*>(vbuf), static_cast<const T*>(k_new),
      static_cast<const T*>(v_new), static_cast<T*>(a.out), a.KH, a.G, D, a.T,
      a.rows_per_split, splits, C, step, a.scale_log2);
  return cudaGetLastError();
}

// bf16 and fp16 at the head dims the split body is built for
template <typename T>
cudaError_t launch_merge_d(const decode_split::Args& a, int S, int D,
                           const void* kbuf, const void* vbuf,
                           const void* k_new, const void* v_new, int splits,
                           int C, int step, cudaStream_t st) {
  switch (D) {
#define TGI_RING_CASE(DV)                                                   \
    case DV:                                                                \
      return launch_merge<T, DV>(a, S, D, kbuf, vbuf, k_new, v_new, splits, \
                                 C, step, st);
    TGI_RING_CASE(16) TGI_RING_CASE(64) TGI_RING_CASE(80) TGI_RING_CASE(96)
    TGI_RING_CASE(128) TGI_RING_CASE(192) TGI_RING_CASE(256)
#undef TGI_RING_CASE
    default: return cudaErrorInvalidValue;
  }
}

bool slot_args(decode_split::Args& a, const void* q, const void* k,
               const void* v, const int32_t* ctx, const int32_t* lo,
               const float* slopes, void* out, float* part,
               unsigned int* arrivals, int KH, int G, int T, long long st_s,
               long long st_k, long long st_t, int rows_per_split, int splits,
               float scale) {
  if (T <= 0 || rows_per_split <= 0 ||
      (long long)splits * rows_per_split < T || st_s % 8 || st_k % 8 ||
      st_t % 8)
    return false;
  a = decode_split::Args{};
  a.q = q;
  a.k = k;
  a.v = v;
  a.ctx = ctx;
  a.lo = lo;
  a.slopes = slopes;
  a.out = out;
  a.part = part;
  a.arrivals = arrivals;
  a.KH = KH;
  a.G = G;
  a.st_s = st_s;
  a.st_k = st_k;
  a.st_t = st_t;
  a.T = T;
  a.rows_per_split = rows_per_split;
  a.scale_log2 = scale * 1.4426950408889634f;
  return true;
}

}  // namespace

// S1: the split body of csrc/decode_split.cuh over the slot cache. lo:
// [S] int32 first live row of each slot, or null for 0 (a row below it is
// never read; the splits are numbered from the one that holds it). slopes:
// [KH, G] f32 ALiBi slopes, or null. part:
// [S, KH * chunks, splits, min(G, 16), D + 2] f32 scratch, chunks =
// ceil(G / 16); arrivals: [S * KH * chunks] uint32, all zero (the kernel
// leaves them zero); both may be null when splits == 1. Strides are in
// elements.
extern "C" int tgi_slot_decode(const void* q, const void* k, const void* v,
                               const int32_t* ctx, const int32_t* lo,
                               const float* slopes, void* out, float* part,
                               unsigned int* arrivals, int S, int KH, int G,
                               int D, int T, long long st_s, long long st_k,
                               long long st_t, int rows_per_split, int splits,
                               int dtype, float scale, void* stream) {
  decode_split::Args a;
  if (!slot_args(a, q, k, v, ctx, lo, slopes, out, part, arrivals, KH, G, T,
                 st_s, st_k, st_t, rows_per_split, splits, scale))
    return (int)cudaErrorInvalidValue;
  return decode_split::dispatch<false, false, decode_split::kOut>(
      a, S, D, dtype, splits, stream);
}

// S2: part is the split scratch as S1's, written by every live split;
// kbuf / vbuf [S, KH, C, D], k_new / v_new [S, KH, D]; ring columns < step
// are live
extern "C" int tgi_ring_decode(const void* q, const void* k, const void* v,
                               const int32_t* ctx, const void* kbuf,
                               const void* vbuf, const void* k_new,
                               const void* v_new, float* part, void* out,
                               int S, int KH, int G, int D, int T,
                               long long st_s, long long st_k, long long st_t,
                               int rows_per_split, int splits, int C, int step,
                               int dtype, float scale, void* stream) {
  decode_split::Args a;
  if (C <= 0 || C > kMaxRing || step < 0 || step > C ||
      !slot_args(a, q, k, v, ctx, nullptr, nullptr, out, part, nullptr, KH, G,
                 T, st_s, st_k, st_t, rows_per_split, splits, scale))
    return (int)cudaErrorInvalidValue;
  int code = decode_split::dispatch<false, false, decode_split::kParts>(
      a, S, D, dtype, splits, stream);
  if (code != 0) return code;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case decode_split::kBf16:
      return (int)launch_merge_d<__nv_bfloat16>(a, S, D, kbuf, vbuf, k_new,
                                                v_new, splits, C, step, st);
    case decode_split::kFp16:
      return (int)launch_merge_d<__half>(a, S, D, kbuf, vbuf, k_new, v_new,
                                         splits, C, step, st);
    default:
      return (int)launch_merge<float, 0>(a, S, D, kbuf, vbuf, k_new, v_new,
                                         splits, C, step, st);
  }
}

extern "C" const char* tgi_slot_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
