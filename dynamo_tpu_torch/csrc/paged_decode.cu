// Paged GQA decode / multi-query verify attention with split-K, for sm_90a.
//
// Replaces dynamo_tpu/ops/pallas_paged.py:_decode_kernel (launched at :507
// by paged_decode_attention) and its host-side combine _lse_combine (:212).
//
// Bound: HBM bytes. Every decode step reads each sequence's whole K/V
// history once (2 * tokens * n_kv * head_dim * itemsize bytes) and does
// ~4 flops per byte of bf16 K/V — far below the card's ~295 flops/byte
// ridge, so the least time is bytes / 3.35 TB/s.
//
// Design against that bound:
// - One block per (split, KV head, sequence). Its G*T_q query rows (GQA
//   group x query tokens) read only that head's head_dim-wide strip at
//   offset kv*head_dim of each page's [page_size, W] slab, so every K/V
//   byte is read by exactly one block (the TPU kernel's block-diagonal
//   eye(n_kv) staging, which spends n_kv times the flops, is gone).
// - Split-K over the sequence (Flash-Decoding): the split count is chosen
//   from static shapes only (batch bucket, KV heads, table width — never
//   runtime lengths), so there are enough blocks in flight to saturate HBM
//   at small batch, and a row's float reduction order never depends on T_q
//   or on the other rows: a T_q=1 decode is bit-identical to the same
//   column inside a T_q=K+1 verify row, and num_splits=1 is bit-identical
//   to the unsplit result.
// - Each thread's arithmetic for a (row, key) score, a row's softmax stats
//   (one warp, fixed shuffle tree) and a (row, dim) output element is the
//   same code whatever the row count, which is what carries those
//   bit-identities.
// - Softmax is online in f32 with p masked explicitly (an all-masked block
//   would otherwise give exp(s - m) = 1). Empty splits write (m=NEG_INF,
//   l=0, acc=0), which the combine turns into exactly 0.
// - K/V tiles stream into shared memory with cp.async, double-buffered:
//   block i+1's pages are in flight while block i is reduced. A deeper
//   TMA ring is later work.

#include "common.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kBlockTokens = 64;  // keys per iteration (ops/paged_decode.py BLOCK_TOKENS)
static_assert(kBlockTokens == 64, "the softmax step gives each lane two keys");

template <typename CT, int HD>
struct DecodeSmem {
  static constexpr int kStride = HD + CacheVec<CT>::N;       // padded K row
  static constexpr int kTile = kBlockTokens * (kStride + HD);  // K + V elements of one buffer
  static size_t bytes(int rows, int t_q) {
    return sizeof(CT) * (size_t)2 * kTile +
           sizeof(float) * ((size_t)2 * rows * HD + (size_t)rows * kBlockTokens + 3 * (size_t)rows) +
           sizeof(int) * (size_t)t_q;
  }
};

template <typename CT, typename QT, int HD>
__global__ void __launch_bounds__(kThreads) decode_partials(
    const QT* __restrict__ q,         // [B, T, H, HD]
    const CT* __restrict__ kc,        // [P, ps, W]
    const CT* __restrict__ vc,        // [P, ps, W]
    const int* __restrict__ tables,   // [B, N]
    const int* __restrict__ positions,// [B, T]
    float* __restrict__ acc_out,      // [B, S, T, H, HD] unnormalized
    float* __restrict__ m_out,        // [B, S, T, H] running max
    float* __restrict__ l_out,        // [B, S, T, H] normalizer
    int T, int H, int n_kv, int ps, int N, int S, int bps, float scale) {
  constexpr int kStride = DecodeSmem<CT, HD>::kStride;
  constexpr int VEC = CacheVec<CT>::N;
  constexpr int VPT = HD / VEC;
  const int G = H / n_kv, R = T * G, W = n_kv * HD;
  const int sp = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  CT* tiles = reinterpret_cast<CT*>(smem_raw);    // 2 x ([BK][kStride] K, [BK][HD] V)
  float* qs = reinterpret_cast<float*>(tiles + 2 * DecodeSmem<CT, HD>::kTile);  // [R][HD]
  float* accs = qs + R * HD;                      // [R][HD]
  float* pt = accs + R * HD;                      // [R][BK] scores, then p
  float* m_s = pt + R * kBlockTokens;             // [R]
  float* l_s = m_s + R;                           // [R]
  float* a_s = l_s + R;                           // [R] rescale factor
  int* qpos = reinterpret_cast<int*>(a_s + R);    // [T]

  // Walk length: the row's farthest query token (max, not last: padding
  // columns carry position 0).
  const int* prow = positions + (size_t)b * T;
  int mx = 0;
  for (int t = 0; t < T; ++t) mx = max(mx, prow[t]);
  const int length = mx + 1;
  const int nb_total = (length + kBlockTokens - 1) / kBlockTokens;
  const int first = sp * bps;
  const int nb_here = min(max(nb_total - first, 0), bps);
  const int last_page = min((length - 1) / ps, N - 1);
  const int* trow = tables + (size_t)b * N;
  auto start_tile = [&](int i) {  // cp.async of block first+i into buffer i&1
    CT* ks = tiles + (i & 1) * DecodeSmem<CT, HD>::kTile;
    load_kv_tile<CT, HD, kThreads, kBlockTokens>(kc, vc, trow, ks, ks + kBlockTokens * kStride, kStride, HD,
                                                 (first + i) * kBlockTokens, last_page, ps, W, kvh);
    cp_async_commit();
  };
  if (nb_here > 0) start_tile(0);  // in flight while the queries are staged

  for (int t = tid; t < T; t += kThreads) qpos[t] = prow[t];
  // Queries pre-scaled in f32, then rounded to the cache dtype (the TPU
  // kernel's staging, pallas_paged.py:483-491).
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD, t = r / G, g = r - t * G;
    const float x = to_f32(q[(((size_t)b * T + t) * H + kvh * G + g) * HD + d]) * scale;
    qs[i] = to_f32(from_f32<CT>(x));
    accs[i] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }

  for (int i = 0; i < nb_here; ++i) {
    const int k0 = (first + i) * kBlockTokens;
    // Double buffer: block i+1's copies fly while block i is reduced.
    if (i + 1 < nb_here) {
      start_tile(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const CT* ks = tiles + (i & 1) * DecodeSmem<CT, HD>::kTile;
    const CT* vs = ks + kBlockTokens * kStride;
    // Scores: one (row, key) dot product per thread, reduced over head_dim in order.
    for (int e = tid; e < R * kBlockTokens; e += kThreads) {
      const int r = e / kBlockTokens, j = e - r * kBlockTokens;
      const float* qr = qs + r * HD;
      const CT* kr = ks + j * kStride;
      float s = 0.f;
#pragma unroll
      for (int c = 0; c < VPT; ++c) {
        float kf[VEC];
        CacheVec<CT>::unpack(*reinterpret_cast<const uint4*>(kr + c * VEC), kf);
#pragma unroll
        for (int x = 0; x < VEC; ++x) s = fmaf(qr[c * VEC + x], kf[x], s);
      }
      pt[e] = (k0 + j <= qpos[r / G]) ? s : kNegInf;
    }
    __syncthreads();
    // Online-softmax stats: one warp per row, a fixed shuffle tree.
    for (int r = warp; r < R; r += kWarps) {
      const int qp = qpos[r / G];
      const float s0 = pt[r * kBlockTokens + lane];
      const float s1 = pt[r * kBlockTokens + lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mx);
      const float p0 = (k0 + lane <= qp) ? expf(s0 - m_new) : 0.f;
      const float p1 = (k0 + lane + 32 <= qp) ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      pt[r * kBlockTokens + lane] = p0;
      pt[r * kBlockTokens + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    // Weighted values: one (row, dim) accumulator per thread, keys in order.
    for (int e = tid; e < R * HD; e += kThreads) {
      const int r = e / HD, d = e - r * HD;
      const float* pr = pt + r * kBlockTokens;
      float a = accs[e] * a_s[r];
#pragma unroll 8
      for (int j = 0; j < kBlockTokens; ++j) a = fmaf(pr[j], to_f32(vs[j * HD + d]), a);
      accs[e] = a;
    }
    __syncthreads();  // buffer i&1 is free for block i+2
  }
  __syncthreads();  // the staging above is visible even when no block was walked
  for (int i = tid; i < R * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD, t = r / G, g = r - t * G;
    acc_out[((((size_t)b * S + sp) * T + t) * H + kvh * G + g) * HD + d] = accs[i];
  }
  for (int r = tid; r < R; r += kThreads) {
    const int t = r / G, g = r - t * G;
    const size_t o = (((size_t)b * S + sp) * T + t) * H + kvh * G + g;
    m_out[o] = m_s[r];
    l_out[o] = l_s[r];
  }
}

// Log-sum-exp merge of the split partials (pallas_paged.py:_lse_combine).
// With one split this is exactly acc / l: alpha = exp(0) = 1.
template <typename QT, int HD>
__global__ void __launch_bounds__(HD) decode_combine(
    const float* __restrict__ acc, const float* __restrict__ m, const float* __restrict__ l,
    QT* __restrict__ out, int S, int TH) {
  const int row = blockIdx.x;  // b * TH + (t * H + h)
  const int b = row / TH, th = row - b * TH;
  const int d = threadIdx.x;
  float mmax = kNegInf;
  for (int s = 0; s < S; ++s) mmax = fmaxf(mmax, m[((size_t)b * S + s) * TH + th]);
  float den = 0.f, num = 0.f;
  for (int s = 0; s < S; ++s) {
    const size_t o = ((size_t)b * S + s) * TH + th;
    const float a = expf(m[o] - mmax);
    den += a * l[o];
    num += acc[o * HD + d] * a;
  }
  out[(size_t)row * HD + d] = from_f32<QT>(num / den);
}

template <typename CT, typename QT, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables, const int* positions,
                   float* acc, float* m, float* l, void* out, int B, int T, int H, int n_kv, int ps,
                   int N, int S, int bps, float scale, cudaStream_t stream) {
  const size_t smem = DecodeSmem<CT, HD>::bytes(T * (H / n_kv), T);
  auto kern = decode_partials<CT, QT, HD>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kern<<<dim3(S, n_kv, B), kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v), tables, positions,
      acc, m, l, T, H, n_kv, ps, N, S, bps, scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  decode_combine<QT, HD><<<B * T * H, HD, 0, stream>>>(acc, m, l, static_cast<QT*>(out), S, T * H);
  return cudaGetLastError();
}

}  // namespace

// Launches the split partials and the combine on `stream`; returns the
// cudaGetLastError() code (0 = launched). No synchronisation, no allocation.
extern "C" int dyn_paged_decode(const void* q, const void* k, const void* v, const int* tables,
                                const int* positions, float* acc, float* m, float* l, void* out, int B,
                                int T, int H, int n_kv, int head_dim, int ps, int N, int S, int bps,
                                int cache_dtype, int q_dtype, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DYN_DECODE_CASE(CC, QC, HDV, CT, QT)                                                        \
  if (cache_dtype == CC && q_dtype == QC && head_dim == HDV)                                        \
    return (int)launch<CT, QT, HDV>(q, k, v, tables, positions, acc, m, l, out, B, T, H, n_kv, ps, N, \
                                    S, bps, scale, st);
  DYN_DECODE_CASE(1, 1, 64, __nv_bfloat16, __nv_bfloat16)
  DYN_DECODE_CASE(1, 1, 128, __nv_bfloat16, __nv_bfloat16)
  DYN_DECODE_CASE(1, 0, 64, __nv_bfloat16, float)
  DYN_DECODE_CASE(1, 0, 128, __nv_bfloat16, float)
  DYN_DECODE_CASE(0, 0, 64, float, float)
  DYN_DECODE_CASE(0, 0, 128, float, float)
  DYN_DECODE_CASE(0, 1, 64, float, __nv_bfloat16)
  DYN_DECODE_CASE(0, 1, 128, float, __nv_bfloat16)
#undef DYN_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}
