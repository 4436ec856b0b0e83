// Paged causal flash attention for contiguous query chunks (prefill and
// mixed steps), for sm_90a.
//
// Replaces dynamo_tpu/ops/pallas_prefill.py:_prefill_kernel (launched at
// :295 by paged_prefill_attention).
//
// Bound: bytes at short chunks, operations at long ones. A chunk of T
// queries over a kv_len-token history moves its K/V strips once
// (2 * kv_len * W * itemsize bytes) and does ~4 * T * kv_len * H * head_dim
// flops under the causal mask; a 512-token chunk is well above the card's
// ridge, so the flop term bounds it.
//
// Design:
// - One block per (query block, KV head, sequence). A query block holds
//   TQ = 64 / G tokens x the G query heads of one KV head: 64 rows, t-major
//   (row r is chunk token r / G, head r % G), so every block contracts only
//   against its own head's strip — the useful flops only.
// - Causality needs no position tensor beyond the row's start: queries are
//   contiguous, so row r sits at start + qi*TQ + r/G. kv_len = max(positions)+1
//   and start = positions[:, 0], read by the block itself.
// - Causal early exit: the key walk stops at clip(start + (qi+1)*TQ, 1, kv_len);
//   a query block wholly past the row's span (the 1-token decode rows a
//   mixed step carries, start = kv_len-1) does no work and writes zeros.
// - The mask is kpos <= qpos and kpos < kv_len; rows with l == 0 write 0, not NaN.
// - bf16 caches (the serving path) run on the tensor cores: mma.sync
//   m16n8k16 with f32 accumulation, the online softmax on the accumulators
//   in registers (prefill_mma_kernel). f32 caches, which exist to check the
//   algorithm without bf16 rounding, run a register-tiled scalar-FMA kernel
//   with the same block structure (prefill_kernel). wgmma/TMA pipelining is
//   later work.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 64;         // query rows (token x head) per block (ops/paged_prefill.py BLOCK_ROWS)
constexpr int kBlockTokens = 64;  // keys per iteration
constexpr int kPStride = kBlockTokens + 1;
static_assert(kBlockTokens == 64, "the softmax step gives each lane two keys");

template <typename CT, int HD>
struct PrefillSmem {
  static constexpr int kKStride = HD + CacheVec<CT>::N;
  static constexpr int kQStride = HD + 4;
  static constexpr size_t bytes() {
    return sizeof(CT) * (size_t)kBlockTokens * (kKStride + HD) +
           sizeof(float) * ((size_t)kRows * kQStride + (size_t)kRows * kPStride + 3 * kRows) + 2 * sizeof(int);
  }
};

template <typename CT, typename QT, int HD>
__global__ void __launch_bounds__(kThreads) prefill_kernel(
    const QT* __restrict__ q,          // [B, T, H, HD]
    const CT* __restrict__ kc,         // [P, ps, W]
    const CT* __restrict__ vc,
    const int* __restrict__ tables,    // [B, N]
    const int* __restrict__ positions, // [B, T]
    QT* __restrict__ out,              // [B, T, H, HD]
    int T, int H, int n_kv, int ps, int N, float scale) {
  constexpr int kKStride = PrefillSmem<CT, HD>::kKStride;
  constexpr int kQStride = PrefillSmem<CT, HD>::kQStride;
  constexpr int VEC = CacheVec<CT>::N;
  constexpr int OC = HD / 16;  // output columns per thread
  const int G = H / n_kv, TQ = kRows / G, rows = TQ * G, W = n_kv * HD;
  const int qi = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tr = tid >> 4, tc = tid & 15;  // 16 x 16 thread grid

  extern __shared__ __align__(16) unsigned char smem_raw[];
  CT* ks = reinterpret_cast<CT*>(smem_raw);                          // [BK][kKStride]
  CT* vs = ks + kBlockTokens * kKStride;                             // [BK][HD]
  float* qs = reinterpret_cast<float*>(vs + kBlockTokens * HD);      // [kRows][kQStride]
  float* pt = qs + kRows * kQStride;                                 // [kRows][kPStride]
  float* m_s = pt + kRows * kPStride;
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;
  int* span = reinterpret_cast<int*>(a_s + kRows);  // [0] = max position

  const int* prow = positions + (size_t)b * T;
  if (tid == 0) span[0] = 0;
  __syncthreads();
  int mx = 0;
  for (int t = tid; t < T; t += kThreads) mx = max(mx, prow[t]);
  atomicMax(span, mx);
  const int t0 = qi * TQ;
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int r = i / HD, d = i - r * HD, t = t0 + r / G, g = r % G;
    float x = 0.f;
    if (r < rows && t < T) {
      x = to_f32(from_f32<CT>(to_f32(q[(((size_t)b * T + t) * H + kvh * G + g) * HD + d]) * scale));
    }
    qs[r * kQStride + d] = x;
  }
  for (int r = tid; r < kRows; r += kThreads) {
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  __syncthreads();
  const int kv_len = max(span[0] + 1, 1);
  const int start = prow[0];
  const bool has_work = start + t0 < kv_len;
  const int kend = min(max(start + t0 + TQ, 1), kv_len);
  const int nblocks = has_work ? (kend + kBlockTokens - 1) / kBlockTokens : 0;
  const int last_page = min((kv_len - 1) / ps, N - 1);
  const int* trow = tables + (size_t)b * N;

  float o[4][OC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < OC; ++c) o[i][c] = 0.f;

  for (int blk = 0; blk < nblocks; ++blk) {
    const int k0 = blk * kBlockTokens;
    load_kv_tile<CT, HD, kThreads, kBlockTokens>(kc, vc, trow, ks, vs, kKStride, HD, k0, last_page, ps, W, kvh);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // Scores: rows tr + 16i, keys tc + 16j.
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d0 = 0; d0 < HD; d0 += VEC) {
      float kf[4][VEC];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        CacheVec<CT>::unpack(*reinterpret_cast<const uint4*>(ks + (tc + 16 * j) * kKStride + d0), kf[j]);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float* qr = qs + (tr + 16 * i) * kQStride + d0;
#pragma unroll
        for (int x = 0; x < VEC; x += 4) {
          const float4 qv = *reinterpret_cast<const float4*>(qr + x);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(qv.x, kf[j][x], s[i][j]);
            s[i][j] = fmaf(qv.y, kf[j][x + 1], s[i][j]);
            s[i][j] = fmaf(qv.z, kf[j][x + 2], s[i][j]);
            s[i][j] = fmaf(qv.w, kf[j][x + 3], s[i][j]);
          }
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tr + 16 * i;
      const int qpos = start + t0 + r / G;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tc + 16 * j;
        pt[r * kPStride + tc + 16 * j] = (kpos <= qpos && kpos < kv_len) ? s[i][j] : kNegInf;
      }
    }
    __syncthreads();
    // Online-softmax stats: one warp per row, p masked explicitly.
    for (int r = warp; r < kRows; r += kWarps) {
      const int qpos = start + t0 + r / G;
      const int ka = k0 + lane, kb = k0 + lane + 32;
      const float s0 = pt[r * kPStride + lane];
      const float s1 = pt[r * kPStride + lane + 32];
      float mrow = fmaxf(s0, s1);
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mrow = fmaxf(mrow, __shfl_xor_sync(0xffffffffu, mrow, off));
      const float m_old = m_s[r];
      const float m_new = fmaxf(m_old, mrow);
      const float p0 = (ka <= qpos && ka < kv_len) ? expf(s0 - m_new) : 0.f;
      const float p1 = (kb <= qpos && kb < kv_len) ? expf(s1 - m_new) : 0.f;
      float sum = p0 + p1;
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
      pt[r * kPStride + lane] = p0;
      pt[r * kPStride + lane + 32] = p1;
      __syncwarp();
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        m_s[r] = m_new;
        l_s[r] = alpha * l_s[r] + sum;
        a_s[r] = alpha;
      }
    }
    __syncthreads();
    // o = alpha * o + p . V for rows tr + 16i, columns tc + 16c.
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = a_s[tr + 16 * i];
#pragma unroll
      for (int c = 0; c < OC; ++c) o[i][c] *= a;
    }
#pragma unroll 4
    for (int k = 0; k < kBlockTokens; ++k) {
      float p[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) p[i] = pt[(tr + 16 * i) * kPStride + k];
#pragma unroll
      for (int c = 0; c < OC; ++c) {
        const float vv = to_f32(vs[k * HD + tc + 16 * c]);
#pragma unroll
        for (int i = 0; i < 4; ++i) o[i][c] = fmaf(p[i], vv, o[i][c]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tr + 16 * i;
    const int t = t0 + r / G;
    if (r >= rows || t >= T) continue;
    const float l = l_s[r];
    QT* orow = out + (((size_t)b * T + t) * H + kvh * G + r % G) * HD;
#pragma unroll
    for (int c = 0; c < OC; ++c) orow[tc + 16 * c] = from_f32<QT>(l > 0.f ? o[i][c] / l : 0.f);
  }
}

// ---------------------------------------------------------------------------
// bf16 caches: the same tiling on the tensor cores (mma.sync m16n8k16,
// bf16 in, f32 accumulate). Four warps, each owning 16 of the 64 query rows;
// per 64-key tile a warp computes its 16x64 scores (Q fragments stay in
// registers for the whole walk, K fragments are 32-bit shared loads), runs
// the online softmax on the accumulators in registers (a row lives in one
// quad of lanes), and feeds p — rounded to bf16 as the TPU kernel rounds it
// (pallas_prefill.py:210) — straight from the score accumulators into the
// p.V product, V fragments loaded with ldmatrix.trans.

constexpr int kMmaThreads = 128;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

template <int HD>
struct MmaSmem {
  static constexpr int kStride = HD + 8;  // bf16 row stride: 16-byte aligned, fragment loads conflict-free
  // Q tile + two (K, V) tile buffers.
  static constexpr size_t bytes() { return sizeof(__nv_bfloat16) * (size_t)5 * 64 * kStride + 2 * sizeof(int); }
};

template <typename QT, int HD>
__global__ void __launch_bounds__(kMmaThreads) prefill_mma_kernel(
    const QT* __restrict__ q, const __nv_bfloat16* __restrict__ kc, const __nv_bfloat16* __restrict__ vc,
    const int* __restrict__ tables, const int* __restrict__ positions, QT* __restrict__ out,
    int T, int H, int n_kv, int ps, int N, float scale) {
  constexpr int S = MmaSmem<HD>::kStride;
  constexpr int KSTEPS = HD / 16;  // k-steps of the score product
  constexpr int NT = HD / 8;       // n-tiles of the output
  const int G = H / n_kv, TQ = kRows / G, rows = TQ * G, W = n_kv * HD;
  const int qi = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][S]
  __nv_bfloat16* tiles = qs + 64 * S;                               // 2 x (K [64][S], V [64][S])
  int* span = reinterpret_cast<int*>(tiles + 4 * 64 * S);

  const int* prow = positions + (size_t)b * T;
  if (tid == 0) span[0] = 0;
  __syncthreads();
  int mx = 0;
  for (int t = tid; t < T; t += kMmaThreads) mx = max(mx, prow[t]);
  atomicMax(span, mx);
  __syncthreads();
  const int kv_len = max(span[0] + 1, 1);
  const int start = prow[0];
  const int t0 = qi * TQ;
  const bool has_work = start + t0 < kv_len;
  const int kend = min(max(start + t0 + TQ, 1), kv_len);
  const int nblocks = has_work ? (kend + kBlockTokens - 1) / kBlockTokens : 0;
  const int last_page = min((kv_len - 1) / ps, N - 1);
  const int* trow = tables + (size_t)b * N;
  auto start_tile = [&](int blk) {  // cp.async of key block blk into buffer blk&1
    __nv_bfloat16* kt = tiles + (blk & 1) * 2 * 64 * S;
    load_kv_tile<__nv_bfloat16, HD, kMmaThreads, kBlockTokens>(kc, vc, trow, kt, kt + 64 * S, S, S,
                                                               blk * kBlockTokens, last_page, ps, W, kvh);
    cp_async_commit();
  };
  if (nblocks > 0) start_tile(0);  // in flight while the queries are staged
  for (int i = tid; i < kRows * HD; i += kMmaThreads) {
    const int r = i / HD, d = i - r * HD, t = t0 + r / G;
    float x = 0.f;
    if (r < rows && t < T) x = to_f32(q[(((size_t)b * T + t) * H + kvh * G + r % G) * HD + d]) * scale;
    qs[r * S + d] = __float2bfloat16(x);
  }
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  const int qpos0 = start + t0 + r0 / G, qpos1 = start + t0 + (r0 + 8) / G;
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = kk * 16 + 2 * t4;
    qa[kk][0] = *reinterpret_cast<const uint32_t*>(qs + r0 * S + c);
    qa[kk][1] = *reinterpret_cast<const uint32_t*>(qs + (r0 + 8) * S + c);
    qa[kk][2] = *reinterpret_cast<const uint32_t*>(qs + r0 * S + c + 8);
    qa[kk][3] = *reinterpret_cast<const uint32_t*>(qs + (r0 + 8) * S + c + 8);
  }
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int blk = 0; blk < nblocks; ++blk) {
    const int k0 = blk * kBlockTokens;
    // Double buffer: key block blk+1's copies fly while block blk is reduced.
    if (blk + 1 < nblocks) {
      start_tile(blk + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* ks = tiles + (blk & 1) * 2 * 64 * S;
    const __nv_bfloat16* vs = ks + 64 * S;
    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KSTEPS; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kr = ks + (j * 8 + g) * S + kk * 16 + 2 * t4;
        mma_bf16(s[j], qa[kk], *reinterpret_cast<const uint32_t*>(kr), *reinterpret_cast<const uint32_t*>(kr + 8));
      }
    }
    // Mask, then the online softmax of rows r0 (elements 0,1) and r0+8 (2,3).
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + j * 8 + 2 * t4 + e;
        if (!(kpos <= qpos0 && kpos < kv_len)) s[j][e] = kNegInf;
        if (!(kpos <= qpos1 && kpos < kv_len)) s[j][2 + e] = kNegInf;
        mx0 = fmaxf(mx0, s[j][e]);
        mx1 = fmaxf(mx1, s[j][2 + e]);
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + j * 8 + 2 * t4 + e;
        s[j][e] = (kpos <= qpos0 && kpos < kv_len) ? expf(s[j][e] - mn0) : 0.f;
        s[j][2 + e] = (kpos <= qpos1 && kpos < kv_len) ? expf(s[j][2 + e] - mn1) : 0.f;
        sum0 += s[j][e];
        sum1 += s[j][2 + e];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    const float a0 = expf(m0 - mn0), a1 = expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 = a0 * l0 + sum0;
    l1 = a1 * l1 + sum1;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
    }
    // o += p . V: 16 keys per k-step; p's A fragment is two score n-tiles.
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
      const __nv_bfloat16* vrow = vs + (kk * 16 + (lane & 15)) * S;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(vrow + n * 8));
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(addr));
        mma_bf16(o[n], pa, b0, b1);
      }
    }
    __syncthreads();
  }
  // Rows with no attendable key (l == 0) write 0, not NaN.
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const int t = t0 + r / G;
    if (r >= rows || t >= T) continue;
    const float l = half ? l1 : l0;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    QT* orow = out + (((size_t)b * T + t) * H + kvh * G + r % G) * HD;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int d = n * 8 + 2 * t4;
      orow[d] = from_f32<QT>(o[n][2 * half] * inv);
      orow[d + 1] = from_f32<QT>(o[n][2 * half + 1] * inv);
    }
  }
}

template <typename CT, typename QT, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables, const int* positions,
                   void* out, int B, int T, int H, int n_kv, int ps, int N, float scale, cudaStream_t stream) {
  const int tq = kRows / (H / n_kv);
  const dim3 grid((T + tq - 1) / tq, n_kv, B);
  if constexpr (std::is_same<CT, __nv_bfloat16>::value) {
    const size_t smem = MmaSmem<HD>::bytes();
    auto kern = prefill_mma_kernel<QT, HD>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    kern<<<grid, kMmaThreads, smem, stream>>>(static_cast<const QT*>(q), static_cast<const __nv_bfloat16*>(k),
                                              static_cast<const __nv_bfloat16*>(v), tables, positions,
                                              static_cast<QT*>(out), T, H, n_kv, ps, N, scale);
    return cudaGetLastError();
  } else {
    const size_t smem = PrefillSmem<CT, HD>::bytes();
    auto kern = prefill_kernel<CT, QT, HD>;
    if (smem > 48 * 1024) {
      const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (e != cudaSuccess) return e;
    }
    kern<<<grid, kThreads, smem, stream>>>(static_cast<const QT*>(q), static_cast<const CT*>(k),
                                           static_cast<const CT*>(v), tables, positions, static_cast<QT*>(out), T,
                                           H, n_kv, ps, N, scale);
    return cudaGetLastError();
  }
}

}  // namespace

// Launches the prefill kernel on `stream`; returns the cudaGetLastError()
// code (0 = launched). No synchronisation, no allocation.
extern "C" int dyn_paged_prefill(const void* q, const void* k, const void* v, const int* tables,
                                 const int* positions, void* out, int B, int T, int H, int n_kv,
                                 int head_dim, int ps, int N, int cache_dtype, int q_dtype, float scale,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DYN_PREFILL_CASE(CC, QC, HDV, CT, QT)                                                         \
  if (cache_dtype == CC && q_dtype == QC && head_dim == HDV)                                          \
    return (int)launch<CT, QT, HDV>(q, k, v, tables, positions, out, B, T, H, n_kv, ps, N, scale, st);
  DYN_PREFILL_CASE(1, 1, 64, __nv_bfloat16, __nv_bfloat16)
  DYN_PREFILL_CASE(1, 1, 128, __nv_bfloat16, __nv_bfloat16)
  DYN_PREFILL_CASE(1, 0, 64, __nv_bfloat16, float)
  DYN_PREFILL_CASE(1, 0, 128, __nv_bfloat16, float)
  DYN_PREFILL_CASE(0, 0, 64, float, float)
  DYN_PREFILL_CASE(0, 0, 128, float, float)
  DYN_PREFILL_CASE(0, 1, 64, float, __nv_bfloat16)
  DYN_PREFILL_CASE(0, 1, 128, float, __nv_bfloat16)
#undef DYN_PREFILL_CASE
  return (int)cudaErrorInvalidValue;
}
