// Paged MLA (DeepSeek latent) attention over the latent cache, for sm_90a:
// decode, multi-query verify, prefill chunks and mixed steps alike.
//
// Replaces dynamo_tpu/ops/pallas_mla.py:_mla_decode_kernel (launched at
// :291 by mla_paged_decode) and its host-side combine (pallas_paged.py
// _lse_combine, :212).
//
// In the absorbed formulation MLA is multi-query attention: every query
// head attends to ONE shared stream, key [c ; k_rope] (latent width D =
// kv_lora_rank plus DR = qk_rope_head_dim rope lanes) and value c. Scores are
// q_lat . c + q_rope . r; the output stays in latent space (f32, D wide);
// each query row is masked to its own horizon kpos <= positions[b, t].
//
// Bound. Decode reads each sequence's whole latent history once
// ((D + DR) * itemsize bytes a token) but all H query heads share it, so it
// does ~2 * H * (2D + DR) / ((D + DR) * 2) = ~60 operations a bf16 byte at
// H = 32: far more than a scalar-FMA kernel can do in the bytes bound's
// time, so bf16 caches run on the tensor cores. A 512-token prefill chunk
// is bound by its operations.
//
// Design:
// - The T * H query rows of a sequence (row = t * H + h) are cut into tiles
//   of kRows = 32; one block per (split, row tile, sequence). Every T runs
//   here: a T = 1 decode row is one tile at H = 32, a prefill chunk many.
//   A tile's key walk ends at its own farthest query position (causal early
//   exit); tiles wholly past the row's last real token (the padding of the
//   1-token decode rows a mixed step carries) do no work and write zeros.
// - Split-K over the key walk in 64-key blocks, the split plan from static
//   shapes only (ops/paged_mla.py mla_split_plan), partials (acc, m, l)
//   merged by a log-sum-exp combine; with one split the block divides by l
//   itself, which is what the combine would give. Every per-row reduction is
//   the same code whatever the tile holds, and key blocks past a row's
//   horizon add exactly 0 (p masked explicitly, alpha = exp(0) = 1), so a
//   T_q = 1 decode equals the same column of a verify row bit for bit.
// - bf16 caches (mla_mma_kernel): mma.sync m16n8k16, f32 accumulation. Per
//   64-key tile the 8 warps compute the 32 x 64 scores once (each a 16 x 16
//   piece over the D + DR contraction: latent lanes, then rope lanes, in two
//   accumulator chains), mask them into shared memory, run the online
//   softmax (8 lanes a row, a warp's 4 rows at once), and
//   then each warp owns a D/8-column slice of the 32 x D f32 output (the
//   whole accumulator does not fit one warp's registers), fed from the
//   bf16 p tile and the same shared c tile (ldmatrix.trans). K/V tiles
//   stream in with cp.async, double-buffered: tile i+1 is in flight while
//   tile i is reduced. p is rounded to bf16 for the value product, as the
//   TPU kernel rounds it (pallas_mla.py:221).
// - f32 caches (mla_f32_kernel), kept to check the algorithm without bf16
//   rounding: the same blocks on scalar FMA, 32-key sub-tiles.
// - Only the first DR lanes of each rope row are read: the cache row is
//   r_width = max(DR, 128) wide with a zero tail (models/mla.py
//   mla_cache_widths).
// - Queries are scaled in f32 and rounded to the cache dtype while staged
//   (the scale is folded into the kernel; pallas_mla.py:273-276 does the
//   same outside its kernel).
// - wgmma/TMA, fp8 caches and a head-sharded form are later work.

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;         // query rows per block (ops/paged_mla.py ROW_TILE)
constexpr int kBlockTokens = 64;  // split granularity and bf16 key tile (ops/paged_mla.py BLOCK_TOKENS)
constexpr int kF32Keys = 32;      // key sub-tile of the f32 kernel
constexpr int kSStride = kBlockTokens + 1;  // f32 score row stride
constexpr int kPStride = kBlockTokens + 8;  // bf16 p row stride (fragment loads conflict-free)
static_assert(kBlockTokens == 64 && kRows == 32, "the tilings below assume 32 rows x 64 keys");

// Shared-memory sizes; ops/paged_mla.py _smem_bytes mirrors them.
__host__ __device__ constexpr size_t mma_smem_bytes(int D, int DR) {
  return sizeof(__nv_bfloat16) * (size_t)(kRows + 2 * kBlockTokens) * (D + DR + 8) +
         sizeof(float) * (size_t)kRows * kSStride + sizeof(__nv_bfloat16) * (size_t)kRows * kPStride +
         sizeof(float) * 3 * kRows + sizeof(int) * (kRows + 4);
}
__host__ __device__ constexpr size_t f32_smem_bytes(int D, int DR) {
  return sizeof(float) * ((size_t)(kRows + kF32Keys) * (D + DR + 4) + (size_t)kRows * (kF32Keys + 1) + 3 * kRows) +
         sizeof(int) * (kRows + 4);
}

// Block-wide scan of the sequence's positions: scal[0] = the row's max
// position (its walk length - 1, and its last page), scal[1] = the first
// token index holding it (tokens past it are padding), scal[2] = the max
// position of tokens [t_first, t_last] (this tile's walk length - 1).
__device__ __forceinline__ void scan_positions(const int* __restrict__ prow, int T, int t_first, int t_last,
                                               int* scal) {
  if (threadIdx.x == 0) {
    scal[0] = 0;
    scal[1] = T;
    scal[2] = 0;
  }
  __syncthreads();
  int mx = 0, tm = 0;
  for (int t = threadIdx.x; t < T; t += kThreads) {
    const int p = prow[t];
    mx = max(mx, p);
    if (t >= t_first && t <= t_last) tm = max(tm, p);
  }
  atomicMax(&scal[0], mx);
  atomicMax(&scal[2], tm);
  __syncthreads();
  int first = T;
  for (int t = threadIdx.x; t < T; t += kThreads)
    if (prow[t] == scal[0]) first = min(first, t);
  atomicMin(&scal[1], first);
  __syncthreads();
}

// Start copying keys [k0, k0 + nkeys) into the tile `dst` (row stride QS):
// lanes [0, D) from the latent cache [P, ps, D], lanes [D, D + DR) from the
// first DR lanes of the rope cache [P, ps, RW]; pages of ps = 1 << sh
// tokens. cp.async: the caller commits and waits. The tile's page ids (at
// most 32: k0 is a multiple of 64 and pages hold 2+ tokens) are read once
// per warp, one per lane, and passed by shuffle, so no cp.async waits on a
// table load; the latent chunks map to threads by shifts alone. Page
// lookups clamp to the row's last page, so a -1 in a table tail is never
// read; the clamped keys are masked by position.
template <typename CT, int D>
__device__ __forceinline__ void load_tile(const CT* __restrict__ cc, const CT* __restrict__ rc,
                                          const int* __restrict__ trow, CT* dst, int QS, int k0, int nkeys,
                                          int last_page, int sh, int DR, int RW) {
  constexpr int VEC = CacheVec<CT>::N;
  constexpr int CL = D / VEC;          // latent chunks (16 bytes) per key: a power of 2
  constexpr int KPP = kThreads / CL;   // keys per pass over the latent lanes
  static_assert(kThreads % CL == 0, "a pass covers whole keys");
  const int lane = threadIdx.x & 31, p0 = k0 >> sh, pmask = (1 << sh) - 1;
  const int page = trow[min(p0 + lane, last_page)];
  const int c = (threadIdx.x % CL) * VEC;
  for (int j = threadIdx.x / CL; j < nkeys; j += KPP) {  // nkeys is a multiple of KPP: every lane shuffles
    const int kpos = k0 + j;
    const size_t slot = ((size_t)__shfl_sync(0xffffffffu, page, (kpos >> sh) - p0) << sh) + (kpos & pmask);
    cp_async16(dst + j * QS + c, cc + slot * D + c);
  }
  const int cr = DR / VEC, total = nkeys * cr;  // rope chunks per key, all of them
  for (int base = 0; base < total; base += kThreads) {  // warp-uniform trip count
    const int e = base + threadIdx.x;
    const int j = e / cr, kpos = k0 + j;
    const int pg = __shfl_sync(0xffffffffu, page, min((kpos >> sh) - p0, 31));
    if (e < total) {
      const size_t slot = ((size_t)pg << sh) + (kpos & pmask);
      cp_async16(dst + j * QS + D + (e - j * cr) * VEC, rc + slot * RW + (e - j * cr) * VEC);
    }
  }
}

// Stage the tile's query rows into shared memory as ST: [q_lat | q_rope],
// scaled in f32 and rounded to ST. 16-byte loads, four in flight per thread
// before any is used (rows past `rows` are zeros).
template <typename QT, typename ST>
__device__ __forceinline__ void stage_queries(const QT* __restrict__ ql, const QT* __restrict__ qr, ST* qs, int QS,
                                              int D, int DR, size_t row0, int rows, float scale) {
  constexpr int V = CacheVec<QT>::N;  // elements per 16-byte load
  constexpr int kBatch = 4;
  const int cpr = (D + DR) / V;
  const int total = kRows * cpr;
  for (int base = threadIdx.x; base < total; base += kBatch * kThreads) {
    uint4 u[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads, r = i / cpr, c = (i - r * cpr) * V;
      u[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && r < rows)
        u[k] = *reinterpret_cast<const uint4*>(c < D ? ql + (row0 + r) * D + c : qr + (row0 + r) * DR + (c - D));
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kThreads, r = i / cpr, c = (i - r * cpr) * V;
      if (i >= total) break;
      float f[V];
      CacheVec<QT>::unpack(u[k], f);
#pragma unroll
      for (int v = 0; v < V; ++v) qs[r * QS + c + v] = from_f32<ST>(f[v] * scale);
    }
  }
}

// One 16-deep k-step of a warp's scores: rows qa0/qa1 (+8) of the query
// tile against the keys of two n-tiles (kb0, kb1), at lane offset c.
__device__ __forceinline__ void score_step(float* acc0, float* acc1, const __nv_bfloat16* qa0,
                                           const __nv_bfloat16* qa1, const __nv_bfloat16* kb0,
                                           const __nv_bfloat16* kb1, int c) {
  const uint32_t af[4] = {ld32(qa0 + c), ld32(qa1 + c), ld32(qa0 + c + 8), ld32(qa1 + c + 8)};
  mma_bf16(acc0, af, ld32(kb0 + c), ld32(kb0 + c + 8));
  mma_bf16(acc1, af, ld32(kb1 + c), ld32(kb1 + c + 8));
}

// The online-softmax step of a key tile of KT keys for all kRows rows: each
// warp takes 4 rows at once, 8 lanes a row, KT/8 keys a lane (keys
// g8 + 8i). Scores in st (masked to NEG_INF); p written to `pw` (row stride
// pstride); each row's m, l and rescale factor updated. Fixed shuffle trees
// inside each 8-lane group, so a row's arithmetic does not depend on which
// rows share its tile.
template <int KT, typename PT>
__device__ __forceinline__ void softmax_rows(const float* st, int sstride, PT* pw, int pstride, int k0,
                                             const int* qpos, float* m_s, float* l_s, float* a_s) {
  static_assert(kRows == 4 * kWarps, "each warp takes 4 rows");
  constexpr int KPL = KT / 8;
  const int lane = threadIdx.x & 31, g8 = lane & 7;
  const int r = (threadIdx.x >> 5) * 4 + (lane >> 3);
  const int qp = qpos[r];
  float s[KPL];
  float mx = kNegInf;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    s[i] = st[r * sstride + g8 + 8 * i];
    mx = fmaxf(mx, s[i]);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  const float m_old = m_s[r];
  const float m_new = fmaxf(m_old, mx);
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < KPL; ++i) {
    // Explicit p mask: an all-masked tile has s == m_new == NEG_INF.
    const float p = (k0 + g8 + 8 * i <= qp) ? expf(s[i] - m_new) : 0.f;
    sum += p;
    pw[r * pstride + g8 + 8 * i] = from_f32<PT>(p);
  }
#pragma unroll
  for (int o = 1; o < 8; o <<= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
  if (g8 == 0) {
    const float alpha = expf(m_old - m_new);
    m_s[r] = m_new;
    l_s[r] = alpha * l_s[r] + sum;
    a_s[r] = alpha;
  }
}

struct MlaArgs {
  const void* q_lat;  // [B, T, H, D]
  const void* q_rope; // [B, T, H, DR]
  const void* cc;     // [P, ps, D]
  const void* rc;     // [P, ps, RW]
  const int* tables;  // [B, N]
  const int* positions;  // [B, T]
  float* acc;         // [B, S, R, D] split partials (S > 1)
  float* m;           // [B, S, R]
  float* l;           // [B, S, R]
  float* out;         // [B, R, D] (S == 1)
  int T, H, DR, RW, ps, N, S, bps;
  float scale;
};

// The block's common prologue: position scan, the tile's walk, its stats
// initialised. Returns the number of 64-key blocks this split walks.
struct Walk {
  int r0, rows, first, nb, last_page, sh;  // sh: log2 of the page size
};

__device__ __forceinline__ Walk plan_walk(const MlaArgs& a, int* scal, int* qpos, float* m_s, float* l_s) {
  const int sp = blockIdx.x, tile = blockIdx.y, b = blockIdx.z;
  const int R = a.T * a.H;
  Walk w;
  w.r0 = tile * kRows;
  w.rows = min(kRows, R - w.r0);
  const int* prow = a.positions + (size_t)b * a.T;
  scan_positions(prow, a.T, w.r0 / a.H, (w.r0 + w.rows - 1) / a.H, scal);
  const int nb_total = (w.r0 / a.H <= scal[1]) ? (scal[2] + kBlockTokens) / kBlockTokens : 0;
  w.first = sp * a.bps;
  w.nb = min(max(nb_total - w.first, 0), a.bps);
  w.sh = __ffs(a.ps) - 1;
  w.last_page = min(scal[0] >> w.sh, a.N - 1);
  for (int r = threadIdx.x; r < kRows; r += kThreads) {
    qpos[r] = r < w.rows ? prow[(w.r0 + r) / a.H] : -1;  // rows past the tile's end mask every key
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  return w;
}

// Row r's result: the final output (S == 1: acc / l, 0 where l == 0, as the
// combine gives) or this split's partials.
__device__ __forceinline__ void store_row2(const MlaArgs& a, const Walk& w, int D, int r, int col, float v0,
                                          float v1, float l) {
  const int b = blockIdx.z;
  const size_t R = (size_t)a.T * a.H;
  if (a.S == 1) {
    const float2 v = l > 0.f ? make_float2(v0 / l, v1 / l) : make_float2(0.f, 0.f);
    *reinterpret_cast<float2*>(a.out + ((size_t)b * R + w.r0 + r) * D + col) = v;
  } else {
    const size_t o = (((size_t)b * a.S + blockIdx.x) * R + w.r0 + r) * D + col;
    *reinterpret_cast<float2*>(a.acc + o) = make_float2(v0, v1);
  }
}

__device__ __forceinline__ void store_stats(const MlaArgs& a, const Walk& w, const float* m_s, const float* l_s) {
  if (a.S == 1) return;
  const size_t R = (size_t)a.T * a.H;
  for (int r = threadIdx.x; r < w.rows; r += kThreads) {
    const size_t o = ((size_t)blockIdx.z * a.S + blockIdx.x) * R + w.r0 + r;
    a.m[o] = m_s[r];
    a.l[o] = l_s[r];
  }
}

// ---------------------------------------------------------------------------
// bf16 caches: tensor cores.

template <typename QT, int D>
__global__ void __launch_bounds__(kThreads, 1) mla_mma_kernel(const MlaArgs a) {
  using bf16 = __nv_bfloat16;
  constexpr int NT = D / 64;  // output n-tiles (8 columns) per warp: D/8 columns each
  const int DR = a.DR, QS = D + DR + 8, KSTEPS = (D + DR) / 16;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const size_t R = (size_t)a.T * a.H;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);                   // [kRows][QS]: q_lat | q_rope
  bf16* kv = qs + kRows * QS;                                     // 2 x [64][QS]: c | r
  float* st = reinterpret_cast<float*>(kv + 2 * kBlockTokens * QS);  // [kRows][kSStride]
  bf16* pt = reinterpret_cast<bf16*>(st + kRows * kSStride);      // [kRows][kPStride]
  float* m_s = reinterpret_cast<float*>(pt + kRows * kPStride);
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;
  int* qpos = reinterpret_cast<int*>(a_s + kRows);
  int* scal = qpos + kRows;

  const Walk w = plan_walk(a, scal, qpos, m_s, l_s);
  const int* trow = a.tables + (size_t)b * a.N;
  const bf16* cc = static_cast<const bf16*>(a.cc);
  const bf16* rc = static_cast<const bf16*>(a.rc);
  auto start_tile = [&](int i) {  // cp.async of key block first+i into buffer i&1
    load_tile<bf16, D>(cc, rc, trow, kv + (i & 1) * kBlockTokens * QS, QS, (w.first + i) * kBlockTokens,
                       kBlockTokens, w.last_page, w.sh, DR, a.RW);
    cp_async_commit();
  };
  if (w.nb > 0) {
    start_tile(0);  // in flight while the queries are staged
    stage_queries<QT, bf16>(static_cast<const QT*>(a.q_lat), static_cast<const QT*>(a.q_rope), qs, QS, D, DR,
                            (size_t)b * R + w.r0, w.rows, a.scale);
  }

  const int mt = warp & 1, nt0 = (warp >> 1) * 2;  // scores: m-tile mt, n-tiles nt0, nt0+1
  const int c0 = warp * (D / 8);                   // output: columns [c0, c0 + D/8)
  float o[2][NT][4];
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n) o[m][n][0] = o[m][n][1] = o[m][n][2] = o[m][n][3] = 0.f;

  for (int i = 0; i < w.nb; ++i) {
    const int k0 = (w.first + i) * kBlockTokens;
    if (i + 1 < w.nb) {
      start_tile(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* ks = kv + (i & 1) * kBlockTokens * QS;
    // Scores of rows mt*16 + {g, g+8}, keys (nt0 + j)*8 + 2*t4 + {0, 1},
    // over the latent lanes, then the rope lanes: even k-steps into s, odd
    // ones into s2 (two independent accumulator chains a key n-tile), summed.
    float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    float s2[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
    const bf16* qa0 = qs + (mt * 16 + g) * QS + 2 * t4;
    const bf16* qa1 = qa0 + 8 * QS;
    const bf16* kb0 = ks + (nt0 * 8 + g) * QS + 2 * t4;
    const bf16* kb1 = kb0 + 8 * QS;
#pragma unroll 2
    for (int kk = 0; kk + 1 < KSTEPS; kk += 2) {
      score_step(s[0], s[1], qa0, qa1, kb0, kb1, kk * 16);
      score_step(s2[0], s2[1], qa0, qa1, kb0, kb1, kk * 16 + 16);
    }
    if (KSTEPS & 1) score_step(s[0], s[1], qa0, qa1, kb0, kb1, (KSTEPS - 1) * 16);
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] += s2[j][e];
    const int ra = mt * 16 + g, rb = ra + 8;
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int key = (nt0 + j) * 8 + 2 * t4 + e;
        st[ra * kSStride + key] = k0 + key <= qpos[ra] ? s[j][e] : kNegInf;
        st[rb * kSStride + key] = k0 + key <= qpos[rb] ? s[j][2 + e] : kNegInf;
      }
    __syncthreads();
    softmax_rows<kBlockTokens, bf16>(st, kSStride, pt, kPStride, k0, qpos, m_s, l_s, a_s);
    __syncthreads();
    // o = alpha * o + p . c over this warp's column slice.
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float al0 = a_s[m * 16 + g], al1 = a_s[m * 16 + g + 8];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        o[m][n][0] *= al0;
        o[m][n][1] *= al0;
        o[m][n][2] *= al1;
        o[m][n][3] *= al1;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBlockTokens / 16; ++kk) {
      uint32_t pa[2][4];
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const bf16* p0 = pt + (m * 16 + g) * kPStride + kk * 16 + 2 * t4;
        pa[m][0] = ld32(p0);
        pa[m][1] = ld32(p0 + 8 * kPStride);
        pa[m][2] = ld32(p0 + 8);
        pa[m][3] = ld32(p0 + 8 * kPStride + 8);
      }
      const bf16* vrow = ks + (kk * 16 + (lane & 15)) * QS + c0;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t b0, b1;
        const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(vrow + n * 8));
        asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
                     : "=r"(b0), "=r"(b1)
                     : "r"(addr));
        mma_bf16(o[0][n], pa[0], b0, b1);
        mma_bf16(o[1][n], pa[1], b0, b1);
      }
    }
    __syncthreads();  // buffer i&1, st and pt are free for block i+1
  }
  __syncthreads();  // the stats' initialisation is visible even when no block was walked
#pragma unroll
  for (int m = 0; m < 2; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m * 16 + g + 8 * half;
      if (r >= w.rows) continue;
      const float l = l_s[r];
#pragma unroll
      for (int n = 0; n < NT; ++n)
        store_row2(a, w, D, r, c0 + n * 8 + 2 * t4, o[m][n][2 * half], o[m][n][2 * half + 1], l);
    }
  store_stats(a, w, m_s, l_s);
}

// ---------------------------------------------------------------------------
// f32 caches: scalar FMA, the same blocks and walk.

template <typename QT, int D>
__global__ void __launch_bounds__(kThreads) mla_f32_kernel(const MlaArgs a) {
  constexpr int TPR = D < kThreads ? D : kThreads;  // threads sharing one row of the output
  constexpr int RPT = kRows * TPR / kThreads;       // output rows per thread
  constexpr int CPT = D / TPR;                      // output columns per thread
  constexpr int KT = kF32Keys;
  const int DR = a.DR, QS = D + DR + 4, DK = D + DR;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t R = (size_t)a.T * a.H;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kRows][QS]
  float* kv = qs + kRows * QS;                     // [KT][QS]
  float* st = kv + KT * QS;                        // [kRows][KT + 1]: scores, then p
  float* m_s = st + kRows * (KT + 1);
  float* l_s = m_s + kRows;
  float* a_s = l_s + kRows;
  int* qpos = reinterpret_cast<int*>(a_s + kRows);
  int* scal = qpos + kRows;

  const Walk w = plan_walk(a, scal, qpos, m_s, l_s);
  const int* trow = a.tables + (size_t)b * a.N;
  if (w.nb > 0)
    stage_queries<QT, float>(static_cast<const QT*>(a.q_lat), static_cast<const QT*>(a.q_rope), qs, QS, D, DR,
                             (size_t)b * R + w.r0, w.rows, a.scale);
  const int col0 = tid % TPR, row0 = (tid / TPR) * RPT;
  float o[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.f;

  for (int kt = 0; kt < w.nb * (kBlockTokens / KT); ++kt) {
    const int k0 = w.first * kBlockTokens + kt * KT;
    load_tile<float, D>(static_cast<const float*>(a.cc), static_cast<const float*>(a.rc), trow, kv, QS, k0, KT,
                        w.last_page, w.sh, DR, a.RW);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // Scores: one (row, key) dot product per thread, latent lanes then rope lanes, in order.
    for (int e = tid; e < kRows * KT; e += kThreads) {
      const int r = e / KT, j = e - r * KT;
      const float* qr = qs + r * QS;
      const float* kr = kv + j * QS;
      float s = 0.f;
      for (int d = 0; d < DK; d += 4) {
        const float4 qv = *reinterpret_cast<const float4*>(qr + d);
        const float4 kvv = *reinterpret_cast<const float4*>(kr + d);
        s = fmaf(qv.x, kvv.x, s);
        s = fmaf(qv.y, kvv.y, s);
        s = fmaf(qv.z, kvv.z, s);
        s = fmaf(qv.w, kvv.w, s);
      }
      st[r * (KT + 1) + j] = k0 + j <= qpos[r] ? s : kNegInf;
    }
    __syncthreads();
    softmax_rows<KT, float>(st, KT + 1, st, KT + 1, k0, qpos, m_s, l_s, a_s);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float al = a_s[row0 + i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) o[i][c] *= al;
    }
    for (int j = 0; j < KT; ++j) {
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = kv[j * QS + col0 + c * TPR];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float p = st[(row0 + i) * (KT + 1) + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) o[i][c] = fmaf(p, vv[c], o[i][c]);
      }
    }
    __syncthreads();  // kv and st are free for the next sub-tile
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = row0 + i;
    if (r >= w.rows) continue;
    const float l = l_s[r];
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = col0 + c * TPR;
      if (a.S == 1) {
        a.out[((size_t)b * R + w.r0 + r) * D + col] = l > 0.f ? o[i][c] / l : 0.f;
      } else {
        a.acc[(((size_t)b * a.S + blockIdx.x) * R + w.r0 + r) * D + col] = o[i][c];
      }
    }
  }
  store_stats(a, w, m_s, l_s);
}

// Log-sum-exp merge of the split partials (pallas_paged.py:_lse_combine);
// a row no split attended (a padding tile) gets 0. One block per row: the
// split weights exp(m_s - max m) and the denominator once in shared memory,
// then each thread merges 4 columns with 16-byte loads, splits in order.
constexpr int kCombineThreads = 128;

__global__ void __launch_bounds__(kCombineThreads) mla_combine(const float* __restrict__ acc,
                                                               const float* __restrict__ m,
                                                               const float* __restrict__ l, float* __restrict__ out,
                                                               int S, int R, int D) {
  extern __shared__ float wts[];  // [S] split weights, then the denominator
  const int row = blockIdx.x;     // b * R + r
  const int b = row / R, r = row - b * R;
  const size_t o0 = (size_t)b * S * R + r;  // split s of this row: o0 + s * R
  float mmax = kNegInf;
  for (int s = 0; s < S; ++s) mmax = fmaxf(mmax, m[o0 + (size_t)s * R]);
  for (int s = threadIdx.x; s < S; s += kCombineThreads) wts[s] = expf(m[o0 + (size_t)s * R] - mmax);
  __syncthreads();
  if (threadIdx.x == 0) {
    float den = 0.f;
    for (int s = 0; s < S; ++s) den += wts[s] * l[o0 + (size_t)s * R];
    wts[S] = den;
  }
  __syncthreads();
  const float den = wts[S];
  for (int d = 4 * threadIdx.x; d < D; d += 4 * kCombineThreads) {
    float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int s = 0; s < S; ++s) {
      const float4 x = *reinterpret_cast<const float4*>(acc + (o0 + (size_t)s * R) * D + d);
      const float al = wts[s];
      num.x += x.x * al;
      num.y += x.y * al;
      num.z += x.z * al;
      num.w += x.w * al;
    }
    const float4 v = den > 0.f ? make_float4(num.x / den, num.y / den, num.z / den, num.w / den)
                               : make_float4(0.f, 0.f, 0.f, 0.f);
    *reinterpret_cast<float4*>(out + (size_t)row * D + d) = v;
  }
}

template <typename CT, typename QT, int D>
cudaError_t launch(const MlaArgs& a, int B, cudaStream_t stream) {
  const int R = a.T * a.H;
  const dim3 grid(a.S, (R + kRows - 1) / kRows, B);
  const bool bf = std::is_same<CT, __nv_bfloat16>::value;
  const size_t smem = bf ? mma_smem_bytes(D, a.DR) : f32_smem_bytes(D, a.DR);
  auto kern = bf ? mla_mma_kernel<QT, D> : mla_f32_kernel<QT, D>;
  // Raised once per kernel to the largest size asked for, so a launch being
  // captured into a CUDA graph after a warm-up call makes no attribute call.
  static size_t smem_allowed = 48 * 1024;
  if (smem > smem_allowed) {
    const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    smem_allowed = smem;
  }
  kern<<<grid, kThreads, smem, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || a.S == 1) return e;
  mla_combine<<<B * R, kCombineThreads, sizeof(float) * (a.S + 1), stream>>>(a.acc, a.m, a.l, a.out, a.S, R, D);
  return cudaGetLastError();
}

}  // namespace

// Launches the MLA attention (and, with S > 1 splits, the combine) on
// `stream`; returns the cudaGetLastError() code (0 = launched). No
// synchronisation, no allocation: acc/m/l are the caller's split scratch
// (unused, may be null, when S == 1). Output f32 [B, T, H, D].
extern "C" int dyn_paged_mla(const void* q_lat, const void* q_rope, const void* c_cache, const void* r_cache,
                             const int* tables, const int* positions, float* acc, float* m, float* l, float* out,
                             int B, int T, int H, int D, int DR, int RW, int ps, int N, int S, int bps,
                             int cache_dtype, int q_dtype, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const MlaArgs a{q_lat, q_rope, c_cache, r_cache, tables, positions, acc, m, l, out,
                  T, H, DR, RW, ps, N, S, bps, scale};
#define DYN_MLA_CASE(CC, QC, DV, CT, QT) \
  if (cache_dtype == CC && q_dtype == QC && D == DV) return (int)launch<CT, QT, DV>(a, B, st);
  DYN_MLA_CASE(1, 1, 512, __nv_bfloat16, __nv_bfloat16)
  DYN_MLA_CASE(1, 1, 128, __nv_bfloat16, __nv_bfloat16)
  DYN_MLA_CASE(1, 0, 512, __nv_bfloat16, float)
  DYN_MLA_CASE(1, 0, 128, __nv_bfloat16, float)
  DYN_MLA_CASE(0, 0, 512, float, float)
  DYN_MLA_CASE(0, 0, 128, float, float)
  DYN_MLA_CASE(0, 1, 512, float, __nv_bfloat16)
  DYN_MLA_CASE(0, 1, 128, float, __nv_bfloat16)
#undef DYN_MLA_CASE
  return (int)cudaErrorInvalidValue;
}
