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
// Contracts of both kernels:
// - Query rows are t-major per KV head (row r is chunk token r / G, head
//   r % G), so every block contracts only against its own head's strip.
// - Causality needs no position tensor beyond the row's start: queries are
//   contiguous, so row r sits at start + t0 + r/G. kv_len = max(positions)+1
//   and start = positions[:, 0], read by the block itself.
// - Causal early exit: the key walk stops at clip(start + t0 + TQ, 1, kv_len);
//   a query block wholly past the row's span (the 1-token decode rows a
//   mixed step carries, start = kv_len-1) does no work and writes zeros.
// - The mask is kpos <= qpos and kpos < kv_len; rows with l == 0 write 0,
//   not NaN. Page lookups clamp to the row's last used page, so a -1 table
//   tail is never read.
//
// bf16 caches (the serving path): prefill_wgmma_kernel, built for Hopper's
// tensor cores.
// - 128 query rows per block (two consumer warpgroups of 64 rows) and one
//   producer warp. The grid walks query blocks longest-first.
// - S = Q.K^T is wgmma m64n128k16 (128-key tiles) with Q and K read from
//   shared memory; O += P.V is wgmma m64n64k16 with P from registers,
//   rounded to bf16 as the TPU kernel rounds it (pallas_prefill.py:210), and
//   V read MN-major. Every tile sits in the 128-byte-swizzled layout (a
//   64-column atom per 128-byte row; head_dim 128 is two atoms).
// - The producer warp keeps a ring of K/V tiles full with TMA: boxes of
//   whole-page row runs x 64 columns, from page ids the block staged in
//   shared memory once, complete a stage's mbarrier; the consumers release
//   a stage through a second mbarrier. Page sizes that allow no 8-row box
//   fall back to cp.async into the same layout.
// - The mask runs only on the key tiles that cross the warpgroup's first
//   query position or kv_len; the softmax is exp2 (one SFU instruction) with
//   log2(e) folded into the score step in f32 (the queries keep the TPU
//   kernel's rounding: scaled in f32, rounded to bf16).
// What bounds it at a 512-token chunk (PERF.md): the producer's walk (every
// block streams its KV head's whole causal history from L2), then the
// consumers' softmax and the two products, which the two warpgroups overlap
// only with each other.
// fp8 e4m3 caches (pallas_prefill.py:189, the cache read at 1 byte an
// element, the matmuls in bf16): the same kernel, prefill_wgmma_kernel<F8 =
// true>, its consumers unchanged (queries and p in bf16 as the TPU kernel
// keeps them, pallas_prefill.py:277, :210), with a producer warpgroup. Its
// first warp keeps an fp8 ring full (TMA boxes of whole head-strip rows,
// unswizzled, or cp.async), four stages deep at hd 64 and two at hd 128 (the
// page ids come from the table, so the ring takes their room); all four
// warps convert each landed tile (fp8x8_to_bf16x8, exact) into the bf16
// stage in the swizzled layout the wgmma descriptors read, then one thread
// publishes it and the fp8 stage is refilled. setmaxnreg hands the
// producers' registers to the consumers.
// f32 caches, which exist to check the algorithm without bf16 rounding, run
// a register-tiled scalar-FMA kernel (prefill_kernel) of 64-row blocks.

#include <type_traits>

#include "hopper.cuh"

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
// bf16 caches on the tensor cores (wgmma), see the note at the top.

constexpr int kWgRows = 64;                         // query rows of one consumer warpgroup (wgmma M)
constexpr int kConsumers = 2;                       // consumer warpgroups
constexpr int kBlockRows = kWgRows * kConsumers;    // 128 (ops/paged_prefill.py BLOCK_ROWS_BF16)
constexpr int kProducerWarp = 4 * kConsumers;       // warp index of the producer
constexpr int kWgThreads = 128 * kConsumers + 32;
constexpr int kWgThreadsF8 = 128 * (kConsumers + 1);  // fp8: a producer warpgroup
constexpr int kF8ProducerRegs = 72;                    // registers a thread after setmaxnreg (fp8): producers
constexpr int kF8ConsumerRegs = 216;                   // and consumers (128 x 72 + 256 x 216 <= 384 x 168)
constexpr int kTileKeys = 128;                      // keys per ring stage (ops/paged_prefill.py TILE_KEYS)
constexpr int kBarProducers = 2;                    // fp8: the producer warpgroup has converted a tile
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout (bytes from a 1024-aligned base): Q [CH][128 rows][64],
// kStages x (K [CH][TK keys][64], V [CH][TK][64]), full/empty mbarriers,
// the position scan, then (bf16) the page ids of the walk (one per table
// entry at most). fp8 caches read their page ids from the table and spend
// the room on an fp8 ring beside the bf16 one: kF8Stages x (K [TK][HD], V
// [TK][HD]) bytes (4 stages at hd 64, 2 at hd 128) and its full mbarriers.
// ops/paged_prefill.py _smem_bytes mirrors bytes().
template <int HD, bool F8>
struct WgSmem {
  static constexpr int CH = HD / 64;  // 64-column atoms per row
  static constexpr int kStages = HD == 64 ? 4 : 2;  // ops/paged_prefill.py _stages
  static constexpr int kF8Stages = F8 ? (HD == 64 ? 4 : 2) : 0;  // ops/paged_prefill.py _fp8_stages
  static constexpr int kQBytes = CH * kBlockRows * 128;
  static constexpr int kHalf = CH * kTileKeys * 128;  // K (or V) of one stage
  static constexpr int kStageBytes = 2 * kHalf;
  static constexpr int kF8Ring = kQBytes + kStages * kStageBytes;
  static constexpr int kF8StageBytes = 2 * kTileKeys * HD;
  static constexpr int kBar = kF8Ring + kF8Stages * kF8StageBytes;
  static constexpr int kSpan = kBar + (2 * kStages + kF8Stages) * 8;
  static constexpr int kPids = kSpan + 16;
  static size_t bytes(int table_width) { return 1024 + kPids + (F8 ? 0 : sizeof(int) * (size_t)table_width); }
};

static_assert(kTileKeys == 128, "the score product is one wgmma m64n128k16 per 16-deep step");

template <typename QT, int HD, bool F8>
__global__ void __launch_bounds__(F8 ? kWgThreadsF8 : kWgThreads, 1) prefill_wgmma_kernel(
    const QT* __restrict__ q, const unsigned char* __restrict__ kc, const unsigned char* __restrict__ vc,
    const int* __restrict__ tables, const int* __restrict__ positions, QT* __restrict__ out,
    int T, int H, int n_kv, int ps, int N, float scale, const __grid_constant__ CUtensorMap tmk,
    const __grid_constant__ CUtensorMap tmv, int box_rows) {
  using L = WgSmem<HD, F8>;
  constexpr int CH = L::CH;
  constexpr int kStages = L::kStages;
  constexpr int NT = F8 ? kWgThreadsF8 : kWgThreads;
  constexpr int CPR = HD / 8;          // 16-byte chunks per row
  constexpr int NJ = kTileKeys / 8;    // n8 column groups of a score tile
  constexpr int PK = kTileKeys / 16;   // 16-key steps of p.V
  const int G = H / n_kv, TQ = kBlockRows / G, rows = TQ * G, W = n_kv * HD;
  const int kvh = blockIdx.x, qi = gridDim.y - 1 - blockIdx.y, b = blockIdx.z;  // longest query blocks first
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + kStages;
  uint64_t* full8 = empty + kStages;  // fp8: the fp8 ring's stages landed
  int* span = reinterpret_cast<int*>(base + L::kSpan);
  int* pids = reinterpret_cast<int*>(base + L::kPids);

  const int* prow = positions + (size_t)b * T;
  if (tid == 32 && box_rows) {
    tma_prefetch_map(&tmk);
    tma_prefetch_map(&tmv);
  }
  if (tid == 0) {
    span[0] = 0;
    for (int s = 0; s < kStages; ++s) {
      // TMA: the producer's one expect_tx arrival; cp.async: its 32 lanes;
      // fp8: the producer warpgroup's one arrival once the tile is converted.
      mbar_init(&full[s], F8 || box_rows ? 1 : 32);
      mbar_init(&empty[s], 4 * kConsumers);  // one arrival per consumer warp
    }
    // fp8 ring, TMA: the loader's one expect_tx arrival; cp.async: its 32 lanes.
    for (int f = 0; f < L::kF8Stages; ++f) mbar_init(&full8[f], box_rows ? 1 : 32);
    mbar_init_fence();
  }
  __syncthreads();
  const int start = prow[0];
  const int t0 = qi * TQ;
  int mx = 0;
  for (int t = tid; t < T; t += NT) mx = max(mx, prow[t]);
  const int* trow = tables + (size_t)b * N;
  if constexpr (!F8) {
    // Page ids of every tile the walk can reach (kend <= start + t0 + TQ),
    // staged while the position scan is in flight; an entry past the row's
    // last page may be staged, and is never used.
    const int tiles = (max(start + t0 + TQ, 1) + kTileKeys - 1) / kTileKeys;
    const int np = min(N, (tiles * kTileKeys - 1) / ps + 1);
    for (int j = tid; j < np; j += NT) pids[j] = trow[j];
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) mx = max(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  if (lane == 0) atomicMax(span, mx);
  __syncthreads();
  const int kv_len = max(span[0] + 1, 1);
  const bool has_work = start + t0 < kv_len;
  const int kend = min(max(start + t0 + TQ, 1), kv_len);
  const int ntiles = has_work ? (kend + kTileKeys - 1) / kTileKeys : 0;
  const int last_page = min((kv_len - 1) / ps, N - 1);

  if (warp >= kProducerWarp) {  // the producer warp (fp8: warpgroup)
    if (ntiles == 0) return;
    const PageWalk pw(ps, last_page);
    if constexpr (F8) {
      setmaxnreg_dec<kF8ProducerRegs>();
      // The producer warpgroup's first warp keeps the fp8 ring full (K
      // then V of each tile, packed head strips): TMA boxes of box_rows
      // whole rows, or cp.async. All 128 threads convert each landed tile
      // into its bf16 stage; once they all have (a named barrier) the tile
      // is published and its fp8 stage refilled kF8Stages tiles on.
      constexpr int kF8Stages = L::kF8Stages;
      constexpr int C16 = HD / 16;  // 16-byte fp8 chunks of a key's K (or V) strip
      const int ptid = tid - kProducerWarp * 32;
      const bool loader = warp == kProducerWarp;
      auto load8 = [&](int i, auto pow2) {
        const int f = i % kF8Stages;
        unsigned char* st8 = base + L::kF8Ring + f * L::kF8StageBytes;
        if (HD == 128 || box_rows) {  // hd 128: every page size allows a box (rows of 128 bytes)
          if (lane == 0) mbar_arrive_expect_tx(&full8[f], L::kF8StageBytes);
          __syncwarp();
          for (int e = lane; e < kTileKeys / box_rows; e += 32) {
            const int j = e * box_rows;
            const int row = (int)pw.row<decltype(pow2)::value>(trow, i * kTileKeys + j);
            tma_load_2d(st8 + j * HD, &tmk, kvh * HD, row, &full8[f]);
            tma_load_2d(st8 + kTileKeys * HD + j * HD, &tmv, kvh * HD, row, &full8[f]);
          }
        } else if constexpr (HD == 64) {
          // lane l copies 16-byte chunk l % C16 of key rows l / C16, + 32 / C16, ...
          const int c = lane % C16;
          for (int j0 = 0; j0 < kTileKeys; j0 += 32 / C16) {
            const int j = j0 + lane / C16;
            const size_t off = pw.row<decltype(pow2)::value>(trow, i * kTileKeys + j) * W + kvh * HD + c * 16;
            cp_async16(st8 + j * HD + c * 16, kc + off);
            cp_async16(st8 + kTileKeys * HD + j * HD + c * 16, vc + off);
          }
          mbar_arrive_cp_async(&full8[f]);
        }
      };
      auto load_tile8 = [&](int i) {
        if (pw.pow2) {
          load8(i, Bool<true>());
        } else {
          load8(i, Bool<false>());
        }
      };
      if (loader)
        for (int i = 0; i < kF8Stages && i < ntiles; ++i) load_tile8(i);
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages, f = i % kF8Stages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        mbar_wait(&full8[f], (i / kF8Stages) & 1);
        // Chunk e: 16 bytes c of key row j's K and V strips, bf16 chunks 2c
        // and 2c + 1 of its atom row (at hd 64 a quarter-warp writes two
        // rows' even, then odd, slots: eight distinct bank groups).
        const uint32_t s8 = smem_u32(base + L::kF8Ring + f * L::kF8StageBytes);
        const uint32_t sb = smem_u32(base + L::kQBytes + s * L::kStageBytes);
        auto convert = [&](uint32_t src, uint32_t dst) {
          const uint4 x = ld_shared16(src);
          st_shared16(dst, fp8x8_to_bf16x8(make_uint2(x.x, x.y)));
          st_shared16(dst ^ 16, fp8x8_to_bf16x8(make_uint2(x.z, x.w)));
        };
        for (int e = ptid; e < kTileKeys * C16; e += 128) {
          const int j = e / C16, c = e % C16;
          const uint32_t dst = sb + (c >> 2) * (kTileKeys * 128) + j * 128 + ((((2 * c) ^ j) & 7) << 4);
          convert(s8 + e * 16, dst);
          convert(s8 + kTileKeys * HD + e * 16, dst + L::kHalf);
        }
        fence_proxy_async();  // the converted tile is read by wgmma (the async proxy)
        named_bar_sync(kBarProducers, 128);  // every producer thread is done with fp8 stage f
        if (ptid == 0) mbar_arrive(&full[s]);
        if (loader && i + kF8Stages < ntiles) load_tile8(i + kF8Stages);
      }
      if (HD == 64 && loader && !box_rows) cp_async_wait<0>();
      return;
    } else {
      // TMA: lane l loads box l of the tile's K and V (kTileKeys / box_rows
      // boxes of box_rows keys per 64-column atom) into ring stage i % kStages.
      const int nbox = box_rows ? (kTileKeys / box_rows) * CH : 0;
      auto tma_tile = [&](int i, auto pow2) {
        uint64_t* bar = &full[i % kStages];
        unsigned char* st = base + L::kQBytes + (i % kStages) * L::kStageBytes;
        for (int e = lane; e < nbox; e += 32) {
          const int a = e % CH, j = (e / CH) * box_rows;
          const int row = (int)pw.row<decltype(pow2)::value>(pids, i * kTileKeys + j);
          const int dst = 2 * (a * (kTileKeys * 64) + j * 64);
          tma_load_2d(st + dst, &tmk, kvh * HD + a * 64, row, bar);
          tma_load_2d(st + L::kHalf + dst, &tmv, kvh * HD + a * 64, row, bar);
        }
      };
      // cp.async: lane l copies 16-byte chunk c = l % C16 of keys l / C16,
      // + 32 / C16, ... into the swizzled layout.
      constexpr int C16 = HD * 2 / 16;  // 16-byte chunks per row
      constexpr int KPI = 32 / C16;     // keys per pass of the warp
      const int c = lane % C16;
      const size_t col = (size_t)kvh * HD * 2 + c * 16;  // bytes into a cache row
      const int dcol = (c >> 3) * (kTileKeys * 64);
      auto copy_tile = [&](int i, auto pow2) {
        unsigned char* ks = base + L::kQBytes + (i % kStages) * L::kStageBytes;
        unsigned char* vs = ks + L::kHalf;
#pragma unroll 8
        for (int j0 = 0; j0 < kTileKeys; j0 += KPI) {
          const int j = j0 + lane / C16;
          const size_t off = pw.row<decltype(pow2)::value>(pids, i * kTileKeys + j) * W * 2 + col;
          const int dst = 2 * (dcol + j * 64 + swz128(c & 7, j));
          cp_async16(ks + dst, kc + off);
          cp_async16(vs + dst, vc + off);
        }
      };
      for (int i = 0; i < ntiles; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        uint64_t* bar = &full[s];
        if (box_rows) {
          if (lane == 0) mbar_arrive_expect_tx(bar, L::kStageBytes);
          __syncwarp();
          if (pw.pow2) {
            tma_tile(i, Bool<true>());
          } else {
            tma_tile(i, Bool<false>());
          }
        } else {
          if (pw.pow2) {
            copy_tile(i, Bool<true>());
          } else {
            copy_tile(i, Bool<false>());
          }
          mbar_arrive_cp_async(bar);
        }
      }
      cp_async_wait<0>();
      return;
    }
  }

  // ---- consumers: warpgroup wg owns block rows [64 wg, 64 wg + 64) ----
  const int wg = warp >> 2, wl = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = wg * kWgRows + wl * 16 + g;  // this thread's rows: r0 and r0 + 8
  if (ntiles == 0) {  // wholly past the row's span: zeros
    for (int e = tid; e < kBlockRows * HD; e += 128 * kConsumers) {
      const int r = e / HD, d = e - r * HD, t = t0 + r / G;
      if (r < rows && t < T) out[(((size_t)b * T + t) * H + kvh * G + r % G) * HD + d] = from_f32<QT>(0.f);
    }
    return;
  }
  if constexpr (F8) setmaxnreg_inc<kF8ConsumerRegs>();
  // Queries: scaled in f32, rounded to bf16, swizzled.
  for (int e = tid; e < kBlockRows * CPR; e += 128 * kConsumers) {
    const int r = e / CPR, c = e - r * CPR, t = t0 + r / G;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < rows && t < T) {
      float f[8];
      load8(q + (((size_t)b * T + t) * H + kvh * G + r % G) * HD + c * 8, f);
      u = make_uint4(pack_bf16(f[0] * scale, f[1] * scale), pack_bf16(f[2] * scale, f[3] * scale),
                     pack_bf16(f[4] * scale, f[5] * scale), pack_bf16(f[6] * scale, f[7] * scale));
    }
    *reinterpret_cast<uint4*>(qs + (c >> 3) * (kBlockRows * 64) + r * 64 + swz128(c & 7, r)) = u;
  }
  fence_proxy_async();
  named_bar_sync(1, 128 * kConsumers);

  const int qbase = start + t0;
  const int qpos0 = qbase + r0 / G, qpos1 = qbase + (r0 + 8) / G;
  const int wg_first = qbase + (wg * kWgRows) / G;  // the warpgroup's smallest query position
  const int wg_last = qbase + min(wg * kWgRows + kWgRows - 1, rows - 1) / G;
  // Key tiles this warpgroup needs; the rest of the block's walk (the other
  // warpgroup's causal tail) it only releases.
  const int wg_tiles = wg_first < kv_len ? (min(wg_last + 1, kv_len) + kTileKeys - 1) / kTileKeys : 0;
  const uint32_t q_addr = smem_u32(qs) + wg * kWgRows * 128;
  const uint32_t ring = smem_u32(base + L::kQBytes);

  float o[CH][32];
#pragma unroll
  for (int c = 0; c < CH; ++c)
#pragma unroll
    for (int i = 0; i < 32; ++i) o[c][i] = 0.f;
  float sc[kTileKeys / 2] = {};
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // l: this thread's partial row sums

  for (int i = 0; i < ntiles; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    if (i >= wg_tiles) {  // the other warpgroup's tail: release only, once its loads landed
      if (lane == 0) mbar_arrive(&empty[s]);
      continue;
    }
    if (!F8 && !box_rows) fence_proxy_async();  // cp.async tiles are the generic proxy's (fp8: the producer fenced)
    const uint32_t k_addr = ring + s * L::kStageBytes;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const uint32_t off = (kk & 3) * 32;  // 16-column step inside the 128-byte row
      wgmma_m64n128k16_ss(sc, sw128_desc(q_addr + (kk >> 2) * (kBlockRows * 128) + off),
                          sw128_desc(k_addr + (kk >> 2) * (kTileKeys * 128) + off), kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // Mask only the tiles that cross the warpgroup's first query or kv_len.
    const int k0 = i * kTileKeys;
    if (k0 + kTileKeys - 1 > wg_first || k0 + kTileKeys > kv_len) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = k0 + 8 * j + 2 * t4 + e;
          if (kpos > qpos0 || kpos >= kv_len) sc[4 * j + e] = -INFINITY;
          if (kpos > qpos1 || kpos >= kv_len) sc[4 * j + 2 + e] = -INFINITY;
        }
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * j], sc[4 * j + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    // A row with no key yet keeps m = -inf: subtract 0 so p = exp2(-inf) = 0.
    const float ms0 = (mn0 == -INFINITY ? 0.f : mn0) * kLog2e;
    const float ms1 = (mn1 == -INFINITY ? 0.f : mn1) * kLog2e;
    const float a0 = fast_exp2(fmaf(m0, kLog2e, -ms0)), a1 = fast_exp2(fmaf(m1, kLog2e, -ms1));
    m0 = mn0;
    m1 = mn1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[4 * j + e] = fast_exp2(fmaf(sc[4 * j + e], kLog2e, -ms0));
        sc[4 * j + 2 + e] = fast_exp2(fmaf(sc[4 * j + 2 + e], kLog2e, -ms1));
        sum0 += sc[4 * j + e];
        sum1 += sc[4 * j + 2 + e];
      }
    }
    l0 = a0 * l0 + sum0;
    l1 = a1 * l1 + sum1;
    uint32_t pa[PK][4];  // p as bf16 A fragments, one per 16-key step
#pragma unroll
    for (int kk = 0; kk < PK; ++kk) {
      pa[kk][0] = pack_bf16(sc[8 * kk], sc[8 * kk + 1]);
      pa[kk][1] = pack_bf16(sc[8 * kk + 2], sc[8 * kk + 3]);
      pa[kk][2] = pack_bf16(sc[8 * kk + 4], sc[8 * kk + 5]);
      pa[kk][3] = pack_bf16(sc[8 * kk + 6], sc[8 * kk + 7]);
    }
#pragma unroll
    for (int c = 0; c < CH; ++c) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        o[c][4 * j] *= a0;
        o[c][4 * j + 1] *= a0;
        o[c][4 * j + 2] *= a1;
        o[c][4 * j + 3] *= a1;
      }
      fence_regs(o[c]);
    }
    const uint32_t v_addr = k_addr + L::kHalf;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < PK; ++kk)
#pragma unroll
      for (int c = 0; c < CH; ++c)
        wgmma_m64n64k16_rs_mn(o[c], pa[kk], sw128_desc(v_addr + c * (kTileKeys * 128) + kk * 16 * 128));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int c = 0; c < CH; ++c) fence_regs(o[c]);
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // Rows with no attendable key (l == 0) write 0, not NaN.
#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = r0 + 8 * half;
    const int t = t0 + r / G;
    if (r >= rows || t >= T) continue;
    const float l = half ? l1 : l0;
    const float inv = l > 0.f ? 1.f / l : 0.f;
    QT* orow = out + (((size_t)b * T + t) * H + kvh * G + r % G) * HD;
#pragma unroll
    for (int c = 0; c < CH; ++c)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int d = c * 64 + 8 * j + 2 * t4;
        orow[d] = from_f32<QT>(o[c][4 * j + 2 * half] * inv);
        orow[d + 1] = from_f32<QT>(o[c][4 * j + 2 * half + 1] * inv);
      }
  }
}

// Raises a kernel's dynamic shared-memory limit once to the largest size
// asked for, so a launch captured into a CUDA graph after a warm-up call
// makes no attribute call.
template <typename K>
cudaError_t allow_smem(K kern, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

template <typename CT, typename QT, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables, const int* positions,
                   void* out, int B, int T, int H, int n_kv, int ps, int N, int P, float scale, cudaStream_t stream) {
  const int G = H / n_kv;
  if constexpr (!std::is_same<CT, float>::value) {
    constexpr bool F8 = std::is_same<CT, __nv_fp8_e4m3>::value;
    static size_t allowed = 48 * 1024;
    const size_t smem = WgSmem<HD, F8>::bytes(N);
    auto kern = prefill_wgmma_kernel<QT, HD, F8>;
    // K/V tiles by TMA where the page size allows a box (bf16: 8 rows into
    // the swizzle; fp8: rows landing 128-byte aligned), else cp.async. A
    // tensor map the driver refuses is an error, never a silent switch to
    // the cp.async path.
    CUtensorMap tmk{}, tmv{};
    const int box_rows = F8 ? tma_box_rows_fp8(ps, kTileKeys, HD) : tma_box_rows(ps, kTileKeys);
    const long long rows = (long long)P * ps;
    if (box_rows && !(encode_map(&tmk, k, rows, n_kv * HD, F8, F8 ? HD : 64, box_rows) &&
                      encode_map(&tmv, v, rows, n_kv * HD, F8, F8 ? HD : 64, box_rows)))
      return cudaErrorNotSupported;
    const cudaError_t e = allow_smem(kern, smem, allowed);
    if (e != cudaSuccess) return e;
    const int tq = kBlockRows / G;
    kern<<<dim3(n_kv, (T + tq - 1) / tq, B), F8 ? kWgThreadsF8 : kWgThreads, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const unsigned char*>(k), static_cast<const unsigned char*>(v),
        tables, positions, static_cast<QT*>(out), T, H, n_kv, ps, N, scale, tmk, tmv, box_rows);
    return cudaGetLastError();
  } else {
    static size_t allowed = 48 * 1024;
    const size_t smem = PrefillSmem<CT, HD>::bytes();
    auto kern = prefill_kernel<CT, QT, HD>;
    const cudaError_t e = allow_smem(kern, smem, allowed);
    if (e != cudaSuccess) return e;
    const int tq = kRows / G;
    kern<<<dim3((T + tq - 1) / tq, n_kv, B), kThreads, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const CT*>(k), static_cast<const CT*>(v), tables, positions,
        static_cast<QT*>(out), T, H, n_kv, ps, N, scale);
    return cudaGetLastError();
  }
}

}  // namespace

// Launches the prefill kernel on `stream`; returns the cudaGetLastError()
// code (0 = launched). No synchronisation, no allocation.
extern "C" int dyn_paged_prefill(const void* q, const void* k, const void* v, const int* tables,
                                 const int* positions, void* out, int B, int T, int H, int n_kv,
                                 int head_dim, int ps, int N, int P, int cache_dtype, int q_dtype, float scale,
                                 void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define DYN_PREFILL_CASE(CC, QC, HDV, CT, QT)                                                         \
  if (cache_dtype == CC && q_dtype == QC && head_dim == HDV)                                          \
    return (int)launch<CT, QT, HDV>(q, k, v, tables, positions, out, B, T, H, n_kv, ps, N, P, scale, st);
  DYN_PREFILL_CASE(1, 1, 64, __nv_bfloat16, __nv_bfloat16)
  DYN_PREFILL_CASE(1, 1, 128, __nv_bfloat16, __nv_bfloat16)
  DYN_PREFILL_CASE(1, 0, 64, __nv_bfloat16, float)
  DYN_PREFILL_CASE(1, 0, 128, __nv_bfloat16, float)
  DYN_PREFILL_CASE(0, 0, 64, float, float)
  DYN_PREFILL_CASE(0, 0, 128, float, float)
  DYN_PREFILL_CASE(0, 1, 64, float, __nv_bfloat16)
  DYN_PREFILL_CASE(0, 1, 128, float, __nv_bfloat16)
  DYN_PREFILL_CASE(2, 1, 64, __nv_fp8_e4m3, __nv_bfloat16)
  DYN_PREFILL_CASE(2, 1, 128, __nv_fp8_e4m3, __nv_bfloat16)
  DYN_PREFILL_CASE(2, 0, 64, __nv_fp8_e4m3, float)
  DYN_PREFILL_CASE(2, 0, 128, __nv_fp8_e4m3, float)
#undef DYN_PREFILL_CASE
  return (int)cudaErrorInvalidValue;
}
