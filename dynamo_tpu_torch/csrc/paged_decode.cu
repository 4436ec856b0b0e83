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
// Contracts of both kernels:
// - A block's query rows (GQA group x query tokens, t-major) read only their
//   KV head's head_dim-wide strip at offset kv*head_dim of each page's
//   [page_size, W] slab (the TPU kernel's block-diagonal eye(n_kv) staging,
//   which spends n_kv times the flops, is gone).
// - Split-K over the sequence (Flash-Decoding): the split count is chosen
//   from static shapes only (batch bucket, KV heads, table width — never
//   runtime lengths or T_q), so a row's float reduction order never depends
//   on T_q or on the other rows: a T_q=1 decode is bit-identical to the same
//   column inside a T_q=K+1 verify row.
// - Softmax is online in f32 with p masked explicitly (an all-masked tile
//   would otherwise give exp(s - m) = 1). Empty splits write (m=NEG_INF,
//   l=0, acc=0), which the merge turns into exactly 0. With one split a
//   block writes acc / l itself, bit-identical to a one-split merge
//   (alpha = exp(0) = 1); with more, the splits of a (sequence, KV head,
//   row tile) form a thread block cluster and rank 0 merges their partials
//   from distributed shared memory (cluster_merge): one launch, no global
//   scratch. At most 8 splits, a cluster's portable size.
// - Page lookups clamp to the row's last used page (and the table width), so
//   a -1 sentinel in a table tail is never read.
//
// bf16 caches (the serving path): decode_mma_kernel, built around bytes in
// flight.
// - One block per (split, KV head x 16-row tile, sequence): the query rows
//   are cut into m16 row tiles in the grid, held as mma.sync A fragments in
//   registers for the whole walk, so neither registers nor shared memory
//   grow with T_q. Any T_q whose row tiles fit the grid's y extent
//   (n_kv * ceil(T_q * G / 16) <= 65535) is taken: a mixed speculative
//   step of the chunk width (2048 tokens) runs here. A row tile walks keys
//   up to its own rows' farthest position, not the sequence's.
// - Each of the 4 warps owns a fixed 16-key slice of every 64-key tile and
//   streams it itself: a kStages-deep ring per warp of TMA boxes (cp.async
//   where the page size allows no 8-row box), from page ids staged in
//   shared memory once per block, each slot completing its own mbarrier (no
//   block barrier inside the walk).
// - Scores and p.V are mma.sync m16n8k16 (K by ldmatrix, V by
//   ldmatrix.trans, both from a 128-byte-swizzled layout); p enters p.V as a
//   bf16 A fragment, rounded as the TPU kernel rounds it (pallas_paged.py:388).
//   Each warp keeps its own online-softmax state and accumulators in
//   registers; the four states merge once at the end in a fixed order.
// - Every row's arithmetic (its key partition, shuffle trees, merge order)
//   depends on static shapes only, which is what carries the bit-identities.
// What bounds it at batch 8 x 2048 tokens (PERF.md): the walk's stream, then
// start-up and the merge; of the knobs tried, only the split count
// (ops/paged_decode.py decode_split_plan) moved it.
// fp8 e4m3 caches (pallas_paged.py:368, the cache read at 1 byte an element,
// the matmuls in bf16): decode_mma_kernel<F8 = true>, the same row tiles,
// 16-key warp slices and products, with every e4m3 -> bf16 conversion
// (fp8x8_to_bf16x8, exact) taken off the warp's serial chain. The queries
// and p stay bf16, as the TPU kernel keeps them (pallas_paged.py:485-487,
// :388).
// - K: no bf16 copy. The score product's B fragments come straight from
//   the landed fp8 rows, converted in registers: lane (g, t4) reads the 16
//   bytes at dims 16*t4 (+64) of key g's row and feeds four k-steps with
//   them, so the head dimension is summed in a fixed permuted order that
//   the query fragments read with (qa below; the same for every row and
//   every T_q). At hd 128 lanes of odd g read their two 64-byte halves in
//   the other order, so each quarter-warp reads 128 distinct banks.
// - V: ldmatrix.trans does V's transpose, which fp8 bytes cannot do, so
//   each warp converts its V slice one tile ahead into one of two bf16
//   slices of its own, between the score product and the softmax, and the
//   p.V product reads the slice converted the tile before.
// - More warps on an SM: a block runs kGroupsF8 groups of 4 warps, group k
//   walking tiles k, k + kGroupsF8, ... of the split (each warp its own
//   ring slot and mbarrier per stage, as in the bf16 form), and merges the
//   groups' warps in shared memory in a fixed order, over its own ring
//   depth (kStagesF8 at hd 64, 3 at hd 128). The split plan stays the bf16 form's, one block a
//   row tile per SM: more splits (more blocks and clusters) measured slower
//   (PERF.md §6).
// f32 caches, which exist to check the algorithm without bf16 rounding, run
// a scalar-FMA kernel (decode_partials) whose rows all share one block.

#include <type_traits>

#include <cooperative_groups.h>

#include "hopper.cuh"

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

// Log-sum-exp merge of the split partials (pallas_paged.py:_lse_combine).
// The S splits of a (sequence, KV head, row tile) run as one thread block
// cluster; each leaves its partial (m [rows], l [rows], acc [rows][HD], f32)
// in its own shared memory, and cluster rank 0 reads them all through
// distributed shared memory and writes the output (rows [r0, r0 + nrows) of
// KV head kvh). Fixed split order, the same arithmetic for every row. Every
// rank returns only after rank 0 has read its partial.
template <typename QT, int HD>
__device__ void cluster_merge(const float* m, const float* l, const float* acc, QT* __restrict__ out, int b, int T,
                              int H, int G, int kvh, int r0, int nrows) {
  namespace cg = cooperative_groups;
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks();
  cluster.sync();  // every split's partial is in its shared memory
  if (cluster.block_rank() == 0) {
    for (int e = threadIdx.x; e < nrows * HD; e += blockDim.x) {
      const int rr = e / HD, d = e - rr * HD, r = r0 + rr;
      float mm = kNegInf;
      for (int s = 0; s < S; ++s) mm = fmaxf(mm, cluster.map_shared_rank(m, s)[rr]);
      float den = 0.f, num = 0.f;
      for (int s = 0; s < S; ++s) {
        const float a = expf(cluster.map_shared_rank(m, s)[rr] - mm);
        den += a * cluster.map_shared_rank(l, s)[rr];
        num += a * cluster.map_shared_rank(acc, s)[rr * HD + d];
      }
      out[(((size_t)b * T + r / G) * H + kvh * G + r % G) * HD + d] = from_f32<QT>(num / den);
    }
  }
  cluster.sync();  // rank 0 is done reading the other ranks' shared memory
}

template <typename CT, typename QT, int HD>
__global__ void __launch_bounds__(kThreads) decode_partials(
    const QT* __restrict__ q,         // [B, T, H, HD]
    const CT* __restrict__ kc,        // [P, ps, W]
    const CT* __restrict__ vc,        // [P, ps, W]
    const int* __restrict__ tables,   // [B, N]
    const int* __restrict__ positions,// [B, T]
    QT* __restrict__ out,             // [B, T, H, HD]
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
  if (S == 1) {
    for (int i = tid; i < R * HD; i += kThreads) {
      const int r = i / HD, d = i - r * HD, t = r / G, g = r - t * G;
      out[(((size_t)b * T + t) * H + kvh * G + g) * HD + d] = from_f32<QT>(accs[i] / l_s[r]);
    }
    return;
  }
  cluster_merge<QT, HD>(m_s, l_s, accs, out, b, T, H, G, kvh, 0, R);
}

// ---------------------------------------------------------------------------
// bf16 caches on the tensor cores, see the note at the top.

constexpr int kStages = 4;     // ring depth (ops/paged_decode.py STAGES)
constexpr int kStagesF8 = 4;   // fp8 ring depth at hd 64 (ops/paged_decode.py _fp8_stages)
constexpr int kGroupsF8 = 2;   // fp8: warp groups a block (ops/paged_decode.py GROUPS_FP8)
constexpr int kRowTile = 16;   // query rows per block (ops/paged_decode.py ROW_TILE)
constexpr int kWarpKeys = kBlockTokens / kWarps;  // 16 keys of each tile per warp of a group
static_assert(kWarpKeys == 16, "a warp's slice is one 16-deep k-step of p.V");

// Shared memory, from a 1024-aligned base: the ring (NS x WG groups x [K |
// V] x [warp][HD/64 atoms][16 keys][64], 128-byte swizzled as TMA writes it;
// fp8: NS x WG x [K | V] x [warp][16 keys][HD] bytes, then each warp's two
// bf16 V slices, [NW][2][HD/64 atoms][16 keys][64] swizzled), the 16
// staged query rows (padded), one mbarrier per (stage, warp), the rows'
// positions, then the page ids of the split's walk. The ring is reused for
// the warps' final states. ops/paged_decode.py _smem_bytes mirrors bytes().
template <int HD, bool F8>
struct MmaSmem {
  // fp8 at hd 128: 3 stages, the bytes of the earlier 8-deep layout (one
  // group, one converted stage), so the page ids of every table width it
  // took still fit.
  static constexpr int NS = F8 ? (HD == 64 ? kStagesF8 : 3) : kStages;
  static constexpr int WG = F8 ? kGroupsF8 : 1;  // warp groups: group k walks tiles k, k + WG, ...
  static constexpr int NW = kWarps * WG;          // warps of the block
  static constexpr int kElem = F8 ? 1 : 2;                     // bytes of a cache element
  static constexpr int kStageElems = 2 * kBlockTokens * HD;    // one group's K and V of a tile
  static constexpr int kSliceBytes = 2 * kWarpKeys * HD * kElem;  // one warp's K and V of a tile
  static constexpr int kQStride = HD + 8;
  static constexpr size_t kRingBytes = (size_t)kElem * NS * WG * kStageElems;
  static constexpr size_t kVBytes = F8 ? sizeof(__nv_bfloat16) * NW * 2 * kWarpKeys * HD : 0;
  static constexpr size_t kQBytes = sizeof(__nv_bfloat16) * kRowTile * kQStride;
  static constexpr size_t kBarBytes = sizeof(uint64_t) * NS * NW;
  static size_t bytes(int npages) {
    return 1024 + kRingBytes + kVBytes + kQBytes + kBarBytes + sizeof(int) * (size_t)(kRowTile + npages);
  }
  static_assert(sizeof(float) * (NW + 1) * kRowTile * (HD + 2) <= kRingBytes, "the merges reuse the ring");
};

// Element offset of 16-byte chunk c of key j inside a warp's [atoms][16][64] slice.
__device__ __forceinline__ int slice_off(int c, int j) { return (c >> 3) * (kWarpKeys * 64) + j * 64 + ((c ^ j) & 7) * 8; }

// Page ids a split of bps 64-key tiles can touch.
__host__ __device__ inline int split_pages(int bps, int ps) { return (bps * kBlockTokens + ps - 1) / ps + 1; }

template <typename QT, int HD, bool F8>
__global__ void __launch_bounds__(32 * MmaSmem<HD, F8>::NW) decode_mma_kernel(
    const QT* __restrict__ q, const unsigned char* __restrict__ kc, const unsigned char* __restrict__ vc,
    const int* __restrict__ tables, const int* __restrict__ positions, QT* __restrict__ out,
    int T, int H, int n_kv, int ps, int N, int S, int bps, int RT, float scale,
    const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv, int box_rows) {
  using L = MmaSmem<HD, F8>;
  constexpr int NS = L::NS, WG = L::WG, NW = L::NW, NTH = 32 * NW;
  constexpr int CPR = HD / 8;  // 8-element chunks per row
  constexpr int KSTEPS = HD / 16;
  constexpr int NT = HD / 8;  // n8 tiles of the output
  const int G = H / n_kv, R = T * G, W = n_kv * HD;
  const int sp = blockIdx.x, kvh = blockIdx.y / RT, rt = blockIdx.y - kvh * RT, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // This warp's 16 keys of each of its group's tiles (one group: constants).
  const int slice = WG == 1 ? warp : warp % kWarps, grp = WG == 1 ? 0 : warp / kWarps;
  const int g = lane >> 2, t4 = lane & 3;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  unsigned char* ring = base;  // L::kElem bytes an element
  __nv_bfloat16* vconv = reinterpret_cast<__nv_bfloat16*>(base + L::kRingBytes);  // fp8: the V slices
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(base + L::kRingBytes + L::kVBytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kRingBytes + L::kVBytes + L::kQBytes);  // [stage][warp]
  int* qpos = reinterpret_cast<int*>(full + NS * NW);
  int* pids = qpos + kRowTile;
  if (tid == 32 && box_rows) {
    tma_prefetch_map(&tmk);
    tma_prefetch_map(&tmv);
  }
  if (tid == 0) {
    // TMA: the warp's one expect_tx arrival; cp.async: its 32 lanes, each
    // once its copies land.
    for (int i = 0; i < NS * NW; ++i) mbar_init(&full[i], box_rows ? 1 : 32);
    mbar_init_fence();
  }

  // The split's page ids, staged with one coalesced load while the
  // positions arrive: every entry the split's span can touch, clamped only to
  // the table width (an entry past the row's last page is staged, never used).
  const int first = sp * bps;
  const int p0 = min(first * kBlockTokens / ps, N - 1);
  const int np = min(split_pages(bps, ps), N - p0);
  const int* trow = tables + (size_t)b * N;
  for (int j = tid; j < np; j += NTH) pids[j] = trow[p0 + j];
  // Walk length: the farthest query token among this row tile's rows (max,
  // not last: padding columns carry position 0). Every key past it is
  // masked for all of the tile's rows, and a tile walked only to be masked
  // leaves each state as it was (scores kNegInf, p 0, alpha exp(0)), so
  // stopping there changes no result: it skips the causal blocks that a
  // long query span's early rows never reach.
  const int* prow = positions + (size_t)b * T;
  int mx = 0;
  const int t_hi = min(T - 1, (rt * kRowTile + kRowTile - 1) / G);  // the tile's query tokens
  for (int t = rt * kRowTile / G; t <= t_hi; ++t) mx = max(mx, prow[t]);
  const int length = mx + 1;
  const int nb_total = (length + kBlockTokens - 1) / kBlockTokens;
  const int nb = min(max(nb_total - first, 0), bps);
  const int nbl = nb > grp ? (nb - grp + WG - 1) / WG : 0;  // this warp group's tiles grp, grp + WG, ...
  const int last_page = min((length - 1) / ps, N - 1);
  // Queries pre-scaled in f32, then rounded to bf16 (the TPU kernel's
  // staging, pallas_paged.py:483-491); rows past R are zero.
  for (int e = tid; e < kRowTile * CPR; e += NTH) {
    const int rr = e / CPR, c = e - rr * CPR, r = rt * kRowTile + rr;
    uint4 u = make_uint4(0u, 0u, 0u, 0u);
    if (r < R) {
      float f[8];
      load8(q + (((size_t)b * T + r / G) * H + kvh * G + r % G) * HD + c * 8, f);
      u = make_uint4(pack_bf16(f[0] * scale, f[1] * scale), pack_bf16(f[2] * scale, f[3] * scale),
                     pack_bf16(f[4] * scale, f[5] * scale), pack_bf16(f[6] * scale, f[7] * scale));
    }
    *reinterpret_cast<uint4*>(qs + rr * L::kQStride + c * 8) = u;
  }
  if (tid < kRowTile) {
    const int r = rt * kRowTile + tid;
    qpos[tid] = r < R ? prow[r / G] : -1;  // a row past R attends to nothing
  }
  __syncthreads();

  // This warp's 16-key slice of its group's li-th tile (tile grp + WG * li)
  // into ring slot li % NS, completing the slot's mbarrier of this warp.
  // TMA: lane l loads box l (bf16: 16 /
  // box_rows boxes of box_rows keys per 64-column atom; fp8: 16 / box_rows
  // boxes of whole HD-byte rows), K and V. cp.async: lane l copies 16-byte
  // chunk l % C16 of keys l / C16, + 32 / C16, ... (C16 chunks a row).
  constexpr int C16 = HD * L::kElem / 16;
  constexpr int KPI = 32 / C16;
  const PageWalk pw(ps, last_page, p0);
  const int cc = lane % C16;
  const size_t col = ((size_t)kvh * HD) * L::kElem + cc * 16;  // bytes into a cache row
  const int nbox = box_rows ? (kWarpKeys / box_rows) * (F8 ? 1 : HD / 64) : 0;
  auto load_slice = [&](int li, auto pow2) {
    constexpr bool P2 = decltype(pow2)::value;
    unsigned char* ks =
        ring + (size_t)(((li % NS) * WG + grp) * L::kStageElems + slice * kWarpKeys * HD) * L::kElem;
    unsigned char* vs = ks + (size_t)kBlockTokens * HD * L::kElem;
    uint64_t* bar = &full[(li % NS) * NW + warp];
    const int kbase = (first + grp + WG * li) * kBlockTokens + slice * kWarpKeys;
    if (box_rows) {
      if (lane == 0) mbar_arrive_expect_tx(bar, L::kSliceBytes);
      __syncwarp();
      if (lane < nbox) {
        if constexpr (F8) {
          const int j = lane * box_rows;
          const int row = (int)pw.row<P2>(pids, kbase + j);
          tma_load_2d(ks + j * HD, &tmk, kvh * HD, row, bar);
          tma_load_2d(vs + j * HD, &tmv, kvh * HD, row, bar);
        } else {
          const int a = lane % (HD / 64), j = (lane / (HD / 64)) * box_rows;
          const int row = (int)pw.row<P2>(pids, kbase + j);
          const int dst = 2 * (a * (kWarpKeys * 64) + j * 64);
          tma_load_2d(ks + dst, &tmk, kvh * HD + a * 64, row, bar);
          tma_load_2d(vs + dst, &tmv, kvh * HD + a * 64, row, bar);
        }
      }
    } else {
#pragma unroll
      for (int j0 = 0; j0 < kWarpKeys; j0 += KPI) {
        const int j = j0 + lane / C16;
        const size_t off = pw.row<P2>(pids, kbase + j) * W * L::kElem + col;
        const int dst = F8 ? j * HD + cc * 16 : 2 * slice_off(cc, j);
        cp_async16(ks + dst, kc + off);
        cp_async16(vs + dst, vc + off);
      }
      mbar_arrive_cp_async(bar);
    }
  };
  auto issue = [&](int i) {
    if (pw.pow2) {
      load_slice(i, Bool<true>());
    } else {
      load_slice(i, Bool<false>());
    }
  };
  for (int li = 0; li < NS - 1 && li < nbl; ++li) issue(li);

  // Query A fragments of the score k-steps. bf16: k-step kk sums dims
  // 16kk..16kk+15 in the mma's order. fp8: lane t4's slots of k-step kk hold
  // dims c..c+3 of its 16-dim chunk t4 (+ 4 chunks past k-step 3), c =
  // 16 * (t4 + 4 * (kk / 4)) + 4 * (kk % 4): the order the K fragments below
  // take from one 16-byte read of a key row.
  uint32_t qa[KSTEPS][4];
#pragma unroll
  for (int kk = 0; kk < KSTEPS; ++kk) {
    const int c = F8 ? 16 * (t4 + 4 * (kk >> 2)) + 4 * (kk & 3) : kk * 16 + 2 * t4;
    constexpr int c2 = F8 ? 2 : 8;  // the second pair of each row's slots
    qa[kk][0] = ld32(qs + g * L::kQStride + c);
    qa[kk][1] = ld32(qs + (g + 8) * L::kQStride + c);
    qa[kk][2] = ld32(qs + g * L::kQStride + c + c2);
    qa[kk][3] = ld32(qs + (g + 8) * L::kQStride + c + c2);
  }
  const int qp0 = qpos[g], qp1 = qpos[g + 8];
  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  // ldmatrix row addresses of this lane inside a warp slice: K (plain) for
  // the score k-steps, V (.trans) for the p.V n-tile pairs.
  const int kkey = (lane >> 4) * 8 + (lane & 7), kcol = (lane >> 3) & 1;
  const int vkey = ((lane >> 3) & 1) * 8 + (lane & 7), vcol = lane >> 4;
  // fp8: this warp's two bf16 V slices, and the conversion of its li-th
  // landed V slice into slice li & 1 (8-byte reads, 16-byte swizzled
  // stores: no bank conflict either way).
  __nv_bfloat16* vb = vconv + warp * 2 * kWarpKeys * HD;
  auto convert_v = [&](int li) {
    const unsigned char* v8 =
        ring + (size_t)((li % NS) * WG + grp) * L::kStageElems + (kBlockTokens + slice * kWarpKeys) * HD;
    __nv_bfloat16* vd = vb + (li & 1) * kWarpKeys * HD;
#pragma unroll
    for (int e = lane; e < kWarpKeys * CPR; e += 32) {
      const int j = e / CPR, c = e - j * CPR;
      *reinterpret_cast<uint4*>(vd + slice_off(c, j)) =
          fp8x8_to_bf16x8(*reinterpret_cast<const uint2*>(v8 + j * HD + c * 8));
    }
  };
  if (F8 && nbl > 0) {
    mbar_wait(&full[warp], 0);
    convert_v(0);
  }

  for (int li = 0; li < nbl; ++li) {
    __syncwarp();  // every lane is done with the slot the next load overwrites (fp8: and the V slice)
    if (li + NS - 1 < nbl) issue(li + NS - 1);
    float sc[2][4];
#pragma unroll
    for (int n = 0; n < 2; ++n) sc[n][0] = sc[n][1] = sc[n][2] = sc[n][3] = 0.f;
    const __nv_bfloat16* vs;
    if constexpr (F8) {
      // Scores from the landed fp8 K rows (slot li landed before its V was
      // converted): per n-tile, lane (g, t4) reads 16 bytes of key 8n+g per
      // 64 dims and converts them into the B fragments of four k-steps.
      const unsigned char* k8 = ring + (size_t)((li % NS) * WG + grp) * L::kStageElems + slice * kWarpKeys * HD;
      const int odd = HD == 128 ? (g & 1) : 0;
#pragma unroll
      for (int n = 0; n < 2; ++n) {
        const unsigned char* kr = k8 + (8 * n + g) * HD + 16 * t4;
        uint4 raw[HD / 64];
#pragma unroll
        for (int h = 0; h < HD / 64; ++h) raw[h] = *reinterpret_cast<const uint4*>(kr + 64 * (h ^ odd));
        if (odd) {
          const uint4 t = raw[0];
          raw[0] = raw[HD / 64 - 1];
          raw[HD / 64 - 1] = t;
        }
#pragma unroll
        for (int h = 0; h < HD / 64; ++h) {
          const uint4 lo = fp8x8_to_bf16x8(make_uint2(raw[h].x, raw[h].y));
          const uint4 hi = fp8x8_to_bf16x8(make_uint2(raw[h].z, raw[h].w));
          mma_bf16(sc[n], qa[4 * h], lo.x, lo.y);
          mma_bf16(sc[n], qa[4 * h + 1], lo.z, lo.w);
          mma_bf16(sc[n], qa[4 * h + 2], hi.x, hi.y);
          mma_bf16(sc[n], qa[4 * h + 3], hi.z, hi.w);
        }
      }
      // The next tile's V, converted while the products run.
      if (li + 1 < nbl) {
        mbar_wait(&full[((li + 1) % NS) * NW + warp], ((li + 1) / NS) & 1);
        convert_v(li + 1);
      }
      vs = vb + (li & 1) * kWarpKeys * HD;
    } else {
      mbar_wait(&full[(li % NS) * NW + warp], (li / NS) & 1);
      const __nv_bfloat16* ks =
          reinterpret_cast<const __nv_bfloat16*>(ring) + (li % NS) * L::kStageElems + slice * kWarpKeys * HD;
      vs = ks + kBlockTokens * HD;
#pragma unroll
      for (int kk = 0; kk < KSTEPS; ++kk) {
        uint32_t kb[4];
        ldmatrix_x4(kb, ks + slice_off(2 * kk + kcol, kkey));
        mma_bf16(sc[0], qa[kk], kb[0], kb[1]);
        mma_bf16(sc[1], qa[kk], kb[2], kb[3]);
      }
    }
    // Mask, then the online softmax of rows g (elements 0, 1) and g+8 (2, 3).
    const int k0 = (first + grp + WG * li) * kBlockTokens + slice * kWarpKeys;
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * n + 2 * t4 + e;
        if (kpos > qp0) sc[n][e] = kNegInf;
        if (kpos > qp1) sc[n][2 + e] = kNegInf;
        mx0 = fmaxf(mx0, sc[n][e]);
        mx1 = fmaxf(mx1, sc[n][2 + e]);
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
    for (int n = 0; n < 2; ++n) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int kpos = k0 + 8 * n + 2 * t4 + e;
        sc[n][e] = kpos <= qp0 ? __expf(sc[n][e] - mn0) : 0.f;
        sc[n][2 + e] = kpos <= qp1 ? __expf(sc[n][2 + e] - mn1) : 0.f;
        sum0 += sc[n][e];
        sum1 += sc[n][2 + e];
      }
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      sum0 += __shfl_xor_sync(0xffffffffu, sum0, off);
      sum1 += __shfl_xor_sync(0xffffffffu, sum1, off);
    }
    const float a0 = __expf(m0 - mn0), a1 = __expf(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 = a0 * l0 + sum0;
    l1 = a1 * l1 + sum1;
    const uint32_t pa[4] = {pack_bf16(sc[0][0], sc[0][1]), pack_bf16(sc[0][2], sc[0][3]),
                            pack_bf16(sc[1][0], sc[1][1]), pack_bf16(sc[1][2], sc[1][3])};
#pragma unroll
    for (int n = 0; n < NT; n += 2) {
      uint32_t vb[4];
      ldmatrix_x4_trans(vb, vs + slice_off(n + vcol, vkey));
      o[n][0] *= a0;
      o[n][1] *= a0;
      o[n][2] *= a1;
      o[n][3] *= a1;
      o[n + 1][0] *= a0;
      o[n + 1][1] *= a0;
      o[n + 1][2] *= a1;
      o[n + 1][3] *= a1;
      mma_bf16(o[n], pa, vb[0], vb[1]);
      mma_bf16(o[n + 1], pa, vb[2], vb[3]);
    }
  }
  __syncthreads();  // every warp is done with the ring (all its loads were waited for): it now holds the warps' states

  // Merge the NW warps' states in a fixed order: ms/ls [warp][16], os
  // [warp][16][HD]; with S > 1 into the block's partial bm/bl [16], bo
  // [16][HD] for the cluster merge.
  float* ms = reinterpret_cast<float*>(base);
  float* ls = ms + NW * kRowTile;
  float* os = ls + NW * kRowTile;
  float* bm = os + NW * kRowTile * HD;
  float* bl = bm + kRowTile;
  float* bo = bl + kRowTile;
  if (t4 == 0) {
    ms[warp * kRowTile + g] = m0;
    ms[warp * kRowTile + g + 8] = m1;
    ls[warp * kRowTile + g] = l0;
    ls[warp * kRowTile + g + 8] = l1;
  }
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float* o_r = os + (warp * kRowTile + g) * HD + 8 * n + 2 * t4;
    o_r[0] = o[n][0];
    o_r[1] = o[n][1];
    o_r[8 * HD] = o[n][2];
    o_r[8 * HD + 1] = o[n][3];
  }
  __syncthreads();
  const int nrows = min(kRowTile, R - rt * kRowTile);
  for (int e = tid; e < kRowTile * HD; e += NTH) {
    const int rr = e / HD, d = e - rr * HD, r = rt * kRowTile + rr;
    if (rr >= nrows) break;
    float mm = kNegInf;
#pragma unroll
    for (int w = 0; w < NW; ++w) mm = fmaxf(mm, ms[w * kRowTile + rr]);
    float den = 0.f, num = 0.f;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const float a = expf(ms[w * kRowTile + rr] - mm);
      den += a * ls[w * kRowTile + rr];
      num += a * os[(w * kRowTile + rr) * HD + d];
    }
    if (S == 1) {
      out[(((size_t)b * T + r / G) * H + kvh * G + r % G) * HD + d] = from_f32<QT>(num / den);
    } else {
      bo[rr * HD + d] = num;
      if (d == 0) {
        bm[rr] = mm;
        bl[rr] = den;
      }
    }
  }
  if (S > 1) cluster_merge<QT, HD>(bm, bl, bo, out, b, T, H, G, kvh, rt * kRowTile, nrows);
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
cudaError_t launch(const void* q, const void* k, const void* v, const int* tables, const int* positions, void* out,
                   int B, int T, int H, int n_kv, int ps, int N, int P, int S, int bps, float scale,
                   cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  // The S splits of a row tile are one cluster (x is the split index).
  cudaLaunchAttribute cluster{};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  if constexpr (!std::is_same<CT, float>::value) {
    constexpr bool F8 = std::is_same<CT, __nv_fp8_e4m3>::value;
    const int rt = (T * (H / n_kv) + kRowTile - 1) / kRowTile;
    cfg.gridDim = dim3(S, n_kv * rt, B);
    cfg.blockDim = dim3(32 * MmaSmem<HD, F8>::NW);
    cfg.dynamicSmemBytes = MmaSmem<HD, F8>::bytes(split_pages(bps, ps));
    auto kern = decode_mma_kernel<QT, HD, F8>;
    cudaError_t e = allow_smem(kern, cfg.dynamicSmemBytes, allowed);
    if (e != cudaSuccess) return e;
    // K/V slices by TMA where the page size allows a box (bf16: 8 rows into
    // the swizzle; fp8: rows landing 128-byte aligned), else cp.async. A
    // tensor map the driver refuses is an error, never a silent switch to
    // the cp.async path.
    CUtensorMap tmk{}, tmv{};
    const int box_rows = F8 ? tma_box_rows_fp8(ps, kWarpKeys, HD) : tma_box_rows(ps, kWarpKeys);
    const long long rows = (long long)P * ps;
    if (box_rows && !(encode_map(&tmk, k, rows, n_kv * HD, F8, F8 ? HD : 64, box_rows) &&
                      encode_map(&tmv, v, rows, n_kv * HD, F8, F8 ? HD : 64, box_rows)))
      return cudaErrorNotSupported;
    e = cudaLaunchKernelEx(&cfg, kern, static_cast<const QT*>(q), static_cast<const unsigned char*>(k),
                           static_cast<const unsigned char*>(v), tables, positions, static_cast<QT*>(out), T, H,
                           n_kv, ps, N, S, bps, rt, scale, tmk, tmv, box_rows);
    if (e != cudaSuccess) return e;
  } else {
    cfg.gridDim = dim3(S, n_kv, B);
    cfg.blockDim = dim3(kThreads);
    cfg.dynamicSmemBytes = DecodeSmem<CT, HD>::bytes(T * (H / n_kv), T);
    auto kern = decode_partials<CT, QT, HD>;
    cudaError_t e = allow_smem(kern, cfg.dynamicSmemBytes, allowed);
    if (e != cudaSuccess) return e;
    e = cudaLaunchKernelEx(&cfg, kern, static_cast<const QT*>(q), static_cast<const CT*>(k),
                           static_cast<const CT*>(v), tables, positions, static_cast<QT*>(out), T, H, n_kv, ps, N,
                           S, bps, scale);
    if (e != cudaSuccess) return e;
  }
  return cudaGetLastError();
}

}  // namespace

// Launches the decode kernel on `stream` (one launch: the S <= 8 splits of
// a row tile form a thread block cluster that merges them); returns the
// CUDA error code (0 = launched). No synchronisation, no allocation.
extern "C" int dyn_paged_decode(const void* q, const void* k, const void* v, const int* tables,
                                const int* positions, void* out, int B, int T, int H, int n_kv, int head_dim, int ps,
                                int N, int P, int S, int bps, int cache_dtype, int q_dtype, float scale,
                                void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > 8) return (int)cudaErrorInvalidValue;
#define DYN_DECODE_CASE(CC, QC, HDV, CT, QT)                                                            \
  if (cache_dtype == CC && q_dtype == QC && head_dim == HDV)                                            \
    return (int)launch<CT, QT, HDV>(q, k, v, tables, positions, out, B, T, H, n_kv, ps, N, P, S, bps, scale, st);
  DYN_DECODE_CASE(1, 1, 64, __nv_bfloat16, __nv_bfloat16)
  DYN_DECODE_CASE(1, 1, 128, __nv_bfloat16, __nv_bfloat16)
  DYN_DECODE_CASE(1, 0, 64, __nv_bfloat16, float)
  DYN_DECODE_CASE(1, 0, 128, __nv_bfloat16, float)
  DYN_DECODE_CASE(0, 0, 64, float, float)
  DYN_DECODE_CASE(0, 0, 128, float, float)
  DYN_DECODE_CASE(0, 1, 64, float, __nv_bfloat16)
  DYN_DECODE_CASE(0, 1, 128, float, __nv_bfloat16)
  DYN_DECODE_CASE(2, 1, 64, __nv_fp8_e4m3, __nv_bfloat16)
  DYN_DECODE_CASE(2, 1, 128, __nv_fp8_e4m3, __nv_bfloat16)
  DYN_DECODE_CASE(2, 0, 64, __nv_fp8_e4m3, float)
  DYN_DECODE_CASE(2, 0, 128, __nv_fp8_e4m3, float)
#undef DYN_DECODE_CASE
  return (int)cudaErrorInvalidValue;
}
