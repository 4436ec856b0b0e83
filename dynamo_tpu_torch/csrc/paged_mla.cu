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
// Bound. Decode reads each sequence's latent history once ((D + DR) * 2
// bytes a token) for all H heads: ~60 operations a byte at H = 32, far
// below the card's ~295, so decode is bound by bytes. A 512-token prefill
// chunk (and the serve's mixed step, which carries two of them) does H * T
// times the work over the same stream: bound by operations.
//
// Design of the bf16 kernel (mla_wgmma_kernel), what it does about both:
// - 64 query rows per block (row = t * H + h; a T = 1 decode at H = 32 is one
//   tile, a 512-token chunk 256), every sequence's longest tiles dispatched
//   first (plan_walk). Two consumer warpgroups and a producer warpgroup whose
//   warp 0 loads; setmaxnreg hands the producer's registers to the consumers
//   (the value product's accumulators alone are 128 a thread).
// - The producer keeps a two-stage ring of 64-key tiles full by TMA: a
//   latent page of ps rows arrives as D/64 boxes of ps x 64 columns plus one
//   box of the first 64 rope lanes, 128-byte swizzled, completing the
//   stage's mbarrier; the consumers release a stage through a second one.
//   Page ids come from the table once per box, clamped to the row's last
//   page, so a -1 table tail is never read. Page sizes that allow no 8-row
//   box (2 and 4) and rope streams narrower than a box copy with cp.async
//   into the same layout.
// - Scores on wgmma: each warpgroup computes all 64 rows against its half
//   of the tile's keys (m64n32k16, Q and K from shared memory, K-major, over
//   the (D + DR)-wide contraction, one 64-element atom per four k-steps).
//   Row maxima are exchanged through shared memory; each warpgroup writes its
//   half of p, rounded to bf16 as the TPU kernel rounds it
//   (pallas_mla.py:221), into a shared 64 x 64 tile.
// - Value product on wgmma: O[:, cols] = alpha * O + P . C[:, cols], the two
//   warpgroups splitting the D output columns (m64n256k16 at D = 512: 128
//   f32 accumulators a thread), A the shared p tile, B the latent lanes of
//   the same key tile read MN-major across four atoms (sw128_desc_mn).
// - The Q tile arrives by TMA too and is scaled in f32 and rounded to bf16
//   in place, as pallas_mla.py:273-276 does outside its kernel. exp2
//   softmax: log2(e) is folded into the f32 scores, never into the rounded
//   queries. Only key tiles that cross the tile's smallest query position
//   are masked.
// - The wrapper computes each sequence's walk facts once on the device
//   (its largest position and the first token holding it, as
//   pallas_mla.py:271 does outside its kernel): a tile wholly past the last
//   real token writes zeros and touches no cache, a tile's walk ends at its
//   own farthest query.
// - Split-K from static shapes only (ops/paged_mla.py mla_split_plan): the
//   splits of a row tile are one thread block cluster. Each block leaves its
//   partial (m, l, acc) in its own shared memory (the key ring is free by
//   then) and each rank merges its own slice of the D columns from every
//   rank's partial through distributed shared memory: no global partials,
//   no second launch.
// - Row arithmetic depends on static shapes only (fixed shuffle and merge
//   orders, key blocks past a row's horizon adding exactly 0: p = 0, alpha =
//   exp2(0) = 1), so a T_q = 1 decode equals the same column of a verify row
//   bit for bit.
// Wider rows (more than nine 64-lane atoms of latent + rope) stream 32-key
// stages instead, within the same 64-key split blocks.
// What bounds it on the card (PERF.md): per 64-key tile, the 36 small
// score wgmma of each warpgroup, then the value product, with the softmax
// between them (both warpgroups in step); at decode also the block's
// start-up and the merge.
// fp8 e4m3 caches (pallas_mla.py:200, latents and rope keys read at 1 byte
// an element, the matmuls in bf16): mla_wgmma_kernel<F8 = true>, the same
// consumers on the same layout and 64-key stages, queries and p in bf16 as
// the TPU kernel keeps them (pallas_mla.py:273-276, :221). No fp8 ring: the
// producer warpgroup's 128 threads land each 16-byte fp8 chunk by cp.async
// in the first of the two bf16 slots it converts into and convert it there
// (hopper.cuh f8_convert_in_place, exact), so the conversion needs no smem
// of its own, a tile's chunks are all in flight at once, and the 64-key
// bf16 stages keep the whole budget. A tile's fill (landing, conversion)
// overlaps the consumers' work on the tile before it. A sequence's row
// tiles (a prefill chunk, a mixed step's chunk rows) all walk one latent
// stream; with one split (S == 1) two adjacent ones form a share group, one
// cluster along z (ops/paged_mla.py mla_share_plan; groups of 4 and 8
// measured slower than none, PERF.md): each rank lands and converts
// 1/share of every key tile's rows and bulk-copies them into the rings of
// the other ranks with rows, completing the bytes on their full mbarriers;
// consumers release a stage to every rank's producer by remote arrivals.
// The group walks its longest walk; a rank computes only its own tiles, and
// a padding rank (a 1-token row's tiles past its token) only helps fill.
// f32 caches (mla_f32_kernel), kept to check the algorithm without bf16
// rounding: 32-row blocks on scalar FMA, 32-key sub-tiles, the same walk
// facts and cluster merge.

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kBlockTokens = 64;  // split granularity (ops/paged_mla.py BLOCK_TOKENS)
constexpr int kMaxSplits = 8;     // a cluster's portable size (ops/paged_decode.py MAX_SPLITS)
constexpr int kMaxShare = 2;      // row tiles of an fp8 share group (ops/paged_mla.py mla_share_plan)
constexpr size_t kMaxSmem = 232448;  // dynamic shared memory a block may use (ops/paged_decode.py SMEM_BYTES)
constexpr float kLog2e = 1.4426950408889634f;

struct MlaArgs {
  const void* q_lat;          // [B, T, H, D]
  const void* q_rope;         // [B, T, H, DR]
  const void* cc;             // [P, ps, D]
  const void* rc;             // [P, ps, RW]
  const int* tables;          // [B, N]
  const int* positions;       // [B, T]
  const int* walk_max;        // [B] the sequence's largest position (null at T = 1: its one position)
  const long long* walk_first;  // [B] the first token holding it, past it padding (null at T = 1)
  float* out;                 // [B, T, H, D]
  int T, H, DR, RW, ps, N, S, bps, q_f32;
  float scale;
  int share;  // fp8 caches, S == 1: the row tiles of a share group (a cluster along z, 1 or 2); 1 otherwise
};

// What one block walks: rows [r0, r0 + rows) of sequence b and keys
// [kbeg, kbeg + nkeys) of its split (whole 64-key blocks).
struct Walk {
  int b, r0, rows, tmin, tmax, kbeg, nkeys, last_page, sh;
  bool padding;  // wholly past the sequence's last real token
};

// The grid is (splits, sequences, row tiles): block z of every sequence is
// dispatched before block z + 1 of any, and z counts down from the tile
// holding the sequence's last real token (its longest walk) to tile 0, then
// up through the padding tiles past it. The long walks of every sequence of
// a mixed step start first, the padding blocks last. A share group rounds
// the row tiles up to whole groups: the tiles past the last row have no
// rows at all (padding that writes nothing).
template <int ROWS>
__device__ __forceinline__ Walk plan_walk(const MlaArgs& a, int z) {
  Walk w;
  const int b = blockIdx.y;
  w.b = b;
  const int R = a.T * a.H;
  const int last = a.walk_first != nullptr ? (((int)a.walk_first[b] + 1) * a.H - 1) / ROWS : (R - 1) / ROWS;
  const int tile = z <= last ? last - z : z;
  w.r0 = tile * ROWS;
  w.rows = max(min(ROWS, R - w.r0), 0);
  w.padding = tile > last;
  const int t_first = w.r0 / a.H, t_last = (w.r0 + w.rows - 1) / a.H;
  const int* prow = a.positions + (size_t)b * a.T;
  w.tmin = 0x7fffffff;
  w.tmax = 0;
  for (int t = t_first; t <= t_last; ++t) {
    const int p = prow[t];
    w.tmin = min(w.tmin, p);
    w.tmax = max(w.tmax, p);
  }
  const int first = blockIdx.x * a.bps;
  const int nb = min(max((w.tmax + kBlockTokens) / kBlockTokens - first, 0), a.bps);
  w.kbeg = first * kBlockTokens;
  w.nkeys = nb * kBlockTokens;
  w.sh = __ffs(a.ps) - 1;
  w.last_page = min((a.walk_max != nullptr ? a.walk_max[b] : prow[0]) >> w.sh, a.N - 1);
  return w;
}
template <int ROWS>
__device__ __forceinline__ Walk plan_walk(const MlaArgs& a) {
  return plan_walk<ROWS>(a, blockIdx.z);
}

// A padding tile's rows are zeros (written once, by split 0).
__device__ __forceinline__ void write_zeros(const MlaArgs& a, const Walk& w, int D) {
  if (blockIdx.x != 0) return;
  float4* o = reinterpret_cast<float4*>(a.out + ((size_t)w.b * a.T * a.H + w.r0) * D);
  for (int e = threadIdx.x; e < w.rows * D / 4; e += blockDim.x) o[e] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// Log-sum-exp merge of a row tile's S split partials (pallas_paged.py
// _lse_combine), the splits being the S blocks of one thread block cluster.
// Each block left its partial in its own shared memory: acc [ROWS][astride]
// f32, m [ROWS] (log2 units; kNegInf where no key was seen), l [ROWS]. Rank
// k merges columns [k * D / S, (k + 1) * D / S) of every row from all ranks'
// partials, each worker fetching a column chunk's acc, m and l from every
// rank at once (one round trip). Fixed split order, the same arithmetic for
// every row; a row no split attended gets 0. Every thread of every block
// calls it, or (threads with no share of the work) meets its two cluster
// barriers; each block returns only after every rank has read its partial.
template <int ROWS>
__device__ void cluster_merge(const float* acc, int astride, const float* m, const float* l,
                              float* __restrict__ out, int rows, int D, int worker, int nworkers) {
  constexpr int kItems = 2;  // column chunks a worker merges with all their remote loads in flight
  cg::cluster_group cluster = cg::this_cluster();
  const int S = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  cluster.sync();  // every split's partial is in its shared memory
  const int n4 = D / 4, lo = rank * n4 / S, nc = (rank + 1) * n4 / S - lo;
  for (int e0 = worker; e0 < rows * nc; e0 += kItems * nworkers) {
    float4 x[kItems][kMaxSplits];
    float ms[kItems][kMaxSplits], ls[kItems][kMaxSplits];
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int e = min(e0 + k * nworkers, rows * nc - 1);  // a past-the-end item repeats the last
      const int r = e / nc, c = 4 * (lo + e - r * nc);
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s >= S) break;
        x[k][s] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(acc, s) + r * astride + c);
        ms[k][s] = cluster.map_shared_rank(m, s)[r];
        ls[k][s] = cluster.map_shared_rank(l, s)[r];
      }
    }
#pragma unroll
    for (int k = 0; k < kItems; ++k) {
      const int e = e0 + k * nworkers;
      if (e >= rows * nc) break;
      const int r = e / nc, c = 4 * (lo + e - r * nc);
      float mm = kNegInf;
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s)
        if (s < S) mm = fmaxf(mm, ms[k][s]);
      float den = 0.f;
      float4 num = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int s = 0; s < kMaxSplits; ++s) {
        if (s >= S) break;
        const float wt = fast_exp2(ms[k][s] - mm);
        den += wt * ls[k][s];
        num.x += wt * x[k][s].x;
        num.y += wt * x[k][s].y;
        num.z += wt * x[k][s].z;
        num.w += wt * x[k][s].w;
      }
      *reinterpret_cast<float4*>(out + (size_t)r * D + c) =
          den > 0.f ? make_float4(num.x / den, num.y / den, num.z / den, num.w / den)
                    : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  cluster.sync();  // every rank is done reading this block's shared memory
}

// ---------------------------------------------------------------------------
// bf16 caches: wgmma, TMA, see the note at the top.

constexpr int kRows = 64;  // query rows per block (ops/paged_mla.py ROW_TILE)
constexpr int kConsumers = 2;
constexpr int kWgThreads = 128 * (kConsumers + 1);  // warpgroup 0: the producer (its warp 0 loads)
constexpr int kProducerRegs = 56;                     // registers a thread after setmaxnreg: producer
constexpr int kConsumerRegs = 224;                    // and consumers (128 x 56 + 256 x 224 = 384 x 168)
constexpr int kStages = 2;
constexpr int kBarConsumers = 1;  // named barriers over the two consumer warpgroups
constexpr int kBarMax = 2;        // both halves of a tile's row maxima are exchanged
constexpr int kBarP = 3;          // both halves of a tile's p are in the p tile
constexpr int kBarProducers = 4;  // fp8: the producer warpgroup has converted a tile
// fp8: registers a thread after setmaxnreg, producers and consumers (128 x 72 + 256 x 216 = 384 x 168;
// the in-place conversion's producer needs more than the bf16 loader's 56, the consumers no more than 216).
constexpr int kF8ProducerRegs = 72;
constexpr int kF8ConsumerRegs = 216;

// Shared-memory layout of mla_wgmma_kernel (bytes from a 1024-aligned base)
// for rows of `na` 64-lane atoms (D / 64 latent, then ceil(DR / 64) rope) and
// stages of `keys` keys: Q [na][64 rows][128 B], the ring kStages x [na][keys]
// [128 B], the p tile [64][128 B], the ring's mbarriers and the Q tile's, the
// row exchange [2][64] f32, the rows' positions, the block's (m, l)
// partial. fp8 caches use the same layout: their tiles are converted in
// place in the ring (f8_convert_in_place), with no fp8 ring beside it.
// ops/paged_mla.py _wg_smem_bytes mirrors bytes().
struct WgLayout {
  int na, keys;
  __host__ __device__ int stage_bytes() const { return na * keys * 128; }
  __host__ __device__ int ring() const { return na * kRows * 128; }
  __host__ __device__ int p() const { return ring() + kStages * stage_bytes(); }
  __host__ __device__ int bar() const { return p() + kRows * 128; }
  __host__ __device__ int red() const { return bar() + (2 * kStages + 1) * 8; }
  __host__ __device__ int qpos() const { return red() + 4 * 2 * kRows; }
  __host__ __device__ int ml() const { return qpos() + 4 * kRows; }
  __host__ __device__ size_t bytes() const { return 1024 + ml() + 4 * 2 * kRows; }
};

// Eight elements scaled in f32 and rounded to bf16, packed.
__device__ __forceinline__ uint4 scale_pack8(const float* f, float s) {
  return make_uint4(pack_bf16(f[0] * s, f[1] * s), pack_bf16(f[2] * s, f[3] * s), pack_bf16(f[4] * s, f[5] * s),
                    pack_bf16(f[6] * s, f[7] * s));
}

// The Q tile after its TMA boxes landed (bf16 queries): the elements of its
// first `rows` rows scaled in f32 and rounded to bf16 in place (the rest are
// masked rows).
__device__ __forceinline__ void scale_q_in_place(uint4* q, int atoms, int rows, float s, int tid, int nthreads) {
  for (int at = 0; at < atoms; ++at) {
    for (int c = tid; c < rows * 8; c += nthreads) {  // an atom's rows are contiguous 8-chunk runs
      uint4* qc = q + at * (kRows * 8) + c;
      float f[8];
      CacheVec<__nv_bfloat16>::unpack(*qc, f);
      *qc = scale_pack8(f, s);
    }
  }
}

// Otherwise (f32 queries, rope widths off the 64-lane boxes) the consumers
// stage the tile's query rows from registers: loads of kBatch 8-element
// chunks a thread in flight before any is stored, scaled in f32 and rounded
// to bf16 into the swizzled Q layout (rows past `rows` are zeros).
template <typename QT, int D>
__device__ __forceinline__ void stage_q_swizzled(const MlaArgs& a, const Walk& w, __nv_bfloat16* qs, int tid,
                                                 int nthreads) {
  constexpr int kBatch = 6;
  constexpr int NV = 8 / CacheVec<QT>::N;  // 16-byte vectors an 8-element chunk
  const int DR = a.DR, cpr = (D + DR) / 8, total = kRows * cpr;
  const size_t row0 = (size_t)w.b * a.T * a.H + w.r0;
  const QT* ql = static_cast<const QT*>(a.q_lat);
  const QT* qr = static_cast<const QT*>(a.q_rope);
  for (int base = tid; base < total; base += kBatch * nthreads) {
    uint4 u[kBatch][NV];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = base + k * nthreads, r = e / cpr, c = e - r * cpr;
      const QT* src = c < D / 8 ? ql + (row0 + r) * D + c * 8 : qr + (row0 + r) * DR + (c - D / 8) * 8;
#pragma unroll
      for (int v = 0; v < NV; ++v)
        u[k][v] = e < total && r < w.rows ? reinterpret_cast<const uint4*>(src)[v] : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int e = base + k * nthreads, r = e / cpr, c = e - r * cpr;
      if (e >= total) break;
      float f[8];
#pragma unroll
      for (int v = 0; v < NV; ++v) CacheVec<QT>::unpack(u[k][v], f + v * CacheVec<QT>::N);
      *reinterpret_cast<uint4*>(qs + (c >> 3) * (kRows * 64) + r * 64 + swz128(c & 7, r)) = scale_pack8(f, a.scale);
    }
  }
}

// RSTEPS: the rope lanes' k-steps (DR / 16), so the score product is one
// unrolled run of wgmma that ptxas pipelines; 0 takes any DR in a loop,
// which ptxas serialises (geometries outside the serving ones). F8: the
// caches are fp8 e4m3 (see the note at the top).
template <int D, int KEYS, int RSTEPS, bool F8>
__global__ void __launch_bounds__(kWgThreads, 1) mla_wgmma_kernel(const MlaArgs a,
                                                                  const __grid_constant__ CUtensorMap tmc,
                                                                  const __grid_constant__ CUtensorMap tmr,
                                                                  const __grid_constant__ CUtensorMap tmq,
                                                                  const __grid_constant__ CUtensorMap tmqr,
                                                                  int box_rows, int q_tma) {
  using bf16 = __nv_bfloat16;
  constexpr int DA = D / 64;   // latent atoms of a row
  constexpr int NO = D / 4;    // f32 accumulators a thread: m64n(D/2), a warpgroup's columns
  constexpr int NS = KEYS / 4; // score accumulators a thread: m64n(KEYS/2), a warpgroup's keys
  constexpr int AS = D + 8;    // row stride (floats) of the f32 partial left for the cluster merge
  static_assert(KEYS == 64 || KEYS == 32, "a warpgroup scores 32 or 16 keys of a stage");
  static_assert(D == 512 || D == 128, "the value product is m64n256 or m64n64 per warpgroup");
  // The merge's partial fits in the Q + ring space of the narrowest row.
  static_assert((size_t)(DA + 1) * 128 * (kRows + kStages * KEYS) >= sizeof(float) * (size_t)kRows * AS,
                "the merge's partial outgrows the Q tile and the ring");
  const int DR = a.DR, NA = DA + (DR + 63) / 64;
  const WgLayout L{NA, KEYS};
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(base);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bar());
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;
  float* red = reinterpret_cast<float*>(base + L.red());
  int* qpos = reinterpret_cast<int*>(base + L.qpos());
  float* m_s = reinterpret_cast<float*>(base + L.ml());
  float* l_s = m_s + kRows;

  const Walk w = plan_walk<kRows>(a);
  const int b = w.b;
  int ntiles = w.nkeys / KEYS;
  // fp8, a.share > 1: the share group, a.share row tiles of one sequence in
  // one cluster (a.S == 1, so every rank walks keys from 0). Each rank fills
  // its 1/share of every tile of the group's longest walk (NT tiles) into
  // the ring of every rank with rows (`consumers`); a rank walks only its own
  // ntiles of them and releases the rest. A padding rank of a group with
  // work helps fill. The ranks' walks come from the positions alone, so
  // every rank computes the same group plan.
  const bool shared = F8 && a.share > 1;
  int NT = ntiles;
  uint32_t consumers = 0, rank = 0;
  if (shared) {
    rank = cluster_rank();
    NT = 0;
    for (int k = 0; k < a.share; ++k) {
      const Walk wk = plan_walk<kRows>(a, blockIdx.z - rank + k);
      if (!wk.padding) {
        consumers |= 1u << k;
        NT = max(NT, wk.nkeys / KEYS);
      }
    }
  }
  if (w.padding) {
    write_zeros(a, w, D);
    if (!shared || NT == 0) return;
    ntiles = 0;
  }
  const int* trow = a.tables + (size_t)b * a.N;
  // The producer's copy of ring tile i: TMA boxes (lane l issues boxes l,
  // l + 32, ...: box e is atom e % NA of the box_rows keys at e / NA *
  // box_rows), or cp.async (lane l copies 16-byte chunks l, l + 32, ... of the
  // tile's keys, latent chunks then rope chunks, into the swizzled layout).
  auto load_tile = [&](int i) {
    const int s = i % kStages, k0 = w.kbeg + i * KEYS, pmask = a.ps - 1;
    unsigned char* st = base + L.ring() + s * L.stage_bytes();
    if (box_rows) {
      if (lane == 0) mbar_arrive_expect_tx(&full[s], L.stage_bytes());
      __syncwarp();
      const int nbox = (KEYS / box_rows) * NA;
      for (int e = lane; e < nbox; e += 32) {
        const int j = e / NA, at = e - j * NA;
        const int kpos = k0 + j * box_rows;
        const int row = trow[min(kpos >> w.sh, w.last_page)] * a.ps + (kpos & pmask);
        unsigned char* dst = st + at * (KEYS * 128) + j * box_rows * 128;
        if (at < DA) {
          tma_load_2d(dst, &tmc, at * 64, row, &full[s]);
        } else {
          tma_load_2d(dst, &tmr, (at - DA) * 64, row, &full[s]);
        }
      }
    } else {
      const bf16* cc = static_cast<const bf16*>(a.cc);
      const bf16* rc = static_cast<const bf16*>(a.rc);
      const int cl = D / 8, cpk = cl + DR / 8;
      for (int e = lane; e < KEYS * cpk; e += 32) {
        const int j = e / cpk, c = e - j * cpk, kpos = k0 + j;
        const size_t slot = (size_t)trow[min(kpos >> w.sh, w.last_page)] * a.ps + (kpos & pmask);
        cp_async16(reinterpret_cast<bf16*>(st) + (c >> 3) * (KEYS * 64) + j * 64 + swz128(c & 7, j),
                   c < cl ? cc + slot * D + c * 8 : rc + slot * a.RW + (c - cl) * 8);
      }
      mbar_arrive_cp_async(&full[s]);
    }
  };
  // fp8: this rank's share of tile i (key rows [key0, key0 + KEYS /
  // share) of the tile's KEYS x (D + DR) cache bytes, cpk 16-byte chunks a
  // row), producer thread tid's part. Chunk e is row chunk c of key row j:
  // e = ((j / 2) * cpk + c) * 2 + j % 2, so a quarter-warp lands and
  // converts four chunks of one atom in two adjacent rows, eight distinct
  // 16-byte bank groups. land_f8 starts the chunks' cp.async into their
  // slots (one commit group a tile; `page`: lane l holds the id of the
  // tile's page l, at most 32 with pages of 2+ tokens, passed by shuffle);
  // convert_f8 converts them in place once they have landed.
  constexpr int CPK = RSTEPS > 0 ? (D + 16 * RSTEPS) / 16 : 0;  // 16-byte chunks of a key row (serving rope)
  const int cpk = RSTEPS > 0 ? CPK : (D + DR) / 16;
  const int key0 = (int)rank * (KEYS / a.share), lo = key0 * cpk, hi = lo + (KEYS / a.share) * cpk;
  auto chunk_of = [&](int e, int& j, int& c) {
    const int t = e >> 1;
    const int jp = t / cpk;
    c = t - jp * cpk;
    j = 2 * jp + (e & 1);
  };
  auto land_f8 = [&](int i) {
    const int k0 = w.kbeg + i * KEYS, p0 = k0 >> w.sh, pmask = a.ps - 1;
    const int page = trow[min(p0 + lane, w.last_page)];
    unsigned char* st = base + L.ring() + (i % kStages) * L.stage_bytes();
    const unsigned char* cc = static_cast<const unsigned char*>(a.cc);
    const unsigned char* rc = static_cast<const unsigned char*>(a.rc);
    for (int e0 = lo; e0 < hi; e0 += 128) {
      int j, c;
      chunk_of(e0 + tid, j, c);
      const int kpos = k0 + j;
      const int pg = __shfl_sync(0xffffffffu, page, (kpos >> w.sh) - p0);
      if (e0 + tid < hi) {
        const size_t slot = (size_t)pg * a.ps + (kpos & pmask);
        cp_async16(st + (c >> 2) * (KEYS * 128) + j * 128 + (((2 * (c & 3)) ^ (j & 7)) << 4),
                   c < D / 16 ? cc + slot * D + c * 16 : rc + slot * a.RW + (c - D / 16) * 16);
      }
    }
    cp_async_commit();
  };
  auto convert_f8 = [&](int i) {
    const uint32_t st = smem_u32(base + L.ring() + (i % kStages) * L.stage_bytes());
    for (int e = lo + tid; e < hi; e += 128) {
      int j, c;
      chunk_of(e, j, c);
      f8_convert_in_place(st + (c >> 2) * (KEYS * 128) + j * 128, (2 * (c & 3)) ^ (j & 7));
    }
  };
  const F8Share group{consumers, rank, a.share};
  if (warp == 0) {
    // Warp 0 starts the Q tile and (bf16) the ring's first stage before the
    // block-wide barrier (the second would compete with Q for bandwidth).
    if (lane == 0) {
      for (int s = 0; s < kStages; ++s) {
        if constexpr (F8) {
          // The producer's one arrival once the tile is converted (a share
          // group: armed with the bytes the other ranks' bulk copies complete).
          mbar_init(&full[s], 1);
          mbar_init(&empty[s], 4 * kConsumers * (shared ? __popc(consumers) : 1));
        } else {
          // TMA: the producer's one expect_tx arrival; cp.async: its 32 lanes.
          mbar_init(&full[s], box_rows ? 1 : 32);
          mbar_init(&empty[s], 4 * kConsumers);  // one arrival per consumer warp
        }
      }
      mbar_init(qbar, 1);
      mbar_init_fence();
      if (box_rows) {
        tma_prefetch_map(&tmc);
        tma_prefetch_map(&tmr);
      }
      if (q_tma && ntiles > 0) {
        // The Q tile by TMA (bf16 queries): one 64-row box per atom, rows
        // past the tensor's end zero-filled; the consumers scale it in place.
        mbar_arrive_expect_tx(qbar, NA * kRows * 128);
        const int qrow = (int)((size_t)b * a.T * a.H + w.r0);
        for (int at = 0; at < NA; ++at) {
          if (at < DA) {
            tma_load_2d(qs + at * (kRows * 64), &tmq, at * 64, qrow, qbar);
          } else {
            tma_load_2d(qs + at * (kRows * 64), &tmqr, (at - DA) * 64, qrow, qbar);
          }
        }
      }
    }
    __syncwarp();
    if constexpr (!F8) {
      if (ntiles > 0) load_tile(0);
    }
  }
  if (tid < kRows) qpos[tid] = tid < w.rows ? a.positions[(size_t)b * a.T + (w.r0 + tid) / a.H] : -1;
  if (shared) {
    cluster_sync();  // every rank's barriers are initialised before any rank copies into it
  } else {
    __syncthreads();
  }
  const size_t row0 = (size_t)b * a.T * a.H + w.r0;
  float* accs = reinterpret_cast<float*>(base);  // S > 1: the split's partial, over Q and the ring

  if (warp < 4) {
    // ---- producer warpgroup: its warp 0 keeps the ring full (fp8: all four
    // warps land and convert it) ----
    setmaxnreg_dec<F8 ? kF8ProducerRegs : kProducerRegs>();
    if constexpr (F8) {
      // Land the first kStages tiles at once (every stage is free); then
      // for each tile: wait for its chunks, convert, publish, and land tile
      // i - 1 + kStages into the stage tile i - 1 leaves once every
      // consumer has released it (its fill overlaps their work on tile i).
      int landed = 0;
      for (; landed < kStages && landed < NT; ++landed) land_f8(landed);
      for (int i = 0; i < NT; ++i) {
        cp_async_wait_upto(landed - 1 - i);
        convert_f8(i);
        fence_proxy_async();  // the converted chunks are read by wgmma and the bulk copies (the async proxy)
        named_bar_sync(kBarProducers, 128);
        group.publish(smem_u32(base + L.ring() + (i % kStages) * L.stage_bytes()), &full[i % kStages], NA,
                      (KEYS / a.share) * 128, [&](int r) { return (uint32_t)(r * (KEYS * 128) + key0 * 128); },
                      tid);
        if (i >= 1 && landed < NT) {
          const int f = (i - 1) % kStages;
          if (shared) {
            mbar_wait_cluster(&empty[f], ((i - 1) / kStages) & 1);
          } else {
            mbar_wait(&empty[f], ((i - 1) / kStages) & 1);
          }
          land_f8(landed++);
        }
      }
    } else if (warp == 0) {
      for (int i = 1; i < ntiles; ++i) {
        if (i >= kStages) mbar_wait(&empty[i % kStages], ((i / kStages) - 1) & 1);
        load_tile(i);
      }
      if (!box_rows) cp_async_wait<0>();
    }
    if (shared) {
      cluster_sync();  // no rank leaves while another still stores into it or arrives on it
      return;
    }
    if (a.S == 1) return;
    cg::this_cluster().sync();  // the consumers' cluster_merge: its two cluster barriers
    cg::this_cluster().sync();
  } else {
    // ---- consumers: warpgroup wg scores keys [wg * KEYS/2, +KEYS/2) of each
    // tile against all 64 rows and owns output columns [wg * D/2, +D/2);
    // row maxima and p go through shared memory. ----
    if (shared && w.padding) {  // a helper of its share group: no rows
      cluster_sync();
      return;
    }
    setmaxnreg_inc<F8 ? kF8ConsumerRegs : kConsumerRegs>();
    const int wg = (warp >> 2) - 1, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
    const int ctid = tid - 128;
    const int ra = wl * 16 + g, rb = ra + 8;  // this thread's rows (the same in both warpgroups)
    if (ntiles > 0) {
      if (q_tma) {
        mbar_wait(qbar, 0);
        scale_q_in_place(reinterpret_cast<uint4*>(qs), NA, w.rows, a.scale, ctid, 128 * kConsumers);
      } else if (a.q_f32) {
        stage_q_swizzled<float, D>(a, w, qs, ctid, 128 * kConsumers);
      } else {
        stage_q_swizzled<bf16, D>(a, w, qs, ctid, 128 * kConsumers);
      }
      fence_proxy_async();
      named_bar_sync(kBarConsumers, 128 * kConsumers);
    }
    const int qa = qpos[ra], qb = qpos[rb];
    const uint32_t q_addr = smem_u32(qs);
    const uint32_t ring_addr = smem_u32(base + L.ring());
    const uint32_t p_addr = smem_u32(base + L.p());
    unsigned char* pt = base + L.p();
    const int ksteps = (D + DR) / 16;

    float o[NO];
#pragma unroll
    for (int x = 0; x < NO; ++x) o[x] = 0.f;
    float sc[NS] = {};
    float ma = -INFINITY, mb = -INFINITY, la = 0.f, lb = 0.f;  // l: this thread's partial row sums

    // Issue tile i's score product (its stage has landed).
    auto issue_scores = [&](int i) {
      const int s = i % kStages;
      if (!F8 && !box_rows) fence_proxy_async();  // cp.async stages are the generic proxy's (fp8: the producer fenced)
      const uint32_t kst = ring_addr + s * L.stage_bytes();
      auto score_step = [&](int kk) {
        const uint32_t off = (kk & 3) * 32;  // 16-lane step inside the 128-byte row
        const uint64_t da = sw128_desc(q_addr + (kk >> 2) * (kRows * 128) + off);
        const uint64_t db = sw128_desc(kst + (kk >> 2) * (KEYS * 128) + wg * (KEYS / 2) * 128 + off);
        if constexpr (KEYS == 64) {
          wgmma_m64n32k16_ss(sc, da, db, kk > 0);
        } else {
          wgmma_m64n16k16_ss(sc, da, db, kk > 0);
        }
      };
      fence_regs(sc);
      wgmma_fence();
      if constexpr (RSTEPS > 0) {
#pragma unroll
        for (int kk = 0; kk < D / 16 + RSTEPS; ++kk) score_step(kk);
      } else {
        for (int kk = 0; kk < ksteps; ++kk) score_step(kk);
      }
      wgmma_commit();
    };
    for (int i = 0; i < NT; ++i) {
      const int s = i % kStages;
      const uint32_t kst = ring_addr + s * L.stage_bytes();
      if (shared) {
        mbar_wait_cluster(&full[s], (i / kStages) & 1);
      } else {
        mbar_wait(&full[s], (i / kStages) & 1);
      }
      if (!shared || i < ntiles) {
        issue_scores(i);
        wgmma_wait<0>();
        fence_regs(sc);

        // Scores in log2 units; the mask only on a tile crossing the smallest horizon.
        const int k0 = w.kbeg + i * KEYS, kw = k0 + wg * (KEYS / 2);
#pragma unroll
        for (int x = 0; x < NS; ++x) sc[x] *= kLog2e;
        if (k0 + KEYS - 1 > w.tmin) {
#pragma unroll
          for (int j = 0; j < NS / 4; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kpos = kw + 8 * j + 2 * t4 + e;
              if (kpos > qa) sc[4 * j + e] = -INFINITY;
              if (kpos > qb) sc[4 * j + 2 + e] = -INFINITY;
            }
        }
        float xa = -INFINITY, xb = -INFINITY;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
          xa = fmaxf(xa, fmaxf(sc[4 * j], sc[4 * j + 1]));
          xb = fmaxf(xb, fmaxf(sc[4 * j + 2], sc[4 * j + 3]));
        }
#pragma unroll
        for (int off = 1; off < 4; off <<= 1) {
          xa = fmaxf(xa, __shfl_xor_sync(0xffffffffu, xa, off));
          xb = fmaxf(xb, __shfl_xor_sync(0xffffffffu, xb, off));
        }
        if (t4 == 0) {
          red[wg * kRows + ra] = xa;
          red[wg * kRows + rb] = xb;
        }
        named_bar_sync(kBarMax, 128 * kConsumers);
        const float na = fmaxf(ma, fmaxf(red[ra], red[kRows + ra]));
        const float nb = fmaxf(mb, fmaxf(red[rb], red[kRows + rb]));
        // A row with no key yet keeps m = -inf: subtract 0 so p = exp2(-inf) = 0.
        const float sa = na == -INFINITY ? 0.f : na, sb = nb == -INFINITY ? 0.f : nb;
        const float aa = fast_exp2(ma - sa), ab = fast_exp2(mb - sb);
        ma = na;
        mb = nb;
        float suma = 0.f, sumb = 0.f;
#pragma unroll
        for (int j = 0; j < NS / 4; ++j) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            sc[4 * j + e] = fast_exp2(sc[4 * j + e] - sa);
            sc[4 * j + 2 + e] = fast_exp2(sc[4 * j + 2 + e] - sb);
            suma += sc[4 * j + e];
            sumb += sc[4 * j + 2 + e];
          }
          // p (bf16) into the swizzled p tile: rows ra / rb, keys kw - k0 + 8j + 2t4 (+1).
          const int chunk = wg * (KEYS / 16) + j;
          const int sw = ((chunk ^ (ra & 7)) << 4) + t4 * 4;  // rb & 7 == ra & 7
          *reinterpret_cast<uint32_t*>(pt + ra * 128 + sw) = pack_bf16(sc[4 * j], sc[4 * j + 1]);
          *reinterpret_cast<uint32_t*>(pt + rb * 128 + sw) = pack_bf16(sc[4 * j + 2], sc[4 * j + 3]);
        }
        la = aa * la + suma;
        lb = ab * lb + sumb;
        fence_proxy_async();
        named_bar_sync(kBarP, 128 * kConsumers);  // both halves of p are in the tile

#pragma unroll
        for (int j = 0; j < NO / 4; ++j) {
          o[4 * j] *= aa;
          o[4 * j + 1] *= aa;
          o[4 * j + 2] *= ab;
          o[4 * j + 3] *= ab;
        }
        fence_regs(o);
        wgmma_fence();
        const uint32_t c_addr = kst + wg * (DA / 2) * (KEYS * 128);  // this warpgroup's first latent atom
#pragma unroll
        for (int kk = 0; kk < KEYS / 16; ++kk) {
          const uint64_t da = sw128_desc(p_addr + kk * 32);
          const uint64_t db = sw128_desc_mn(c_addr + kk * 16 * 128, KEYS * 128);
          if constexpr (D == 512) {
            wgmma_m64n256k16_ss_mn(o, da, db);
          } else {
            wgmma_m64n64k16_ss_mn(o, da, db);
          }
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(o);
      }
      if (shared) {
        // Release the stage to every rank's producer (none waits for the
        // last kStages tiles' releases).
        if (i + kStages < NT && lane == 0)
          for (int k = 0; k < a.share; ++k) mbar_arrive_cluster(mapa(smem_u32(&empty[s]), k));
      } else if (lane == 0) {
        mbar_arrive(&empty[s]);
      }
    }

    // Row sums: the quad's partials, then the two warpgroups' in order.
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      la += __shfl_xor_sync(0xffffffffu, la, off);
      lb += __shfl_xor_sync(0xffffffffu, lb, off);
    }
    if (t4 == 0) {
      red[wg * kRows + ra] = la;
      red[wg * kRows + rb] = lb;
    }
    named_bar_sync(kBarConsumers, 128 * kConsumers);  // also: both warpgroups are done with Q and the ring
    const float lra = red[ra] + red[kRows + ra], lrb = red[rb] + red[kRows + rb];
    if (a.S == 1) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = half ? rb : ra;
        if (r >= w.rows) continue;
        const float lr = half ? lrb : lra;
        const float inv = lr > 0.f ? 1.f / lr : 0.f;
        float* orow = a.out + (row0 + r) * D + wg * (D / 2);
#pragma unroll
        for (int j = 0; j < NO / 4; ++j)
          *reinterpret_cast<float2*>(orow + 8 * j + 2 * t4) =
              make_float2(o[4 * j + 2 * half] * inv, o[4 * j + 2 * half + 1] * inv);
      }
      if (shared) cluster_sync();
      return;
    }
    if (wg == 0 && t4 == 0) {
      m_s[ra] = ma == -INFINITY ? kNegInf : ma;
      m_s[rb] = mb == -INFINITY ? kNegInf : mb;
      l_s[ra] = lra;
      l_s[rb] = lrb;
    }
    // This split's partial for the cluster merge.
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float* arow = accs + (half ? rb : ra) * AS + wg * (D / 2);
#pragma unroll
      for (int j = 0; j < NO / 4; ++j)
        *reinterpret_cast<float2*>(arow + 8 * j + 2 * t4) = make_float2(o[4 * j + 2 * half], o[4 * j + 2 * half + 1]);
    }
    cluster_merge<kRows>(accs, AS, m_s, l_s, a.out + row0 * D, w.rows, D, ctid, 128 * kConsumers);
  }
}

// ---------------------------------------------------------------------------
// f32 caches: scalar FMA, the same walk and merge.

constexpr int kF32Threads = 256;
constexpr int kF32Warps = kF32Threads / 32;
constexpr int kF32Rows = 32;  // query rows per block
constexpr int kF32Keys = 32;  // key sub-tile

// ops/paged_mla.py _smem_bytes mirrors this.
__host__ __device__ constexpr size_t f32_smem_bytes(int D, int DR) {
  return sizeof(float) * ((size_t)(kF32Rows + kF32Keys) * (D + DR + 4) + (size_t)kF32Rows * (kF32Keys + 1) +
                          3 * kF32Rows) +
         sizeof(int) * kF32Rows;
}

// Start copying keys [k0, k0 + nkeys) into the tile `dst` (row stride QS):
// lanes [0, D) from the latent cache [P, ps, D], lanes [D, D + DR) from the
// first DR lanes of the rope cache [P, ps, RW]; pages of ps = 1 << sh
// tokens. cp.async: the caller commits and waits. The tile's page ids (at
// most 16: k0 is a multiple of 32 and pages hold 2+ tokens) are read once
// per warp, one per lane, and passed by shuffle. Page lookups clamp to the
// row's last page, so a -1 in a table tail is never read; the clamped keys
// are masked by position.
template <int D>
__device__ __forceinline__ void load_tile_f32(const float* __restrict__ cc, const float* __restrict__ rc,
                                              const int* __restrict__ trow, float* dst, int QS, int k0, int nkeys,
                                              int last_page, int sh, int DR, int RW) {
  constexpr int VEC = 4;
  constexpr int CL = D / VEC;              // latent chunks (16 bytes) per key: a power of 2
  constexpr int KPP = kF32Threads / CL;    // keys per pass over the latent lanes
  static_assert(kF32Threads % CL == 0, "a pass covers whole keys");
  const int lane = threadIdx.x & 31, p0 = k0 >> sh, pmask = (1 << sh) - 1;
  const int page = trow[min(p0 + lane, last_page)];
  const int c = (threadIdx.x % CL) * VEC;
  for (int j = threadIdx.x / CL; j < nkeys; j += KPP) {  // nkeys is a multiple of KPP: every lane shuffles
    const int kpos = k0 + j;
    const size_t slot = ((size_t)__shfl_sync(0xffffffffu, page, (kpos >> sh) - p0) << sh) + (kpos & pmask);
    cp_async16(dst + j * QS + c, cc + slot * D + c);
  }
  const int cr = DR / VEC, total = nkeys * cr;  // rope chunks per key, all of them
  for (int base = 0; base < total; base += kF32Threads) {  // warp-uniform trip count
    const int e = base + threadIdx.x;
    const int j = e / cr, kpos = k0 + j;
    const int pg = __shfl_sync(0xffffffffu, page, min((kpos >> sh) - p0, 31));
    if (e < total) {
      const size_t slot = ((size_t)pg << sh) + (kpos & pmask);
      cp_async16(dst + j * QS + D + (e - j * cr) * VEC, rc + slot * RW + (e - j * cr) * VEC);
    }
  }
}

// Stage the tile's query rows into shared memory as f32: [q_lat | q_rope],
// scaled in f32 and rounded to the cache dtype (f32: unchanged). 16-byte
// loads, four in flight per thread before any is used (rows past `rows` are
// zeros).
template <typename QT>
__device__ __forceinline__ void stage_queries_f32(const MlaArgs& a, const Walk& w, float* qs, int QS, int D) {
  constexpr int V = CacheVec<QT>::N;  // elements per 16-byte load
  constexpr int kBatch = 4;
  const int DR = a.DR, cpr = (D + DR) / V, total = kF32Rows * cpr;
  const size_t row0 = (size_t)w.b * a.T * a.H + w.r0;
  const QT* ql = static_cast<const QT*>(a.q_lat);
  const QT* qr = static_cast<const QT*>(a.q_rope);
  for (int base = threadIdx.x; base < total; base += kBatch * kF32Threads) {
    uint4 u[kBatch];
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kF32Threads, r = i / cpr, c = (i - r * cpr) * V;
      u[k] = make_uint4(0u, 0u, 0u, 0u);
      if (i < total && r < w.rows)
        u[k] = *reinterpret_cast<const uint4*>(c < D ? ql + (row0 + r) * D + c : qr + (row0 + r) * DR + (c - D));
    }
#pragma unroll
    for (int k = 0; k < kBatch; ++k) {
      const int i = base + k * kF32Threads, r = i / cpr, c = (i - r * cpr) * V;
      if (i >= total) break;
      float f[V];
      CacheVec<QT>::unpack(u[k], f);
#pragma unroll
      for (int v = 0; v < V; ++v) qs[r * QS + c + v] = f[v] * a.scale;
    }
  }
}

// The online-softmax step of a key sub-tile for all kF32Rows rows: each
// warp takes 4 rows at once, 8 lanes a row, kF32Keys/8 keys a lane (keys
// g8 + 8i). Scores in st (masked to NEG_INF), overwritten with p; each
// row's m, l and rescale factor updated. Fixed shuffle trees inside each
// 8-lane group, so a row's arithmetic does not depend on which rows share
// its tile.
__device__ __forceinline__ void softmax_rows(float* st, int sstride, int k0, const int* qpos, float* m_s, float* l_s,
                                             float* a_s) {
  static_assert(kF32Rows == 4 * kF32Warps, "each warp takes 4 rows");
  constexpr int KPL = kF32Keys / 8;
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
    st[r * sstride + g8 + 8 * i] = p;
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

template <int D>
__global__ void __launch_bounds__(kF32Threads, 1) mla_f32_kernel(const MlaArgs a) {
  constexpr int TPR = D < kF32Threads ? D : kF32Threads;  // threads sharing one row of the output
  constexpr int RPT = kF32Rows * TPR / kF32Threads;       // output rows per thread
  constexpr int CPT = D / TPR;                            // output columns per thread
  constexpr int KT = kF32Keys;
  const int DR = a.DR, QS = D + DR + 4, DK = D + DR;
  const int tid = threadIdx.x;

  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kF32Rows][QS]
  float* kv = qs + kF32Rows * QS;                  // [KT][QS]
  float* st = kv + KT * QS;                        // [kF32Rows][KT + 1]: scores, then p
  float* m_s = st + kF32Rows * (KT + 1);
  float* l_s = m_s + kF32Rows;
  float* a_s = l_s + kF32Rows;
  int* qpos = reinterpret_cast<int*>(a_s + kF32Rows);

  const Walk w = plan_walk<kF32Rows>(a);
  const int b = w.b;
  if (w.padding) {
    write_zeros(a, w, D);
    return;
  }
  for (int r = tid; r < kF32Rows; r += kF32Threads) {
    qpos[r] = r < w.rows ? a.positions[(size_t)b * a.T + (w.r0 + r) / a.H] : -1;  // rows past the end mask every key
    m_s[r] = kNegInf;
    l_s[r] = 0.f;
  }
  const int* trow = a.tables + (size_t)b * a.N;
  if (w.nkeys > 0) {
    if (a.q_f32) {
      stage_queries_f32<float>(a, w, qs, QS, D);
    } else {
      stage_queries_f32<__nv_bfloat16>(a, w, qs, QS, D);
    }
  }
  const int col0 = tid % TPR, row0 = (tid / TPR) * RPT;
  float o[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) o[i][c] = 0.f;

  for (int k0 = w.kbeg; k0 < w.kbeg + w.nkeys; k0 += KT) {
    load_tile_f32<D>(static_cast<const float*>(a.cc), static_cast<const float*>(a.rc), trow, kv, QS, k0, KT,
                     w.last_page, w.sh, DR, a.RW);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    // Scores: one (row, key) dot product per thread, latent lanes then rope lanes, in order.
    for (int e = tid; e < kF32Rows * KT; e += kF32Threads) {
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
    softmax_rows(st, KT + 1, k0, qpos, m_s, l_s, a_s);
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
  __syncthreads();  // the stats are visible even when no key was walked
  const size_t orow0 = (size_t)b * a.T * a.H + w.r0;
  if (a.S == 1) {
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = row0 + i;
      if (r >= w.rows) continue;
      const float l = l_s[r];
#pragma unroll
      for (int c = 0; c < CPT; ++c) a.out[(orow0 + r) * D + col0 + c * TPR] = l > 0.f ? o[i][c] / l : 0.f;
    }
    return;
  }
  // This split's partial over the query tile, m in log2 units, for the cluster merge.
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) qs[(row0 + i) * QS + col0 + c * TPR] = o[i][c];
  for (int r = tid; r < kF32Rows; r += kF32Threads) m_s[r] *= kLog2e;
  cluster_merge<kF32Rows>(qs, QS, m_s, l_s, a.out + orow0 * D, w.rows, D, tid, kF32Threads);
}

// ---------------------------------------------------------------------------

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

// One launch: grid (S splits, B sequences, row tiles rounded up to whole
// share groups; see plan_walk), one thread block cluster of S x 1 x share:
// the S splits of a row tile (merged in the cluster), or (fp8, S == 1) a
// share group of `share` row tiles.
template <typename K, typename... Args>
cudaError_t launch_clustered(K kern, const MlaArgs& a, int B, int rows, int threads, size_t smem,
                             cudaStream_t stream, Args... args) {
  cudaLaunchAttribute cluster{};
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = a.S;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = a.share;
  const int tiles = (a.T * a.H + rows - 1) / rows;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(a.S, B, (tiles + a.share - 1) / a.share * a.share);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, a, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int D, int KEYS, int RSTEPS, bool F8>
cudaError_t launch_wgmma(const MlaArgs& a, int B, int P, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  const WgLayout L{D / 64 + (a.DR + 63) / 64, KEYS};
  auto kern = mla_wgmma_kernel<D, KEYS, RSTEPS, F8>;
  // bf16: latent and rope tiles by TMA where the page size allows an 8-row
  // box and the rope stream is a box wide, else cp.async. A tensor map the
  // driver refuses is an error, never a silent switch to cp.async. fp8
  // tiles land by cp.async and are converted in place.
  CUtensorMap tmc{}, tmr{}, tmq{}, tmqr{};
  const long long cache_rows = (long long)P * a.ps;
  const int box_rows = !F8 && a.RW >= 64 ? tma_box_rows(a.ps, KEYS) : 0;
  if (box_rows && !(encode_cache_map(&tmc, a.cc, cache_rows, D, box_rows) &&
                    encode_cache_map(&tmr, a.rc, cache_rows, a.RW, box_rows)))
    return cudaErrorNotSupported;
  // bf16 queries whose rope lanes fill whole boxes arrive by TMA too.
  const int q_tma = !a.q_f32 && a.DR % 64 == 0;
  const long long rows = (long long)B * a.T * a.H;
  if (q_tma &&
      !(encode_cache_map(&tmq, a.q_lat, rows, D, kRows) && encode_cache_map(&tmqr, a.q_rope, rows, a.DR, kRows)))
    return cudaErrorNotSupported;
  const cudaError_t e = allow_smem(kern, L.bytes(), allowed);
  if (e != cudaSuccess) return e;
  return launch_clustered(kern, a, B, kRows, kWgThreads, L.bytes(), stream, tmc, tmr, tmq, tmqr, box_rows, q_tma);
}

// The wgmma kernel for D, DR and `keys`-key stages; the rope width of every
// serving geometry (64) gets an unrolled score product.
template <bool F8>
cudaError_t launch_wgmma_for(const MlaArgs& a, int D, int keys, int B, int P, cudaStream_t st) {
  if (D == 512) {
    if (a.DR == 64 && keys == 64) return launch_wgmma<512, 64, 4, F8>(a, B, P, st);
    return keys == 64 ? launch_wgmma<512, 64, 0, F8>(a, B, P, st) : launch_wgmma<512, 32, 0, F8>(a, B, P, st);
  }
  if (a.DR == 64 && keys == 64) return launch_wgmma<128, 64, 4, F8>(a, B, P, st);
  return keys == 64 ? launch_wgmma<128, 64, 0, F8>(a, B, P, st) : launch_wgmma<128, 32, 0, F8>(a, B, P, st);
}

template <int D>
cudaError_t launch_f32(const MlaArgs& a, int B, cudaStream_t stream) {
  static size_t allowed = 48 * 1024;
  auto kern = mla_f32_kernel<D>;
  const size_t smem = f32_smem_bytes(D, a.DR);
  const cudaError_t e = allow_smem(kern, smem, allowed);
  if (e != cudaSuccess) return e;
  return launch_clustered(kern, a, B, kF32Rows, kF32Threads, smem, stream);
}

}  // namespace

// Launches the MLA attention on `stream`: one launch, the S <= 8 splits of a
// row tile one thread block cluster that merges them, or (fp8 caches, S ==
// 1) `share` (1 or 2) row tiles one cluster that fills each key tile once
// (ops/paged_mla.py mla_share_plan). Returns the CUDA error code (0 =
// launched). No synchronisation, no allocation. walk_max / walk_first: each
// sequence's largest position (int32) and the first token holding it
// (int64), from ops/paged_mla.py walk_facts; both null at T = 1. Output f32
// [B, T, H, D].
extern "C" int dyn_paged_mla(const void* q_lat, const void* q_rope, const void* c_cache, const void* r_cache,
                             const int* tables, const int* positions, const int* walk_max,
                             const long long* walk_first, float* out, int B, int T, int H, int D, int DR, int RW,
                             int ps, int N, int P, int S, int bps, int share, int cache_dtype, int q_dtype,
                             float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (S < 1 || S > kMaxSplits || (D != 128 && D != 512) || (q_dtype != 0 && q_dtype != 1))
    return (int)cudaErrorInvalidValue;
  if (share < 1 || share > kMaxShare || (share > 1 && (cache_dtype != 2 || S != 1)))
    return (int)cudaErrorInvalidValue;
  const MlaArgs a{q_lat, q_rope, c_cache, r_cache, tables, positions, walk_max, walk_first, out,
                  T, H, DR, RW, ps, N, S, bps, q_dtype == 0, scale, share};
  if (cache_dtype == 1 || cache_dtype == 2) {
    // 64-key stages where they fit the shared memory, else 32 (rows of more
    // than nine atoms); ops/paged_mla.py _tile_keys makes the same choice.
    const int na = D / 64 + (DR + 63) / 64;
    const int keys = WgLayout{na, 64}.bytes() <= kMaxSmem ? 64 : 32;
    if (WgLayout{na, keys}.bytes() > kMaxSmem) return (int)cudaErrorInvalidValue;
    return (int)(cache_dtype == 2 ? launch_wgmma_for<true>(a, D, keys, B, P, st)
                                  : launch_wgmma_for<false>(a, D, keys, B, P, st));
  }
  if (cache_dtype == 0) return (int)(D == 512 ? launch_f32<512>(a, B, st) : launch_f32<128>(a, B, st));
  return (int)cudaErrorInvalidValue;
}
