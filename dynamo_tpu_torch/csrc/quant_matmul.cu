// Weight-only quantized matrix product y[M, N] = x[M, K] @ W[K, N], for sm_90a:
// x bf16, W int8 per output channel or packed int4 with group scales along K
// (and an optional per-group bias), y bf16 or f32.
//
// Replaces no pl.pallas_call. The JAX build writes this product as a plain
// jnp.matmul over the dequantization expression (dynamo_tpu/models/quant.py:182
// quant_matmul, :148 _dequant_int4) and XLA fuses the dequantization into the
// dot's operand read, so the full-width weight never reaches device memory.
// Eager PyTorch has no such fusion; this kernel is that fusion, written by hand.
//
// What it computes, rounded exactly as the JAX expression is:
// - int8 (leaf {"qw": int8[K, N], "scale": bf16[N]}): W's elements convert
//   exactly to bf16; the f32 accumulator is rounded to the output dtype, then
//   multiplied by the column's scale and rounded again (quant.py:200-203).
// - int4 (leaf {"qw4": int8[K/2, N], "scale": [G, N], "qbias"?: [G, N]}): byte
//   i of a column holds element 2i in its low nibble and 2i+1 in its high one
//   (sign-extended); element k of group g = k / group_size is
//   bf16(bf16(q * s) + b), s and b the group's scale and bias rounded to bf16
//   (bf16 or f32 leaves; GGUF imports keep f32), the two steps never fused.
//   The f32 accumulator is rounded to the output dtype.
//
// Bound: weight bytes at decode (M of a few rows: K*N or K*N/2 bytes against
// 2*M*N*K operations), operations at prefill (2*M*N*K at M in the hundreds or
// thousands of rows, above the card's ~295 operations a byte). Two forms; the
// plan (ops/quant_matmul.py plan) picks one per launch from shapes alone, and
// both cut K into at most 8 splits that form a thread block cluster: each
// split leaves its f32 partial in its shared memory, and every rank sums a
// slice of the tile over the ranks' partials in rank order through
// distributed shared memory, then rounds and stores it (one launch, no
// workspace, no atomics, so a CUDA-graph replay equals an eager launch).
//
// The decode form (M <= 16: decode batches), built to stream the weight.
// - A block owns 256 output columns and a split's K range. One producer lane
//   keeps a ring of raw weight tiles in flight with TMA (two 128-byte boxes a
//   64-deep stage, landing in the 128-byte swizzle; int4 group scales and
//   biases as boxes beside them), 6 stages deep for int4 and 4 for int8. x
//   arrives by TMA too, once for the block's K range where it fits 24 KB (else
//   in two 12 KB chunks refilled in turns: a block's shared memory stays
//   small enough for two an SM); rows past M are zero-filled, never re-read.
// - Four consumer warps each own 64 columns as four m16 tiles of mma.sync
//   m16n8k16 with the WEIGHT as the A operand and x^T as n8 B fragments
//   (ldmatrix from the swizzled x tile), so M 8 pads nothing (M 16: two n8
//   tiles). A lane's four tiles take four consecutive columns, so each A
//   register's (k, k+1) pair is one byte of an int4 column (or two bytes, one
//   of each of two int8 rows) of one 32-bit shared-memory word; the chunks a
//   warp reads are chosen so that every word load hits 32 distinct banks
//   through the swizzle.
//
// The prefill form (M > 16), warp-specialised wgmma with the weight in
// registers: y^T = W^T . x^T, so the weight is wgmma's register A operand,
// converted where it is used, and x the K-major shared-memory B operand.
// - A block owns 128 weight columns (two consumer warpgroups of 64) and 128
//   or 256 x rows (wgmma m64n128k16 / m64n256k16, 64 / 128 accumulators a
//   thread). One thread of a producer warpgroup keeps a ring of stages full
//   with TMA (the x tile, 64 bf16 columns in the 128-byte swizzle, the ragged
//   M edge zero-filled; the raw weight tile and its scales), 5 stages at 256
//   rows and 8 at 128, behind full/empty mbarrier pairs; setmaxnreg hands the
//   producers' registers to the consumers.
// - A consumer thread's A rows g and g + 8 are two neighbouring columns, so
//   one 16-bit word of a raw row holds both; it converts a stage's four k16
//   steps into registers, issues them, and converts the next stage while they
//   run (one stage in flight, two A register sets), releasing each stage as
//   the next is issued.
// - The conversion is exact and the same in both forms: int4 nibbles into
//   bf16 halves by prmt (128 + q + 8, less 136), then __hmul2_rn and
//   __hadd2_rn, never contracted; int8 bytes through an exact f32 magic
//   number (decode) or an exact bf16 one (128 + low 7 bits less 128 or 256 by
//   the sign, prefill).
// What bounds each form, measured (PERF.md): the prefill form's conversion
// and loads, issued by the warps that issue the products; the decode form's
// per-stage latency, at a few warps an SM.

#include <algorithm>

#include <cooperative_groups.h>

#include "hopper.cuh"

namespace {

constexpr int kBK = 64;  // K per stage: two GGUF groups of 32, half a default group of 128

enum Mode { kInt8 = 0, kInt4 = 1 };
enum Form { kDecode = 0, kPrefill = 1 };

constexpr int round1024(int b) { return (b + 1023) / 1024 * 1024; }

// One ring stage of raw weights for BN columns: BN / 128 TMA boxes of 128
// bytes x kRows rows (32 packed int4 rows or 64 int8 rows) in the 128-byte
// swizzle, then (int4) up to two rows of group scales and two of biases
// (group 32 spans two rows a stage, larger groups one), BN elements each.
template <int MODE, typename ST, int BN>
struct WStage {
  static constexpr int kRows = MODE == kInt4 ? kBK / 2 : kBK;
  static constexpr int kBoxes = BN / 128;
  static constexpr int kBox = kRows * 128;
  static constexpr int kW = kBoxes * kBox;
  static constexpr int kS = MODE == kInt4 ? 2 * BN * (int)sizeof(ST) : 0;  // scale rows (and as many bias rows)
  static constexpr int kBytes = round1024(kW + 2 * kS);
  // Bytes a stage's TMA boxes deliver: srows scale (and bias) rows.
  static __host__ __device__ uint32_t tx(int srows, bool bias) {
    return kW + (MODE == kInt4 ? srows * BN * (int)sizeof(ST) * (bias ? 2 : 1) : 0);
  }
};

__device__ __forceinline__ uint32_t ld_u32(const uint8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }
// ldmatrix_x4 from a shared::cta address.
__device__ __forceinline__ void ldsm_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ __nv_bfloat162 as_bf162(uint32_t u) { return *reinterpret_cast<__nv_bfloat162*>(&u); }
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) { return *reinterpret_cast<uint32_t*>(&v); }

// The four scales (or biases) at p .. p + 3 as bf16 pairs, each value in
// both halves (an A register's (k, k+1) pair of one column). An f32 leaf is
// rounded to bf16 first, as the JAX expression casts it to the activation
// dtype.
__device__ __forceinline__ void scale_pairs(const __nv_bfloat16* p, uint32_t* out) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  out[0] = __byte_perm(u.x, 0, 0x1010);
  out[1] = __byte_perm(u.x, 0, 0x3232);
  out[2] = __byte_perm(u.y, 0, 0x1010);
  out[3] = __byte_perm(u.y, 0, 0x3232);
}
__device__ __forceinline__ void scale_pairs(const float* p, uint32_t* out) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  out[0] = pack_bf16(v.x, v.x);
  out[1] = pack_bf16(v.y, v.y);
  out[2] = pack_bf16(v.z, v.z);
  out[3] = pack_bf16(v.w, v.w);
}

// The two scales (or biases) at p, p + 1 the same way.
__device__ __forceinline__ void scale_pairs2(const __nv_bfloat16* p, uint32_t* out) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(p);
  out[0] = __byte_perm(u, 0, 0x1010);
  out[1] = __byte_perm(u, 0, 0x3232);
}
__device__ __forceinline__ void scale_pairs2(const float* p, uint32_t* out) {
  const float2 v = *reinterpret_cast<const float2*>(p);
  out[0] = pack_bf16(v.x, v.x);
  out[1] = pack_bf16(v.y, v.y);
}

// Two offset int4 codes (nibble ^ 8, one a byte) picked by `sel` from `nib`
// into bf16 halves 128 + (q + 8) (exact), then q, scaled and biased, each
// step rounded to bf16 as the JAX expression rounds it (__hmul2_rn and
// __hadd2_rn are never contracted into one fma).
__device__ __forceinline__ uint32_t dq4_pair(uint32_t nib, uint32_t sel, uint32_t s2, uint32_t b2, bool bias) {
  __nv_bfloat162 v = __hsub2(as_bf162(__byte_perm(nib, 0x43434343u, sel)), __float2bfloat162_rn(136.0f));
  v = __hmul2_rn(v, as_bf162(s2));
  if (bias) v = __hadd2_rn(v, as_bf162(b2));
  return as_u32(v);
}

// One int4 A-fragment register: byte j of the offset words lo / hi, i.e.
// elements (2i, 2i+1) of column j.
__device__ __forceinline__ uint32_t dq4(uint32_t lo, uint32_t hi, int j, uint32_t s2, uint32_t b2, bool bias) {
  return dq4_pair(__byte_perm(lo, hi, (uint32_t)j | ((uint32_t)(4 + j) << 4)), 0x4140, s2, b2, bias);
}

// Byte j of an int8 word (already ^ 0x80) as an exact f32: 2^23 + (q + 128) - (2^23 + 128).
__device__ __forceinline__ float i8f(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | (uint32_t)j)) - 8388736.0f;
}

template <typename OT>
__device__ __forceinline__ float round_out(float v) {
  return std::is_same<OT, float>::value ? v : __bfloat162float(__float2bfloat16_rn(v));
}

// The epilogue of one output element from its f32 sum: int8 rounds, scales by
// the column's scale and rounds again; int4 rounds.
template <int MODE, typename OT>
__device__ __forceinline__ float finish(float acc, const __nv_bfloat16* __restrict__ scale, int n) {
  if constexpr (MODE == kInt8) return round_out<OT>(round_out<OT>(acc) * __bfloat162float(scale[n]));
  return round_out<OT>(acc);
}

// Four consecutive outputs of one row (8 or 16 bytes, aligned).
template <typename OT>
__device__ __forceinline__ void store4(OT* p, const float* v) {
  if constexpr (std::is_same<OT, float>::value) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<uint2*>(p) = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
  }
}
template <typename OT>
__device__ __forceinline__ void store2(OT* p, float a, float b) {
  if constexpr (std::is_same<OT, float>::value) {
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
  } else {
    *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
  }
}

constexpr int kMaxSplits = 8;  // K splits of a tile: one cluster, a portable size

// Sum of the float4 at element `off` of every rank's `part` (a cluster of S
// <= kMaxSplits blocks), in rank order; all S loads are issued before the
// first add.
__device__ __forceinline__ float4 sum_ranks(cooperative_groups::cluster_group& cluster, float* part, int off, int S) {
  float4 p[kMaxSplits];
#pragma unroll
  for (int r = 0; r < kMaxSplits; ++r)
    if (r < S) p[r] = *reinterpret_cast<const float4*>(cluster.map_shared_rank(part, r) + off);
  float4 v = p[0];
#pragma unroll
  for (int r = 1; r < kMaxSplits; ++r) {
    if (r < S) {
      v.x += p[r].x;
      v.y += p[r].y;
      v.z += p[r].z;
      v.w += p[r].w;
    }
  }
  return v;
}

// ---------------------------------------------------------------------------
// The decode form (see the note at the top).

constexpr int kDecBN = 256;                 // columns a block (ops/quant_matmul.py DECODE_BLOCK_N)
constexpr int kXBytes = 24 * 1024;          // x staged at most this much at once

// A decode block: a consumer warp a 64-column slab, and one producer warp.
template <int MODE, typename ST, int MT>
struct DecLayout {
  using W = WStage<MODE, ST, kDecBN>;
  static constexpr int kWarps = kDecBN / 64;       // consumer warps
  static constexpr int kThreads = 32 * (kWarps + 1);
  static constexpr int R = MODE == kInt4 ? 6 : 4;  // ring stages
  static constexpr int MP = 8 * MT;                // x rows staged (M padded to the n8 tiles)
  static constexpr int kXBox = MP * 128;           // one 64-column x box
  static constexpr int kRing = R * W::kBytes;
  static constexpr int kPart = MP * kDecBN * 4;    // a split's f32 partial
  // ring | x slots (slots x spc boxes) | partial (splits > 1) | mbarriers
  static size_t bytes(int spc, int slots, int splits) {
    return 1024 + kRing + (size_t)slots * spc * kXBox + (splits > 1 ? kPart : 0) + (2 * R + 4) * 8;
  }
};

// Stages of x a slot holds: the longest split's whole range in one slot
// where it fits kXBytes, else two slots of half that, refilled in turns.
inline void x_chunks(int MP, int K, int splits, int& spc, int& slots) {
  const int nk = K / kBK, longest = (nk + splits - 1) / splits;
  slots = longest * MP * 128 <= kXBytes ? 1 : 2;
  spc = slots == 1 ? longest : kXBytes / 2 / (MP * 128);
}

template <int MODE, typename ST, typename OT, int MT>
__global__ void __launch_bounds__(DecLayout<MODE, ST, MT>::kThreads) qmm_decode_kernel(
    const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
    const __grid_constant__ CUtensorMap tms, const __grid_constant__ CUtensorMap tmb,
    const __nv_bfloat16* __restrict__ scale8, OT* __restrict__ out, int M, int N, int K, int gs, int bias,
    int spc, int slots) {
  namespace cg = cooperative_groups;
  using L = DecLayout<MODE, ST, MT>;
  using W = typename L::W;
  constexpr int R = L::R, MP = L::MP, kWarps = L::kWarps;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* xs = base + L::kRing;
  const int S = gridDim.x;
  float* part = reinterpret_cast<float*>(xs + (size_t)slots * spc * L::kXBox);
  uint64_t* full = reinterpret_cast<uint64_t*>(reinterpret_cast<uint8_t*>(part) + (S > 1 ? L::kPart : 0));
  uint64_t* empty = full + R;
  uint64_t* xfull = empty + R;
  uint64_t* xempty = xfull + 2;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int n0 = blockIdx.y * kDecBN, nk = K / kBK;
  const int kb = (int)((long long)blockIdx.x * nk / S), ns = (int)((long long)(blockIdx.x + 1) * nk / S) - kb;
  const int srows = gs == 32 ? 2 : 1;
  if (tid == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(&full[s], 1);  // the producer's expect_tx arrival
      mbar_init(&empty[s], kWarps);
    }
    for (int c = 0; c < 2; ++c) {
      mbar_init(&xfull[c], 1);
      mbar_init(&xempty[c], kWarps);
    }
    mbar_init_fence();
  }
  __syncthreads();

  float acc[MT][4][4];
#pragma unroll
  for (int t = 0; t < MT; ++t)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[t][j][r] = 0.f;
  const int g = lane >> 2, t4 = lane & 3;
  const int box = warp >> 1, h = warp & 1, u = g >> 2, ob = (g & 3) * 4;
  // The 16-byte chunks (of a box's 128-byte rows) holding the lane's columns
  // of its tiles' rows g (A) and g + 8 (B): each warp load then reads eight
  // distinct chunks through the swizzle (int4 rows vary in bits 0-1 across
  // t4, int8 rows in bits 1-2).
  const int cA = MODE == kInt4 ? 2 * h + 4 * u : 4 * h + u;
  const int cB = MODE == kInt4 ? cA + 1 : cA + 2;
  const int colA = box * 128 + cA * 16 + ob, colB = box * 128 + cB * 16 + ob;  // tile-local columns

  if (warp == kWarps) {
    if (lane == 0 && ns > 0) {
      tma_prefetch_map(&tmx);
      tma_prefetch_map(&tmw);
      const uint32_t wtx = W::tx(srows, bias);
      for (int i = 0; i < ns; ++i) {
        if (i % spc == 0) {  // x for the next chunk of the range
          const int c = i / spc, xsl = c % slots;
          if (c >= slots) mbar_wait(&xempty[xsl], ((c / slots) - 1) & 1);
          const int nb = min(spc, ns - i);
          mbar_arrive_expect_tx(&xfull[xsl], (uint32_t)nb * L::kXBox);
          for (int b = 0; b < nb; ++b)
            tma_load_2d(xs + ((size_t)xsl * spc + b) * L::kXBox, &tmx, (kb + i + b) * kBK, 0, &xfull[xsl]);
        }
        const int s = i % R;
        if (i >= R) mbar_wait(&empty[s], ((i / R) - 1) & 1);
        uint8_t* st = base + s * W::kBytes;
        mbar_arrive_expect_tx(&full[s], wtx);
        const int k0 = (kb + i) * kBK;
#pragma unroll
        for (int b = 0; b < W::kBoxes; ++b)
          tma_load_2d(st + b * W::kBox, &tmw, n0 + 128 * b, MODE == kInt4 ? k0 / 2 : k0, &full[s]);
        if constexpr (MODE == kInt4) {
          tma_load_2d(st + W::kW, &tms, n0, k0 / gs, &full[s]);
          if (bias) tma_load_2d(st + W::kW + W::kS, &tmb, n0, k0 / gs, &full[s]);
        }
      }
    }
  } else {
    // Per-lane word offsets inside a box row: int4 rows 8s + t4 and 8s + 4 + t4
    // (row & 7 = t4, t4 ^ 4); int8 rows 16s + 2t4 + e and 8 rows on (row & 7 = 2t4 + e).
    uint32_t oA[2], oB[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int r7 = MODE == kInt4 ? (t4 ^ (4 * e)) : ((2 * t4 + e) & 7);
      oA[e] = ((cA ^ r7) << 4) + ob;
      oB[e] = ((cB ^ r7) << 4) + ob;
    }
    for (int i = 0; i < ns; ++i) {
      const int c = i / spc, xsl = c % slots;
      if (i % spc == 0) mbar_wait(&xfull[xsl], (c / slots) & 1);
      const int s = i % R;
      mbar_wait(&full[s], (i / R) & 1);
      const uint8_t* wst = base + s * W::kBytes + box * W::kBox;
      const uint32_t xb = smem_u32(xs) + (uint32_t)((xsl * spc + i % spc) * L::kXBox);
      // int4: the stage's scale (and bias) pairs of the lane's columns, rows
      // 0 and srows - 1 (group 32: steps 2 and 3 take row 1).
      uint32_t sc[2][2][4], bi[2][2][4];
      if constexpr (MODE == kInt4) {
        const ST* sp = reinterpret_cast<const ST*>(base + s * W::kBytes + W::kW);
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const ST* row = sp + r * (srows - 1) * kDecBN;
          scale_pairs(row + colA, sc[r][0]);
          scale_pairs(row + colB, sc[r][1]);
          if (bias) {
            scale_pairs(row + W::kS / (int)sizeof(ST) + colA, bi[r][0]);
            scale_pairs(row + W::kS / (int)sizeof(ST) + colB, bi[r][1]);
          } else {
#pragma unroll
            for (int j = 0; j < 4; ++j) bi[r][0][j] = bi[r][1][j] = 0u;
          }
        }
      }
      uint32_t xq[4];  // MT == 1: the x fragments of two k16 steps
#pragma unroll
      for (int ks = 0; ks < kBK / 16; ++ks) {
        // x^T fragments (b0 b1 of n8 tile t): rows m of the swizzled x box,
        // 16-byte k chunks 2ks and 2ks + 1.
        uint32_t xf[MT][2];
        if constexpr (MT == 1) {
          if ((ks & 1) == 0) {  // k chunks 2ks .. 2ks + 3 of rows 0..7: this step and the next
            const int m = lane & 7, ch = 2 * ks + (lane >> 3);
            ldsm_x4(xq, xb + m * 128 + ((ch ^ m) << 4));
          }
          xf[0][0] = xq[(ks & 1) * 2];
          xf[0][1] = xq[(ks & 1) * 2 + 1];
        } else {
#pragma unroll
          for (int tp = 0; tp < MT / 2; ++tp) {  // n8 tiles 2tp and 2tp + 1
            const int m = 8 * (2 * tp + (lane >> 4)) + (lane & 7), ch = 2 * ks + ((lane >> 3) & 1);
            uint32_t r[4];
            ldsm_x4(r, xb + m * 128 + ((ch ^ (lane & 7)) << 4));
            xf[2 * tp][0] = r[0];
            xf[2 * tp][1] = r[1];
            xf[2 * tp + 1][0] = r[2];
            xf[2 * tp + 1][1] = r[3];
          }
        }
        // The weight as m16 A fragments of the warp's four tiles: a[j] =
        // {row g k-low, row g+8 k-low, row g k-high, row g+8 k-high}.
        uint32_t a[4][4];
        if constexpr (MODE == kInt4) {
          const uint8_t* r0 = wst + (ks * 8 + t4) * 128;
          const uint8_t* r1 = r0 + 4 * 128;
          const uint32_t w[4] = {ld_u32(r0 + oA[0]), ld_u32(r0 + oB[0]), ld_u32(r1 + oA[1]), ld_u32(r1 + oB[1])};
          const int grp = (srows == 2 && ks >= 2) ? 1 : 0;
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const uint32_t lo = (w[q] & 0x0F0F0F0Fu) ^ 0x08080808u, hi = ((w[q] >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
            const int set = q & 1;  // 0: the columns of rows g (A), 1: of rows g + 8 (B)
#pragma unroll
            for (int j = 0; j < 4; ++j)
              a[j][q] = dq4(lo, hi, j, grp ? sc[1][set][j] : sc[0][set][j], grp ? bi[1][set][j] : bi[0][set][j],
                            bias);
          }
        } else {
          const uint8_t* r0 = wst + (ks * 16 + 2 * t4) * 128;
#pragma unroll
          for (int q = 0; q < 4; ++q) {  // q: set (bit 0), k half (bit 1)
            const uint8_t* rq = r0 + (q >> 1) * 8 * 128;
            const uint32_t o0 = (q & 1) ? oB[0] : oA[0], o1 = (q & 1) ? oB[1] : oA[1];
            const uint32_t lo = ld_u32(rq + o0) ^ 0x80808080u, hi = ld_u32(rq + 128 + o1) ^ 0x80808080u;
#pragma unroll
            for (int j = 0; j < 4; ++j) a[j][q] = pack_bf16(i8f(lo, j), i8f(hi, j));
          }
        }
#pragma unroll
        for (int t = 0; t < MT; ++t)
#pragma unroll
          for (int j = 0; j < 4; ++j) mma_bf16(acc[t][j], a[j], xf[t][0], xf[t][1]);
      }
      __syncwarp();
      if (lane == 0) {
        mbar_arrive(&empty[s]);
        if ((i + 1) % spc == 0 || i + 1 == ns) mbar_arrive(&xempty[xsl]);
      }
    }
  }

  // Tile j's C fragment: c0 c1 rows (outputs) m = 8t + 2t4 (+1) at column
  // colA + j, c2 c3 the same rows at colB + j.
  if (S == 1) {
    if (warp < kWarps) {
#pragma unroll
      for (int t = 0; t < MT; ++t)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int m = 8 * t + 2 * t4 + e;
          if (m >= M) continue;
#pragma unroll
          for (int set = 0; set < 2; ++set) {
            const int n = n0 + (set ? colB : colA);
            if (n >= N) continue;
            float v[4];
#pragma unroll
            for (int j = 0; j < 4; ++j) v[j] = finish<MODE, OT>(acc[t][j][2 * set + e], scale8, n + j);
            store4<OT>(out + (size_t)m * N + n, v);
          }
        }
    }
    return;
  }
  if (warp < kWarps) {
#pragma unroll
    for (int t = 0; t < MT; ++t)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = 8 * t + 2 * t4 + e;
#pragma unroll
        for (int set = 0; set < 2; ++set)
          *reinterpret_cast<float4*>(part + m * kDecBN + (set ? colB : colA)) =
              make_float4(acc[t][0][2 * set + e], acc[t][1][2 * set + e], acc[t][2][2 * set + e],
                          acc[t][3][2 * set + e]);
      }
  }
  // Every rank sums its slice of the tile (quads of 4 columns of rows < M)
  // over the ranks' partials in rank order, then rounds and stores it.
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  const int items = min(M, MP) * (kDecBN / 4), per = (items + S - 1) / S;
  const int lo = (int)cluster.block_rank() * per, hi = min(items, lo + per);
  for (int e = lo + tid; e < hi; e += L::kThreads) {
    const int m = e / (kDecBN / 4), c4 = (e % (kDecBN / 4)) * 4, n = n0 + c4;
    if (n >= N) continue;
    const float4 v = sum_ranks(cluster, part, m * kDecBN + c4, S);
    const float o[4] = {finish<MODE, OT>(v.x, scale8, n), finish<MODE, OT>(v.y, scale8, n + 1),
                        finish<MODE, OT>(v.z, scale8, n + 2), finish<MODE, OT>(v.w, scale8, n + 3)};
    store4<OT>(out + (size_t)m * N + n, o);
  }
  cluster.sync();  // no rank leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// The prefill form (see the note at the top).

constexpr int kPreCols = 128;      // weight columns a block: two consumer warpgroups of 64
constexpr int kPreThreads = 384;   // a producer warpgroup (one thread issues) and two consumer warpgroups
constexpr int kProducerRegs = 40;  // registers a thread after setmaxnreg: producers
constexpr int kConsumerRegs = 232; // and consumers (128 x 40 + 256 x 232 <= 384 x 168)
constexpr int kPending = 1;        // stages of a warpgroup's products in flight while it converts the next

template <int MODE, typename ST, int NX>
struct PreLayout {
  using W = WStage<MODE, ST, kPreCols>;
  static constexpr int R = NX == 256 ? 5 : 8;     // ring stages
  static constexpr int kX = NX * 128;             // NX x rows x 64 bf16
  static constexpr int kStage = kX + W::kBytes;   // the x tile, then the raw weight tile and its scales
  static constexpr int kBar = R * kStage;
  static constexpr int kBytes = 1024 + kBar + 2 * R * 8;
};

// An int8 A register: bytes j of h0 (row k) and h1 (row k + 1), one column,
// as exact bf16: 128 + (b & 127) minus 128 or 256 by the sign bit.
__device__ __forceinline__ uint32_t i8_pair(uint32_t h0, uint32_t h1, int j) {
  const uint32_t p = __byte_perm(h0, h1, (uint32_t)j | ((uint32_t)(4 + j) << 8));
  const uint32_t v = (p & 0x007F007Fu) | 0x43004300u, c = (p & 0x00800080u) | 0x43004300u;
  return as_u32(__hsub2(as_bf162(v), as_bf162(c)));
}

template <int MODE, typename ST, typename OT, int NX>
__global__ void __launch_bounds__(kPreThreads, 1) qmm_prefill_kernel(
    const __grid_constant__ CUtensorMap tmx, const __grid_constant__ CUtensorMap tmw,
    const __grid_constant__ CUtensorMap tms, const __grid_constant__ CUtensorMap tmb,
    const __nv_bfloat16* __restrict__ scale8, OT* __restrict__ out, int M, int N, int K, int gs, int bias) {
  using L = PreLayout<MODE, ST, NX>;
  using W = typename L::W;
  constexpr int R = L::R;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::kBar);
  uint64_t* empty = full + R;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.x * NX, n0 = blockIdx.y * kPreCols, nk = K / kBK, S = gridDim.z;
  const int kb = (int)((long long)blockIdx.z * nk / S), ns = (int)((long long)(blockIdx.z + 1) * nk / S) - kb;
  const int srows = gs == 32 ? 2 : 1;
  if (tid == 0) {
    for (int s = 0; s < R; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx arrival
      mbar_init(&empty[s], 8);  // one arrival per consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp < 4) {  // ---- producer warpgroup: its first thread issues every load ----
    setmaxnreg_dec<kProducerRegs>();
    if (tid == 0) {
      tma_prefetch_map(&tmx);
      tma_prefetch_map(&tmw);
      const uint32_t tx = L::kX + W::tx(srows, bias);
      for (int i = 0; i < ns; ++i) {
        const int s = i % R, k0 = (kb + i) * kBK;
        if (i >= R) mbar_wait(&empty[s], ((i / R) - 1) & 1);
        uint8_t* st = base + s * L::kStage;
        mbar_arrive_expect_tx(&full[s], tx);
        tma_load_2d(st, &tmx, k0, m0, &full[s]);
        tma_load_2d(st + L::kX, &tmw, n0, MODE == kInt4 ? k0 / 2 : k0, &full[s]);
        if constexpr (MODE == kInt4) {
          tma_load_2d(st + L::kX + W::kW, &tms, n0, k0 / gs, &full[s]);
          if (bias) tma_load_2d(st + L::kX + W::kW + W::kS, &tmb, n0, k0 / gs, &full[s]);
        }
      }
    }
    if (S > 1) {  // the split merge's two cluster barriers (consumers write, then read, the partials)
      cooperative_groups::this_cluster().sync();
      cooperative_groups::this_cluster().sync();
    }
    return;
  }

  // ---- consumers: warpgroup c owns the block's columns [64 c, 64 c + 64) ----
  // A row 16 wl + g of the warpgroup is column cg = 64c + 16wl + 2g, row
  // 16 wl + g + 8 column cg + 1: one 16-bit word of a raw row holds both.
  setmaxnreg_inc<kConsumerRegs>();
  const int c = (warp >> 2) - 1, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const int cg = 64 * c + 16 * wl + 2 * g, q = cg >> 4;  // column and its 16-byte chunk of a raw row
  uint32_t o[2];  // byte offsets in a raw row: int4 rows 8ks + t4 (+4); int8 rows 16ks + 2t4 + e (+8)
#pragma unroll
  for (int e = 0; e < 2; ++e) o[e] = ((q ^ (MODE == kInt4 ? (t4 ^ (4 * e)) : ((2 * t4 + e) & 7))) << 4) + (cg & 15);
  float acc[NX / 2];
#pragma unroll
  for (int e = 0; e < NX / 2; ++e) acc[e] = 0.f;
  uint32_t af[kPending + 1][4][4];  // A fragments of a stage (4 k16 steps), one set a stage in flight
  for (int i0 = 0; i0 < ns; i0 += kPending + 1) {
#pragma unroll
    for (int hs = 0; hs <= kPending; ++hs) {  // the stage's A set: compile-time after unrolling
      const int i = i0 + hs;
      if (i >= ns) break;
      uint32_t(&a)[4][4] = af[hs];
      const int s = i % R;
      mbar_wait(&full[s], (i / R) & 1);
      const uint8_t* wst = base + s * L::kStage + L::kX;
      if constexpr (MODE == kInt4) {
        // scale (bias) pairs of columns cg (rows g) and cg + 1 (rows g + 8), group rows 0 and srows - 1
        uint32_t sg[2][2], bg[2][2] = {};
        const ST* sp = reinterpret_cast<const ST*>(wst + W::kW) + cg;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          scale_pairs2(sp + r * (srows - 1) * kPreCols, sg[r]);
          if (bias) scale_pairs2(sp + W::kS / (int)sizeof(ST) + r * (srows - 1) * kPreCols, bg[r]);
        }
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint32_t h0 = *reinterpret_cast<const uint16_t*>(wst + (8 * ks + t4) * 128 + o[0]);
          const uint32_t h1 = *reinterpret_cast<const uint16_t*>(wst + (8 * ks + t4 + 4) * 128 + o[1]);
          const uint32_t lo0 = (h0 & 0x0F0Fu) ^ 0x0808u, hi0 = ((h0 >> 4) & 0x0F0Fu) ^ 0x0808u;
          const uint32_t lo1 = (h1 & 0x0F0Fu) ^ 0x0808u, hi1 = ((h1 >> 4) & 0x0F0Fu) ^ 0x0808u;
          const int gr = (srows == 2 && ks >= 2) ? 1 : 0;
          a[ks][0] = dq4(lo0, hi0, 0, sg[gr][0], bg[gr][0], bias);
          a[ks][1] = dq4(lo0, hi0, 1, sg[gr][1], bg[gr][1], bias);
          a[ks][2] = dq4(lo1, hi1, 0, sg[gr][0], bg[gr][0], bias);
          a[ks][3] = dq4(lo1, hi1, 1, sg[gr][1], bg[gr][1], bias);
        }
      } else {
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) {
          const uint8_t* r0 = wst + (16 * ks + 2 * t4) * 128;
          const uint32_t h00 = *reinterpret_cast<const uint16_t*>(r0 + o[0]);
          const uint32_t h01 = *reinterpret_cast<const uint16_t*>(r0 + 128 + o[1]);
          const uint32_t h10 = *reinterpret_cast<const uint16_t*>(r0 + 8 * 128 + o[0]);
          const uint32_t h11 = *reinterpret_cast<const uint16_t*>(r0 + 9 * 128 + o[1]);
          a[ks][0] = i8_pair(h00, h01, 0);
          a[ks][1] = i8_pair(h00, h01, 1);
          a[ks][2] = i8_pair(h10, h11, 0);
          a[ks][3] = i8_pair(h10, h11, 1);
        }
      }
      const uint32_t xa = smem_u32(base + s * L::kStage);
      fence_regs(acc);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) fence_regs_u32(a[ks]);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t db = sw128_desc(xa + ks * 32);
        if constexpr (NX == 256) {
          wgmma_m64n256k16_rs(acc, a[ks], db);
        } else {
          wgmma_m64n128k16_rs(acc, a[ks], db);
        }
      }
      wgmma_commit();
      wgmma_wait<kPending>();  // stage i - kPending's products are done: its A registers and its stage are free
      fence_regs(acc);
#pragma unroll
      for (int h = 0; h <= kPending; ++h)
#pragma unroll
        for (int ks = 0; ks < 4; ++ks) fence_regs_u32(af[h][ks]);
      if (i >= kPending && lane == 0) mbar_arrive(&empty[(i - kPending) % R]);
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);

  // acc[4j] / [4j + 1]: column cg at x rows 8j + 2t4 / + 1; acc[4j + 2] / [4j + 3]: column cg + 1.
  // N is a multiple of 16: a column pair is whole or gone.
  if (S == 1) {
    const int n = n0 + cg;
    if (n >= N) return;
#pragma unroll
    for (int j = 0; j < NX / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int m = m0 + 8 * j + 2 * t4 + e;
        if (m < M)
          store2<OT>(out + (size_t)m * N + n, finish<MODE, OT>(acc[4 * j + e], scale8, n),
                     finish<MODE, OT>(acc[4 * j + 2 + e], scale8, n + 1));
      }
    }
    return;
  }
  // K splits: each leaves its f32 partial [NX rows][kPreCols] over its ring
  // (every load landed and every product read its stage), and every rank
  // sums a slice of the tile over the ranks' partials in rank order.
  named_bar_sync(1, 256);  // both consumer warpgroups are done with the ring
  float* part = reinterpret_cast<float*>(base);
#pragma unroll
  for (int j = 0; j < NX / 8; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      *reinterpret_cast<float2*>(part + (8 * j + 2 * t4 + e) * kPreCols + cg) =
          make_float2(acc[4 * j + e], acc[4 * j + 2 + e]);
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  cluster.sync();
  const int items = min(NX, M - m0) * (kPreCols / 4), per = (items + S - 1) / S;
  const int lo = (int)cluster.block_rank() * per, hi = min(items, lo + per);
  for (int e = lo + tid - 128; e < hi; e += 256) {
    const int m = e / (kPreCols / 4), c4 = (e % (kPreCols / 4)) * 4, n = n0 + c4;
    if (n >= N) continue;
    const float4 v = sum_ranks(cluster, part, m * kPreCols + c4, S);
    const float o[4] = {finish<MODE, OT>(v.x, scale8, n), finish<MODE, OT>(v.y, scale8, n + 1),
                        finish<MODE, OT>(v.z, scale8, n + 2), finish<MODE, OT>(v.w, scale8, n + 3)};
    store4<OT>(out + (size_t)(m0 + m) * N + n, o);
  }
  cluster.sync();  // no rank leaves while another reads its partial
}

// ---------------------------------------------------------------------------
// Launch.

struct Args {
  const void *x, *qw, *scale, *qbias;
  void* out;
  int M, N, K, gs;
};

// Raises a kernel's dynamic shared-memory limit once to the largest size
// asked for, so a launch captured into a CUDA graph after a warm-up call
// makes no attribute call.
template <typename Kern>
cudaError_t allow_smem(Kern kern, size_t smem, size_t& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e == cudaSuccess) allowed = smem;
  return e;
}

// The tensor maps of a launch: x as 64-column bf16 boxes of `x_rows` rows
// into the swizzle, the raw weight as 128-byte boxes of a stage's rows into
// the swizzle, int4 scales (and biases) as boxes of `bn` columns by a
// stage's group rows. A map the driver refuses is an error.
template <int MODE, typename ST, int BN>
bool make_maps(const Args& a, int x_rows, int bn, CUtensorMap* tmx, CUtensorMap* tmw, CUtensorMap* tms,
               CUtensorMap* tmb) {
  using W = WStage<MODE, ST, BN>;
  if (!encode_map(tmx, a.x, a.M, a.K, false, 64, x_rows)) return false;
  if (!encode_tiled(tmw, a.qw, MODE == kInt4 ? a.K / 2 : a.K, a.N, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, 128, W::kRows,
                    CU_TENSOR_MAP_SWIZZLE_128B))
    return false;
  if constexpr (MODE == kInt4) {
    const CUtensorMapDataType dt =
        std::is_same<ST, float>::value ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
    const int srows = a.gs == 32 ? 2 : 1;
    if (!encode_tiled(tms, a.scale, a.K / a.gs, a.N, dt, (int)sizeof(ST), bn, srows, CU_TENSOR_MAP_SWIZZLE_NONE))
      return false;
    if (a.qbias && !encode_tiled(tmb, a.qbias, a.K / a.gs, a.N, dt, (int)sizeof(ST), bn, srows,
                                 CU_TENSOR_MAP_SWIZZLE_NONE))
      return false;
  }
  return true;
}

template <int MODE, typename ST, typename OT, int MT>
cudaError_t launch_decode(const Args& a, int splits, cudaStream_t st) {
  using L = DecLayout<MODE, ST, MT>;
  static size_t allowed = 48 * 1024;
  CUtensorMap tmx{}, tmw{}, tms{}, tmb{};
  if (!make_maps<MODE, ST, kDecBN>(a, L::MP, kDecBN, &tmx, &tmw, &tms, &tmb)) return cudaErrorNotSupported;
  int spc = 0, slots = 0;
  x_chunks(L::MP, a.K, splits, spc, slots);
  auto kern = qmm_decode_kernel<MODE, ST, OT, MT>;
  cudaLaunchAttribute cluster{};  // the splits of a column tile are one cluster (x: the split)
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = splits;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3(splits, (a.N + kDecBN - 1) / kDecBN, 1);
  cfg.blockDim = dim3(L::kThreads);
  cfg.dynamicSmemBytes = L::bytes(spc, slots, splits);
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  cudaError_t e = allow_smem(kern, cfg.dynamicSmemBytes, allowed);
  if (e != cudaSuccess) return e;
  e = cudaLaunchKernelEx(&cfg, kern, tmx, tmw, tms, tmb, static_cast<const __nv_bfloat16*>(a.scale),
                         static_cast<OT*>(a.out), a.M, a.N, a.K, a.gs, a.qbias != nullptr ? 1 : 0, spc, slots);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int MODE, typename ST, typename OT, int NX>
cudaError_t launch_prefill(const Args& a, int splits, cudaStream_t st) {
  using L = PreLayout<MODE, ST, NX>;
  static size_t allowed = 48 * 1024;
  CUtensorMap tmx{}, tmw{}, tms{}, tmb{};
  if (!make_maps<MODE, ST, kPreCols>(a, NX, kPreCols, &tmx, &tmw, &tms, &tmb)) return cudaErrorNotSupported;
  auto kern = qmm_prefill_kernel<MODE, ST, OT, NX>;
  cudaError_t e = allow_smem(kern, L::kBytes, allowed);
  if (e != cudaSuccess) return e;
  cudaLaunchAttribute cluster{};  // the splits of a tile are one cluster (z: the split)
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = 1;
  cluster.val.clusterDim.y = 1;
  cluster.val.clusterDim.z = splits;
  cudaLaunchConfig_t cfg{};
  cfg.gridDim = dim3((a.M + NX - 1) / NX, (a.N + kPreCols - 1) / kPreCols, splits);
  cfg.blockDim = dim3(kPreThreads);
  cfg.dynamicSmemBytes = L::kBytes;
  cfg.stream = st;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, tmx, tmw, tms, tmb, static_cast<const __nv_bfloat16*>(a.scale),
                         static_cast<OT*>(a.out), a.M, a.N, a.K, a.gs, a.qbias != nullptr ? 1 : 0);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

template <int MODE, typename ST, typename OT>
cudaError_t dispatch_form(const Args& a, int form, int param, int splits, cudaStream_t st) {
  if (form == kDecode) {
    switch (param) {
      case 1: return launch_decode<MODE, ST, OT, 1>(a, splits, st);
      case 2: return launch_decode<MODE, ST, OT, 2>(a, splits, st);
      default: return cudaErrorInvalidValue;
    }
  }
  if (form == kPrefill) {
    switch (param) {
      case 128: return launch_prefill<MODE, ST, OT, 128>(a, splits, st);
      case 256: return launch_prefill<MODE, ST, OT, 256>(a, splits, st);
      default: return cudaErrorInvalidValue;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// y = x @ W on `stream` (ops/quant_matmul.py holds the contract and the plan).
// mode 0 = int8 (per-column bf16 scale), 1 = int4 (group scales and optional
// bias, bf16 or f32); dtype codes 0 = float32, 1 = bfloat16. `form` 0 runs
// the decode form (M <= 8 * param rows, param 1 or 2 n8 tiles), 1 the
// prefill form (param = a block's x rows, 128 or 256); both cut K into
// `splits` (1..8) blocks of one cluster. Returns the CUDA error code (0 =
// launched). No synchronisation, no allocation.
extern "C" int dyn_quant_matmul(const void* x, const void* qw, const void* scale, const void* qbias, void* out, int M,
                                int N, int K, int mode, int group_size, int scale_dtype, int out_dtype, int form,
                                int param, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N % 16 || K % kBK || K < kBK || splits < 1 || splits > kMaxSplits || splits > K / kBK)
    return (int)cudaErrorInvalidValue;
  if (form == kDecode && M > 8 * param) return (int)cudaErrorInvalidValue;
  if (mode == kInt4 && (group_size % 32 || (group_size < kBK ? kBK % group_size : group_size % kBK) ||
                        K % group_size))
    return (int)cudaErrorInvalidValue;
  if (mode == kInt8 && qbias != nullptr) return (int)cudaErrorInvalidValue;
  const Args a{x, qw, scale, qbias, out, M, N, K, mode == kInt4 ? group_size : kBK};
#define DYN_QMM_CASE(MODE, SC, OC, ST, OT)                    \
  if (mode == MODE && scale_dtype == SC && out_dtype == OC) \
    return (int)dispatch_form<MODE, ST, OT>(a, form, param, splits, st);
  DYN_QMM_CASE(kInt8, 1, 1, __nv_bfloat16, __nv_bfloat16)
  DYN_QMM_CASE(kInt8, 1, 0, __nv_bfloat16, float)
  DYN_QMM_CASE(kInt4, 1, 1, __nv_bfloat16, __nv_bfloat16)
  DYN_QMM_CASE(kInt4, 1, 0, __nv_bfloat16, float)
  DYN_QMM_CASE(kInt4, 0, 1, float, __nv_bfloat16)
  DYN_QMM_CASE(kInt4, 0, 0, float, float)
#undef DYN_QMM_CASE
  return (int)cudaErrorInvalidValue;
}
