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
//   (bf16 or f32 leaves; GGUF imports keep f32). The f32 accumulator is rounded
//   to the output dtype.
//
// Bound: weight bytes at decode (M of a few rows: K*N or K*N/2 bytes against
// 2*M*N*K operations), operations at prefill (2*M*N*K at M in the hundreds or
// thousands of rows, above the card's ~295 operations a byte). The design:
// - Tensor cores at every M (mma.sync m16n8k16, bf16 in, f32 accumulate). The
//   raw weight tile is staged with cp.async (16 bytes a thread) into shared
//   memory and dequantized straight into mma B fragments in registers: never
//   into device memory, and never a second time into shared memory. A lane's
//   four n8 tiles take the columns 4g..4g+3 of its 32-column slab (g = lane / 4),
//   so each fragment row it needs is one 32-bit word: for int4 the two
//   nibbles of one byte are exactly the fragment's (k, k+1) pair; int8 bytes go
//   through an exact f32 magic-number conversion. The permuted columns come
//   back as eight consecutive outputs per lane and row (16-byte stores).
// - A block is 4 warps, each owning every row of a 32-column slab, so each
//   weight element is dequantized once a block; a stage's group scales are read
//   once into bf16 pairs in registers.
// - Decode: M <= 16 runs 16-row blocks with a 4-stage ring, so a block keeps
//   three tiles in flight; the K range is split across blocks until the grid
//   holds about two blocks an SM (four for int4, whose tiles are half the
//   bytes). The split is deterministic: each split writes f32 partials to a
//   workspace that the caller allocates, and a second kernel sums them in
//   split order (no atomics), so a CUDA-graph replay and an eager launch give
//   the same bits.
// - Verify rows and prefill: 64-row blocks (4 stages) and 128-row blocks (3
//   stages); each dequantized B fragment feeds 4 or 8 mma.
// wgmma, TMA and a persistent schedule are later work (PERF.md).

#include <algorithm>

#include "common.cuh"

namespace {

constexpr int kBN = 128;  // output columns per block: 4 warps of 32
constexpr int kBK = 64;   // K per stage: two GGUF groups of 32, half a default group of 128
constexpr int kAStride = kBK + 8;  // bf16 elements a staged x row: 144 bytes, ldmatrix without bank conflicts

enum Mode { kInt8 = 0, kInt4 = 1 };

// A block is 4 warps side by side, each owning all BM rows of a 32-column
// slab: every weight element is dequantized once a block.
template <int BM_, int STAGES_>
struct Cfg {
  static constexpr int BM = BM_, STAGES = STAGES_, MI = BM / 16;
  static constexpr int kThreads = 128;
};
using Small = Cfg<16, 4>;   // decode rows
using Mid = Cfg<64, 4>;     // verify rows, small batches
using Large = Cfg<128, 3>;  // prefill chunks and mixed steps

// Shared-memory stage: the x tile, the raw weight tile and (int4) the scale and
// bias rows of the groups the stage spans. Weight rows are padded so the four
// (int4: consecutive, int8: every other) rows a warp's fragment loads touch
// 8-bank-apart words.
template <class C, int MODE, typename ST>
struct Stage {
  static constexpr int kWRows = MODE == kInt4 ? kBK / 2 : kBK;
  static constexpr int kWStride = kBN + (MODE == kInt4 ? 32 : 16);  // bytes
  static constexpr int kGroupRows = MODE == kInt4 ? kBK / 32 : 0;   // at most 2 groups (group size 32)
  static constexpr int kA = C::BM * kAStride * 2;
  static constexpr int kW = kWRows * kWStride;
  static constexpr int kS = kGroupRows * kBN * (int)sizeof(ST);
  static constexpr int kBytes = kA + kW + 2 * kS;
};

__device__ __forceinline__ uint32_t ld_u32(const uint8_t* p) { return *reinterpret_cast<const uint32_t*>(p); }

// The four scales (or biases) at p, p + 1, p + 2, p + 3 as bf16 pairs, each
// value in both halves. An f32 leaf is rounded to bf16 first, as the JAX
// expression casts it to the activation dtype.
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

// One int4 B-fragment register: byte j of the (nibble ^ 8) words lo / hi, i.e.
// elements (2i, 2i+1) of column j, as bf16 q values, then scaled (and biased),
// each step rounded to bf16 as the JAX expression rounds it.
__device__ __forceinline__ uint32_t dq4(uint32_t lo, uint32_t hi, int j, uint32_t s2, uint32_t b2, bool bias) {
  // bytes [lo_j, 0x43, hi_j, 0x43]: bf16 halves 128 + (q + 8), exact
  const uint32_t y = __byte_perm(lo, hi, (uint32_t)j | ((uint32_t)(4 + j) << 4));
  uint32_t x = __byte_perm(y, 0x43434343u, 0x4140);
  __nv_bfloat162 v = *reinterpret_cast<__nv_bfloat162*>(&x);
  v = __hsub2(v, __float2bfloat162_rn(136.0f));                          // q, exact
  v = __hmul2_rn(v, *reinterpret_cast<const __nv_bfloat162*>(&s2));  // bf16(q * s), never fused with the add
  if (bias) v = __hadd2_rn(v, *reinterpret_cast<const __nv_bfloat162*>(&b2));  // bf16(. + b)
  return *reinterpret_cast<uint32_t*>(&v);
}

// Byte j of an int8 word (already ^ 0x80) as an exact f32: 2^23 + (q + 128) - (2^23 + 128).
__device__ __forceinline__ float i8f(uint32_t w, int j) {
  return __uint_as_float(__byte_perm(w, 0x4B000000u, 0x7540u | (uint32_t)j)) - 8388736.0f;
}

template <typename OT>
__device__ __forceinline__ float round_out(float v) {
  return std::is_same<OT, float>::value ? v : __bfloat162float(__float2bfloat16_rn(v));
}

// Eight consecutive outputs of one row.
template <typename OT>
__device__ __forceinline__ void store8(OT* p, const float* v) {
  if constexpr (std::is_same<OT, float>::value) {
    reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
    uint4 u;
    u.x = pack_bf16(v[0], v[1]);
    u.y = pack_bf16(v[2], v[3]);
    u.z = pack_bf16(v[4], v[5]);
    u.w = pack_bf16(v[6], v[7]);
    *reinterpret_cast<uint4*>(p) = u;
  }
}

// The epilogue of one output element from its f32 sum: int8 rounds, scales by
// the column's scale and rounds again; int4 rounds.
template <int MODE, typename OT>
__device__ __forceinline__ float finish(float acc, const __nv_bfloat16* __restrict__ scale, int n) {
  if constexpr (MODE == kInt8) return round_out<OT>(round_out<OT>(acc) * __bfloat162float(scale[n]));
  return round_out<OT>(acc);
}

template <class C, int MODE, typename ST, typename OT>
__global__ void __launch_bounds__(C::kThreads) quant_matmul_kernel(
    const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ qw, const ST* __restrict__ scale,
    const ST* __restrict__ qbias, OT* __restrict__ out, float* __restrict__ ws, int M, int N, int K,
    int group_size, int splits) {
  using S = Stage<C, MODE, ST>;
  extern __shared__ __align__(128) uint8_t smem[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;  // warp: the 32-column slab it owns
  const int g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * kBN, m0 = blockIdx.y * C::BM;
  const int nk = K / kBK;
  const int kb = (int)((long long)blockIdx.z * nk / splits), ke = (int)((long long)(blockIdx.z + 1) * nk / splits);
  const int nkt = ke - kb;
  const bool bias = MODE == kInt4 && qbias != nullptr;

  auto stage_ptr = [&](int st) { return smem + (size_t)st * S::kBytes; };

  auto load_stage = [&](int st, int kt) {
    uint8_t* base = stage_ptr(st);
    __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(base);
    uint8_t* Ws = base + S::kA;
    const int k0 = kt * kBK;
    for (int e = tid; e < C::BM * (kBK / 8); e += C::kThreads) {  // x: 8 bf16 a chunk
      const int r = e >> 3, c = e & 7;
      const int row = min(m0 + r, M - 1);  // rows past M read the last row; their outputs are dropped
      cp_async16(As + r * kAStride + c * 8, x + (size_t)row * K + k0 + c * 8);
    }
    const int wrow0 = MODE == kInt4 ? k0 / 2 : k0;
    for (int e = tid; e < S::kWRows * (kBN / 16); e += C::kThreads) {  // weights: 16 bytes a chunk
      const int r = e >> 3, c = e & 7;
      const int col = n0 + c * 16;
      if (col < N) cp_async16(Ws + r * S::kWStride + c * 16, qw + (size_t)(wrow0 + r) * N + col);
    }
    if constexpr (MODE == kInt4) {
      constexpr int kPer = 16 / (int)sizeof(ST);  // scale elements a chunk
      const int g0 = k0 / group_size;
      const int ng = group_size >= kBK ? 1 : kBK / group_size;
      uint8_t* Ss = Ws + S::kW;
      for (int e = tid; e < ng * (kBN / kPer); e += C::kThreads) {
        const int r = e / (kBN / kPer), c = e % (kBN / kPer);
        const int col = n0 + c * kPer;
        if (col < N) {
          const size_t off = (size_t)(g0 + r) * N + col;
          cp_async16(Ss + (r * kBN + c * kPer) * sizeof(ST), scale + off);
          if (bias) cp_async16(Ss + S::kS + (r * kBN + c * kPer) * sizeof(ST), qbias + off);
        }
      }
    }
  };

  float acc[C::MI][4][4];
#pragma unroll
  for (int i = 0; i < C::MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0.f;

  auto compute = [&](int st) {
    const uint8_t* base = stage_ptr(st);
    const __nv_bfloat16* As = reinterpret_cast<const __nv_bfloat16*>(base);
    const uint8_t* Ws = base + S::kA;
    const int col = warp * 32 + 4 * g;  // this lane's four columns in the tile (byte offset in a weight row)
    // int4: the scale (and bias) pairs of this lane's columns for the stage's
    // group rows, read once a stage: row 1 serves k16 steps 2 and 3 at group
    // size 32; any larger group spans the whole stage.
    uint32_t sc[2][4], bi[2][4];
    const bool two_groups = group_size == 32;
    if constexpr (MODE == kInt4) {
      const ST* sp = reinterpret_cast<const ST*>(Ws + S::kW) + col;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        scale_pairs(sp + (two_groups ? r : 0) * kBN, sc[r]);
        if (bias) scale_pairs(sp + S::kS / (int)sizeof(ST) + (two_groups ? r : 0) * kBN, bi[r]);
      }
    }
#pragma unroll
    for (int s = 0; s < kBK / 16; ++s) {
      uint32_t a[C::MI][4];
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
        ldmatrix_x4(a[i], As + (i * 16 + (lane & 15)) * kAStride + s * 16 + (lane >> 4) * 8);
      uint32_t b[4][2];
      if constexpr (MODE == kInt4) {
        const uint32_t w0 = ld_u32(Ws + (s * 8 + t4) * S::kWStride + col);
        const uint32_t w1 = ld_u32(Ws + (s * 8 + t4 + 4) * S::kWStride + col);
        const uint32_t lo0 = (w0 & 0x0F0F0F0Fu) ^ 0x08080808u, hi0 = ((w0 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        const uint32_t lo1 = (w1 & 0x0F0F0F0Fu) ^ 0x08080808u, hi1 = ((w1 >> 4) & 0x0F0F0F0Fu) ^ 0x08080808u;
        const bool second = s >= 2 && two_groups;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const uint32_t s2 = second ? sc[1][j] : sc[0][j];
          const uint32_t b2 = bias ? (second ? bi[1][j] : bi[0][j]) : 0u;
          b[j][0] = dq4(lo0, hi0, j, s2, b2, bias);
          b[j][1] = dq4(lo1, hi1, j, s2, b2, bias);
        }
      } else {
        const uint8_t* wr = Ws + (s * 16 + 2 * t4) * S::kWStride + col;
        const uint32_t r0 = ld_u32(wr) ^ 0x80808080u, r1 = ld_u32(wr + S::kWStride) ^ 0x80808080u;
        const uint32_t r2 = ld_u32(wr + 8 * S::kWStride) ^ 0x80808080u;
        const uint32_t r3 = ld_u32(wr + 9 * S::kWStride) ^ 0x80808080u;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          b[j][0] = pack_bf16(i8f(r0, j), i8f(r1, j));
          b[j][1] = pack_bf16(i8f(r2, j), i8f(r3, j));
        }
      }
#pragma unroll
      for (int i = 0; i < C::MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[i][j], a[i], b[j][0], b[j][1]);
    }
  };

#pragma unroll
  for (int i = 0; i < C::STAGES - 1; ++i) {
    if (i < nkt) load_stage(i, kb + i);
    cp_async_commit();
  }
  for (int i = 0; i < nkt; ++i) {
    cp_async_wait<C::STAGES - 2>();
    __syncthreads();  // tile i landed for every thread; every warp is done with tile i - 1's stage
    const int nxt = i + C::STAGES - 1;
    if (nxt < nkt) load_stage(nxt % C::STAGES, kb + nxt);
    cp_async_commit();
    compute(i % C::STAGES);
  }
  cp_async_wait<0>();

  // Lane (g, t4) holds, for rows g and g + 8 of each m16 tile, the columns
  // 8*t4 .. 8*t4 + 7 of its slab: column 8*t4 + j is tile j's c[0] (row g) /
  // c[2] (row g + 8), column 8*t4 + 4 + j its c[1] / c[3].
  const int n = n0 + warp * 32 + 8 * t4;
  if (n >= N) return;
#pragma unroll
  for (int i = 0; i < C::MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + i * 16 + g + 8 * h;
      if (m >= M) continue;
      float v[8];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j] = acc[i][j][2 * h];
        v[4 + j] = acc[i][j][2 * h + 1];
      }
      if (splits > 1) {
        float* p = ws + ((size_t)blockIdx.z * M + m) * N + n;
        reinterpret_cast<float4*>(p)[0] = make_float4(v[0], v[1], v[2], v[3]);
        reinterpret_cast<float4*>(p)[1] = make_float4(v[4], v[5], v[6], v[7]);
      } else {
#pragma unroll
        for (int o = 0; o < 8; ++o)
          v[o] = finish<MODE, OT>(v[o], reinterpret_cast<const __nv_bfloat16*>(scale), n + o);
        store8<OT>(out + (size_t)m * N + n, v);
      }
    }
  }
}

// The split-K reduction: each output's partials summed in split order, then
// the epilogue. Four outputs a thread.
template <int MODE, typename OT>
__global__ void quant_matmul_reduce(const float* __restrict__ ws, const __nv_bfloat16* __restrict__ scale,
                                    OT* __restrict__ out, int M, int N, int splits) {
  const size_t total = (size_t)M * N / 4;
  for (size_t e = blockIdx.x * (size_t)blockDim.x + threadIdx.x; e < total; e += (size_t)gridDim.x * blockDim.x) {
    float4 s = reinterpret_cast<const float4*>(ws)[e];
    for (int z = 1; z < splits; ++z) {
      const float4 p = reinterpret_cast<const float4*>(ws + (size_t)z * M * N)[e];
      s.x += p.x;
      s.y += p.y;
      s.z += p.z;
      s.w += p.w;
    }
    const int n = (int)((e * 4) % N);
    const float v[4] = {finish<MODE, OT>(s.x, scale, n), finish<MODE, OT>(s.y, scale, n + 1),
                        finish<MODE, OT>(s.z, scale, n + 2), finish<MODE, OT>(s.w, scale, n + 3)};
    if constexpr (std::is_same<OT, float>::value) {
      reinterpret_cast<float4*>(out)[e] = make_float4(v[0], v[1], v[2], v[3]);
    } else {
      reinterpret_cast<uint2*>(out)[e] = make_uint2(pack_bf16(v[0], v[1]), pack_bf16(v[2], v[3]));
    }
  }
}

template <class C, int MODE, typename ST, typename OT>
cudaError_t launch(const void* x, const void* qw, const void* scale, const void* qbias, void* out, void* ws, int M,
                   int N, int K, int group_size, int splits, cudaStream_t st) {
  constexpr int smem = Stage<C, MODE, ST>::kBytes * C::STAGES;
  auto kernel = quant_matmul_kernel<C, MODE, ST, OT>;
  static bool attr = false;  // raising the dynamic shared-memory cap once per instantiation
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return e;
    attr = true;
  }
  const dim3 grid((N + kBN - 1) / kBN, (M + C::BM - 1) / C::BM, splits);
  kernel<<<grid, C::kThreads, smem, st>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(qw), static_cast<const ST*>(scale),
      static_cast<const ST*>(qbias), static_cast<OT*>(out), static_cast<float*>(ws), M, N, K, group_size, splits);
  if (splits > 1) {
    const size_t quads = (size_t)M * N / 4;
    const int blocks = (int)std::min<size_t>((quads + 255) / 256, 132 * 8);
    quant_matmul_reduce<MODE, OT><<<blocks, 256, 0, st>>>(static_cast<const float*>(ws),
                                                         static_cast<const __nv_bfloat16*>(scale),
                                                         static_cast<OT*>(out), M, N, splits);
  }
  return cudaGetLastError();
}

template <class C>
cudaError_t dispatch(const void* x, const void* qw, const void* scale, const void* qbias, void* out, void* ws, int M,
                     int N, int K, int mode, int group_size, int scale_dtype, int out_dtype, int splits,
                     cudaStream_t st) {
#define DYN_QMM_CASE(MODE, SC, OC, ST, OT) \
  if (mode == MODE && scale_dtype == SC && out_dtype == OC) \
    return launch<C, MODE, ST, OT>(x, qw, scale, qbias, out, ws, M, N, K, group_size, splits, st);
  DYN_QMM_CASE(kInt8, 1, 1, __nv_bfloat16, __nv_bfloat16)
  DYN_QMM_CASE(kInt8, 1, 0, __nv_bfloat16, float)
  DYN_QMM_CASE(kInt4, 1, 1, __nv_bfloat16, __nv_bfloat16)
  DYN_QMM_CASE(kInt4, 1, 0, __nv_bfloat16, float)
  DYN_QMM_CASE(kInt4, 0, 1, float, __nv_bfloat16)
  DYN_QMM_CASE(kInt4, 0, 0, float, float)
#undef DYN_QMM_CASE
  return cudaErrorInvalidValue;
}

}  // namespace

// y = x @ W on `stream` (ops/quant_matmul.py holds the contract and the plan).
// mode 0 = int8 (per-column bf16 scale), 1 = int4 (group scales and optional
// bias, bf16 or f32); dtype codes 0 = float32, 1 = bfloat16. `config` picks the
// block shape (0: 16 rows, 1: 64, 2: 128) and `splits` the K split; with
// splits > 1, `ws` is a float32 workspace of splits * M * N elements. Returns
// the CUDA error code (0 = launched). No synchronisation, no allocation.
extern "C" int dyn_quant_matmul(const void* x, const void* qw, const void* scale, const void* qbias, void* out,
                                void* ws, int M, int N, int K, int mode, int group_size, int scale_dtype,
                                int out_dtype, int config, int splits, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (M < 1 || N % 16 || K % kBK || splits < 1 || splits > K / kBK || (splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  if (mode == kInt4 && (group_size % 32 || (group_size < kBK ? kBK % group_size : group_size % kBK) ||
                        K % group_size))
    return (int)cudaErrorInvalidValue;
  if (mode == kInt8 && qbias != nullptr) return (int)cudaErrorInvalidValue;
  switch (config) {
    case 0: return (int)dispatch<Small>(x, qw, scale, qbias, out, ws, M, N, K, mode, group_size, scale_dtype,
                                        out_dtype, splits, st);
    case 1: return (int)dispatch<Mid>(x, qw, scale, qbias, out, ws, M, N, K, mode, group_size, scale_dtype,
                                      out_dtype, splits, st);
    case 2: return (int)dispatch<Large>(x, qw, scale, qbias, out, ws, M, N, K, mode, group_size, scale_dtype,
                                        out_dtype, splits, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
