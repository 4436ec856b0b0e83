// Shared helpers of the port's hand-written attention kernels (sm_90a).
//
// Dtype codes passed across the plain-C interface (ops/build.py DTYPE_CODES):
//   0 = float32, 1 = bfloat16, 2 = float8_e4m3fn (KV caches only).
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

// Large-but-finite mask value: avoids NaN from (-inf) - (-inf) (ops/attention.py NEG_INF).
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) { return __float2bfloat16(x); }

// One 16-byte vector of cache elements, unpacked to floats (both conversions exact).
template <typename T>
struct CacheVec;

template <>
struct CacheVec<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct CacheVec<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* f) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 x = __bfloat1622float2(h[i]);
      f[2 * i] = x.x;
      f[2 * i + 1] = x.y;
    }
  }
};

// Asynchronous 16-byte global -> shared copies (cp.async, bypassing L1 and
// registers): issued, grouped by commit, and waited for by group count.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Cache row of key position kpos: page ids staged in shared memory (pids[i]
// is the table's entry first_page + i), lookups clamped to the row's last
// used page. Callers branch once on `pow2` and call row<true> (every serving
// configuration: shifts) or row<false> (a division), so the copy loops of
// the power-of-two path hold no division.
struct PageWalk {
  int ps, last_page, first_page, sh;
  bool pow2;
  __device__ __forceinline__ PageWalk(int ps_, int last_page_, int first_page_ = 0)
      : ps(ps_), last_page(last_page_), first_page(first_page_), sh(0), pow2((ps_ & (ps_ - 1)) == 0) {
    while ((1 << sh) < ps) ++sh;
  }
  template <bool POW2>
  __device__ __forceinline__ size_t row(const int* pids, int kpos) const {
    const int idx = POW2 ? kpos >> sh : kpos / ps;
    const int off = POW2 ? kpos & (ps - 1) : kpos - idx * ps;
    return (size_t)pids[min(idx, last_page) - first_page] * ps + off;
  }
};
template <bool V>
using Bool = std::integral_constant<bool, V>;

// Start copying the head strip [kvh*HD, (kvh+1)*HD) of KT consecutive key
// positions from k0 out of the paged caches [P, ps, W] into shared memory,
// K rows `kstride` and V rows `vstride` elements apart (16 bytes of pad past
// HD keep the kernels' row reads free of bank conflicts). The copies are
// cp.async: the caller commits them and waits before reading.
// Page lookups clamp to the row's last used page (and the table width), so
// a -1 sentinel in a table tail is never dereferenced; the clamped tokens
// are masked by position in the caller.
template <typename CT, int HD, int NT, int KT>
__device__ __forceinline__ void load_kv_tile(
    const CT* __restrict__ kc, const CT* __restrict__ vc, const int* __restrict__ trow,
    CT* ks, CT* vs, int kstride, int vstride, int k0, int last_page, int ps, int W, int kvh) {
  constexpr int VEC = CacheVec<CT>::N;
  constexpr int VPT = HD / VEC;
#pragma unroll
  for (int e = threadIdx.x; e < KT * VPT; e += NT) {
    const int j = e / VPT, c = e - j * VPT;
    const int kpos = k0 + j;
    const int page = trow[min(kpos / ps, last_page)];
    const size_t off = ((size_t)page * ps + (kpos % ps)) * W + (size_t)kvh * HD + c * VEC;
    cp_async16(ks + j * kstride + c * VEC, kc + off);
    cp_async16(vs + j * vstride + c * VEC, vc + off);
  }
}

// ---------------------------------------------------------------------------
// Warp-level tensor-core helpers (mma.sync m16n8k16, bf16 in, f32 accumulate).
// Fragment layouts (lane = 4 * g + t4): A rows g / g+8, columns 2*t4 (+1)
// and 2*t4+8 (+1); B column g, rows 2*t4 (+1) and 2*t4+8 (+1); C rows g
// (c[0], c[1]) and g+8 (c[2], c[3]), columns 2*t4 and 2*t4+1.

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, "
      "{%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats rounded to bf16 (round to nearest even), packed low-first.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// 2**x in one SFU instruction (ex2.approx.ftz: ~2 ulp, 2**-inf = 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) { return *reinterpret_cast<const uint32_t*>(p); }

// Four 8x8 bf16 matrices from shared memory; lane l gives the address of row
// l % 8 of matrix l / 8. Plain: r[i] holds matrix i's (row g, columns
// 2*t4, 2*t4+1); .trans: its (rows 2*t4, 2*t4+1, column g).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* row_addr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* row_addr) {
  const unsigned a = static_cast<unsigned>(__cvta_generic_to_shared(row_addr));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(a));
}

// Eight consecutive elements (16 or 32 bytes, 16-byte aligned) as floats.
template <typename T>
__device__ __forceinline__ void load8(const T* p, float* f) {
#pragma unroll
  for (int i = 0; i < 8; i += CacheVec<T>::N) CacheVec<T>::unpack(*reinterpret_cast<const uint4*>(p + i), f + i);
}

// The 128-byte swizzle of a row-major bf16 tile whose rows are 64 elements
// (128 bytes): 16-byte chunk c of row r sits at chunk c ^ (r % 8), so the
// eight rows of an 8x8 matrix load from eight different bank groups. Wider
// rows (HD 128) swizzle within each 128-byte half. Returns the element
// offset of chunk c within its row.
__device__ __forceinline__ int swz128(int c, int r) { return ((c & ~7) | ((c ^ r) & 7)) * 8; }

// Eight e4m3 codes (8 bytes) as eight bf16 values (16 bytes), in order. Exact
// for all 256 codes: e4m3 -> f16 (cvt.rn.f16x2.e4m3x2) loses nothing, and
// every e4m3 value (NaN included) is a bf16 value. The fp8 forms of the
// kernels land fp8 tiles at 1 byte an element and convert them on chip with
// this, then run their bf16 matrix path on the converted tile, as the TPU
// kernels upcast fp8 K/V to bf16 before their matmuls. (A form on the
// integer and bf16 units instead, a bf16 multiply by 2^120 of the shifted
// code, measured slower in every kernel on an H100: PERF.md §6.)
__device__ __forceinline__ uint4 fp8x8_to_bf16x8(uint2 v) {
  uint32_t o[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const uint32_t w = i < 2 ? v.x : v.y;
    const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2((__nv_fp8x2_storage_t)(w >> (16 * (i & 1))), __NV_E4M3);
    const float2 f = __half22float2(__half2(h));
    o[i] = pack_bf16(f.x, f.y);
  }
  return make_uint4(o[0], o[1], o[2], o[3]);
}
