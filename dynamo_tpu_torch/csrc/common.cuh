// Shared helpers of the port's hand-written attention kernels (sm_90a).
//
// Dtype codes passed across the plain-C interface (ops/build.py DTYPE_CODES):
//   0 = float32, 1 = bfloat16.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
