// Hopper-only building blocks (sm_90a): warpgroup matrix multiply (wgmma),
// its shared-memory matrix descriptors, mbarriers and proxy fences, thread
// block clusters, and the fp8 forms' tile conversion and share groups.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums (types only: nothing links libcuda)

#include <map>
#include <mutex>
#include <numeric>
#include <tuple>

#include "common.cuh"

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarriers -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// An arrive-on that fires once every cp.async this thread issued before it
// has landed (the barrier's count includes it: .noinc).
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// The next phase of `bar` also waits for `bytes` of asynchronous copies.
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

// ---- thread block clusters -------------------------------------------------

// This block's rank in its cluster.
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// Every thread of every block of the cluster meets here (release / acquire
// at cluster scope); also a barrier over this block's threads.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release;\nbarrier.cluster.wait.acquire;\n" ::: "memory");
}
// The shared::cluster address of the same shared-memory location in the
// block of rank `rank` (addr: a shared::cta address of this block).
__device__ __forceinline__ uint32_t mapa(uint32_t addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}
// Arrive on an mbarrier of any block of the cluster (a shared::cluster
// address), releasing this thread's earlier writes at cluster scope.
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
// mbar_wait for a phase completed by other blocks of the cluster (remote
// arrivals, bulk-copy transactions): acquire at cluster scope.
__device__ __forceinline__ void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAITC:\n"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAITC;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// ---- TMA ---------------------------------------------------------------------

// One box of the 2D tensor map at (column c0, row c1) into shared memory,
// completing `bytes` of `bar`'s transaction count.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(
          smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_u32(bar))
      : "memory");
}

// Start fetching a tensor map's descriptor, so the first load that uses it
// does not wait for it.
__device__ __forceinline__ void tma_prefetch_map(const CUtensorMap* map) {
  asm volatile("prefetch.tensormap [%0];\n" ::"l"(reinterpret_cast<uint64_t>(map)) : "memory");
}

// A row-major 2D tensor [rows, cols] of `dtype` elements (`elem_bytes`
// each) as a tensor map with boxes of `box_rows` rows x `box_cols`
// elements landing in the `swizzle` layout. cuTensorMapEncodeTiled comes
// through the runtime's driver entry point, so nothing links libcuda. The
// map is a pure function of the arguments, and a serving step asks for the
// same few (each layer's K and V, each layer's weights) on every launch, so
// encoded maps are kept and reused. Returns false when the driver has no
// such entry or refuses the map.
inline bool encode_tiled(CUtensorMap* map, const void* base, long long rows, long long cols,
                         CUtensorMapDataType dtype, int elem_bytes, int box_cols, int box_rows,
                         CUtensorMapSwizzle swizzle) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                              const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                              CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return static_cast<Encode>(nullptr);
    return reinterpret_cast<Encode>(fn);
  }();
  using Key = std::tuple<const void*, long long, long long, int, int, int, int>;
  static std::mutex mu;
  static std::map<Key, CUtensorMap> kept;
  const Key key{base, rows, cols, (int)dtype, box_cols, box_rows, (int)swizzle};
  std::lock_guard<std::mutex> lock(mu);
  const auto it = kept.find(key);
  if (it != kept.end()) {
    *map = it->second;
    return true;
  }
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  if (encode(map, dtype, 2, const_cast<void*>(base), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (kept.size() >= 1024) kept.clear();  // tensors reallocated many times over: start afresh
  kept.emplace(key, *map);
  return true;
}

// A row-major 2D tensor [rows, W] as a tensor map (encode_tiled), boxes of
// `box_rows` rows x `box_cols` elements: bf16 boxes of 64 columns (128
// bytes) landing in the 128-byte-swizzled layout, or fp8 boxes (read as
// bytes) of up to 256 columns landing unswizzled, rows packed.
inline bool encode_map(CUtensorMap* map, const void* base, long long rows, int W, bool fp8, int box_cols,
                       int box_rows) {
  return encode_tiled(map, base, rows, W, fp8 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                      fp8 ? 1 : (int)sizeof(__nv_bfloat16), box_cols, box_rows,
                      fp8 ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
}

// A paged bf16 cache [P, ps, W] as P*ps rows of W elements, 64-column boxes
// into the 128-byte swizzle (see encode_map).
inline bool encode_cache_map(CUtensorMap* map, const void* base, long long rows, int W, int box_rows) {
  return encode_map(map, base, rows, W, false, 64, box_rows);
}

// Rows per TMA box of a key walk in `span`-key pieces over pages of ps
// tokens: every box lies in one page and lands 1024-byte aligned (8 rows of
// 128 bytes), or 0 when the page size allows no such box (the kernels then
// copy with cp.async).
inline int tma_box_rows(int ps, int span) {
  const int r = std::gcd(ps, span);
  return r >= 8 ? r : 0;
}

// The same for unswizzled fp8 boxes `box_bytes` wide that land packed: every
// box (box_rows whole rows of one page) must start 128 bytes aligned, so
// box_rows * box_bytes must be a multiple of 128; 0 (cp.async) otherwise.
inline int tma_box_rows_fp8(int ps, int span, int box_bytes) {
  const int r = std::gcd(ps, span);
  return (r * box_bytes) % 128 == 0 ? r : 0;
}

// Shared-memory writes of the generic proxy (st.shared, cp.async) made
// visible to the async proxy (wgmma operand reads).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Barrier `id` (1..15) over the first `count` threads of the block.
__device__ __forceinline__ void named_bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ---- fp8 key tiles ------------------------------------------------------------
//
// The fp8 forms of the wgmma kernels read e4m3 tiles and convert them on
// chip (fp8x8_to_bf16x8, exact) into the bf16 ring their wgmma descriptors
// read, in the 128-byte swizzle: 16-byte bf16 chunk k of a 128-byte atom
// row r sits in slot k ^ (r % 8). Two ways in:
// - paged_mla (no room beside its 64-key bf16 stages) converts in place: a
//   16-byte fp8 chunk (16 values, bf16 chunks 2q and 2q + 1 of its atom
//   row) lands by cp.async in slot x = 2q ^ (r % 8), its own, and is
//   converted there into slots x and x ^ 1.
// - paged_prefill lands whole fp8 tiles by TMA in an fp8 ring of its own
//   and converts each 16-byte chunk into its two slots of the bf16 stage.
// paged_mla's row tiles that walk the same keys form a share group (a
// thread block cluster): each rank converts only its 1/n of every tile (a
// run of whole key rows) into its own stage, then copies those rows into
// the same stage of every other rank that consumes the tile (cp.async.bulk
// shared::cta -> shared::cluster), completing the bytes on that rank's full
// mbarrier.

// Waits until at most n (0..3) of this thread's cp.async groups are pending.
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0) {
    cp_async_wait<0>();
  } else if (n == 1) {
    cp_async_wait<1>();
  } else if (n == 2) {
    cp_async_wait<2>();
  } else {
    cp_async_wait<3>();
  }
}

__device__ __forceinline__ uint4 ld_shared16(uint32_t a) {
  uint4 v;
  asm volatile("ld.shared.v4.b32 {%0, %1, %2, %3}, [%4];\n" : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "r"(a)
               : "memory");
  return v;
}
__device__ __forceinline__ void st_shared16(uint32_t a, const uint4& v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(a), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

// The landed 16-byte fp8 chunk in slot x of the 128-byte atom row at
// shared address `row`, converted in place into slots x and x ^ 1.
__device__ __forceinline__ void f8_convert_in_place(uint32_t row, int x) {
  const uint32_t a = row + (x << 4);
  const uint4 v = ld_shared16(a);
  st_shared16(a, fp8x8_to_bf16x8(make_uint2(v.x, v.y)));
  st_shared16(a ^ 16, fp8x8_to_bf16x8(make_uint2(v.z, v.w)));
}

// `bytes` (a multiple of 16) from this block's shared memory to a block of
// the cluster (dst and bar: shared::cluster addresses), completing them on
// the mbarrier `bar` there.
__device__ __forceinline__ void bulk_to_cluster(uint32_t dst, uint32_t src, uint32_t bytes, uint32_t bar) {
  asm volatile("cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(dst),
               "r"(src), "r"(bytes), "r"(bar)
               : "memory");
}

// Publishes a converted tile (stage at shared::cta address `stage`, full
// mbarrier `full`, one arrival a phase) once every producer thread has
// converted its chunks, fenced them for the async proxy and met the others
// at a named barrier; called by the producer warpgroup's threads (ptid of
// 128). Alone (consumers == 0): thread 0 arrives. In a share group: the
// first warp copies the share's `nreg` regions (offset off(r), `bytes`
// each) to every other consumer, and a consuming rank's thread 0 arms its
// own full mbarrier with the bytes the other ranks deliver.
struct F8Share {
  uint32_t consumers;  // ranks (bit k) that consume the group's tiles; 0: this block alone
  uint32_t rank;
  int share;
  template <typename Off>
  __device__ __forceinline__ void publish(uint32_t stage, uint64_t* full, int nreg, uint32_t bytes, Off off,
                                          int ptid) const {
    if (ptid >= 32) return;
    if (consumers == 0) {
      if (ptid == 0) mbar_arrive(full);
      return;
    }
    const uint32_t bar = smem_u32(full);
    for (uint32_t m = consumers & ~(1u << rank); m; m &= m - 1) {
      const uint32_t k = __ffs(m) - 1;
      for (int r = ptid; r < nreg; r += 32) bulk_to_cluster(mapa(stage + off(r), k), stage + off(r), bytes, mapa(bar, k));
    }
    if (ptid == 0 && (consumers >> rank & 1)) mbar_arrive_expect_tx(full, (uint32_t)(share - 1) * nreg * bytes);
  }
};

// ---- wgmma -----------------------------------------------------------------

// Descriptor of a bf16 operand tile in the 128-byte-swizzled layout: rows of
// 64 elements (128 bytes), eight-row groups 1024 bytes apart, the tile
// 1024-byte aligned (so the base offset is 0). Both the K-major form (Q, K:
// the contraction runs along a row) and the MN-major form (V: along the
// rows) read the eight-row group stride; neither spans a second 64-element
// atom in its other extent here, so both offset fields carry 1024 bytes.
__device__ __forceinline__ uint64_t sw128_desc(uint32_t saddr) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)64 << 16) | ((uint64_t)64 << 32) | (1ull << 62);
}

// The same layout read MN-major across several 64-element atoms (the MN
// extent of the product spans more than one): the leading-byte-offset field
// carries the atom-to-atom stride `atom_bytes` of the tile the TMA boxes (or
// the swizzled copies) land in, the stride field the eight-row group stride
// along K (1024 bytes). sw128_desc's single-atom operands need no atom stride.
__device__ __forceinline__ uint64_t sw128_desc_mn(uint32_t saddr, uint32_t atom_bytes) {
  return (uint64_t)((saddr & 0x3FFFF) >> 4) | ((uint64_t)((atom_bytes >> 4) & 0x3FFF) << 16) | ((uint64_t)64 << 32) |
         (1ull << 62);
}

// Hand registers between the warpgroups of a block: a warpgroup lowers its
// per-thread count to N (dec) or raises it to N (inc, waiting until another
// warpgroup has released enough). Executed by all threads of the warpgroup.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Pins accumulator registers at this point of the program: their reads and
// writes are not moved across the wgmma issue / wait around it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Accumulator layout of wgmma m64nNk16 (f32): warp w of the warpgroup holds
// rows 16w + g (d[4j], d[4j+1]) and 16w + g + 8 (d[4j+2], d[4j+3]) at
// columns 8j + 2*t4 (+1).

#define DYN_WG_D32                                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}"
#define DYN_WG_OUT32(d)                                                                                   \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),        \
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),           \
      "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]),         \
      "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]),         \
      "+f"(d[29]), "+f"(d[30]), "+f"(d[31])

#define DYN_WG_D64                                                                                      \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, " \
  "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "   \
  "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "   \
  "%62, %63}"
#define DYN_WG_OUT64(d)                                                                                   \
  DYN_WG_OUT32(d), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]),          \
      "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),         \
      "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),         \
      "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]),         \
      "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], both K-major in shared memory
// (the 128 rows of B are 16 eight-row groups 1024 bytes apart).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DYN_WG_D64 ", %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : DYN_WG_OUT64(d)
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A from registers (warp w: rows
// 16w..16w+15 in the mma.sync A-fragment layout), B MN-major in shared memory.
__device__ __forceinline__ void wgmma_m64n64k16_rs_mn(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " DYN_WG_D32
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : DYN_WG_OUT32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d[64 x 16] (+)= A[64 x 16] . B[16 x 16], both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n16k16_ss(float (&d)[8], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 32] (+)= A[64 x 16] . B[16 x 32], both K-major in shared memory.
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64], A K-major and B MN-major in shared
// memory (B's 64 columns: 1 atom, addressed by sw128_desc_mn).
__device__ __forceinline__ void wgmma_m64n64k16_ss_mn(float (&d)[32], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db));
}

// d[64 x 256] += A[64 x 16] . B[16 x 256], A K-major and B MN-major in shared
// memory (B's 256 columns: 4 atoms, addressed by sw128_desc_mn).
__device__ __forceinline__ void wgmma_m64n256k16_ss_mn(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, "
      "%22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, "
      "%42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, "
      "%62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, %80, %81, "
      "%82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, %96, %97, %98, %99, %100, "
      "%101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, %112, %113, %114, %115, %116, "
      "%117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, 1, 1, 1, 0, 1;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]),
        "+f"(d[103]), "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]),
        "+f"(d[110]), "+f"(d[111]), "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]),
        "+f"(d[117]), "+f"(d[118]), "+f"(d[119]), "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db));
}

// d[64 x N] += A[64 x 16] . B[16 x N], A from registers (warp w: rows
// 16w..16w+15 in the mma.sync A-fragment layout), B K-major in shared memory
// (N rows of B, eight-row groups 1024 bytes apart: sw128_desc).
__device__ __forceinline__ void wgmma_m64n128k16_rs(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  asm volatile("wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " DYN_WG_D64
               ", {%64, %65, %66, %67}, %68, 1, 1, 1, 0;\n"
               : DYN_WG_OUT64(d)
               : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}
__device__ __forceinline__ void wgmma_m64n256k16_rs(float (&d)[128], const uint32_t (&a)[4], uint64_t db) {
  asm volatile(
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, "
      "{%128, %129, %130, %131}, %132, 1, 1, 1, 0;\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db));
}

// Pins A-fragment registers at this point of the program (fence_regs for
// the register operand of an RS wgmma still in flight).
template <int N>
__device__ __forceinline__ void fence_regs_u32(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#undef DYN_WG_D32
#undef DYN_WG_OUT32
#undef DYN_WG_D64
#undef DYN_WG_OUT64
