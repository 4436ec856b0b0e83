// Grouped matrix product of routed MoE, for sm_90a:
//   out[r, :] = x[r, :] @ W[e]   for every row r in [offsets[e], offsets[e + 1])
// with x bf16[M, K] (token rows sorted by expert), W bf16[E, K, N] (each
// expert's matrix stored [in, out], as the parameters keep it), offsets
// int32[E + 1] on the device (offsets[0] = 0, non-decreasing), out bf16[M, N]
// with f32 accumulation, rounded once. Rows in [offsets[E], M) are written as
// zeros (a group sum short of M, as lax.ragged_dot leaves them).
//
// Replaces no pl.pallas_call: the JAX build runs a routed MoE layer's expert
// FFNs as three jax.lax.ragged_dot calls (dynamo_tpu/parallel/moe.py:205
// moe_mlp_dropless, :232-234), a grouped matmul that XLA lowers on the TPU.
// Eager PyTorch has no counterpart the port may use; this kernel is it.
//
// Bound: at decode (a few rows an expert) the bytes of the experts that have
// rows: olmoe-1b-7b at batch 8, top-8 of 64 touches about 41 experts, each
// matrix 4 MB, against 2*M*K*N operations that the tensor cores do in a
// fraction of that time. At prefill (hundreds of rows an expert) the
// operations. What the design does about it:
// - The grid is sized from shapes alone, so a launch is graph-capturable and
//   needs no host sync: gridDim.y = ceil(M / 64) + E + 1 row tiles (the most
//   the groups can need, plus the zero tail) x ceil(N / 128) column tiles.
// - Each block reads offsets and finds its expert and row tile itself (a
//   block-wide scan of the tiles a group needs). Experts with no rows own no
//   tile: no block ever touches their weights, so decode moves the bytes of
//   the experts it uses and no more. Blocks past the real tiles exit.
// - A block computes a 64 x 128 tile with 8 warps of mma.sync m16n8k16 (bf16
//   in, f32 accumulate; each warp 32 x 32), fed by a 3-stage cp.async ring
//   of 32-deep K slices (ldmatrix for x, ldmatrix.trans for the [in, out]
//   weight); rows past the group's end load the group's last row and are
//   never stored. A simple form: wgmma and TMA, and fusing silu(gate) * up
//   and the row gather into it, are later work (ROADMAP B6).

#include "common.cuh"

namespace {

constexpr int kBM = 64;           // rows of a tile
constexpr int kBN = 128;          // columns of a tile
constexpr int kBK = 32;           // K a pipeline stage
constexpr int kStages = 3;
constexpr int kThreads = 256;     // 8 warps: 2 (rows) x 4 (columns), 32 x 32 each
constexpr int kAStride = kBK + 8; // 80-byte rows: ldmatrix rows hit distinct banks
constexpr int kBStride = kBN + 8; // 272-byte rows, likewise
constexpr int kExpertsPerThread = 4;
constexpr int kMaxExperts = kThreads * kExpertsPerThread;

__global__ void __launch_bounds__(kThreads) grouped_mm_kernel(const __nv_bfloat16* __restrict__ x,
                                                               const __nv_bfloat16* __restrict__ w,
                                                               const int* __restrict__ offsets,
                                                               __nv_bfloat16* __restrict__ out, int M, int N,
                                                               int K, int E) {
  __shared__ __align__(128) __nv_bfloat16 as[kStages][kBM * kAStride];
  __shared__ __align__(128) __nv_bfloat16 bs[kStages][kBK * kBStride];
  __shared__ int warp_tiles[kThreads / 32];
  __shared__ int found[3];  // expert (-1: none), its first tile, tiles in all

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tile = blockIdx.y;
  const int n0 = blockIdx.x * kBN;

  // -- which expert and row tile: tiles of expert e = ceil(rows_e / kBM) ---
  const int e0 = tid * kExpertsPerThread;
  int cnt[kExpertsPerThread];
  int local = 0;
#pragma unroll
  for (int j = 0; j < kExpertsPerThread; ++j) {
    const int e = e0 + j;
    const int rows = e < E ? offsets[e + 1] - offsets[e] : 0;
    cnt[j] = rows > 0 ? (rows + kBM - 1) / kBM : 0;
    local += cnt[j];
  }
  int incl = local;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += v;
  }
  if (lane == 31) warp_tiles[warp] = incl;
  if (tid == 0) found[0] = -1;
  __syncthreads();
  int start = incl - local;
  for (int i = 0; i < warp; ++i) start += warp_tiles[i];
  if (tid == kThreads - 1) found[2] = start + local;
#pragma unroll
  for (int j = 0; j < kExpertsPerThread; ++j) {
    if (tile >= start && tile < start + cnt[j]) {
      found[0] = e0 + j;
      found[1] = start;
    }
    start += cnt[j];
  }
  __syncthreads();
  const int expert = found[0];

  if (expert < 0) {
    // The zero tail [offsets[E], M), in row tiles after the groups' tiles.
    const int r0 = offsets[E] + (tile - found[2]) * kBM;
    if (tile < found[2] || r0 >= M) return;
    const int rows = min(kBM, M - r0);
    const __nv_bfloat162 zero = __floats2bfloat162_rn(0.f, 0.f);
    for (int i = tid; i < rows * (kBN / 2); i += kThreads) {
      const int r = i / (kBN / 2), c = n0 + 2 * (i % (kBN / 2));
      if (c < N) *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(r0 + r) * N + c) = zero;
    }
    return;
  }

  const int row0 = offsets[expert] + (tile - found[1]) * kBM;
  const int rows = min(kBM, offsets[expert + 1] - row0);
  const __nv_bfloat16* wexp = w + (size_t)expert * K * N;

  // Each thread copies one 16-byte x chunk and two weight chunks a stage.
  const int a_r = tid >> 2, a_c = (tid & 3) * 8;
  const __nv_bfloat16* a_src = x + (size_t)(row0 + min(a_r, rows - 1)) * K + a_c;
  int b_r[2], b_col[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int chunk = tid + i * kThreads;
    b_r[i] = chunk >> 4;
    b_col[i] = (chunk & 15) * 8;
  }
  auto load_stage = [&](int slot, int k0) {
    cp_async16(&as[slot][a_r * kAStride + a_c], a_src + k0);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int col = min(n0 + b_col[i], N - 8);  // a ragged column edge re-reads the last chunk; never stored
      cp_async16(&bs[slot][b_r[i] * kBStride + b_col[i]], wexp + (size_t)(k0 + b_r[i]) * N + col);
    }
  };

  const int kt_count = K / kBK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < kt_count) load_stage(s, s * kBK);
    cp_async_commit();
  }

  const int wm = warp >> 2, wn = warp & 3;
  float acc[2][4][4] = {};
  for (int kt = 0; kt < kt_count; ++kt) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = kt + kStages - 1;
    if (next < kt_count) load_stage(next % kStages, next * kBK);
    cp_async_commit();
    const __nv_bfloat16* a_tile = as[kt % kStages];
    const __nv_bfloat16* b_tile = bs[kt % kStages];
#pragma unroll
    for (int kk = 0; kk < kBK; kk += 16) {
      uint32_t a[2][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldmatrix_x4(a[mi], a_tile + (wm * 32 + mi * 16 + (lane & 15)) * kAStride + kk + (lane >> 4) * 8);
#pragma unroll
      for (int nj = 0; nj < 2; ++nj) {
        uint32_t r[4];
        ldmatrix_x4_trans(r, b_tile + (kk + (lane & 15)) * kBStride + wn * 32 + nj * 16 + (lane >> 4) * 8);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_bf16(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
    }
  }
  cp_async_wait<0>();

  const int g = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * t4;
      if (col >= N) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * 32 + mi * 16 + g + 8 * h;
        if (r < rows)
          *reinterpret_cast<uint32_t*>(out + (size_t)(row0 + r) * N + col) =
              pack_bf16(acc[mi][ni][2 * h], acc[mi][ni][2 * h + 1]);
      }
    }
}

}  // namespace

extern "C" int dyn_grouped_matmul(const void* x, const void* w, const void* offsets, void* out, int M, int N, int K,
                                  int E, void* stream) {
  if (M < 1 || N < 8 || N % 8 || K < kBK || K % kBK || E < 1 || E > kMaxExperts) return (int)cudaErrorInvalidValue;
  const long long row_tiles = (M + kBM - 1) / kBM + (long long)E + 1;
  if (row_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBN - 1) / kBN, (unsigned)row_tiles);
  grouped_mm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(w), static_cast<const int*>(offsets),
      static_cast<__nv_bfloat16*>(out), M, N, K, E);
  return (int)cudaGetLastError();
}
