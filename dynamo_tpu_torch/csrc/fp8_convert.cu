// The on-chip e4m3 -> bf16 conversion of the fp8 kernels (common.cuh
// fp8x8_to_bf16x8), exposed on its own so a check can run every code through
// it: out[i] = bf16(in[i]) for n bytes of fp8 codes (n a multiple of 8).
// Not on any serving path; chip_smoke.py holds it against PyTorch's cast.

#include "common.cuh"

namespace {

__global__ void fp8_to_bf16_kernel(const uint2* __restrict__ in, uint4* __restrict__ out, int n8) {
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < n8; i += gridDim.x * blockDim.x)
    out[i] = fp8x8_to_bf16x8(in[i]);
}

}  // namespace

// Launches the conversion on `stream`; returns the CUDA error code (0 =
// launched). No synchronisation, no allocation.
extern "C" int dyn_fp8_to_bf16(const void* in, void* out, int n, void* stream) {
  if (n % 8) return (int)cudaErrorInvalidValue;
  const int n8 = n / 8;
  fp8_to_bf16_kernel<<<(n8 + 255) / 256, 256, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint2*>(in), static_cast<uint4*>(out), n8);
  return (int)cudaGetLastError();
}
