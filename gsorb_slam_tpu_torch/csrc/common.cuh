// Shared constants and helpers of the port's hand-written Hopper kernels.
//
// Layout contract at every kernel boundary (the JAX package's packed
// screen-instance layout, raster/pallas_raster.py:60-69):
//   packed [T, 16, cap] f32, rows MU MV CA CB CC OP R G B Z LIVE + 5 pad;
//   dead instances carry opacity 0 (and zeroed conics), so the blend gates
//   on alpha alone.
#pragma once

#include <cuda_runtime.h>

namespace gsorb {

constexpr int N_ATTR = 16;
constexpr int N_BLEND = 10;  // rows a blend reads: MU..Z
constexpr int N_GRAD = 10;   // per-instance gradient rows: d MU..Z
constexpr float MIN_ALPHA = 1.0f / 255.0f;
constexpr float STOP_T = 1e-4f;
constexpr float ALPHA_CLAMP = 0.99f;
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Row { MU = 0, MV, CA, CB, CC, OP, CR, CG, CBL, Z, LIVE };

// Per-instance falloff exponent at pixel (pu, pv): the CUDA renderer's
// power = -0.5 (a d0^2 + c d1^2) - b d0 d1 with d = mean - pixel.
__device__ __forceinline__ float falloff_power(float mu, float mv, float ca, float cb,
                                               float cc, float pu, float pv,
                                               float* d0_out, float* d1_out) {
  const float d0 = mu - pu;
  const float d1 = mv - pv;
  *d0_out = d0;
  *d1_out = d1;
  return -0.5f * (ca * d0 * d0 + cc * d1 * d1) - cb * d0 * d1;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL_MASK, v, off);
  return v;
}

// Copies the N_BLEND attribute rows of one chunk [K] of a tile's packed
// block into shared memory (row-major [N_BLEND][K]), coalesced along K.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ tile_pk, int cap,
                                            int base, int K, float* __restrict__ attr) {
  for (int i = threadIdx.x; i < N_BLEND * K; i += blockDim.x) {
    const int r = i / K;
    const int k = i - r * K;
    attr[i] = tile_pk[(size_t)r * cap + base + k];
  }
}

// Opts a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace gsorb
