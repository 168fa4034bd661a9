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

// The blend backwards' reverse walk over one tile's chunks (K5 on the flat
// chunk list, K6 per tile), run by the tile's block, one thread per pixel.
//
// Chunk i (0 <= i < n_chunks, in depth order) holds K instances at
// pk + i * chunk_stride, its attribute rows row_stride floats apart; its
// gradients go to the same offsets of gr (zero-filled by the caller), and
// ct + i * px holds its incoming T per pixel (0 once the pixel is done).
// last is the pixel's last applied slot (i * K + k, -1 for none), t_final
// its final T, g = its cotangents of (r, g, b, depth, alpha, final T).
// smem holds N_BLEND * SUB_K + n_warps * N_GRAD * SUB_K floats.
//
// Each pixel's suffix sum starts at final T x its cotangent; the
// transmittance is rebuilt backwards by division by (1 - alpha) and
// re-anchored at every chunk boundary to the next chunk's stored incoming
// T, so the rebuild never runs longer than one chunk. The per-instance sums
// over the tile's pixels are warp shuffles, then one shared-memory slab per
// warp, added in warp order: no float atomics, bitwise reproducible.
constexpr int SUB_K = 64;  // instances per backward sub-chunk

__device__ __forceinline__ void blend_backward_chunks(
    const float* __restrict__ pk, float* __restrict__ gr, const float* __restrict__ ct,
    int n_chunks, int K, size_t chunk_stride, int row_stride, float pu, float pv, int last,
    float t_final, const float* g, float* smem) {
  float* attr = smem;                    // [N_BLEND][SUB_K]
  float* slab = smem + N_BLEND * SUB_K;  // [n_warps][N_GRAD][SUB_K] per-warp sums
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = px >> 5;
  const float g_r = g[0], g_g = g[1], g_b = g[2], g_d = g[3], g_s = g[4], g_t = g[5];
  float Tb = t_final;             // transmittance after the instance being visited
  float suffix = t_final * g_t;   // final-T term + sum over later applied w * phi

  for (int i = n_chunks - 1; i >= 0; --i) {
    // T after chunk i is the next chunk's incoming T while the pixel was
    // still blending there; otherwise nothing applied after chunk i and the
    // running Tb already holds it.
    if (i + 1 < n_chunks) {
      const float tn = ct[(size_t)(i + 1) * px + p];
      if (tn > 0.f) Tb = tn;
    }
    const int pos0 = i * K;
    if (!__syncthreads_or(last >= pos0)) continue;  // no pixel applied any of it
    const float* pc = pk + (size_t)i * chunk_stride;
    float* gc = gr + (size_t)i * chunk_stride;
    for (int base = ((K + SUB_K - 1) / SUB_K - 1) * SUB_K; base >= 0; base -= SUB_K) {
      const int kmax = min(SUB_K, K - base);
      if (!__syncthreads_or(last >= pos0 + base)) continue;  // also fences attr / slab
      for (int j = p; j < N_BLEND * SUB_K; j += px) {
        const int r = j / SUB_K;
        const int kk = j - r * SUB_K;
        attr[j] = kk < kmax ? pc[(size_t)r * row_stride + base + kk] : 0.f;
      }
      __syncthreads();
      for (int k = kmax - 1; k >= 0; --k) {
        float v[N_GRAD];
#pragma unroll
        for (int j = 0; j < N_GRAD; ++j) v[j] = 0.f;
        bool has = false;
        if (pos0 + base + k <= last) {
          float d0, d1;
          const float ca = attr[CA * SUB_K + k], cb = attr[CB * SUB_K + k];
          const float cc = attr[CC * SUB_K + k], op = attr[OP * SUB_K + k];
          const float power = falloff_power(attr[MU * SUB_K + k], attr[MV * SUB_K + k], ca, cb,
                                            cc, pu, pv, &d0, &d1);
          const float alpha = fminf(ALPHA_CLAMP, op * expf(power));
          if (power <= 0.f && alpha >= MIN_ALPHA) {
            const float one_m = 1.f - alpha;
            const float Tp = Tb / one_m;
            const float w = alpha * Tp;
            const float phi = g_r * attr[CR * SUB_K + k] + g_g * attr[CG * SUB_K + k] +
                              g_b * attr[CBL * SUB_K + k] + g_d * attr[Z * SUB_K + k] + g_s;
            const float d_alpha = Tp * phi - suffix / one_m;
            suffix += w * phi;
            Tb = Tp;
            const float dpow = alpha < ALPHA_CLAMP ? alpha * d_alpha : 0.f;
            v[0] = -dpow * (ca * d0 + cb * d1);
            v[1] = -dpow * (cc * d1 + cb * d0);
            v[2] = -0.5f * dpow * d0 * d0;
            v[3] = -dpow * d0 * d1;
            v[4] = -0.5f * dpow * d1 * d1;
            v[5] = dpow / fmaxf(op, 1e-12f);
            v[6] = w * g_r;
            v[7] = w * g_g;
            v[8] = w * g_b;
            v[9] = w * g_d;
            has = true;
          }
        }
        float* sw = slab + (size_t)warp * N_GRAD * SUB_K + k;
        if (__any_sync(FULL_MASK, has)) {
#pragma unroll
          for (int j = 0; j < N_GRAD; ++j) {
            const float s = warp_sum(v[j]);
            if (lane == 0) sw[j * SUB_K] = s;
          }
        } else if (lane == 0) {
#pragma unroll
          for (int j = 0; j < N_GRAD; ++j) sw[j * SUB_K] = 0.f;
        }
      }
      __syncthreads();
      for (int j = p; j < N_GRAD * kmax; j += px) {
        const int r = j / kmax;
        const int kk = j - r * kmax;
        float s = 0.f;
        for (int w = 0; w < n_warps; ++w) s += slab[((size_t)w * N_GRAD + r) * SUB_K + kk];
        gc[(size_t)r * row_stride + base + kk] = s;
      }
    }
  }
}

// Dynamic shared memory of blend_backward_chunks for a tile of px pixels.
inline size_t blend_backward_smem(int px) {
  return ((size_t)N_BLEND * SUB_K + (size_t)(px / 32) * N_GRAD * SUB_K) * sizeof(float);
}

// Opts a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace gsorb
