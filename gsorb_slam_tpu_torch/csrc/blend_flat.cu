// K4 and K5: the mapping path's flat-chunk blend and its backward.
//
// K4 replaces the TPU kernel raster/pallas_raster.py:_flat_fwd_kernel
// (:1691), launched by _blend_flat_fwd_impl (:1950); K5 replaces
// _flat_bwd_kernel (:1773) + _flat_chunk_grad (:1820), launched by
// _blend_flat_vjp_bwd (:2014).
//
// Contract. The input is the flat list of live chunks of a binning episode
// (ChunkBins, tile-sorted, so a tile's chunks are contiguous): packed
// [MC, 16, K] in the packed row layout, and tile_start [T + 1], the first
// flat chunk of each tile. Dead budget chunks (past tile_start[T]) belong
// to no tile and cost nothing.
// K4 writes, per tile t, the rows out[t] = (r, g, b, blended depth,
// alpha = sum w, median depth, final T, 0) over the tile's pixels (tiles
// without chunks get T = 1 and zeros), and the residuals K5 needs:
// chunk_t[c] = the incoming T of chunk c (0 once the pixel is done) and
// last[t] = the tile-local slot (chunk position * K + k) of each pixel's
// last applied instance (-1 for none). Stop rules and median are K3's
// (csrc/blend_forward.cu): fast = an instance applies while its incoming
// T >= 1e-4; exact = the instance whose blend would take T below 1e-4 is
// not applied; median = z of the last applied instance with incoming
// T > 0.5.
// K5 takes the cotangent gout [T, 8, px] of out (rows 0-4 and the final T
// row 6; the median carries no gradient) and writes the per-instance
// gradients grads [MC, 16, K]: rows d_mu, d_mv, d_ca, d_cb, d_cc, d_op,
// d_r, d_g, d_b, d_z. The wrapper zero-fills grads, so rows 10-15, dead
// chunks and slots past every pixel's last applied instance stay 0.
//
// What bounds them on the H100: as for K3 and K1, the (pixel, instance)
// pairs. K4 spends ~16 f32 operations on every evaluated pair (falloff,
// exp, gates) and ~15 more on an applied one; K5 evaluates the falloff
// again on every pair up to the pixel's last applied instance and spends
// ~53 on each applied pair, its share of the pixel sums included. The
// bytes (the live chunks' 10 blend rows, the rows out, the residuals and
// the gradient block) are each moved once.
//
// Design: one block per tile, one thread per pixel, walking the tile's
// chunks in order (K4) or in reverse (K5); the TPU kernel's grid over
// chunks carries the blend state in scratch from one grid step to the
// next, which on the GPU becomes the loop inside the tile's block. Each
// chunk's 10 attribute rows are staged in shared memory. K4 leaves the
// chunk loop once every pixel of the tile is done. K5 seeds each pixel's
// suffix sum with final T x its cotangent (that couples the background
// into the colour gradient), rebuilds the transmittance backwards by
// division by (1 - alpha), as the original renderer's backward does, and
// re-anchors it at every chunk boundary to the stored incoming T of the
// next chunk, so the rebuild never runs longer than one chunk. Its
// per-instance sums over the tile's pixels are K1's: warp shuffles, then
// one shared-memory slab per warp, added in warp order. Every (chunk, slot)
// belongs to one tile, so no float atomics are used and the gradients are
// bitwise reproducible.
#include "common.cuh"

using namespace gsorb;

namespace {

constexpr int BK = 64;  // instances per backward sub-chunk (K5)

__global__ void __launch_bounds__(256) blend_flat_fwd_kernel(
    const float* __restrict__ packed, const int* __restrict__ tile_start,
    float* __restrict__ out, float* __restrict__ chunk_t, int* __restrict__ last_out,
    int K, int tiles_x, int ts_x, int ts_y, int exact) {
  extern __shared__ float attr[];  // [N_BLEND][K]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const float pu = (float)((t % tiles_x) * ts_x + p % ts_x);
  const float pv = (float)((t / tiles_x) * ts_y + p / ts_x);
  const int c0 = tile_start[t];
  const int c1 = tile_start[t + 1];

  float T = 1.f, Cr = 0.f, Cg = 0.f, Cb = 0.f, D = 0.f, S = 0.f, Med = 0.f;
  int last = -1;
  bool done = false;
  bool alive = true;  // block-uniform: some pixel still accepts instances
  for (int c = c0; c < c1; ++c) {
    chunk_t[(size_t)c * px + p] = done ? 0.f : T;
    if (!alive) continue;
    alive = __syncthreads_count(!done) > 0;  // also fences the last chunk's reads
    if (!alive) continue;
    stage_chunk(packed + (size_t)c * N_ATTR * K, K, 0, K, attr);
    __syncthreads();
    if (done) continue;
    const int base = (c - c0) * K;
    for (int k = 0; k < K; ++k) {
      float d0, d1;
      const float power = falloff_power(attr[MU * K + k], attr[MV * K + k],
                                        attr[CA * K + k], attr[CB * K + k],
                                        attr[CC * K + k], pu, pv, &d0, &d1);
      if (power > 0.f) continue;
      const float alpha = fminf(ALPHA_CLAMP, attr[OP * K + k] * expf(power));
      if (alpha < MIN_ALPHA) continue;
      const float Tn = T * (1.f - alpha);
      if (exact && Tn < STOP_T) {
        done = true;
        break;
      }
      const float w = alpha * T;
      const float z = attr[Z * K + k];
      Cr += w * attr[CR * K + k];
      Cg += w * attr[CG * K + k];
      Cb += w * attr[CBL * K + k];
      D += w * z;
      S += w;
      if (T > 0.5f) Med = z;
      T = Tn;
      last = base + k;
      if (!exact && T < STOP_T) {
        done = true;
        break;
      }
    }
  }
  float* o = out + (size_t)t * 8 * px;
  o[0 * px + p] = Cr;
  o[1 * px + p] = Cg;
  o[2 * px + p] = Cb;
  o[3 * px + p] = D;
  o[4 * px + p] = S;
  o[5 * px + p] = Med;
  o[6 * px + p] = T;
  o[7 * px + p] = 0.f;
  last_out[(size_t)t * px + p] = last;
}

__global__ void __launch_bounds__(256) blend_flat_bwd_kernel(
    const float* __restrict__ packed, const int* __restrict__ tile_start,
    const float* __restrict__ chunk_t, const int* __restrict__ last_in,
    const float* __restrict__ out, const float* __restrict__ gout,
    float* __restrict__ grads, int K, int tiles_x, int ts_x, int ts_y) {
  extern __shared__ float smem[];
  float* attr = smem;                // [N_BLEND][BK]
  float* slab = smem + N_BLEND * BK;  // [n_warps][N_GRAD][BK] per-warp sums
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = px >> 5;
  const float pu = (float)((t % tiles_x) * ts_x + p % ts_x);
  const float pv = (float)((t / tiles_x) * ts_y + p / ts_x);
  const int c0 = tile_start[t];
  const int c1 = tile_start[t + 1];

  const float* g = gout + (size_t)t * 8 * px;
  const float g_r = g[0 * px + p], g_g = g[1 * px + p], g_b = g[2 * px + p];
  const float g_d = g[3 * px + p], g_s = g[4 * px + p], g_t = g[6 * px + p];
  const float t_final = out[(size_t)t * 8 * px + 6 * px + p];
  const int last = last_in[(size_t)t * px + p];
  float Tb = t_final;             // transmittance after the instance being visited
  float suffix = t_final * g_t;   // final-T term + sum over later applied w * phi

  for (int c = c1 - 1; c >= c0; --c) {
    // T after chunk c is the next chunk's incoming T while the pixel was
    // still blending there; otherwise nothing applied after chunk c and the
    // running Tb already holds it.
    if (c + 1 < c1) {
      const float tn = chunk_t[(size_t)(c + 1) * px + p];
      if (tn > 0.f) Tb = tn;
    }
    const int pos0 = (c - c0) * K;
    if (!__syncthreads_or(last >= pos0)) continue;  // no pixel applied any of it
    const float* pk = packed + (size_t)c * N_ATTR * K;
    float* gr = grads + (size_t)c * N_ATTR * K;
    for (int base = ((K + BK - 1) / BK - 1) * BK; base >= 0; base -= BK) {
      const int kmax = min(BK, K - base);
      if (!__syncthreads_or(last >= pos0 + base)) continue;  // also fences attr / slab
      for (int i = p; i < N_BLEND * BK; i += px) {
        const int r = i / BK;
        const int kk = i - r * BK;
        attr[i] = kk < kmax ? pk[(size_t)r * K + base + kk] : 0.f;
      }
      __syncthreads();
      for (int k = kmax - 1; k >= 0; --k) {
        float v[N_GRAD];
#pragma unroll
        for (int j = 0; j < N_GRAD; ++j) v[j] = 0.f;
        bool has = false;
        if (pos0 + base + k <= last) {
          float d0, d1;
          const float ca = attr[CA * BK + k], cb = attr[CB * BK + k], cc = attr[CC * BK + k];
          const float op = attr[OP * BK + k];
          const float power =
              falloff_power(attr[MU * BK + k], attr[MV * BK + k], ca, cb, cc, pu, pv, &d0, &d1);
          const float alpha = fminf(ALPHA_CLAMP, op * expf(power));
          if (power <= 0.f && alpha >= MIN_ALPHA) {
            const float one_m = 1.f - alpha;
            const float Tp = Tb / one_m;
            const float w = alpha * Tp;
            const float phi = g_r * attr[CR * BK + k] + g_g * attr[CG * BK + k] +
                              g_b * attr[CBL * BK + k] + g_d * attr[Z * BK + k] + g_s;
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
        float* sw = slab + (size_t)warp * N_GRAD * BK + k;
        if (__any_sync(FULL_MASK, has)) {
#pragma unroll
          for (int j = 0; j < N_GRAD; ++j) {
            const float s = warp_sum(v[j]);
            if (lane == 0) sw[j * BK] = s;
          }
        } else if (lane == 0) {
#pragma unroll
          for (int j = 0; j < N_GRAD; ++j) sw[j * BK] = 0.f;
        }
      }
      __syncthreads();
      for (int i = p; i < N_GRAD * kmax; i += px) {
        const int r = i / kmax;
        const int kk = i - r * kmax;
        float s = 0.f;
        for (int w = 0; w < n_warps; ++w) s += slab[((size_t)w * N_GRAD + r) * BK + kk];
        gr[(size_t)r * K + base + kk] = s;
      }
    }
  }
}

}  // namespace

extern "C" int gsorb_blend_flat_fwd(const float* packed, const int* tile_start, float* out,
                                    float* chunk_t, int* last, int n_tiles, int K,
                                    int tiles_x, int ts_x, int ts_y, int exact,
                                    void* stream) {
  const size_t smem = (size_t)N_BLEND * K * sizeof(float);
  cudaError_t err = allow_smem(blend_flat_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    blend_flat_fwd_kernel<<<n_tiles, ts_x * ts_y, smem, (cudaStream_t)stream>>>(
        packed, tile_start, out, chunk_t, last, K, tiles_x, ts_x, ts_y, exact);
  }
  return (int)cudaGetLastError();
}

extern "C" int gsorb_blend_flat_bwd(const float* packed, const int* tile_start,
                                    const float* chunk_t, const int* last, const float* out,
                                    const float* gout, float* grads, int n_tiles, int K,
                                    int tiles_x, int ts_x, int ts_y, void* stream) {
  const size_t smem =
      ((size_t)N_BLEND * BK + (size_t)(ts_x * ts_y / 32) * N_GRAD * BK) * sizeof(float);
  cudaError_t err = allow_smem(blend_flat_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    blend_flat_bwd_kernel<<<n_tiles, ts_x * ts_y, smem, (cudaStream_t)stream>>>(
        packed, tile_start, chunk_t, last, out, gout, grads, K, tiles_x, ts_x, ts_y);
  }
  return (int)cudaGetLastError();
}
