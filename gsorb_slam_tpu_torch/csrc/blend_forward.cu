// K3: per-tile forward alpha blend of depth-sorted screen instances.
//
// Replaces the TPU kernel raster/pallas_raster.py:_fwd_kernel (:348),
// launched by _blend_fwd_impl (:613). Same contract: for each tile of the
// [T, 16, cap] packed instances it writes the rows
//   out[t] = (r, g, b, blended depth, alpha = sum w, median depth, final T, 0)
// over the tile's pixels, and chunk_t[t, c] = the incoming transmittance of
// chunk c (0 once the pixel is done), chunk_t[t, n_chunks] = final T. It
// also writes last[t] = the slot (c * K + k) of each pixel's last applied
// instance (-1 for none), which the TPU kernel does not: with chunk_t it is
// the residual of the per-tile backward K6 (csrc/blend_backward.cu), whose
// reverse walk starts there. exact != 0 gives the
// CUDA-exact stop (the instance whose blend would cross T < 1e-4 is not
// applied); exact == 0 the fast rule (an instance applies while its incoming
// T >= 1e-4).
//
// What bounds it on the H100: the blend is one f32 falloff + exp + 6 FMAs
// per evaluated (pixel, instance) pair, and the packed block is read once
// from HBM (about 157 MB at 1200 tiles x cap 2048). With most tiles
// saturating after a few hundred instances, it is bound by the f32 instruction
// rate of the evaluated pairs rather than by bytes.
//
// Design: one block per tile, one thread per pixel (the original
// renderer's layout). Each chunk of K instances is staged into shared
// memory once (10 rows x K floats) and read by all pixels of the tile;
// pixels loop over the chunk front to back with the per-pixel stop rule,
// and the block leaves the chunk loop once every pixel is done
// (__syncthreads_count). Chunks past the tile's live count are never
// staged.
#include "common.cuh"

using namespace gsorb;

__global__ void __launch_bounds__(256) blend_forward_kernel(
    const float* __restrict__ packed, const int* __restrict__ counts,
    float* __restrict__ out, float* __restrict__ chunk_t, int* __restrict__ last_out,
    int cap, int K, int tiles_x,
    int ts_x, int ts_y, int exact) {
  extern __shared__ float attr[];  // [N_BLEND][K]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const int n_chunks = cap / K;
  const float pu = (float)((t % tiles_x) * ts_x + p % ts_x);
  const float pv = (float)((t / tiles_x) * ts_y + p / ts_x);
  const int count = min(max(counts[t], 0), cap);
  const int n_live = (count + K - 1) / K;
  const float* pk = packed + (size_t)t * N_ATTR * cap;
  float* ct = chunk_t + (size_t)t * (n_chunks + 1) * px;

  float T = 1.f, Cr = 0.f, Cg = 0.f, Cb = 0.f, D = 0.f, S = 0.f, Med = 0.f;
  int last = -1;
  bool done = false;
  bool alive = true;  // block-uniform: some pixel still accepts instances
  for (int c = 0; c < n_chunks; ++c) {
    ct[(size_t)c * px + p] = done ? 0.f : T;
    if (c >= n_live || !alive) continue;
    alive = __syncthreads_count(!done) > 0;  // also fences the last chunk's reads
    if (!alive) continue;
    const int base = c * K;
    stage_chunk(pk, cap, base, K, attr);
    __syncthreads();
    if (done) continue;
    const int kmax = min(K, count - base);
    for (int k = 0; k < kmax; ++k) {
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
  ct[(size_t)n_chunks * px + p] = T;
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

extern "C" int gsorb_blend_forward(const float* packed, const int* counts, float* out,
                                   float* chunk_t, int* last, int n_tiles, int cap, int K,
                                   int tiles_x, int ts_x, int ts_y, int exact,
                                   void* stream) {
  const size_t smem = (size_t)N_BLEND * K * sizeof(float);
  cudaError_t err = allow_smem(blend_forward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    blend_forward_kernel<<<n_tiles, ts_x * ts_y, smem, (cudaStream_t)stream>>>(
        packed, counts, out, chunk_t, last, cap, K, tiles_x, ts_x, ts_y, exact);
  }
  return (int)cudaGetLastError();
}
