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
// to no tile: K4 does not read them and K5 only zeroes their gradients.
// K4 writes, per tile t, the rows out[t] = (r, g, b, blended depth,
// alpha = sum w, median depth, final T, 0) over the tile's pixels (tiles
// without chunks get T = 1 and zeros), and the residuals K5 needs:
// chunk_t[c] = the incoming T of chunk c (0 once the pixel is done),
// last[t] = the tile-local slot (chunk position * K + k) of each pixel's
// last applied instance (-1 for none), and visit[c] = the chunk's visit
// words [px / 32][ceil(K / 32)]: bit b of word j of warp w is set iff one
// of the warp's 32 pixels applied slot 32 j + b (the wrapper zero-fills
// chunk_t and visit, which stay 0 for chunks no pixel entered). Stop rules
// and median are K3's (csrc/blend_forward.cu): fast = an instance applies
// while its incoming T >= 1e-4; exact = the instance whose blend would
// take T below 1e-4 is not applied; median = z of the last applied
// instance with incoming T > 0.5.
// K5 takes the cotangent gout [T, 8, px] of out (rows 0-4 and the final T
// row 6; the median carries no gradient) and writes the per-instance
// gradients grads [MC, 16, K]: rows d_mu, d_mv, d_ca, d_cb, d_cc, d_op,
// d_r, d_g, d_b, d_z. It writes every element itself: rows 10-15, slots
// no warp visited and the dead budget chunks past tile_start[T] are 0.
//
// What bounds them on the H100: as for K3 and K1, the (pixel, instance)
// pairs. K4 spends ~16 f32 operations on every evaluated pair (falloff,
// exp, gates) and ~15 more on an applied one; K5 spends ~53 on each
// applied pair, its share of the pixel sums included. The bytes (the live
// chunks' 10 blend rows, the rows out, the residuals and the gradient
// block) are each moved once. Beyond those operations the kernels pay
// instruction overhead per pair: shared-memory loads, branches and, in the
// backward, the warp's bookkeeping per slot.
//
// Design: one block per tile, one thread per pixel, walking the tile's
// chunks in order (K4) or in reverse (K5); the TPU kernel's grid over
// chunks carries the blend state in scratch from one grid step to the
// next, which on the GPU becomes the loop inside the tile's block. K4
// stages each chunk's 10 attribute rows in shared memory, leaves the chunk
// loop once every pixel of the tile is done, and records the visit words:
// each applying pixel sets its slot's bit in its warp's word in shared
// memory (an integer atomicOr, whose result does not depend on the
// order), and the words go out at the chunk's end. K5 is common.cuh's
// blend_backward_visited: each warp walks only the set bits of its words,
// from high to low, so it spends nothing on the slots none of its pixels
// applied (the render bins: 25.9 M (lane, slot) pairs against 106.4 M to
// each pixel's last applied slot, profiling/count_pairs.py). Each chunk's
// rows are staged once, per slot (two 16-byte loads for a pair's
// falloff), not once per 64-slot sub-chunk. The suffix
// sum starts at final T x its cotangent (that couples the background into
// the colour gradient), the transmittance is rebuilt backwards by division
// by (1 - alpha), as the original renderer's backward does, and re-anchored
// at every chunk boundary to the stored incoming T of the next chunk. The
// per-instance sums over the tile's pixels are K1's: a halving tree of
// warp shuffles into one shared-memory slab per warp, then, per slot, the
// slabs of the warps that visited it added in warp order. Every (chunk, slot) belongs to one tile,
// so no float atomics are used and the gradients are bitwise reproducible.
// No tensor cores: the pixel sums are the only contraction and a small
// share of the time; the rest is per-pair elementwise work with
// data-dependent stops.
#include "common.cuh"

using namespace gsorb;

namespace {

__global__ void __launch_bounds__(256) blend_flat_fwd_kernel(
    const float* __restrict__ packed, const int* __restrict__ tile_start,
    float* __restrict__ out, float* __restrict__ chunk_t, int* __restrict__ last_out,
    unsigned* __restrict__ visit, int K, int tiles_x, int ts_x, int ts_y, int exact) {
  extern __shared__ float attr[];  // [N_BLEND][K], then the words [n_warps][kw]
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const int kw = (K + 31) >> 5;
  const int nwk = (px >> 5) * kw;  // visit words per chunk
  unsigned* words = reinterpret_cast<unsigned*>(attr + N_BLEND * K);
  unsigned* my_words = words + (p >> 5) * kw;
  const float pu = (float)((t % tiles_x) * ts_x + p % ts_x);
  const float pv = (float)((t / tiles_x) * ts_y + p / ts_x);
  const int c0 = tile_start[t];
  const int c1 = tile_start[t + 1];

  float T = 1.f, Cr = 0.f, Cg = 0.f, Cb = 0.f, D = 0.f, S = 0.f, Med = 0.f;
  int last = -1;
  bool done = false;
  bool alive = true;  // block-uniform: some pixel still accepts instances
  int pending = -1;   // the entered chunk whose words are still in shared memory
  for (int c = c0; c < c1; ++c) {
    chunk_t[(size_t)c * px + p] = done ? 0.f : T;
    if (!alive) continue;
    alive = __syncthreads_count(!done) > 0;  // also fences the last chunk's reads
    for (int j = p; j < nwk; j += px) {
      if (pending >= 0) visit[(size_t)pending * nwk + j] = words[j];
      words[j] = 0u;
    }
    pending = -1;
    if (!alive) continue;
    pending = c;
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
      mark_visit(my_words, k);
      if (!exact && T < STOP_T) {
        done = true;
        break;
      }
    }
  }
  __syncthreads();
  for (int j = p; j < nwk && pending >= 0; j += px) visit[(size_t)pending * nwk + j] = words[j];
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
    const unsigned* __restrict__ visit, const float* __restrict__ out,
    const float* __restrict__ gout, float* __restrict__ grads, int n_tiles, int n_chunks,
    int K, int tiles_x, int ts_x, int ts_y) {
  extern __shared__ float4 smem4[];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const float pu = (float)((t % tiles_x) * ts_x + p % ts_x);
  const float pv = (float)((t / tiles_x) * ts_y + p / ts_x);
  const int c0 = tile_start[t];
  const int c1 = tile_start[t + 1];
  const float* go = gout + (size_t)t * 8 * px + p;
  const float g[6] = {go[0 * px], go[1 * px], go[2 * px], go[3 * px], go[4 * px], go[6 * px]};
  const size_t chunk = (size_t)N_ATTR * K;
  const size_t nwk = (size_t)(px >> 5) * ((K + 31) >> 5);
  blend_backward_visited(packed + c0 * chunk, grads + c0 * chunk, chunk_t + (size_t)c0 * px,
                         visit + c0 * nwk, c1 - c0, K, pu, pv, last_in[(size_t)t * px + p],
                         out[(size_t)t * 8 * px + 6 * px + p], g,
                         reinterpret_cast<float*>(smem4));
  // The dead budget chunks past tile_start[n_tiles] belong to no tile: the
  // blocks zero them in turn.
  for (int c = tile_start[n_tiles] + t; c < n_chunks; c += n_tiles)
    zero_slots(grads + c * chunk, K, 0, K, p, px);
}

}  // namespace

extern "C" int gsorb_blend_flat_fwd(const float* packed, const int* tile_start, float* out,
                                    float* chunk_t, int* last, unsigned* visit, int n_tiles,
                                    int K, int tiles_x, int ts_x, int ts_y, int exact,
                                    void* stream) {
  const size_t smem = (size_t)N_BLEND * K * sizeof(float) +
                      (size_t)(ts_x * ts_y / 32) * ((K + 31) / 32) * sizeof(unsigned);
  cudaError_t err = allow_smem(blend_flat_fwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    blend_flat_fwd_kernel<<<n_tiles, ts_x * ts_y, smem, (cudaStream_t)stream>>>(
        packed, tile_start, out, chunk_t, last, visit, K, tiles_x, ts_x, ts_y, exact);
  }
  return (int)cudaGetLastError();
}

extern "C" int gsorb_blend_flat_bwd(const float* packed, const int* tile_start,
                                    const float* chunk_t, const int* last,
                                    const unsigned* visit, const float* out, const float* gout,
                                    float* grads, int n_tiles, int n_chunks, int K, int tiles_x,
                                    int ts_x, int ts_y, void* stream) {
  const size_t smem = blend_backward_visited_smem(ts_x * ts_y, K);
  cudaError_t err = allow_smem(blend_flat_bwd_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    blend_flat_bwd_kernel<<<n_tiles, ts_x * ts_y, smem, (cudaStream_t)stream>>>(
        packed, tile_start, chunk_t, last, visit, out, gout, grads, n_tiles, n_chunks, K,
        tiles_x, ts_x, ts_y);
  }
  return (int)cudaGetLastError();
}
