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
// next, which on the GPU becomes the loop inside the tile's block. The TPU
// kernel evaluates whole [px, K] blocks; a GPU warp can skip a slot for
// all its 32 pixels at once, so K4 spends its work only where a pair can
// apply:
//   - Rows per slot. Each chunk's rows are staged once, per slot (common.cuh's
//     SLOT_F layout: a pair's falloff inputs are two 16-byte broadcast
//     loads where there were six scalar loads: 22% off the per-pixel walk
//     on its own, PERF.md).
//   - A footprint cull per warp, with visit words from votes and no exp
//     skip (common.cuh's stage_slots_with_extents and blend_chunk_culled,
//     shared with K3, say how and why). On the render bins the warps
//     evaluate 27.7 M (lane, slot) pairs where the per-pixel walk evaluated
//     112.2 M, against a floor of 25.9 M, the slots some lane applied
//     (profiling/count_pairs.py: warp_kept, evaluated, warp_visits). K4
//     writes every word of the chunks it walks; the wrapper zero-fills
//     those of the chunks it skips.
// The block leaves the chunk loop once every pixel of the tile is done.
// K5 is common.cuh's blend_backward_visited, shared with K6 (it says how):
// each warp walks only the set bits of its words, from high to low, so it
// spends nothing on the slots none of its pixels applied (the render bins:
// 25.9 M (lane, slot) pairs against 106.4 M to each pixel's last applied
// slot, chip_smoke.py). Every (chunk, slot) belongs to one tile, so no
// float atomics are used and the gradients are bitwise reproducible.
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
  extern __shared__ float4 rows4[];  // [K][3]: the chunk's rows per slot (SLOT_F)
  float* rows = reinterpret_cast<float*>(rows4);
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const int lane = p & 31;
  const int kw = (K + 31) >> 5;
  const int n_warps = px >> 5;
  const float pu = (float)((t % tiles_x) * ts_x + p % ts_x);
  const float pv = (float)((t / tiles_x) * ts_y + p / ts_x);
  const WarpRect rect = warp_rect(pu, pv);
  const int c0 = tile_start[t];
  const int c1 = tile_start[t + 1];

  Blend b;
  bool alive = true;  // block-uniform: some pixel still accepts instances
  for (int c = c0; c < c1; ++c) {
    chunk_t[(size_t)c * px + p] = b.done ? 0.f : b.T;
    if (!alive) continue;
    alive = __syncthreads_count(!b.done) > 0;  // also fences the last chunk's reads
    if (!alive) continue;
    stage_slots_with_extents(rows, packed + (size_t)c * N_ATTR * K, K, K, p, px);
    __syncthreads();
    blend_chunk_culled(rows4, K, kw, rect, pu, pv, exact, (c - c0) * K, lane, b,
                       visit + ((size_t)c * n_warps + (p >> 5)) * kw);
  }
  write_blend_rows(out + (size_t)t * 8 * px, px, p, b);
  last_out[(size_t)t * px + p] = b.last;
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
                         visit + c0 * nwk, c1 - c0, K, chunk, K, pu, pv,
                         last_in[(size_t)t * px + p], out[(size_t)t * 8 * px + 6 * px + p], g,
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
  const size_t smem = (size_t)K * SLOT_F * sizeof(float);
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
