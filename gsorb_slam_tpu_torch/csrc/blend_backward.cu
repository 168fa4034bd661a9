// K6: the backward of the per-tile forward blend K3.
//
// Replaces the TPU kernel raster/pallas_raster.py:_bwd_kernel (:433),
// launched by _blend_vjp_bwd (:659). Contract: for each tile of the
// [T, 16, cap] packed instances, K3's residuals chunk_t [T, n_chunks + 1, px]
// (the incoming T of each chunk, 0 once the pixel is done; row n_chunks =
// final T), last [T, px] (the slot of each pixel's last applied instance,
// -1 for none) and visit [T, n_chunks, px / 32, ceil(K / 32)] (per warp and
// 32 slots, the OR of the slots its pixels applied), and the cotangent
// gout [T, 8, px] of K3's rows (r, g, b, depth, alpha and the final T row 6;
// the median row 5 carries no gradient), it writes the per-instance
// gradients grads [T, 16, cap]: rows d_mu, d_mv, d_ca, d_cb, d_cc, d_op,
// d_r, d_g, d_b, d_z. It writes every element itself: rows 10-15, the slots
// no warp applied and the chunks no pixel reached are 0, so the wrapper
// fills nothing. Both stop rules are honoured by construction: the walk
// visits exactly the instances the forward applied (those up to last that
// pass the gates).
//
// What bounds it on the H100: as for K5, the (pixel, instance) pairs, ~53
// f32 operations per applied pair, its share of the pixel sums included,
// and the gate again per visited one. The bytes (the live instances' 10
// blend rows, K3's residuals, six cotangent rows and the whole gradient
// block, 157 MB at 1200 tiles x cap 2048) are each moved once.
//
// Design: K5's visited-slot walk (common.cuh's blend_backward_visited) in
// per-tile addressing: chunk c of tile t is packed[t, :, c*K:(c+1)*K], rows
// cap apart. One block per tile, one thread per pixel, walking all cap / K
// chunks in reverse: a chunk no pixel reached is zeroed; in the others each
// warp visits only the set bits of its visit words, from high to low, so it
// spends nothing on the slots none of its pixels applied: on the render
// bins 25.9 M (lane, slot) pairs where the walk to each pixel's last
// applied slot, K6's before, visited 106.4 M (chip_smoke.py). The
// per-instance sums over the tile's pixels are a halving tree of warp
// shuffles into one shared-memory slab per warp, then, per slot, the slabs
// of the warps that visited it added in warp order. Every slot belongs to
// one tile and one block: no float atomics, and the gradients are bitwise
// reproducible. The TPU kernel instead re-runs each entered chunk forward
// to find its applied set, which costs a second falloff per evaluated pair.
#include "common.cuh"

using namespace gsorb;

namespace {

__global__ void __launch_bounds__(256) blend_backward_kernel(
    const float* __restrict__ packed, const float* __restrict__ chunk_t,
    const int* __restrict__ last_in, const unsigned* __restrict__ visit,
    const float* __restrict__ gout, float* __restrict__ grads, int cap, int K, int tiles_x,
    int ts_x, int ts_y) {
  extern __shared__ float4 smem4[];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const int n_chunks = cap / K;
  const float pu = (float)((t % tiles_x) * ts_x + p % ts_x);
  const float pv = (float)((t / tiles_x) * ts_y + p / ts_x);
  const float* ct = chunk_t + (size_t)t * (n_chunks + 1) * px;
  const float* go = gout + (size_t)t * 8 * px + p;
  const float g[6] = {go[0 * px], go[1 * px], go[2 * px], go[3 * px], go[4 * px], go[6 * px]};
  const size_t tile = (size_t)t * N_ATTR * cap;
  const size_t nwk = (size_t)(px >> 5) * ((K + 31) >> 5);
  blend_backward_visited(packed + tile, grads + tile, ct, visit + t * n_chunks * nwk, n_chunks,
                         K, (size_t)K, cap, pu, pv, last_in[(size_t)t * px + p],
                         ct[(size_t)n_chunks * px + p], g, reinterpret_cast<float*>(smem4));
}

}  // namespace

extern "C" int gsorb_blend_backward(const float* packed, const float* chunk_t, const int* last,
                                    const unsigned* visit, const float* gout, float* grads,
                                    int n_tiles, int cap, int K, int tiles_x, int ts_x, int ts_y,
                                    void* stream) {
  const size_t smem = blend_backward_visited_smem(ts_x * ts_y, K);
  cudaError_t err = allow_smem(blend_backward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    blend_backward_kernel<<<n_tiles, ts_x * ts_y, smem, (cudaStream_t)stream>>>(
        packed, chunk_t, last, visit, gout, grads, cap, K, tiles_x, ts_x, ts_y);
  }
  return (int)cudaGetLastError();
}
