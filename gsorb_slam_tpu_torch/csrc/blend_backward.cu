// K6: the backward of the per-tile forward blend K3.
//
// Replaces the TPU kernel raster/pallas_raster.py:_bwd_kernel (:433),
// launched by _blend_vjp_bwd (:659). Contract: for each tile of the
// [T, 16, cap] packed instances (the first counts[t] slots live), K3's
// residuals chunk_t [T, n_chunks + 1, px] (the incoming T of each chunk, 0
// once the pixel is done; row n_chunks = final T) and last [T, px] (the
// slot of each pixel's last applied instance, -1 for none), and the
// cotangent gout [T, 8, px] of K3's rows (r, g, b, depth, alpha and the
// final T row 6; the median row 5 carries no gradient), it writes the
// per-instance gradients grads [T, 16, cap]: rows d_mu, d_mv, d_ca, d_cb,
// d_cc, d_op, d_r, d_g, d_b, d_z. The wrapper zero-fills grads, so rows
// 10-15, dead slots and the slots past every pixel's last applied instance
// (the chunks the forward never entered among them) stay 0. Both stop
// rules are honoured by construction: the walk visits exactly the
// instances the forward applied (those up to last that pass the gates).
//
// What bounds it on the H100: as for K5, the (pixel, instance) pairs. The
// falloff is evaluated again (~16 f32 operations) on every pair up to the
// pixel's last applied instance, and each applied pair costs ~53 more, its
// share of the pixel sums included. The bytes (the live instances' 10
// blend rows, chunk_t, last, six cotangent rows and the gradient block)
// are each moved once.
//
// Design: K5 with per-tile chunk addressing. Chunk c of tile t is
// packed[t, :, c*K:(c+1)*K] (rows cap apart), the tile's live chunks are
// the first ceil(counts[t] / K), and there is no flat list. One block per
// tile, one thread per pixel, walking the live chunks in reverse through
// common.cuh's blend_backward_chunks (shared with K5): each sub-chunk's
// 10 blend rows are staged in shared memory, the walk starts at the
// pixel's last applied slot (so it skips what the forward never applied),
// the transmittance is re-anchored at each chunk boundary to the stored
// incoming T, the suffix sum is seeded with final T x its cotangent (the
// background enters the colour gradient there), and the per-instance
// pixel sums are warp shuffles, then one shared-memory slab per warp added
// in warp order. Every slot belongs to one tile and one block: no float
// atomics, so the gradients are bitwise reproducible. The walk is bounded
// by K3's last output rather than by walking every entered chunk: the TPU
// kernel re-runs each entered chunk forward to find its applied set, which
// costs a second falloff per evaluated pair.
#include "common.cuh"

using namespace gsorb;

namespace {

__global__ void __launch_bounds__(256) blend_backward_kernel(
    const float* __restrict__ packed, const int* __restrict__ counts,
    const float* __restrict__ chunk_t, const int* __restrict__ last_in,
    const float* __restrict__ gout, float* __restrict__ grads, int cap, int K,
    int tiles_x, int ts_x, int ts_y) {
  extern __shared__ float smem[];
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const int n_chunks = cap / K;
  const float pu = (float)((t % tiles_x) * ts_x + p % ts_x);
  const float pv = (float)((t / tiles_x) * ts_y + p / ts_x);
  const int count = min(max(counts[t], 0), cap);
  const float* ct = chunk_t + (size_t)t * (n_chunks + 1) * px;
  const float* go = gout + (size_t)t * 8 * px + p;
  const float g[6] = {go[0 * px], go[1 * px], go[2 * px], go[3 * px], go[4 * px], go[6 * px]};
  const size_t tile = (size_t)t * N_ATTR * cap;
  blend_backward_chunks(packed + tile, grads + tile, ct, (count + K - 1) / K, K, (size_t)K,
                        cap, pu, pv, last_in[(size_t)t * px + p],
                        ct[(size_t)n_chunks * px + p], g, smem);
}

}  // namespace

extern "C" int gsorb_blend_backward(const float* packed, const int* counts,
                                    const float* chunk_t, const int* last, const float* gout,
                                    float* grads, int n_tiles, int cap, int K, int tiles_x,
                                    int ts_x, int ts_y, void* stream) {
  const size_t smem = blend_backward_smem(ts_x * ts_y);
  cudaError_t err = allow_smem(blend_backward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    blend_backward_kernel<<<n_tiles, ts_x * ts_y, smem, (cudaStream_t)stream>>>(
        packed, counts, chunk_t, last, gout, grads, cap, K, tiles_x, ts_x, ts_y);
  }
  return (int)cudaGetLastError();
}
