// K3: per-tile forward alpha blend of depth-sorted screen instances.
//
// Replaces the TPU kernel raster/pallas_raster.py:_fwd_kernel (:348),
// launched by _blend_fwd_impl (:613). Same contract: for each tile of the
// [T, 16, cap] packed instances (the first counts[t] slots live) it writes
// the rows
//   out[t] = (r, g, b, blended depth, alpha = sum w, median depth, final T, 0)
// over the tile's pixels, and chunk_t[t, c] = the incoming transmittance of
// chunk c (0 once the pixel is done), chunk_t[t, n_chunks] = final T. It
// also writes what the TPU kernel does not, the residuals of the per-tile
// backward K6 (csrc/blend_backward.cu): last[t] = the slot (c * K + k) of
// each pixel's last applied instance (-1 for none), and visit[t, c] = the
// chunk's visit words [px / 32][ceil(K / 32)]: bit b of word j of warp w is
// set iff one of the warp's 32 pixels applied slot c * K + 32 j + b. It
// writes every element of every output itself (the words of the chunks it
// never enters are 0), so the wrapper fills nothing. exact != 0 gives the
// CUDA-exact stop (the instance whose blend would cross T < 1e-4 is not
// applied); exact == 0 the fast rule (an instance applies while its
// incoming T >= 1e-4).
//
// What bounds it on the H100: the blend is one f32 falloff + exp + gates per
// evaluated (pixel, instance) pair and ~15 more operations per applied
// one, and the live instances' rows are read once from HBM (the packed
// block is about 157 MB at 1200 tiles x cap 2048, most of it dead padding
// that is never read). A warp need evaluate only the slots some lane of it
// applies, so on the render bins the bytes (live rows, rows out and the
// residuals) bound it rather than the operations (chip_smoke.py).
//
// Design: K4's forward (csrc/blend_flat.cu) in per-tile addressing: chunk c
// of tile t is packed[t, :, c*K:(c+1)*K], rows cap apart, and the tile's
// live chunks are the first ceil(counts[t] / K). One block per tile, one
// thread per pixel; each live chunk's rows are staged per slot with their
// footprints, and each warp walks only the slots whose footprint box meets
// its pixels (common.cuh's blend_chunk_culled, shared with K4): on the
// render bins 27.7 M (lane, slot) pairs where the per-pixel walk evaluated
// 112.2 M, against a floor of 25.9 M, the slots some lane applied
// (profiling/count_pairs.py). Slots past counts[t] inside the last live
// chunk are never evaluated, whatever their opacity. The block leaves the
// chunk loop once every pixel of the tile is done (__syncthreads_count).
#include "common.cuh"

using namespace gsorb;

// (256, 5): under (256) alone ptxas holds K3 to 40 registers and spills 16
// bytes; 48 (5 blocks of 256 per SM) keep it whole, 3% faster (PERF.md).
__global__ void __launch_bounds__(256, 5) blend_forward_kernel(
    const float* __restrict__ packed, const int* __restrict__ counts,
    float* __restrict__ out, float* __restrict__ chunk_t, int* __restrict__ last_out,
    unsigned* __restrict__ visit, int cap, int K, int tiles_x, int ts_x, int ts_y, int exact) {
  extern __shared__ float4 rows4[];  // [K][3]: the chunk's rows per slot (SLOT_F)
  float* rows = reinterpret_cast<float*>(rows4);
  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const int lane = p & 31;
  const int kw = (K + 31) >> 5;
  const int n_warps = px >> 5;
  const int n_chunks = cap / K;
  const float pu = (float)((t % tiles_x) * ts_x + p % ts_x);
  const float pv = (float)((t / tiles_x) * ts_y + p / ts_x);
  const WarpRect rect = warp_rect(pu, pv);
  const int count = min(max(counts[t], 0), cap);
  const int n_live = (count + K - 1) / K;
  const float* pk = packed + (size_t)t * N_ATTR * cap;
  float* ct = chunk_t + (size_t)t * (n_chunks + 1) * px;
  // The warp's words of chunk c at vw + c * n_warps * kw.
  unsigned* vw = visit + ((size_t)t * n_chunks * n_warps + (p >> 5)) * kw;

  Blend b;
  bool alive = true;  // block-uniform: some pixel still accepts instances
  for (int c = 0; c < n_chunks; ++c, vw += (size_t)n_warps * kw) {
    ct[(size_t)c * px + p] = b.done ? 0.f : b.T;
    bool enter = c < n_live && alive;
    if (enter) enter = alive = __syncthreads_count(!b.done) > 0;  // fences the last chunk
    if (!enter) {
      for (int j = lane; j < kw; j += 32) vw[j] = 0u;
      continue;
    }
    stage_slots_with_extents(rows, pk + (size_t)c * K, cap, K, p, px);
    __syncthreads();
    blend_chunk_culled(rows4, min(K, count - c * K), kw, rect, pu, pv, exact, c * K, lane, b,
                       vw);
  }
  ct[(size_t)n_chunks * px + p] = b.T;
  write_blend_rows(out + (size_t)t * 8 * px, px, p, b);
  last_out[(size_t)t * px + p] = b.last;
}

extern "C" int gsorb_blend_forward(const float* packed, const int* counts, float* out,
                                   float* chunk_t, int* last, unsigned* visit, int n_tiles,
                                   int cap, int K, int tiles_x, int ts_x, int ts_y, int exact,
                                   void* stream) {
  const size_t smem = (size_t)K * SLOT_F * sizeof(float);
  cudaError_t err = allow_smem(blend_forward_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    blend_forward_kernel<<<n_tiles, ts_x * ts_y, smem, (cudaStream_t)stream>>>(
        packed, counts, out, chunk_t, last, visit, cap, K, tiles_x, ts_x, ts_y, exact);
  }
  return (int)cudaGetLastError();
}
