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
//     on its own, PERF.md). The thread that stages a slot also writes
//     the slot's footprint (slot_extents) into the two spare floats: the
//     half-extents of the box around its {alpha >= 1/255} ellipse, widened
//     for f32 rounding, -1 where the opacity is below the gate, inf where
//     the conic is not positive definite.
//   - A footprint cull per warp. Each warp tests 32 slots at a time against
//     the rectangle of its 32 pixel centres (16 x 2 at tile 16) with one
//     ballot, then walks the set bits in ascending order (__ffs), the whole
//     warp together; a lane that is done sits the rest out, and the warp
//     leaves the chunk once all its lanes are done. A culled pair cannot
//     pass power <= 0 and alpha >= 1/255, so every output (rows, chunk_t,
//     last, visit words) is the walk over every slot's, bit for bit, under
//     both stop rules. On the render bins the warps evaluate 27.7 M (lane,
//     slot) pairs where the per-pixel walk evaluated 112.2 M, against a
//     floor of 25.9 M, the slots some lane applied
//     (profiling/count_pairs.py: warp_kept, evaluated, warp_visits).
//   - No exp skip: K1's skip of the exp below a falloff exponent of -5.6
//     made this walk 4% slower. The lanes of a warp evaluate one kept slot
//     together, and near a footprint they rarely all fall below the cut,
//     so the branch costs more than the exps it saves (PERF.md).
//   - Visit words without atomics: per walked slot the warp votes whether
//     any lane applied it, and lane 0 writes each non-zero word (the
//     wrapper zero-fills the rest).
// The block leaves the chunk loop once every pixel of the tile is done.
// K5 is common.cuh's
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

// K4's footprint cull; blend_kernels.footprint_extents is its plain
// version and says where each margin comes from. A slot whose opacity is
// below FOOT_OP_MIN gets ex = -1 (no pixel can apply it), one whose conic
// cannot be bounded ex = ey = inf (always evaluated).
constexpr float FOOT_OP_MIN = MIN_ALPHA * (1.f - 1e-5f);
constexpr float FOOT_Q_REL = 2e-6f;
constexpr float FOOT_REL = 1e-5f;
constexpr float FOOT_PAD_PX = 1e-3f;
// Where a staged slot keeps its half-extents: the spare floats of the
// SLOT_F layout, {cc, op, z, ex} and {r, g, b, ey}.
constexpr int EX_F = 7, EY_F = 11;

__device__ __forceinline__ void slot_extents(float ca, float cb, float cc, float op, float* ex,
                                             float* ey) {
  if (op < FOOT_OP_MIN) {
    *ex = *ey = -1.f;
    return;
  }
  const float det = ca * cc - cb * cb;
  const float tr = ca + cc;
  const float rho = FOOT_Q_REL * tr * tr / det;
  if (!(ca > 0.f && cc > 0.f && det > 0.f && rho < 0.5f)) {
    *ex = *ey = __int_as_float(0x7f800000);  // +inf
    return;
  }
  const float tau =
      (fmaxf(2.f * logf(255.f * op), 0.f) * (1.f + FOOT_REL) + FOOT_REL) / (1.f - rho);
  *ex = sqrtf(tau * cc / det) * (1.f + FOOT_REL) + FOOT_PAD_PX;
  *ey = sqrtf(tau * ca / det) * (1.f + FOOT_REL) + FOOT_PAD_PX;
}

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
  // The warp's rectangle of pixel centres.
  float x0 = pu, x1 = pu, y0 = pv, y1 = pv;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    x0 = fminf(x0, __shfl_xor_sync(FULL_MASK, x0, off));
    x1 = fmaxf(x1, __shfl_xor_sync(FULL_MASK, x1, off));
    y0 = fminf(y0, __shfl_xor_sync(FULL_MASK, y0, off));
    y1 = fmaxf(y1, __shfl_xor_sync(FULL_MASK, y1, off));
  }
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
    stage_slots(rows, packed + (size_t)c * N_ATTR * K, K, 0, K, p, px);
    for (int s = p; s < K; s += px) {  // the slots this thread staged
      float* r = rows + (size_t)s * SLOT_F;
      slot_extents(r[CA], r[CB], r[slot_field(CC)], r[slot_field(OP)], r + EX_F, r + EY_F);
    }
    __syncthreads();
    if (!__any_sync(FULL_MASK, !done)) continue;
    const int base = (c - c0) * K;
    unsigned* vw = visit + ((size_t)c * n_warps + (p >> 5)) * kw;
    for (int j = 0; j < kw; ++j) {
      // The 32 slots of word j whose footprint box meets the warp's
      // rectangle, walked in ascending order by the whole warp.
      const int sl = 32 * j + lane;
      bool keep = false;
      if (sl < K) {
        const float4 A = rows4[3 * sl], B = rows4[3 * sl + 1], C = rows4[3 * sl + 2];
        keep = !(B.w < 0.f) && !(A.x + B.w < x0) && !(A.x - B.w > x1) &&
               !(A.y + C.w < y0) && !(A.y - C.w > y1);
      }
      unsigned m = __ballot_sync(FULL_MASK, keep);
      unsigned word = 0u;
      bool warp_done = false;
      while (m != 0u) {
        const int b = __ffs(m) - 1;
        m &= m - 1u;
        const int k = 32 * j + b;
        bool applied = false;
        if (!done) {
          const float4 A = rows4[3 * k], B = rows4[3 * k + 1];
          float d0, d1;
          const float power = falloff_power(A.x, A.y, A.z, A.w, B.x, pu, pv, &d0, &d1);
          if (!(power > 0.f)) {  // a NaN power goes on, as in K3
            const float alpha = fminf(ALPHA_CLAMP, B.y * expf(power));
            if (alpha >= MIN_ALPHA) {
              const float Tn = T * (1.f - alpha);
              if (exact && Tn < STOP_T) {
                done = true;
              } else {
                const float w = alpha * T;
                const float4 C = rows4[3 * k + 2];
                const float z = B.z;
                Cr += w * C.x;
                Cg += w * C.y;
                Cb += w * C.z;
                D += w * z;
                S += w;
                if (T > 0.5f) Med = z;
                T = Tn;
                last = base + k;
                applied = true;
                if (!exact && T < STOP_T) done = true;
              }
            }
          }
        }
        if (__any_sync(FULL_MASK, applied)) word |= 1u << b;
        warp_done = !__any_sync(FULL_MASK, !done);
        if (warp_done) break;
      }
      if (word != 0u && lane == 0) vw[j] = word;  // the wrapper zero-fills the rest
      if (warp_done) break;
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
