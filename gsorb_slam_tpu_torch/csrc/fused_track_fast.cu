// K1: one whole tracking iteration per tile in one launch — forward blend,
// masked-L1 loss, cotangents and the backward to per-instance gradients.
//
// Replaces the TPU kernel raster/pallas_raster.py:_fused_track_kernel_fast
// (:952, per-chunk math in _chunk_fast :218), launched by the fast branch of
// tracking_loss_grad (:1484-1547). Contract per tile t (global id
// tile_ids[t], which sets the pixel origin):
//   - front-to-back blend of the depth-sorted screen instances with the
//     fast stop rule: an instance applies while the pixel's incoming T is
//     >= 1e-4; alpha = min(0.99, op exp(power)), skipped below 1/255 or for
//     power > 0;
//   - median depth = z of the instance where T crosses 0.5
//     (T > 0.5 and T (1 - alpha) <= 0.5), carrying no gradient;
//   - loss rows loss[t] = (im_w * sum mask |C - gt_C|, depth_w * sum mask
//     |depth - gt_d|), mask = alpha > 0.99 and gt depth > 0, depth = median
//     (use_sur) or blended;
//   - grads[t] = d loss / d packed[t] in the packed row layout: rows 0-9
//     (mu, mv, conic a b c, op, r, g, b, z), rows 10-15 zero, zero for dead
//     and never-reached slots. The median term sends no gradient, so with
//     use_sur the depth row's cotangent is 0.
// The TPU kernel leaves the blend at chunk granularity; this one stops per
// pixel, as the original renderer does. The two differ by less than 1e-4 in
// the blended outputs.
//
// What bounds it on the H100: per evaluated (pixel, instance) pair the
// forward spends ~16 f32 operations (falloff, exp, gates) and ~15 more when
// the instance applies; the backward evaluates the falloff again up to the
// pixel's last applied instance and spends ~53 per applied pair, its share
// of the pixel sums included. The packed block (39 MB at 1200 tiles x cap
// 512) and the gradient block are each moved once. The pairs, not bytes,
// set the time.
//
// Design: one block per tile, one thread per pixel, forward and backward in
// the same block so each pixel's state (final T, last applied instance,
// cotangents) stays in registers between them. Each chunk's 10 attribute
// rows are staged in shared memory (10 KB at K = 256). The backward walks
// back from each pixel's last applied instance and rebuilds T by division
// by (1 - alpha), as the original renderer's backward does, instead of
// storing per-(instance, pixel) slabs, which do not fit in shared memory.
// Per-instance sums over the tile's pixels use warp shuffles; each warp
// writes its sums into its own shared-memory slab, and the slabs are added
// in a fixed warp order (no atomics), so the result is bitwise
// reproducible. The backward stages BK = 64 instances at a time to keep the
// slabs at 20 KB. Each tile owns its [16, cap] gradient block, so no global
// atomics are needed.
#include "common.cuh"

using namespace gsorb;

constexpr int BK = 64;  // instances per backward sub-chunk

__global__ void __launch_bounds__(256) fused_track_fast_kernel(
    const float* __restrict__ packed, const int* __restrict__ counts,
    const int* __restrict__ tile_ids, const float* __restrict__ gt,
    float* __restrict__ grads, float* __restrict__ loss, int cap, int K, int tiles_x,
    int ts_x, int ts_y, float im_w, float depth_w, int use_sur) {
  extern __shared__ float smem[];
  float* attr = smem;                // [N_BLEND][K]; the backward uses [N_BLEND][BK]
  float* slab = smem + N_BLEND * max(K, BK);  // [n_warps][N_GRAD][BK] per-warp sums
  __shared__ float red[2][32];

  const int t = blockIdx.x;
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = px >> 5;
  const int tg = tile_ids[t];
  const float pu = (float)((tg % tiles_x) * ts_x + p % ts_x);
  const float pv = (float)((tg / tiles_x) * ts_y + p / ts_x);
  const int count = min(max(counts[t], 0), cap);
  const int n_live = (count + K - 1) / K;
  const float* pk = packed + (size_t)t * N_ATTR * cap;

  // ---- forward ----
  float T = 1.f, Cr = 0.f, Cg = 0.f, Cb = 0.f, D = 0.f, S = 0.f, Med = 0.f;
  bool done = false;
  int last = -1;  // index of this pixel's last applied instance
  int c_end = 0;  // chunks the block entered (block-uniform)
  for (int c = 0; c < n_live; ++c) {
    if (__syncthreads_count(!done) == 0) break;  // also fences the last chunk's reads
    const int base = c * K;
    stage_chunk(pk, cap, base, K, attr);
    __syncthreads();
    c_end = c + 1;
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
      const float w = alpha * T;
      const float Tn = T * (1.f - alpha);
      const float z = attr[Z * K + k];
      Cr += w * attr[CR * K + k];
      Cg += w * attr[CG * K + k];
      Cb += w * attr[CBL * K + k];
      D += w * z;
      S += w;
      if (T > 0.5f && Tn <= 0.5f) Med = z;
      T = Tn;
      last = base + k;
      if (T < STOP_T) {
        done = true;
        break;
      }
    }
  }

  // ---- loss and cotangents ----
  const float* g = gt + (size_t)t * 4 * px;
  const float gd = g[3 * px + p];
  const float mask = (S > 0.99f && gd > 0.f) ? 1.f : 0.f;
  const float dr = Cr - g[p];
  const float dg = Cg - g[px + p];
  const float db = Cb - g[2 * px + p];
  const float dpred = use_sur ? Med : D;
  float lc = mask * (fabsf(dr) + fabsf(dg) + fabsf(db));
  float ld = mask * fabsf(dpred - gd);
  auto sgn = [](float x) { return (float)((x > 0.f) - (x < 0.f)); };
  const float g_r = im_w * mask * sgn(dr);
  const float g_g = im_w * mask * sgn(dg);
  const float g_b = im_w * mask * sgn(db);
  const float g_d = use_sur ? 0.f : depth_w * mask * sgn(D - gd);

  lc = warp_sum(lc);
  ld = warp_sum(ld);
  if (lane == 0) {
    red[0][warp] = lc;
    red[1][warp] = ld;
  }
  __syncthreads();
  if (p == 0) {
    float a = 0.f, b = 0.f;
    for (int i = 0; i < n_warps; ++i) {
      a += red[0][i];
      b += red[1][i];
    }
    loss[2 * t] = im_w * a;
    loss[2 * t + 1] = depth_w * b;
  }

  // ---- backward ----
  // Walks back over [0, hi) in sub-chunks of BK instances. Each warp writes
  // its per-instance sums into its own slab slot, and the slabs are added in
  // warp order, so the gradients are bitwise reproducible.
  float* gr_t = grads + (size_t)t * N_ATTR * cap;
  const int hi = min(count, c_end * K);  // slots the forward may have applied
  float Tb = T;         // transmittance after the instance being visited
  float suffix = 0.f;   // sum over later applied instances of w * phi
  for (int base = ((hi + BK - 1) / BK - 1) * BK; base >= 0; base -= BK) {
    const int kmax = min(BK, hi - base);
    __syncthreads();  // earlier readers of attr / slab are done
    for (int i = p; i < N_BLEND * BK; i += px) {
      const int r = i / BK;
      const int kk = i - r * BK;
      attr[i] = kk < kmax ? pk[(size_t)r * cap + base + kk] : 0.f;
    }
    __syncthreads();
    for (int k = kmax - 1; k >= 0; --k) {
      float v[N_GRAD];
#pragma unroll
      for (int j = 0; j < N_GRAD; ++j) v[j] = 0.f;
      bool has = false;
      if (base + k <= last) {
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
                            g_b * attr[CBL * BK + k] + g_d * attr[Z * BK + k];
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
    for (int i = p; i < N_ATTR * kmax; i += px) {
      const int r = i / kmax;
      const int kk = i - r * kmax;
      float s = 0.f;
      if (r < N_GRAD)
        for (int w = 0; w < n_warps; ++w) s += slab[((size_t)w * N_GRAD + r) * BK + kk];
      gr_t[(size_t)r * cap + base + kk] = s;
    }
  }
  // Dead slots and slots of chunks the block never entered carry no gradient.
  const int tail = cap - hi;
  for (int i = p; i < N_ATTR * tail; i += px) {
    const int r = i / tail;
    const int kk = i - r * tail;
    gr_t[(size_t)r * cap + hi + kk] = 0.f;
  }
}

extern "C" int gsorb_fused_track_fast(const float* packed, const int* counts,
                                      const int* tile_ids, const float* gt, float* grads,
                                      float* loss, int n_tiles, int cap, int K,
                                      int tiles_x, int ts_x, int ts_y, float im_w,
                                      float depth_w, int use_sur, void* stream) {
  const size_t smem =
      ((size_t)N_BLEND * (K > BK ? K : BK) + (size_t)(ts_x * ts_y / 32) * N_GRAD * BK) *
      sizeof(float);
  cudaError_t err = allow_smem(fused_track_fast_kernel, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    fused_track_fast_kernel<<<n_tiles, ts_x * ts_y, smem, (cudaStream_t)stream>>>(
        packed, counts, tile_ids, gt, grads, loss, cap, K, tiles_x, ts_x, ts_y, im_w,
        depth_w, use_sur);
  }
  return (int)cudaGetLastError();
}
