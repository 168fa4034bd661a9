// K1, K7 and K8: one whole tracking iteration per tile in one launch —
// forward blend, masked-L1 loss, cotangents and the backward to
// per-instance gradients. One templated kernel, three entry points:
//
//   K1 gsorb_fused_track_fast  <EXACT = false, TILES = 1>
//     replaces raster/pallas_raster.py:_fused_track_kernel_fast (:952, per-
//     chunk math in _chunk_fast :218), the fast branch of tracking_loss_grad
//     (:1484-1547);
//   K7 gsorb_fused_track_exact <EXACT = true, TILES = 1>
//     replaces raster/pallas_raster.py:_fused_track_kernel_exact (:767-950),
//     the exact branch of tracking_loss_grad (:1433-1482);
//   K8 gsorb_paired_track      <EXACT = false, TILES = 2>
//     replaces raster/paired.py:_paired_track_kernel (:173), launched by
//     tracking_loss_grad_paired (:406).
//
// Contract per tile row t (global tile id tile_ids[t], which sets the pixel
// origin):
//   - front-to-back blend of the depth-sorted screen instances;
//     alpha = min(0.99, op exp(power)), skipped below 1/255 or for power > 0.
//     Fast stop (K1, K8): an instance applies while the pixel's incoming T
//     is >= 1e-4. Exact stop (K7): the instance whose blend would take T
//     below 1e-4 is not applied and the pixel stops there;
//   - median depth, carrying no gradient: fast, the z of the instance where
//     T crosses 0.5 (T > 0.5 and T (1 - alpha) <= 0.5); exact, the z of the
//     last applied instance with incoming T > 0.5 (the TPU exact kernel's
//     rule; the two agree wherever the pixel's T falls below 0.5, which the
//     loss mask alpha > 0.99 requires);
//   - loss rows loss[t] = (im_w * sum mask |C - gt_C|, depth_w * sum mask
//     |depth - gt_d|), mask = alpha > 0.99 and gt depth > 0, depth = median
//     (use_sur) or blended;
//   - grads[t] = d loss / d packed[t] in the packed row layout: rows 0-9
//     (mu, mv, conic a b c, op, r, g, b, z), rows 10-15 zero, zero for dead
//     and never-reached slots. The median term sends no gradient, so with
//     use_sur the depth row's cotangent is 0.
// gt is [T / TILES, 4, TILES * px]: row r of tile row TILES b + h lives in
// lanes [h px, (h + 1) px) of block row b (K8's paired layout; K1 and K7
// take the plain [T, 4, px]).
// The TPU kernels leave the fast blend at chunk granularity (K8 when both
// halves of a pair are done); these stop per pixel, as the original renderer
// does. The two differ by less than 1e-4 in the blended outputs.
//
// What bounds them on the H100: per evaluated (pixel, instance) pair the
// forward spends ~16 f32 operations (falloff, exp, gates) and ~15 more when
// the instance applies; the backward evaluates the falloff again up to the
// pixel's last applied instance and spends ~53 per applied pair, its share
// of the pixel sums included. The packed block (39 MB at 1200 tiles x cap
// 512) and the gradient block are each moved once. The pairs, not bytes,
// set the time.
//
// Design: one block per tile (K8: per pair of rect tiles, threads [0, px)
// the first tile's pixels and [px, 2 px) the second's), one thread per
// pixel, forward and backward in the same block so each pixel's state
// (final T, last applied instance, cotangents) stays in registers between
// them. Each tile stages its own chunk's 10 attribute rows in shared memory
// (10 KB at K = 256); the block walks the chunks of its longer tile and
// leaves the chunk loop once every pixel of both is done. The backward
// walks back from each pixel's last applied instance and rebuilds T by
// division by (1 - alpha), as the original renderer's backward does,
// instead of storing per-(instance, pixel) slabs, which do not fit in shared
// memory. Per-instance sums over a tile's pixels use warp shuffles; each
// warp writes its sums into its own shared-memory slab, and each tile adds
// its warps' slabs in a fixed warp order (no atomics), so the result is
// bitwise reproducible. The backward stages BK = 64 instances at a time to
// keep the slabs at 20 KB. Each tile owns its [16, cap] gradient block, so no
// global atomics are needed.
#include "common.cuh"

using namespace gsorb;

constexpr int BK = 64;        // instances per backward sub-chunk
constexpr int MAX_WARPS = 8;  // 256 threads per block

// Copies the N_BLEND attribute rows of slots [base, base + K) of one tile's
// packed block into attr [N_BLEND][K], with the tile's threads
// p = 0 .. np - 1, coalesced along the slots.
__device__ __forceinline__ void stage_rows(const float* __restrict__ pk, int cap, int base,
                                           int K, float* __restrict__ attr, int p, int np) {
  for (int i = p; i < N_BLEND * K; i += np) {
    const int r = i / K;
    attr[i] = pk[(size_t)r * cap + base + i - r * K];
  }
}

// As stage_rows for slots [base, base + n) into attr [N_BLEND][stride],
// zero past n.
__device__ __forceinline__ void stage_rows_padded(const float* __restrict__ pk, int cap,
                                                  int base, int n, int stride,
                                                  float* __restrict__ attr, int p, int np) {
  for (int i = p; i < N_BLEND * stride; i += np) {
    const int r = i / stride;
    const int k = i - r * stride;
    attr[i] = k < n ? pk[(size_t)r * cap + base + k] : 0.f;
  }
}

template <bool EXACT, int TILES>
__global__ void __launch_bounds__(256) fused_track_kernel(
    const float* __restrict__ packed, const int* __restrict__ counts,
    const int* __restrict__ tile_ids, const float* __restrict__ gt,
    float* __restrict__ grads, float* __restrict__ loss, int cap, int K, int tiles_x,
    int ts_x, int ts_y, float im_w, float depth_w, int use_sur) {
  extern __shared__ float smem[];
  __shared__ float red[2][MAX_WARPS];

  const int tpx = ts_x * ts_y;  // pixels (threads) per tile
  const int half = TILES == 1 ? 0 : (int)threadIdx.x / tpx;  // this thread's tile
  const int p = threadIdx.x - half * tpx;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile_warps = tpx >> 5;
  const int w0 = half * tile_warps;  // the tile's first warp
  const int stride = max(K, BK);
  // [TILES][N_BLEND][stride] staged rows, then [warps][N_GRAD][BK] slabs.
  float* attr = smem + (size_t)half * N_BLEND * stride;
  float* slab = smem + (size_t)TILES * N_BLEND * stride;

  const int t = blockIdx.x * TILES + half;
  const int tg = tile_ids[t];
  const float pu = (float)((tg % tiles_x) * ts_x + p % ts_x);
  const float pv = (float)((tg / tiles_x) * ts_y + p / ts_x);
  const int count = min(max(counts[t], 0), cap);
  // The other tile of a K8 block; the block walks the longer tile's chunks.
  const int other = TILES == 1 ? count : min(max(counts[t + 1 - 2 * half], 0), cap);
  const int n_live = (max(count, other) + K - 1) / K;
  const float* pk = packed + (size_t)t * N_ATTR * cap;

  // ---- forward ----
  float T = 1.f, Cr = 0.f, Cg = 0.f, Cb = 0.f, D = 0.f, S = 0.f, Med = 0.f;
  bool done = false;
  int last = -1;  // index of this pixel's last applied instance
  int c_end = 0;  // chunks the block entered (block-uniform)
  for (int c = 0; c < n_live; ++c) {
    if (__syncthreads_count(!done) == 0) break;  // also fences the last chunk's reads
    const int base = c * K;
    const int kmax = min(K, count - base);  // <= 0 once this tile's instances ran out
    if (kmax > 0) stage_rows(pk, cap, base, K, attr, p, tpx);
    __syncthreads();
    c_end = c + 1;
    if (done) continue;
    for (int k = 0; k < kmax; ++k) {
      float d0, d1;
      const float power = falloff_power(attr[MU * K + k], attr[MV * K + k],
                                        attr[CA * K + k], attr[CB * K + k],
                                        attr[CC * K + k], pu, pv, &d0, &d1);
      if (power > 0.f) continue;
      const float alpha = fminf(ALPHA_CLAMP, attr[OP * K + k] * expf(power));
      if (alpha < MIN_ALPHA) continue;
      const float Tn = T * (1.f - alpha);
      if (EXACT && Tn < STOP_T) {
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
      if (EXACT ? T > 0.5f : (T > 0.5f && Tn <= 0.5f)) Med = z;
      T = Tn;
      last = base + k;
      if (!EXACT && T < STOP_T) {
        done = true;
        break;
      }
    }
  }

  // ---- loss and cotangents ----
  const int bpx = TILES * tpx;
  const float* g = gt + (size_t)blockIdx.x * 4 * bpx;
  const int q = threadIdx.x;
  const float gd = g[3 * bpx + q];
  const float mask = (S > 0.99f && gd > 0.f) ? 1.f : 0.f;
  const float dr = Cr - g[q];
  const float dg = Cg - g[bpx + q];
  const float db = Cb - g[2 * bpx + q];
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
    for (int i = w0; i < w0 + tile_warps; ++i) {
      a += red[0][i];
      b += red[1][i];
    }
    loss[2 * t] = im_w * a;
    loss[2 * t + 1] = depth_w * b;
  }

  // ---- backward ----
  // Walks back over [0, hi) in sub-chunks of BK instances; the block walks
  // the longer tile's range. Each warp writes its per-instance sums into its
  // own slab slot, and each tile adds its warps' slabs in warp order, so the
  // gradients are bitwise reproducible.
  float* gr_t = grads + (size_t)t * N_ATTR * cap;
  const int hi = min(count, c_end * K);  // slots the forward may have applied
  const int hi_max = min(max(count, other), c_end * K);  // block-uniform
  float Tb = T;        // transmittance after the instance being visited
  float suffix = 0.f;  // sum over later applied instances of w * phi
  for (int base = ((hi_max + BK - 1) / BK - 1) * BK; base >= 0; base -= BK) {
    const int kmax = min(BK, hi - base);  // <= 0: this tile has no slots here
    __syncthreads();  // earlier readers of attr / slab are done
    stage_rows_padded(pk, cap, base, kmax, BK, attr, p, tpx);
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
    for (int i = p; i < N_ATTR * kmax; i += tpx) {
      const int r = i / kmax;
      const int kk = i - r * kmax;
      float s = 0.f;
      if (r < N_GRAD)
        for (int w = w0; w < w0 + tile_warps; ++w) s += slab[((size_t)w * N_GRAD + r) * BK + kk];
      gr_t[(size_t)r * cap + base + kk] = s;
    }
  }
  // Dead slots and slots of chunks the block never entered carry no gradient.
  const int tail = cap - hi;
  for (int i = p; i < N_ATTR * tail; i += tpx) {
    const int r = i / tail;
    const int kk = i - r * tail;
    gr_t[(size_t)r * cap + hi + kk] = 0.f;
  }
}

template <bool EXACT, int TILES>
static int launch(const float* packed, const int* counts, const int* tile_ids, const float* gt,
                  float* grads, float* loss, int n_tiles, int cap, int K, int tiles_x, int ts_x,
                  int ts_y, float im_w, float depth_w, int use_sur, void* stream) {
  const int threads = TILES * ts_x * ts_y;
  if (threads > MAX_WARPS * 32 || (ts_x * ts_y) % 32 || n_tiles % TILES)
    return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)TILES * N_BLEND * (K > BK ? K : BK) +
                       (size_t)(threads / 32) * N_GRAD * BK) *
                      sizeof(float);
  cudaError_t err = allow_smem(fused_track_kernel<EXACT, TILES>, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    fused_track_kernel<EXACT, TILES><<<n_tiles / TILES, threads, smem, (cudaStream_t)stream>>>(
        packed, counts, tile_ids, gt, grads, loss, cap, K, tiles_x, ts_x, ts_y, im_w, depth_w,
        use_sur);
  }
  return (int)cudaGetLastError();
}

#define GSORB_TRACK_ARGS                                                                   \
  const float *packed, const int *counts, const int *tile_ids, const float *gt, float *grads, \
      float *loss, int n_tiles, int cap, int K, int tiles_x, int ts_x, int ts_y, float im_w,  \
      float depth_w, int use_sur, void *stream
#define GSORB_TRACK_CALL                                                                  \
  packed, counts, tile_ids, gt, grads, loss, n_tiles, cap, K, tiles_x, ts_x, ts_y, im_w, \
      depth_w, use_sur, stream

extern "C" int gsorb_fused_track_fast(GSORB_TRACK_ARGS) {
  return launch<false, 1>(GSORB_TRACK_CALL);
}

extern "C" int gsorb_fused_track_exact(GSORB_TRACK_ARGS) {
  return launch<true, 1>(GSORB_TRACK_CALL);
}

extern "C" int gsorb_paired_track(GSORB_TRACK_ARGS) {
  return launch<false, 2>(GSORB_TRACK_CALL);
}
