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
//     tracking_loss_grad_paired (:406);
//   K9 gsorb_fused_track_ablate_<variant> <EXACT = false, TILES = 1, ABL>
//     replaces scripts/profile_fused_ablate.py:_kernel (:60, launched at
//     :255), the profiling copy of K1 (see "K9" below).
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
//
// K9, the ablation copy of K1 (timing only, except "full" and the loss rows
// of "fwd"): the template's third parameter ABL is a bit set of switches,
// 0 for K1, K7 and K8, whose code `if constexpr` keeps as it is. Every K9
// variant sets ABL_FIXED: each tile walks exactly ABLATE_CHUNKS chunks,
// slots [0, ABLATE_CHUNKS K), whatever its count (dead slots read the
// pack's zero row, so their alpha is 0), with no transmittance stop, so
// every variant evaluates the same pairs. Its gradient rows at and past
// ABLATE_CHUNKS K are zero. The other switches turn parts off:
//   ABL_NOBWD    the forward and the loss rows only; the gradient block is 0;
//   ABL_NOEXP    each expf (forward and backward) becomes one FMA,
//                1 + power / 5.5, which crosses 0 where exp crosses 1/255
//                at op = 1, so about as many pairs pass the gate;
//   ABL_NOREDUCE each per-instance sum over the tile's pixels (the warp
//                shuffles, the per-warp slabs and their ordered adds) becomes
//                one lane's own value;
//   ABL_HALF2    the forward falloff and alpha of two instances per step in
//                __half2 (offsets clamped to +-64 px so the products stay
//                finite); the blend itself stays float32.
// With no stop a pixel's T falls through float32's range (0.8^512 ~ 1e-50),
// and the backward's rebuild of T by division from the final T would give 0
// for every instance in front. So the forward records the anchor, the last
// applied slot whose outgoing T is still >= 1e-30, and that T. The backward
// still evaluates every pair after the anchor, with T taken as 0 there (their
// weights are below 1e-30), and from the anchor back rebuilds T by division
// from the recorded T. The error this leaves is below 1e-30 times a
// cotangent.
#include <cuda_fp16.h>

#include "common.cuh"

using namespace gsorb;

constexpr int BK = 64;        // instances per backward sub-chunk
constexpr int MAX_WARPS = 8;  // 256 threads per block

// K9's switches (see the header) and its fixed walk.
constexpr int ABL_FIXED = 1;
constexpr int ABL_NOBWD = 2;
constexpr int ABL_NOEXP = 4;
constexpr int ABL_NOREDUCE = 8;
constexpr int ABL_HALF2 = 16;
constexpr int ABLATE_CHUNKS = 2;
constexpr float ANCHOR_T = 1e-30f;

// exp(power), or its stand-in under ABL_NOEXP.
template <int ABL>
__device__ __forceinline__ float gauss(float power) {
  if constexpr ((ABL & ABL_NOEXP) != 0) {
    return fmaf(power, 1.f / 5.5f, 1.f);
  } else {
    return expf(power);
  }
}

// ABL_HALF2: the falloff exponents and alphas of instances k and k + 1 of
// the staged rows attr [N_BLEND][K] at pixel (pu, pv), in __half2.
__device__ __forceinline__ void half2_alpha(const float* __restrict__ attr, int K, int k,
                                            float pu, float pv, float2* power, float2* alpha) {
  auto off = [](float x) { return fminf(fmaxf(x, -64.f), 64.f); };
  const __half2 d0 = __floats2half2_rn(off(attr[MU * K + k] - pu), off(attr[MU * K + k + 1] - pu));
  const __half2 d1 = __floats2half2_rn(off(attr[MV * K + k] - pv), off(attr[MV * K + k + 1] - pv));
  const __half2 ca = __floats2half2_rn(attr[CA * K + k], attr[CA * K + k + 1]);
  const __half2 cb = __floats2half2_rn(attr[CB * K + k], attr[CB * K + k + 1]);
  const __half2 cc = __floats2half2_rn(attr[CC * K + k], attr[CC * K + k + 1]);
  const __half2 op = __floats2half2_rn(attr[OP * K + k], attr[OP * K + k + 1]);
  const __half2 h = __float2half2_rn(0.5f);
  __half2 s = __hmul2(__hmul2(h, ca), __hmul2(d0, d0));
  s = __hfma2(__hmul2(h, cc), __hmul2(d1, d1), s);
  s = __hfma2(cb, __hmul2(d0, d1), s);
  const __half2 pw = __hneg2(s);
  const __half2 a = __hmin2(__float2half2_rn(ALPHA_CLAMP), __hmul2(op, h2exp(pw)));
  *power = __half22float2(pw);
  *alpha = __half22float2(a);
}

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

template <bool EXACT, int TILES, int ABL = 0>
__global__ void __launch_bounds__(256) fused_track_kernel(
    const float* __restrict__ packed, const int* __restrict__ counts,
    const int* __restrict__ tile_ids, const float* __restrict__ gt,
    float* __restrict__ grads, float* __restrict__ loss, int cap, int K, int tiles_x,
    int ts_x, int ts_y, float im_w, float depth_w, int use_sur) {
  constexpr bool FIXED = (ABL & ABL_FIXED) != 0;  // K9
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
  const int count = FIXED ? ABLATE_CHUNKS * K : min(max(counts[t], 0), cap);
  // The other tile of a K8 block; the block walks the longer tile's chunks.
  const int other = TILES == 1 ? count : min(max(counts[t + 1 - 2 * half], 0), cap);
  const int n_live = (max(count, other) + K - 1) / K;
  const float* pk = packed + (size_t)t * N_ATTR * cap;

  // ---- forward ----
  float T = 1.f, Cr = 0.f, Cg = 0.f, Cb = 0.f, D = 0.f, S = 0.f, Med = 0.f;
  bool done = false;
  int last = -1;  // index of this pixel's last applied instance
  int c_end = 0;  // chunks the block entered (block-uniform)
  int anchor = -1;       // K9: the last applied slot whose outgoing T >= ANCHOR_T,
  float T_anchor = 0.f;  // and that T
  for (int c = 0; c < n_live; ++c) {
    if (__syncthreads_count(!done) == 0) break;  // also fences the last chunk's reads
    const int base = c * K;
    const int kmax = min(K, count - base);  // <= 0 once this tile's instances ran out
    if (kmax > 0) stage_rows(pk, cap, base, K, attr, p, tpx);
    __syncthreads();
    c_end = c + 1;
    if (done) continue;
    if constexpr ((ABL & ABL_HALF2) != 0) {
      for (int k = 0; k < kmax; k += 2) {
        float2 pw, al;
        half2_alpha(attr, K, k, pu, pv, &pw, &al);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float alpha = h ? al.y : al.x;
          if ((h ? pw.y : pw.x) > 0.f || alpha < MIN_ALPHA) continue;
          const float Tn = T * (1.f - alpha);
          const float w = alpha * T;
          const float z = attr[Z * K + k + h];
          Cr += w * attr[CR * K + k + h];
          Cg += w * attr[CG * K + k + h];
          Cb += w * attr[CBL * K + k + h];
          D += w * z;
          S += w;
          if (T > 0.5f && Tn <= 0.5f) Med = z;
          T = Tn;
          last = base + k + h;
          if (T >= ANCHOR_T) {
            anchor = last;
            T_anchor = T;
          }
        }
      }
    } else {
      for (int k = 0; k < kmax; ++k) {
        float d0, d1;
        const float power = falloff_power(attr[MU * K + k], attr[MV * K + k],
                                          attr[CA * K + k], attr[CB * K + k],
                                          attr[CC * K + k], pu, pv, &d0, &d1);
        if (power > 0.f) continue;
        const float alpha = fminf(ALPHA_CLAMP, attr[OP * K + k] * gauss<ABL>(power));
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
        if constexpr (FIXED) {
          if (T >= ANCHOR_T) {
            anchor = last;
            T_anchor = T;
          }
        }
        if (!EXACT && !FIXED && T < STOP_T) {
          done = true;
          break;
        }
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
  // Slots the forward may have applied (none under ABL_NOBWD: the tail
  // loop below then zeroes the whole block).
  const int hi = (ABL & ABL_NOBWD) ? 0 : min(count, c_end * K);
  const int hi_max = (ABL & ABL_NOBWD) ? 0 : min(max(count, other), c_end * K);  // block-uniform
  // Transmittance after the instance being visited (K9: 0 past the anchor).
  float Tb = FIXED ? 0.f : T;
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
        const float alpha = fminf(ALPHA_CLAMP, op * gauss<ABL>(power));
        if (power <= 0.f && alpha >= MIN_ALPHA) {
          if constexpr (FIXED) {
            if (base + k == anchor) Tb = T_anchor;
          }
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
      if constexpr ((ABL & ABL_NOREDUCE) != 0) {
        if (lane == (k & 31)) {
#pragma unroll
          for (int j = 0; j < N_GRAD; ++j) sw[j * BK] = v[j];
        }
      } else if (__any_sync(FULL_MASK, has)) {
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
      if (r < N_GRAD) {
        if constexpr ((ABL & ABL_NOREDUCE) != 0) {
          s = slab[((size_t)w0 * N_GRAD + r) * BK + kk];
        } else {
          for (int w = w0; w < w0 + tile_warps; ++w) s += slab[((size_t)w * N_GRAD + r) * BK + kk];
        }
      }
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

template <bool EXACT, int TILES, int ABL = 0>
static int launch(const float* packed, const int* counts, const int* tile_ids, const float* gt,
                  float* grads, float* loss, int n_tiles, int cap, int K, int tiles_x, int ts_x,
                  int ts_y, float im_w, float depth_w, int use_sur, void* stream) {
  const int threads = TILES * ts_x * ts_y;
  if (threads > MAX_WARPS * 32 || (ts_x * ts_y) % 32 || n_tiles % TILES)
    return (int)cudaErrorInvalidValue;
  if ((ABL & ABL_FIXED) && (ABLATE_CHUNKS * K > cap || K % 2)) return (int)cudaErrorInvalidValue;
  const size_t smem = ((size_t)TILES * N_BLEND * (K > BK ? K : BK) +
                       (size_t)(threads / 32) * N_GRAD * BK) *
                      sizeof(float);
  cudaError_t err = allow_smem(fused_track_kernel<EXACT, TILES, ABL>, smem);
  if (err != cudaSuccess) return (int)err;
  if (n_tiles > 0) {
    fused_track_kernel<EXACT, TILES, ABL><<<n_tiles / TILES, threads, smem, (cudaStream_t)stream>>>(
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

// K9's variants (counts is not read). "full" is K1's math over the fixed
// walk; the others are timing only, except the loss rows of "fwd".
#define GSORB_ABLATE(variant, switches)                                \
  extern "C" int gsorb_fused_track_ablate_##variant(GSORB_TRACK_ARGS) { \
    return launch<false, 1, ABL_FIXED | (switches)>(GSORB_TRACK_CALL);  \
  }

GSORB_ABLATE(full, 0)
GSORB_ABLATE(fwd, ABL_NOBWD)
GSORB_ABLATE(noexp, ABL_NOEXP)
GSORB_ABLATE(noreduce, ABL_NOREDUCE)
GSORB_ABLATE(min, ABL_NOEXP | ABL_NOREDUCE)
GSORB_ABLATE(half2, ABL_HALF2)
