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
// What bounds them on the H100: the (pixel, instance) pairs, not bytes (the
// packed block, 39 MB at 1200 tiles x cap 512, and the gradient block are
// each moved once). Per evaluated pair the forward spends ~16 f32
// operations (falloff, exp, gates) and ~15 more when the instance applies;
// the backward spends ~53 per applied pair, its share of the pixel sums
// included. What it costs beyond that is instruction overhead per pair:
// shared-memory loads, branches, and per-slot bookkeeping of the warp.
//
// Design: one block per tile (K8: per pair of rect tiles, threads [0, px)
// the first tile's pixels and [px, 2 px) the second's), one thread per
// pixel, forward and backward in the same block so each pixel's state
// (final T, last applied instance, cotangents) stays in registers between
// them.
//   - Rows per slot. Each chunk's live rows go to shared memory once for
//     the forward, per slot (common.cuh's SLOT_F layout: a pair's falloff
//     inputs are two 16-byte broadcast loads), and each backward window of
//     64 slots is staged again from global memory (L2) before its warps
//     visit it. So the shared memory does not grow with the capacity: 32.5
//     KB a block at cap 512 (K8's two tiles 44.5 KB). Keeping every slot
//     staged from the forward to the backward (24 KB a tile at cap 512, 96
//     KB at 2048) bought at most 0.5% at cap 512, cost K8 8% and K1 5.5% at
//     cap 1024 in blocks per SM, and could not launch past cap ~2200 (K8)
//     or ~4300 (K1) (PERF.md). Copying chunk c + 1 by cp.async
//     while chunk c blends bought < 1%: the co-resident blocks already hide
//     the copy, so it is a plain copy. The block leaves the chunk loop once
//     every pixel is done.
//   - The forward skips the exp of a pair whose falloff exponent is below
//     -5.6: with op <= 1 it cannot pass the 1/255 gate, so the applied
//     pairs, and every output, are the same.
//   - Visit words. Each pixel that applies slot s sets bit s of its warp's
//     word s / 32 in shared memory (an integer atomicOr: the OR does not
//     depend on the order). The backward walks, per warp, only those set
//     bits from high to low: at the main path's pack the warps visit 25.8 M
//     (lane, slot) pairs where a walk to each pixel's last applied slot
//     evaluates 106.4 M (profiling/count_pairs.py). Each lane still checks
//     slot <= last and the gate, so the stop rules and the median are
//     unchanged; it rebuilds T by division by (1 - alpha), as the original
//     renderer's backward does.
//   - Sums without atomics. Per visited slot a warp sums its lanes' ten
//     gradient terms by a halving tree of 16 shuffles (the same pairs, and
//     so the same floats, as ten shuffle-down sums of 50) into its
//     shared-memory slab; per window of
//     64 slots each tile adds, slot by slot and in warp order, the slabs of
//     the warps that visited the slot, and writes every row of the window
//     (zeros included). Every rerun is bit for bit; each tile owns its
//     [16, cap] gradient block, so no global atomics are needed.
// No tensor cores: the one contraction, the pixel sums, is 10-13% of the
// time (K9's noreduce); the rest is per-pair elementwise work with data-
// dependent stops, which wgmma has nothing of size to work on. TMA tensor
// maps buy nothing for 3 KB row windows.
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
//                one lane's own value, that of the first warp that visited
//                the slot;
//   ABL_HALF2    the forward falloff and alpha of two instances per step in
//                __half2 (offsets clamped to +-64 px so the products stay
//                finite); the blend itself stays float32.
// With no stop a pixel's T falls through float32's range (0.8^512 ~ 1e-50),
// and the backward's rebuild of T by division from the final T would give 0
// for every instance in front. So the forward records the anchor, the last
// applied slot whose outgoing T is still >= 1e-30, and that T. The backward
// still visits every applied slot after the anchor, with T taken as 0 there
// (their weights are below 1e-30), and from the anchor back rebuilds T by
// division from the recorded T. The error this leaves is below 1e-30 times a
// cotangent.
#include <cuda_fp16.h>

#include "common.cuh"

using namespace gsorb;

constexpr int MAX_WARPS = 8;  // 256 threads per block

// K9's switches (see the header) and its fixed walk.
constexpr int ABL_FIXED = 1;
constexpr int ABL_NOBWD = 2;
constexpr int ABL_NOEXP = 4;
constexpr int ABL_NOREDUCE = 8;
constexpr int ABL_HALF2 = 16;
constexpr int ABLATE_CHUNKS = 2;
constexpr float ANCHOR_T = 1e-30f;
// exp(-5.6) < 1/255: with op <= 1 no pair whose falloff exponent lies below
// this passes the forward's alpha gate.
constexpr float POWER_CUT = -5.6f;

// exp(power), or its stand-in under ABL_NOEXP.
template <int ABL>
__device__ __forceinline__ float gauss(float power) {
  if constexpr ((ABL & ABL_NOEXP) != 0) {
    return fmaf(power, 1.f / 5.5f, 1.f);
  } else {
    return expf(power);
  }
}

// ABL_HALF2: the falloff exponents and alphas of the staged slots s and
// s + 1 at pixel (pu, pv), in __half2.
__device__ __forceinline__ void half2_alpha(const float4* __restrict__ r4, int s, float pu,
                                            float pv, float2* power, float2* alpha) {
  auto off = [](float x) { return fminf(fmaxf(x, -64.f), 64.f); };
  const float4 A0 = r4[3 * s], B0 = r4[3 * s + 1], A1 = r4[3 * s + 3], B1 = r4[3 * s + 4];
  const __half2 d0 = __floats2half2_rn(off(A0.x - pu), off(A1.x - pu));
  const __half2 d1 = __floats2half2_rn(off(A0.y - pv), off(A1.y - pv));
  const __half2 ca = __floats2half2_rn(A0.z, A1.z);
  const __half2 cb = __floats2half2_rn(A0.w, A1.w);
  const __half2 cc = __floats2half2_rn(B0.x, B1.x);
  const __half2 op = __floats2half2_rn(B0.y, B1.y);
  const __half2 h = __float2half2_rn(0.5f);
  __half2 t = __hmul2(__hmul2(h, ca), __hmul2(d0, d0));
  t = __hfma2(__hmul2(h, cc), __hmul2(d1, d1), t);
  t = __hfma2(cb, __hmul2(d0, d1), t);
  const __half2 pw = __hneg2(t);
  const __half2 a = __hmin2(__float2half2_rn(ALPHA_CLAMP), __hmul2(op, h2exp(pw)));
  *power = __half22float2(pw);
  *alpha = __half22float2(a);
}

template <bool EXACT, int TILES, int ABL = 0>
__global__ void __launch_bounds__(256) fused_track_kernel(
    const float* __restrict__ packed, const int* __restrict__ counts,
    const int* __restrict__ tile_ids, const float* __restrict__ gt,
    float* __restrict__ grads, float* __restrict__ loss, int cap, int K, int tiles_x,
    int ts_x, int ts_y, float im_w, float depth_w, int use_sur) {
  constexpr bool FIXED = (ABL & ABL_FIXED) != 0;  // K9
  constexpr bool NOREDUCE = (ABL & ABL_NOREDUCE) != 0;
  extern __shared__ float4 smem4[];
  __shared__ float red[2][MAX_WARPS];

  const int tpx = ts_x * ts_y;  // pixels (threads) per tile
  const int half = TILES == 1 ? 0 : (int)threadIdx.x / tpx;  // this thread's tile
  const int p = threadIdx.x - half * tpx;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int tile_warps = tpx >> 5;
  const int w0 = half * tile_warps;  // the tile's first warp
  const int cw = (cap + 31) >> 5;    // visit words per warp
  // [TILES][n_rows][SLOT_F] staged rows (one chunk in the forward, one
  // window in the backward; slot s at s - the first slot), [warps][N_GRAD]
  // [WIN] slabs, then [warps][cw] visit words.
  const int n_rows = max(K, WIN);
  float* smem = reinterpret_cast<float*>(smem4);
  float* rows = smem + (size_t)half * n_rows * SLOT_F;
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  float* slab = smem + (size_t)TILES * n_rows * SLOT_F;
  unsigned* words = reinterpret_cast<unsigned*>(slab + (size_t)TILES * tile_warps * N_GRAD * WIN);
  unsigned* my_words = words + warp * cw;

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
  for (int j = lane; j < cw; j += 32) my_words[j] = 0u;
  float T = 1.f, Cr = 0.f, Cg = 0.f, Cb = 0.f, D = 0.f, S = 0.f, Med = 0.f;
  bool done = false;
  int last = -1;  // index of this pixel's last applied instance
  int c_end = 0;  // chunks the block entered (block-uniform)
  int anchor = -1;       // K9: the last applied slot whose outgoing T >= ANCHOR_T,
  float T_anchor = 0.f;  // and that T
  for (int c = 0; c < n_live; ++c) {
    const int base = c * K;
    const int kmax = min(K, count - base);  // <= 0 once this tile's instances ran out
    // Chunk c's rows replace chunk c - 1's once their readers are done.
    if (c > 0) __syncthreads();
    stage_slots(rows, pk + base, cap, 0, kmax, p, tpx);
    // The rows are in (and the words zeroed); every pixel done ends it.
    if (__syncthreads_count(!done) == 0) break;
    c_end = c + 1;
    if (done) continue;
    if constexpr ((ABL & ABL_HALF2) != 0) {
      for (int k = 0; k < kmax; k += 2) {
        float2 pw, al;
        half2_alpha(r4, k, pu, pv, &pw, &al);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float alpha = h ? al.y : al.x;
          if ((h ? pw.y : pw.x) > 0.f || alpha < MIN_ALPHA) continue;
          const int s = base + k + h;
          const float Tn = T * (1.f - alpha);
          const float w = alpha * T;
          const float4 B = r4[3 * (k + h) + 1], C = r4[3 * (k + h) + 2];
          Cr += w * C.x;
          Cg += w * C.y;
          Cb += w * C.z;
          D += w * B.z;
          S += w;
          if (T > 0.5f && Tn <= 0.5f) Med = B.z;
          T = Tn;
          last = s;
          mark_visit(my_words, s);
          if (T >= ANCHOR_T) {
            anchor = last;
            T_anchor = T;
          }
        }
      }
    } else {
      for (int k = 0; k < kmax; ++k) {
        const int s = base + k;
        const float4 A = r4[3 * k], B = r4[3 * k + 1];
        float d0, d1;
        const float power = falloff_power(A.x, A.y, A.z, A.w, B.x, pu, pv, &d0, &d1);
        // Below POWER_CUT no pair with op <= 1 passes the alpha gate: its
        // exp is skipped, and the applied pairs are the same.
        if (power > 0.f || (power < POWER_CUT && B.y <= 1.f)) continue;
        const float alpha = fminf(ALPHA_CLAMP, B.y * gauss<ABL>(power));
        if (alpha < MIN_ALPHA) continue;
        const float Tn = T * (1.f - alpha);
        if (EXACT && Tn < STOP_T) {
          done = true;
          break;
        }
        const float w = alpha * T;
        const float4 C = r4[3 * k + 2];
        Cr += w * C.x;
        Cg += w * C.y;
        Cb += w * C.z;
        D += w * B.z;
        S += w;
        if (EXACT ? T > 0.5f : (T > 0.5f && Tn <= 0.5f)) Med = B.z;
        T = Tn;
        last = s;
        mark_visit(my_words, s);
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
  // Windows of WIN slots over [0, hi_max), high to low (block-uniform; the
  // block walks the longer tile's range). In each, every warp visits the
  // slots its lanes applied and writes its sums into its slab; then each
  // tile adds, slot by slot, the slabs of its warps that visited the slot,
  // in warp order, and writes every row of the window. Slots past the last
  // window carry no gradient (none under ABL_NOBWD).
  float* gr_t = grads + (size_t)t * N_ATTR * cap;
  const int hi_max = (ABL & ABL_NOBWD) ? 0 : min(max(count, other), c_end * K);
  const int n_win = (hi_max + WIN - 1) / WIN;
  // Transmittance after the instance being visited (K9: 0 past the anchor).
  float Tb = FIXED ? 0.f : T;
  float suffix = 0.f;  // sum over later applied instances of w * phi
  for (int base = (n_win - 1) * WIN; base >= 0; base -= WIN) {
    __syncthreads();  // the last window's row and slab readers are done
    stage_slots(rows, pk + base, cap, 0, min(WIN, count - base), p, tpx);
    __syncthreads();
    for_each_visited(my_words, cw, base, [&](int s) {
      float v[N_GRAD];
#pragma unroll
      for (int j = 0; j < N_GRAD; ++j) v[j] = 0.f;
      if (s <= last) {
        const float4* r = r4 + 3 * (s - base);  // the staged slot
        const float4 A = r[0], B = r[1];
        float d0, d1;
        const float power = falloff_power(A.x, A.y, A.z, A.w, B.x, pu, pv, &d0, &d1);
        const float alpha = fminf(ALPHA_CLAMP, B.y * gauss<ABL>(power));
        if (power <= 0.f && alpha >= MIN_ALPHA) {
          if constexpr (FIXED) {
            if (s == anchor) Tb = T_anchor;
          }
          const float4 C = r[2];
          const float phi = g_r * C.x + g_g * C.y + g_b * C.z + g_d * B.z;
          pair_backward(alpha, B.y, A.z, A.w, B.x, d0, d1, phi, g_r, g_g, g_b, g_d, Tb, suffix,
                        v);
        }
      }
      float* sw = slab + (size_t)warp * N_GRAD * WIN + (s - base);
      if constexpr (NOREDUCE) {
        if (lane == (s & 31)) {
#pragma unroll
          for (int j = 0; j < N_GRAD; ++j) sw[j * WIN] = v[j];
        }
      } else {
        warp_slot_sums(v, sw, lane);
      }
    });
    __syncthreads();
    write_window<NOREDUCE>(gr_t, cap, base, min(WIN, cap - base), slab, words, cw, w0,
                           w0 + tile_warps, p, tpx);
  }
  zero_slots(gr_t, cap, n_win * WIN, cap, p, tpx);
}

template <bool EXACT, int TILES, int ABL = 0>
static int launch(const float* packed, const int* counts, const int* tile_ids, const float* gt,
                  float* grads, float* loss, int n_tiles, int cap, int K, int tiles_x, int ts_x,
                  int ts_y, float im_w, float depth_w, int use_sur, void* stream) {
  const int threads = TILES * ts_x * ts_y;
  if (threads > MAX_WARPS * 32 || (ts_x * ts_y) % 32 || n_tiles % TILES)
    return (int)cudaErrorInvalidValue;
  if ((ABL & ABL_FIXED) && (ABLATE_CHUNKS * K > cap || K % 2)) return (int)cudaErrorInvalidValue;
  const size_t smem =
      ((size_t)TILES * max(K, WIN) * SLOT_F + (size_t)(threads / 32) * N_GRAD * WIN) *
          sizeof(float) +
      (size_t)(threads / 32) * ((cap + 31) / 32) * sizeof(unsigned);
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
