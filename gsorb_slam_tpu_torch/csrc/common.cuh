// Shared constants and helpers of the port's hand-written Hopper kernels.
//
// Layout contract at every kernel boundary (the JAX package's packed
// screen-instance layout, raster/pallas_raster.py:60-69):
//   packed [T, 16, cap] f32, rows MU MV CA CB CC OP R G B Z LIVE + 5 pad;
//   dead instances carry opacity 0 (and zeroed conics), so the blend gates
//   on alpha alone.
#pragma once

#include <cuda_runtime.h>

namespace gsorb {

constexpr int N_ATTR = 16;
constexpr int N_BLEND = 10;  // rows a blend reads: MU..Z
constexpr int N_GRAD = 10;   // per-instance gradient rows: d MU..Z
constexpr float MIN_ALPHA = 1.0f / 255.0f;
constexpr float STOP_T = 1e-4f;
constexpr float ALPHA_CLAMP = 0.99f;
constexpr unsigned FULL_MASK = 0xffffffffu;

enum Row { MU = 0, MV, CA, CB, CC, OP, CR, CG, CBL, Z, LIVE };

// Per-instance falloff exponent at pixel (pu, pv): the CUDA renderer's
// power = -0.5 (a d0^2 + c d1^2) - b d0 d1 with d = mean - pixel.
__device__ __forceinline__ float falloff_power(float mu, float mv, float ca, float cb,
                                               float cc, float pu, float pv,
                                               float* d0_out, float* d1_out) {
  const float d0 = mu - pu;
  const float d1 = mv - pv;
  *d0_out = d0;
  *d1_out = d1;
  return -0.5f * (ca * d0 * d0 + cc * d1 * d1) - cb * d0 * d1;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL_MASK, v, off);
  return v;
}

constexpr int WIN = 64;  // slots per backward window (one slab column each)

// The backward of one applied (pixel, instance) pair of the reverse walk:
// T before the instance is rebuilt from Tb (T after it) by division, the
// suffix sum advances, and v receives the pair's ten gradient terms
// (d mu, mv, ca, cb, cc, op, r, g, b, z). phi is the pair's cotangent dot
// (colour, depth and, for K5, alpha).
__device__ __forceinline__ void pair_backward(float alpha, float op, float ca, float cb,
                                              float cc, float d0, float d1, float phi,
                                              float g_r, float g_g, float g_b, float g_d,
                                              float& Tb, float& suffix, float* v) {
  const float one_m = 1.f - alpha;
  const float Tp = Tb / one_m;
  const float w = alpha * Tp;
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
}

// One halving step of warp_slot_sums: lanes whose bit 2H is set keep the
// upper H of their 2H partial sums, the others the lower H, and each adds
// its partner's (lane ^ 2H) half.
template <int H>
__device__ __forceinline__ void halve_sums(float* a, int lane) {
  const bool up = (lane & (2 * H)) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float keep = up ? a[H + i] : a[i];
    const float send = up ? a[i] : a[H + i];
    a[i] = keep + __shfl_xor_sync(FULL_MASK, send, 2 * H);
  }
}

// The warp's sums of v over its lanes into its slab column sw (row j at
// sw[j * WIN]), as a halving tree: 16 shuffles for the ten rows (padded to
// 16) where ten shuffle-down sums take 50. Every row's sum pairs the lanes
// as warp_sum does (lane ^ 16, then ^ 8, ^ 4, ^ 2, ^ 1), so it is the same
// float, bit for bit; lanes 2j and 2j + 1 end with row j's.
__device__ __forceinline__ void warp_slot_sums(const float* v, float* sw, int lane) {
  float a[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = j < N_GRAD ? v[j] : 0.f;
  halve_sums<8>(a, lane);
  halve_sums<4>(a, lane);
  halve_sums<2>(a, lane);
  halve_sums<1>(a, lane);
  a[0] += __shfl_xor_sync(FULL_MASK, a[0], 1);
  if ((lane & 1) == 0 && (lane >> 1) < N_GRAD) sw[(lane >> 1) * WIN] = a[0];
}

// ---- The visited-slot reverse walk (K1, K7, K8, K9 in fused_track.cu; K5; K6) ----
//
// What bounds a blend backward on the H100 is the work per (pixel,
// instance) pair, ~53 f32 operations per applied pair and the gate again
// per visited one; the bytes are moved once. A walk to each pixel's last
// applied slot pays the warp's per-slot bookkeeping (a shared load, the
// falloff, a vote, a slab write) on every slot up to its lanes' largest
// last, though only a few per cent of those pairs applied: 106.4 M pairs
// walked for 6.5 M applied on the tracking pack (profiling/count_pairs.py).
//
// So the forward records, per warp and per 32 slots, one visit word: the
// OR over the warp's lanes of the slots each lane applied. The backward
// walks only the set bits of its warp's words, from high to low (25.8 M
// (lane, slot) pairs on that pack), so a warp spends nothing on the slots
// none of its pixels applied. At a visited slot each lane still checks
// slot <= last and the gate, so the stop rules and the dead-instance
// semantics are the forward's; a lane that did not apply the slot adds 0.
// The per-slot sums over a warp's lanes are a halving tree of shuffles into
// the warp's slab; a window's sums over warps add, in warp order, only the
// warps whose bit is set: no float atomics, every rerun bit for bit. The
// rows are staged per slot (K5, K6: each chunk once; K1: each chunk for the
// forward, each window again for the backward), so a pair's falloff
// inputs are two 16-byte broadcast loads. No tensor cores: the pixel sums are the only
// contraction, 10-13% of K1's time (K9's noreduce); the rest is elementwise
// work per pair behind data-dependent stops.

// One staged slot: the ten blend rows in three float4, so that a pair's
// falloff inputs are two 16-byte broadcast loads:
//   {mu, mv, ca, cb}, {cc, op, z, -}, {r, g, b, -}.
constexpr int SLOT_F = 12;
// Where packed row r (MU .. Z) sits within a slot.
__host__ __device__ constexpr int slot_field(int r) {
  return r <= OP ? r : (r == Z ? 6 : r + 2);
}


// Copies the N_BLEND rows of slots [s0, s0 + n) of a packed block (slot s
// of row r at src[r * row_stride + s]) into rows (slot s at
// rows + s * SLOT_F), with threads p = 0 .. np - 1, coalesced along the
// slots.
__device__ __forceinline__ void stage_slots(float* __restrict__ rows,
                                            const float* __restrict__ src, int row_stride,
                                            int s0, int n, int p, int np) {
  for (int s = s0 + p; s < s0 + n; s += np) {
#pragma unroll
    for (int r = 0; r < N_BLEND; ++r)
      rows[(size_t)s * SLOT_F + slot_field(r)] = src[(size_t)r * row_stride + s];
  }
}

// ---- The forward's footprint cull (K3 in blend_forward.cu, K4 in blend_flat.cu) ----
//
// A TPU kernel evaluates whole [px, K] blocks; a GPU warp can skip a slot
// for all its 32 pixels at once. So the thread that stages a slot also
// writes the slot's footprint into the two spare floats of its SLOT_F
// layout: the half-extents of the box around its {alpha >= 1/255}
// ellipse, widened for f32 rounding. Each warp tests 32 slots at a time
// against the rectangle of its 32 pixel centres (16 x 2 at tile 16) with
// one ballot, then walks the kept bits in ascending order. A culled pair
// cannot pass power <= 0 and alpha >= 1/255, so every output is that of the
// walk over every slot, bit for bit, under both stop rules.
//
// blend_kernels.footprint_extents is slot_extents' plain version and says
// where each margin comes from. A slot whose opacity is below FOOT_OP_MIN
// gets ex = -1 (no pixel can apply it), one whose conic cannot be bounded
// ex = ey = inf (always evaluated).
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

// stage_slots of slots [0, K), each slot's half-extents written by the
// thread that staged it.
__device__ __forceinline__ void stage_slots_with_extents(float* __restrict__ rows,
                                                         const float* __restrict__ src,
                                                         int row_stride, int K, int p, int np) {
  stage_slots(rows, src, row_stride, 0, K, p, np);
  for (int s = p; s < K; s += np) {  // the slots this thread staged
    float* r = rows + (size_t)s * SLOT_F;
    slot_extents(r[CA], r[CB], r[slot_field(CC)], r[slot_field(OP)], r + EX_F, r + EY_F);
  }
}

// The rectangle of the warp's 32 pixel centres.
struct WarpRect {
  float x0, x1, y0, y1;
};

__device__ __forceinline__ WarpRect warp_rect(float pu, float pv) {
  WarpRect r{pu, pu, pv, pv};
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    r.x0 = fminf(r.x0, __shfl_xor_sync(FULL_MASK, r.x0, off));
    r.x1 = fmaxf(r.x1, __shfl_xor_sync(FULL_MASK, r.x1, off));
    r.y0 = fminf(r.y0, __shfl_xor_sync(FULL_MASK, r.y0, off));
    r.y1 = fmaxf(r.y1, __shfl_xor_sync(FULL_MASK, r.y1, off));
  }
  return r;
}

// Whether staged slot s's footprint box meets the warp's rectangle.
__device__ __forceinline__ bool footprint_meets(const float4* __restrict__ rows4, int s,
                                                const WarpRect& w) {
  const float4 A = rows4[3 * s], B = rows4[3 * s + 1], C = rows4[3 * s + 2];
  return !(B.w < 0.f) && !(A.x + B.w < w.x0) && !(A.x - B.w > w.x1) && !(A.y + C.w < w.y0) &&
         !(A.y - C.w > w.y1);
}

// A pixel's front-to-back blend state.
struct Blend {
  float T = 1.f, Cr = 0.f, Cg = 0.f, Cb = 0.f, D = 0.f, S = 0.f, Med = 0.f;
  int last = -1;  // the pixel's last applied slot (-1 for none)
  bool done = false;
};

// One staged chunk of the culled forward walk (K3, K4), run by each warp:
// per 32 slots j of [0, kmax), one ballot of the slots whose footprint meets
// the warp's rectangle, then the kept bits in ascending order, the whole
// warp together; a lane that is done sits the rest out, and the warp leaves
// the chunk once all its lanes are done. The stop rules and the median are
// the original renderer's: fast (exact == 0) = an instance applies while
// its incoming T >= 1e-4; exact = the instance whose blend would take T
// below 1e-4 is not applied; median = z of the last applied instance with
// incoming T > 0.5. pos0 is the chunk's first slot in the pixel's order
// (b.last = pos0 + k). Visit words without atomics: per walked slot the warp
// votes whether any lane applied it, and lane 0 writes word j of vw (bit b:
// slot 32 j + b), every word of [0, kw), zeros included. No exp skip: K1's skip of the exp below a
// falloff exponent of -5.6 made this walk 4% slower (the lanes of a warp
// evaluate one kept slot together, and near a footprint they rarely all
// fall below the cut).
__device__ __forceinline__ void blend_chunk_culled(const float4* __restrict__ rows4, int kmax,
                                                   int kw, const WarpRect& rect, float pu,
                                                   float pv, int exact, int pos0, int lane,
                                                   Blend& b, unsigned* __restrict__ vw) {
  int j = 0;
  bool warp_done = !__any_sync(FULL_MASK, !b.done);
  for (; j < kw && !warp_done; ++j) {
    const int sl = 32 * j + lane;
    unsigned m = __ballot_sync(FULL_MASK, sl < kmax && footprint_meets(rows4, sl, rect));
    unsigned word = 0u;
    while (m != 0u) {
      const int bit = __ffs(m) - 1;
      m &= m - 1u;
      const int k = 32 * j + bit;
      bool applied = false;
      if (!b.done) {
        const float4 A = rows4[3 * k], B = rows4[3 * k + 1];
        float d0, d1;
        const float power = falloff_power(A.x, A.y, A.z, A.w, B.x, pu, pv, &d0, &d1);
        if (!(power > 0.f)) {  // a NaN power goes on, as in the per-pixel walk
          const float alpha = fminf(ALPHA_CLAMP, B.y * expf(power));
          if (alpha >= MIN_ALPHA) {
            const float Tn = b.T * (1.f - alpha);
            if (exact && Tn < STOP_T) {
              b.done = true;
            } else {
              const float w = alpha * b.T;
              const float4 C = rows4[3 * k + 2];
              const float z = B.z;
              b.Cr += w * C.x;
              b.Cg += w * C.y;
              b.Cb += w * C.z;
              b.D += w * z;
              b.S += w;
              if (b.T > 0.5f) b.Med = z;
              b.T = Tn;
              b.last = pos0 + k;
              applied = true;
              if (!exact && b.T < STOP_T) b.done = true;
            }
          }
        }
      }
      if (__any_sync(FULL_MASK, applied)) word |= 1u << bit;
      warp_done = !__any_sync(FULL_MASK, !b.done);
      if (warp_done) break;
    }
    if (lane == 0) vw[j] = word;
  }
  for (int jj = j + lane; jj < kw; jj += 32) vw[jj] = 0u;
}

// The blend rows of pixel p (px pixels per tile) at o:
// (r, g, b, blended depth, alpha = sum w, median depth, final T, 0).
__device__ __forceinline__ void write_blend_rows(float* __restrict__ o, int px, int p,
                                                 const Blend& b) {
  o[0 * px + p] = b.Cr;
  o[1 * px + p] = b.Cg;
  o[2 * px + p] = b.Cb;
  o[3 * px + p] = b.D;
  o[4 * px + p] = b.S;
  o[5 * px + p] = b.Med;
  o[6 * px + p] = b.T;
  o[7 * px + p] = 0.f;
}

// Marks slot s as applied by this lane in its warp's visit words.
__device__ __forceinline__ void mark_visit(unsigned* warp_words, int s) {
  atomicOr(warp_words + (s >> 5), 1u << (s & 31));
}

// Calls f(s) for every slot s of the window [base, base + WIN) whose bit is
// set in the warp's visit words wv (n_words of them), from the highest slot
// down. Every lane reads the same words, so the warp stays converged.
template <typename F>
__device__ __forceinline__ void for_each_visited(const unsigned* __restrict__ wv, int n_words,
                                                 int base, F&& f) {
  for (int j = min(WIN / 32, n_words - base / 32) - 1; j >= 0; --j) {
    unsigned m = wv[base / 32 + j];
    while (m != 0u) {
      const int b = 31 - __clz((int)m);
      m ^= 1u << b;
      f(base + 32 * j + b);
    }
  }
}

// Writes rows 0 .. N_ATTR - 1 of the window's slots [base, base + n) of a
// gradient block (rows row_stride floats apart), threads p = 0 .. np - 1:
// row r < N_GRAD of slot s is the sum, in warp order, of the slab entries
// of the warps w0 .. w1 - 1 whose visit bit of s is set (FIRST: the first
// such warp's entry alone, K9's noreduce); the other rows, and slots no
// warp visited, get 0. slab is [warps][N_GRAD][WIN], words [warps][n_words].
template <bool FIRST = false>
__device__ __forceinline__ void write_window(float* __restrict__ gr, int row_stride, int base,
                                             int n, const float* __restrict__ slab,
                                             const unsigned* __restrict__ words, int n_words,
                                             int w0, int w1, int p, int np) {
  for (int e = p; e < N_ATTR * WIN; e += np) {
    const int s = e % WIN;
    const int r = e / WIN;
    if (s >= n) continue;
    float acc = 0.f;
    if (r < N_GRAD) {
      const int word = (base + s) >> 5;
      const unsigned bit = 1u << ((base + s) & 31);
      for (int w = w0; w < w1; ++w) {
        if (words[w * n_words + word] & bit) {
          acc += slab[((size_t)w * N_GRAD + r) * WIN + s];
          if (FIRST) break;
        }
      }
    }
    gr[(size_t)r * row_stride + base + s] = acc;
  }
}

// Zeroes rows 0 .. N_ATTR - 1 of slots [s0, s1) of a gradient block.
__device__ __forceinline__ void zero_slots(float* __restrict__ gr, int row_stride, int s0,
                                           int s1, int p, int np) {
  for (int r = 0; r < N_ATTR; ++r)
    for (int s = s0 + p; s < s1; s += np) gr[(size_t)r * row_stride + s] = 0.f;
}

// The visited-slot reverse walk over one tile's chunks (K5 over the flat
// list, K6 over the per-tile pack), run by the tile's block, one thread per
// pixel. Chunk i (0 <= i < n_chunks, in depth order) holds K instances at
// pk + i * chunk_stride, its attribute rows row_stride floats apart (K5:
// N_ATTR * K and K; K6: K and cap); its gradients go to the same offsets of
// gr (every element of the chunk's N_ATTR rows written, zeros included),
// ct + i * px holds its incoming T per pixel (0 once the pixel is done) and
// vis + i * n_warps * kw its visit words (kw = ceil(K / 32) per warp). last
// is the pixel's last applied slot (i * K + k, -1 for none), t_final its
// final T, g = its cotangents of (r, g, b, depth, alpha, final T). Each
// chunk's rows and words are staged once; a chunk no pixel reached is
// zeroed. The suffix sum starts at final T x its cotangent (that couples
// the background into the colour gradient); the transmittance is rebuilt
// backwards by division by (1 - alpha) and re-anchored at every chunk
// boundary to the next chunk's stored incoming T, so the rebuild never runs
// longer than one chunk.
// smem: rows [K][SLOT_F], words [n_warps][kw], slab [n_warps][N_GRAD][WIN].
__device__ __forceinline__ void blend_backward_visited(
    const float* __restrict__ pk, float* __restrict__ gr, const float* __restrict__ ct,
    const unsigned* __restrict__ vis, int n_chunks, int K, size_t chunk_stride, int row_stride,
    float pu, float pv, int last, float t_final, const float* g, float* smem) {
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = px >> 5;
  const int kw = (K + 31) >> 5;
  const int nwk = n_warps * kw;
  float* rows = smem;                                                        // [K * SLOT_F]
  unsigned* words = reinterpret_cast<unsigned*>(smem + (size_t)K * SLOT_F);  // [nwk]
  float* slab = reinterpret_cast<float*>(words + nwk);  // [n_warps][N_GRAD][WIN]
  const float4* r4 = reinterpret_cast<const float4*>(rows);
  const float g_r = g[0], g_g = g[1], g_b = g[2], g_d = g[3], g_s = g[4], g_t = g[5];
  float Tb = t_final;            // transmittance after the instance being visited
  float suffix = t_final * g_t;  // final-T term + sum over later applied w * phi

  for (int i = n_chunks - 1; i >= 0; --i) {
    // T after chunk i is the next chunk's incoming T while the pixel was
    // still blending there; otherwise nothing applied after chunk i and the
    // running Tb already holds it.
    if (i + 1 < n_chunks) {
      const float tn = ct[(size_t)(i + 1) * px + p];
      if (tn > 0.f) Tb = tn;
    }
    float* gc = gr + i * chunk_stride;
    // Also fences the last chunk's readers of rows, words and slab.
    if (!__syncthreads_or(last >= i * K)) {  // no pixel applied any of it
      zero_slots(gc, row_stride, 0, K, p, px);
      continue;
    }
    stage_slots(rows, pk + i * chunk_stride, row_stride, 0, K, p, px);
    for (int j = p; j < nwk; j += px) words[j] = vis[(size_t)i * nwk + j];
    for (int base = ((K + WIN - 1) / WIN - 1) * WIN; base >= 0; base -= WIN) {
      __syncthreads();  // the chunk is staged; the last window's slab readers are done
      for_each_visited(words + warp * kw, kw, base, [&](int k) {
        float v[N_GRAD];
#pragma unroll
        for (int j = 0; j < N_GRAD; ++j) v[j] = 0.f;
        if (i * K + k <= last) {
          const float4 A = r4[3 * k], B = r4[3 * k + 1];
          float d0, d1;
          const float power = falloff_power(A.x, A.y, A.z, A.w, B.x, pu, pv, &d0, &d1);
          const float alpha = fminf(ALPHA_CLAMP, B.y * expf(power));
          if (power <= 0.f && alpha >= MIN_ALPHA) {
            const float4 C = r4[3 * k + 2];
            const float phi = g_r * C.x + g_g * C.y + g_b * C.z + g_d * B.z + g_s;
            pair_backward(alpha, B.y, A.z, A.w, B.x, d0, d1, phi, g_r, g_g, g_b, g_d, Tb,
                          suffix, v);
          }
        }
        warp_slot_sums(v, slab + (size_t)warp * N_GRAD * WIN + (k - base), lane);
      });
      __syncthreads();
      write_window(gc, row_stride, base, min(WIN, K - base), slab, words, kw, 0, n_warps, p,
                   px);
    }
  }
}

// Dynamic shared memory of blend_backward_visited for px pixels and chunk K.
inline size_t blend_backward_visited_smem(int px, int K) {
  const size_t nwk = (size_t)(px / 32) * ((K + 31) / 32);
  return ((size_t)K * SLOT_F + (size_t)(px / 32) * N_GRAD * WIN) * sizeof(float) +
         nwk * sizeof(unsigned);
}

// Opts a kernel into more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace gsorb
