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

// Copies the N_BLEND attribute rows of one chunk [K] of a tile's packed
// block into shared memory (row-major [N_BLEND][K]), coalesced along K.
__device__ __forceinline__ void stage_chunk(const float* __restrict__ tile_pk, int cap,
                                            int base, int K, float* __restrict__ attr) {
  for (int i = threadIdx.x; i < N_BLEND * K; i += blockDim.x) {
    const int r = i / K;
    const int k = i - r * K;
    attr[i] = tile_pk[(size_t)r * cap + base + k];
  }
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

// K6's reverse walk over one tile's chunks (K3's per-tile backward), run by
// the tile's block, one thread per pixel. K5 and the tracking kernels walk
// only the slots their warps applied (blend_backward_visited, below); K6
// has no visit words from K3 and walks every slot up to each pixel's last.
//
// Chunk i (0 <= i < n_chunks, in depth order) holds K instances at
// pk + i * chunk_stride, its attribute rows row_stride floats apart; its
// gradients go to the same offsets of gr (zero-filled by the caller), and
// ct + i * px holds its incoming T per pixel (0 once the pixel is done).
// last is the pixel's last applied slot (i * K + k, -1 for none), t_final
// its final T, g = its cotangents of (r, g, b, depth, alpha, final T).
// smem holds N_BLEND * WIN + n_warps * N_GRAD * WIN floats.
//
// Each pixel's suffix sum starts at final T x its cotangent; the
// transmittance is rebuilt backwards by division by (1 - alpha) and
// re-anchored at every chunk boundary to the next chunk's stored incoming
// T, so the rebuild never runs longer than one chunk. Each applied pair's
// terms come from pair_backward; the per-instance sums over the tile's
// pixels are warp_slot_sums into one shared-memory slab per warp (zeros
// where no lane of the warp applied the slot), added in warp order: no
// float atomics, bitwise reproducible. The walk differs from the visited
// one below only in how it chooses slots and in its row layout.
__device__ __forceinline__ void blend_backward_chunks(
    const float* __restrict__ pk, float* __restrict__ gr, const float* __restrict__ ct,
    int n_chunks, int K, size_t chunk_stride, int row_stride, float pu, float pv, int last,
    float t_final, const float* g, float* smem) {
  float* attr = smem;                  // [N_BLEND][WIN]
  float* slab = smem + N_BLEND * WIN;  // [n_warps][N_GRAD][WIN] per-warp sums
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = px >> 5;
  const float g_r = g[0], g_g = g[1], g_b = g[2], g_d = g[3], g_s = g[4], g_t = g[5];
  float Tb = t_final;             // transmittance after the instance being visited
  float suffix = t_final * g_t;   // final-T term + sum over later applied w * phi

  for (int i = n_chunks - 1; i >= 0; --i) {
    // T after chunk i is the next chunk's incoming T while the pixel was
    // still blending there; otherwise nothing applied after chunk i and the
    // running Tb already holds it.
    if (i + 1 < n_chunks) {
      const float tn = ct[(size_t)(i + 1) * px + p];
      if (tn > 0.f) Tb = tn;
    }
    const int pos0 = i * K;
    if (!__syncthreads_or(last >= pos0)) continue;  // no pixel applied any of it
    const float* pc = pk + (size_t)i * chunk_stride;
    float* gc = gr + (size_t)i * chunk_stride;
    for (int base = ((K + WIN - 1) / WIN - 1) * WIN; base >= 0; base -= WIN) {
      const int kmax = min(WIN, K - base);
      if (!__syncthreads_or(last >= pos0 + base)) continue;  // also fences attr / slab
      for (int j = p; j < N_BLEND * WIN; j += px) {
        const int r = j / WIN;
        const int kk = j - r * WIN;
        attr[j] = kk < kmax ? pc[(size_t)r * row_stride + base + kk] : 0.f;
      }
      __syncthreads();
      for (int k = kmax - 1; k >= 0; --k) {
        float v[N_GRAD];
#pragma unroll
        for (int j = 0; j < N_GRAD; ++j) v[j] = 0.f;
        bool has = false;
        if (pos0 + base + k <= last) {
          float d0, d1;
          const float ca = attr[CA * WIN + k], cb = attr[CB * WIN + k];
          const float cc = attr[CC * WIN + k], op = attr[OP * WIN + k];
          const float power = falloff_power(attr[MU * WIN + k], attr[MV * WIN + k], ca, cb,
                                            cc, pu, pv, &d0, &d1);
          const float alpha = fminf(ALPHA_CLAMP, op * expf(power));
          if (power <= 0.f && alpha >= MIN_ALPHA) {
            const float phi = g_r * attr[CR * WIN + k] + g_g * attr[CG * WIN + k] +
                              g_b * attr[CBL * WIN + k] + g_d * attr[Z * WIN + k] + g_s;
            pair_backward(alpha, op, ca, cb, cc, d0, d1, phi, g_r, g_g, g_b, g_d, Tb, suffix, v);
            has = true;
          }
        }
        float* sw = slab + (size_t)warp * N_GRAD * WIN + k;
        if (__any_sync(FULL_MASK, has)) {
          warp_slot_sums(v, sw, lane);
        } else if (lane == 0) {
#pragma unroll
          for (int j = 0; j < N_GRAD; ++j) sw[j * WIN] = 0.f;
        }
      }
      __syncthreads();
      for (int j = p; j < N_GRAD * kmax; j += px) {
        const int r = j / kmax;
        const int kk = j - r * kmax;
        float s = 0.f;
        for (int w = 0; w < n_warps; ++w) s += slab[((size_t)w * N_GRAD + r) * WIN + kk];
        gc[(size_t)r * row_stride + base + kk] = s;
      }
    }
  }
}

// Dynamic shared memory of blend_backward_chunks for a tile of px pixels.
inline size_t blend_backward_smem(int px) {
  return ((size_t)N_BLEND * WIN + (size_t)(px / 32) * N_GRAD * WIN) * sizeof(float);
}

// ---- The visited-slot reverse walk (K1, K7, K8, K9 in fused_track.cu; K5) ----
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
// rows are staged per slot (K5: each chunk once; K1: each chunk for the
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

// K5's reverse walk over one tile's chunks of the flat list, one thread per
// pixel, visiting only the slots its warp applied. Chunk i (0 <= i <
// n_chunks) holds K instances at pk + i * N_ATTR * K (rows K apart), its
// gradients at the same offset of gr (every slot written, zeros included),
// its incoming T per pixel at ct + i * px, and its visit words (kw =
// ceil(K / 32) per warp) at vis + i * n_warps * kw. last, t_final and g as
// for blend_backward_chunks. Each chunk's rows and words are staged once.
// smem: rows [K][SLOT_F], words [n_warps][kw], slab [n_warps][N_GRAD][WIN].
__device__ __forceinline__ void blend_backward_visited(
    const float* __restrict__ pk, float* __restrict__ gr, const float* __restrict__ ct,
    const unsigned* __restrict__ vis, int n_chunks, int K, float pu, float pv, int last,
    float t_final, const float* g, float* smem) {
  const int p = threadIdx.x;
  const int px = blockDim.x;
  const int lane = p & 31;
  const int warp = p >> 5;
  const int n_warps = px >> 5;
  const int kw = (K + 31) >> 5;
  const int nwk = n_warps * kw;
  const size_t chunk = (size_t)N_ATTR * K;
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
    float* gc = gr + i * chunk;
    // Also fences the last chunk's readers of rows, words and slab.
    if (!__syncthreads_or(last >= i * K)) {  // no pixel applied any of it
      zero_slots(gc, K, 0, K, p, px);
      continue;
    }
    stage_slots(rows, pk + i * chunk, K, 0, K, p, px);
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
      write_window(gc, K, base, min(WIN, K - base), slab, words, kw, 0, n_warps, p, px);
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
