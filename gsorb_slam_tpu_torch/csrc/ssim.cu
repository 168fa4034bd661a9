// K11f / K11b: the mean SSIM of two [H, W, C] images (the mapping loss's
// SSIM, src/Utils.cc:81-120: an 11x11 separable Gaussian window, valid
// output) and its adjoint w.r.t. the first image.
//
// No TPU kernel: the JAX package writes SSIM as five depthwise
// convolutions and lets XLA fuse them. The port's eager composite
// (ops/losses.py ssim_plain) ran as two grouped cuDNN convolutions, their
// dgrad backward and ~90 elementwise kernels an iteration; these two replace
// it (ops/ssim_kernel.py):
//   K11f: pred, target [H, W, C] (channels last), an optional mask [H, W]
//         and the window [11] -> value = sum(S m) / den and den =
//         max(sum(m), 1) over the valid (H - 10) x (W - 10) x C crop
//         (m = 1 without a mask; the mask is read at the crop's pixels), and,
//         where asked, the SSIM map's partials w.r.t. the blurred moments
//         mu_p, E[p^2] and E[pt]: parts [3, H - 10, W - 10, C].
//   K11b: the scalar cotangent g, den, parts, pred, target and the mask
//         -> d_pred [H, W, C] = blur^T(d_mu) + 2 p blur^T(d_pp)
//         + t blur^T(d_pt), each partial scaled by g / den and the mask.
//
// What bounds them on the H100: bytes. K11f reads two images and writes
// three partial maps (20 B a pixel and channel), K11b reads three maps and
// two images and writes one (24 B); about 15-20 us each at 1200x680x3.
//
// Design: one block stages a TY x TX tile of its output with a 5-pixel
// halo (K11b: 10 pixels on the leading sides, the partials of the outputs
// that read the tile) in shared memory, runs the vertical pass into shared
// memory and the horizontal pass into registers: every window tap is a
// shared-memory read, the image is read from device memory once (the halo
// aside). The blurs take the composite's order (the 11 rows, then the 11
// columns). K11f's mean: each block's sums in a fixed order (warp halving
// trees, then warps in order) into its row of block_sums; the last block to
// finish (an integer ticket: __threadfence, atomicAdd on an unsigned) adds
// the rows in index order and resets the ticket. No float atomics and no
// host reads: both kernels rerun bit for bit and capture into a CUDA graph.
#include <cuda_runtime.h>

namespace {

constexpr int R = 5;           // the window's radius
constexpr int TAPS = 2 * R + 1;
constexpr int TY = 8;          // a tile's rows
constexpr int TX = 32;         // a tile's pixels along a row
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(FULL, v, off);
  return v;
}

// The sum of v over the block, in a fixed order, on thread 0 (red: WARPS
// floats of shared memory, free on entry).
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w];
  }
  __syncthreads();
  return s;
}

template <int C>
__global__ void __launch_bounds__(THREADS) ssim_fwd_kernel(
    const float* __restrict__ pred, const float* __restrict__ target,
    const float* __restrict__ mask, const float* __restrict__ window,
    float* __restrict__ parts, float* __restrict__ block_sums, unsigned* __restrict__ ticket,
    float* __restrict__ value, float* __restrict__ den, int H, int W, float c1, float c2) {
  constexpr int IW = (TX + 2 * R) * C;  // a staged row: TX + 10 pixels
  constexpr int IH = TY + 2 * R;
  __shared__ float s_p[IH][IW];
  __shared__ float s_t[IH][IW];
  __shared__ float s_v[5][TY][IW];  // the vertical pass of p, t, p^2, t^2, p t
  __shared__ float s_w[TAPS];
  __shared__ float s_red[WARPS];
  __shared__ bool is_last;

  const int Ho = H - 2 * R, Wo = W - 2 * R;
  const int oy0 = blockIdx.y * TY, ox0 = blockIdx.x * TX;
  if (threadIdx.x < TAPS) s_w[threadIdx.x] = window[threadIdx.x];
  // Output (oy, ox) reads input rows oy .. oy + 10 and columns ox .. ox + 10.
  for (int i = threadIdx.x; i < IH * IW; i += THREADS) {
    const int r = i / IW, k = i - r * IW;
    const int y = oy0 + r, x = ox0 + k / C;
    float p = 0.f, t = 0.f;
    if (y < H && x < W) {
      const size_t g = ((size_t)y * W + ox0) * C + k;
      p = pred[g];
      t = target[g];
    }
    s_p[r][k] = p;
    s_t[r][k] = t;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TY * IW; i += THREADS) {
    const int r = i / IW, k = i - r * IW;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const float w = s_w[j], p = s_p[r + j][k], t = s_t[r + j][k];
      a0 = fmaf(w, p, a0);
      a1 = fmaf(w, t, a1);
      a2 = fmaf(w, p * p, a2);
      a3 = fmaf(w, t * t, a3);
      a4 = fmaf(w, p * t, a4);
    }
    s_v[0][r][k] = a0;
    s_v[1][r][k] = a1;
    s_v[2][r][k] = a2;
    s_v[3][r][k] = a3;
    s_v[4][r][k] = a4;
  }
  __syncthreads();

  const size_t n = (size_t)Ho * Wo * C;
  float acc = 0.f, cnt = 0.f;
  for (int i = threadIdx.x; i < TY * TX * C; i += THREADS) {
    const int r = i / (TX * C), k = i - r * (TX * C);
    const int oy = oy0 + r, ox = ox0 + k / C;
    if (oy >= Ho || ox >= Wo) continue;
    float m0 = 0.f, m1 = 0.f, m2 = 0.f, m3 = 0.f, m4 = 0.f;
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const float w = s_w[j];
      const int kk = k + j * C;
      m0 = fmaf(w, s_v[0][r][kk], m0);
      m1 = fmaf(w, s_v[1][r][kk], m1);
      m2 = fmaf(w, s_v[2][r][kk], m2);
      m3 = fmaf(w, s_v[3][r][kk], m3);
      m4 = fmaf(w, s_v[4][r][kk], m4);
    }
    // S = A B / (C D), the composite's terms.
    const float a = 2.f * m0 * m1 + c1;
    const float b = 2.f * (m4 - m0 * m1) + c2;
    const float c = m0 * m0 + m1 * m1 + c1;
    const float d = (m2 - m0 * m0) + (m3 - m1 * m1) + c2;
    const float cd = c * d;
    const float s = a * b / cd;
    const float wm = mask ? mask[(size_t)(oy + R) * W + ox + R] : 1.f;
    acc += s * wm;
    cnt += wm;
    if (parts) {
      const size_t o = ((size_t)oy * Wo + ox0) * C + k;
      parts[o] = (2.f * m1 * (b - a) - 2.f * m0 * s * (d - c)) / cd;  // dS / d mu_p
      parts[n + o] = -s / d;                                          // dS / d E[p^2]
      parts[2 * n + o] = 2.f * a / cd;                                // dS / d E[pt]
    }
  }

  const int nb = gridDim.x * gridDim.y;
  const float bs = block_sum(acc, s_red);
  const float bc = block_sum(cnt, s_red);
  if (threadIdx.x == 0) {
    const size_t b = (size_t)blockIdx.y * gridDim.x + blockIdx.x;
    block_sums[2 * b] = bs;
    block_sums[2 * b + 1] = bc;
    __threadfence();  // the row is visible to every block before the ticket
    is_last = atomicAdd(ticket, 1u) == (unsigned)nb - 1u;
  }
  __syncthreads();
  if (!is_last) return;
  // The last block: thread i adds rows i, i + THREADS, ... in order, then
  // the block's sums in a fixed order. The same order on every launch.
  float s = 0.f, q = 0.f;
  for (int b = threadIdx.x; b < nb; b += THREADS) {
    s += __ldcg(block_sums + 2 * (size_t)b);
    q += __ldcg(block_sums + 2 * (size_t)b + 1);
  }
  s = block_sum(s, s_red);
  q = block_sum(q, s_red);
  if (threadIdx.x == 0) {
    const float d = fmaxf(q, 1.f);
    *value = s / d;
    *den = d;
    *ticket = 0u;  // ready for the next launch
  }
}

template <int C>
__global__ void __launch_bounds__(THREADS) ssim_bwd_kernel(
    const float* __restrict__ pred, const float* __restrict__ target,
    const float* __restrict__ mask, const float* __restrict__ window,
    const float* __restrict__ parts, const float* __restrict__ g_out,
    const float* __restrict__ den, float* __restrict__ d_pred, int H, int W) {
  constexpr int IW = (TX + 2 * R) * C;
  constexpr int IH = TY + 2 * R;
  __shared__ float s_q[3][IH][IW];  // the scaled partials the tile's pixels feed
  __shared__ float s_u[3][TY][IW];  // their vertical pass
  __shared__ float s_w[TAPS];

  const int Ho = H - 2 * R, Wo = W - 2 * R;
  const int y0 = blockIdx.y * TY, x0 = blockIdx.x * TX;
  if (threadIdx.x < TAPS) s_w[threadIdx.x] = window[threadIdx.x];
  // Input (y, x) feeds outputs y - 10 .. y and x - 10 .. x, with weight
  // w[y - oy] w[x - ox]; outputs off the valid crop feed nothing.
  const float scale = *g_out / *den;
  const size_t n = (size_t)Ho * Wo * C;
  for (int i = threadIdx.x; i < IH * IW; i += THREADS) {
    const int r = i / IW, k = i - r * IW;
    const int oy = y0 - 2 * R + r, ox = x0 - 2 * R + k / C;
    float q0 = 0.f, q1 = 0.f, q2 = 0.f;
    if (oy >= 0 && oy < Ho && ox >= 0 && ox < Wo) {
      const size_t o = ((size_t)oy * Wo + ox) * C + k % C;
      const float s = mask ? scale * mask[(size_t)(oy + R) * W + ox + R] : scale;
      q0 = parts[o] * s;
      q1 = parts[n + o] * s;
      q2 = parts[2 * n + o] * s;
    }
    s_q[0][r][k] = q0;
    s_q[1][r][k] = q1;
    s_q[2][r][k] = q2;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TY * IW; i += THREADS) {
    const int r = i / IW, k = i - r * IW;
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const float w = s_w[j];
      const int rr = r + 2 * R - j;
      a0 = fmaf(w, s_q[0][rr][k], a0);
      a1 = fmaf(w, s_q[1][rr][k], a1);
      a2 = fmaf(w, s_q[2][rr][k], a2);
    }
    s_u[0][r][k] = a0;
    s_u[1][r][k] = a1;
    s_u[2][r][k] = a2;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < TY * TX * C; i += THREADS) {
    const int r = i / (TX * C), k = i - r * (TX * C);
    const int y = y0 + r, x = x0 + k / C;
    if (y >= H || x >= W) continue;
    float e0 = 0.f, e1 = 0.f, e2 = 0.f;
#pragma unroll
    for (int j = 0; j < TAPS; ++j) {
      const float w = s_w[j];
      const int kk = k + (2 * R - j) * C;
      e0 = fmaf(w, s_u[0][r][kk], e0);
      e1 = fmaf(w, s_u[1][r][kk], e1);
      e2 = fmaf(w, s_u[2][r][kk], e2);
    }
    const size_t g = ((size_t)y * W + x0) * C + k;
    d_pred[g] = e0 + 2.f * pred[g] * e1 + target[g] * e2;
  }
}

dim3 tiles(int h, int w) { return dim3((w + TX - 1) / TX, (h + TY - 1) / TY); }

}  // namespace

// pred, target, d_pred: [H, W, C] with 1 <= C <= 3, H and W >= 11; mask
// [H, W] or null; window [11]; parts [3, H - 10, W - 10, C] or null (no
// partials written); block_sums: 2 floats per block of the grid
// (gsorb_ssim_fwd_blocks); ticket: one unsigned, 0 between launches, used by
// one launch at a time (the port launches on one stream); value, den: one
// float each.
extern "C" int gsorb_ssim_fwd_blocks(int H, int W) {
  const dim3 g = tiles(H - 2 * R, W - 2 * R);
  return (int)(g.x * g.y);
}

extern "C" int gsorb_ssim_fwd(const float* pred, const float* target, const float* mask,
                              const float* window, float* parts, float* block_sums,
                              unsigned* ticket, float* value, float* den, int H, int W,
                              int C, float c1, float c2, void* stream) {
  const dim3 grid = tiles(H - 2 * R, W - 2 * R);
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1:
      ssim_fwd_kernel<1><<<grid, THREADS, 0, s>>>(pred, target, mask, window, parts,
                                                  block_sums, ticket, value, den, H, W, c1, c2);
      break;
    case 2:
      ssim_fwd_kernel<2><<<grid, THREADS, 0, s>>>(pred, target, mask, window, parts,
                                                  block_sums, ticket, value, den, H, W, c1, c2);
      break;
    case 3:
      ssim_fwd_kernel<3><<<grid, THREADS, 0, s>>>(pred, target, mask, window, parts,
                                                  block_sums, ticket, value, den, H, W, c1, c2);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" int gsorb_ssim_bwd(const float* pred, const float* target, const float* mask,
                              const float* window, const float* parts, const float* g_out,
                              const float* den, float* d_pred, int H, int W, int C,
                              void* stream) {
  const dim3 grid = tiles(H, W);
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 1:
      ssim_bwd_kernel<1><<<grid, THREADS, 0, s>>>(pred, target, mask, window, parts, g_out,
                                                  den, d_pred, H, W);
      break;
    case 2:
      ssim_bwd_kernel<2><<<grid, THREADS, 0, s>>>(pred, target, mask, window, parts, g_out,
                                                  den, d_pred, H, W);
      break;
    case 3:
      ssim_bwd_kernel<3><<<grid, THREADS, 0, s>>>(pred, target, mask, window, parts, g_out,
                                                  den, d_pred, H, W);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
