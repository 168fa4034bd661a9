// K10f / K10b: the mapping path's projection of the splats into the packed
// attribute table, and its adjoint w.r.t. the five splat parameter groups.
//
// No TPU kernel: the JAX package differentiates raster/preprocess.py and
// lets XLA fuse it. The port's eager autograd ran the same chain as ~850
// kernels a mapping iteration, one per operation over C rows; these two
// replace it (raster/map_attr.py):
//   K10f: means [C, 3], rgb [C, 3], quats [C, 4], logit opacities [C],
//         log-scales [C, 3], active [C] (bool) and T_cw [4, 4]
//         -> cols [C + 1, 16] (rows MU .. LIVE, then 5 zero rows; the
//         conic, opacity and depth rows masked by validity; row C the zero
//         sentinel) and radius [C], exactly what
//         attr_cols(preprocess(...)) and preprocess(...).radius return.
//   K10b: d_cols [C + 1, 16] (rows 0-9 read) and the same inputs
//         -> d_means, d_rgb, d_quats, d_logit_opacities, d_log_scales.
//
// What bounds them on the H100: bytes. K10f reads 56 B and 1 B of a row and
// writes 68 B; K10b reads 40 B of cotangents and 56 B of parameters and
// writes 56 B. Both are ~0.05 ms at 2^20 rows.
//
// Design: one thread owns one row; no atomics, no host reads, so every
// result reruns bit for bit and both launches capture into a CUDA graph.
// The forward (map_row) runs under ewa.cuh's Rounded arithmetic, in the
// plain composite's order and with the operations PyTorch's kernels use
// (a Python scalar over a tensor is the tensor's reciprocal times the
// scalar; clamps and minimum pass NaN through; expf, logf, IEEE division
// and square root), so K10f equals the plain composite bit for bit on the
// card. K10b runs the same map_row, so it takes the forward's branches,
// then sweeps back by hand with autograd's subgradients: a clamp passes the
// gradient on min <= x <= max, a select the branch it took, and the
// validity masks and the radius (a ceil) carry nothing. The pose gets no
// gradient here; tracking differentiates it through K2.
#include "common.cuh"
#include "ewa.cuh"

using namespace gsorb;

namespace {

constexpr int THREADS = 256;
constexpr float MIN_OPACITY = (float)(1.0 / 255.0);  // preprocess's op >= 1/255 cull

struct MapCam {
  float fx, fy, cx, cy, lim_x, lim_y, sm, width, height;
};

// One row's forward, with what its adjoint reads.
struct MapRow {
  float tx, ty, tz, sz, txr, tyr, txz, tyz;
  bool in_front, x_in, y_in, qn_in, valid;
  float qn, q[4];  // the norm and the normalized quaternion (w, x, y, z)
  float r[3][3];   // its rotation
  float v[3];      // squared scales
  float k[6];      // cov_cam's upper entries
  float fx_z, fy_z, j02, j12, a, b, c, inv_det;
  float ca, cb, cc, op, u, vv, radius;
};

__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
__device__ __forceinline__ float clamp_min_nan(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float minimum_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
}

using RF = Rounded;

// raster/preprocess.py's preprocess for one row, operation for operation.
__device__ __forceinline__ MapRow map_row(const float* __restrict__ means,
                                          const float* __restrict__ quats,
                                          const float* __restrict__ logit_op,
                                          const float* __restrict__ log_scales,
                                          const bool* __restrict__ active, const float P[3][3],
                                          const float t[3], const MapCam& cam, long long i) {
  MapRow f;
  const float x = means[3 * i], y = means[3 * i + 1], z = means[3 * i + 2];
  f.tx = RF::add(dot3<RF>(P[0][0], x, P[0][1], y, P[0][2], z), t[0]);
  f.ty = RF::add(dot3<RF>(P[1][0], x, P[1][1], y, P[1][2], z), t[1]);
  f.tz = RF::add(dot3<RF>(P[2][0], x, P[2][1], y, P[2][2], z), t[2]);
  f.in_front = f.tz > NEAR_CULL;
  f.sz = f.in_front ? f.tz : 1.f;
  f.txr = __fdiv_rn(f.tx, f.sz);
  f.tyr = __fdiv_rn(f.ty, f.sz);
  f.txz = clamp_nan(f.txr, -cam.lim_x, cam.lim_x);
  f.tyz = clamp_nan(f.tyr, -cam.lim_y, cam.lim_y);
  f.x_in = f.txr >= -cam.lim_x && f.txr <= cam.lim_x;
  f.y_in = f.tyr >= -cam.lim_y && f.tyr <= cam.lim_y;

  // rotation_entries: the quaternion over its norm (at least 1e-12).
  const float4 q = reinterpret_cast<const float4*>(quats)[i];
  const float ss = RF::add(RF::add(RF::add(RF::mul(q.x, q.x), RF::mul(q.y, q.y)),
                                   RF::mul(q.z, q.z)), RF::mul(q.w, q.w));
  const float qs = __fsqrt_rn(ss);
  f.qn_in = qs >= 1e-12f;
  f.qn = clamp_min_nan(qs, 1e-12f);
  f.q[0] = __fdiv_rn(q.x, f.qn);
  f.q[1] = __fdiv_rn(q.y, f.qn);
  f.q[2] = __fdiv_rn(q.z, f.qn);
  f.q[3] = __fdiv_rn(q.w, f.qn);
  const float w_ = f.q[0], xq = f.q[1], yq = f.q[2], zq = f.q[3];
  auto one_minus_2 = [](float s) { return __fsub_rn(1.f, RF::mul(2.f, s)); };
  auto two = [](float s) { return RF::mul(2.f, s); };
  f.r[0][0] = one_minus_2(RF::add(RF::mul(yq, yq), RF::mul(zq, zq)));
  f.r[0][1] = two(__fsub_rn(RF::mul(xq, yq), RF::mul(w_, zq)));
  f.r[0][2] = two(RF::add(RF::mul(xq, zq), RF::mul(w_, yq)));
  f.r[1][0] = two(RF::add(RF::mul(xq, yq), RF::mul(w_, zq)));
  f.r[1][1] = one_minus_2(RF::add(RF::mul(xq, xq), RF::mul(zq, zq)));
  f.r[1][2] = two(__fsub_rn(RF::mul(yq, zq), RF::mul(w_, xq)));
  f.r[2][0] = two(__fsub_rn(RF::mul(xq, zq), RF::mul(w_, yq)));
  f.r[2][1] = two(RF::add(RF::mul(yq, zq), RF::mul(w_, xq)));
  f.r[2][2] = one_minus_2(RF::add(RF::mul(xq, xq), RF::mul(yq, yq)));

  // World covariance R diag(e^2) R^T, e = exp(log_scale) sm.
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    const float e = RF::mul(expf(log_scales[3 * i + l]), cam.sm);
    f.v[l] = RF::mul(e, e);
  }
  auto cov = [&](int m, int n) {
    return RF::add(RF::add(RF::mul(RF::mul(f.r[m][0], f.r[n][0]), f.v[0]),
                           RF::mul(RF::mul(f.r[m][1], f.r[n][1]), f.v[1])),
                   RF::mul(RF::mul(f.r[m][2], f.r[n][2]), f.v[2]));
  };
  const float c00 = cov(0, 0), c01 = cov(0, 1), c02 = cov(0, 2);
  const float c11 = cov(1, 1), c12 = cov(1, 2), c22 = cov(2, 2);
  const float cw[3][3] = {{c00, c01, c02}, {c01, c11, c12}, {c02, c12, c22}};
  float M[3][3];
  camera_cov<RF>(P, cw, M, f.k);

  // fx / safe_z is safe_z's reciprocal times fx.
  const float rz = __fdiv_rn(1.f, f.sz);
  f.fx_z = RF::mul(rz, cam.fx);
  f.fy_z = RF::mul(rz, cam.fy);
  f.j02 = RF::mul(-f.fx_z, f.txz);
  f.j12 = RF::mul(-f.fy_z, f.tyz);
  ewa_abc<RF>(f.fx_z, f.fy_z, f.j02, f.j12, f.k, f.a, f.b, f.c);

  const float det = __fsub_rn(RF::mul(f.a, f.c), RF::mul(f.b, f.b));
  const bool det_ok = det > 0.f;
  f.inv_det = __fdiv_rn(1.f, det_ok ? det : 1.f);
  f.ca = RF::mul(f.c, f.inv_det);
  f.cb = RF::mul(-f.b, f.inv_det);
  f.cc = RF::mul(f.a, f.inv_det);

  // radius = ceil(min(3 sqrt(lam1), sqrt(2 lam1 ln(255 op)))).
  const float mid = RF::mul(0.5f, RF::add(f.a, f.c));
  const float lam1 =
      RF::add(mid, __fsqrt_rn(clamp_min_nan(__fsub_rn(RF::mul(mid, mid), det), 0.1f)));
  f.op = __fdiv_rn(1.f, RF::add(1.f, expf(-logit_op[i])));
  const float ln_term = logf(clamp_min_nan(RF::mul(255.f, f.op), 1e-6f));
  const float cutoff = __fsqrt_rn(RF::mul(RF::mul(2.f, lam1), clamp_min_nan(ln_term, 0.f)));
  f.radius = ceilf(minimum_nan(RF::mul(3.f, __fsqrt_rn(lam1)), cutoff));

  f.u = RF::add(RF::mul(cam.fx, f.txr), cam.cx);
  f.vv = RF::add(RF::mul(cam.fy, f.tyr), cam.cy);
  const bool on_screen = RF::add(f.u, f.radius) > 0.f && __fsub_rn(f.u, f.radius) < cam.width &&
                         RF::add(f.vv, f.radius) > 0.f &&
                         __fsub_rn(f.vv, f.radius) < cam.height;
  f.valid = active[i] && f.in_front && det_ok && on_screen && f.op >= MIN_OPACITY;
  return f;
}

__device__ __forceinline__ void load_pose(const float* __restrict__ T, float P[3][3],
                                          float t[3]) {
#pragma unroll
  for (int m = 0; m < 3; ++m) {
#pragma unroll
    for (int n = 0; n < 3; ++n) P[m][n] = __ldg(T + 4 * m + n);
    t[m] = __ldg(T + 4 * m + 3);
  }
}

__global__ void __launch_bounds__(THREADS) map_attr_fwd_kernel(
    const float* __restrict__ means, const float* __restrict__ rgb,
    const float* __restrict__ quats, const float* __restrict__ logit_op,
    const float* __restrict__ log_scales, const bool* __restrict__ active,
    const float* __restrict__ T, float* __restrict__ cols, float* __restrict__ radius,
    long long C, MapCam cam) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i > C) return;
  float4* out = reinterpret_cast<float4*>(cols + (size_t)i * N_ATTR);
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
  if (i == C) {  // the zero sentinel row that padding slots read
#pragma unroll
    for (int j = 0; j < N_ATTR / 4; ++j) out[j] = zero;
    return;
  }
  float P[3][3], t[3];
  load_pose(T, P, t);
  const MapRow f = map_row(means, quats, logit_op, log_scales, active, P, t, cam, i);
  const float vf = f.valid ? 1.f : 0.f;
  out[0] = make_float4(f.u, f.vv, RF::mul(f.ca, vf), RF::mul(f.cb, vf));
  out[1] = make_float4(RF::mul(f.cc, vf), RF::mul(f.op, vf), rgb[3 * i], rgb[3 * i + 1]);
  out[2] = make_float4(rgb[3 * i + 2], f.valid ? f.tz : 0.f, vf, 0.f);
  out[3] = zero;
  radius[i] = f.valid ? f.radius : 0.f;
}

__global__ void __launch_bounds__(THREADS) map_attr_bwd_kernel(
    const float* __restrict__ means, const float* __restrict__ quats,
    const float* __restrict__ logit_op, const float* __restrict__ log_scales,
    const bool* __restrict__ active, const float* __restrict__ T,
    const float* __restrict__ d_cols, float* __restrict__ d_means, float* __restrict__ d_rgb,
    float* __restrict__ d_quats, float* __restrict__ d_logit_op,
    float* __restrict__ d_log_scales, long long C, MapCam cam) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= C) return;
  float P[3][3], t[3];
  load_pose(T, P, t);
  const MapRow f = map_row(means, quats, logit_op, log_scales, active, P, t, cam, i);
  const float4* gp = reinterpret_cast<const float4*>(d_cols + (size_t)i * N_ATTR);
  const float4 g0 = gp[0], g1 = gp[1], g2 = gp[2];
  const float g[10] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w, g2.x, g2.y};

  d_rgb[3 * i] = g[CR];
  d_rgb[3 * i + 1] = g[CG];
  d_rgb[3 * i + 2] = g[CBL];
  // opacity * vf, sigmoid's derivative op (1 - op).
  d_logit_op[i] = f.valid ? g[OP] * (1.f - f.op) * f.op : 0.f;

  // u = fx tx / sz + cx, v likewise: unmasked.
  float d_txr = g[MU] * cam.fx;
  float d_tyr = g[MV] * cam.fy;
  float d_sz = 0.f, d_tz = 0.f;
  float dq[4] = {0.f, 0.f, 0.f, 0.f}, dls[3] = {0.f, 0.f, 0.f};
  if (f.valid) {
    float da, db, dc;
    conic_adjoint(g[CA], g[CB], g[CC], f.a, f.b, f.c, f.inv_det, da, db, dc);
    d_tz = g[Z];
    float d_fx, d_fy, d_j02, d_j12, w[6];
    abc_adjoint(da, db, dc, f.fx_z, f.fy_z, f.j02, f.j12, f.k, d_fx, d_fy, d_j02, d_j12, w);
    // j02 = -fx_z txz, j12 = -fy_z tyz; txz = clamp(txr), tyz likewise.
    d_fx -= d_j02 * f.txz;
    d_fy -= d_j12 * f.tyz;
    if (f.x_in) d_txr -= d_j02 * f.fx_z;
    if (f.y_in) d_tyr -= d_j12 * f.fy_z;
    // fx_z = fx / sz, fy_z = fy / sz.
    d_sz -= (d_fx * f.fx_z + d_fy * f.fy_z) / f.sz;
    // cov_cam = P cov_w P^T with cotangent S = w / 2 (full sum): cov_w's is
    // G = P^T S P.
    const float S[3][3] = {{0.5f * w[0], 0.5f * w[1], 0.5f * w[2]},
                           {0.5f * w[1], 0.5f * w[3], 0.5f * w[4]},
                           {0.5f * w[2], 0.5f * w[4], 0.5f * w[5]}};
    float SP[3][3], G[3][3];
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int n = 0; n < 3; ++n)
        SP[m][n] = S[m][0] * P[0][n] + S[m][1] * P[1][n] + S[m][2] * P[2][n];
#pragma unroll
    for (int m = 0; m < 3; ++m)
#pragma unroll
      for (int n = 0; n < 3; ++n)
        G[m][n] = P[0][m] * SP[0][n] + P[1][m] * SP[1][n] + P[2][m] * SP[2][n];
    // cov_w = r diag(v) r^T: d v_l = (r^T G r)_ll, d r = 2 G r diag(v).
    float dr[3][3];
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      float dv = 0.f;
#pragma unroll
      for (int m = 0; m < 3; ++m) {
        const float Gr = G[m][0] * f.r[0][l] + G[m][1] * f.r[1][l] + G[m][2] * f.r[2][l];
        dv += f.r[m][l] * Gr;
        dr[m][l] = 2.f * f.v[l] * Gr;
      }
      // v = (exp(s) sm)^2: d s = 2 v d v.
      dls[l] = 2.f * f.v[l] * dv;
    }
    // The rotation of the normalized quaternion (w, x, y, z).
    const float w_ = f.q[0], xq = f.q[1], yq = f.q[2], zq = f.q[3];
    float dn[4];
    dn[0] = 2.f * (-zq * dr[0][1] + yq * dr[0][2] + zq * dr[1][0] - xq * dr[1][2] -
                   yq * dr[2][0] + xq * dr[2][1]);
    dn[1] = 2.f * (yq * dr[0][1] + zq * dr[0][2] + yq * dr[1][0] - 2.f * xq * dr[1][1] -
                   w_ * dr[1][2] + zq * dr[2][0] + w_ * dr[2][1] - 2.f * xq * dr[2][2]);
    dn[2] = 2.f * (-2.f * yq * dr[0][0] + xq * dr[0][1] + w_ * dr[0][2] + xq * dr[1][0] +
                   zq * dr[1][2] - w_ * dr[2][0] + zq * dr[2][1] - 2.f * yq * dr[2][2]);
    dn[3] = 2.f * (-2.f * zq * dr[0][0] - w_ * dr[0][1] + xq * dr[0][2] + w_ * dr[1][0] -
                   2.f * zq * dr[1][1] + yq * dr[1][2] + xq * dr[2][0] + yq * dr[2][1]);
    // q / max(|q|, 1e-12): the norm's gradient passes where |q| >= 1e-12.
    const float proj = f.qn_in ? dn[0] * w_ + dn[1] * xq + dn[2] * yq + dn[3] * zq : 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) dq[j] = (dn[j] - f.q[j] * proj) / f.qn;
  }
  // txr = tx / sz, tyr = ty / sz; sz = tz in front of the near plane.
  const float d_tx = d_txr / f.sz;
  const float d_ty = d_tyr / f.sz;
  d_sz -= (d_txr * f.txr + d_tyr * f.tyr) / f.sz;
  if (f.in_front) d_tz += d_sz;
  // (tx, ty, tz) = P mean + t.
#pragma unroll
  for (int l = 0; l < 3; ++l)
    d_means[3 * i + l] = P[0][l] * d_tx + P[1][l] * d_ty + P[2][l] * d_tz;
  reinterpret_cast<float4*>(d_quats)[i] = make_float4(dq[0], dq[1], dq[2], dq[3]);
#pragma unroll
  for (int l = 0; l < 3; ++l) d_log_scales[3 * i + l] = dls[l];
}

int blocks(long long n) { return (int)((n + THREADS - 1) / THREADS); }

}  // namespace

// T: T_cw [4, 4] on the device; cols [C + 1, 16] and d_cols 16-byte aligned
// (rows of 64 B), quats and d_quats likewise (rows of 16 B).
extern "C" int gsorb_map_attr_fwd(const float* means, const float* rgb, const float* quats,
                                  const float* logit_op, const float* log_scales,
                                  const bool* active, const float* T, float* cols,
                                  float* radius, long long C, float fx, float fy, float cx,
                                  float cy, float lim_x, float lim_y, float sm, float width,
                                  float height, void* stream) {
  const MapCam cam{fx, fy, cx, cy, lim_x, lim_y, sm, width, height};
  map_attr_fwd_kernel<<<blocks(C + 1), THREADS, 0, (cudaStream_t)stream>>>(
      means, rgb, quats, logit_op, log_scales, active, T, cols, radius, C, cam);
  return (int)cudaGetLastError();
}

extern "C" int gsorb_map_attr_bwd(const float* means, const float* quats,
                                  const float* logit_op, const float* log_scales,
                                  const bool* active, const float* T, const float* d_cols,
                                  float* d_means, float* d_rgb, float* d_quats,
                                  float* d_logit_op, float* d_log_scales, long long C,
                                  float fx, float fy, float cx, float cy, float lim_x,
                                  float lim_y, float sm, float width, float height,
                                  void* stream) {
  if (C <= 0) return (int)cudaGetLastError();
  const MapCam cam{fx, fy, cx, cy, lim_x, lim_y, sm, width, height};
  map_attr_bwd_kernel<<<blocks(C), THREADS, 0, (cudaStream_t)stream>>>(
      means, quats, logit_op, log_scales, active, T, d_cols, d_means, d_rgb, d_quats,
      d_logit_op, d_log_scales, C, cam);
  return (int)cudaGetLastError();
}
