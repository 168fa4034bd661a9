// K2f / K2b: per-instance EWA projection of the raw tile-instance pack under
// a pose R|t, and its adjoint with respect to the 12 pose numbers.
//
// Replaces the TPU kernel pair raster/preprocess_pallas.py:_fwd_kernel
// (:118) and _bwd_kernel (:127), launched by _fwd_impl (:183) and _vjp_bwd
// (:207), math in _ewa_rows (:35) = raster/instances.py:preprocess_instances.
//   K2f: raw [T, 16, cap] (mean3, rgb, world cov6, logit opacity, live)
//        -> screen [T, 16, cap] (u, v, conic a b c, opacity, rgb, z, valid,
//        5 zero rows); invalid instances (not live, behind the near plane,
//        det <= 0) get zero conic, opacity and depth.
//   K2b: d_screen [T, 16, cap] -> per-block partial sums [n_blocks, 12] of
//        d_rt = sum over instances and screen rows of d_screen * d screen /
//        d rt (rt = R row-major, then t). The caller adds the partials (a
//        fixed-order sum, so the result is deterministic). d_raw is zero by
//        contract: tracking never differentiates the pack.
//
// What bounds it on the H100: K2f reads 16 and writes 16 floats per
// instance (2 x 39 MB at 1200 tiles x cap 512) for ~150 f32 operations,
// so it is bound by HBM bytes. K2b reads 2 x 39 MB and does 12 dual-number
// passes (~3,600 operations per instance): roughly balanced between bytes
// and the f32 rate.
//
// Design: one thread per (tile, slot), rows read and written along the
// contiguous slot axis (coalesced). The backward evaluates THE SAME device
// function as the forward on dual numbers (a value and one tangent), once
// per pose direction, so no hand-derived adjoint can drift from the
// forward; select / clip branches then take the one-sided derivatives
// autodiff takes. One tangent at a time keeps the live state in registers.
#include "common.cuh"

using namespace gsorb;

namespace {

constexpr float NEAR_CULL = 0.2f;
constexpr float LOW_PASS = 0.3f;
constexpr int THREADS = 256;

struct CamParams {
  float fx, fy, cx, cy, lim_x, lim_y, sm;
};

// A value with one tangent.
struct Dual {
  float v, d;
  __device__ Dual() : v(0.f), d(0.f) {}
  __device__ Dual(float x) : v(x), d(0.f) {}
  __device__ Dual(float x, float dx) : v(x), d(dx) {}
};
__device__ __forceinline__ Dual operator+(Dual a, Dual b) { return Dual(a.v + b.v, a.d + b.d); }
__device__ __forceinline__ Dual operator-(Dual a, Dual b) { return Dual(a.v - b.v, a.d - b.d); }
__device__ __forceinline__ Dual operator-(Dual a) { return Dual(-a.v, -a.d); }
__device__ __forceinline__ Dual operator*(Dual a, Dual b) {
  return Dual(a.v * b.v, a.d * b.v + a.v * b.d);
}
__device__ __forceinline__ Dual operator/(Dual a, Dual b) {
  return Dual(a.v / b.v, (a.d * b.v - a.v * b.d) / (b.v * b.v));
}
__device__ __forceinline__ float val(float x) { return x; }
__device__ __forceinline__ float val(Dual x) { return x.v; }

template <typename S>
__device__ __forceinline__ S clip(S x, float lo, float hi) {
  return val(x) < lo ? S(lo) : (val(x) > hi ? S(hi) : x);
}

// The pose-dependent screen rows of one instance. raw: the 14 used raw rows.
template <typename S>
struct ScreenRows {
  S u, v, ca, cb, cc, z;
  float vf;
};

template <typename S>
__device__ __forceinline__ ScreenRows<S> ewa_rows(const float* raw, const S* rt,
                                                  const CamParams& cam) {
  const float x = raw[0], y = raw[1], z3 = raw[2];
  const float cw[3][3] = {{raw[6], raw[7], raw[8]},
                          {raw[7], raw[9], raw[10]},
                          {raw[8], raw[10], raw[11]}};
  const S tx = rt[0] * x + rt[1] * y + rt[2] * z3 + rt[9];
  const S ty = rt[3] * x + rt[4] * y + rt[5] * z3 + rt[10];
  const S tz = rt[6] * x + rt[7] * y + rt[8] * z3 + rt[11];

  const bool in_front = val(tz) > NEAR_CULL;
  const S safe_z = in_front ? tz : S(1.f);
  const S txz = clip(tx / safe_z, -cam.lim_x, cam.lim_x);
  const S tyz = clip(ty / safe_z, -cam.lim_y, cam.lim_y);

  // cov_cam = (sm R) cov_w (sm R)^T; only the six unique entries are used.
  S Rs[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Rs[i][j] = rt[3 * i + j] * cam.sm;
  S M[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      M[i][j] = Rs[i][0] * cw[0][j] + Rs[i][1] * cw[1][j] + Rs[i][2] * cw[2][j];
  auto km = [&](int i, int j) {
    return M[i][0] * Rs[j][0] + M[i][1] * Rs[j][1] + M[i][2] * Rs[j][2];
  };
  const S k00 = km(0, 0), k01 = km(0, 1), k02 = km(0, 2);
  const S k11 = km(1, 1), k12 = km(1, 2), k22 = km(2, 2);

  const S fx_z = S(cam.fx) / safe_z;
  const S fy_z = S(cam.fy) / safe_z;
  const S j02 = -(fx_z * txz);
  const S j12 = -(fy_z * tyz);
  const S a = fx_z * (fx_z * k00 + j02 * k02) + j02 * (fx_z * k02 + j02 * k22) + S(LOW_PASS);
  const S b = fx_z * (fy_z * k01 + j12 * k02) + j02 * (fy_z * k12 + j12 * k22);
  const S c = fy_z * (fy_z * k11 + j12 * k12) + j12 * (fy_z * k12 + j12 * k22) + S(LOW_PASS);

  const S det = a * c - b * b;
  const bool det_ok = val(det) > 0.f;
  const S inv_det = S(1.f) / (det_ok ? det : S(1.f));

  const bool valid = raw[13] > 0.5f && in_front && det_ok;
  const float vf = valid ? 1.f : 0.f;
  ScreenRows<S> out;
  out.u = S(cam.fx) * (tx / safe_z) + S(cam.cx);
  out.v = S(cam.fy) * (ty / safe_z) + S(cam.cy);
  out.ca = c * inv_det * S(vf);
  out.cb = -b * inv_det * S(vf);
  out.cc = a * inv_det * S(vf);
  out.z = valid ? tz : S(0.f);
  out.vf = vf;
  return out;
}

__device__ __forceinline__ void load_raw(const float* __restrict__ raw, size_t t, int k,
                                         int cap, float* r) {
  const float* rp = raw + t * N_ATTR * cap + k;
#pragma unroll
  for (int j = 0; j < 14; ++j) r[j] = rp[(size_t)j * cap];
}

__global__ void __launch_bounds__(THREADS) preprocess_fwd_kernel(
    const float* __restrict__ raw, const float* __restrict__ rt, float* __restrict__ out,
    long long n, int cap, CamParams cam) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t t = (size_t)(i / cap);
  const int k = (int)(i - (long long)t * cap);
  float r[14];
  load_raw(raw, t, k, cap, r);
  float pose[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) pose[j] = rt[j];
  const ScreenRows<float> s = ewa_rows<float>(r, pose, cam);
  float* o = out + t * N_ATTR * cap + k;
  o[0] = s.u;
  o[1 * (size_t)cap] = s.v;
  o[2 * (size_t)cap] = s.ca;
  o[3 * (size_t)cap] = s.cb;
  o[4 * (size_t)cap] = s.cc;
  o[5 * (size_t)cap] = s.vf / (1.f + expf(-r[12]));  // sigmoid(logit) * valid
  o[6 * (size_t)cap] = r[3];
  o[7 * (size_t)cap] = r[4];
  o[8 * (size_t)cap] = r[5];
  o[9 * (size_t)cap] = s.z;
  o[10 * (size_t)cap] = s.vf;
#pragma unroll
  for (int j = 11; j < N_ATTR; ++j) o[j * (size_t)cap] = 0.f;
}

__global__ void __launch_bounds__(THREADS) preprocess_bwd_kernel(
    const float* __restrict__ raw, const float* __restrict__ rt,
    const float* __restrict__ dout, float* __restrict__ partials, long long n, int cap,
    CamParams cam) {
  __shared__ float red[THREADS / 32][12];
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float acc[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) acc[j] = 0.f;
  if (i < n) {
    const size_t t = (size_t)(i / cap);
    const int k = (int)(i - (long long)t * cap);
    const float* dp = dout + t * N_ATTR * cap + k;
    // Only the rows that depend on the pose carry a tangent.
    const float du = dp[0], dv = dp[(size_t)cap], dca = dp[2 * (size_t)cap],
                dcb = dp[3 * (size_t)cap], dcc = dp[4 * (size_t)cap],
                dz = dp[9 * (size_t)cap];
    if (du != 0.f || dv != 0.f || dca != 0.f || dcb != 0.f || dcc != 0.f || dz != 0.f) {
      float r[14];
      load_raw(raw, t, k, cap, r);
      float pose[12];
#pragma unroll
      for (int j = 0; j < 12; ++j) pose[j] = rt[j];
#pragma unroll 1
      for (int dir = 0; dir < 12; ++dir) {
        Dual pd[12];
#pragma unroll
        for (int j = 0; j < 12; ++j) pd[j] = Dual(pose[j], j == dir ? 1.f : 0.f);
        const ScreenRows<Dual> s = ewa_rows<Dual>(r, pd, cam);
        const float g = du * s.u.d + dv * s.v.d + dca * s.ca.d + dcb * s.cb.d +
                        dcc * s.cc.d + dz * s.z.d;
#pragma unroll
        for (int j = 0; j < 12; ++j)
          if (j == dir) acc[j] = g;
      }
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 12; ++j) {
    const float s = warp_sum(acc[j]);
    if (lane == 0) red[warp][j] = s;
  }
  __syncthreads();
  if (threadIdx.x < 12) {
    float s = 0.f;
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) s += red[w][threadIdx.x];
    partials[(size_t)blockIdx.x * 12 + threadIdx.x] = s;
  }
}

}  // namespace

extern "C" int gsorb_preprocess_blocks(long long n) {
  return (int)((n + THREADS - 1) / THREADS);
}

extern "C" int gsorb_preprocess_fwd(const float* raw, const float* rt, float* out,
                                    int n_tiles, int cap, float fx, float fy, float cx,
                                    float cy, float lim_x, float lim_y, float sm,
                                    void* stream) {
  const long long n = (long long)n_tiles * cap;
  const CamParams cam{fx, fy, cx, cy, lim_x, lim_y, sm};
  if (n > 0) {
    preprocess_fwd_kernel<<<gsorb_preprocess_blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        raw, rt, out, n, cap, cam);
  }
  return (int)cudaGetLastError();
}

extern "C" int gsorb_preprocess_bwd(const float* raw, const float* rt, const float* dout,
                                    float* partials, int n_tiles, int cap, float fx,
                                    float fy, float cx, float cy, float lim_x, float lim_y,
                                    float sm, void* stream) {
  const long long n = (long long)n_tiles * cap;
  const CamParams cam{fx, fy, cx, cy, lim_x, lim_y, sm};
  if (n > 0) {
    preprocess_bwd_kernel<<<gsorb_preprocess_blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
        raw, rt, dout, partials, n, cap, cam);
  }
  return (int)cudaGetLastError();
}
