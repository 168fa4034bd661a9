// The EWA projection's steps that K2 (preprocess_instances.cu) and K10
// (map_attr.cu) share: the camera-frame covariance, the 2D covariance with
// its 0.3 px low-pass, and the adjoints of the conic and of the 2D
// covariance.
//
// The forward steps take an arithmetic policy. Under Fused the compiler may
// contract a product and a sum into one FMA, as K2 always has. Under
// Rounded every product and sum is rounded on its own (__fmul_rn /
// __fadd_rn, which are never contracted), as PyTorch's eager kernels round
// them, one kernel per operation: K10f equals the plain composite bit for
// bit under it. The sums run left to right, in the order the plain code
// writes them.
#pragma once

#include <cuda_runtime.h>

namespace gsorb {

constexpr float NEAR_CULL = 0.2f;  // p_view.z <= 0.2 culled
constexpr float LOW_PASS = 0.3f;   // pixel low-pass on the 2D covariance diagonal

struct Fused {
  static __device__ __forceinline__ float mul(float a, float b) { return a * b; }
  static __device__ __forceinline__ float add(float a, float b) { return a + b; }
};

struct Rounded {
  static __device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
  static __device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
};

// a0 b0 + a1 b1 + a2 b2, summed left to right.
template <class F>
__device__ __forceinline__ float dot3(float a0, float b0, float a1, float b1, float a2,
                                      float b2) {
  return F::add(F::add(F::mul(a0, b0), F::mul(a1, b1)), F::mul(a2, b2));
}

// cov_cam = Rs cov_w Rs^T: M = Rs cov_w and the six upper entries
// k = (k00, k01, k02, k11, k12, k22) of M Rs^T.
template <class F>
__device__ __forceinline__ void camera_cov(const float Rs[3][3], const float cw[3][3],
                                           float M[3][3], float k[6]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      M[i][j] = dot3<F>(Rs[i][0], cw[0][j], Rs[i][1], cw[1][j], Rs[i][2], cw[2][j]);
  auto km = [&](int i, int j) {
    return dot3<F>(M[i][0], Rs[j][0], M[i][1], Rs[j][1], M[i][2], Rs[j][2]);
  };
  k[0] = km(0, 0), k[1] = km(0, 1), k[2] = km(0, 2);
  k[3] = km(1, 1), k[4] = km(1, 2), k[5] = km(2, 2);
}

// The 2D covariance J K J^T + 0.3 I as (a, b, c), J = [[fx_z, 0, j02],
// [0, fy_z, j12]].
template <class F>
__device__ __forceinline__ void ewa_abc(float fx_z, float fy_z, float j02, float j12,
                                        const float k[6], float& a, float& b, float& c) {
  const float k00 = k[0], k01 = k[1], k02 = k[2], k11 = k[3], k12 = k[4], k22 = k[5];
  a = F::add(F::add(F::mul(fx_z, F::add(F::mul(fx_z, k00), F::mul(j02, k02))),
                    F::mul(j02, F::add(F::mul(fx_z, k02), F::mul(j02, k22)))),
             LOW_PASS);
  b = F::add(F::mul(fx_z, F::add(F::mul(fy_z, k01), F::mul(j12, k02))),
             F::mul(j02, F::add(F::mul(fy_z, k12), F::mul(j12, k22))));
  c = F::add(F::add(F::mul(fy_z, F::add(F::mul(fy_z, k11), F::mul(j12, k12))),
                    F::mul(j12, F::add(F::mul(fy_z, k12), F::mul(j12, k22)))),
             LOW_PASS);
}

// The conic (c, -b, a) / det's adjoint: the cotangents g2, g3, g4 of its
// three rows -> (da, db, dc).
__device__ __forceinline__ void conic_adjoint(float g2, float g3, float g4, float a, float b,
                                              float c, float inv_det, float& da, float& db,
                                              float& dc) {
  const float id = inv_det;
  const float d_inv = g2 * c - g3 * b + g4 * a;
  const float d_det = -d_inv * id * id;
  da = g4 * id + d_det * c;
  db = -g3 * id - 2.f * d_det * b;
  dc = g2 * id + d_det * a;
}

// ewa_abc's adjoint: (da, db, dc) -> the cotangents of fx_z, fy_z, j02,
// j12, and of the six k entries as w (symmetric; each entry twice the
// full-sum cotangent W of cov_cam, so that d Rs = W M for Rs cov_w Rs^T).
__device__ __forceinline__ void abc_adjoint(float da, float db, float dc, float fx_z,
                                            float fy_z, float j02, float j12, const float k[6],
                                            float& d_fx, float& d_fy, float& d_j02,
                                            float& d_j12, float w[6]) {
  const float k00 = k[0], k01 = k[1], k02 = k[2], k11 = k[3], k12 = k[4], k22 = k[5];
  d_fx = 2.f * da * (fx_z * k00 + j02 * k02) + db * (fy_z * k01 + j12 * k02);
  d_fy = db * (fx_z * k01 + j02 * k12) + 2.f * dc * (fy_z * k11 + j12 * k12);
  d_j02 = 2.f * da * (fx_z * k02 + j02 * k22) + db * (fy_z * k12 + j12 * k22);
  d_j12 = db * (fx_z * k02 + j02 * k22) + 2.f * dc * (fy_z * k12 + j12 * k22);
  w[0] = 2.f * da * fx_z * fx_z;                                        // 00
  w[1] = db * fx_z * fy_z;                                              // 01
  w[2] = 2.f * da * fx_z * j02 + db * fx_z * j12;                       // 02
  w[3] = 2.f * dc * fy_z * fy_z;                                        // 11
  w[4] = db * j02 * fy_z + 2.f * dc * fy_z * j12;                       // 12
  w[5] = 2.f * (da * j02 * j02 + db * j02 * j12 + dc * j12 * j12);      // 22
}

}  // namespace gsorb
