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
//   K2b: d_screen [T, 16, cap] -> d_rt [12] = the sum over instances and
//        screen rows of d_screen * d screen / d rt (rt = R row-major, then
//        t), in one launch. d_raw is zero by contract: tracking never
//        differentiates the pack.
//
// What bounds them on the H100: bytes. K2f reads 14 and writes 16 floats
// per instance (2 x 39 MB at 1200 tiles x cap 512) for ~160 f32
// operations. K2b reads the 6 pose-dependent cotangent rows of every slot
// and the 10 raw rows it needs (mean, world covariance, live) of the slots
// whose cotangent is not zero, and does ~480 operations on each of those.
//
// Design: K2f is one thread per (tile, slot), rows read and written along
// the contiguous slot axis (coalesced). K2b is one reverse pass: each thread
// evaluates ewa_rows once, keeping its intermediates in registers (Ewa),
// and ewa_adjoint sweeps back from the six cotangent rows (u, v, ca, cb, cc,
// z) to the 12 pose numbers (the steps K10 shares with them, under K2's
// Fused arithmetic, are ewa.cuh's). The adjoint is written by hand: the
// reference linearizes _ewa_rows with jax.vjp inside its kernel, which CUDA has no
// counterpart of, and twelve forward-mode passes on dual numbers, one per
// pose number, would cost ~8x the operations. It takes the derivatives
// the JAX VJP takes at every select and clip, and
// tests/test_torch_kernel_redesign.py holds a step-by-step PyTorch mirror of
// the sweep against the JAX VJP on packs with every branch taken.
// The sum is inside the launch, deterministic and without float atomics:
// each thread accumulates its 12 sums over a grid-stride set of slots (the
// grid depends on n only), each warp adds its lanes by the halving tree
// (16 shuffles), each block adds its warps in warp order into its row of a
// workspace; the last block to finish (an integer ticket: __threadfence,
// then atomicAdd on a counter that it resets for the next launch) adds the
// block rows in a fixed order and writes d_rt.
// The sweep holds 96 registers, so 2 blocks share an SM; held to 3 blocks
// it spills (and is then 14% faster), and keeping the pose in shared memory
// frees no registers (PERF.md).
#include "common.cuh"
#include "ewa.cuh"

using namespace gsorb;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// K2b's grid: one slot per thread up to this many blocks, then a grid-stride
// loop. Its block rows are the workspace the wrapper allocates once.
constexpr int BWD_MAX_BLOCKS = 1024;
constexpr int POSE_PAD = 16;  // 12 pose sums padded for the halving tree

struct CamParams {
  float fx, fy, cx, cy, lim_x, lim_y, sm;
};

// One instance's projection: the screen rows that depend on the pose and
// the intermediates its adjoint reads.
struct Ewa {
  float u, v, ca, cb, cc, z, vf;
  float safe_z, txr, tyr, txz, tyz;
  bool in_front, x_in, y_in, valid;
  float M[3][3];  // (sm R) cov_w
  float k[6];     // cov_cam's upper entries k00, k01, k02, k11, k12, k22
  float fx_z, fy_z, j02, j12, a, b, c, inv_det;
};

// raw: raw rows 0-2 (mean), 6-11 (world covariance) and 13 (live) at those
// indices; rt: the 12 pose numbers.
__device__ __forceinline__ Ewa ewa_rows(const float* raw, const float* rt,
                                        const CamParams& cam) {
  Ewa e;
  const float x = raw[0], y = raw[1], z3 = raw[2];
  const float cw[3][3] = {{raw[6], raw[7], raw[8]},
                          {raw[7], raw[9], raw[10]},
                          {raw[8], raw[10], raw[11]}};
  const float tx = rt[0] * x + rt[1] * y + rt[2] * z3 + rt[9];
  const float ty = rt[3] * x + rt[4] * y + rt[5] * z3 + rt[10];
  const float tz = rt[6] * x + rt[7] * y + rt[8] * z3 + rt[11];

  e.in_front = tz > NEAR_CULL;
  e.safe_z = e.in_front ? tz : 1.f;
  e.txr = tx / e.safe_z;
  e.tyr = ty / e.safe_z;
  e.x_in = !(e.txr < -cam.lim_x) && !(e.txr > cam.lim_x);
  e.y_in = !(e.tyr < -cam.lim_y) && !(e.tyr > cam.lim_y);
  e.txz = e.txr < -cam.lim_x ? -cam.lim_x : (e.txr > cam.lim_x ? cam.lim_x : e.txr);
  e.tyz = e.tyr < -cam.lim_y ? -cam.lim_y : (e.tyr > cam.lim_y ? cam.lim_y : e.tyr);

  // cov_cam = (sm R) cov_w (sm R)^T; only the six upper entries are used.
  float Rs[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j) Rs[i][j] = rt[3 * i + j] * cam.sm;
  camera_cov<Fused>(Rs, cw, e.M, e.k);

  e.fx_z = cam.fx / e.safe_z;
  e.fy_z = cam.fy / e.safe_z;
  e.j02 = -(e.fx_z * e.txz);
  e.j12 = -(e.fy_z * e.tyz);
  ewa_abc<Fused>(e.fx_z, e.fy_z, e.j02, e.j12, e.k, e.a, e.b, e.c);

  const float det = e.a * e.c - e.b * e.b;
  const bool det_ok = det > 0.f;
  e.inv_det = 1.f / (det_ok ? det : 1.f);

  e.valid = raw[13] > 0.5f && e.in_front && det_ok;
  e.vf = e.valid ? 1.f : 0.f;
  e.u = cam.fx * e.txr + cam.cx;
  e.v = cam.fy * e.tyr + cam.cy;
  e.ca = e.c * e.inv_det * e.vf;
  e.cb = -e.b * e.inv_det * e.vf;
  e.cc = e.a * e.inv_det * e.vf;
  e.z = e.valid ? tz : 0.f;
  return e;
}

// Adds d rt of one instance (cotangents g of the rows u, v, ca, cb, cc, z)
// to acc[0..11]: the reverse sweep of ewa_rows. The selects and clips take
// the derivatives the JAX VJP takes: u and v carry no valid mask, so their
// cotangents reach the pose even for dead instances; the conic rows and z
// only for valid ones (vf = 0 otherwise; det <= 0 is invalid); nothing flows
// through safe_z behind the near plane (safe_z = 1) or through a clipped
// txz / tyz. A value exactly at a clip bound or at the near plane has
// measure zero, so which side takes it needs no care.
__device__ __forceinline__ void ewa_adjoint(const Ewa& e, const float* raw, const float* g,
                                            const CamParams& cam, float* acc) {
  const float inv_sz = 1.f / e.safe_z;
  // u = fx tx / safe_z + cx, v likewise.
  float d_tx = g[0] * e.fx_z;
  float d_ty = g[1] * e.fy_z;
  float d_sz = -(g[0] * e.fx_z * e.txr + g[1] * e.fy_z * e.tyr);
  float d_tz = 0.f;
  if (e.valid) {
    // ca = c / det, cb = -b / det, cc = a / det.
    float da, db, dc;
    conic_adjoint(g[2], g[3], g[4], e.a, e.b, e.c, e.inv_det, da, db, dc);
    d_tz = g[5];
    // a, b, c as functions of fx_z, fy_z, j02, j12 and the six Km entries;
    // w: d Rs = W M, since Km = Rs cov_w Rs^T.
    float d_fx, d_fy, d_j02, d_j12, w[6];
    abc_adjoint(da, db, dc, e.fx_z, e.fy_z, e.j02, e.j12, e.k, d_fx, d_fy, d_j02, d_j12, w);
    const float w00 = w[0], w01 = w[1], w02 = w[2], w11 = w[3], w12 = w[4], w22 = w[5];
    // j02 = -fx_z txz, j12 = -fy_z tyz.
    d_fx -= d_j02 * e.txz;
    d_fy -= d_j12 * e.tyz;
    const float d_txz = -d_j02 * e.fx_z;
    const float d_tyz = -d_j12 * e.fy_z;
    // fx_z = fx / safe_z, fy_z = fy / safe_z.
    d_sz -= (d_fx * e.fx_z + d_fy * e.fy_z) * inv_sz;
    // txz = clip(tx / safe_z), tyz likewise.
    if (e.x_in) {
      d_tx += d_txz * inv_sz;
      d_sz -= d_txz * e.txr * inv_sz;
    }
    if (e.y_in) {
      d_ty += d_tyz * inv_sz;
      d_sz -= d_tyz * e.tyr * inv_sz;
    }
#pragma unroll
    for (int l = 0; l < 3; ++l) {
      acc[l] += cam.sm * (w00 * e.M[0][l] + w01 * e.M[1][l] + w02 * e.M[2][l]);
      acc[3 + l] += cam.sm * (w01 * e.M[0][l] + w11 * e.M[1][l] + w12 * e.M[2][l]);
      acc[6 + l] += cam.sm * (w02 * e.M[0][l] + w12 * e.M[1][l] + w22 * e.M[2][l]);
    }
  }
  // safe_z = tz in front of the near plane, 1 behind it.
  if (e.in_front) d_tz += d_sz;
  // (tx, ty, tz) = R mean + t.
  const float m[3] = {raw[0], raw[1], raw[2]};
#pragma unroll
  for (int l = 0; l < 3; ++l) {
    acc[l] += d_tx * m[l];
    acc[3 + l] += d_ty * m[l];
    acc[6 + l] += d_tz * m[l];
  }
  acc[9] += d_tx;
  acc[10] += d_ty;
  acc[11] += d_tz;
}

__global__ void __launch_bounds__(THREADS) preprocess_fwd_kernel(
    const float* __restrict__ raw, const float* __restrict__ rt, float* __restrict__ out,
    long long n, int cap, CamParams cam) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const size_t t = (size_t)(i / cap);
  const int k = (int)(i - (long long)t * cap);
  const float* rp = raw + t * N_ATTR * cap + k;
  float r[14];
#pragma unroll
  for (int j = 0; j < 14; ++j) r[j] = rp[(size_t)j * cap];
  float pose[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) pose[j] = rt[j];
  const Ewa s = ewa_rows(r, pose, cam);
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

// The screen rows whose cotangent reaches the pose (j = 0 .. 5): u, v, ca,
// cb, cc, z.
__host__ __device__ constexpr int pose_row(int j) { return j < 5 ? j : Z; }
// The raw rows ewa_rows reads (j = 0 .. 9): mean, world covariance, live.
__host__ __device__ constexpr int raw_row(int j) { return j < 3 ? j : (j < 9 ? j + 3 : 13); }

// The six pose cotangents of slot i (zeros past n).
__device__ __forceinline__ void load_cotangents(const float* __restrict__ dout, long long i,
                                                long long n, int cap, float* g) {
  if (i < n) {
    const size_t t = (size_t)(i / cap);
    const int k = (int)(i - (long long)t * cap);
    const float* dp = dout + t * N_ATTR * cap + k;
#pragma unroll
    for (int j = 0; j < 6; ++j) g[j] = dp[(size_t)pose_row(j) * cap];
  } else {
#pragma unroll
    for (int j = 0; j < 6; ++j) g[j] = 0.f;
  }
}

__global__ void __launch_bounds__(THREADS) preprocess_bwd_kernel(
    const float* __restrict__ raw, const float* __restrict__ rt,
    const float* __restrict__ dout, float* __restrict__ d_rt, float* __restrict__ rows,
    unsigned* __restrict__ ticket, long long n, int cap, CamParams cam) {
  __shared__ float red[WARPS][POSE_PAD];
  __shared__ float fin[THREADS / POSE_PAD][POSE_PAD];  // the last block's group sums
  __shared__ bool is_last;
  float pose[12];
#pragma unroll
  for (int j = 0; j < 12; ++j) pose[j] = rt[j];
  float acc[POSE_PAD];
#pragma unroll
  for (int j = 0; j < POSE_PAD; ++j) acc[j] = 0.f;
  // One slot per thread up to BWD_MAX_BLOCKS blocks, then a grid-stride
  // loop; the next slot's cotangents are loaded before this slot's raw rows
  // and sweep, so two loads are in flight where the stride loop has two
  // slots.
  const long long stride = (long long)gridDim.x * THREADS;
  long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  float gn[6];
  load_cotangents(dout, i, n, cap, gn);
  for (; i < n; i += stride) {
    float g[6];
    bool any = false;
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      g[j] = gn[j];
      any |= g[j] != 0.f;
    }
    load_cotangents(dout, i + stride, n, cap, gn);
    if (!any) continue;  // the slot adds nothing: skip its raw rows
    const size_t t = (size_t)(i / cap);
    const int k = (int)(i - (long long)t * cap);
    const float* rp = raw + t * N_ATTR * cap + k;
    float r[14];
#pragma unroll
    for (int j = 0; j < 10; ++j) r[raw_row(j)] = rp[(size_t)raw_row(j) * cap];
    const Ewa e = ewa_rows(r, pose, cam);
    ewa_adjoint(e, r, g, cam, acc);
  }

  // The block's sums: each warp's by the halving tree (lanes 2j end with
  // row j's), then the warps in warp order.
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  halve_sums<8>(acc, lane);
  halve_sums<4>(acc, lane);
  halve_sums<2>(acc, lane);
  halve_sums<1>(acc, lane);
  acc[0] += __shfl_xor_sync(FULL_MASK, acc[0], 1);
  if ((lane & 1) == 0) red[warp][lane >> 1] = acc[0];
  __syncthreads();
  if (threadIdx.x < 12) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][threadIdx.x];
    rows[(size_t)blockIdx.x * POSE_PAD + threadIdx.x] = s;
    __threadfence();  // the row is visible to every block before the ticket
  }
  __syncthreads();
  if (threadIdx.x == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;

  // The last block: thread 16 g + j adds pose number j of the block rows
  // b = g + 16 m, m = 0, 1, ..., into UNROLL partial sums (m mod UNROLL, so
  // that UNROLL loads are in flight), adds those in order, and threads
  // j < 12 then add the 16 groups in order. The same order on every launch
  // of this n.
  constexpr int GROUPS = THREADS / POSE_PAD;
  constexpr int UNROLL = 8;
  const int j = threadIdx.x & (POSE_PAD - 1);
  const int grp = threadIdx.x / POSE_PAD;
  float part[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) part[u] = 0.f;
  if (j < 12) {
    for (int b0 = grp; b0 < (int)gridDim.x; b0 += GROUPS * UNROLL) {
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        const int b = b0 + u * GROUPS;
        if (b < (int)gridDim.x) part[u] += __ldcg(rows + (size_t)b * POSE_PAD + j);
      }
    }
  }
  float s = 0.f;
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) s += part[u];
  fin[grp][j] = s;
  __syncthreads();
  if (threadIdx.x < 12) {
    float total = 0.f;
#pragma unroll
    for (int q = 0; q < GROUPS; ++q) total += fin[q][threadIdx.x];
    d_rt[threadIdx.x] = total;
  }
  if (threadIdx.x == 0) *ticket = 0u;  // ready for the next launch
}

int bwd_blocks(long long n) {
  const long long b = (n + THREADS - 1) / THREADS;
  return (int)(b < 1 ? 1 : (b > BWD_MAX_BLOCKS ? BWD_MAX_BLOCKS : b));
}

}  // namespace

extern "C" int gsorb_preprocess_bwd_max_blocks() { return BWD_MAX_BLOCKS; }

extern "C" int gsorb_preprocess_fwd(const float* raw, const float* rt, float* out,
                                    int n_tiles, int cap, float fx, float fy, float cx,
                                    float cy, float lim_x, float lim_y, float sm,
                                    void* stream) {
  const long long n = (long long)n_tiles * cap;
  const CamParams cam{fx, fy, cx, cy, lim_x, lim_y, sm};
  if (n > 0) {
    preprocess_fwd_kernel<<<(int)((n + THREADS - 1) / THREADS), THREADS, 0,
                            (cudaStream_t)stream>>>(raw, rt, out, n, cap, cam);
  }
  return (int)cudaGetLastError();
}

// rows: [BWD_MAX_BLOCKS, 16] floats; ticket: one unsigned, 0 between
// launches. Both belong to the device and are used by one launch at a time
// (the port launches on one stream). Launches at n = 0 too: d_rt = 0.
extern "C" int gsorb_preprocess_bwd(const float* raw, const float* rt, const float* dout,
                                    float* d_rt, float* rows, unsigned* ticket, int n_tiles,
                                    int cap, float fx, float fy, float cx, float cy,
                                    float lim_x, float lim_y, float sm, void* stream) {
  const long long n = (long long)n_tiles * cap;
  const CamParams cam{fx, fy, cx, cy, lim_x, lim_y, sm};
  preprocess_bwd_kernel<<<bwd_blocks(n), THREADS, 0, (cudaStream_t)stream>>>(
      raw, rt, dout, d_rt, rows, ticket, n, cap, cam);
  return (int)cudaGetLastError();
}
