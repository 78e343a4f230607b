// Per-frame pose solve for Hopper (sm_90a): the Gauss-Newton / IRLS rounds
// of optimize/pose_opt.py: pose_optimize in one launch.
//
// Replaces no TPU kernel: the JAX package's optimize/pose_opt.py is plain
// XLA under jit, with no Pallas kernel. It was added because the plain
// PyTorch body is bound by host launches: 4 rounds x 10 dependent
// Gauss-Newton steps, each a few hundred tiny tensor ops, about 30,000
// launches a solve for about 20 MFLOP and 36 KB of input at the main path's
// shapes (1024 point edges, 64 line edges, 8 plane rows, 2 x 16 structural
// rows and the motion prior). On this card those bytes take about 0.01 us
// at 3.35 TB/s and the operations about 0.3 us at 67 TFLOP/s: what bounds a
// solve is the chain of 40 dependent steps, each a block-wide reduction and
// a 6x6 solve.
//
// Design: one block of THREADS threads carries every round and step of one
// solve. Per step each thread walks its share of the edges (points, lines,
// then the stacked plane, parallel and vertical rows: edge e goes to thread
// e % THREADS) and, for each residual row, computes the residual, its
// analytic Jacobian d r / d xi for the left update T <- exp(xi) T and the
// robust weight, as optimize/residuals.py writes them, adding J^T w J (the 21
// upper entries) and J^T w r (6) into float32 registers. The last thread adds
// the weak motion prior (se3_log in float32, its inverse left Jacobian in
// float64, as geometry/se3.py computes them). A warp-shuffle butterfly and a
// sum over the warps in shared memory, both in a fixed order, reduce the 27
// sums, so a launch repeats bit for bit (no atomics). Thread 0 then damps
// the system (damping + 1e-8 trace H), solves it by LU with partial
// pivoting in float32 (6x6, or 3x3 in translation-only mode), replaces a
// non-finite update by zero, applies T <- se3_exp(delta) T and publishes T
// through shared memory. At the end of each round every thread recomputes
// its edges' inlier masks at the round's pose with the robust kernel off
// (points at CHI2_MONO / CHI2_STEREO, lines at 2 CHI2_LINE, planes at
// plane_chi2), kept as mask & valid in the output arrays, which is what the
// next round's edges read. Masked-out plane, parallel and vertical rows are
// replaced by a well-conditioned plane as residuals._sanitize_planes does.
// Last, the total weighted chi2 and the point inlier count are reduced the
// same way and written beside the pose.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// What one solve reads and writes; mirrored by optimize/pose_gn.py:
// _Problem. Arrays are contiguous, row-major, float32 or bool (one byte).
struct PoseGnProblem {
  const float* T_init;      // (4, 4)
  const float* pt_world;    // (NP, 3)
  const float* pt_obs;      // (NP, 3) u, v, uR (uR <= 0: monocular)
  const float* pt_is2;      // (NP,)
  const uint8_t* pt_valid;  // (NP,)
  const float* ln_world;    // (NL, 6)
  const float* ln_obs;      // (NL, 3)
  const float* ln_is2;      // (NL,)
  const uint8_t* ln_valid;  // (NL,)
  const float* pl_world;    // (NF, 4)
  const float* pl_obs;      // (NF, 4)
  const uint8_t* pl_valid;  // (NF,)
  const float* par_world;   // (NS, 4)
  const float* par_obs;
  const uint8_t* par_valid;
  const float* ver_world;   // (NS, 4)
  const float* ver_obs;
  const uint8_t* ver_valid;
  float* T_out;             // (4, 4)
  uint8_t* pt_in;           // (NP,) final point inliers
  uint8_t* ln_in;           // (NL,)
  uint8_t* pl_in;           // (NF,)
  int64_t* n_inliers;       // ()
  float* chi2;              // ()
  int NP, NL, NF, NS;
  int n_rounds, n_iters;
  int translation_only, struct_on, use_prior;
  float fx, fy, cx, cy, bf;
  float angle_info, dist_info;
  float plane_chi2, vp_chi2;
  float sqrt_plane_chi2, sqrt_vp_chi2;  // float32 of the double root
  float damping;
  float prior_wt, prior_wr;             // 1 / sigma^2 of the prior
};

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NACC = 27;          // 21 upper entries of H, then 6 of b
constexpr unsigned FULL = 0xffffffffu;
constexpr float EPS = 1e-9f;      // geometry/se3.py: _EPS
constexpr float CHI2_MONO = 5.991f;
constexpr float CHI2_STEREO = 9.488f;
constexpr float CHI2_LINE = 3.84f;
constexpr float CHI2_LINE_MASK = (float)(3.84 * 2.0);
constexpr float SQRT_CHI2_LINE = 1.9595917942265424f;  // float(3.84 ** 0.5)

// what an edge evaluation does with its rows
enum Mode { STEP, STEP_HUBER, MASKS, FINAL };

__device__ __forceinline__ void add_row(float* acc, const float J[6], float w,
                                        float r) {
  float Jw[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) Jw[i] = J[i] * w;
  int k = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) acc[k++] += J[i] * Jw[j];
#pragma unroll
  for (int i = 0; i < 6; ++i) acc[21 + i] += Jw[i] * r;
}

// A Python number over a tensor, `s / x` in the plain version, is
// `x.reciprocal() * s` (Tensor.__rtruediv__)
__device__ __forceinline__ float rdiv(float s, float x) {
  return (1.0f / x) * s;
}

__device__ __forceinline__ float huber_w(float chi2, float delta2,
                                         float sqrt_delta2) {
  const float c = sqrtf(fmaxf(chi2, 1e-12f));
  return chi2 <= delta2 ? 1.0f : rdiv(sqrt_delta2, c);
}

__device__ __forceinline__ void cross(const float a[3], const float b[3],
                                      float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ float dot3(const float a[3], const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

// T (row-major 4x4) applied to a world point
__device__ __forceinline__ void transform(const float* T, const float* X,
                                          float out[3]) {
#pragma unroll
  for (int j = 0; j < 3; ++j)
    out[j] = X[0] * T[4 * j] + X[1] * T[4 * j + 1] + X[2] * T[4 * j + 2]
             + T[4 * j + 3];
}

// d r / d xi = [d r / d Xc, Xc x d r / d Xc]
__device__ __forceinline__ void pose_jac(const float d[3], const float Xc[3],
                                         float J[6]) {
  J[0] = d[0];
  J[1] = d[1];
  J[2] = d[2];
  cross(Xc, d, J + 3);
}

// residuals.py: _proj_grads
__device__ __forceinline__ void proj_grads(const float X[3], float fx,
                                           float fy, float du[3],
                                           float dv[3]) {
  const bool tiny = fabsf(X[2]) < EPS;
  const float zs = tiny ? EPS : X[2];
  const float dz = tiny ? 0.0f : -1.0f / (zs * zs);
  du[0] = rdiv(fx, zs);
  du[1] = 0.0f;
  du[2] = fx * X[0] * dz;
  dv[0] = 0.0f;
  dv[1] = rdiv(fy, zs);
  dv[2] = fy * X[1] * dz;
}

// se3.project of a camera-frame point -> (u, v)
__device__ __forceinline__ void project(const PoseGnProblem& p,
                                        const float X[3], float& u,
                                        float& v) {
  const float zs = fabsf(X[2]) < EPS ? EPS : X[2];
  u = p.fx * X[0] / zs + p.cx;
  v = p.fy * X[1] / zs + p.cy;
}

// One point edge (residuals.py: point_residuals): rows (du, dv, duR, dz).
// STEP*: adds its rows to acc; MASKS: writes pt_in; FINAL: adds r^T W r to
// acc[0] and the inlier to acc[1].
template <int MODE>
__device__ __forceinline__ void point_edge(const PoseGnProblem& p,
                                           const float* T, int i,
                                           float* acc) {
  const bool valid = p.pt_valid[i] != 0;
  const bool use = MODE == MASKS ? valid : p.pt_in[i] != 0;
  float Xc[3];
  transform(T, p.pt_world + 3 * i, Xc);
  const float z = Xc[2];
  float u, v;
  project(p, Xc, u, v);
  const float u_r = u - rdiv(p.bf, fmaxf(z, 1e-6f));
  const float* o = p.pt_obs + 3 * i;
  const bool st = o[2] > 0.0f;
  const float disparity = fmaxf(o[0] - o[2], 1e-3f);
  const float z_obs = st ? rdiv(p.bf, disparity) : 1.0f;
  const float r[4] = {o[0] - u, o[1] - v, st ? o[2] - u_r : 0.0f,
                      st ? z_obs - z : 0.0f};
  const bool ok = use && z > 0.05f;
  const float sigma_z = 0.0025f * z_obs * z_obs + 0.002f;
  const float is2 = p.pt_is2[i];
  const float info[4] = {
      ok ? is2 : 0.0f, ok ? is2 : 0.0f, ok ? is2 * (st ? 1.0f : 0.0f) : 0.0f,
      ok && st ? 1.0f / (sigma_z * sigma_z) : 0.0f};
  const float chi2 = r[0] * r[0] * info[0] + r[1] * r[1] * info[1]
                     + r[2] * r[2] * info[2] + r[3] * r[3] * info[3];
  const float th = st ? CHI2_STEREO : CHI2_MONO;
  if (MODE == MASKS) {
    p.pt_in[i] = valid && chi2 < th;
    return;
  }
  if (MODE == FINAL) {
    acc[0] += chi2;
    acc[1] += use ? 1.0f : 0.0f;
    return;
  }
  // the threshold is a tensor here, so its root over c is a plain division
  const float hw = MODE != STEP_HUBER || chi2 <= th
                       ? 1.0f : sqrtf(th) / sqrtf(fmaxf(chi2, 1e-12f));
  float du[3], dv[3];
  proj_grads(Xc, p.fx, p.fy, du, dv);
  const float s = st ? 1.0f : 0.0f;
  const float dbz = z > 1e-6f ? rdiv(p.bf, z * z) : 0.0f;
  const float rows[4][3] = {{-du[0], -du[1], -du[2]},
                            {-dv[0], -dv[1], -dv[2]},
                            {-(s * du[0]), -(s * du[1]), -(s * (du[2] + dbz))},
                            {0.0f, 0.0f, -s}};
  float J[6];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    pose_jac(rows[k], Xc, J);
    add_row(acc, J, info[k] * hw, r[k]);
  }
}

// One line edge (residuals.py: line_residuals): the 2D line's distance to
// each projected endpoint.
template <int MODE>
__device__ __forceinline__ void line_edge(const PoseGnProblem& p,
                                          const float* T, int i, float* acc) {
  const bool valid = p.ln_valid[i] != 0;
  const bool use = MODE == MASKS ? valid : p.ln_in[i] != 0;
  float X[2][3];
  transform(T, p.ln_world + 6 * i, X[0]);
  transform(T, p.ln_world + 6 * i + 3, X[1]);
  const float* o = p.ln_obs + 3 * i;
  const float a = o[0], b = o[1];
  float r[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float u, v;
    project(p, X[k], u, v);
    r[k] = a * u + b * v + o[2];
  }
  const bool ok = use && X[0][2] > 0.05f && X[1][2] > 0.05f;
  const float info = ok ? p.ln_is2[i] : 0.0f;
  const float chi2 = r[0] * r[0] * info + r[1] * r[1] * info;
  if (MODE == MASKS) {
    p.ln_in[i] = valid && chi2 < CHI2_LINE_MASK;
    return;
  }
  if (MODE == FINAL) {
    acc[0] += chi2;
    return;
  }
  const float w = info * (MODE == STEP_HUBER
                              ? huber_w(chi2, CHI2_LINE, SQRT_CHI2_LINE)
                              : 1.0f);
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    float du[3], dv[3], d[3], J[6];
    proj_grads(X[k], p.fx, p.fy, du, dv);
#pragma unroll
    for (int j = 0; j < 3; ++j) d[j] = a * du[j] + b * dv[j];
    pose_jac(d, X[k], J);
    add_row(acc, J, w, r[k]);
  }
}

// residuals.py: structural_terms for one sanitized world plane pw and
// camera observation po, with Ti = inv_T(T): e = (n_obs . t1, n_obs . t2,
// d_obs - d_pred, n_obs . n_pred) and, with JAC, J (4 x 6).
template <bool JAC>
__device__ __forceinline__ void structural(const float* Ti, const float pw[4],
                                           const float po[4], float e[4],
                                           float J[4][6]) {
  float pc[4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    pc[j] = pw[0] * Ti[j] + pw[1] * Ti[4 + j] + pw[2] * Ti[8 + j]
            + pw[3] * Ti[12 + j];
  const float nn = fmaxf(sqrtf(pc[0] * pc[0] + pc[1] * pc[1] + pc[2] * pc[2]),
                         EPS);
  const float sign = pc[3] / nn < 0.0f ? -1.0f : 1.0f;
  float pred[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) pred[j] = pc[j] / nn * sign;
  const float* n = pred;
  const bool use_x = fabsf(n[0]) < 0.9f;
  const float ax[3] = {use_x ? 1.0f : 0.0f, use_x ? 0.0f : 1.0f, 0.0f};
  float uu[3], t1[3], t2[3];
  cross(n, ax, uu);
  const float nu = fmaxf(sqrtf(uu[0] * uu[0] + uu[1] * uu[1] + uu[2] * uu[2]),
                         EPS);
#pragma unroll
  for (int j = 0; j < 3; ++j) t1[j] = uu[j] / nu;
  cross(n, t1, t2);
  const float* no = po;
  e[0] = dot3(no, t1);
  e[1] = dot3(no, t2);
  e[2] = po[3] - pred[3];
  e[3] = dot3(no, n);
  if (!JAC) return;
  // under T <- exp(xi) T the camera plane moves as n <- n + phi x n,
  // d <- d - n . rho; normalisation scales by sign / |n|
  const float scale = sign / nn;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    J[0][k] = 0.0f;
    J[1][k] = 0.0f;
    J[2][k] = pc[k] * scale;
    J[3][k] = 0.0f;
  }
  const float hat[3][3] = {{0.0f, -pc[2], pc[1]},
                           {pc[2], 0.0f, -pc[0]},
                           {-pc[1], pc[0], 0.0f}};
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    float dn[3], du[3], dt1[3], c1[3], c2[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) dn[j] = hat[k][j] * scale;
    cross(dn, ax, du);
    const float d1 = dot3(t1, du);
#pragma unroll
    for (int j = 0; j < 3; ++j) dt1[j] = (du[j] - t1[j] * d1) / nu;
    cross(dn, t1, c1);
    cross(n, dt1, c2);
    const float dt2[3] = {c1[0] + c2[0], c1[1] + c2[1], c1[2] + c2[2]};
    J[0][3 + k] = dot3(no, dt1);
    J[1][3 + k] = dot3(no, dt2);
    J[2][3 + k] = 0.0f;
    J[3][3 + k] = dot3(no, dn);
  }
}

// One structural row s of the stack [planes (NF) | parallel (NS) |
// vertical (NS)]: a plane adds rows 0-2 of e, a parallel relation rows 0-1,
// a vertical one row 3.
template <int MODE>
__device__ __forceinline__ void struct_edge(const PoseGnProblem& p,
                                            const float* Ti, int s,
                                            float* acc) {
  const float* world;
  const float* obs;
  bool valid, use;
  int first, n_rows;
  if (s < p.NF) {
    world = p.pl_world + 4 * s;
    obs = p.pl_obs + 4 * s;
    valid = p.pl_valid[s] != 0;
    use = MODE == MASKS ? valid : p.pl_in[s] != 0;
    first = 0;
    n_rows = 3;
  } else if (s < p.NF + p.NS) {
    const int j = s - p.NF;
    world = p.par_world + 4 * j;
    obs = p.par_obs + 4 * j;
    valid = use = p.par_valid[j] != 0 && p.struct_on;
    first = 0;
    n_rows = 2;
  } else {
    const int j = s - p.NF - p.NS;
    world = p.ver_world + 4 * j;
    obs = p.ver_obs + 4 * j;
    valid = use = p.ver_valid[j] != 0 && p.struct_on;
    first = 3;
    n_rows = 1;
  }
  if (MODE == MASKS && s >= p.NF) return;
  // residuals.py: _sanitize_planes (by validity, not by the round's mask)
  const float safe[4] = {0.0f, 0.0f, 1.0f, 1.0f};
  float pw[4], po[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    pw[j] = valid ? world[j] : safe[j];
    po[j] = valid ? obs[j] : safe[j];
  }
  constexpr bool JAC = MODE == STEP || MODE == STEP_HUBER;
  float e[4], J[4][6];
  structural<JAC>(Ti, pw, po, e, J);
  bool row[4];
  float info[4];
  float chi2 = 0.0f;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    row[k] = k >= first && k < first + n_rows;
    info[k] = use && row[k] ? (s < p.NF && k == 2 ? p.dist_info
                                                  : p.angle_info) : 0.0f;
    if (row[k]) chi2 += e[k] * e[k] * info[k];
  }
  if (MODE == MASKS) {
    p.pl_in[s] = valid && chi2 < p.plane_chi2;
    return;
  }
  if (MODE == FINAL) {
    acc[0] += chi2;
    return;
  }
  float hw = 1.0f;
  if (MODE == STEP_HUBER)
    hw = s < p.NF ? huber_w(chi2, p.plane_chi2, p.sqrt_plane_chi2)
                  : huber_w(chi2, p.vp_chi2, p.sqrt_vp_chi2);
#pragma unroll
  for (int k = 0; k < 4; ++k)
    if (row[k]) add_row(acc, J[k], info[k] * hw, e[k]);
}

__device__ __forceinline__ void matmul4(const float* A, const float* B,
                                        float* C) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      C[4 * i + j] = A[4 * i] * B[j] + A[4 * i + 1] * B[4 + j]
                     + A[4 * i + 2] * B[8 + j] + A[4 * i + 3] * B[12 + j];
}

// se3.inv_T: [R^T, -R^T t; 0 0 0 1]
__device__ __forceinline__ void inv_T(const float* T, float* Ti) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) Ti[4 * i + j] = T[4 * j + i];
    Ti[4 * i + 3] = -(T[i] * T[3] + T[4 + i] * T[7] + T[8 + i] * T[11]);
  }
  Ti[12] = 0.0f;
  Ti[13] = 0.0f;
  Ti[14] = 0.0f;
  Ti[15] = 1.0f;
}

template <typename F>
__device__ __forceinline__ void hat3(const F w[3], F W[3][3]) {
  W[0][0] = 0;     W[0][1] = -w[2]; W[0][2] = w[1];
  W[1][0] = w[2];  W[1][1] = 0;     W[1][2] = -w[0];
  W[2][0] = -w[1]; W[2][1] = w[0];  W[2][2] = 0;
}

template <typename F>
__device__ __forceinline__ void mat3(F A[3][3], F B[3][3], F C[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      C[i][j] = A[i][0] * B[0][j] + A[i][1] * B[1][j] + A[i][2] * B[2][j];
}

// se3.se3_left_jacobian_inv in float64 (Barfoot & Furgale 2014, eq. 102)
__device__ void left_jacobian_inv(const float xi[6], float J[6][6]) {
  const double rho[3] = {xi[0], xi[1], xi[2]};
  const double phi[3] = {xi[3], xi[4], xi[5]};
  const double theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool small = theta2 < 1e-4;
  const double t2 = small ? 1.0 : theta2;
  const double t = sqrt(t2);
  const double s = sin(t), c = cos(t);
  const double half = 0.5 * t;
  const double c0 = small ? 1.0 / 12.0 + theta2 / 720.0
                          : (1.0 - half * cos(half) / sin(half)) / t2;
  const double c1 = small ? 1.0 / 6.0 - theta2 / 120.0 : (t - s) / (t2 * t);
  const double c2 = small ? 1.0 / 24.0 - theta2 / 720.0
                          : (t2 + 2.0 * c - 2.0) / (2.0 * t2 * t2);
  const double c3 = small ? 1.0 / 120.0 - theta2 / 2520.0
                          : (2.0 * t - 3.0 * s + t * c) / (2.0 * t2 * t2 * t);
  double P[3][3], F[3][3], FF[3][3], FP[3][3], PF[3][3], FPF[3][3];
  double FFP[3][3], PFF[3][3], FPFF[3][3], FFPF[3][3];
  hat3(rho, P);
  hat3(phi, F);
  mat3(F, F, FF);
  mat3(F, P, FP);
  mat3(P, F, PF);
  mat3(FP, F, FPF);
  mat3(FF, P, FFP);
  mat3(PF, F, PFF);
  mat3(FPF, F, FPFF);
  mat3(F, FPF, FFPF);
  double Q[3][3], Ji[3][3], nJi[3][3], T1[3][3], T2[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      Q[i][j] = 0.5 * P[i][j] + c1 * (FP[i][j] + PF[i][j] + FPF[i][j])
                + c2 * (FFP[i][j] + PFF[i][j] - 3.0 * FPF[i][j])
                + c3 * (FPFF[i][j] + FFPF[i][j]);
      Ji[i][j] = (i == j ? 1.0 : 0.0) - 0.5 * F[i][j] + c0 * FF[i][j];
      nJi[i][j] = -Ji[i][j];
    }
  mat3(nJi, Q, T1);
  mat3(T1, Ji, T2);
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      J[i][j] = (float)Ji[i][j];
      J[i][3 + j] = (float)T2[i][j];
      J[3 + i][j] = 0.0f;
      J[3 + i][3 + j] = (float)Ji[i][j];
    }
}

// The weak motion prior log(T inv_T(T_prior)) (se3.se3_log in float32);
// with JAC, its inverse left Jacobian.
template <int MODE>
__device__ void prior_edge(const PoseGnProblem& p, const float* T,
                           const float* Tpi, float* acc) {
  float M[16];
  matmul4(T, Tpi, M);
  // so3_log
  const float w[3] = {(M[9] - M[6]) * 0.5f, (M[2] - M[8]) * 0.5f,
                      (M[4] - M[1]) * 0.5f};
  const float s = sqrtf(w[0] * w[0] + w[1] * w[1] + w[2] * w[2] + 1e-20f);
  const float c = (M[0] + M[5] + M[10] - 1.0f) / 2.0f;
  const float theta = atan2f(s, c);
  const bool small = s < 1e-5f;
  const float scale = small ? 1.0f + (1.0f - c) / 3.0f : theta / s;
  float r[6];
  float* phi = r + 3;
#pragma unroll
  for (int j = 0; j < 3; ++j) phi[j] = w[j] * scale;
  // V^-1 t
  const float th2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool small2 = th2 < 1e-8f;
  const float th2s = small2 ? 1.0f : th2;
  const float half = sqrtf(th2s) / 2.0f;
  const float cot = small2 ? 1.0f / 12.0f + th2 / 720.0f
                           : (1.0f - half * cosf(half)
                                         / fmaxf(sinf(half), EPS)) / th2s;
  float W[3][3], WW[3][3];
  hat3(phi, W);
  mat3(W, W, WW);
  const float t[3] = {M[3], M[7], M[11]};
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float row[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      row[j] = (i == j ? 1.0f : 0.0f) - 0.5f * W[i][j] + cot * WW[i][j];
    r[i] = row[0] * t[0] + row[1] * t[1] + row[2] * t[2];
  }
  const float wts[6] = {p.prior_wt, p.prior_wt, p.prior_wt,
                        p.prior_wr, p.prior_wr, p.prior_wr};
  if (MODE == FINAL) {
#pragma unroll
    for (int k = 0; k < 6; ++k) acc[0] += r[k] * r[k] * wts[k];
    return;
  }
  float J[6][6];
  left_jacobian_inv(r, J);
#pragma unroll
  for (int k = 0; k < 6; ++k) add_row(acc, J[k], wts[k], r[k]);
}

// Sums acc[0..N) over the block into out[0..N) (shared), the same on every
// launch: a butterfly within each warp, then the warps in order.
template <int N>
__device__ __forceinline__ void block_sum(float* acc, float (*red)[NACC],
                                          float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    acc[k] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < N; ++k) red[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < N) {
    float v = red[0][threadIdx.x];
#pragma unroll
    for (int w = 1; w < WARPS; ++w) v += red[w][threadIdx.x];
    out[threadIdx.x] = v;
  }
  __syncthreads();
}

// se3.se3_exp(xi) as a 4x4
__device__ void se3_exp(const float xi[6], float E[16]) {
  const float* rho = xi;
  const float* phi = xi + 3;
  const float theta2 = phi[0] * phi[0] + phi[1] * phi[1] + phi[2] * phi[2];
  const bool small = theta2 < 1e-8f;
  const float th2s = small ? 1.0f : theta2;
  const float theta = sqrtf(th2s);
  const float a = small ? 1.0f - theta2 / 6.0f : sinf(theta) / theta;
  const float b = small ? 0.5f - theta2 / 24.0f : (1.0f - cosf(theta)) / th2s;
  const float c = small ? 1.0f / 6.0f - theta2 / 120.0f : (1.0f - a) / th2s;
  float W[3][3], WW[3][3];
  hat3(phi, W);
  mat3(W, W, WW);
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float I = i == j ? 1.0f : 0.0f;
      E[4 * i + j] = I + a * W[i][j] + b * WW[i][j];
      V[j] = I + b * W[i][j] + c * WW[i][j];
    }
    E[4 * i + 3] = V[0] * rho[0] + V[1] * rho[1] + V[2] * rho[2];
  }
  E[12] = 0.0f;
  E[13] = 0.0f;
  E[14] = 0.0f;
  E[15] = 1.0f;
}

// One damped Gauss-Newton update of T (shared) from the reduced sums:
// (H + damping I + 1e-8 trace(H) I) delta = -b, LU with partial pivoting
// (the first largest pivot), delta = 0 where not finite, T <- exp(delta) T.
template <int DIM>
__device__ void solve_update(const PoseGnProblem& p, const float* sums,
                             float* T) {
  float A[DIM][DIM], x[DIM];
  {
    int k = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i)
#pragma unroll
      for (int j = i; j < 6; ++j, ++k)
        if (i < DIM && j < DIM) A[i][j] = A[j][i] = sums[k];
  }
  float trace = 0.0f;
#pragma unroll
  for (int i = 0; i < DIM; ++i) trace += A[i][i];
  const float extra = 1e-8f * trace;
#pragma unroll
  for (int i = 0; i < DIM; ++i) {
    A[i][i] = A[i][i] + p.damping + extra;
    x[i] = -sums[21 + i];
  }
#pragma unroll
  for (int c = 0; c < DIM; ++c) {
    int piv = c;
    float best = fabsf(A[c][c]);
#pragma unroll
    for (int r = c + 1; r < DIM; ++r)
      if (fabsf(A[r][c]) > best) {
        best = fabsf(A[r][c]);
        piv = r;
      }
#pragma unroll
    for (int r = c + 1; r < DIM; ++r)
      if (r == piv) {
#pragma unroll
        for (int j = 0; j < DIM; ++j) {
          const float tmp = A[c][j];
          A[c][j] = A[r][j];
          A[r][j] = tmp;
        }
        const float tmp = x[c];
        x[c] = x[r];
        x[r] = tmp;
      }
#pragma unroll
    for (int r = c + 1; r < DIM; ++r) {
      const float f = A[r][c] / A[c][c];
#pragma unroll
      for (int j = c + 1; j < DIM; ++j) A[r][j] -= f * A[c][j];
      x[r] -= f * x[c];
    }
  }
  bool finite = true;
#pragma unroll
  for (int i = DIM - 1; i >= 0; --i) {
    float s = x[i];
#pragma unroll
    for (int j = i + 1; j < DIM; ++j) s -= A[i][j] * x[j];
    x[i] = s / A[i][i];
    finite = finite && isfinite(x[i]);
  }
  float xi[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int i = 0; i < DIM; ++i) xi[i] = finite ? x[i] : 0.0f;
  float E[16], out[16];
  se3_exp(xi, E);
  matmul4(E, T, out);
#pragma unroll
  for (int k = 0; k < 16; ++k) T[k] = out[k];
}

// Every edge of this thread (edge e to thread e % THREADS), then the prior
// on the last thread.
template <int MODE>
__device__ __forceinline__ void walk_edges(const PoseGnProblem& p,
                                           const float* sT, const float* sTpi,
                                           float* acc) {
  float T[16], Ti[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) T[k] = sT[k];
  inv_T(T, Ti);
  const int n_pt_ln = p.NP + p.NL;
  const int n_edges = n_pt_ln + p.NF + 2 * p.NS;
  for (int e = threadIdx.x; e < n_edges; e += THREADS) {
    if (e < p.NP)
      point_edge<MODE>(p, T, e, acc);
    else if (e < n_pt_ln)
      line_edge<MODE>(p, T, e - p.NP, acc);
    else
      struct_edge<MODE>(p, Ti, e - n_pt_ln, acc);
  }
  if (MODE != MASKS && p.use_prior && threadIdx.x == THREADS - 1)
    prior_edge<MODE>(p, T, sTpi, acc);
}

__global__ void __launch_bounds__(THREADS) pose_gn_kernel(const PoseGnProblem p) {
  __shared__ float sT[16];
  __shared__ float sTpi[16];  // inv_T(T_init), the prior's reference
  __shared__ float red[WARPS][NACC];
  __shared__ float sums[NACC];
  const int tid = threadIdx.x;
  if (tid < 16) sT[tid] = p.T_init[tid];
  if (tid == 0) {
    float T0[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) T0[k] = p.T_init[k];
    inv_T(T0, sTpi);
  }
  // the first round's masks: every valid edge
  for (int i = tid; i < p.NP; i += THREADS) p.pt_in[i] = p.pt_valid[i] != 0;
  for (int i = tid; i < p.NL; i += THREADS) p.ln_in[i] = p.ln_valid[i] != 0;
  for (int i = tid; i < p.NF; i += THREADS) p.pl_in[i] = p.pl_valid[i] != 0;
  __syncthreads();

  for (int rnd = 0; rnd < p.n_rounds; ++rnd) {
    // g2o drops the robust kernel at round 3 (Optimizer.cc:1044-1330)
    const bool huber = rnd < 2;
    for (int it = 0; it < p.n_iters; ++it) {
      float acc[NACC];
#pragma unroll
      for (int k = 0; k < NACC; ++k) acc[k] = 0.0f;
      if (huber)
        walk_edges<STEP_HUBER>(p, sT, sTpi, acc);
      else
        walk_edges<STEP>(p, sT, sTpi, acc);
      block_sum<NACC>(acc, red, sums);
      if (tid == 0) {
        if (p.translation_only)
          solve_update<3>(p, sums, sT);
        else
          solve_update<6>(p, sums, sT);
      }
      __syncthreads();
    }
    walk_edges<MASKS>(p, sT, sTpi, nullptr);
  }

  float acc[2] = {0.0f, 0.0f};
  walk_edges<FINAL>(p, sT, sTpi, acc);
  block_sum<2>(acc, red, sums);
  if (tid < 16) p.T_out[tid] = sT[tid];
  if (tid == 0) {
    *p.chi2 = sums[0];
    *p.n_inliers = (int64_t)sums[1];
  }
}

}  // namespace

// Enqueues one solve on `stream`; returns cudaGetLastError() (0 = ok).
extern "C" int pose_gn_launch(const PoseGnProblem* problem,
                              cudaStream_t stream) {
  if (problem == nullptr || problem->NP < 0 || problem->NL < 0
      || problem->NF < 0 || problem->NS < 0 || problem->n_rounds < 0
      || problem->n_iters < 0)
    return (int)cudaErrorInvalidValue;
  pose_gn_kernel<<<1, THREADS, 0, stream>>>(*problem);
  return (int)cudaGetLastError();
}
