// Fused pose-only Levenberg-Marquardt (kernel K4).
//
// Replaces: `_pose_optimize_f32` of the JAX package
// (orb_slam2_refactored_tpu/optim/pose_opt.py:71-168), in the form of the
// port's plain version (optim/pose_opt.py::pose_optimize_plain): `rounds`
// rounds of a fixed `iters` LM loop with a frozen-state mask, Huber weights
// in the first two rounds, chi2 reclassification of the inliers after each
// round, the analytic 3x6 Jacobian of project_stereo(transform(exp(d) @
// pose, x)) at d = 0.
//
// What bounds it on the H100: one call is ~20 iterations over N ~ 1000
// observations. An iteration needs ~300 f32 operations per observation
// (residual, Jacobian, 21+6 products for H and g, a second residual for the
// new cost) and reads ~40 bytes per observation, all L1/L2-resident after
// the first pass: ~0.3 MFLOP and 40 KB an iteration, a few microseconds of
// the card's f32 rate. The real bound is latency: each iteration depends on
// the one before through a 6x6 solve, and each needs two block-wide
// reductions. The plain PyTorch version issues ~60 launches an iteration,
// ~1200 a call; here the whole call is one launch.
//
// Design: one CTA of 512 threads runs every round and iteration. The pose,
// lambda and the done flag live in shared memory. Each thread accumulates
// the 21 distinct entries of H, the 6 of g and cost_old over its
// observations in registers; a warp shuffle tree and one pass over the
// warps' partials reduce them in a fixed order (deterministic). One thread
// forms Hd = H + lam*diag(H) + 1e-8*I, solves it by LU with partial
// pivoting (the algorithm behind torch.linalg.solve), retracts the pose
// (se3.retract, small-angle branch included) and, after the second
// reduction (cost_new), applies the accept / lambda / done rules. Once a
// round reports `done`, its remaining iterations would change nothing
// (frozen mask), so the CTA leaves the round early: same result, less
// latency. Outputs stay on the device: pose f32[7], inliers (bool[N]),
// num_inliers i32, final_cost f32; nothing is read back to the host. An
// optional `work` i32[rounds, 2] (null on the tracking path) receives each
// round's iterations run and observations active: the work that a bound on
// this call counts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kRed = 28;  // 21 entries of H, 6 of g, cost_old

struct Cam {
  float fx, fy, cx, cy, bf;
};

// ---- SE(3) on [qw qx qy qz tx ty tz], as geometry/se3.py ---------------

__device__ void quat_rotate(const float* q, const float* v, float* out) {
  const float w = q[0], ux = q[1], uy = q[2], uz = q[3];
  // uv = u x v
  const float a0 = uy * v[2] - uz * v[1];
  const float a1 = uz * v[0] - ux * v[2];
  const float a2 = ux * v[1] - uy * v[0];
  // u x uv
  const float b0 = uy * a2 - uz * a1;
  const float b1 = uz * a0 - ux * a2;
  const float b2 = ux * a1 - uy * a0;
  out[0] = v[0] + 2.0f * (w * a0 + b0);
  out[1] = v[1] + 2.0f * (w * a1 + b1);
  out[2] = v[2] + 2.0f * (w * a2 + b2);
}

__device__ void transform(const float* pose, const float* x, float* out) {
  quat_rotate(pose, x, out);
  out[0] += pose[4];
  out[1] += pose[5];
  out[2] += pose[6];
}

__device__ void quat_normalize(float* q) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float d = fmaxf(n, 1e-12f);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / d;
}

// exp(delta) @ pose, tangent order [omega, upsilon]
__device__ void retract(const float* pose, const float* d, float* out) {
  const float w0 = d[0], w1 = d[1], w2 = d[2];
  const float theta2 = w0 * w0 + w1 * w1 + w2 * w2;
  const float theta = sqrtf(fmaxf(theta2, 1e-24f));
  const bool small = theta2 < 1e-12f;
  const float half = 0.5f * theta;
  float qe[4];
  qe[0] = small ? 1.0f - theta2 / 8.0f : cosf(half);
  const float k = small ? 0.5f - theta2 / 48.0f : sinf(half) / theta;
  qe[1] = k * w0;
  qe[2] = k * w1;
  qe[3] = k * w2;
  quat_normalize(qe);
  // left Jacobian V = I + a K + b K^2, K = skew(omega)
  const float a = small ? 0.5f - theta2 / 24.0f
                        : (1.0f - cosf(theta)) / fmaxf(theta2, 1e-24f);
  const float b = small ? 1.0f / 6.0f - theta2 / 120.0f
                        : (theta - sinf(theta)) / fmaxf(theta2 * theta, 1e-24f);
  const float K[3][3] = {{0.f, -w2, w1}, {w2, 0.f, -w0}, {-w1, w0, 0.f}};
  float te[3];
  for (int i = 0; i < 3; ++i) {
    float acc = 0.f;
    for (int j = 0; j < 3; ++j) {
      float kk = 0.f;
      for (int m = 0; m < 3; ++m) kk += K[i][m] * K[m][j];
      const float v = (i == j ? 1.0f : 0.0f) + a * K[i][j] + b * kk;
      acc += v * d[3 + j];
    }
    te[i] = acc;
  }
  // compose(exp, pose): q = qe * qp, t = qe . tp + te
  const float* qp = pose;
  float q[4];
  q[0] = qe[0] * qp[0] - qe[1] * qp[1] - qe[2] * qp[2] - qe[3] * qp[3];
  q[1] = qe[0] * qp[1] + qe[1] * qp[0] + qe[2] * qp[3] - qe[3] * qp[2];
  q[2] = qe[0] * qp[2] - qe[1] * qp[3] + qe[2] * qp[0] + qe[3] * qp[1];
  q[3] = qe[0] * qp[3] + qe[1] * qp[2] - qe[2] * qp[1] + qe[3] * qp[0];
  float t[3];
  quat_rotate(qe, pose + 4, t);
  quat_normalize(q);
  for (int i = 0; i < 4; ++i) out[i] = q[i];
  for (int i = 0; i < 3; ++i) out[4 + i] = t[i] + te[i];
}

// ---- residual, as optim/pose_opt.py::_residuals -------------------------

struct Obs {
  float x[3], u, v, ur, inv_s2;
  bool has_ur;
};

__device__ __forceinline__ float inv_z_of(float z) {
  return 1.0f / (fabsf(z) < 1e-9f ? 1e-9f : z);
}

__device__ void residual(const float* pose, const Obs& o, const Cam& c,
                         float* r, float* xc) {
  transform(pose, o.x, xc);
  const float iz = inv_z_of(xc[2]);
  const float pu = c.fx * xc[0] * iz + c.cx;
  const float pv = c.fy * xc[1] * iz + c.cy;
  const float pr = pu - c.bf * iz;
  r[0] = o.u - pu;
  r[1] = o.v - pv;
  r[2] = o.has_ur ? (o.ur - pr) : 0.0f;
}

__device__ __forceinline__ float chi2_of(const float* r, float inv_s2) {
  return (r[0] * r[0] + r[1] * r[1] + r[2] * r[2]) * inv_s2;
}

__device__ __forceinline__ float huber_w(float chi2, float delta,
                                         bool use_huber) {
  const float s = sqrtf(fmaxf(chi2, 1e-12f));
  if (!use_huber) return 1.0f;
  return s > delta ? delta / s : 1.0f;
}

// J[3][6] = d r / d delta, as optim/pose_opt.py::residual_jacobian
__device__ void jacobian(const float* xc, bool has_ur, const Cam& c,
                         float J[3][6]) {
  const float X = xc[0], Y = xc[1], Z = xc[2];
  const bool small = fabsf(Z) < 1e-9f;
  const float iz = 1.0f / (small ? 1e-9f : Z);
  const float diz = small ? 0.0f : -iz * iz;
  float D[3][3] = {{c.fx * iz, 0.f, c.fx * X * diz},
                   {0.f, c.fy * iz, c.fy * Y * diz},
                   {c.fx * iz, 0.f, c.fx * X * diz - c.bf * diz}};
  if (!has_ur) D[2][0] = D[2][1] = D[2][2] = 0.f;
  for (int i = 0; i < 3; ++i) {
    const float d0 = D[i][0], d1 = D[i][1], d2 = D[i][2];
    // -(d @ [-[xc]_x | I])
    J[i][0] = -(d2 * Y - d1 * Z);
    J[i][1] = -(d0 * Z - d2 * X);
    J[i][2] = -(d1 * X - d0 * Y);
    J[i][3] = -d0;
    J[i][4] = -d1;
    J[i][5] = -d2;
  }
}

__device__ Obs load_obs(int n, const float* pts, const float* uv,
                        const float* ur, const float* inv_s2) {
  Obs o;
  o.x[0] = pts[3 * n + 0];
  o.x[1] = pts[3 * n + 1];
  o.x[2] = pts[3 * n + 2];
  o.u = uv[2 * n + 0];
  o.v = uv[2 * n + 1];
  o.has_ur = ur[n] > 0.0f;
  o.ur = o.has_ur ? ur[n] : 0.0f;
  o.inv_s2 = inv_s2[n];
  return o;
}

// Sum v[0..NV) over the block; every thread gets the totals in `out`.
template <int NV>
__device__ void block_sum(float* v, float* s_part, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    float x = v[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
    if (lane == 0) s_part[warp * NV + i] = x;
  }
  __syncthreads();
  if (threadIdx.x < NV) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += s_part[w * NV + threadIdx.x];
    out[threadIdx.x] = acc;
  }
  __syncthreads();
}

// Solve A x = b (6x6, row-major, overwritten) by LU with partial pivoting.
__device__ void solve6(float A[6][6], float* b) {
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
    for (int i = k + 1; i < 6; ++i) {
      if (fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
    }
    if (p != k) {
      for (int j = 0; j < 6; ++j) {
        const float t = A[k][j];
        A[k][j] = A[p][j];
        A[p][j] = t;
      }
      const float t = b[k];
      b[k] = b[p];
      b[p] = t;
    }
    for (int i = k + 1; i < 6; ++i) {
      const float f = A[i][k] / A[k][k];
      for (int j = k + 1; j < 6; ++j) A[i][j] -= f * A[k][j];
      b[i] -= f * b[k];
    }
  }
  for (int i = 5; i >= 0; --i) {
    float acc = b[i];
    for (int j = i + 1; j < 6; ++j) acc -= A[i][j] * b[j];
    b[i] = acc / A[i][i];
  }
}

__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const float* __restrict__ pose0, const float* __restrict__ pts,
               const float* __restrict__ uv, const float* __restrict__ ur,
               const float* __restrict__ inv_s2,
               const unsigned char* __restrict__ valid, int N, Cam cam,
               int rounds, int iters, float* __restrict__ out_pose,
               unsigned char* __restrict__ out_inl,
               int* __restrict__ out_num, float* __restrict__ out_cost,
               int* __restrict__ out_work) {
  __shared__ float s_part[kWarps * kRed];
  __shared__ float s_sum[kRed];
  __shared__ float s_pose[7], s_new[7], s_lam;
  __shared__ float s_step_inf;
  __shared__ int s_done;
  const int tid = threadIdx.x;
  const float kChi2Mono = 5.991f, kChi2Stereo = 7.815f;

  if (tid < 7) s_pose[tid] = pose0[tid];
  for (int n = tid; n < N; n += kThreads) out_inl[n] = valid[n];
  __syncthreads();

  for (int round = 0; round < rounds; ++round) {
    const bool use_huber = round < 2;
    if (tid == 0) {
      s_lam = 1e-3f;
      s_done = 0;
    }
    __syncthreads();
    if (out_work) {  // uniform over the block
      float na[1] = {0.f};
      for (int n = tid; n < N; n += kThreads) {
        na[0] += (valid[n] && out_inl[n]) ? 1.0f : 0.0f;
      }
      block_sum<1>(na, s_part, s_sum);
      if (tid == 0) out_work[2 * round + 1] = (int)(s_sum[0] + 0.5f);
    }
    int ran = 0;
    for (int it = 0; it < iters; ++it) {
      ++ran;
      // ---- H, g and cost_old at the current pose ----
      float acc[kRed];
#pragma unroll
      for (int i = 0; i < kRed; ++i) acc[i] = 0.f;
      for (int n = tid; n < N; n += kThreads) {
        if (!(valid[n] && out_inl[n])) continue;  // w = 0
        const Obs o = load_obs(n, pts, uv, ur, inv_s2);
        float r[3], xc[3], J[3][6];
        residual(s_pose, o, cam, r, xc);
        jacobian(xc, o.has_ur, cam, J);
        const float chi2 = chi2_of(r, o.inv_s2);
        const float delta = sqrtf(o.has_ur ? kChi2Stereo : kChi2Mono);
        const float wh = huber_w(chi2, delta, use_huber);
        const float w = o.inv_s2 * wh;
        int e = 0;
        for (int a = 0; a < 6; ++a) {
          for (int b = a; b < 6; ++b) {
            acc[e++] += w * (J[0][a] * J[0][b] + J[1][a] * J[1][b] +
                             J[2][a] * J[2][b]);
          }
        }
        for (int a = 0; a < 6; ++a) {
          acc[21 + a] += w * (J[0][a] * r[0] + J[1][a] * r[1] + J[2][a] * r[2]);
        }
        acc[27] += chi2 * wh;
      }
      block_sum<kRed>(acc, s_part, s_sum);
      // ---- one thread: damped solve and retraction ----
      if (tid == 0) {
        float A[6][6], g[6];
        int e = 0;
        for (int a = 0; a < 6; ++a) {
          for (int b = a; b < 6; ++b) {
            A[a][b] = s_sum[e];
            A[b][a] = s_sum[e];
            ++e;
          }
        }
        for (int a = 0; a < 6; ++a) {
          A[a][a] = A[a][a] + s_lam * A[a][a] + 1e-8f;
          g[a] = s_sum[21 + a];
        }
        solve6(A, g);
        float d[6], step_inf = 0.f;
        for (int a = 0; a < 6; ++a) {
          d[a] = -g[a];
          step_inf = fmaxf(step_inf, fabsf(d[a]));
        }
        retract(s_pose, d, s_new);
        s_step_inf = step_inf;
      }
      __syncthreads();
      const float cost_old = s_sum[27];
      // ---- cost at the candidate pose ----
      float cn[1] = {0.f};
      for (int n = tid; n < N; n += kThreads) {
        if (!(valid[n] && out_inl[n])) continue;
        const Obs o = load_obs(n, pts, uv, ur, inv_s2);
        float r[3], xc[3];
        residual(s_new, o, cam, r, xc);
        const float chi2 = chi2_of(r, o.inv_s2);
        const float delta = sqrtf(o.has_ur ? kChi2Stereo : kChi2Mono);
        cn[0] += chi2 * huber_w(chi2, delta, use_huber);
      }
      block_sum<1>(cn, s_part, s_sum);
      // ---- accept, lambda, done (frozen-state mask) ----
      if (tid == 0) {
        const float cost_new = s_sum[0];
        const float lam = s_lam;
        const bool done = s_done != 0;
        const bool improved = cost_new < cost_old;
        const float rel_gain = (cost_old - cost_new) / fmaxf(cost_old, 1e-12f);
        const bool done_now =
            (improved && (rel_gain < 1e-5f || s_step_inf < 1e-5f)) ||
            (!improved && lam >= 1e6f);
        if (improved && !done) {
          for (int i = 0; i < 7; ++i) s_pose[i] = s_new[i];
        }
        if (!done) {
          s_lam = fminf(fmaxf(improved ? lam * 0.5f : lam * 4.0f, 1e-8f), 1e6f);
        }
        s_done = (done || done_now) ? 1 : 0;
      }
      __syncthreads();
      if (s_done) break;  // later iterations of the round change nothing
    }
    if (tid == 0 && out_work) out_work[2 * round] = ran;
    // ---- reclassify: inliers = valid & chi2 <= threshold ----
    for (int n = tid; n < N; n += kThreads) {
      const Obs o = load_obs(n, pts, uv, ur, inv_s2);
      float r[3], xc[3];
      residual(s_pose, o, cam, r, xc);
      const float th = o.has_ur ? kChi2Stereo : kChi2Mono;
      out_inl[n] = (valid[n] && chi2_of(r, o.inv_s2) <= th) ? 1 : 0;
    }
    __syncthreads();
  }
  // ---- final cost over the inliers, and their count ----
  float fin[2] = {0.f, 0.f};
  for (int n = tid; n < N; n += kThreads) {
    if (!out_inl[n]) continue;
    const Obs o = load_obs(n, pts, uv, ur, inv_s2);
    float r[3], xc[3];
    residual(s_pose, o, cam, r, xc);
    fin[0] += chi2_of(r, o.inv_s2);
    fin[1] += 1.0f;
  }
  block_sum<2>(fin, s_part, s_sum);
  if (tid == 0) {
    for (int i = 0; i < 7; ++i) out_pose[i] = s_pose[i];
    *out_cost = s_sum[0];
    *out_num = (int)(s_sum[1] + 0.5f);
  }
}

}  // namespace

extern "C" int pose_lm(const void* pose0, const void* pts, const void* uv,
                       const void* ur, const void* inv_s2, const void* valid,
                       int N, float fx, float fy, float cx, float cy, float bf,
                       int rounds, int iters, void* out_pose, void* out_inl,
                       void* out_num, void* out_cost, void* out_work,
                       void* stream) {
  const Cam cam{fx, fy, cx, cy, bf};
  pose_lm_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)pose0, (const float*)pts, (const float*)uv,
      (const float*)ur, (const float*)inv_s2, (const unsigned char*)valid, N,
      cam, rounds, iters, (float*)out_pose, (unsigned char*)out_inl,
      (int*)out_num, (float*)out_cost, (int*)out_work);
  return (int)cudaGetLastError();
}
