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
// (residual, Jacobian, 21+6 products for H and g, the cost), ~0.3 MFLOP, a
// few microseconds of the card's f32 rate even on one SM. The real bound is
// latency: each iteration depends on the one before through a block-wide
// reduction and a 6x6 solve.
//
// Design: one CTA of 512 threads runs every round and iteration, and the
// dependent chain of an iteration is kept to one pass over the
// observations, one reduction and one solve:
//   * one pass an iteration: the residual, Jacobian, Huber weight, cost
//     and the 21 + 6 entries of H and g are evaluated at the CANDIDATE pose
//     and reduced together (32 slots: H, g, cost, active count). If the
//     step is taken, those sums are the next iteration's H, g and cost_old,
//     the same bits that evaluating them again at the taken pose would
//     give; if it is refused, the previous sums stay (two buffers in shared
//     memory), and the next iteration only solves with the new lambda;
//   * the reclassification after a round is fused with the next round's
//     first evaluation (each thread owns the same observations in every
//     pass), and the last one with the final cost and inlier count;
//   * observations are loaded once a call into registers (up to 4 a
//     thread, N <= 2048); a larger N reads them from global memory in each
//     pass and keeps the inlier flags in `out_inl`;
//   * warp 0 owns the LM state: it adds the warps' partial sums, applies
//     the accept, lambda and done rules, solves the 6x6 system (LU with
//     partial pivoting, the algorithm behind torch.linalg.solve, with
//     static indices so that it stays in registers), retracts, and
//     publishes the next pose to evaluate in shared memory. (Every thread
//     solving for itself, tried first, made an iteration on no observation
//     take 9.3 us against the one-thread solve's 7.0 us on an NVIDIA H100
//     80GB HBM3 at 700 W: 16 warps issuing the solve cost more than the
//     barrier that broadcasts it.)
//   * the reduction keeps the old order bit for bit: each thread sums its
//     observations in index order; a reduce-scatter over the 32 lanes
//     combines the lanes in the same pairs and the same order as a
//     butterfly (offsets 16, 8, 4, 2, 1), so each slot gets the butterfly's
//     bits in 31 shuffles instead of 5 a slot; then lane i of warp 0 adds
//     the 16 warps' partials of slot i in warp order.
// An iteration is then one pass, 31 shuffles, two barriers and a solve.
// Once a round reports `done`, its remaining iterations would change
// nothing (frozen mask), so the CTA leaves the round early. Outputs stay on
// the device: pose f32[7], inliers (bool[N]), num_inliers i32, final_cost
// f32. An optional `work` i32[rounds, 2] (null on the tracking path)
// receives each round's iterations run and observations active: the work
// that a bound on this call counts.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kSlots = 32;  // 21 entries of H, 6 of g, cost, count, 3 free
constexpr int kCost = 27, kCount = 28;

struct Cam {
  float fx, fy, cx, cy, bf;
};

// ---- SE(3) on [qw qx qy qz tx ty tz], as geometry/se3.py ---------------

__device__ __forceinline__ void quat_rotate(const float* q, const float* v,
                                            float* out) {
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

__device__ __forceinline__ void transform(const float* pose, const float* x,
                                          float* out) {
  quat_rotate(pose, x, out);
  out[0] += pose[4];
  out[1] += pose[5];
  out[2] += pose[6];
}

__device__ __forceinline__ void quat_normalize(float* q) {
  const float n = sqrtf(q[0] * q[0] + q[1] * q[1] + q[2] * q[2] + q[3] * q[3]);
  const float d = fmaxf(n, 1e-12f);
  for (int i = 0; i < 4; ++i) q[i] = q[i] / d;
}

// exp(delta) @ pose, tangent order [omega, upsilon]
__device__ __forceinline__ void retract(const float* pose, const float* d,
                                        float* out) {
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
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float acc = 0.f;
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      float kk = 0.f;
#pragma unroll
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
  bool has_ur, valid;
};

__device__ __forceinline__ float inv_z_of(float z) {
  return 1.0f / (fabsf(z) < 1e-9f ? 1e-9f : z);
}

__device__ __forceinline__ void residual(const float* pose, const Obs& o,
                                         const Cam& c, float* r, float* xc) {
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

__device__ __forceinline__ float chi2_threshold(const Obs& o) {
  return o.has_ur ? 7.815f : 5.991f;
}

__device__ __forceinline__ float huber_w(float chi2, float delta,
                                         bool use_huber) {
  const float s = sqrtf(fmaxf(chi2, 1e-12f));
  if (!use_huber) return 1.0f;
  return s > delta ? delta / s : 1.0f;
}

// J[3][6] = d r / d delta, as optim/pose_opt.py::residual_jacobian
__device__ __forceinline__ void jacobian(const float* xc, bool has_ur,
                                         const Cam& c, float J[3][6]) {
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

// Add one active observation's H (upper triangle), g, cost and count at
// the residual r (camera point xc) to the slots.
__device__ __forceinline__ void accumulate(const Obs& o, const float* r,
                                           const float* xc, float chi2,
                                           const Cam& cam, bool use_huber,
                                           float* acc) {
  float J[3][6];
  jacobian(xc, o.has_ur, cam, J);
  const float delta = sqrtf(chi2_threshold(o));
  const float wh = huber_w(chi2, delta, use_huber);
  const float w = o.inv_s2 * wh;
  int e = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      if (b < a) continue;
      acc[e++] += w * (J[0][a] * J[0][b] + J[1][a] * J[1][b] +
                       J[2][a] * J[2][b]);
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    acc[21 + a] += w * (J[0][a] * r[0] + J[1][a] * r[1] + J[2][a] * r[2]);
  }
  acc[kCost] += chi2 * wh;
  acc[kCount] += 1.0f;
}

struct Inputs {
  const float *pts, *uv, *ur, *inv_s2;
  const unsigned char* valid;
};

__device__ __forceinline__ Obs load_obs(int n, const Inputs& in) {
  Obs o;
  o.x[0] = in.pts[3 * n + 0];
  o.x[1] = in.pts[3 * n + 1];
  o.x[2] = in.pts[3 * n + 2];
  o.u = in.uv[2 * n + 0];
  o.v = in.uv[2 * n + 1];
  o.has_ur = in.ur[n] > 0.0f;
  o.ur = o.has_ur ? in.ur[n] : 0.0f;
  o.inv_s2 = in.inv_s2[n];
  o.valid = in.valid[n] != 0;
  return o;
}

// A thread's observations n = tid + k * kThreads, in increasing n: held in
// registers (KPT a thread), or, with KPT == 0, read from global memory in
// every pass with the inlier flags kept in `inl_g`.
template <int KPT>
struct Owned {
  Obs o[KPT > 0 ? KPT : 1];
  bool inl[KPT > 0 ? KPT : 1];
};

template <int KPT, class F>
__device__ __forceinline__ void for_each_obs(Owned<KPT>& own, int N,
                                             const Inputs& in,
                                             unsigned char* inl_g, F f) {
  if constexpr (KPT > 0) {
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      if (threadIdx.x + k * kThreads < N) f(own.o[k], own.inl[k]);
    }
  } else {
    for (int n = threadIdx.x; n < N; n += kThreads) {
      const Obs o = load_obs(n, in);
      bool inl = inl_g[n] != 0;
      f(o, inl);
      inl_g[n] = inl ? 1 : 0;
    }
  }
}

// One level of the reduce-scatter below: lanes `off` apart exchange half of
// their `2 off` live slots.
template <int OFF>
__device__ __forceinline__ void scatter_level(float* v, int lane) {
  const bool upper = (lane & OFF) != 0;
#pragma unroll
  for (int j = 0; j < OFF; ++j) {
    const float send = upper ? v[j] : v[j + OFF];
    const float keep = upper ? v[j + OFF] : v[j];
    v[j] = keep + __shfl_xor_sync(kFull, send, OFF);
  }
}

// Sum the 32 slots over the block into out[32], for warp 0. Within a
// warp, a reduce-scatter: at offset `off`, a lane keeps the half of its
// slots its `off` bit names and adds the partner's copy of them, so each
// slot is combined in the same pairs and order as by a butterfly and lane i
// ends with slot i. After one barrier, lane i of warp 0 adds the warps'
// partials of slot i in warp order. Only warp 0 may read `out`, after the
// call; the caller's next barrier orders the other warps' next writes of
// `s_part` after warp 0's reads.
__device__ __forceinline__ void block_reduce(float* v, float* s_part,
                                             float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  scatter_level<16>(v, lane);
  scatter_level<8>(v, lane);
  scatter_level<4>(v, lane);
  scatter_level<2>(v, lane);
  scatter_level<1>(v, lane);
  s_part[warp * kSlots + lane] = v[0];
  __syncthreads();
  if (warp == 0) {
    float acc = 0.f;
    for (int w = 0; w < kWarps; ++w) acc += s_part[w * kSlots + lane];
    out[lane] = acc;
    __syncwarp();
  }
}

// Solve A x = b (6x6, row-major, overwritten) by LU with partial pivoting.
// Every loop runs over all 6 indices with the bound as a test, so that it
// unrolls whole, the indices are static and A stays in registers (a loop
// from k + 1 unrolls only after its outer loop, or not at all, and then
// puts A in local memory); row swaps are predicated moves.
__device__ __forceinline__ void solve6(float A[6][6], float* b) {
#pragma unroll
  for (int k = 0; k < 6; ++k) {
    int p = k;
    float best = fabsf(A[k][k]);
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (i > k && fabsf(A[i][k]) > best) {
        best = fabsf(A[i][k]);
        p = i;
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (i > k && p == i) {
#pragma unroll
        for (int j = 0; j < 6; ++j) {
          const float t = A[k][j];
          A[k][j] = A[i][j];
          A[i][j] = t;
        }
        const float t = b[k];
        b[k] = b[i];
        b[i] = t;
      }
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      if (i <= k) continue;
      const float f = A[i][k] / A[k][k];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        if (j > k) A[i][j] -= f * A[k][j];
      }
      b[i] -= f * b[k];
    }
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float acc = b[i];
#pragma unroll
    for (int j = 0; j < 6; ++j) {
      if (j > i) acc -= A[i][j] * b[j];
    }
    b[i] = acc / A[i][i];
  }
}

// The damped LM step from the sums `s` at `pose`: cand = exp(d) @ pose.
__device__ __forceinline__ void lm_step(const float* s, float lam,
                                        const float* pose, float* cand,
                                        float* step_inf) {
  float A[6][6], g[6];
  int e = 0;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
#pragma unroll
    for (int b = 0; b < 6; ++b) {
      if (b < a) continue;
      A[a][b] = s[e];
      A[b][a] = s[e];
      ++e;
    }
  }
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    A[a][a] = A[a][a] + lam * A[a][a] + 1e-8f;
    g[a] = s[21 + a];
  }
  solve6(A, g);
  float d[6], m = 0.f;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    d[a] = -g[a];
    m = fmaxf(m, fabsf(d[a]));
  }
  retract(pose, d, cand);
  *step_inf = m;
}

template <int KPT>
__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const float* __restrict__ pose0, Inputs in, int N, Cam cam,
               int rounds, int iters, float* __restrict__ out_pose,
               unsigned char* __restrict__ out_inl,
               int* __restrict__ out_num, float* __restrict__ out_cost,
               int* __restrict__ out_work) {
  __shared__ float s_part[kWarps * kSlots];
  __shared__ float s_sum[2][kSlots];
  __shared__ float s_eval[7];  // the pose the next pass evaluates
  __shared__ int s_go;         // another candidate follows
  const int tid = threadIdx.x;
  const bool leader = tid < 32;  // warp 0 owns the LM state

  Owned<KPT> own;
  if constexpr (KPT > 0) {
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const int n = tid + k * kThreads;
      if (n < N) {
        own.o[k] = load_obs(n, in);
        own.inl[k] = own.o[k].valid;
      }
    }
  } else {
    for (int n = tid; n < N; n += kThreads) out_inl[n] = in.valid[n];
  }
  // warp 0's state: the pose, its sums in s_sum[cur], lambda; identical in
  // every lane
  float pose[7], cand[7], lam = 0.f, step_inf = 0.f;
  int cur = 0, ran = 0;
#pragma unroll
  for (int i = 0; i < 7; ++i) pose[i] = pose0[i];
  float eval[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) eval[i] = pose[i];

  for (int round = 0; round < rounds; ++round) {
    const bool use_huber = round < 2;
    // ---- reclassify at the round's pose (after round 0), fused with the
    // round's first H, g and cost over the new inlier set ----
    float acc[kSlots];
#pragma unroll
    for (int i = 0; i < kSlots; ++i) acc[i] = 0.f;
    for_each_obs<KPT>(own, N, in, out_inl, [&](const Obs& o, bool& inl) {
      float r[3], xc[3];
      residual(eval, o, cam, r, xc);
      const float chi2 = chi2_of(r, o.inv_s2);
      if (round > 0) inl = o.valid && chi2 <= chi2_threshold(o);
      if (inl) accumulate(o, r, xc, chi2, cam, use_huber, acc);
    });
    block_reduce(acc, s_part, s_sum[cur]);
    if (leader) {  // ---- the round's first damped solve ----
      lam = 1e-3f;
      ran = 0;
      if (iters > 0) lm_step(s_sum[cur], lam, pose, cand, &step_inf);
      if (tid < 7) s_eval[tid] = iters > 0 ? cand[tid] : pose[tid];
      if (tid == 0) s_go = iters > 0;
    }
    __syncthreads();
    for (int it = 0; s_go; ++it) {
#pragma unroll
      for (int i = 0; i < 7; ++i) eval[i] = s_eval[i];
      // ---- H, g and cost at the candidate ----
#pragma unroll
      for (int i = 0; i < kSlots; ++i) acc[i] = 0.f;
      for_each_obs<KPT>(own, N, in, out_inl, [&](const Obs& o, bool& inl) {
        if (!inl) return;
        float r[3], xc[3];
        residual(eval, o, cam, r, xc);
        accumulate(o, r, xc, chi2_of(r, o.inv_s2), cam, use_huber, acc);
      });
      block_reduce(acc, s_part, s_sum[cur ^ 1]);
      if (leader) {
        // ---- accept, lambda, done; then the next damped solve ----
        ++ran;
        const float cost_old = s_sum[cur][kCost];
        const float cost_new = s_sum[cur ^ 1][kCost];
        const bool improved = cost_new < cost_old;
        const float rel_gain =
            (cost_old - cost_new) / fmaxf(cost_old, 1e-12f);
        const bool done =
            (improved && (rel_gain < 1e-5f || step_inf < 1e-5f)) ||
            (!improved && lam >= 1e6f);
        if (improved) {
#pragma unroll
          for (int i = 0; i < 7; ++i) pose[i] = cand[i];
          cur ^= 1;
        }
        lam = fminf(fmaxf(improved ? lam * 0.5f : lam * 4.0f, 1e-8f), 1e6f);
        // once `done`, later iterations of the round change nothing
        const bool go = !done && it + 1 < iters;
        if (go) lm_step(s_sum[cur], lam, pose, cand, &step_inf);
        if (tid < 7) s_eval[tid] = go ? cand[tid] : pose[tid];
        if (tid == 0) s_go = go;
      }
      __syncthreads();
    }
    if (tid == 0 && out_work) {
      // every pass of a round counts the same active set
      out_work[2 * round] = ran;
      out_work[2 * round + 1] = (int)(s_sum[cur][kCount] + 0.5f);
    }
#pragma unroll
    for (int i = 0; i < 7; ++i) eval[i] = s_eval[i];
  }
  // ---- reclassify at the final pose, fused with the final cost over the
  // inliers and their count ----
  float fin[kSlots];
#pragma unroll
  for (int i = 0; i < kSlots; ++i) fin[i] = 0.f;
  for_each_obs<KPT>(own, N, in, out_inl, [&](const Obs& o, bool& inl) {
    float r[3], xc[3];
    residual(eval, o, cam, r, xc);
    const float chi2 = chi2_of(r, o.inv_s2);
    if (rounds > 0) inl = o.valid && chi2 <= chi2_threshold(o);
    if (inl) {
      fin[0] += chi2;
      fin[1] += 1.0f;
    }
  });
  if constexpr (KPT > 0) {
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const int n = tid + k * kThreads;
      if (n < N) out_inl[n] = own.inl[k] ? 1 : 0;
    }
  }
  block_reduce(fin, s_part, s_sum[0]);
  if (tid == 0) {
    for (int i = 0; i < 7; ++i) out_pose[i] = pose[i];
    *out_cost = s_sum[0][0];
    *out_num = (int)(s_sum[0][1] + 0.5f);
  }
}

template <int KPT>
void launch(const float* pose0, const Inputs& in, int N, const Cam& cam,
            int rounds, int iters, float* out_pose, unsigned char* out_inl,
            int* out_num, float* out_cost, int* out_work,
            cudaStream_t stream) {
  pose_lm_kernel<KPT><<<1, kThreads, 0, stream>>>(
      pose0, in, N, cam, rounds, iters, out_pose, out_inl, out_num,
      out_cost, out_work);
}

}  // namespace

extern "C" int pose_lm(const void* pose0, const void* pts, const void* uv,
                       const void* ur, const void* inv_s2, const void* valid,
                       int N, float fx, float fy, float cx, float cy, float bf,
                       int rounds, int iters, void* out_pose, void* out_inl,
                       void* out_num, void* out_cost, void* out_work,
                       void* stream) {
  const Cam cam{fx, fy, cx, cy, bf};
  const Inputs in{(const float*)pts, (const float*)uv, (const float*)ur,
                  (const float*)inv_s2, (const unsigned char*)valid};
  const auto s = (cudaStream_t)stream;
  auto* p = (const float*)pose0;
  auto* op = (float*)out_pose;
  auto* oi = (unsigned char*)out_inl;
  auto* on = (int*)out_num;
  auto* oc = (float*)out_cost;
  auto* ow = (int*)out_work;
  if (N <= 2 * kThreads) {
    launch<2>(p, in, N, cam, rounds, iters, op, oi, on, oc, ow, s);
  } else if (N <= 4 * kThreads) {
    launch<4>(p, in, N, cam, rounds, iters, op, oi, on, oc, ow, s);
  } else {
    launch<0>(p, in, N, cam, rounds, iters, op, oi, on, oc, ow, s);
  }
  return (int)cudaGetLastError();
}
