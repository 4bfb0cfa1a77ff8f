// Dense-Schur bundle-adjustment assembly and cost (kernel K5).
//
// Replaces: the per-iteration assembly of `_ba_solve_f32`'s dense-Schur
// branch in the JAX package (orb_slam2_refactored_tpu/optim/ba.py):
// `_residuals_jacobians` (:71-129), the Huber weights (:275-278), the
// block-diagonal Hpp / g_p (:283-284), the packed [Q,12] Hll|g_l scatter
// (:285-299) and the [Q*W,18] camera-block scatter T (:372-380); and
// `_cost_only` (:151-161) with the final chi2 gate (:455-457). XLA
// materialises r, Jp [W,N,3,6], Jl [W,N,3,3], their weighted copies and
// the per-observation Hll / W blocks in memory before scattering them;
// here each observation's blocks live in registers only.
//
// What bounds it on the H100: per LM iteration the window has W*N = 32 *
// 1000 observation slots. Inputs are ~1 MB (observations, poses, the Q
// points); the outputs are dominated by T, Q*W*18 f32 = 4.7 MB at Q = 2048
// and 18.9 MB at Q = 8192, zeroed by the wrapper and then written by
// atomics: bytes bound ~1.5-6 us. Operations: ~400 f32 a live observation
// (residual, two Jacobian blocks, 21 + 6 + 9 + 3 + 18 weighted products),
// ~10 MFLOP, ~0.3 us. So it is bound by bytes (the T output) and, at this
// size, by its launch latency far more than either.
//
// Design: one block of 256 threads per window row (W blocks). A thread
// walks the row's observations with a stride of 256 and skips the slots
// that carry no observation (obs_ok false: padding rows, unmatched
// features, points outside the compacted set), which in the plain version
// contribute exact zeros. Hpp (21 distinct entries) and g_p (6) are summed
// in registers and reduced per row by the block (shuffle tree, then the
// warps' partials in a fixed order): no atomics, deterministic. Hll|g_l
// and T rows are shared between window rows and between observations, so
// they are added with f32 atomicAdd: their sums come out in no fixed order
// and agree with the plain version to a tolerance, not bit for bit. Two
// features of one keyframe on one landmark add into the same T row, as
// JAX's `.at[].add` does.
//
// `ba_cost`: the same residual per slot; chi2 for every slot (the point
// index clipped to [0, Q), as JAX does) and the Huber rho summed over the
// observations, reduced per row (rho_row[W]; the caller sums the W rows).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;

struct Cam {
  float fx, fy, cx, cy, bf;
};

struct Slot {
  float r[3];
  float Jp[3][6];
  float Jl[3][3];
  float chi2;
  bool has_ur;
};

__device__ void quat_to_matrix(const float* q, float R[3][3]) {
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  R[0][0] = 1.f - 2.f * (y * y + z * z);
  R[0][1] = 2.f * (x * y - w * z);
  R[0][2] = 2.f * (x * z + w * y);
  R[1][0] = 2.f * (x * y + w * z);
  R[1][1] = 1.f - 2.f * (x * x + z * z);
  R[1][2] = 2.f * (y * z - w * x);
  R[2][0] = 2.f * (x * z - w * y);
  R[2][1] = 2.f * (y * z + w * x);
  R[2][2] = 1.f - 2.f * (x * x + y * y);
}

__device__ void transform(const float* pose, const float* v, float* out) {
  const float w = pose[0], ux = pose[1], uy = pose[2], uz = pose[3];
  const float a0 = uy * v[2] - uz * v[1];
  const float a1 = uz * v[0] - ux * v[2];
  const float a2 = ux * v[1] - uy * v[0];
  const float b0 = uy * a2 - uz * a1;
  const float b1 = uz * a0 - ux * a2;
  const float b2 = ux * a1 - uy * a0;
  out[0] = v[0] + 2.0f * (w * a0 + b0) + pose[4];
  out[1] = v[1] + 2.0f * (w * a1 + b1) + pose[5];
  out[2] = v[2] + 2.0f * (w * a2 + b2) + pose[6];
}

// Residual (and, with `jac`, both Jacobian blocks) of one observation slot,
// as `_residuals_jacobians`: depth gate z > 1e-2, mono third row masked.
template <bool jac>
__device__ void eval_slot(const float* pose, const float R[3][3],
                          const float* p, float u, float v, float ur_in,
                          float inv_s2, const Cam& c, Slot& s) {
  float xc[3];
  transform(pose, p, xc);
  const float x = xc[0], y = xc[1], z = xc[2];
  const bool live = z > 1e-2f;
  const bool has_ur = ur_in > 0.0f;
  const float zs = fabsf(z) < 1e-9f ? 1e-9f : z;
  const float iz = 1.0f / zs;
  const float iz2 = iz * iz;
  const float pu = c.fx * x * iz + c.cx;
  const float pv = c.fy * y * iz + c.cy;
  const float pr = pu - c.bf * iz;
  s.r[0] = live ? u - pu : 0.f;
  s.r[1] = live ? v - pv : 0.f;
  s.r[2] = (live && has_ur) ? ur_in - pr : 0.f;
  s.has_ur = has_ur;
  s.chi2 = (s.r[0] * s.r[0] + s.r[1] * s.r[1] + s.r[2] * s.r[2]) * inv_s2;
  if (!jac) return;
  // dr/dxc = -Jproj, rows masked like the residual
  float D[3][3] = {{-c.fx * iz, 0.f, c.fx * x * iz2},
                   {0.f, -c.fy * iz, c.fy * y * iz2},
                   {-c.fx * iz, 0.f, -(-c.fx * x * iz2 + c.bf * iz2)}};
  const bool row_ok[3] = {live, live, live && has_ur};
  for (int i = 0; i < 3; ++i) {
    if (!row_ok[i]) D[i][0] = D[i][1] = D[i][2] = 0.f;
    const float d0 = D[i][0], d1 = D[i][1], d2 = D[i][2];
    // Jp_rot = -(D @ skew(xc)), skew = [[0,-z,y],[z,0,-x],[-y,x,0]]
    s.Jp[i][0] = -(d1 * z - d2 * y);
    s.Jp[i][1] = -(-d0 * z + d2 * x);
    s.Jp[i][2] = -(d0 * y - d1 * x);
    s.Jp[i][3] = d0;
    s.Jp[i][4] = d1;
    s.Jp[i][5] = d2;
    // Jl = D @ R
    for (int l = 0; l < 3; ++l) {
      s.Jl[i][l] = d0 * R[0][l] + d1 * R[1][l] + d2 * R[2][l];
    }
  }
}

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
}

__global__ void __launch_bounds__(kThreads)
assemble_kernel(const float* __restrict__ kf_pose,
                const float* __restrict__ pt_pos,
                const float* __restrict__ obs_uv,
                const float* __restrict__ obs_ur,
                const int* __restrict__ obs_pt,
                const float* __restrict__ obs_inv_s2,
                const unsigned char* __restrict__ obs_ok, int W, int N, int Q,
                Cam cam, int use_huber, float* __restrict__ Hpp,
                float* __restrict__ g_p, float* __restrict__ acc_l,
                float* __restrict__ T) {
  __shared__ float s_part[kWarps * 27];
  __shared__ float s_sum[27];
  const int k = blockIdx.x;
  float pose[7], R[3][3];
  for (int i = 0; i < 7; ++i) pose[i] = kf_pose[k * 7 + i];
  quat_to_matrix(pose, R);

  float acc[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) acc[i] = 0.f;
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const int o = k * N + n;
    if (!obs_ok[o]) continue;
    const int pt = min(max(obs_pt[o], 0), Q - 1);
    Slot s;
    eval_slot<true>(pose, R, pt_pos + 3 * pt, obs_uv[2 * o], obs_uv[2 * o + 1],
                    obs_ur[o], obs_inv_s2[o], cam, s);
    const float delta = sqrtf(s.has_ur ? kChi2Stereo : kChi2Mono);
    const float sq = sqrtf(fmaxf(s.chi2, 1e-12f));
    const float wh = (use_huber && sq > delta) ? delta / sq : 1.0f;
    const float w = obs_inv_s2[o] * wh;
    int e = 0;
    for (int a = 0; a < 6; ++a) {
      for (int b = a; b < 6; ++b) {
        acc[e++] += w * (s.Jp[0][a] * s.Jp[0][b] + s.Jp[1][a] * s.Jp[1][b] +
                         s.Jp[2][a] * s.Jp[2][b]);
      }
    }
    for (int a = 0; a < 6; ++a) {
      acc[21 + a] += w * (s.Jp[0][a] * s.r[0] + s.Jp[1][a] * s.r[1] +
                          s.Jp[2][a] * s.r[2]);
    }
    // point blocks: Hll (9, row-major) | g_l (3)
    float* dst = acc_l + (size_t)pt * 12;
    for (int i = 0; i < 3; ++i) {
      for (int j = 0; j < 3; ++j) {
        atomicAdd(dst + i * 3 + j,
                  w * (s.Jl[0][i] * s.Jl[0][j] + s.Jl[1][i] * s.Jl[1][j] +
                       s.Jl[2][i] * s.Jl[2][j]));
      }
      atomicAdd(dst + 9 + i, w * (s.Jl[0][i] * s.r[0] + s.Jl[1][i] * s.r[1] +
                                  s.Jl[2][i] * s.r[2]));
    }
    // camera-point block W_obs = (w Jp)^T Jl, [6,3] row-major, at row pt*W+k
    float* tr = T + ((size_t)pt * W + k) * 18;
    for (int i = 0; i < 6; ++i) {
      for (int j = 0; j < 3; ++j) {
        atomicAdd(tr + i * 3 + j,
                  w * (s.Jp[0][i] * s.Jl[0][j] + s.Jp[1][i] * s.Jl[1][j] +
                       s.Jp[2][i] * s.Jl[2][j]));
      }
    }
  }
  block_sum<27>(acc, s_part, s_sum);
  __syncthreads();
  if (threadIdx.x < 36) {
    const int a = threadIdx.x / 6, b = threadIdx.x % 6;
    const int lo = min(a, b), hi = max(a, b);
    // index of (lo, hi) in the row-major upper triangle
    const int e = lo * 6 - lo * (lo - 1) / 2 + (hi - lo);
    Hpp[k * 36 + threadIdx.x] = s_sum[e];
  }
  if (threadIdx.x < 6) g_p[k * 6 + threadIdx.x] = s_sum[21 + threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
cost_kernel(const float* __restrict__ kf_pose, const float* __restrict__ pt_pos,
            const float* __restrict__ obs_uv, const float* __restrict__ obs_ur,
            const int* __restrict__ obs_pt,
            const float* __restrict__ obs_inv_s2,
            const unsigned char* __restrict__ obs_ok, int N, int Q, Cam cam,
            int use_huber, float* __restrict__ rho_row,
            float* __restrict__ chi2_out) {
  __shared__ float s_part[kWarps];
  __shared__ float s_sum[1];
  const int k = blockIdx.x;
  float pose[7], R[3][3];
  for (int i = 0; i < 7; ++i) pose[i] = kf_pose[k * 7 + i];
  quat_to_matrix(pose, R);
  float rho[1] = {0.f};
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const int o = k * N + n;
    const int pt = min(max(obs_pt[o], 0), Q - 1);
    Slot s;
    eval_slot<false>(pose, R, pt_pos + 3 * pt, obs_uv[2 * o],
                     obs_uv[2 * o + 1], obs_ur[o], obs_inv_s2[o], cam, s);
    chi2_out[o] = s.chi2;
    if (!obs_ok[o]) continue;
    const float delta = sqrtf(s.has_ur ? kChi2Stereo : kChi2Mono);
    const float sq = sqrtf(fmaxf(s.chi2, 1e-12f));
    const float r = (sq <= delta) ? s.chi2 : 2.0f * delta * sq - delta * delta;
    rho[0] += use_huber ? r : s.chi2;
  }
  block_sum<1>(rho, s_part, s_sum);
  if (threadIdx.x == 0) rho_row[k] = s_sum[0];
}

}  // namespace

extern "C" int ba_assemble(const void* kf_pose, const void* pt_pos,
                           const void* obs_uv, const void* obs_ur,
                           const void* obs_pt, const void* obs_inv_s2,
                           const void* obs_ok, int W, int N, int Q, float fx,
                           float fy, float cx, float cy, float bf,
                           int use_huber, void* Hpp, void* g_p, void* acc_l,
                           void* T, void* stream) {
  if (W <= 0) return (int)cudaGetLastError();
  const Cam cam{fx, fy, cx, cy, bf};
  assemble_kernel<<<W, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)kf_pose, (const float*)pt_pos, (const float*)obs_uv,
      (const float*)obs_ur, (const int*)obs_pt, (const float*)obs_inv_s2,
      (const unsigned char*)obs_ok, W, N, Q, cam, use_huber, (float*)Hpp,
      (float*)g_p, (float*)acc_l, (float*)T);
  return (int)cudaGetLastError();
}

extern "C" int ba_cost(const void* kf_pose, const void* pt_pos,
                       const void* obs_uv, const void* obs_ur,
                       const void* obs_pt, const void* obs_inv_s2,
                       const void* obs_ok, int W, int N, int Q, float fx,
                       float fy, float cx, float cy, float bf, int use_huber,
                       void* rho_row, void* chi2, void* stream) {
  if (W <= 0) return (int)cudaGetLastError();
  const Cam cam{fx, fy, cx, cy, bf};
  cost_kernel<<<W, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)kf_pose, (const float*)pt_pos, (const float*)obs_uv,
      (const float*)obs_ur, (const int*)obs_pt, (const float*)obs_inv_s2,
      (const unsigned char*)obs_ok, N, Q, cam, use_huber, (float*)rho_row,
      (float*)chi2);
  return (int)cudaGetLastError();
}
