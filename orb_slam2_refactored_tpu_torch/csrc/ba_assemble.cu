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
// and 18.9 MB at Q = 8192: bytes bound ~1.5-6 us. Operations: ~480 f32 a
// live observation, ~10 MFLOP, ~0.3 us. So it is bound by bytes (the T
// output) and, at this size, by its launch latency far more than either.
//
// Three entries, none with an atomic on a float and none with a fill or a
// torch op beside it, so two calls on the same arguments give the same
// bits:
//
// `ba_point_index` (two launches a solve: obs_pt and obs_ok do not change
// during a `ba_solve`): a CSR of the live slots by point, offsets [Q+1]
// and slot ids [W*N] (ascending within each point; -1 past offsets[Q]),
// points clamped to [0, Q) as the plain version does, dead slots left
// out; and place [W*N], each live slot's position in `slots` (-1 on a
// dead slot). (1) A CTA a keyframe row counts the row's live slots by point,
// gives each slot its rank among the row's slots of its point in slot
// order (one warp walks the repeated ones), and writes that row of a
// [W, Q] table; the last CTA scans the point totals into offsets. (2) A
// thread a slot writes it to its place: its point's start, plus the
// table's column above its row, plus its rank. Every place is computed,
// not claimed: no sort, and the same bits every build. A row's counts and
// running counts are kept in shared memory while 2 Q ints fit there (the
// window BA, Q <= 8192); past that (the global BA, Q up to the map's
// 32,768 points) the counts are kept in the row's own `table` row and the
// running counts in a second [W, Q] block of the same scratch, with the
// same integer operations in the same order, so both give the same index.
//
// `ba_assemble` (one launch a call, no fill before it): a heterogeneous
// grid.
//   * Camera CTAs (design (a)): each of the W rows is split over C CTAs,
//     with W*C >= 132, so they alone cover the card. A CTA evaluates its
//     chunk of the row, sums Hpp (21 distinct entries) and g_p (6) per
//     thread, then over the block in a fixed tree, and stores [27]
//     partials; the row's last CTA (a __threadfence and an atomic ticket,
//     which it resets for the next call) adds the C partials in chunk
//     order and writes Hpp and g_p.
//   * Point CTAs: a warp owns one point. It walks the point's slots from
//     the index in ascending order, 32 at a time: Hll|g_l (12) summed in
//     registers, then over the warp in a fixed xor tree, and the [12] row
//     written once; each observation's (w Jp)^T Jl [6,3] added into the
//     point's [W,18] tile in shared memory in slot order (two features of
//     one keyframe on one landmark add into one row, as JAX's `.at[].add`
//     does); then the whole tile, zero rows too, written as contiguous
//     16-byte stores. A point with no live observation writes zeros. T
//     needs no zero fill and every output element is written once.
//   The observation's arithmetic (`eval_slot`, the Huber weight, the
//   depth gate, the mono third row) is the parent kernel's; f32 throughout.

// `ba_assemble_w_obs` (the matrix-free CG branch of global BA, JAX
// `optim/ba.py:317`): the same launch with the camera-point blocks written
// per live observation instead of per point. W_live [W*N, 18]: row i =
// (w Jp)^T Jl of slot `slots[i]`, so point q's rows are rows offsets[q] ..
// offsets[q+1] - 1, in the index's order, and only the first offsets[Q]
// rows are written (a dead slot has no row). A point warp, which
// evaluates its point's live slots 32 at a time anyway, stages the 32
// rows (2,304 contiguous bytes) in shared memory and stores them as
// 16-byte stores; the camera CTAs write Hpp and g_p only. At whole-map
// size (W = 128, Q ~ 30k) T would be 300 MB; the live rows of the bench
// circuit's first global BA are 0.9 MB (12,191 of 128,000 slots), where
// a row a slot took 9.2 MB of strided scalar stores. The slot's row is
// found from the slot through `place` (`ba_point_index`). The mode is a
// template argument: the dense instantiation is the code above unchanged.

// `ba_cost` (one launch a call, no torch sum after it): one slot a thread
// over ceil(W*N / 256) CTAs; chi2 stored only when asked for (the final
// gate); the Huber rho of the live slots summed per block in a fixed tree;
// the last CTA (ticket, as above) adds the per-block partials in block
// order and writes the scalar cost.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kIndexThreads = 1024;
constexpr int kSMs = 132;
constexpr unsigned kFull = 0xffffffffu;
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
// dynamic shared memory a block may take, below the 227 KB limit by room
// for the kernels' static arrays
constexpr int kSharedMax = 226 * 1024;

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

// One live observation, evaluated with its Jacobians; returns its weight
// 1/sigma^2 times the Huber factor.
__device__ float observe(const float* pose, const float R[3][3],
                         const float* __restrict__ pt_pos,
                         const float* __restrict__ obs_uv,
                         const float* __restrict__ obs_ur,
                         const float* __restrict__ obs_inv_s2, int o, int pt,
                         const Cam& cam, int use_huber, Slot& s) {
  const float inv_s2 = obs_inv_s2[o];
  eval_slot<true>(pose, R, pt_pos + 3 * pt, obs_uv[2 * o], obs_uv[2 * o + 1],
                  obs_ur[o], inv_s2, cam, s);
  const float delta = sqrtf(s.has_ur ? kChi2Stereo : kChi2Mono);
  const float sq = sqrtf(fmaxf(s.chi2, 1e-12f));
  const float wh = (use_huber && sq > delta) ? delta / sq : 1.0f;
  return inv_s2 * wh;
}

__device__ void load_pose(const float* __restrict__ kf_pose, int k,
                          float pose[7], float R[3][3]) {
  for (int i = 0; i < 7; ++i) pose[i] = kf_pose[k * 7 + i];
  quat_to_matrix(pose, R);
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

// After every thread of the CTA wrote its part of `partial`: true in the
// CTA that arrives last at `ticket` (which it resets to 0 for the next
// call). Its reads of the other CTAs' partials must bypass L1 (__ldcg).
__device__ bool last_to_arrive(int* ticket, int n, int* s_flag) {
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    const int t = atomicAdd(ticket, 1);
    *s_flag = t == n - 1;
    if (t == n - 1) atomicExch(ticket, 0);
  }
  __syncthreads();
  if (*s_flag) __threadfence();
  return *s_flag;
}

// ---------------------------------------------------------------------------
// ba_point_index
// ---------------------------------------------------------------------------

struct IndexArgs {
  const int* obs_pt;
  const unsigned char* obs_ok;
  int S, N, Q;
  int* offsets;  // [Q+1]
  int* slots;    // [S]
  int* place;    // [S]: a live slot's position in `slots`, -1 on a dead one
  int* table;    // [2 S/N, Q]: row k's live slots of each point, then
                 // (past kIndexSharedQ) the rows' running counts
  int* rank;     // [S]: a live slot's place among its row's of its point
  int* count;    // [Q], zero between solves
  int* ticket;   // [1], zero between solves
};

// Launch 1, a CTA a keyframe row: the row's live slots counted by point
// (integer atomics); a slot whose point the row holds
// once has rank 0; the others are gathered in slot order (a block-wide
// ordered compaction) and one warp walks them 32 at a time: lanes of one
// point find each other (`__match_any_sync`), the lowest reads and
// advances the point's running count, and each lane's rank is that count
// plus the lanes of its point below it. So ranks follow slot order. The
// row of `table` is written whole and its nonzero counts added to the
// point totals in `count`; the last CTA scans the totals into offsets and
// zeroes `count`. The counts and running counts are in shared memory, or
// with kGlobal (a Q whose 2 Q ints do not fit there) in the row's `table`
// row and its row of the block after the table.
template <bool kGlobal>
__global__ void __launch_bounds__(kIndexThreads) index_rows_kernel(IndexArgs a) {
  // shared: [cnt[Q] | run[Q] |] the repeated slots [1024] | their points
  extern __shared__ int s_idx[];
  __shared__ int s_warp[kIndexThreads / 32];
  __shared__ int s_last;
  const int k = blockIdx.x, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  int* trow = a.table + (size_t)k * a.Q;
  int* cnt = kGlobal ? trow : s_idx;
  int* run = kGlobal ? a.table + ((size_t)gridDim.x + k) * a.Q : s_idx + a.Q;
  int* rep = kGlobal ? s_idx : s_idx + 2 * a.Q;
  int* rep_q = rep + kIndexThreads;
  const bool row = k * a.N < a.S;  // no row at all when S = 0
  for (int q = tid; q < a.Q; q += kIndexThreads) cnt[q] = run[q] = 0;
  __syncthreads();
  for (int n = tid; row && n < a.N; n += kIndexThreads) {
    const int s = k * a.N + n;
    if (a.obs_ok[s]) atomicAdd(&cnt[min(max(a.obs_pt[s], 0), a.Q - 1)], 1);
  }
  __syncthreads();
  for (int c0 = 0; row && c0 < a.N; c0 += kIndexThreads) {
    const int n = c0 + tid, s = k * a.N + n;
    const int q = n < a.N && a.obs_ok[s] ? min(max(a.obs_pt[s], 0), a.Q - 1)
                                         : -1;
    // in global memory the counts were added at L2: read them there
    const bool repeated = q >= 0 && (kGlobal ? __ldcg(cnt + q) : cnt[q]) > 1;
    if (q >= 0 && !repeated) a.rank[s] = 0;
    // ordered compaction of the repeated slots
    const unsigned ballot = __ballot_sync(kFull, repeated);
    if (lane == 0) s_warp[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, total = 0;
    for (int w = 0; w < kIndexThreads / 32; ++w) {
      before += w < warp ? s_warp[w] : 0;
      total += s_warp[w];
    }
    if (repeated) {
      const int j = before + __popc(ballot & ((1u << lane) - 1u));
      rep[j] = s;
      rep_q[j] = q;
    }
    __syncthreads();
    if (warp == 0) {
      for (int j0 = 0; j0 < total; j0 += 32) {
        const int r = j0 + lane < total ? rep[j0 + lane] : -1;
        const int rq = r >= 0 ? rep_q[j0 + lane] : -1;
        const unsigned same = __match_any_sync(kFull, rq);
        const int lead = __ffs(same) - 1;
        int base = 0;
        if (lane == lead && rq >= 0) {
          base = run[rq];
          run[rq] = base + __popc(same);
        }
        base = __shfl_sync(kFull, base, lead);
        if (r >= 0) a.rank[r] = base + __popc(same & ((1u << lane) - 1u));
        __syncwarp();
      }
    }
    __syncthreads();
  }
  for (int q = tid; row && q < a.Q; q += kIndexThreads) {
    const int c = kGlobal ? __ldcg(cnt + q) : cnt[q];
    if (!kGlobal) trow[q] = c;
    if (c) atomicAdd(&a.count[q], c);
  }
  if (!last_to_arrive(a.ticket, gridDim.x, &s_last)) return;
  // exclusive scan of the totals: a contiguous run of points a thread
  const int per = (a.Q + kIndexThreads - 1) / kIndexThreads;
  const int q0 = min(a.Q, tid * per), q1 = min(a.Q, q0 + per);
  int mine = 0;
  for (int q = q0; q < q1; ++q) mine += __ldcg(a.count + q);
  int incl = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int o = __shfl_up_sync(kFull, incl, off);
    if (lane >= off) incl += o;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int acc = incl - mine;
  for (int w = 0; w < warp; ++w) acc += s_warp[w];
  for (int q = q0; q < q1; ++q) {
    const int c = __ldcg(a.count + q);
    a.offsets[q] = acc;
    a.count[q] = 0;
    acc += c;
  }
  if (tid == kIndexThreads - 1) a.offsets[a.Q] = acc;
}

// Launch 2, a thread a slot: a live slot's place is its point's start,
// plus the point's live slots in the rows before its own (the table's
// column above it), plus its rank in its row. So each point's slot ids
// come out ascending with no sort and no claim; a slot index past the
// total gets -1.
__global__ void __launch_bounds__(kThreads) index_scatter_kernel(IndexArgs a) {
  const int s = blockIdx.x * kThreads + threadIdx.x;
  if (s >= a.S) return;
  int pos = -1;
  if (a.obs_ok[s]) {
    const int q = min(max(a.obs_pt[s], 0), a.Q - 1);
    const int k = s / a.N;
    pos = a.offsets[q] + a.rank[s];
#pragma unroll 4
    for (int j = 0; j < k; ++j) pos += a.table[(size_t)j * a.Q + q];
    a.slots[pos] = s;
  }
  a.place[s] = pos;
  if (s >= a.offsets[a.Q]) a.slots[s] = -1;
}

// ---------------------------------------------------------------------------
// ba_assemble
// ---------------------------------------------------------------------------

struct AsmArgs {
  const float* kf_pose;
  const float* pt_pos;
  const float* obs_uv;
  const float* obs_ur;
  const int* obs_pt;
  const float* obs_inv_s2;
  const unsigned char* obs_ok;
  const int* offsets;
  const int* slots;
  int W, N, Q, C;
  Cam cam;
  int use_huber;
  float* Hpp;
  float* g_p;
  float* acc_l;
  float* T;        // dense mode: [Q*W, 18]
  float* W_obs;    // w_obs mode: [W*N, 18], the live rows in index order
  float* partial;  // [W, C, 27]
  int* ticket;     // [W], zero between calls
};

__device__ void camera_block(const AsmArgs& a, int cb) {
  __shared__ float s_part[kWarps * 27];
  __shared__ float s_sum[27];
  __shared__ int s_last;
  const int k = cb / a.C, c = cb % a.C;
  const int chunk = (a.N + a.C - 1) / a.C;
  const int n0 = min(a.N, c * chunk), n1 = min(a.N, n0 + chunk);
  float pose[7], R[3][3];
  load_pose(a.kf_pose, k, pose, R);
  float acc[27];
#pragma unroll
  for (int i = 0; i < 27; ++i) acc[i] = 0.f;
  for (int n = n0 + threadIdx.x; n < n1; n += kThreads) {
    const int o = k * a.N + n;
    if (!a.obs_ok[o]) continue;
    const int pt = min(max(a.obs_pt[o], 0), a.Q - 1);
    Slot s;
    const float w = observe(pose, R, a.pt_pos, a.obs_uv, a.obs_ur,
                            a.obs_inv_s2, o, pt, a.cam, a.use_huber, s);
    int e = 0;
    for (int i = 0; i < 6; ++i) {
      for (int j = i; j < 6; ++j) {
        acc[e++] += w * (s.Jp[0][i] * s.Jp[0][j] + s.Jp[1][i] * s.Jp[1][j] +
                         s.Jp[2][i] * s.Jp[2][j]);
      }
    }
    for (int i = 0; i < 6; ++i) {
      acc[21 + i] += w * (s.Jp[0][i] * s.r[0] + s.Jp[1][i] * s.r[1] +
                          s.Jp[2][i] * s.r[2]);
    }
  }
  block_sum<27>(acc, s_part, s_sum);
  __syncthreads();
  float* part = a.partial + ((size_t)k * a.C + c) * 27;
  if (threadIdx.x < 27) part[threadIdx.x] = s_sum[threadIdx.x];
  if (!last_to_arrive(a.ticket + k, a.C, &s_last)) return;
  if (threadIdx.x < 27) {
    float t = 0.f;
    for (int cc = 0; cc < a.C; ++cc)
      t += __ldcg(a.partial + ((size_t)k * a.C + cc) * 27 + threadIdx.x);
    s_sum[threadIdx.x] = t;
  }
  __syncthreads();
  if (threadIdx.x < 36) {
    const int i = threadIdx.x / 6, j = threadIdx.x % 6;
    const int lo = min(i, j), hi = max(i, j);
    // index of (lo, hi) in the row-major upper triangle
    const int e = lo * 6 - lo * (lo - 1) / 2 + (hi - lo);
    a.Hpp[k * 36 + threadIdx.x] = s_sum[e];
  }
  if (threadIdx.x < 6) a.g_p[k * 6 + threadIdx.x] = s_sum[21 + threadIdx.x];
}

// w_obs mode: a warp's staging area, 32 rows of 18 floats and 2 floats of
// shift (a multiple of 4 floats, so every warp's area is 16-byte aligned)
constexpr int kStage = 32 * 18 + 4;

// W_live's rows base .. base + n - 1 (n <= 32; lane l < n holds row
// base + l in t): n * 72 contiguous bytes from float e0 = 18 * base, which
// is 8-byte aligned (e0 even) and 16-byte aligned when e0 % 4 == 0. The
// rows are staged at `sh` = e0 % 4 floats into the warp's area, so that a
// float4 of W_live and its source in shared memory share their alignment;
// the run is stored as float4s, with a float2 at the head when it starts
// on 8 bytes and at the tail when it stops on 8.
__device__ void store_rows(float* __restrict__ W_live, float* stage, int base,
                           int n, const float t[18]) {
  const int lane = threadIdx.x & 31;
  const int e0 = base * 18, e1 = e0 + n * 18, sh = e0 & 3;
  if (lane < n) {
#pragma unroll
    for (int e = 0; e < 18; ++e) stage[sh + lane * 18 + e] = t[e];
  }
  __syncwarp();
  const int a0 = (e0 + 3) & ~3, a1 = e1 & ~3;  // the 16-byte-aligned middle
  const float* src = stage + sh;                // src[e - e0] is W_live[e]
  if (lane == 0 && a0 != e0)
    *reinterpret_cast<float2*>(W_live + e0) = make_float2(src[0], src[1]);
  if (lane == 1 && a1 != e1)
    *reinterpret_cast<float2*>(W_live + a1) =
        make_float2(src[a1 - e0], src[a1 - e0 + 1]);
  for (int e = a0 + 4 * lane; e < a1; e += 128)
    *reinterpret_cast<float4*>(W_live + e) =
        *reinterpret_cast<const float4*>(src + (e - e0));
  __syncwarp();  // the area is reused by the next 32 rows
}

template <bool kWObs>
__device__ void point_block(const AsmArgs& a, int pb, float* tiles) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int q = pb * kWarps + warp;
  if (q >= a.Q) return;  // the whole warp leaves together
  const int W = a.W, TW = W * 18;
  float* tile = tiles + (size_t)warp * (kWObs ? kStage : TW);
  if constexpr (!kWObs) {
    for (int e = lane; e < TW; e += 32) tile[e] = 0.f;
    __syncwarp();
  }

  const int beg = a.offsets[q], end = a.offsets[q + 1];
  float hl[12];
#pragma unroll
  for (int e = 0; e < 12; ++e) hl[e] = 0.f;
  for (int base = beg; base < end; base += 32) {
    const int i = base + lane;
    const bool act = i < end;
    int k = W + lane;  // never a keyframe: inactive lanes match no one
    float t[18];
    if (act) {
      const int o = a.slots[i];
      k = o / a.N;
      float pose[7], R[3][3];
      load_pose(a.kf_pose, k, pose, R);
      Slot s;
      const float w = observe(pose, R, a.pt_pos, a.obs_uv, a.obs_ur,
                              a.obs_inv_s2, o, q, a.cam, a.use_huber, s);
      // point blocks: Hll (9, row-major) | g_l (3)
      for (int r = 0; r < 3; ++r) {
        for (int c = 0; c < 3; ++c) {
          hl[r * 3 + c] += w * (s.Jl[0][r] * s.Jl[0][c] +
                                s.Jl[1][r] * s.Jl[1][c] +
                                s.Jl[2][r] * s.Jl[2][c]);
        }
        hl[9 + r] += w * (s.Jl[0][r] * s.r[0] + s.Jl[1][r] * s.r[1] +
                          s.Jl[2][r] * s.r[2]);
      }
      // camera-point block W_obs = (w Jp)^T Jl, [6,3] row-major
      for (int r = 0; r < 6; ++r) {
        for (int c = 0; c < 3; ++c) {
          t[r * 3 + c] = w * (s.Jp[0][r] * s.Jl[0][c] +
                              s.Jp[1][r] * s.Jl[1][c] +
                              s.Jp[2][r] * s.Jl[2][c]);
        }
      }
    }
    if constexpr (kWObs) {
      // the rows at their index positions: W_live[base + lane]
      store_rows(a.W_obs, tile, base, min(32, end - base), t);
      continue;
    }
    // slots ascend, so one keyframe's observations sit on adjacent lanes:
    // add them into its row in slot order, one round per run position
    const unsigned same = __match_any_sync(kFull, k);
    const int rp = __popc(same & ((1u << lane) - 1u));
    int rounds = rp;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      rounds = max(rounds, __shfl_xor_sync(kFull, rounds, off));
    for (int r = 0; r <= rounds; ++r) {
      if (act && rp == r) {
#pragma unroll
        for (int e = 0; e < 18; ++e) tile[k * 18 + e] += t[e];
      }
      __syncwarp();
    }
  }
#pragma unroll
  for (int e = 0; e < 12; ++e) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      hl[e] += __shfl_xor_sync(kFull, hl[e], off);
  }
  if (lane < 3) {
    const float4 v = lane == 0   ? make_float4(hl[0], hl[1], hl[2], hl[3])
                     : lane == 1 ? make_float4(hl[4], hl[5], hl[6], hl[7])
                                 : make_float4(hl[8], hl[9], hl[10], hl[11]);
    reinterpret_cast<float4*>(a.acc_l + (size_t)q * 12)[lane] = v;
  }
  if constexpr (kWObs) return;
  float* dst = a.T + (size_t)q * TW;
  if ((W & 1) == 0) {  // the point's W rows: TW / 4 aligned float4s
    const float4* src = reinterpret_cast<const float4*>(tile);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int e = lane; e < TW / 4; e += 32) d4[e] = src[e];
  } else {
    for (int e = lane; e < TW; e += 32) dst[e] = tile[e];
  }
}

template <bool kWObs>
__global__ void __launch_bounds__(kThreads) assemble_kernel(AsmArgs a) {
  extern __shared__ float4 s_tiles[];
  if ((int)blockIdx.x < a.W * a.C) {
    camera_block(a, blockIdx.x);
  } else {
    point_block<kWObs>(a, blockIdx.x - a.W * a.C,
                       reinterpret_cast<float*>(s_tiles));
  }
}

template <bool kWObs>
int launch_assemble(const AsmArgs& a, cudaStream_t stream) {
  const int n_point = (a.Q + kWarps - 1) / kWarps;
  const size_t smem = (size_t)kWarps * (kWObs ? kStage : a.W * 18) *
                      sizeof(float);
  if (smem > (size_t)kSharedMax) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        assemble_kernel<kWObs>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  assemble_kernel<kWObs><<<a.W * a.C + n_point, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// ba_cost
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
cost_kernel(const float* __restrict__ kf_pose, const float* __restrict__ pt_pos,
            const float* __restrict__ obs_uv, const float* __restrict__ obs_ur,
            const int* __restrict__ obs_pt,
            const float* __restrict__ obs_inv_s2,
            const unsigned char* __restrict__ obs_ok, int W, int N, int Q,
            Cam cam, int use_huber, float* __restrict__ partial,
            int* __restrict__ ticket, float* __restrict__ cost,
            float* __restrict__ chi2_out) {
  __shared__ float s_part[kWarps];
  __shared__ float s_sum[1];
  __shared__ int s_last;
  const int S = W * N;
  float rho[1] = {0.f};
  for (int o = blockIdx.x * kThreads + threadIdx.x; o < S;
       o += gridDim.x * kThreads) {
    const int k = o / N;
    float pose[7], R[3][3];
    for (int i = 0; i < 7; ++i) pose[i] = kf_pose[k * 7 + i];
    const int pt = min(max(obs_pt[o], 0), Q - 1);
    Slot s;
    eval_slot<false>(pose, R, pt_pos + 3 * pt, obs_uv[2 * o],
                     obs_uv[2 * o + 1], obs_ur[o], obs_inv_s2[o], cam, s);
    if (chi2_out) chi2_out[o] = s.chi2;
    if (!obs_ok[o]) continue;
    const float delta = sqrtf(s.has_ur ? kChi2Stereo : kChi2Mono);
    const float sq = sqrtf(fmaxf(s.chi2, 1e-12f));
    const float r = (sq <= delta) ? s.chi2 : 2.0f * delta * sq - delta * delta;
    rho[0] += use_huber ? r : s.chi2;
  }
  block_sum<1>(rho, s_part, s_sum);
  __syncthreads();
  if (threadIdx.x == 0) partial[blockIdx.x] = s_sum[0];
  if (!last_to_arrive(ticket, gridDim.x, &s_last)) return;
  float t[1] = {0.f};
  for (int b = threadIdx.x; b < (int)gridDim.x; b += kThreads)
    t[0] += __ldcg(partial + b);
  block_sum<1>(t, s_part, s_sum);
  if (threadIdx.x == 0) *cost = s_sum[0];
}

}  // namespace

// Launches a solve: two. Writes offsets, slots and place. `table` (2 S/N
// x Q ints) and `rank` (S) are scratch; `count` Q ints and `ticket` one,
// zero between solves (the first launch's last CTA leaves them so). A
// row's counts live in shared memory while Q <= kIndexSharedQ, in
// `table` past it (the second S/N x Q block holds the running counts).
constexpr int kIndexSharedQ =
    (kSharedMax / (int)sizeof(int) - 2 * kIndexThreads) / 2;

extern "C" int ba_point_index(const void* obs_pt, const void* obs_ok, int S,
                              int N, int Q, void* offsets, void* slots,
                              void* place, void* table, void* rank,
                              void* count, void* ticket, void* stream) {
  if (Q <= 0 || N <= 0 || S % N != 0) return (int)cudaErrorInvalidValue;
  const IndexArgs a{(const int*)obs_pt, (const unsigned char*)obs_ok, S, N,
                    Q, (int*)offsets, (int*)slots, (int*)place, (int*)table,
                    (int*)rank, (int*)count, (int*)ticket};
  const bool global = Q > kIndexSharedQ;
  const size_t smem =
      (size_t)((global ? 0 : 2 * Q) + 2 * kIndexThreads) * sizeof(int);
  const void* fn = global ? (const void*)index_rows_kernel<true>
                          : (const void*)index_rows_kernel<false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const cudaStream_t st = (cudaStream_t)stream;
  const int rows = max(1, S / N);
  if (global)
    index_rows_kernel<true><<<rows, kIndexThreads, smem, st>>>(a);
  else
    index_rows_kernel<false><<<rows, kIndexThreads, smem, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  index_scatter_kernel<<<max(1, (S + kThreads - 1) / kThreads), kThreads, 0,
                         st>>>(a);
  return (int)cudaGetLastError();
}

// Camera CTAs a window row: enough for one slot a thread and, over the W
// rows, at least one CTA an SM. The partials take [W, C, 27] floats.
extern "C" int ba_assemble_row_ctas(int W, int N) {
  if (W <= 0) return 1;
  return max(1, max((N + kThreads - 1) / kThreads, (kSMs + W - 1) / W));
}

extern "C" int ba_assemble(const void* kf_pose, const void* pt_pos,
                           const void* obs_uv, const void* obs_ur,
                           const void* obs_pt, const void* obs_inv_s2,
                           const void* obs_ok, const void* offsets,
                           const void* slots, int W, int N, int Q, float fx,
                           float fy, float cx, float cy, float bf,
                           int use_huber, void* Hpp, void* g_p,
                           void* acc_l, void* T, void* partial, void* ticket,
                           void* stream) {
  if (W <= 0) return (int)cudaGetLastError();
  AsmArgs a{(const float*)kf_pose, (const float*)pt_pos, (const float*)obs_uv,
            (const float*)obs_ur, (const int*)obs_pt,
            (const float*)obs_inv_s2, (const unsigned char*)obs_ok,
            (const int*)offsets, (const int*)slots, W, N, Q,
            ba_assemble_row_ctas(W, N), Cam{fx, fy, cx, cy, bf}, use_huber,
            (float*)Hpp, (float*)g_p, (float*)acc_l, (float*)T, nullptr,
            (float*)partial, (int*)ticket};
  return launch_assemble<false>(a, (cudaStream_t)stream);
}

// `ba_assemble` with W_live [W*N, 18] (the first offsets[Q] rows written,
// in the index's order) in place of T.
extern "C" int ba_assemble_w_obs(const void* kf_pose, const void* pt_pos,
                                 const void* obs_uv, const void* obs_ur,
                                 const void* obs_pt, const void* obs_inv_s2,
                                 const void* obs_ok, const void* offsets,
                                 const void* slots, int W, int N, int Q,
                                 float fx, float fy, float cx, float cy,
                                 float bf, int use_huber, void* Hpp,
                                 void* g_p, void* acc_l, void* W_obs,
                                 void* partial, void* ticket, void* stream) {
  if (W <= 0) return (int)cudaGetLastError();
  AsmArgs a{(const float*)kf_pose, (const float*)pt_pos, (const float*)obs_uv,
            (const float*)obs_ur, (const int*)obs_pt,
            (const float*)obs_inv_s2, (const unsigned char*)obs_ok,
            (const int*)offsets, (const int*)slots, W, N, Q,
            ba_assemble_row_ctas(W, N), Cam{fx, fy, cx, cy, bf}, use_huber,
            (float*)Hpp, (float*)g_p, (float*)acc_l, nullptr, (float*)W_obs,
            (float*)partial, (int*)ticket};
  return launch_assemble<true>(a, (cudaStream_t)stream);
}

// CTAs of a `ba_cost` launch (one partial each).
extern "C" int ba_cost_ctas(int W, int N) {
  return max(1, (W * N + kThreads - 1) / kThreads);
}

extern "C" int ba_cost(const void* kf_pose, const void* pt_pos,
                       const void* obs_uv, const void* obs_ur,
                       const void* obs_pt, const void* obs_inv_s2,
                       const void* obs_ok, int W, int N, int Q, float fx,
                       float fy, float cx, float cy, float bf, int use_huber,
                       void* partial, void* ticket, void* cost, void* chi2,
                       void* stream) {
  const Cam cam{fx, fy, cx, cy, bf};
  cost_kernel<<<ba_cost_ctas(W, N), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)kf_pose, (const float*)pt_pos, (const float*)obs_uv,
      (const float*)obs_ur, (const int*)obs_pt, (const float*)obs_inv_s2,
      (const unsigned char*)obs_ok, W, N, Q, cam, use_huber, (float*)partial,
      (int*)ticket, (float*)cost, (float*)chi2);
  return (int)cudaGetLastError();
}
