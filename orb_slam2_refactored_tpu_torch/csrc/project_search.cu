// The projection search's per-point gates and candidate compaction
// (kernel B6): from the map's points and a pose to the rows K1 searches;
// and its feature mode: the motion-model search's per-feature gates.
//
// Replaces: the XLA stage of `search_by_projection` in the JAX package
// (orb_slam2_refactored_tpu/ops/matching.py:116-167, up to and including
// the `lax.top_k` compaction at :160), which runs on every tracked frame:
// the transform, the projection, the depth and image-bounds gates, the
// camera centre, the distance band, the predicted level, the view-angle
// gate, the search radius, then the frustum-passing points lowest index
// first and the failing ones lowest index first, the first `cap` of them.
// The port's plain version (`ops/matching.py::project_candidates_plain`)
// takes ~95 torch operations for it; this is one launch. The feature mode
// replaces the gates of `search_last_frame` (the same file, :246-251: the
// transform by the predicted pose, the projection, `z > 0.05` and the
// radius at each feature's own level), with the tracker's gather of the
// last frame's map points (slam/tracking.py, `_track_impl`); its plain
// version (`project_features_plain`) takes ~36 operations.
//
// What bounds it on the H100: at the bench's shapes (P = 32,768 points,
// cap = 8,192) it reads 57 bytes a point and writes ~62 bytes a candidate
// and 5 a point, ~2.5 MB (0.0006-0.0007 ms at 3.35 TB/s), and does ~110
// operations a point, 3.6 M in all (below a microsecond). Neither binds: a
// launch's latency, the chain of ~110 dependent operations a point (IEEE
// division, sqrtf, logf, an f64 product and sum) and the one barrier the
// partition needs do. The feature mode (N = 1,000 features) moves ~40 KB.
//
// Design: one cooperative launch (`cudaLaunchCooperativeKernel`) of
// ceil(P / (256 T)) blocks of 256 threads, T points a thread (T = 1 at the
// bench's shapes: 128 blocks, one wave), all resident at once.
//   1. Each thread computes its points' gates and row values and keeps
//      them in registers, writes `vis`, and a warp ballot counts the
//      passing points of each round and warp; the block's count goes to
//      `block_pass[block]`. Then (T <= 2) each thread loads its points'
//      two int4 descriptor words, which stay in flight across the grid
//      barrier.
//   2. Each block adds the counts of the blocks before it (and of all, the
//      total), scans its own (round, warp) counts in index order, and
//      places each point: a passing point at the number of passing points
//      before it, a failing one at total + the failing points before it.
//      That is `torch.sort((~ok).to(uint8), stable=True).indices` (and
//      `jax.lax.top_k` over the 0/1 keys): rows past `cap` are dropped.
//      Without compaction (cap >= P, or cap = 0) row p is point p.
//   The kept rows' (uv, r, level, ok, descriptor, point) are written at
//   their places and `slot[p]` is the row of point p (-1 when dropped),
//   which the claim resolution (kernel R) reads to give results per point.
// One thread block cluster instead (16 or 8 blocks of 1024 threads, 2 or
// 4 points a thread, the counts pushed through distributed shared memory,
// `cluster.sync()` for the grid barrier) was built, bit-equal, and
// measured on the H100 at the bench's shapes: 0.0103-0.0105 ms (16
// blocks) and 0.0206 (8) against this design's 0.0048. Twice the points
// an SM took twice the time: the gate chain (IEEE division, sqrtf, logf,
// an f64 product and sum) is bound by the instruction throughput of the
// SMs it runs on, not by its latency, and 16 SMs cannot match 128.
// The feature mode is a launch of its own: a thread a feature, the same
// transform and projection functions, no partition (row = feature); with
// `feat_idx` given, the point of feature i is map point feat_idx[i]
// (clamped into [0, Q), absent where negative) and its validity the map's.
//
// Rounding: every product and sum is rounded as the plain version's torch
// operations round it on the card, one operation at a time; the file is
// built with -fmad=false and the fused operations are written out:
//   - the projection's `_fma` (geometry/projection.py) is the f32 product
//     fx * x, then an exact f64 product with 1 / z and an f64 sum with cx,
//     rounded once to f32: __dmul_rn, __dadd_rn, __double2float_rn;
//   - the cross products of `quat_rotate` are torch's CUDA cross kernel,
//     which nvcc compiles (fmad on) as a product, then a fused
//     multiply-add of the other product with its negation (`cross3`);
//   - the three-term sums over the last axis (`dist`, `nrm`, the dot
//     product) add as torch's CUDA reduction adds them (`sum3`);
//   - 1.0 / z, the divisions, sqrtf, logf and ceilf with the default flags
//     (IEEE division and square root, the CUDA math library's logf), as
//     torch's own kernels call them; no --use_fast_math.
// The host passes the camera, radius and image bounds as f32 (torch casts
// a Python scalar to the tensor's f32 before it compares or multiplies).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

// The launch record (`ops/matching.py::_B6Record`): the pointers first
// (the inputs written a call, the rows and scratch a geometry's
// workspace), then what is fixed for a geometry (a device, P, cap, L, the
// camera, radius, bounds and gates).
// (outside the unnamed namespace: the exported C entry takes it)
struct B6Args {
  const float* pos;            // [Q, 3]
  const float* normal;         // [P, 3]
  const float* min_dist;       // [P]
  const float* max_dist;       // [P]
  const unsigned char* valid;  // [Q] (feature mode: may be null)
  const int4* desc;            // [P, 8] i32, two int4 a row
  const float* pose;           // [7] qw qx qy qz tx ty tz
  const float* sf;             // [L]
  const int* feat_idx;         // feature mode: [N] map point, or null
  const int* feat_level;       // feature mode: [N]
  const unsigned char* feat_valid;  // feature mode: [N] or null
  float2* uv_r;                // [rows, 2]
  float* r_r;                  // [rows]
  int* lvl_r;                  // [rows]
  unsigned char* ok_r;         // [rows]
  int4* desc_r;                // [rows, 8]
  int* cand;                   // [rows]
  unsigned char* vis;          // [P]
  int* slot;                   // [P]
  int* block_pass;             // [blocks] scratch, written before read
  int L;
  float fx, fy, cx, cy, radius;
  int bounds;  // image bounds given
  float min_x, max_x, min_y, max_y;
  int view_angle;
  int P, rows, compact;
  int Q;  // feature mode: map points (the clamp of feat_idx)
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxT = 8;  // points a thread
constexpr int kFeatureThreads = 256;
constexpr int kMaxDevices = 16;

// a*b - c*d as torch's CUDA cross kernel computes it: nvcc (fmad on)
// contracts the first product into a fused multiply-add with the negated
// second (bit-equal on 600,000 components, torch 2.11 on the H100; the
// product-first and the second-fused forms each differ on ~25-33 %)
__device__ __forceinline__ float cross_term(float a, float b, float c,
                                            float d) {
  return __fmaf_rn(a, b, -__fmul_rn(c, d));
}

__device__ __forceinline__ void cross3(const float a[3], const float b[3],
                                       float out[3]) {
  out[0] = cross_term(a[1], b[2], a[2], b[1]);
  out[1] = cross_term(a[2], b[0], a[0], b[2]);
  out[2] = cross_term(a[0], b[1], a[1], b[0]);
}

// torch.sum(x, -1) over three terms as torch's CUDA reduction adds them:
// two lanes take (x0, x2) and x1, so (x0 + x2) + x1 (bit-equal on 200,000
// rows; the other two orders differ on ~30 %)
__device__ __forceinline__ float sum3(float a, float b, float c) {
  return __fadd_rn(__fadd_rn(a, c), b);
}

// `quat_rotate(q, v)` = v + 2 (w (u x v) + u x (u x v)), op by op
__device__ __forceinline__ void quat_rotate(float w, const float u[3],
                                            const float v[3], float out[3]) {
  float c1[3], c2[3];
  cross3(u, v, c1);
  cross3(u, c1, c2);
  for (int i = 0; i < 3; ++i) {
    const float s = __fadd_rn(__fmul_rn(w, c1[i]), c2[i]);
    out[i] = __fadd_rn(v[i], __fmul_rn(2.0f, s));
  }
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}

// `_fma` of geometry/projection.py: (f32 a) * (f32 b) + c in f64, once
// rounded to f32
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}

// `se3.transform(pose, x)` then `proj.project(cam, xc)`: xc and (u, v)
__device__ __forceinline__ void transform_project(const B6Args& a,
                                                  const float x[3],
                                                  float xc[3], float* u,
                                                  float* v) {
  const float w = a.pose[0];
  const float q[3] = {a.pose[1], a.pose[2], a.pose[3]};
  quat_rotate(w, q, x, xc);
  for (int i = 0; i < 3; ++i) xc[i] = __fadd_rn(xc[i], a.pose[4 + i]);
  // inv_z = 1 / z (z = 1e-9 where |z| < 1e-9)
  const float z = (fabsf(xc[2]) < 1e-9f) ? 1e-9f : xc[2];
  const float inv_z = 1.0f / z;
  *u = fma_f64(__fmul_rn(a.fx, xc[0]), inv_z, a.cx);
  *v = fma_f64(__fmul_rn(a.fy, xc[1]), inv_z, a.cy);
}

struct Point {
  float u, v, r;
  int lvl;
  bool ok;
};

__device__ __forceinline__ Point gate_point(const B6Args& a, int p,
                                            const float cc[3],
                                            float log_sf, bool* vis_out) {
  const float x[3] = {a.pos[3 * p], a.pos[3 * p + 1], a.pos[3 * p + 2]};
  float xc[3];
  Point o;
  transform_project(a, x, xc, &o.u, &o.v);
  bool vis = a.valid[p] != 0 && xc[2] > 0.05f;
  if (a.bounds)
    vis = vis && o.u >= a.min_x && o.u < a.max_x && o.v >= a.min_y &&
          o.v < a.max_y;

  float po[3];
  for (int i = 0; i < 3; ++i) po[i] = __fsub_rn(x[i], cc[i]);
  const float dist = sqrtf(sum3(__fmul_rn(po[0], po[0]),
                                __fmul_rn(po[1], po[1]),
                                __fmul_rn(po[2], po[2])));
  const float dmax = a.max_dist[p];
  vis = vis && dist >= __fmul_rn(a.min_dist[p], 0.8f) &&
        dist <= __fmul_rn(dmax, 1.2f);

  float lv = ceilf(__fdiv_rn(
      logf(__fdiv_rn(clamp_min(dmax, 1e-6f), clamp_min(dist, 1e-6f))),
      log_sf));
  if (!isnan(lv)) lv = fminf(fmaxf(lv, 0.0f), (float)(a.L - 1));
  o.lvl = (int)lv;  // NaN converts to 0, as torch's cast does

  bool ok = vis;
  if (a.view_angle) {
    const float n[3] = {a.normal[3 * p], a.normal[3 * p + 1],
                        a.normal[3 * p + 2]};
    const float nrm = sqrtf(sum3(__fmul_rn(n[0], n[0]),
                                 __fmul_rn(n[1], n[1]),
                                 __fmul_rn(n[2], n[2])));
    const float dot = sum3(__fmul_rn(po[0], n[0]), __fmul_rn(po[1], n[1]),
                           __fmul_rn(po[2], n[2]));
    const float cosang =
        __fdiv_rn(dot, clamp_min(__fmul_rn(dist, nrm), 1e-6f));
    ok = ok && cosang > 0.5f;
  }
  o.ok = ok;
  o.r = __fmul_rn(a.radius, a.sf[o.lvl]);
  *vis_out = vis;
  return o;
}

template <int T>
__global__ void __launch_bounds__(kThreads)
    project_search_kernel(const __grid_constant__ B6Args a) {
  // descriptors held in registers across the barrier where they fit
  constexpr bool kPrefetch = T <= 2;
  cg::grid_group grid = cg::this_grid();
  __shared__ int warp_base[T][kWarps];
  __shared__ unsigned ballots[T][kWarps];
  __shared__ int red[2][kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int base = blockIdx.x * kThreads * T;

  // the camera centre, -quat_rotate(conj(q), t), and log(sf1 / sf0), as
  // the plain version computes them on 0-d and [3] tensors
  float cc[3];
  {
    const float w = a.pose[0];
    const float nu[3] = {-a.pose[1], -a.pose[2], -a.pose[3]};
    const float t[3] = {a.pose[4], a.pose[5], a.pose[6]};
    quat_rotate(w, nu, t, cc);
    for (int i = 0; i < 3; ++i) cc[i] = -cc[i];
  }
  const float log_sf = logf(__fdiv_rn(a.sf[1], a.sf[0]));

  // 1. gates and row values, kept in registers
  Point pt[T];
  unsigned bal[T];
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int p = base + k * kThreads + tid;
    bool ok = false;
    if (p < a.P) {
      bool vis;
      pt[k] = gate_point(a, p, cc, log_sf, &vis);
      a.vis[p] = vis;
      ok = pt[k].ok;
    }
    bal[k] = __ballot_sync(0xffffffffu, ok);
    if (lane == 0) ballots[k][warp] = bal[k];
  }
  __syncthreads();
  if (tid == 0) {
    int run = 0;
    for (int k = 0; k < T; ++k)
      for (int w = 0; w < kWarps; ++w) {
        warp_base[k][w] = run;
        run += __popc(ballots[k][w]);
      }
    a.block_pass[blockIdx.x] = run;
  }
  // the descriptor loads, consumed after the barrier
  int4 d0[kPrefetch ? T : 1], d1[kPrefetch ? T : 1];
  if (kPrefetch) {
#pragma unroll
    for (int k = 0; k < (kPrefetch ? T : 0); ++k) {
      const int p = base + k * kThreads + tid;
      if (p < a.P) {
        d0[k] = a.desc[2 * p];
        d1[k] = a.desc[2 * p + 1];
      }
    }
  }
  grid.sync();

  // 2. the passing points before this block, and in all
  int before = 0, total = 0;
  for (int b = tid; b < (int)gridDim.x; b += kThreads) {
    const int c = a.block_pass[b];
    total += c;
    if (b < (int)blockIdx.x) before += c;
  }
  for (int off = 16; off > 0; off >>= 1) {
    before += __shfl_xor_sync(0xffffffffu, before, off);
    total += __shfl_xor_sync(0xffffffffu, total, off);
  }
  if (lane == 0) {
    red[0][warp] = before;
    red[1][warp] = total;
  }
  __syncthreads();
  before = 0;
  total = 0;
  for (int w = 0; w < kWarps; ++w) {
    before += red[0][w];
    total += red[1][w];
  }

  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < T; ++k) {
    const int p = base + k * kThreads + tid;
    if (p >= a.P) continue;
    const int pass_before = before + warp_base[k][warp] + __popc(bal[k] & lt);
    int row = p;
    if (a.compact)
      row = pt[k].ok ? pass_before : total + (p - pass_before);
    if (row >= a.rows) {
      a.slot[p] = -1;
      continue;
    }
    a.slot[p] = row;
    a.cand[row] = p;
    a.uv_r[row] = make_float2(pt[k].u, pt[k].v);
    a.r_r[row] = pt[k].r;
    a.lvl_r[row] = pt[k].lvl;
    a.ok_r[row] = pt[k].ok;
    if (kPrefetch) {
      a.desc_r[2 * row] = d0[k];
      a.desc_r[2 * row + 1] = d1[k];
    } else {
      a.desc_r[2 * row] = a.desc[2 * p];
      a.desc_r[2 * row + 1] = a.desc[2 * p + 1];
    }
  }
}

// the feature mode: a thread a feature, row = feature
__global__ void __launch_bounds__(kFeatureThreads)
    project_features_kernel(const __grid_constant__ B6Args a) {
  const int i = blockIdx.x * kFeatureThreads + threadIdx.x;
  if (i >= a.P) return;
  int q = i;
  bool ok = true;
  if (a.feat_idx != nullptr) {
    const int m = a.feat_idx[i];
    ok = m >= 0;
    q = m < 0 ? 0 : (m > a.Q - 1 ? a.Q - 1 : m);
  }
  if (a.valid != nullptr) ok = ok && a.valid[q] != 0;
  if (a.feat_valid != nullptr) ok = ok && a.feat_valid[i] != 0;
  const float x[3] = {a.pos[3 * q], a.pos[3 * q + 1], a.pos[3 * q + 2]};
  float xc[3], u, v;
  transform_project(a, x, xc, &u, &v);
  a.uv_r[i] = make_float2(u, v);
  a.ok_r[i] = ok && xc[2] > 0.05f;
  a.r_r[i] = __fmul_rn(a.radius, a.sf[a.feat_level[i]]);
}

template <int T>
int resident_blocks() {
  // blocks of 256 threads one launch can keep resident, per device
  static int cache[kMaxDevices] = {0};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, project_search_kernel<T>, kThreads, 0);
  if (e != cudaSuccess) return -(int)e;
  if (dev < kMaxDevices) cache[dev] = per_sm * sms;
  return per_sm * sms;
}

template <int T>
int launch(B6Args a, int blocks, void* stream) {
  void* args[] = {&a};
  // refused (never dropped to another path) when the grid cannot be
  // resident at once: cudaErrorCooperativeLaunchTooLarge
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)project_search_kernel<T>, dim3(blocks), dim3(kThreads),
      args, 0, (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The grid of a launch for P points: `*T` points a thread (1, 2, 4 or 8,
// the fewest that fit), the blocks returned; 0 when P is past what one
// resident grid takes, a negative CUDA error if the query fails.
int plan(int P, int* T) {
  if (P <= 0) return 0;
  for (*T = 1; *T <= kMaxT; *T *= 2) {
    const int cap = *T == 1   ? resident_blocks<1>()
                    : *T == 2 ? resident_blocks<2>()
                    : *T == 4 ? resident_blocks<4>()
                              : resident_blocks<8>();
    if (cap < 0) return cap;
    const int blocks = (P + kThreads * *T - 1) / (kThreads * *T);
    if (blocks <= cap) return blocks;
  }
  return 0;
}

}  // namespace

// Blocks of a `project_search` launch for P points (the wrapper sizes the
// `block_pass` scratch with it); 0 when P is past what one resident grid
// takes (8 points a thread), a negative CUDA error if the query fails.
extern "C" int project_search_blocks(int P) {
  int T = 0;
  return plan(P, &T);
}

// Kernel B6 in the points mode: a->P points, a->rows = min(cap, P) rows
// written (compact: cap < P, else rows = P, row p = point p); a launch the
// card refuses returns its CUDA error, nothing falls back.
extern "C" int project_search(const B6Args* a, void* stream) {
  if (a->P <= 0 || a->L < 2 || a->rows <= 0 || a->rows > a->P ||
      (!a->compact && a->rows != a->P))
    return (int)cudaErrorInvalidValue;
  int T = 0;
  const int blocks = plan(a->P, &T);
  if (blocks < 0) return -blocks;
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  if (T == 1) return launch<1>(*a, blocks, stream);
  if (T == 2) return launch<2>(*a, blocks, stream);
  if (T == 4) return launch<4>(*a, blocks, stream);
  return launch<8>(*a, blocks, stream);
}

// Kernel B6 in the feature mode: a->P features, each row its feature's
// (uv, radius, ok).
extern "C" int project_features(const B6Args* a, void* stream) {
  if (a->P <= 0 || (a->feat_idx != nullptr && a->Q <= 0))
    return (int)cudaErrorInvalidValue;
  const int blocks = (a->P + kFeatureThreads - 1) / kFeatureThreads;
  project_features_kernel<<<blocks, kFeatureThreads, 0,
                            (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
