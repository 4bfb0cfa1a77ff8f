// Matrix-free CG solve of one global-BA LM iteration (kernel K6).
//
// Replaces: the CG branch of `_ba_solve_f32` in the JAX package
// (orb_slam2_refactored_tpu/optim/ba.py:319-360, 400-412): the rhs
// -(g_p - U G g_l) on the free keyframes, `cg_iters` iterations of
// `cg_body` (the reduced-camera product S p = Hpp_d p - U G U^T p, the two
// dot products, the guarded divisions, the x and r updates, the
// block-Jacobi step z = Minv r and the new direction), and the
// back-substitution's U^T dp. XLA fuses that `lax.scan` into one program;
// issued op by op it took two launches of the product and ~22 torch ops a
// CG iteration, ~9,000 of the 11,712 device operations of the bench
// circuit's first global BA (10 LM x 40 CG), and its host time.
//
// One cooperative launch an LM iteration (`cudaLaunchCooperativeKernel`;
// blocks of 1024 threads, as many as fit on the card at once: one an SM
// on the H100), its phases separated by grid-wide barriers
// (`this_grid().sync()`). Every block keeps the whole CG state (x, r, z
// and the direction p, [K,6] each) in its shared memory and updates it
// itself, in the same order, so every block holds the same bits and the
// vector updates need no barrier of their own:
//   setup: a block a keyframe k gathers u[k] = U G g_l over its live slots
//     (G g_l computed a slot); barrier; every block forms r = -(g_p - u)
//     on the free keyframes, z = Minv r, r.z and p = z;
//   then a CG iteration, two barriers:
//   1. points: a warp a point q reads q's live rows of W_live, which K5
//     wrote contiguously in point order, and writes w2[q] = G[q] sum W^T
//     p[k] over q's slots on free keyframes; barrier;
//   2. cameras: a block a keyframe k, a thread a slot, gathers its live
//     slots' rows through `place` and w2 of their points, and writes
//     Ap[k] = Hpp_d p[k] - sum W w2 (0 on a fixed keyframe); barrier;
//   3. vectors, in every block: p.Ap, alpha, x and r, z = Minv r, r.z,
//     beta and the new p, each sum over the [K,6] entries in one fixed
//     order.
//   Last, U^T x [Q,3] by the point warps, over every live slot.
// Every sum has a fixed order (lanes in an xor tree, warps in order) and
// no float atomic is used, so two calls on the same arguments give the
// same bits, whatever the grid size.
//
// What bounds it on the H100. Bytes: each input read once and each output
// written once is ~1.7 MB on the bench circuit's first global BA (12,191
// live rows of 72 bytes, `place` for all 128,000 slots, the index, G and
// g_l of the observed points, Hpp_d, Minv), ~0.5 us at 3.35 TB/s; the 40
// iterations read W_live again from the 50 MB L2. Operations: 36 f32 FMAs
// a live slot and iteration, ~0.6 us. What it waits on is its 2 x
// cg_iters + 1 grid barriers (`ba_schur_cg_barriers` runs the same launch
// with empty phases) and each phase's dependent L2 round trips: the
// design keeps a point to a warp and a slot to a thread, so a phase is
// ~2 round trips deep, keeps the host out of the loop and the vectors in
// shared memory. A first version (256-thread blocks, six an SM, three
// barriers an iteration, the vectors in global memory and owned by one
// block a keyframe, a thread walking four slots in turn) took 0.80 ms an
// LM iteration, 0.24 ms of it in barriers of ~2 us. Staging W_live in
// shared memory across the iterations is left for later.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// keyframes a launch takes: the state [5, K, 6] and the free flags in each
// block's shared memory
constexpr int kMaxK = 1024;

struct CgArgs {
  const float* __restrict__ Hpp_d;  // [K,6,6], damped
  const float* __restrict__ Minv;   // [K,6,6], (Hpp_d + 1e-9 I)^-1
  const float* __restrict__ g_p;    // [K,6]
  const float* __restrict__ g_l;    // [Q,3]
  const float* __restrict__ G;      // [Q,3,3]
  const float* __restrict__ W;      // [>= offsets[Q], 18]: K5's live rows
  const int* __restrict__ obs_pt;   // [K*N]
  const int* __restrict__ offsets;  // [Q+1]
  const int* __restrict__ slots;    // [K*N]
  const int* __restrict__ place;    // [K*N]: row of a live slot, else -1
  const unsigned char* __restrict__ free;  // [K]
  int K, N, Q, iters;
  // written in the launch and read by other blocks: never through the
  // read-only path
  float* w2;  // [Q,3]
  float* u;   // [K,6]: U G g_l, then Ap
  float* x;   // [K,6], out
  float* ut;  // [Q,3], out
};

// a block's shared state
struct State {
  float *x, *r, *z, *p;  // [K*6] each
  float* ap;             // [K*6]: this iteration's A p, read once from L2
  unsigned char* free;   // [K]
  float* part;           // [kWarps * 6]
  float* scalar;         // [2]
};

__device__ __forceinline__ float guarded(float d) {
  return fabsf(d) < 1e-12f ? 1e-12f : d;
}

// Sum over the block of each thread's `t`, in one fixed order (the lanes
// in an xor tree, then the warps in order); every thread gets it. Two
// sums in a row use the two `slot`s, so that the second need not wait
// for every thread to have read the first.
__device__ float block_sum(float t, const State& st, int slot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float* part = st.part + slot * kWarps;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
  if (lane == 0) part[warp] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kWarps; ++w) s += part[w];
    st.scalar[slot] = s;
  }
  __syncthreads();
  return st.scalar[slot];
}

// z = Minv r on the free keyframes (0 on the fixed ones) and r.z, over
// the block's entries e = t, t + 1024, ... of [K*6]
__device__ float precondition(const CgArgs& a, const State& st) {
  float rz = 0.f;
  for (int e = threadIdx.x; e < a.K * 6; e += kThreads) {
    const int k = e / 6;
    const float* M = a.Minv + (size_t)e * 6;  // row e % 6 of Minv[k]
    const float* r = st.r + k * 6;
    float z = M[0] * r[0] + M[1] * r[1] + M[2] * r[2] + M[3] * r[3] +
              M[4] * r[4] + M[5] * r[5];
    if (!st.free[k]) z = 0.f;
    st.z[e] = z;
    rz += st.r[e] * z;
  }
  return rz;
}

// A warp a point q: sum over q's live rows i of W[i]^T v[k(i)] (the free
// keyframes' only with `product`), lanes over rows l, l + 32, ..., then
// an xor tree; lane 0 writes G[q] times it to w2[q] (`product`) or it to
// ut[q].
__device__ void point_rows(const CgArgs& a, const State& st, int q,
                           const float* v, bool product) {
  const int lane = threadIdx.x & 31;
  float g[9];
  if (product && lane == 0) {
#pragma unroll
    for (int j = 0; j < 9; ++j) g[j] = a.G[(size_t)q * 9 + j];
  }
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  const int end = a.offsets[q + 1];
  for (int i = a.offsets[q] + lane; i < end; i += 32) {
    // [6,3] row-major, 8-byte aligned (72 bytes a row)
    const float2* W2 = reinterpret_cast<const float2*>(a.W + (size_t)i * 18);
    float W[18];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const float2 w = W2[j];
      W[2 * j] = w.x;
      W[2 * j + 1] = w.y;
    }
    const int k = a.slots[i] / a.N;
    if (product && !st.free[k]) continue;
    const float* vk = v + k * 6;
    a0 += W[0] * vk[0] + W[3] * vk[1] + W[6] * vk[2] + W[9] * vk[3] +
          W[12] * vk[4] + W[15] * vk[5];
    a1 += W[1] * vk[0] + W[4] * vk[1] + W[7] * vk[2] + W[10] * vk[3] +
          W[13] * vk[4] + W[16] * vk[5];
    a2 += W[2] * vk[0] + W[5] * vk[1] + W[8] * vk[2] + W[11] * vk[3] +
          W[14] * vk[4] + W[17] * vk[5];
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    a0 += __shfl_xor_sync(kFull, a0, off);
    a1 += __shfl_xor_sync(kFull, a1, off);
    a2 += __shfl_xor_sync(kFull, a2, off);
  }
  if (lane != 0) return;
  if (product) {
    a.w2[q * 3 + 0] = g[0] * a0 + g[1] * a1 + g[2] * a2;
    a.w2[q * 3 + 1] = g[3] * a0 + g[4] * a1 + g[5] * a2;
    a.w2[q * 3 + 2] = g[6] * a0 + g[7] * a1 + g[8] * a2;
  } else {
    a.ut[q * 3 + 0] = a0;
    a.ut[q * 3 + 1] = a1;
    a.ut[q * 3 + 2] = a2;
  }
}

// A block a keyframe k: u = sum over k's live slots of W[place] y[pt],
// y = w2 (`rhs` false) or G g_l computed a slot (`rhs`); a slot a thread
// (n = t, t + 1024, ...), the warp in an xor tree, the warps in order.
// Returns u[r] in threads r < 6.
__device__ float camera_rows(const CgArgs& a, const State& st, int k,
                             bool rhs) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n = threadIdx.x; n < a.N; n += kThreads) {
    const int s = k * a.N + n;
    const int i = a.place[s];
    const int q = min(max(a.obs_pt[s], 0), a.Q - 1);
    if (i < 0) continue;
    float y0, y1, y2;
    if (rhs) {
      const float* g = a.G + (size_t)q * 9;
      const float l0 = a.g_l[q * 3], l1 = a.g_l[q * 3 + 1],
                  l2 = a.g_l[q * 3 + 2];
      y0 = g[0] * l0 + g[1] * l1 + g[2] * l2;
      y1 = g[3] * l0 + g[4] * l1 + g[5] * l2;
      y2 = g[6] * l0 + g[7] * l1 + g[8] * l2;
    } else {
      y0 = __ldcg(a.w2 + q * 3);
      y1 = __ldcg(a.w2 + q * 3 + 1);
      y2 = __ldcg(a.w2 + q * 3 + 2);
    }
    const float2* W2 = reinterpret_cast<const float2*>(a.W + (size_t)i * 18);
    float W[18];
#pragma unroll
    for (int j = 0; j < 9; ++j) {
      const float2 w = W2[j];
      W[2 * j] = w.x;
      W[2 * j + 1] = w.y;
    }
#pragma unroll
    for (int r = 0; r < 6; ++r)
      acc[r] += W[r * 3] * y0 + W[r * 3 + 1] * y1 + W[r * 3 + 2] * y2;
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float t = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
    if (lane == 0) st.part[warp * 6 + r] = t;
  }
  __syncthreads();
  float u = 0.f;
  if (threadIdx.x < 6)
    for (int w = 0; w < kWarps; ++w) u += st.part[w * 6 + threadIdx.x];
  __syncthreads();  // `part` is reused by the next keyframe
  return u;
}

template <bool kBody>
__global__ void __launch_bounds__(kThreads) cg_kernel(CgArgs a) {
  extern __shared__ float s_state[];  // x, r, z, p, ap [K*6] each, free [K]
  __shared__ float s_part[kWarps * 6];
  __shared__ float s_scalar[2];
  cg::grid_group grid = cg::this_grid();
  const int K6 = a.K * 6;
  const State st{s_state, s_state + K6, s_state + 2 * K6, s_state + 3 * K6,
                 s_state + 4 * K6,
                 reinterpret_cast<unsigned char*>(s_state + 5 * K6), s_part,
                 s_scalar};
  const int gwarp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int nwarps = gridDim.x * kWarps;

  // setup: u = U G g_l a keyframe, then in every block r, z, r.z, p = z
  float rz = 0.f;
  if (kBody) {
    for (int k = threadIdx.x; k < a.K; k += kThreads) st.free[k] = a.free[k];
    for (int k = blockIdx.x; k < a.K; k += gridDim.x) {
      const float u = camera_rows(a, st, k, true);
      if (threadIdx.x < 6) a.u[k * 6 + threadIdx.x] = u;
    }
  }
  grid.sync();
  if (kBody) {
    for (int e = threadIdx.x; e < K6; e += kThreads) {
      st.r[e] = st.free[e / 6] ? -(a.g_p[e] - __ldcg(a.u + e)) : 0.f;
      st.x[e] = 0.f;
    }
    __syncthreads();
    rz = block_sum(precondition(a, st), st, 0);
    for (int e = threadIdx.x; e < K6; e += kThreads) st.p[e] = st.z[e];
    __syncthreads();
  }

  for (int it = 0; it < a.iters; ++it) {
    // 1. w2 = G U^T p
    for (int q = gwarp; kBody && q < a.Q; q += nwarps)
      point_rows(a, st, q, st.p, true);
    grid.sync();
    // 2. Ap = Hpp_d p - U w2 on the free keyframes (into u)
    for (int k = blockIdx.x; kBody && k < a.K; k += gridDim.x) {
      // row r of Hpp_d[k] p[k], loaded before the gather
      float hv = 0.f;
      if (threadIdx.x < 6) {
        const float* A = a.Hpp_d + k * 36 + threadIdx.x * 6;
        const float* pk = st.p + k * 6;
        hv = A[0] * pk[0] + A[1] * pk[1] + A[2] * pk[2] + A[3] * pk[3] +
             A[4] * pk[4] + A[5] * pk[5];
      }
      const float u = camera_rows(a, st, k, false);
      if (threadIdx.x < 6)
        a.u[k * 6 + threadIdx.x] = st.free[k] ? hv - u : 0.f;
    }
    grid.sync();
    // 3. the vector updates, in every block
    if (kBody) {
      float pap = 0.f;
      for (int e = threadIdx.x; e < K6; e += kThreads) {
        st.ap[e] = __ldcg(a.u + e);
        pap += st.p[e] * st.ap[e];
      }
      const float alpha = rz / guarded(block_sum(pap, st, 1));
      for (int e = threadIdx.x; e < K6; e += kThreads) {
        st.x[e] = st.x[e] + alpha * st.p[e];
        st.r[e] = st.r[e] - alpha * st.ap[e];
      }
      __syncthreads();
      const float rz_new = block_sum(precondition(a, st), st, 0);
      const float beta = rz_new / guarded(rz);
      for (int e = threadIdx.x; e < K6; e += kThreads)
        st.p[e] = st.z[e] + beta * st.p[e];
      rz = rz_new;
      __syncthreads();
    }
  }

  // U^T x over every live slot; x is the same in every block
  if (kBody) {
    if (blockIdx.x == 0)
      for (int e = threadIdx.x; e < K6; e += kThreads) a.x[e] = st.x[e];
    for (int q = gwarp; q < a.Q; q += nwarps)
      point_rows(a, st, q, st.x, false);
  }
}

// blocks of one launch: as many as fit on the card at once
int grid_blocks(int K, size_t* smem) {
  *smem = (size_t)K * (5 * 6 * sizeof(float) + 1);
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // above 48 KB of dynamic shared memory only after opting in
  if (e == cudaSuccess && *smem > 48 * 1024)
    e = cudaFuncSetAttribute(cg_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
  if (e == cudaSuccess && *smem > 48 * 1024)
    e = cudaFuncSetAttribute(cg_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)*smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, cg_kernel<true>, kThreads, *smem);
  if (e != cudaSuccess) return -(int)e;
  return per_sm * sms;
}

template <bool kBody>
int launch(CgArgs a, void* stream) {
  size_t smem = 0;
  const int blocks = grid_blocks(a.K, &smem);
  if (blocks < 0) return -blocks;
  if (blocks == 0) return (int)cudaErrorInvalidValue;
  void* args[] = {&a};
  // refused (never dropped to another path) when the grid cannot be
  // resident at once: cudaErrorCooperativeLaunchTooLarge
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)cg_kernel<kBody>, dim3(blocks), dim3(kThreads), args, smem,
      (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ba_schur_cg_max_k() { return kMaxK; }

// Blocks of a `ba_schur_cg` launch on the current device for K keyframes
// (a negative CUDA error code if the query fails).
extern "C" int ba_schur_cg_blocks(int K) {
  size_t smem = 0;
  return grid_blocks(K, &smem);
}

// One LM iteration's CG solve: x [K,6] (dp) and ut [Q,3] (U^T dp), in one
// cooperative launch. `scratch` holds 3 Q + 6 K floats: w2, and U G g_l
// then Ap. K <= ba_schur_cg_max_k() (the state lives in shared memory).
extern "C" int ba_schur_cg(const void* Hpp_d, const void* Minv,
                           const void* g_p, const void* g_l, const void* G,
                           const void* W_live, const void* obs_pt,
                           const void* offsets, const void* slots,
                           const void* place, const void* free, int K, int N,
                           int Q, int iters, void* scratch, void* x, void* ut,
                           void* stream) {
  if (K <= 0 || N <= 0 || Q <= 0 || iters < 0 || K > kMaxK)
    return (int)cudaErrorInvalidValue;
  float* s = (float*)scratch;
  CgArgs a{(const float*)Hpp_d, (const float*)Minv, (const float*)g_p,
           (const float*)g_l, (const float*)G, (const float*)W_live,
           (const int*)obs_pt, (const int*)offsets, (const int*)slots,
           (const int*)place, (const unsigned char*)free, K, N, Q, iters,
           s, s + 3 * Q, (float*)x, (float*)ut};
  return launch<true>(a, stream);
}

// The same launch (grid, barriers, loop) with every phase empty: the
// barrier floor of `ba_schur_cg` for `iters` CG iterations.
extern "C" int ba_schur_cg_barriers(int K, int iters, void* stream) {
  if (K <= 0 || iters < 0 || K > kMaxK) return (int)cudaErrorInvalidValue;
  CgArgs a{};
  a.K = K;
  a.iters = iters;
  return launch<false>(a, stream);
}
