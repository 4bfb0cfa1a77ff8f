// The CG of a keyframe-sharded global-BA LM iteration, kernel K6 split at
// its reductions (K6s: `ba_cg_ut`, `ba_cg_ap`, `ba_cg_update`).
//
// Replaces: the CG branch of `_ba_solve_f32` in the JAX package under
// `shard_map` (orb_slam2_refactored_tpu/optim/ba.py:318-360, 393-412 with
// `axis_name` set): `U_T`'s `psum_scatter` (:318-326), the `all_gather` of
// `G w1` in `S_mv` (:339) and of the rhs's `G g_l` (:402), and the two CG
// scalars' `psum`s (:352, :357, :408). K6 (`ba_schur.cu`) runs the whole CG
// in one cooperative launch with its cross-block sums at grid barriers; a
// collective over the process group cannot run inside a launch, so here
// each of K6's phases that ends in a cross-rank sum is a launch of its
// own, and the wrapper (`optim/ba.py::sharded_cg_solve`) issues the
// collective after it on the same stream:
//   ut      a warp a point over K5's live rows (`LiveRows`, point order):
//           this rank's part of U^T p [Q,3] (K6 phase 1 without G); beta
//           and the new direction p = z + beta p_prev fold into it (p is
//           formed a slot from z and p_prev, and written once for the
//           other launches). Then `all_reduce` of U^T p: JAX's
//           `psum_scatter` and `all_gather` of G w1 move the same bytes,
//           and G is applied a slot in `ap` (as K6 applies it to g_l), so
//           no per-point work is left to divide over the ranks.
//   ap      a block a keyframe over its live slots through `place`: G w1 a
//           slot, A p = Hpp_d p - U G w1 on the free keyframes (K6 phase
//           2) and p . A p, the keyframes' parts added in keyframe order by
//           the last block (an int ticket, no float atomic). Then
//           `all_reduce` of the scalar.
//   update  one block: alpha, x and r, z = Minv r and r . z (K6 phase 3
//           up to beta). Then `all_reduce` of the scalar.
// The setup (r = -(g_p - U G g_l), z, r . z) is `ap` in its rhs mode and
// `update` in its setup mode; the final U^T x is `ut` in its plain mode.
// Three launches and three collectives (`all_reduce`) a CG iteration.
// Where the points shard, the per-point work of an LM iteration (Hll|g_l's
// reduction, G, the back-substitution) stays on the rank's rows as in
// JAX: G and g_l are gathered once before the CG and U^T dp is
// reduce-scattered after it.
//
// Every sum has a fixed order (lanes in an xor tree, then warps or
// keyframes in order) and no float atomic is used, so two calls give the
// same bits. The vector updates round as the plain version's torch ops do
// (`__fmul_rn`, `__fadd_rn`): p, x and r equal the plain version's given
// the same scalars.
//
// What bounds it on the H100: each launch reads its inputs once (the live
// rows, 72 bytes each, dominate: ~0.9 MB for 12,000 live slots, ~0.3 us at
// 3.35 TB/s) and does ~36 FMAs a live slot; a CG iteration is three
// launches of a few microseconds each plus the collectives, so launch
// latency and the host's issue of 3 launches and 3 collectives an
// iteration bound it, not bytes or operations. A simple design first: no
// state kept across launches beyond device memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kUtThreads = 256;
constexpr int kApThreads = 256;
constexpr int kApWarps = kApThreads / 32;
constexpr int kUpThreads = 1024;
constexpr int kUpWarps = kUpThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float guarded(float d) {
  return fabsf(d) < 1e-12f ? 1e-12f : d;
}

// row i of K5's live rows: W [6,3] row-major, 8-byte aligned (72 bytes)
__device__ __forceinline__ void load_row(const float* __restrict__ W,
                                         int i, float* w) {
  const float2* W2 = reinterpret_cast<const float2*>(W + (size_t)i * 18);
#pragma unroll
  for (int j = 0; j < 9; ++j) {
    const float2 t = W2[j];
    w[2 * j] = t.x;
    w[2 * j + 1] = t.y;
  }
}

// mode 0: out[q] = sum over q's live rows i of W[i]^T v[k(i)] (every row).
// mode 1 (CG iteration `it`): p = v (it 0) or v + beta p_prev, beta =
// rz[it] / rz[it - 1] (guarded), written to p_out; out[q] = the same sum
// of p over the rows of free keyframes.
__global__ void __launch_bounds__(kUtThreads) ut_kernel(
    const float* __restrict__ W, const int* __restrict__ offsets,
    const int* __restrict__ slots, const unsigned char* __restrict__ free,
    const float* __restrict__ v, const float* __restrict__ p_prev,
    const float* __restrict__ rz, float* __restrict__ p_out, int it,
    int mode, int K, int N, int Q, float* __restrict__ out) {
  const bool iter = mode == 1;
  const bool mix = iter && it > 0;
  const float beta = mix ? rz[it] / guarded(rz[it - 1]) : 0.f;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  if (iter)
    for (int e = tid; e < K * 6; e += nthreads)
      p_out[e] = mix ? __fadd_rn(v[e], __fmul_rn(beta, p_prev[e])) : v[e];
  const int lane = threadIdx.x & 31;
  for (int q = tid >> 5; q < Q; q += nthreads >> 5) {
    float a0 = 0.f, a1 = 0.f, a2 = 0.f;
    const int end = offsets[q + 1];
    for (int i = offsets[q] + lane; i < end; i += 32) {
      const int k = slots[i] / N;
      if (iter && !free[k]) continue;
      float vk[6];
#pragma unroll
      for (int j = 0; j < 6; ++j) {
        const float z = v[k * 6 + j];
        vk[j] = mix ? __fadd_rn(z, __fmul_rn(beta, p_prev[k * 6 + j])) : z;
      }
      float w[18];
      load_row(W, i, w);
      a0 += w[0] * vk[0] + w[3] * vk[1] + w[6] * vk[2] + w[9] * vk[3] +
            w[12] * vk[4] + w[15] * vk[5];
      a1 += w[1] * vk[0] + w[4] * vk[1] + w[7] * vk[2] + w[10] * vk[3] +
            w[13] * vk[4] + w[16] * vk[5];
      a2 += w[2] * vk[0] + w[5] * vk[1] + w[8] * vk[2] + w[11] * vk[3] +
            w[14] * vk[4] + w[17] * vk[5];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a0 += __shfl_xor_sync(kFull, a0, off);
      a1 += __shfl_xor_sync(kFull, a1, off);
      a2 += __shfl_xor_sync(kFull, a2, off);
    }
    if (lane == 0) {
      out[q * 3 + 0] = a0;
      out[q * 3 + 1] = a1;
      out[q * 3 + 2] = a2;
    }
  }
}

// A block a keyframe k: u = sum over k's live slots of W[place] G[q] vec[q]
// (a thread a slot, the warps' sums in order). mode 0 (rhs): out[k] =
// -(g_p[k] - u) on a free keyframe, else 0. mode 1: out[k] = Hpp_d[k] p[k]
// - u on a free keyframe, else 0, and p[k] . out[k] into part[k]; the last
// block to take the ticket adds part[0..K) in order into pap[it] and
// resets the ticket.
__global__ void __launch_bounds__(kApThreads) ap_kernel(
    const float* __restrict__ Hpp_d, const float* __restrict__ g_p,
    const float* __restrict__ G, const float* __restrict__ vec,
    const float* __restrict__ W, const int* __restrict__ obs_pt,
    const int* __restrict__ place, const unsigned char* __restrict__ free,
    const float* __restrict__ p, float* __restrict__ out, int K, int N,
    int Q, int mode, int it, float* part, int* ticket,
    float* __restrict__ pap) {
  __shared__ float s_part[kApWarps * 6];
  const int k = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n = threadIdx.x; n < N; n += kApThreads) {
    const int s = k * N + n;
    const int i = place[s];
    if (i < 0) continue;
    const int q = min(max(obs_pt[s], 0), Q - 1);
    const float* g = G + (size_t)q * 9;
    const float l0 = vec[q * 3], l1 = vec[q * 3 + 1], l2 = vec[q * 3 + 2];
    const float y0 = g[0] * l0 + g[1] * l1 + g[2] * l2;
    const float y1 = g[3] * l0 + g[4] * l1 + g[5] * l2;
    const float y2 = g[6] * l0 + g[7] * l1 + g[8] * l2;
    float w[18];
    load_row(W, i, w);
#pragma unroll
    for (int r = 0; r < 6; ++r)
      acc[r] += w[r * 3] * y0 + w[r * 3 + 1] * y1 + w[r * 3 + 2] * y2;
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float t = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
    if (lane == 0) s_part[warp * 6 + r] = t;
  }
  __syncthreads();
  if (threadIdx.x != 0) return;
  const bool f = free[k] != 0;
  float dot = 0.f;
  for (int r = 0; r < 6; ++r) {
    float u = 0.f;
    for (int w = 0; w < kApWarps; ++w) u += s_part[w * 6 + r];
    float a;
    if (mode == 0) {
      a = f ? -(g_p[k * 6 + r] - u) : 0.f;
    } else {
      const float* A = Hpp_d + k * 36 + r * 6;
      const float* pk = p + k * 6;
      const float hv = A[0] * pk[0] + A[1] * pk[1] + A[2] * pk[2] +
                       A[3] * pk[3] + A[4] * pk[4] + A[5] * pk[5];
      a = f ? hv - u : 0.f;
      dot += p[k * 6 + r] * a;
    }
    out[k * 6 + r] = a;
  }
  if (mode == 0) return;
  part[k] = dot;
  __threadfence();
  if (atomicAdd(ticket, 1) != K - 1) return;
  __threadfence();
  float s = 0.f;
  for (int j = 0; j < K; ++j) s += __ldcg(part + j);
  pap[it] = s;
  *ticket = 0;
}

// One block. mode 0 (setup): x = 0. mode 1: alpha = rz[it] / pap[it]
// (guarded), x += alpha p, r -= alpha ap. Then z = Minv r (0 on a fixed
// keyframe) and r . z into rz[0] (mode 0) or rz[it + 1].
__global__ void __launch_bounds__(kUpThreads) update_kernel(
    const float* __restrict__ Minv, const unsigned char* __restrict__ free,
    float* r, float* __restrict__ x, float* __restrict__ z, float* rz,
    const float* __restrict__ p, const float* __restrict__ ap,
    const float* __restrict__ pap, int K, int mode, int it) {
  __shared__ float s_part[kUpWarps];
  const int K6 = K * 6;
  if (mode == 0) {
    for (int e = threadIdx.x; e < K6; e += kUpThreads) x[e] = 0.f;
  } else {
    const float alpha = rz[it] / guarded(pap[it]);
    for (int e = threadIdx.x; e < K6; e += kUpThreads) {
      x[e] = __fadd_rn(x[e], __fmul_rn(alpha, p[e]));
      r[e] = __fsub_rn(r[e], __fmul_rn(alpha, ap[e]));
    }
  }
  __syncthreads();  // every entry of r before a keyframe's Minv r
  float t = 0.f;
  for (int e = threadIdx.x; e < K6; e += kUpThreads) {
    const int k = e / 6;
    const float* M = Minv + (size_t)e * 6;  // row e % 6 of Minv[k]
    const float* rk = r + k * 6;
    float zz = M[0] * rk[0] + M[1] * rk[1] + M[2] * rk[2] + M[3] * rk[3] +
               M[4] * rk[4] + M[5] * rk[5];
    if (!free[k]) zz = 0.f;
    z[e] = zz;
    t += r[e] * zz;
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) t += __shfl_xor_sync(kFull, t, off);
  if (lane == 0) s_part[warp] = t;
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int w = 0; w < kUpWarps; ++w) s += s_part[w];
    rz[mode == 0 ? 0 : it + 1] = s;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess)
    return 0;
  return sms;
}

}  // namespace

// This rank's part of U^T v [Q,3] into `out` (mode 0), or of U^T p with p
// formed from v = z, p_prev and rz and written to p_out (mode 1, CG
// iteration `it`). One launch: warps over points, 8 a block, at most 8
// blocks an SM.
extern "C" int ba_cg_ut(const void* W_live, const void* offsets,
                        const void* slots, const void* free, const void* v,
                        const void* p_prev, const void* rz, void* p_out,
                        int it, int mode, int K, int N, int Q, void* out,
                        void* stream) {
  if (K <= 0 || N <= 0 || Q <= 0 || it < 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  if (mode == 1 && (!p_prev || !rz || !p_out))
    return (int)cudaErrorInvalidValue;
  const int sms = sm_count();
  if (sms <= 0) return (int)cudaErrorInvalidDevice;
  const int warps_a_block = kUtThreads / 32;
  int blocks = (Q + warps_a_block - 1) / warps_a_block;
  if (blocks > 8 * sms) blocks = 8 * sms;
  ut_kernel<<<blocks, kUtThreads, 0, (cudaStream_t)stream>>>(
      (const float*)W_live, (const int*)offsets, (const int*)slots,
      (const unsigned char*)free, (const float*)v, (const float*)p_prev,
      (const float*)rz, (float*)p_out, it, mode, K, N, Q, (float*)out);
  return (int)cudaGetLastError();
}

// A p and this rank's p . A p into pap[it] (mode 1), or the rhs (mode 0),
// on this rank's K keyframes: one launch, a block a keyframe. `part`
// holds K floats; `ticket` one int, zero before the call and after it.
extern "C" int ba_cg_ap(const void* Hpp_d, const void* g_p, const void* G,
                        const void* vec, const void* W_live,
                        const void* obs_pt, const void* place,
                        const void* free, const void* p, void* out, int K,
                        int N, int Q, int mode, int it, void* part,
                        void* ticket, void* pap, void* stream) {
  if (K <= 0 || N <= 0 || Q <= 0 || it < 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  if (mode == 1 && (!p || !pap)) return (int)cudaErrorInvalidValue;
  ap_kernel<<<K, kApThreads, 0, (cudaStream_t)stream>>>(
      (const float*)Hpp_d, (const float*)g_p, (const float*)G,
      (const float*)vec, (const float*)W_live, (const int*)obs_pt,
      (const int*)place, (const unsigned char*)free, (const float*)p,
      (float*)out, K, N, Q, mode, it, (float*)part, (int*)ticket,
      (float*)pap);
  return (int)cudaGetLastError();
}

// The CG's vector step on K keyframes, one launch of one block: the setup
// (mode 0) or iteration `it` (mode 1); see `update_kernel`.
extern "C" int ba_cg_update(const void* Minv, const void* free, void* r,
                            void* x, void* z, void* rz, const void* p,
                            const void* ap, const void* pap, int K, int mode,
                            int it, void* stream) {
  if (K <= 0 || it < 0 || (mode != 0 && mode != 1))
    return (int)cudaErrorInvalidValue;
  if (mode == 1 && (!p || !ap || !pap)) return (int)cudaErrorInvalidValue;
  update_kernel<<<1, kUpThreads, 0, (cudaStream_t)stream>>>(
      (const float*)Minv, (const unsigned char*)free, (float*)r, (float*)x,
      (float*)z, (float*)rz, (const float*)p, (const float*)ap,
      (const float*)pap, K, mode, it);
  return (int)cudaGetLastError();
}
