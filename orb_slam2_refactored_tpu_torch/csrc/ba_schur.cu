// Reduced-camera product of matrix-free CG bundle adjustment (kernel K6).
//
// Replaces: `S_mv` of `_ba_solve_f32`'s CG branch in the JAX package
// (orb_slam2_refactored_tpu/optim/ba.py:319-345): with the landmarks
// eliminated, S v = Hpp_d v - U G U^T v on the free keyframes, where U^T v
// is a scatter over the points of each observation's W_obs^T v_k
// (`U_T`), G = Hll_d^-1 a 3x3 product a point, and U y a gather of
// W_obs y_p summed over each keyframe's features (`U`). XLA runs these as
// about a dozen ops a product (einsums, a [P,3] scatter, a gather), so a
// global BA's 10 LM x 40 CG products make ~5,000 launches before the
// vector updates.
//
// Two launches a product, with no float atomic, so two calls on the same
// arguments give the same bits:
//   1. point-major (`points_kernel`), a warp a point q: the point's live
//      slots from K5's point index (CSR, slot ids ascending), lane l adding
//      W_obs[s]^T v[k(s)] (free keyframes only) of slots l, l + 32, ...,
//      the lanes summed in a fixed xor tree; the sum multiplied by G[q]
//      and written to w2[q] (a thread a point took 29 us of H100 device
//      time on the bench circuit's 3,072 points: 12 CTAs on 132 SMs, each
//      thread walking its slots one gather at a time);
//   2. camera-major (`cams_kernel`), a block a keyframe k: its live slots
//      W_obs[k, n] w2[pt(k, n)] summed, a slot a thread in strided order,
//      then over the warp in a fixed xor tree and over the warps in order;
//      out[k] = Hpp_d[k] v[k] - that sum on a free keyframe, 0 on a fixed
//      one.
// The rhs (U G g_l) and the back-substitution (U^T dp) of each LM
// iteration take one launch each: `cams_kernel` without Hpp_d returns
// U y, and `points_kernel` without G or the free mask returns U^T v.
//
// What bounds it on the H100: each product reads W_obs twice (72 bytes a
// live slot), the index, G and the small vectors: on the bench circuit's
// first global BA (128 keyframe slots x 1000 features, 12,191 live slots
// on 3,072 points) ~2.7 MB, so ~0.8 us at 3.35 TB/s; the operations (36
// f32 FMAs a live slot, 18 each way) are ~0.02 us. The gathers of W_obs
// rows by point are not coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// w[q] = G[q] * sum over q's slots s of W_obs[s]^T v[k(s)], the free
// keyframes' only; with no G the plain sum, with no `free` every
// keyframe's. A warp a point: lane l adds the point's slots l, l + 32, ...
// (ascending), then the lanes add up in a fixed xor tree.
__global__ void __launch_bounds__(kThreads)
points_kernel(const float* __restrict__ v, const unsigned char* __restrict__ free,
              const float* __restrict__ G, const float* __restrict__ W_obs,
              const int* __restrict__ offsets, const int* __restrict__ slots,
              int N, int Q, float* __restrict__ w) {
  const int lane = threadIdx.x & 31;
  const int q = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (q >= Q) return;  // the whole warp leaves together
  float a0 = 0.f, a1 = 0.f, a2 = 0.f;
  const int end = offsets[q + 1];
  for (int i = offsets[q] + lane; i < end; i += 32) {
    const int s = slots[i];
    const int k = s / N;
    if (free != nullptr && !free[k]) continue;
    const float* W = W_obs + (size_t)s * 18;  // [6,3] row-major
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
  if (G != nullptr) {
    const float* g = G + (size_t)q * 9;
    w[q * 3 + 0] = g[0] * a0 + g[1] * a1 + g[2] * a2;
    w[q * 3 + 1] = g[3] * a0 + g[4] * a1 + g[5] * a2;
    w[q * 3 + 2] = g[6] * a0 + g[7] * a1 + g[8] * a2;
  } else {
    w[q * 3 + 0] = a0;
    w[q * 3 + 1] = a1;
    w[q * 3 + 2] = a2;
  }
}

// out[k] = free[k] ? Hpp_d[k] v[k] - sum_n W_obs[k,n] y[pt(k,n)] : 0; with
// no Hpp_d, out[k] = sum_n W_obs[k,n] y[pt(k,n)] (U y) on every keyframe.
__global__ void __launch_bounds__(kThreads)
cams_kernel(const float* __restrict__ Hpp_d, const float* __restrict__ v,
            const unsigned char* __restrict__ free,
            const float* __restrict__ W_obs, const int* __restrict__ obs_pt,
            const unsigned char* __restrict__ obs_ok,
            const float* __restrict__ y, int N, int Q,
            float* __restrict__ out) {
  __shared__ float s_part[kWarps * 6];
  const int k = blockIdx.x, lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  for (int n = threadIdx.x; n < N; n += kThreads) {
    const int s = k * N + n;
    if (!obs_ok[s]) continue;
    const int q = min(max(obs_pt[s], 0), Q - 1);
    const float y0 = y[q * 3], y1 = y[q * 3 + 1], y2 = y[q * 3 + 2];
    const float* W = W_obs + (size_t)s * 18;
#pragma unroll
    for (int r = 0; r < 6; ++r)
      acc[r] += W[r * 3] * y0 + W[r * 3 + 1] * y1 + W[r * 3 + 2] * y2;
  }
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    float x = acc[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(kFull, x, off);
    if (lane == 0) s_part[warp * 6 + r] = x;
  }
  __syncthreads();
  if (threadIdx.x >= 6) return;
  const int r = threadIdx.x;
  float u = 0.f;
  for (int wp = 0; wp < kWarps; ++wp) u += s_part[wp * 6 + r];
  if (Hpp_d == nullptr) {
    out[k * 6 + r] = u;
    return;
  }
  if (!free[k]) {
    out[k * 6 + r] = 0.f;
    return;
  }
  const float* A = Hpp_d + k * 36 + r * 6;
  const float* vk = v + k * 6;
  const float hv = A[0] * vk[0] + A[1] * vk[1] + A[2] * vk[2] + A[3] * vk[3] +
                   A[4] * vk[4] + A[5] * vk[5];
  out[k * 6 + r] = hv - u;
}

}  // namespace

// S v in two launches; `w2` is [Q, 3] scratch.
extern "C" int ba_schur_mv(const void* v, const void* free, const void* Hpp_d,
                           const void* G, const void* W_obs,
                           const void* obs_pt, const void* obs_ok,
                           const void* offsets, const void* slots, int K,
                           int N, int Q, void* w2, void* out, void* stream) {
  if (K <= 0 || N <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  points_kernel<<<(Q + kWarps - 1) / kWarps, kThreads, 0, st>>>(
      (const float*)v, (const unsigned char*)free, (const float*)G,
      (const float*)W_obs, (const int*)offsets, (const int*)slots, N, Q,
      (float*)w2);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  cams_kernel<<<K, kThreads, 0, st>>>(
      (const float*)Hpp_d, (const float*)v, (const unsigned char*)free,
      (const float*)W_obs, (const int*)obs_pt, (const unsigned char*)obs_ok,
      (const float*)w2, N, Q, (float*)out);
  return (int)cudaGetLastError();
}

// U^T v [Q, 3] (no G, no mask), one launch.
extern "C" int ba_schur_ut(const void* v, const void* W_obs,
                           const void* offsets, const void* slots, int N,
                           int Q, void* out, void* stream) {
  if (N <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  points_kernel<<<(Q + kWarps - 1) / kWarps, kThreads, 0,
                  (cudaStream_t)stream>>>(
      (const float*)v, nullptr, nullptr, (const float*)W_obs,
      (const int*)offsets, (const int*)slots, N, Q, (float*)out);
  return (int)cudaGetLastError();
}

// U y [K, 6], one launch.
extern "C" int ba_schur_u(const void* y, const void* W_obs,
                          const void* obs_pt, const void* obs_ok, int K,
                          int N, int Q, void* out, void* stream) {
  if (K <= 0 || N <= 0 || Q <= 0) return (int)cudaErrorInvalidValue;
  cams_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
      nullptr, nullptr, nullptr, (const float*)W_obs, (const int*)obs_pt,
      (const unsigned char*)obs_ok, (const float*)y, N, Q, (float*)out);
  return (int)cudaGetLastError();
}
