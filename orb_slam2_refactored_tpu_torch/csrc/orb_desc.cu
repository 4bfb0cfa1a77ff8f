// In-window blur, intensity-centroid angle and steered BRIEF of every
// pyramid level's keypoints in one launch (kernel K3).
//
// Replaces: `angles_and_descriptors_mxu_raw` of the JAX package
// (orb_slam2_refactored_tpu/ops/orb.py:364-386, with `_gather_patches_r`,
// `_blur31_matrix` and `_brief_from_windows`, :319-361), called once per
// level. XLA gathers a [K,37,37] window per keypoint, blurs it with two
// band-matrix products, takes the moments as a [K,961]x[961,2] product and
// runs the 256 tests as a bf16 [K,729]x[K,729,256] contraction against a
// gathered +-1 table.
//
// What bounds it on the H100: neither bytes nor arithmetic. At VGA the
// 1000 keypoints of a frame read ~2.7 MB of f32 pixels under the union of
// their 37x37 windows (0.8 us at 3.35 TB/s) and need ~17 M f32
// instructions (the ~15 k blur FMAs, the moments and the tests of each
// keypoint; 0.5 us at the card's f32 rate). The kernel is bounded by
// launch latency and by how much independent work is in flight to hide the
// window loads.
//
// The design before this one (one launch a level, a block of 256 threads a
// keypoint) took 0.201 and 0.286 ms a frame in two calls on an NVIDIA H100
// 80GB HBM3 at 700 W, ~250x its bound: 8 serial launches of 60-217 blocks
// each, a divide and a modulo per loaded element, and 255 threads idle
// while thread 0 summed the warps' moments and took the angle. This design:
//   - one launch for all keypoints: a by-value table gives each level's
//     image, shape and first keypoint (the per-level budgets are static),
//     and a block finds its level from the offsets. At VGA that is 1000
//     blocks, one wave on 132 SMs;
//   - one block of 128 threads (4 warps) a keypoint, ~10 KB of shared
//     memory, so up to 16 keypoints are in flight on an SM;
//   - the 37x37 raw window is loaded by rows, warp w taking rows w, w + 4,
//     ..., lane i columns i and 32 + i, with 4-byte `cp.async` copies (the
//     window's rows start at any column, so no wider copy is aligned), and
//     no divide or modulo;
//   - the separable 7-tap sigma=2 blur in f32 into shared memory, each
//     sample's taps summed in the same order and built with the same flags
//     (default -fmad) as the design before, so the samples are bit-equal
//     to it; the blurred window overwrites the raw one;
//   - the moments from the blurred window in shared memory, in the same
//     order as the design before (256 strided partial sums, a shuffle
//     butterfly in each group of 32, the 8 group totals in order), so the
//     angles are bit-equal to it too; every thread adds the 8 totals and
//     takes atan2 and the bin floor((theta+pi)*64/2pi) mod 64 itself, with
//     no serial section and no broadcast;
//   - thread i runs tests i and i + 128 of that bin: two window offsets
//     from a [64,256,2] table, each sample rounded to bf16 (RNE, as the JAX
//     contraction rounds its operands), bit = (A - B) < 0, strict; the 256
//     bits are 8 `__ballot_sync` words.
// Tensor cores are not used: the blur is ~15 k FMAs a keypoint, the kernel
// is bound by bytes and launch latency, and a TF32 product would move the
// samples across bf16 rounding ties.
// A test whose two points rotate onto one pixel reads the same sample
// twice and yields 0, as the all-zero column of the JAX table does. The
// blur and the moments sum in another order than XLA (and the plain
// version) do, so a last-bit difference can move a sample across a bf16
// rounding tie or an angle across a bin edge; the tests state the
// tolerance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRaw = 37;
constexpr int kWin = 31;
constexpr int kHalfRaw = 18;
constexpr int kBins = 64;
constexpr int kTests = 256;

struct KLevel {
  const float* img;
  int w;
  int k0;  // first keypoint of the level
};

struct KLevels {
  KLevel lv[kMaxLevels];
  int n;
};

__device__ __forceinline__ float bf16_round(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

__global__ void __launch_bounds__(kThreads)
orb_kernel(const __grid_constant__ KLevels L, const int* __restrict__ ys,
           const int* __restrict__ xs, const float* __restrict__ gk,
           const float* __restrict__ xm, const float* __restrict__ ym,
           const int2* __restrict__ pairs, float* __restrict__ out_angle,
           int* __restrict__ out_desc) {
  __shared__ float raw[kRaw * kRaw];  // then the 31x31 blurred window
  __shared__ float tmp[kRaw * kWin];
  __shared__ float red[2][2 * kWarps];

  const int k = blockIdx.x;
  int l = 0;
  while (l + 1 < L.n && k >= L.lv[l + 1].k0) ++l;
  const int w = L.lv[l].w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float* src =
      L.lv[l].img + (size_t)(ys[k] - kHalfRaw) * w + (xs[k] - kHalfRaw);
  for (int r = warp; r < kRaw; r += kWarps) {
    cp_async4(&raw[r * kRaw + lane], src + (size_t)r * w + lane);
    if (lane < kRaw - 32)
      cp_async4(&raw[r * kRaw + 32 + lane], src + (size_t)r * w + 32 + lane);
  }
  float g[7];
#pragma unroll
  for (int t = 0; t < 7; ++t) g[t] = gk[t];
  cp_async_wait_all();
  __syncthreads();
  if (lane < kWin) {
    for (int r = warp; r < kRaw; r += kWarps) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < 7; ++t) s += g[t] * raw[r * kRaw + lane + t];
      tmp[r * kWin + lane] = s;
    }
  }
  __syncthreads();
  float* win = raw;
  if (lane < kWin) {
    for (int r = warp; r < kWin; r += kWarps) {
      float s = 0.f;
#pragma unroll
      for (int t = 0; t < 7; ++t) s += g[t] * tmp[(r + t) * kWin + lane];
      win[r * kWin + lane] = s;
    }
  }
  __syncthreads();
  // The moments, summed in the order of the design before, so the angles
  // stay bit-equal to it: 256 partial sums over i = t, t + 256, ... (thread
  // tid keeps those of t = tid and t = tid + 128), a shuffle butterfly in
  // each group of 32, then the 8 group totals in order.
  float m10[2] = {0.f, 0.f}, m01[2] = {0.f, 0.f};
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    for (int i = tid + half * kThreads; i < kWin * kWin; i += 2 * kThreads) {
      const float s = win[i];
      m10[half] += s * xm[i];
      m01[half] += s * ym[i];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      m10[half] += __shfl_xor_sync(0xffffffffu, m10[half], off);
      m01[half] += __shfl_xor_sync(0xffffffffu, m01[half], off);
    }
    if (lane == 0) {
      red[0][half * kWarps + warp] = m10[half];
      red[1][half * kWarps + warp] = m01[half];
    }
  }
  __syncthreads();
  // every thread adds the group totals itself: no serial section, no
  // broadcast
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int i = 0; i < 2 * kWarps; ++i) {
    a += red[0][i];
    b += red[1][i];
  }
  const float ang = atan2f(b, a);
  const float pi = 3.14159265358979323846f;
  const float scale = (float)(kBins / (2.0 * 3.14159265358979323846));
  int bin = (int)floorf((ang + pi) * scale) % kBins;
  if (bin < 0) bin += kBins;
  if (tid == 0) out_angle[k] = ang;
  const int2* p = pairs + (size_t)bin * kTests;
#pragma unroll
  for (int half = 0; half < kTests / kThreads; ++half) {
    const int2 ab = p[tid + half * kThreads];
    const float va = bf16_round(win[ab.x]);
    const float vb = bf16_round(win[ab.y]);
    const unsigned word = __ballot_sync(0xffffffffu, (va - vb) < 0.f);
    if (lane == 0) out_desc[k * 8 + half * kWarps + warp] = (int)word;
  }
}

}  // namespace

// imgs[n]: f32 level images; dims: (h, w) of each level, then each level's
// keypoint count; ys, xs: int32[K] grouped by level, each at least 18 px
// inside its level; out_angle f32[K], out_desc int32[K, 8].
extern "C" int orb_angles_desc_levels(int n, const void* const* imgs,
                                      const int* dims, const void* ys,
                                      const void* xs, int K, const void* gk,
                                      const void* xm, const void* ym,
                                      const void* pairs, void* out_angle,
                                      void* out_desc, void* stream) {
  if (n < 1 || n > kMaxLevels) return (int)cudaErrorInvalidValue;
  KLevels L;
  L.n = n;
  int k0 = 0;
  for (int l = 0; l < n; ++l) {
    const int h = dims[2 * l], w = dims[2 * l + 1], cnt = dims[2 * n + l];
    if (cnt < 0 || (cnt > 0 && (h < kRaw || w < kRaw)))
      return (int)cudaErrorInvalidValue;
    L.lv[l].img = (const float*)imgs[l];
    L.lv[l].w = w;
    L.lv[l].k0 = k0;
    k0 += cnt;
  }
  if (k0 != K) return (int)cudaErrorInvalidValue;
  if (K <= 0) return (int)cudaGetLastError();
  orb_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
      L, (const int*)ys, (const int*)xs, (const float*)gk, (const float*)xm,
      (const float*)ym, (const int2*)pairs, (float*)out_angle,
      (int*)out_desc);
  return (int)cudaGetLastError();
}
