// Stereo sub-pixel refinement at each keypoint's own pyramid level
// (kernel B9): the 11x11 SAD at 11 disparities, the argmin, the parabola
// and its gates, for every keypoint of a stereo frame in one launch.
//
// Replaces: `refine_subpixel_pyramid` of the JAX package
// (orb_slam2_refactored_tpu/ops/stereo.py:120-221), the part between the
// integer level coordinates and the rescale to level 0 (:171-203). XLA
// flattens both pyramids into a zero-padded [sum H, W0] plane, gathers 11
// rows of it a keypoint ([N, 11, W0] for each image), slices the patch and
// the strip, stacks the 11 windows ([N, 11, 11, 11]) and reduces them.
//
// What bounds it on the H100: neither bytes nor arithmetic. At VGA a
// stereo frame's 1000 keypoints read ~1.4 MB of f32 pixels (an 11x11 patch
// and an 11x21 strip each, 0.4 us at 3.35 TB/s) and need ~5.3 M f32
// operations (11 windows x 121 pixels x 4: two centrings, a difference and
// an add of its absolute value; ~0.02 us at the card's f32 rate). The
// kernel is bounded by launch latency and by the chain of each keypoint:
// its loads, then 121 dependent adds a lane.
//
// Design (simple and right first):
//   - the levels are read in place through a by-value table of each
//     level's left and right image and its shape (the same table as K2 and
//     K3), no flattened or padded copy: the wrapper's clipped coordinates
//     keep every read inside the keypoint's own level, and the kernel
//     clamps them again so a caller's bad coordinate cannot read outside;
//   - one warp a keypoint, 8 warps a block, so 1000 keypoints are 125
//     blocks, one wave on 132 SMs; each warp stages its patch and strip
//     (352 f32, 1.4 KB) in shared memory, lane k loading elements k,
//     k + 32, ...;
//   - lane r < 11 sums window r over the 121 offsets in row-major order
//     from 0, one f32 add at a time, so the plain version
//     (`refine_subpixel_sad_plain`), which adds in that order, is
//     bit-equal to it; nothing multiplies into an add except 2 * s_0,
//     which is exact, so FMA contraction changes no bit;
//   - lane 0 takes the argmin by a strict compare from index 0 up (the
//     lowest index on ties, as `jnp.argmin`: level-0 pixels are integers,
//     so SADs tie often), fits the parabola and writes the three outputs.
// The integer coordinates come from the wrapper (torch's half-to-even
// `round`), so no rounding mode of this file enters them.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kW = 5;                 // half patch
constexpr int kR = 5;                 // half disparity range
constexpr int kP = 2 * kW + 1;        // patch side, 11
constexpr int kS = kP + 2 * kR;       // strip width, 21
constexpr int kD = 2 * kR + 1;        // disparities, 11
constexpr int kWarps = 8;

struct SLevel {
  const float* left;
  const float* right;
  int h;
  int w;
};

struct SLevels {
  SLevel lv[kMaxLevels];
  int n;
};

__global__ void __launch_bounds__(kWarps * 32)
stereo_sad_kernel(const __grid_constant__ SLevels L,
                  const int* __restrict__ lvl, const int* __restrict__ ys,
                  const int* __restrict__ xs, const int* __restrict__ urs,
                  int N,
                  float* __restrict__ out_ur, float* __restrict__ out_sad,
                  bool* __restrict__ out_ok) {
  __shared__ float patch[kWarps][kP * kP];
  __shared__ float strip[kWarps][kP * kS];
  __shared__ float sads[kWarps][kD];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= N) return;  // whole warps only: no block barrier below
  const int l = min(max(lvl[i], 0), L.n - 1);
  const int h = L.lv[l].h, w = L.lv[l].w;
  const int y = min(max(ys[i], kW), h - kW - 1);
  const int x = min(max(xs[i], kW), w - kW - 1);
  const int u = min(max(urs[i], kW + kR), w - kW - kR - 1);
  const float* pl = L.lv[l].left + (size_t)(y - kW) * w + (x - kW);
  const float* pr = L.lv[l].right + (size_t)(y - kW) * w + (u - kW - kR);
  float* P = patch[warp];
  float* S = strip[warp];
  for (int k = lane; k < kP * kP; k += 32) {
    const int r = k / kP;
    P[k] = pl[(size_t)r * w + (k - r * kP)];
  }
  for (int k = lane; k < kP * kS; k += 32) {
    const int r = k / kS;
    S[k] = pr[(size_t)r * w + (k - r * kS)];
  }
  __syncwarp();
  if (lane < kD) {
    const float cl = P[kW * kP + kW];
    const float cr = S[kW * kS + lane + kW];
    float s = 0.f;
    for (int dy = 0; dy < kP; ++dy) {
#pragma unroll
      for (int dx = 0; dx < kP; ++dx)
        s += fabsf((P[dy * kP + dx] - cl) - (S[dy * kS + lane + dx] - cr));
    }
    sads[warp][lane] = s;
  }
  __syncwarp();
  if (lane == 0) {
    const float* sd = sads[warp];
    int best = 0;
    float cur = sd[0];
    for (int r = 1; r < kD; ++r) {
      if (sd[r] < cur) {
        cur = sd[r];
        best = r;
      }
    }
    const int bi = min(max(best, 1), kD - 2);
    const float sm = sd[bi - 1], s0 = sd[bi], sp = sd[bi + 1];
    const float denom = sm + sp - 2.f * s0;
    // 2 marks a flat valley: rejected, as |delta| > 1 is
    const float delta = fabsf(denom) > 1e-6f ? 0.5f * (sm - sp) / denom : 2.f;
    out_ur[i] = ((float)u + (float)(bi - kR)) + fminf(fmaxf(delta, -1.f), 1.f);
    out_sad[i] = s0;
    out_ok[i] = fabsf(delta) <= 1.f && best != 0 && best != kD - 1;
  }
}

}  // namespace

// imgs_l[n], imgs_r[n]: f32 level images, the same shapes; dims: (h, w) of
// each level; lvl, ys, xs, urs: int32[N], the keypoint's level and its
// patch centre and strip centre there; out_ur f32[N] (the refined right
// u at the keypoint's level), out_sad f32[N] (the SAD at the clipped
// argmin), out_ok bool[N] (|delta| <= 1 and an interior argmin).
extern "C" int stereo_sad(int n, const void* const* imgs_l,
                          const void* const* imgs_r, const int* dims,
                          const void* lvl, const void* ys, const void* xs,
                          const void* urs, int N, void* out_ur, void* out_sad,
                          void* out_ok, void* stream) {
  if (n < 1 || n > kMaxLevels || N < 0) return (int)cudaErrorInvalidValue;
  SLevels L;
  L.n = n;
  for (int l = 0; l < n; ++l) {
    const int h = dims[2 * l], w = dims[2 * l + 1];
    if (h < kP || w < kS) return (int)cudaErrorInvalidValue;
    L.lv[l].left = (const float*)imgs_l[l];
    L.lv[l].right = (const float*)imgs_r[l];
    L.lv[l].h = h;
    L.lv[l].w = w;
  }
  if (N == 0) return (int)cudaGetLastError();
  stereo_sad_kernel<<<(N + kWarps - 1) / kWarps, kWarps * 32, 0,
                      (cudaStream_t)stream>>>(
      L, (const int*)lvl, (const int*)ys, (const int*)xs, (const int*)urs, N,
      (float*)out_ur, (float*)out_sad, (bool*)out_ok);
  return (int)cudaGetLastError();
}
