// IC angle, Gaussian blur and steered BRIEF with the learned test table, for
// every pyramid level's keypoints in one launch (kernel K7).
//
// Replaces: the full-image branch of the JAX package's extractor, which it
// takes for a test table that does not fit the 31x31 window
// (orb_slam2_refactored_tpu/ops/orb.py:524-534): `image_ops.gaussian_blur`
// of the level (ops/image.py:64-78: `jnp.pad(mode="reflect")`, a 7-tap
// sigma=2 horizontal then vertical pass), `ic_angles` (ops/orb.py:236-242:
// the moments of the 31x31 circular patch of the RAW level, then atan2) and
// `brief_descriptors` (ops/orb.py:410-433: cos and sin of the exact angle,
// the 512 offsets rotated and rounded half to even, gathered from the
// BLURRED level, bit = A < B). XLA blurs every level whole and gathers
// 512 samples a keypoint from it; no TPU kernel.
//
// The learned table (OpenCV's bit_pattern_31_) reaches radius 18.4, so a
// rotated and rounded offset reaches 18 px: a keypoint needs its blurred
// level out to 18 px and the raw level out to 18 + 3. Keypoints sit at
// least EDGE_MARGIN = 19 px inside their level, so the raw window reaches
// 2 px past the border there; it is loaded with the border mirrored as
// `jnp.pad(mode="reflect")` mirrors it (-1 -> 1, -2 -> 2, h -> h - 2).
//
// What bounds it on the H100: at VGA the 1000 keypoints of a frame read
// ~3 MB of f32 pixels under the union of their 43x43 windows (~1 us at
// 3.35 TB/s) and need ~45 M f32 instructions (the ~21 k blur products and
// sums of each keypoint, the moments and the tests; ~1.3 us at the card's
// f32 rate). Like K3 it is bounded in practice by launch latency and by
// how much independent work hides the window loads.
//
// Design (simple first; making it fast is later work):
//   - one launch for all keypoints: a by-value table gives each level's
//     image, shape and first keypoint, as K3's does, and a block finds its
//     level from the offsets;
//   - one block of 256 threads a keypoint, one test a thread;
//   - the 43x43 raw window is loaded with mirrored indices into shared
//     memory; the moments of its central 31x31 circular patch are summed
//     in a fixed order (thread t takes pixels t, t + 256, ..., a shuffle
//     butterfly in each warp, the 8 warp totals in order), then atan2f;
//     the entry can take the angles instead (`angles_in`), so that its
//     descriptors can be held bit for bit against the plain version fed
//     the same angles;
//   - the two blur passes into a 43x37 and then a 37x37 window, every
//     sample's 7 products rounded one by one and added in tap order with
//     `__fmul_rn` / `__fadd_rn` (never contracted into an FMA), the order
//     of the plain version (`ops/image.py::gaussian_blur`), so the two
//     agree bit for bit;
//   - each thread rotates its two points with cosf / sinf of the angle as
//     x c - y s and x s + y c, each product and the sum rounded apart
//     (`__fmul_rn`, `__fsub_rn`, `__fadd_rn`), rounds half to even
//     (rintf), as torch and XLA op by op do; a contracted FMA would move
//     a coordinate that sits at a half-integer;
//   - each warp's 32 tests are packed with `__ballot_sync` into one
//     descriptor word: test i is bit i % 32 of word i / 32.
// ~19 KB of shared memory a block. Tensor cores are not used.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTaps = 7;
constexpr int kHalo = kTaps / 2;          // 3
constexpr int kReach = 18;                // rotated offsets of the table
constexpr int kBlur = 2 * kReach + 1;     // 37
constexpr int kRaw = kBlur + 2 * kHalo;   // 43
constexpr int kHalf = 15;                 // the IC patch's half width
constexpr int kWin = 2 * kHalf + 1;       // 31
constexpr int kPatchOff = kReach + kHalo - kHalf;  // 6

struct KLevel {
  const float* img;
  int h;
  int w;
  int k0;  // first keypoint of the level
};

struct KLevels {
  KLevel lv[kMaxLevels];
  int n;
};

// `jnp.pad(mode="reflect")`: the edge is not repeated
__device__ __forceinline__ int mirror(int i, int n) {
  if (i < 0) i = -i;
  if (i > n - 1) i = 2 * (n - 1) - i;
  return i;
}

__global__ void __launch_bounds__(kThreads)
orb_learned_kernel(const __grid_constant__ KLevels L,
                   const int* __restrict__ ys, const int* __restrict__ xs,
                   const float* __restrict__ gk, const float* __restrict__ xm,
                   const float* __restrict__ ym,
                   const int4* __restrict__ pattern,
                   const float* __restrict__ angles_in,
                   float* __restrict__ out_angle, int* __restrict__ out_desc) {
  __shared__ float raw[kRaw * kRaw];
  __shared__ float hp[kRaw * kBlur];
  __shared__ float blur[kBlur * kBlur];
  __shared__ float red[2][kWarps];

  const int k = blockIdx.x;
  int l = 0;
  while (l + 1 < L.n && k >= L.lv[l + 1].k0) ++l;
  const float* img = L.lv[l].img;
  const int h = L.lv[l].h, w = L.lv[l].w;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int y0 = ys[k] - (kReach + kHalo), x0 = xs[k] - (kReach + kHalo);
  for (int i = tid; i < kRaw * kRaw; i += kThreads) {
    const int r = i / kRaw, c = i - r * kRaw;
    raw[i] = img[(size_t)mirror(y0 + r, h) * w + mirror(x0 + c, w)];
  }
  float g[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) g[t] = gk[t];
  __syncthreads();

  // the moments of the raw level's circular patch (unless given)
  if (angles_in == nullptr) {
    float a = 0.f, b = 0.f;
    for (int i = tid; i < kWin * kWin; i += kThreads) {
      const int r = i / kWin, c = i - r * kWin;
      const float v = raw[(r + kPatchOff) * kRaw + c + kPatchOff];
      a = __fadd_rn(a, __fmul_rn(v, xm[i]));
      b = __fadd_rn(b, __fmul_rn(v, ym[i]));
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
      b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, off));
    }
    if (lane == 0) {
      red[0][warp] = a;
      red[1][warp] = b;
    }
  }
  // horizontal pass: 43 rows x 37 columns
  for (int i = tid; i < kRaw * kBlur; i += kThreads) {
    const int r = i / kBlur, c = i - r * kBlur;
    const float* src = &raw[r * kRaw + c];
    float s = __fmul_rn(g[0], src[0]);
#pragma unroll
    for (int t = 1; t < kTaps; ++t) s = __fadd_rn(s, __fmul_rn(g[t], src[t]));
    hp[i] = s;
  }
  __syncthreads();
  // vertical pass: 37 x 37
  for (int i = tid; i < kBlur * kBlur; i += kThreads) {
    const int r = i / kBlur, c = i - r * kBlur;
    const float* src = &hp[r * kBlur + c];
    float s = __fmul_rn(g[0], src[0]);
#pragma unroll
    for (int t = 1; t < kTaps; ++t)
      s = __fadd_rn(s, __fmul_rn(g[t], src[t * kBlur]));
    blur[i] = s;
  }
  float ang;
  if (angles_in == nullptr) {
    // every thread adds the warp totals itself, in order
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) {
      a = __fadd_rn(a, red[0][i]);
      b = __fadd_rn(b, red[1][i]);
    }
    ang = atan2f(b, a);
  } else {
    ang = angles_in[k];
  }
  if (tid == 0) out_angle[k] = ang;
  const float cs = cosf(ang), sn = sinf(ang);
  __syncthreads();

  const int4 p = pattern[tid];  // (ax, ay, bx, by)
  const float ax = (float)p.x, ay = (float)p.y, bx = (float)p.z,
              by = (float)p.w;
  const int rxa = (int)rintf(__fsub_rn(__fmul_rn(ax, cs), __fmul_rn(ay, sn)));
  const int rya = (int)rintf(__fadd_rn(__fmul_rn(ax, sn), __fmul_rn(ay, cs)));
  const int rxb = (int)rintf(__fsub_rn(__fmul_rn(bx, cs), __fmul_rn(by, sn)));
  const int ryb = (int)rintf(__fadd_rn(__fmul_rn(bx, sn), __fmul_rn(by, cs)));
  const float va = blur[(rya + kReach) * kBlur + rxa + kReach];
  const float vb = blur[(ryb + kReach) * kBlur + rxb + kReach];
  const unsigned word = __ballot_sync(0xffffffffu, va < vb);
  if (lane == 0) out_desc[k * 8 + warp] = (int)word;
}

}  // namespace

// imgs[n]: f32 level images; dims: (h, w) of each level, then each level's
// keypoint count; ys, xs: int32[K] grouped by level, each at least 19 px
// inside its level; gk: f32[7] blur taps; xm, ym: f32[31 * 31] moment
// weights; pattern: int32[256, 4] (ax, ay, bx, by), every point within
// radius 18.5; angles_in: f32[K] or null (then the angles are computed);
// out_angle f32[K], out_desc int32[K, 8].
extern "C" int orb_learned_levels(int n, const void* const* imgs,
                                  const int* dims, const void* ys,
                                  const void* xs, int K, const void* gk,
                                  const void* xm, const void* ym,
                                  const void* pattern, const void* angles_in,
                                  void* out_angle, void* out_desc,
                                  void* stream) {
  if (n < 1 || n > kMaxLevels) return (int)cudaErrorInvalidValue;
  KLevels L;
  L.n = n;
  int k0 = 0;
  for (int l = 0; l < n; ++l) {
    const int h = dims[2 * l], w = dims[2 * l + 1], cnt = dims[2 * n + l];
    if (cnt < 0 || (cnt > 0 && (h < 2 * 19 + 1 || w < 2 * 19 + 1)))
      return (int)cudaErrorInvalidValue;
    L.lv[l].img = (const float*)imgs[l];
    L.lv[l].h = h;
    L.lv[l].w = w;
    L.lv[l].k0 = k0;
    k0 += cnt;
  }
  if (k0 != K) return (int)cudaErrorInvalidValue;
  if (K <= 0) return (int)cudaGetLastError();
  orb_learned_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
      L, (const int*)ys, (const int*)xs, (const float*)gk, (const float*)xm,
      (const float*)ym, (const int4*)pattern, (const float*)angles_in,
      (float*)out_angle, (int*)out_desc);
  return (int)cudaGetLastError();
}
