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
// f32 rate). No product may be contracted into an FMA, so the blur's
// instructions are fixed. In practice the kernel is bound by the
// multiprocessors' instruction issue and by each block's chain of
// dependent phases (load, moments and horizontal pass, vertical pass,
// tests), and its loads by the L2: the windows overlap, so a frame reads
// ~7.4 MB of window rows.
//
// The first design (one block of 256 threads a keypoint, every element of
// the window loaded with a divide, a modulo and two mirrors, both blur
// passes reading their 7 taps from shared memory, every thread taking the
// angle and its sine and cosine) took 0.0118 ms a frame on an NVIDIA H100
// 80GB HBM3 at 700 W, 12.8x its bound. This design (`extract_probe.py`
// splits its time and holds it against the first design in turns):
//   - one launch for all keypoints: a launch table built once a geometry
//     (`ops/orb.py::_learned_plan`) gives each level's image (the frame,
//     or an offset into the pyramid kernel's one buffer), shape and first
//     keypoint; the host turns it into a by-value table, and a block finds
//     its level from the offsets;
//   - one block of 128 threads a keypoint, 13.8 KB of shared memory: a VGA
//     frame's 1000 keypoints are one wave, ~8 blocks a multiprocessor. 256
//     threads measured slower, and so did fewer blocks each walking
//     several keypoints with the next window's copies in flight (a ring of
//     two windows), at every grid from 528 blocks down to 132;
//   - the 43x43 raw window is loaded by rows, warp w taking rows w,
//     w + kWarps, ..., lane i columns i and 32 + i, with 4-byte `cp.async`
//     copies (a level's rows start at any column, so no wider copy is
//     aligned); no divide, no modulo; the mirror is decided once a
//     keypoint: a window inside its level loads plain rows, one that
//     reaches past a border mirrors its column indices once and each row
//     index once. The taps, the thread's tests (int8) and its moment
//     weights are read while the window arrives;
//   - the blur from registers: a thread takes a run of up to 8 outputs of
//     one row (43 rows x 5 runs), reads the run's raw pixels from shared
//     memory once into registers and sums each output there; then a run
//     of up to 7 outputs down one column (37 columns x 6 runs) the same
//     way. Every sample is g0 x0, then + g_t x_t in tap order, each
//     product and sum rounded apart (`__fmul_rn` / `__fadd_rn`), the
//     horizontal pass first: the order of the plain version
//     (`ops/image.py::gaussian_blur`), so the two agree bit for bit. The
//     blurred window overwrites the raw one;
//   - the moments of the raw window's central 31x31 circular patch in the
//     first design's order: 256 strided partial sums (pixel t, t + 256,
//     ... of the patch), a shuffle butterfly in each group of 32, the 8
//     group totals added in order, then atan2f; a thread keeps the partial
//     sums of the 256 / kThreads groups' threads it stands for, so the
//     angles are bit-equal to the first design's. The last warp, which has
//     the fewest vertical runs, takes the angle, its cosine and sine for
//     the block. The entry can take the angles instead (`angles_in`), so
//     that its descriptors can be held bit for bit against the plain
//     version fed the same angles;
//   - each test rotates its two points with cosf / sinf of the angle as
//     x c - y s and x s + y c, each product and the sum rounded apart
//     (`__fmul_rn`, `__fsub_rn`, `__fadd_rn`), rounds half to even
//     (rintf), as torch and XLA op by op do; a contracted FMA would move a
//     coordinate that sits at a half-integer;
//   - each warp's 32 tests are packed with `__ballot_sync` into one
//     descriptor word: test i is bit i % 32 of word i / 32.
// Tensor cores are not used: a TF32 product would break the bit-equality.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTests = 256;
constexpr int kPerThread = kTests / kThreads;  // tests (and the first
                                               // design's threads) a thread
constexpr int kTaps = 7;
constexpr int kHalo = kTaps / 2;          // 3
constexpr int kReach = 18;                // rotated offsets of the table
constexpr int kBlur = 2 * kReach + 1;     // 37
constexpr int kRaw = kBlur + 2 * kHalo;   // 43
constexpr int kHalf = 15;                 // the IC patch's half width
constexpr int kWin = 2 * kHalf + 1;       // 31
constexpr int kPatchOff = kReach + kHalo - kHalf;  // 6
// the horizontal pass in 43 rows x 5 runs of 8, 8, 7, 7, 7 columns; the
// vertical pass in 37 columns x 6 runs of 7, 6, 6, 6, 6, 6 rows
constexpr int kRowRuns = 5;
constexpr int kColRuns = 6;
constexpr int kRowRun = (kBlur + kRowRuns - 1) / kRowRuns;  // 8
constexpr int kColRun = (kBlur + kColRuns - 1) / kColRuns;  // 7

static_assert(kTests % kThreads == 0 && kThreads % 32 == 0, "threads");

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

__device__ __forceinline__ void cp_async4(float* smem, const float* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::
                   : "memory");
}

// run `r` of `runs` over 37 outputs: its first output and its length, the
// first 37 % runs runs one longer
__device__ __forceinline__ void run_span(int r, int runs, int& start,
                                         int& n) {
  const int base = kBlur / runs, extra = kBlur % runs;
  start = r * base + min(r, extra);
  n = base + (r < extra);
}

// n <= kLen outputs of one 7-tap pass along a row or a column: the n + 6
// inputs read once into registers (`step_in` apart), each output g0 x0,
// then + g_t x_t in tap order, each product and sum rounded apart
template <int kLen>
__device__ __forceinline__ void blur_run(const float* src, int step_in,
                                         float* dst, int step_out, int n,
                                         const float* g) {
  float x[kLen + kTaps - 1];
#pragma unroll
  for (int j = 0; j < kLen + kTaps - 1; ++j)
    if (j < n + kTaps - 1) x[j] = src[j * step_in];
#pragma unroll
  for (int j = 0; j < kLen; ++j) {
    if (j < n) {
      float s = __fmul_rn(g[0], x[j]);
#pragma unroll
      for (int t = 1; t < kTaps; ++t)
        s = __fadd_rn(s, __fmul_rn(g[t], x[j + t]));
      dst[j * step_out] = s;
    }
  }
}

// one keypoint's window in a raw buffer: its level's image, shape and top
// left corner, and whether it lies inside the level
struct Window {
  const float* img;
  int h, w, y0, x0;
  bool inside;
};

__device__ __forceinline__ Window locate(const KLevels& L, int k, int y,
                                         int x) {
  int l = 0;
  while (l + 1 < L.n && k >= L.lv[l + 1].k0) ++l;
  Window v;
  v.img = L.lv[l].img;
  v.h = L.lv[l].h;
  v.w = L.lv[l].w;
  v.y0 = y - (kReach + kHalo);
  v.x0 = x - (kReach + kHalo);
  v.inside = v.y0 >= 0 && v.x0 >= 0 && v.y0 + kRaw <= v.h &&
             v.x0 + kRaw <= v.w;
  return v;
}

// the 43x43 window by rows into `raw` (4-byte `cp.async`, not waited on);
// mirrored indices only for a window past a border, decided once
__device__ __forceinline__ void load_window(const Window& v, float* raw,
                                            int lane, int warp) {
  int c0 = v.x0 + lane, c1 = v.x0 + 32 + lane;
  if (!v.inside) {
    c0 = mirror(c0, v.w);
    c1 = lane < kRaw - 32 ? mirror(c1, v.w) : c0;
  }
  for (int r = warp; r < kRaw; r += kWarps) {
    const float* row =
        v.img + (size_t)(v.inside ? v.y0 + r : mirror(v.y0 + r, v.h)) * v.w;
    cp_async4(&raw[r * kRaw + lane], row + c0);
    if (lane < kRaw - 32) cp_async4(&raw[r * kRaw + 32 + lane], row + c1);
  }
}

__global__ void __launch_bounds__(kThreads, 1024 / kThreads)
orb_learned_kernel(const __grid_constant__ KLevels L,
                   const int* __restrict__ ys, const int* __restrict__ xs,
                   const float* __restrict__ gk,
                   const float2* __restrict__ mom,
                   const char4* __restrict__ pattern,
                   const float* __restrict__ angles_in,
                   float* __restrict__ out_angle, int* __restrict__ out_desc) {
  __shared__ float raw[kRaw * kRaw];  // then the 37x37 blurred window
  __shared__ float hp[kRaw * kBlur];
  __shared__ float red[2][kTests / 32];
  __shared__ float trig[2];  // cos and sin of the keypoint's angle

  const int k = blockIdx.x;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  load_window(locate(L, k, ys[k], xs[k]), raw, lane, warp);
  // read while the window arrives: the taps, this thread's tests and the
  // moment weights of its partial sums (pixels t, t + 256, ...)
  float g[kTaps];
#pragma unroll
  for (int t = 0; t < kTaps; ++t) g[t] = gk[t];
  char4 p[kPerThread];  // (ax, ay, bx, by)
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) p[v] = pattern[tid + v * kThreads];
  constexpr int kSums = (kWin * kWin + kTests - 1) / kTests;  // 4
  float2 mw[kPerThread][kSums];
  if (angles_in == nullptr) {
#pragma unroll
    for (int v = 0; v < kPerThread; ++v)
#pragma unroll
      for (int j = 0; j < kSums; ++j) {
        const int i = tid + v * kThreads + j * kTests;
        mw[v][j] = i < kWin * kWin ? mom[i] : make_float2(0.f, 0.f);
      }
  }
  cp_async_wait_all();
  __syncthreads();

  // the moments of the raw level's circular patch (unless given), summed
  // as the first design's thread t = tid + v * kThreads summed them
  if (angles_in == nullptr) {
#pragma unroll
    for (int v = 0; v < kPerThread; ++v) {
      const int t = tid + v * kThreads;
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int j = 0; j < kSums; ++j) {
        const int i = t + j * kTests;
        if (i < kWin * kWin) {
          const int r = i / kWin, c = i - r * kWin;
          const float px = raw[(r + kPatchOff) * kRaw + c + kPatchOff];
          a = __fadd_rn(a, __fmul_rn(px, mw[v][j].x));
          b = __fadd_rn(b, __fmul_rn(px, mw[v][j].y));
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        a = __fadd_rn(a, __shfl_xor_sync(0xffffffffu, a, off));
        b = __fadd_rn(b, __shfl_xor_sync(0xffffffffu, b, off));
      }
      if (lane == 0) {
        red[0][t >> 5] = a;
        red[1][t >> 5] = b;
      }
    }
  }
  // horizontal pass: 43 rows x 37 columns, a run of one row a task (the
  // lanes of a warp on consecutive rows of one run)
  for (int task = tid; task < kRaw * kRowRuns; task += kThreads) {
    const int run = task / kRaw, r = task - run * kRaw;
    int c, n;
    run_span(run, kRowRuns, c, n);
    blur_run<kRowRun>(&raw[r * kRaw + c], 1, &hp[r * kBlur + c], 1, n, g);
  }
  __syncthreads();
  // vertical pass: 37 x 37, a run of one column a task, into `raw`
  float* blur = raw;
  for (int task = tid; task < kBlur * kColRuns; task += kThreads) {
    const int run = task / kBlur, c = task - run * kBlur;
    int r, n;
    run_span(run, kColRuns, r, n);
    blur_run<kColRun>(&hp[r * kBlur + c], kBlur, &blur[r * kBlur + c], kBlur,
                      n, g);
  }
  // the angle, its cosine and sine, by the last warp (the one with the
  // fewest vertical runs): the group totals added in order, then atan2f
  if (warp == kWarps - 1) {
    float ang;
    if (angles_in == nullptr) {
      float a = 0.f, b = 0.f;
#pragma unroll
      for (int i = 0; i < kTests / 32; ++i) {
        a = __fadd_rn(a, red[0][i]);
        b = __fadd_rn(b, red[1][i]);
      }
      ang = atan2f(b, a);
    } else {
      ang = angles_in[k];
    }
    const float cs = cosf(ang), sn = sinf(ang);
    if (lane == 0) {
      out_angle[k] = ang;
      trig[0] = cs;
      trig[1] = sn;
    }
  }
  __syncthreads();

  const float cs = trig[0], sn = trig[1];
#pragma unroll
  for (int v = 0; v < kPerThread; ++v) {
    const float ax = (float)p[v].x, ay = (float)p[v].y, bx = (float)p[v].z,
                by = (float)p[v].w;
    const int rxa =
        (int)rintf(__fsub_rn(__fmul_rn(ax, cs), __fmul_rn(ay, sn)));
    const int rya =
        (int)rintf(__fadd_rn(__fmul_rn(ax, sn), __fmul_rn(ay, cs)));
    const int rxb =
        (int)rintf(__fsub_rn(__fmul_rn(bx, cs), __fmul_rn(by, sn)));
    const int ryb =
        (int)rintf(__fadd_rn(__fmul_rn(bx, sn), __fmul_rn(by, cs)));
    const float va = blur[(rya + kReach) * kBlur + rxa + kReach];
    const float vb = blur[(ryb + kReach) * kBlur + rxb + kReach];
    const unsigned word = __ballot_sync(0xffffffffu, va < vb);
    if (lane == 0) out_desc[k * 8 + v * kWarps + warp] = (int)word;
  }
}

// The launch table of one geometry, built once on the host
// (`ops/orb.py::_learned_plan`, a ctypes.Structure of this layout): level
// l's image is `img0` + off[l] bytes where from_base[l] is 0, else `base`
// + off[l] bytes.
struct K7Table {
  int n;  // levels
  int K;  // keypoints: the sum of the levels' counts
  int h[kMaxLevels];
  int w[kMaxLevels];
  int k0[kMaxLevels];  // each level's first keypoint
  int from_base[kMaxLevels];
  long long off[kMaxLevels];
  const void* gk;       // f32[7] blur taps
  const void* mom;      // f32[31 * 31, 2] moment weights (x, y)
  const void* pattern;  // int8[256, 4] (ax, ay, bx, by)
};

}  // namespace

// img0, base: the two sources of the table's level images (the frame and
// the pyramid kernel's buffer; or null and 0 when every off[] is an
// address); ys, xs: int32[K] grouped by level, each at least 19 px inside
// its level; angles_in: f32[K] or null (then the angles are computed);
// out_angle f32[K], out_desc int32[K, 8]. The table's checks (levels,
// counts, sizes, the pattern's radius) are made when it is built.
extern "C" int orb_learned_levels(const void* img0, const void* base,
                                  const void* table, const void* ys,
                                  const void* xs, int K,
                                  const void* angles_in, void* out_angle,
                                  void* out_desc, void* stream) {
  const K7Table* t = (const K7Table*)table;
  if (t == nullptr || t->n < 1 || t->n > kMaxLevels || K != t->K)
    return (int)cudaErrorInvalidValue;
  KLevels L;
  L.n = t->n;
  for (int l = 0; l < t->n; ++l) {
    const uintptr_t src = (uintptr_t)(t->from_base[l] ? base : img0);
    L.lv[l].img = (const float*)(src + (uintptr_t)t->off[l]);
    L.lv[l].h = t->h[l];
    L.lv[l].w = t->w[l];
    L.lv[l].k0 = t->k0[l];
  }
  if (K <= 0) return (int)cudaGetLastError();
  orb_learned_kernel<<<K, kThreads, 0, (cudaStream_t)stream>>>(
      L, (const int*)ys, (const int*)xs, (const float*)t->gk,
      (const float2*)t->mom, (const char4*)t->pattern, (const float*)angles_in,
      (float*)out_angle, (int*)out_desc);
  return (int)cudaGetLastError();
}
