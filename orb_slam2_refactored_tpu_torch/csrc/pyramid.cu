// The image pyramid of one frame, levels 1 to n-1, in one launch (kernel K8).
//
// Replaces, in the JAX package (orb_slam2_refactored_tpu/):
//   - `build_pyramid` (ops/image.py:42-53), a chain of
//     `jax.image.resize(method="linear")` calls (ops/image.py:28-30), each
//     level resized from the previous one, which XLA runs as two products
//     a level with dense [in, out] weight matrices.
// The plain PyTorch version (`ops/image.py::build_pyramid_plain`) does the
// same with two dense f32 GEMMs a level, each of whose outputs has 2-3
// nonzero taps at the scale factor 1.2, and uploads the weight matrices
// on every call.
//
// What it computes. Level l is resized from level l-1: first the vertical
// pass (`wh.T @ img`), rounded to f32, then the horizontal pass (`@ ww`).
// Each output sums its taps in ascending input index as `fmaf` chains that
// start from a product: taps [0, split) as one chain, taps [split, count)
// as another, then the two added. That is how the card's f32 GEMM adds
// them (zero taps add nothing exactly): an FFMA K loop whose partial sums
// of 8-wide K blocks, or of split-K slices, are added at the end, as
// cuBLAS chooses for the shape; `ops/image.py::gemm_tap_splits` finds the
// split of each output once per shape by a probe of the GEMM, so the
// kernel equals the plain version on the card bit for bit (a single chain,
// split = count, measured 79-93 % of the upper levels' pixels bit-equal on
// the H100). The taps are `_resize_weights_np`'s own f32 weights, read
// from a table (per output: first input index, tap count, the bounds of a
// tile's input span, the split; then the taps) uploaded once per shape
// and device (`ops/image.py::resize_taps`).
//
// What bounds it on the H100. The function reads level 0 once and writes
// levels 1 to n-1 once: at VGA 1.23 MB in and 2.6 MB out, ~1.1 us at 3.35
// TB/s; it does ~2.5 FMAs a vertical and a horizontal output, a few
// million f32 operations, well under a microsecond. So bytes bound it,
// and in practice the dependency between levels: level l cannot start
// before level l-1 is written. Design:
//   - one cooperative launch (`cudaLaunchCooperativeKernel`), as many
//     blocks as fit at once up to the largest level's tile count, a grid
//     barrier (`this_grid().sync()`) between levels: n-2 barriers, no
//     float atomics, no host work between levels;
//   - a block a 16 x 64 output tile: it stages the tile's taps and its
//     input span (the rows and columns its taps reach) in shared memory,
//     computes the vertical sums of the span's columns into shared memory
//     (rounded to f32, as the GEMM's intermediate is), then the
//     horizontal sums, and writes the tile with coalesced stores;
//   - the previous level is read with `ld.global.cg` (L2, not the SM's
//     L1): it was written by other blocks in the same launch.
// One ordinary launch a level, with no barrier, measured 13-36 % slower in
// CUDA-event time on the H100 (PERF.md), so the one launch is kept.
// Levels start at 16-byte-aligned offsets of one buffer (the caller lays
// it out), where kernel K2 uses vector loads.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxTaps = 8;   // `PYR_MAX_TAPS` in ops/image.py
constexpr int TY = 16;        // a tile: 16 output rows x 64 columns
constexpr int TX = 64;        // (`PYR_TILE` in ops/image.py)
constexpr int kThreads = 256;

constexpr int kIdx = 5;  // first, count, span lo, span hi, split

struct Axis {
  const int* idx;     // [out, kIdx]
  const float* taps;  // [out, kMaxTaps]
};

struct Phase {        // level l from level l-1
  const float* src;
  float* dst;
  int iw, oh, ow;
  int tiles_x, tiles;
  Axis v, h;
};

struct PyrArgs {
  Phase ph[kMaxLevels];
  int n;              // levels: phases 1 to n-1
};

struct TileTaps {
  int vf[TY], vc[TY], vs[TY], hf[TX], hc[TX], hs[TX];
  float vw[TY][kMaxTaps], hw[TX][kMaxTaps];
};

// taps [0, split) of x[0], x[stride], ... as one fmaf chain from the first
// product, taps [split, count) as another, then their sum (count >= 1,
// 1 <= split <= count)
__device__ __forceinline__ float tap_sum(const float* x, int stride,
                                         const float* w, int count,
                                         int split) {
  float a = __fmul_rn(w[0], x[0]);
  for (int k = 1; k < split; ++k) a = __fmaf_rn(w[k], x[k * stride], a);
  if (split >= count) return a;
  float b = __fmul_rn(w[split], x[split * stride]);
  for (int k = split + 1; k < count; ++k)
    b = __fmaf_rn(w[k], x[k * stride], b);
  return __fadd_rn(a, b);
}

__device__ void resize_tile(const Phase& p, int t, float* smem,
                            TileTaps& s) {
  const int tid = threadIdx.x;
  const int oy0 = (t / p.tiles_x) * TY, ox0 = (t % p.tiles_x) * TX;
  const int my = min(TY, p.oh - oy0), mx = min(TX, p.ow - ox0);
  const int ry0 = __ldg(p.v.idx + kIdx * oy0 + 2);
  const int ry1 = __ldg(p.v.idx + kIdx * (oy0 + my - 1) + 3);
  const int rx0 = __ldg(p.h.idx + kIdx * ox0 + 2);
  const int rx1 = __ldg(p.h.idx + kIdx * (ox0 + mx - 1) + 3);
  const int ny = max(ry1 - ry0, 0), nx = max(rx1 - rx0, 0);
  float* s_in = smem;            // [ny][nx]: the input span
  float* s_tmp = smem + ny * nx;  // [my][nx]: the vertical sums
  if (tid < my) {
    const int* e = p.v.idx + kIdx * (oy0 + tid);
    s.vf[tid] = __ldg(e) - ry0;
    s.vc[tid] = __ldg(e + 1);
    s.vs[tid] = __ldg(e + 4);
  } else if (tid >= TY && tid < TY + mx) {
    const int q = tid - TY;
    const int* e = p.h.idx + kIdx * (ox0 + q);
    s.hf[q] = __ldg(e) - rx0;
    s.hc[q] = __ldg(e + 1);
    s.hs[q] = __ldg(e + 4);
  }
  for (int i = tid; i < my * kMaxTaps; i += kThreads)
    s.vw[i / kMaxTaps][i % kMaxTaps] = __ldg(p.v.taps + oy0 * kMaxTaps + i);
  for (int i = tid; i < mx * kMaxTaps; i += kThreads)
    s.hw[i / kMaxTaps][i % kMaxTaps] = __ldg(p.h.taps + ox0 * kMaxTaps + i);
  for (int i = tid; i < ny * nx; i += kThreads)
    s_in[i] = __ldcg(p.src + (size_t)(ry0 + i / nx) * p.iw + rx0 + i % nx);
  __syncthreads();
  // vertical: tmp[r][j] = sum over the taps of output row oy0 + r
  for (int i = tid; i < my * nx; i += kThreads) {
    const int r = i / nx, j = i % nx, c = s.vc[r];
    s_tmp[i] = c > 0 ? tap_sum(s_in + s.vf[r] * nx + j, nx, s.vw[r], c,
                               s.vs[r])
                     : 0.f;
  }
  __syncthreads();
  // horizontal: out[r][q] = sum over the taps of output column ox0 + q
  for (int i = tid; i < my * mx; i += kThreads) {
    const int r = i / mx, q = i % mx, c = s.hc[q];
    p.dst[(size_t)(oy0 + r) * p.ow + ox0 + q] =
        c > 0 ? tap_sum(s_tmp + r * nx + s.hf[q], 1, s.hw[q], c, s.hs[q])
              : 0.f;
  }
  __syncthreads();  // the shared memory is reused by the next tile
}

__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const __grid_constant__ PyrArgs a) {
  extern __shared__ float smem[];
  __shared__ TileTaps s;
  for (int l = 1; l < a.n; ++l) {
    // the barrier orders level l-1's stores before level l's loads
    if (l > 1) cg::this_grid().sync();
    const Phase& p = a.ph[l];
    for (int t = blockIdx.x; t < p.tiles; t += gridDim.x)
      resize_tile(p, t, smem, s);
  }
}

// blocks of a cooperative launch that fit on the card at once, cached by
// device and shared memory (a negative CUDA error code if a query fails)
int resident_blocks(int smem) {
  static int cached_dev = -1, cached_smem = -1, cached = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return -(int)e;
  if (dev == cached_dev && smem == cached_smem) return cached;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  // above 48 KB of dynamic shared memory only after opting in
  if (e == cudaSuccess && smem > 48 * 1024)
    e = cudaFuncSetAttribute(pyramid_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, pyramid_kernel,
                                                      kThreads, smem);
  if (e != cudaSuccess) return -(int)e;
  cached_dev = dev;
  cached_smem = smem;
  cached = per_sm * sms;
  return cached;
}

}  // namespace

// Levels 1 to n-1 of an f32 [h, w] image (`img`, level 0) into `buf`,
// level l at float offset offsets[l-1]. dims: (h, w) of the n levels;
// tables: per level l >= 1, the vertical (h[l-1] -> h[l]) index and taps,
// then the horizontal ones; spans: per level l >= 1 the largest input rows
// and columns a tile reaches; smem: bytes of the largest tile's span and
// vertical sums.
extern "C" int pyramid_levels(int n, const void* img, void* buf,
                              const int* dims, const int* offsets,
                              const void* const* tables, const int* spans,
                              int smem, void* stream) {
  if (n < 2 || n > kMaxLevels || smem <= 0)
    return (int)cudaErrorInvalidValue;
  PyrArgs a;
  a.n = n;
  int max_tiles = 0;
  for (int l = 1; l < n; ++l) {
    Phase& p = a.ph[l];
    const int ih = dims[2 * (l - 1)], iw = dims[2 * (l - 1) + 1];
    p.oh = dims[2 * l];
    p.ow = dims[2 * l + 1];
    if (ih < 1 || iw < 1 || p.oh < 1 || p.ow < 1)
      return (int)cudaErrorInvalidValue;
    const int sy = spans[2 * (l - 1)], sx = spans[2 * (l - 1) + 1];
    if ((size_t)4 * (sy + TY) * sx > (size_t)smem)
      return (int)cudaErrorInvalidValue;
    p.src = l == 1 ? (const float*)img : (const float*)buf + offsets[l - 2];
    p.dst = (float*)buf + offsets[l - 1];
    p.iw = iw;
    p.tiles_x = (p.ow + TX - 1) / TX;
    p.tiles = p.tiles_x * ((p.oh + TY - 1) / TY);
    const void* const* t = tables + 4 * (l - 1);
    p.v = Axis{(const int*)t[0], (const float*)t[1]};
    p.h = Axis{(const int*)t[2], (const float*)t[3]};
    if (p.tiles > max_tiles) max_tiles = p.tiles;
  }
  const int fit = resident_blocks(smem);
  if (fit < 0) return -fit;
  if (fit == 0) return (int)cudaErrorInvalidConfiguration;
  cudaStream_t st = (cudaStream_t)stream;
  const int blocks = max_tiles < fit ? max_tiles : fit;
  void* args[] = {&a};
  // refused (never dropped to another path) when the grid cannot be
  // resident at once: cudaErrorCooperativeLaunchTooLarge
  const cudaError_t e = cudaLaunchCooperativeKernel(
      (const void*)pyramid_kernel, dim3(blocks), dim3(kThreads), args,
      (size_t)smem, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
