// The image pyramid of one frame, levels 1 to n-1, in one launch (kernel K8).
//
// Replaces, in the JAX package (orb_slam2_refactored_tpu/):
//   - `build_pyramid` (ops/image.py:42-53), a chain of
//     `jax.image.resize(method="linear")` calls (ops/image.py:28-30), each
//     level resized from the previous one, which XLA runs as two products
//     a level with dense [in, out] weight matrices.
// The plain PyTorch version (`ops/image.py::build_pyramid_plain`) does the
// same with two dense f32 GEMMs a level, each of whose outputs has 2-3
// nonzero taps at the scale factor 1.2.
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
// kernel equals the plain version on the card bit for bit. The taps are
// `_resize_weights_np`'s own f32 weights, read from a record per output
// (first input index, tap count, split, then the taps: three 16-byte
// loads) uploaded once per shape and device (`ops/image.py::_tap_records`).
//
// What bounds it on the H100. The function reads level 0 once and writes
// levels 1 to n-1 once: at VGA 1.23 MB in and 2.6 MB out, ~1.1 us at 3.35
// TB/s; it does ~2.5 FMAs a vertical and a horizontal output, a few
// million f32 operations, well under a microsecond. So bytes bound it,
// and in practice the dependency between levels: level l needs level l-1.
// Design: no block waits on another. The deepest level is cut into a grid
// of gy x gx parts (`ops/image.py::pyramid_schedule`, ~one block an SM),
// and block (by, bx) computes, level after level from level 0, the region
// of each level that its part needs (`axis_parts`: the rows and columns
// whose taps its next level's region reads, hulled with what it owns);
// a region lives in shared memory and is the next level's input, so only
// level 0 is read from device memory. Neighbouring blocks compute their
// shared margins twice (~1.5x the outputs in all at VGA); each writes only
// the outputs it owns, and the owned outputs of the blocks cover every
// level once. No grid barrier, no cooperative launch, no float atomics:
// a level's latency is two `__syncthreads`. Every output is computed with
// the same record and the same rounding wherever it is computed, so a
// block's margin equals its neighbour's owned output bit for bit.
// Levels start at 16-byte-aligned offsets of one buffer (the caller lays
// it out), where kernel K2 uses vector loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxTaps = 8;  // `PYR_MAX_TAPS` in ops/image.py
constexpr int kRec = 1 + kMaxTaps / 4;  // int4 a record: first, count,
                                        // split, a pad, then the taps
constexpr int kThreads = 1024;
constexpr int kMaxSmem = 232448;  // `PYR_SMEM` in ops/image.py

struct Level {        // level l from level l-1
  float* dst;         // level l in the buffer
  int w;              // its width
  const int4* v;      // vertical records, kRec int4 an output row
  const int4* h;      // horizontal records, kRec int4 an output column
};

struct PyrArgs {
  Level lv[kMaxLevels];
  const float* img;   // level 0
  int w0, n, gx;
  const int4* rows;   // [gy][n]: need lo, need hi, own lo, own hi
  const int4* cols;   // [gx][n]
  int records;        // records a block stages, at most
  int region;         // floats of a region buffer (two of them)
};

// The output of record `rec` over x[first - origin], x[first - origin +
// stride], ...: taps [0, split) as one fmaf chain from the first product,
// taps [split, count) as another, then their sum (1 <= split <= count);
// 0 for an output with no tap.
__device__ __forceinline__ float tap_sum(const float* x, int stride,
                                         int origin, const int4* rec) {
  const int4 hd = rec[0];
  const int count = hd.y, split = hd.z;
  if (count <= 0) return 0.f;
  const float* w = reinterpret_cast<const float*>(rec + 1);
  x += (hd.x - origin) * stride;
  float a = __fmul_rn(w[0], x[0]);
  for (int k = 1; k < split; ++k) a = __fmaf_rn(w[k], x[k * stride], a);
  if (split >= count) return a;
  float b = __fmul_rn(w[split], x[split * stride]);
  for (int k = split + 1; k < count; ++k)
    b = __fmaf_rn(w[k], x[k * stride], b);
  return __fadd_rn(a, b);
}

// a thread's walk over a row-major region of width `width`: element i =
// y width + x, from `start`, kThreads at a time (no division a pixel)
struct Walk {
  int i, y, x;
  const int width, dy, dx;
  __device__ Walk(int start, int width_)
      : i(start),
        y(width_ > 0 ? start / width_ : 0),
        x(start - y * width_),
        width(width_),
        dy(width_ > 0 ? kThreads / width_ : 0),
        dx(kThreads - dy * width_) {}
  __device__ void next() {
    i += kThreads;
    y += dy;
    x += dx;
    if (x >= width) {
      x -= width;
      ++y;
    }
  }
};

__global__ void __launch_bounds__(kThreads)
pyramid_kernel(const __grid_constant__ PyrArgs a) {
  // the block's records (kRec int4 an output: its needed rows of every
  // level, then its needed columns), then two region buffers and the
  // vertical sums
  extern __shared__ int4 s_rec[];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int4* R = a.rows + (blockIdx.x / a.gx) * a.n;
  const int4* C = a.cols + (blockIdx.x % a.gx) * a.n;
  float* src = reinterpret_cast<float*>(s_rec + kRec * a.records);
  float* dst = src + a.region;       // level l's region
  float* tmp = src + 2 * a.region;   // level l's vertical sums
  // stage every level's records, a warp a (level, axis) segment, and level
  // 0's region: all of it read once from device memory, the loads of a
  // thread unrolled so that they are in flight together
  int at = 0;
  for (int seg = 0; seg < 2 * (a.n - 1); ++seg) {
    const int l = seg % (a.n - 1) + 1;
    const int4 e = __ldg((seg < a.n - 1 ? R : C) + l);
    const int count = kRec * (e.y - e.x);
    if (seg % (kThreads / 32) == warp) {
      const int4* from = (seg < a.n - 1 ? a.lv[l].v : a.lv[l].h) + kRec * e.x;
#pragma unroll 4
      for (int k = lane; k < count; k += 32) s_rec[at + k] = __ldg(from + k);
    }
    at += count;
  }
  int4 r = __ldg(R), c = __ldg(C);
  int sy0 = r.x, sx0 = c.x, snx = c.y - c.x;
#pragma unroll 4
  for (Walk w(tid, snx); w.i < (r.y - r.x) * snx; w.next())
    src[w.i] = __ldg(a.img + (size_t)(sy0 + w.y) * a.w0 + sx0 + w.x);
  __syncthreads();
  const int4* vrec = s_rec;  // level l's rows from its first needed row
  const int4* hrec = s_rec;  // its columns likewise
  for (int l = 1; l < a.n; ++l)
    hrec += kRec * (__ldg(R + l).y - __ldg(R + l).x);
  for (int l = 1; l < a.n; ++l) {
    const Level& L = a.lv[l];
    r = __ldg(R + l);
    c = __ldg(C + l);
    const int ny = r.y - r.x, nx = c.y - c.x;
    // vertical: tmp[y][x] = the taps of output row r.x + y over src
    // column x
    for (Walk w(tid, snx); w.i < ny * snx; w.next())
      tmp[w.i] = tap_sum(src + w.x, snx, sy0, vrec + kRec * w.y);
    __syncthreads();
    // horizontal: the region's outputs; the owned ones also to the level
    for (Walk w(tid, nx); w.i < ny * nx; w.next()) {
      const float v = tap_sum(tmp + w.y * snx, 1, sx0, hrec + kRec * w.x);
      dst[w.i] = v;
      const int oy = r.x + w.y, ox = c.x + w.x;
      if (oy >= r.z && oy < r.w && ox >= c.z && ox < c.w)
        L.dst[(size_t)oy * L.w + ox] = v;
    }
    __syncthreads();  // dst is read and src rewritten by the next level
    float* t = src;
    src = dst;
    dst = t;
    sy0 = r.x;
    sx0 = c.x;
    snx = nx;
    vrec += kRec * ny;
    hrec += kRec * nx;
  }
}

}  // namespace

// Levels 1 to n-1 of an f32 [h, w] image (`img`, level 0) into `buf`,
// level l at float offset offsets[l-1]. dims: (h, w) of the n levels;
// recs: per level l >= 1 its vertical (h[l-1] -> h[l]) and horizontal
// records; rows, cols: the schedule, int32 [gy, n, 4] and [gx, n, 4]
// (`ops/image.py::axis_parts`); records, region, sums: the most records
// (rows and columns of every level), the largest region and the largest
// vertical sums a block holds (`pyramid_schedule`).
extern "C" int pyramid_levels(int n, const void* img, void* buf,
                              const int* dims, const int* offsets,
                              const void* const* recs, const void* rows,
                              const void* cols, int gy, int gx, int records,
                              int region, int sums, void* stream) {
  if (n < 2 || n > kMaxLevels || gy < 1 || gx < 1 || records < 0 ||
      region < 0 || sums < 0)
    return (int)cudaErrorInvalidValue;
  const long long smem =
      16LL * kRec * records + 4LL * (2LL * region + sums);
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  PyrArgs a;
  a.img = (const float*)img;
  a.w0 = dims[1];
  a.n = n;
  a.gx = gx;
  a.rows = (const int4*)rows;
  a.cols = (const int4*)cols;
  a.records = records;
  a.region = region;
  for (int l = 0; l < n; ++l)
    if (dims[2 * l] < 1 || dims[2 * l + 1] < 1)
      return (int)cudaErrorInvalidValue;
  for (int l = 1; l < n; ++l) {
    Level& L = a.lv[l];
    L.dst = (float*)buf + offsets[l - 1];
    L.w = dims[2 * l + 1];
    L.v = (const int4*)recs[2 * (l - 1)];
    L.h = (const int4*)recs[2 * (l - 1) + 1];
  }
  // above 48 KB of dynamic shared memory only after opting in (once a
  // device for the largest size asked so far)
  static int opted_dev = -1;
  static long long opted = 0;
  if (smem > 48 * 1024) {
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e != cudaSuccess) return (int)e;
    if (dev != opted_dev || smem > opted) {
      e = cudaFuncSetAttribute(pyramid_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
      if (e != cudaSuccess) return (int)e;
      opted_dev = dev;
      opted = smem;
    }
  }
  pyramid_kernel<<<gy * gx, kThreads, (size_t)smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
