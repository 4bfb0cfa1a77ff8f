// Wire unpack (kernel K10): the decode of a packed frame upload, one
// launch for the rows of a [k, B] uint8 buffer.
//
// Replaces: `decode_dct` (orb_slam2_refactored_tpu/ops/codec.py:90-108)
// and the log8 branch of `Tracker._unpack_impl`
// (orb_slam2_refactored_tpu/slam/tracking.py:523-531), the XLA stages at
// the head of every packed step program of the JAX tracker (JAX fuses them
// into the step; here the step's first kernels read this launch's output).
// It replaces no Pallas kernel: the JAX package has none.
//
// What it computes, per row r of the buffer (row_stride bytes apart):
//   * the DCT image (W > 0): f32 img[r, y, x] = sum_k sum_l Cr[k, y%8] *
//     K[k, l] * Cr[l, x%8] over its 8x8 block's KEEP x KEEP kept
//     coefficients K, stored from img_off on, KEEP*KEEP bytes a block in
//     block raster order: the DC byte unsigned (x dc_step), the AC bytes
//     signed (x ac_step);
//   * the log8 depth (w > 0): f32 dep[r, i] = lut[code], the code the byte
//     at dep_off + i. The table is the plain decode of the codes 0-255 on
//     the card (`ops/codec.py::log8_table`), so this is the plain version
//     bit for bit by construction.
//
// What bounds it on the H100: bytes. It reads each coded byte once (plus
// the 1 KB table) and writes 4 bytes a decoded value: at the bench's
// setting (raw image, log8 depth at subsample 8) 4,800 codes in and
// 19,200 bytes out a VGA frame, a few nanoseconds at 3.35 TB/s, so a
// launch's latency is what it costs. The design is the simple one: a
// thread a decoded value, 256 threads a block; the first `img_blocks`
// blocks decode image pixels (consecutive threads take consecutive x, so
// the stores coalesce and the 16 coefficient bytes of a block are read by
// the 8 x 8 threads of its pixels from L1), the rest depth codes. The basis
// rows Cr (host f32 `_dct_matrix()`, never recomputed with cosf here) are
// passed by value, so they sit in the kernel's constant parameter bank;
// each image block copies them to shared memory, where the warp's 8
// different columns are read without serializing. Each depth block copies
// the table to shared memory. No atomics, no reduction: every output is
// written once by one thread.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBlock = 8;
constexpr int kMaxKeep = 8;

struct WireArgs {
  const uint8_t* buf;
  long long row_stride;
  int k;
  int img_off, H, W;  // W == 0: no image to decode
  int dep_off, h, w;  // w == 0: no depth to decode
  int keep;
  float ac_step, dc_step;
  float basis[kMaxKeep * kBlock];  // Cr [keep, 8], row-major
  const float* lut;
  float* img;
  float* dep;
  int img_blocks;
};

__global__ void __launch_bounds__(kThreads)
    wire_unpack_kernel(const WireArgs a) {
  __shared__ float s_tab[256];  // the basis rows, or the log8 table
  if ((int)blockIdx.x < a.img_blocks) {
    for (int i = threadIdx.x; i < a.keep * kBlock; i += kThreads)
      s_tab[i] = a.basis[i];
    __syncthreads();
    const long long hw = (long long)a.H * a.W;
    const long long p = (long long)blockIdx.x * kThreads + threadIdx.x;
    if (p >= (long long)a.k * hw) return;
    const long long r = p / hw;
    const int rem = (int)(p - r * hw);
    const int y = rem / a.W;
    const int x = rem - y * a.W;
    const int nb = a.keep * a.keep;
    const uint8_t* blk = a.buf + r * a.row_stride + a.img_off +
                         ((long long)(y / kBlock) * (a.W / kBlock) +
                          x / kBlock) * nb;
    const float* cy = s_tab + (y % kBlock);
    const float* cx = s_tab + (x % kBlock);
    float acc = 0.f;
    for (int kk = 0; kk < a.keep; ++kk) {
      float t = 0.f;
      for (int l = 0; l < a.keep; ++l) {
        const int j = kk * a.keep + l;
        const uint8_t b = __ldg(blk + j);
        const float c = j == 0 ? (float)b * a.dc_step
                               : (float)(int8_t)b * a.ac_step;
        t = fmaf(c, cx[l * kBlock], t);
      }
      acc = fmaf(cy[kk * kBlock], t, acc);
    }
    a.img[p] = acc;
    return;
  }
  for (int i = threadIdx.x; i < 256; i += kThreads) s_tab[i] = __ldg(a.lut + i);
  __syncthreads();
  const long long hw = (long long)a.h * a.w;
  const long long p =
      (long long)(blockIdx.x - a.img_blocks) * kThreads + threadIdx.x;
  if (p >= (long long)a.k * hw) return;
  const long long r = p / hw;
  const long long i = p - r * hw;
  a.dep[p] = s_tab[__ldg(a.buf + r * a.row_stride + a.dep_off + i)];
}

}  // namespace

// buf: u8 [k, row_stride]; basis: host f32 [keep * 8]; lut: f32 [256] on
// the card (null without a depth); img: f32 [k, H, W] (null when W == 0);
// dep: f32 [k, h, w] (null when w == 0). Returns the launch's error.
extern "C" int wire_unpack(const void* buf, long long row_stride, int k,
                           int img_off, int H, int W, int dep_off, int h,
                           int w, int keep, float ac_step, float dc_step,
                           const float* basis, const void* lut, void* img,
                           void* dep, void* stream) {
  if (k < 1 || keep < 1 || keep > kMaxKeep || (W <= 0 && w <= 0))
    return (int)cudaErrorInvalidValue;
  if (W > 0 && (H <= 0 || H % kBlock || W % kBlock || img == nullptr))
    return (int)cudaErrorInvalidValue;
  if (w > 0 && (h <= 0 || lut == nullptr || dep == nullptr))
    return (int)cudaErrorInvalidValue;
  WireArgs a;
  a.buf = (const uint8_t*)buf;
  a.row_stride = row_stride;
  a.k = k;
  a.img_off = img_off;
  a.H = W > 0 ? H : 0;
  a.W = W > 0 ? W : 0;
  a.dep_off = dep_off;
  a.h = w > 0 ? h : 0;
  a.w = w > 0 ? w : 0;
  a.keep = keep;
  a.ac_step = ac_step;
  a.dc_step = dc_step;
  for (int i = 0; i < kMaxKeep * kBlock; ++i)
    a.basis[i] = i < keep * kBlock ? basis[i] : 0.f;
  a.lut = (const float*)lut;
  a.img = (float*)img;
  a.dep = (float*)dep;
  const long long n_img = (long long)k * a.H * a.W;
  const long long n_dep = (long long)k * a.h * a.w;
  const long long b_img = (n_img + kThreads - 1) / kThreads;
  const long long b_dep = (n_dep + kThreads - 1) / kThreads;
  if (b_img + b_dep > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  a.img_blocks = (int)b_img;
  wire_unpack_kernel<<<(unsigned)(b_img + b_dep), kThreads, 0,
                       (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
