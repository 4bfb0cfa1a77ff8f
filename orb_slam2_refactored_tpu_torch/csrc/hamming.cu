// Fused, gated Hamming best-2 matcher (kernel K1).
//
// Replaces: `hamming_matrix` + `masked_best2` of the JAX package
// (orb_slam2_refactored_tpu/ops/hamming.py:62-92) together with the
// candidate gates its three tracking callers build
// (ops/matching.py:47-51, 170-176, 251-259). XLA materialises an int32
// [M,N] distance matrix and a bool [M,N] mask and reduces them; here
// neither is ever written.
//
// What bounds it on the H100: at the largest main-path shape (8192 query
// rows x 1000 targets) the inputs are ~0.55 MB, read once. The work the
// function needs is the gate for each pair of a valid row and a valid
// column (~6 f32 and ~4 integer ops) and 8 XOR + 8 POPC for each pair that
// passes it; with the window gate few pairs pass, so operations and bytes
// come out close, and both far below a launch's latency. So the kernel
// skips invalid rows whole, tests the cheap gate before the XOR/POPC, and
// keeps the target set on chip so that no input is read from memory twice
// per block.
//
// Design: one warp per query row, eight rows per block. The block stages
// tiles of 256 targets (descriptors, keypoint xy, level, validity) in
// shared memory, so eight rows share every target load. Each lane walks
// its targets in increasing index and keeps a running (best, idx, second);
// a shuffle tree then merges the 32 lanes. Semantics reproduced exactly:
//   * a masked entry reads as BIG = 10000;
//   * the best index is the LOWEST index among equal minima;
//   * `second` is the minimum after blanking only the argmin position, so
//     two equal minima give second == best;
//   * a fully masked row returns idx 0, best = second = BIG.
// The window test is f32 `dx*dx + dy*dy <= r*r`; this file is compiled
// with -fmad=false so no product is contracted into an FMA (a contracted
// FMA rounds differently from XLA and flips pixels on the window's rim).
//
// Optional dense pair gate `pair_ok` (uint8 [M,N], row-major): ANDed into
// the candidate gate. Triangulation (slam/local_mapping.py:271-279 of the
// JAX package) passes its epipolar mask here. A warp reads 32 neighbouring
// bytes of its row per step, so the [M,N] mask is read once, coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBig = 10000;
constexpr int kWarps = 8;
constexpr int kTile = 256;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kWarps * 32)
best2_kernel(const int* __restrict__ q, const int* __restrict__ t,
             const unsigned char* __restrict__ row_ok,
             const unsigned char* __restrict__ col_ok,
             const float* __restrict__ uv, const float* __restrict__ rad,
             const int* __restrict__ lvl_r, const float* __restrict__ xy,
             const int* __restrict__ lvl_c,
             const unsigned char* __restrict__ pair_ok, int M, int N,
             int gated, int* __restrict__ out_idx, int* __restrict__ out_best,
             int* __restrict__ out_second) {
  __shared__ uint32_t s_desc[kTile][9];  // padded: 8 words + 1
  __shared__ float s_x[kTile], s_y[kTile];
  __shared__ int s_lvl[kTile];
  __shared__ unsigned char s_ok[kTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarps + warp;
  const bool have_row = row < M;

  uint32_t qd[8];
  bool rok = false;
  float ux = 0.f, uy = 0.f, r2 = 0.f;
  int rl = 0;
  if (have_row) {
#pragma unroll
    for (int w = 0; w < 8; ++w) qd[w] = (uint32_t)q[row * 8 + w];
    rok = row_ok[row] != 0;
    if (gated) {
      ux = uv[row * 2 + 0];
      uy = uv[row * 2 + 1];
      const float r = rad[row];
      r2 = r * r;
      rl = lvl_r[row];
    }
  } else {
#pragma unroll
    for (int w = 0; w < 8; ++w) qd[w] = 0u;
  }

  int best = kBig, idx = 0, second = kBig;
  for (int base = 0; base < N; base += kTile) {
    const int n_tile = min(kTile, N - base);
    __syncthreads();
    for (int i = threadIdx.x; i < n_tile * 8; i += kWarps * 32) {
      s_desc[i >> 3][i & 7] = (uint32_t)t[base * 8 + i];
    }
    for (int i = threadIdx.x; i < n_tile; i += kWarps * 32) {
      s_ok[i] = col_ok[base + i];
      if (gated) {
        s_x[i] = xy[(base + i) * 2 + 0];
        s_y[i] = xy[(base + i) * 2 + 1];
        s_lvl[i] = lvl_c[base + i];
      }
    }
    __syncthreads();
    if (!rok) continue;
    for (int j = lane; j < n_tile; j += 32) {
      bool ok = s_ok[j] != 0;
      if (gated) {
        const float dx = ux - s_x[j];
        const float dy = uy - s_y[j];
        const float d2 = dx * dx + dy * dy;
        ok = ok && (d2 <= r2) && (abs(s_lvl[j] - rl) <= 1);
      }
      if (pair_ok != nullptr) {
        ok = ok && pair_ok[(size_t)row * N + base + j] != 0;
      }
      int v = kBig;
      if (ok) {
        int d = 0;
#pragma unroll
        for (int w = 0; w < 8; ++w) d += __popc(qd[w] ^ s_desc[j][w]);
        v = d;
      }
      if (v < best) {
        second = best;
        best = v;
        idx = base + j;
      } else if (v < second) {
        second = v;
      }
    }
  }

  // merge the 32 lanes: lexicographic (value, index) minimum; the loser's
  // best competes for second place
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(kFull, best, off);
    const int oi = __shfl_xor_sync(kFull, idx, off);
    const int os = __shfl_xor_sync(kFull, second, off);
    if (ob < best || (ob == best && oi < idx)) {
      second = min(os, best);
      best = ob;
      idx = oi;
    } else {
      second = min(second, ob);
    }
  }
  if (have_row && lane == 0) {
    out_idx[row] = idx;
    out_best[row] = best;
    out_second[row] = second;
  }
}

}  // namespace

extern "C" int hamming_best2(const void* q, const void* t, const void* row_ok,
                             const void* col_ok, const void* uv,
                             const void* rad, const void* lvl_r,
                             const void* xy, const void* lvl_c,
                             const void* pair_ok, int M, int N, int gated,
                             void* out_idx, void* out_best, void* out_second,
                             void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  const dim3 grid((M + kWarps - 1) / kWarps);
  best2_kernel<<<grid, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const int*)q, (const int*)t, (const unsigned char*)row_ok,
      (const unsigned char*)col_ok, (const float*)uv, (const float*)rad,
      (const int*)lvl_r, (const float*)xy, (const int*)lvl_c,
      (const unsigned char*)pair_ok, M, N, gated, (int*)out_idx, (int*)out_best, (int*)out_second);
  return (int)cudaGetLastError();
}
