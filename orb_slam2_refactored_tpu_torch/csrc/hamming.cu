// Fused, gated Hamming best-2 matcher (kernel K1).
//
// Replaces: `hamming_matrix` + `masked_best2` of the JAX package
// (orb_slam2_refactored_tpu/ops/hamming.py:62-92) together with the
// candidate gates its tracking and mapping callers build
// (ops/matching.py:47-51, 170-176, 251-259; slam/local_mapping.py). XLA
// materialises an int32 [M,N] distance matrix and a bool [M,N] mask and
// reduces them; here neither is ever written. One launch a call.
//
// What bounds it on the H100: at the largest main-path shape (8192 query
// rows x 1000 targets, a few hundred rows valid) the inputs are ~0.55 MB
// and the pairs that pass the window gate a few hundred: bytes and
// operations are both far below a launch's latency. What cost time was
// reading targets that a row cannot match: every block staged all N
// targets' descriptors, ~46 MB from L2 for that call. So:
//
// Window-gated calls (`uv` given), `search_gated_kernel`: one warp a query
// row, 8 rows a block. A block with no valid row leaves at once
// (`__syncthreads_or`). The others read the targets' (x, y, level,
// validity) once into registers and build, in shared memory, a coarse grid
// of them: the bounding box of the valid targets, 32-px cells (at most
// 32 x 32), a counting sort into cell offsets and (x, y, level, index)
// records in cell order; 2048 targets at a time, so any N is taken. Then a
// row reads only the cells that [u-R, u+R] x [v-R, v+R] overlaps: one
// contiguous run of records per grid row, the runs laid end to end over
// the warp's lanes, so that the descriptors (read from global memory only
// where the exact tests pass) of all its candidates are read at once. The
// exact tests are the plain version's: f32 `dx*dx + dy*dy <= r*r`, the
// level test, `col_ok`. R = |r| (1 + 1e-4) + 1e-4 max(|u|, |v|) + 1e-20
// lies above every f32 rounding of dx, dy and r^2, and the cell of a
// coordinate is a monotone function of it, clamped to the grid, so no
// target that the exact test passes lies outside the cells read. A block
// reads ~13 bytes a target (xy, level, validity) and no descriptor it does
// not need.
//
// Dense calls (no window; optional `pair_ok`), `search_dense_kernel`: 8
// query rows a block, one warp each, stage tiles of 256 targets in shared
// memory, so each staged target serves every row of the block; a block
// with no valid row leaves before any load. `pair_ok` is read coalesced
// along the row. (16 and 32 rows a block, timed on the main path's
// 1000 x 1000 calls on an NVIDIA H100 80GB HBM3 at 700 W, were slower:
// these calls are bound by latency, not by the L2 traffic more rows save.)
//
// Best-2 under a scan order that is not the index order: each lane keeps a
// running (best, idx, second) and takes a candidate (v, j) as the new best
// when (v, j) is lexicographically below (best, idx), the old best becoming
// second; otherwise second = min(second, v). A shuffle tree merges the 32
// lanes by the same rule. Semantics reproduced exactly:
//   * a masked entry reads as BIG = 10000;
//   * the best index is the LOWEST index among equal minima;
//   * `second` is the minimum after blanking only the argmin position, so
//     two equal minima give second == best;
//   * a fully masked row returns idx 0, best = second = BIG.
// This file is compiled with -fmad=false so no product is contracted into
// an FMA (a contracted FMA rounds differently from XLA and flips pixels on
// the window's rim).
//
// Optional `work` (i32[3], null on the tracking path): valid rows searched,
// grid cells read, target records tested, summed over the call.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBig = 10000;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kTile = 256;
constexpr int kDenseWarps = 8;  // query rows a block of the dense search
constexpr int kGatedWarps = 8;
constexpr int kGatedThreads = kGatedWarps * 32;
constexpr int kChunk = 2048;  // targets binned at a time
constexpr int kGridAxis = 32;  // cells a grid axis, at most
constexpr int kGridCells = kGridAxis * kGridAxis;
constexpr int kPerThread = kChunk / kGatedThreads;  // targets a thread bins
constexpr float kCellPx = 32.0f;

// (idx, best, second) of one lane or row
struct Best2 {
  int best, idx, second;
};

__device__ __forceinline__ void take(Best2& b, int v, int j) {
  if (v < b.best || (v == b.best && j < b.idx)) {
    b.second = b.best;
    b.best = v;
    b.idx = j;
  } else {
    b.second = min(b.second, v);
  }
}

__device__ __forceinline__ Best2 warp_merge(Best2 b) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const int ob = __shfl_xor_sync(kFull, b.best, off);
    const int oi = __shfl_xor_sync(kFull, b.idx, off);
    const int os = __shfl_xor_sync(kFull, b.second, off);
    if (ob < b.best || (ob == b.best && oi < b.idx)) {
      b.second = min(os, b.best);
      b.best = ob;
      b.idx = oi;
    } else {
      b.second = min(b.second, ob);
    }
  }
  return b;
}

__device__ __forceinline__ void write_row(int row, const Best2& b,
                                          int* out_idx, int* out_best,
                                          int* out_second) {
  out_idx[row] = b.idx;
  out_best[row] = b.best;
  out_second[row] = b.second;
}

// ---- the coarse grid ----------------------------------------------------

struct Grid {
  float x0, y0, inv;  // origin and 1 / cell size
  int gx, gy;
};

// Cell of a coordinate along one axis: monotone in `x`, clamped to the grid
// (NaN lands in cell 0).
__device__ __forceinline__ int cell_of(float x, float x0, float inv, int g) {
  float f = floorf((x - x0) * inv);
  f = fminf(fmaxf(f, 0.0f), (float)(g - 1));
  return (int)f;
}

__device__ __forceinline__ int cell_xy(const Grid& g, float x, float y) {
  return cell_of(y, g.y0, g.inv, g.gy) * g.gx + cell_of(x, g.x0, g.inv, g.gx);
}

// A target that can pass a window: valid and without a NaN coordinate (one
// at infinity is kept, since an infinite radius reaches it; it lands in an
// edge cell).
__device__ __forceinline__ bool binned(const unsigned char* col_ok,
                                       const float* xy, int j, float* x,
                                       float* y) {
  *x = xy[2 * j];
  *y = xy[2 * j + 1];
  return col_ok[j] && !isnan(*x) && !isnan(*y);
}

__device__ __forceinline__ void warp_minmax(float* v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    v[0] = fminf(v[0], __shfl_xor_sync(kFull, v[0], off));
    v[1] = fminf(v[1], __shfl_xor_sync(kFull, v[1], off));
    v[2] = fmaxf(v[2], __shfl_xor_sync(kFull, v[2], off));
    v[3] = fmaxf(v[3], __shfl_xor_sync(kFull, v[3], off));
  }
}

__global__ void __launch_bounds__(kGatedThreads)
search_gated_kernel(const int* __restrict__ q, const int* __restrict__ t,
                    const unsigned char* __restrict__ row_ok,
                    const unsigned char* __restrict__ col_ok,
                    const float* __restrict__ uv, const float* __restrict__ rad,
                    const int* __restrict__ lvl_r, const float* __restrict__ xy,
                    const int* __restrict__ lvl_c,
                    const unsigned char* __restrict__ pair_ok, int M, int N,
                    int* __restrict__ out_idx, int* __restrict__ out_best,
                    int* __restrict__ out_second, int* __restrict__ work) {
  __shared__ int4 s_rec[kChunk];  // x, y (bits), level, index; cell order
  __shared__ int s_start[kGridCells + 1];
  __shared__ int s_cur[kGridCells];
  __shared__ float s_box[4][kGatedWarps];
  __shared__ int s_part[kGatedWarps];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int row = blockIdx.x * kGatedWarps + warp;
  const bool have_row = row < M;
  const bool rok = have_row && row_ok[row] != 0;
  Best2 b{kBig, 0, kBig};
  if (!__syncthreads_or(rok)) {
    if (have_row && lane == 0) write_row(row, b, out_idx, out_best, out_second);
    return;
  }
  uint32_t qd[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  float ux = 0.f, uy = 0.f, r2 = 0.f, R = 0.f;
  int rl = 0;
  if (rok) {
    const int4* q4 = reinterpret_cast<const int4*>(q + (size_t)row * 8);
    const int4 qa = q4[0], qb = q4[1];
    qd[0] = qa.x; qd[1] = qa.y; qd[2] = qa.z; qd[3] = qa.w;
    qd[4] = qb.x; qd[5] = qb.y; qd[6] = qb.z; qd[7] = qb.w;
    ux = uv[2 * row];
    uy = uv[2 * row + 1];
    const float r = rad[row];
    r2 = r * r;
    rl = lvl_r[row];
    R = fabsf(r) * (1.0f + 1e-4f) + fmaxf(fabsf(ux), fabsf(uy)) * 1e-4f +
        1e-20f;
  }
  int cells_read = 0, tested = 0;

  for (int base = 0; base < N; base += kChunk) {
    const int n = min(kChunk, N - base);
    // ---- the chunk's targets, one global read into registers, and the
    // bounding box of the finite ones that can pass a window ----
    float tx[kPerThread], ty[kPerThread];
    int tl[kPerThread], tc[kPerThread];
    float box[4] = {INFINITY, INFINITY, -INFINITY, -INFINITY};
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = tid + k * kGatedThreads;
      tc[k] = -1;
      if (i < n && binned(col_ok, xy, base + i, &tx[k], &ty[k])) {
        tc[k] = 0;
        tl[k] = lvl_c[base + i];
        if (isfinite(tx[k]) && isfinite(ty[k])) {
          box[0] = fminf(box[0], tx[k]);
          box[1] = fminf(box[1], ty[k]);
          box[2] = fmaxf(box[2], tx[k]);
          box[3] = fmaxf(box[3], ty[k]);
        }
      }
    }
    for (int c = tid; c < kGridCells; c += kGatedThreads) s_cur[c] = 0;
    warp_minmax(box);
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) s_box[k][warp] = box[k];
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < 4; ++k) box[k] = s_box[k][lane % kGatedWarps];
    warp_minmax(box);
    Grid g;
    if (box[0] > box[2]) {  // no finite binned target
      g.x0 = g.y0 = 0.0f;
      g.inv = 1.0f / kCellPx;
      g.gx = g.gy = 1;
    } else {
      const float ext = fmaxf(box[2] - box[0], box[3] - box[1]);
      g.x0 = box[0];
      g.y0 = box[1];
      g.inv = 1.0f / fmaxf(kCellPx, ext / (float)(kGridAxis - 1));
      g.gx = (int)fminf(fmaxf(floorf((box[2] - box[0]) * g.inv) + 1.0f, 1.0f),
                        (float)kGridAxis);
      g.gy = (int)fminf(fmaxf(floorf((box[3] - box[1]) * g.inv) + 1.0f, 1.0f),
                        (float)kGridAxis);
    }
    // ---- counting sort: histogram, exclusive scan, scatter ----
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (tc[k] >= 0) {
        tc[k] = cell_xy(g, tx[k], ty[k]);
        atomicAdd(&s_cur[tc[k]], 1);
      }
    }
    __syncthreads();
    constexpr int kPer = kGridCells / kGatedThreads;
    int local[kPer], sum = 0;
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      local[k] = sum;
      sum += s_cur[tid * kPer + k];
    }
    int incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int o = __shfl_up_sync(kFull, incl, off);
      if (lane >= off) incl += o;
    }
    if (lane == 31) s_part[warp] = incl;
    __syncthreads();
    int before = incl - sum;
    for (int w = 0; w < warp; ++w) before += s_part[w];
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      s_start[tid * kPer + k] = before + local[k];
      s_cur[tid * kPer + k] = before + local[k];
    }
    if (tid == kGatedThreads - 1) s_start[kGridCells] = before + sum;
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      if (tc[k] >= 0) {
        const int pos = atomicAdd(&s_cur[tc[k]], 1);
        s_rec[pos] = make_int4(__float_as_int(tx[k]), __float_as_int(ty[k]),
                               tl[k], base + tid + k * kGatedThreads);
      }
    }
    __syncthreads();
    // ---- each valid row reads the cells its window overlaps: one run of
    // records a grid row, the runs laid end to end over the lanes, so the
    // descriptors of all candidates are read at once ----
    if (rok) {
      const int cx0 = cell_of(ux - R, g.x0, g.inv, g.gx);
      const int cx1 = cell_of(ux + R, g.x0, g.inv, g.gx);
      const int cy0 = cell_of(uy - R, g.y0, g.inv, g.gy);
      const int cy1 = cell_of(uy + R, g.y0, g.inv, g.gy);
      const int n_runs = cy1 - cy0 + 1;  // <= kGridAxis = 32
      int run_start = 0, run_len = 0;
      if (lane < n_runs) {
        const int c = (cy0 + lane) * g.gx;
        run_start = s_start[c + cx0];
        run_len = s_start[c + cx1 + 1] - run_start;
      }
      int run_end = run_len;  // inclusive scan: where each run ends
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int o = __shfl_up_sync(kFull, run_end, off);
        if (lane >= off) run_end += o;
      }
      const int total = __shfl_sync(kFull, run_end, n_runs - 1);
      cells_read += n_runs * (cx1 - cx0 + 1);
      tested += total;
      for (int k0 = 0; k0 < total; k0 += 32) {
        const int k = k0 + lane;
        int rec = -1;
        for (int i = 0; i < n_runs; ++i) {
          const int e = __shfl_sync(kFull, run_end, i);
          const int st = __shfl_sync(kFull, run_start, i);
          const int len = __shfl_sync(kFull, run_len, i);
          if (rec < 0 && k < e) rec = st + k - (e - len);
        }
        if (k >= total) continue;
        const int4 c = s_rec[rec];
        const float dx = ux - __int_as_float(c.x);
        const float dy = uy - __int_as_float(c.y);
        const float d2 = dx * dx + dy * dy;
        bool ok = (d2 <= r2) && (abs(c.z - rl) <= 1);
        if (pair_ok != nullptr) {
          ok = ok && pair_ok[(size_t)row * N + c.w] != 0;
        }
        if (ok) {
          const int4* d4 = reinterpret_cast<const int4*>(t + (size_t)c.w * 8);
          const int4 da = d4[0], db = d4[1];
          const int v =
              __popc(qd[0] ^ (uint32_t)da.x) + __popc(qd[1] ^ (uint32_t)da.y) +
              __popc(qd[2] ^ (uint32_t)da.z) + __popc(qd[3] ^ (uint32_t)da.w) +
              __popc(qd[4] ^ (uint32_t)db.x) + __popc(qd[5] ^ (uint32_t)db.y) +
              __popc(qd[6] ^ (uint32_t)db.z) + __popc(qd[7] ^ (uint32_t)db.w);
          take(b, v, c.w);
        }
      }
    }
    __syncthreads();  // the next chunk rewrites the grid
  }
  b = warp_merge(b);
  if (have_row && lane == 0) {
    write_row(row, b, out_idx, out_best, out_second);
    if (work != nullptr && rok) {
      atomicAdd(&work[0], 1);
      atomicAdd(&work[1], cells_read);
      atomicAdd(&work[2], tested);
    }
  }
}

__global__ void __launch_bounds__(kDenseWarps * 32)
search_dense_kernel(const int* __restrict__ q, const int* __restrict__ t,
                    const unsigned char* __restrict__ row_ok,
                    const unsigned char* __restrict__ col_ok,
                    const unsigned char* __restrict__ pair_ok, int M, int N,
                    int* __restrict__ out_idx, int* __restrict__ out_best,
                    int* __restrict__ out_second, int* __restrict__ work) {
  __shared__ uint32_t s_desc[kTile][9];  // padded: 8 words + 1
  __shared__ unsigned char s_ok[kTile];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kDenseWarps + warp;
  const bool have_row = row < M;
  const bool rok = have_row && row_ok[row] != 0;
  Best2 b{kBig, 0, kBig};
  if (__syncthreads_or(rok)) {
    uint32_t qd[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) qd[w] = rok ? (uint32_t)q[row * 8 + w] : 0u;
    for (int base = 0; base < N; base += kTile) {
      const int n_tile = min(kTile, N - base);
      __syncthreads();
      for (int i = threadIdx.x; i < n_tile * 8; i += kDenseWarps * 32) {
        s_desc[i >> 3][i & 7] = (uint32_t)t[base * 8 + i];
      }
      for (int i = threadIdx.x; i < n_tile; i += kDenseWarps * 32) {
        s_ok[i] = col_ok[base + i];
      }
      __syncthreads();
      if (!rok) continue;
      for (int j = lane; j < n_tile; j += 32) {
        bool ok = s_ok[j] != 0;
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
        // targets come in index order: a strict compare keeps the lowest
        // index among equal minima
        if (v < b.best) {
          b.second = b.best;
          b.best = v;
          b.idx = base + j;
        } else if (v < b.second) {
          b.second = v;
        }
      }
    }
  }
  b = warp_merge(b);
  if (have_row && lane == 0) {
    write_row(row, b, out_idx, out_best, out_second);
    if (work != nullptr && rok) {
      atomicAdd(&work[0], 1);
      atomicAdd(&work[2], N);
    }
  }
}

}  // namespace

extern "C" int hamming_best2(const void* q, const void* t, const void* row_ok,
                             const void* col_ok, const void* uv,
                             const void* rad, const void* lvl_r,
                             const void* xy, const void* lvl_c,
                             const void* pair_ok, int M, int N, int gated,
                             void* out_idx, void* out_best, void* out_second,
                             void* work, void* stream) {
  if (M <= 0) return (int)cudaGetLastError();
  const auto s = (cudaStream_t)stream;
  const auto* pq = (const int*)q;
  const auto* pt = (const int*)t;
  const auto* rok = (const unsigned char*)row_ok;
  const auto* cok = (const unsigned char*)col_ok;
  const auto* pok = (const unsigned char*)pair_ok;
  auto* oi = (int*)out_idx;
  auto* ob = (int*)out_best;
  auto* os = (int*)out_second;
  auto* wk = (int*)work;
  if (gated) {
    search_gated_kernel<<<(M + kGatedWarps - 1) / kGatedWarps, kGatedThreads,
                          0, s>>>(
        pq, pt, rok, cok, (const float*)uv, (const float*)rad,
        (const int*)lvl_r, (const float*)xy, (const int*)lvl_c, pok, M, N, oi,
        ob, os, wk);
  } else {
    search_dense_kernel<<<(M + kDenseWarps - 1) / kDenseWarps,
                          kDenseWarps * 32, 0, s>>>(pq, pt, rok, cok, pok, M,
                                                    N, oi, ob, os, wk);
  }
  return (int)cudaGetLastError();
}
