// Two-threshold FAST-9/16 with per-cell fallback, 3x3 NMS, the edge margin
// and the per-cell rank rounds of every pyramid level, in one call a frame
// (kernel K2).
//
// Replaces, in the JAX package (orb_slam2_refactored_tpu/):
//   - `detect_two_threshold` (ops/fast.py:130-143, with `fast_strength_map`
//     :59, `nms3x3` :105 and `cell_pool_any` :118), which XLA runs as 16
//     shifted image planes, min/max cascades, a padded cell max-pool and 8
//     shifted NMS planes, each a pass over device memory;
//   - the edge-margin mask of `OrbExtractor` (ops/orb.py:510-519);
//   - the rank rounds of `select_spread_topk` (ops/orb.py:146-212, the loop
//     at :185-199): per round an argmax, a gather and a scatter over the
//     level's 32x32 tiles.
// The global top-k over the rounds' candidates is kernel K9
// (`csrc/spread_topk.cu`), which reads the rounds' (raw, pos) as written.
//
// What bounds it on the H100. Over the 8 VGA levels (950,532 px) the
// function must read each f32 image once and write each f32 score plane
// once (8 bytes a pixel, 7.6 MB, 2.3 us at 3.35 TB/s) plus the rounds'
// (raw, pos) pairs; it needs ~178 f32 subtract/min/max a pixel for the
// strength (16 differences, 4 a nine-long arc window with the doubling
// cascade of the JAX code for each of the 2 x 16 windows, the arc
// reductions and the threshold test) and ~13 for the threshold and the NMS,
// ~182 M operations, 5.3 us at the card's f32 rate: operations bound.
//
// The design before this one (one call a level) took 0.273 and 0.410 ms a
// frame in two calls on an NVIDIA H100 80GB HBM3 at 700 W, 50x its bound:
// 8 calls of a memset and two kernels each, each level's grid of 32x8
// tiles under one wave for the upper levels, a serial 9-long minimum per
// arc window (~300 operations a pixel), and the score plane written for
// ~300 plain launches (57 rank rounds a frame) to read back. This design:
//   - one call for every level: a by-value table gives each level's image,
//     outputs, shape, first tile, first ranking cell and rounds; a block
//     finds its level from the tile (or cell) offsets. Three device
//     operations a frame: one memset of all levels' 30x30 fallback flags,
//     `strength_kernel` over all levels' tiles, `nms_rank_kernel` over all
//     levels' ranking cells (998 blocks at VGA). The flags of a 30x30 cell
//     depend on pixels anywhere in it, so strength and NMS stay two
//     kernels;
//   - `strength_kernel`: a 64x16 tile, its 3-px halo loaded with 16-byte
//     vector loads where the level's rows are 16-byte aligned (levels whose
//     width is a multiple of 4), the strength by the doubling cascade in
//     registers; a pixel above the initial threshold sets its 30x30 cell's
//     flag;
//   - `nms_rank_kernel`: one block of 256 threads a 32x32 ranking cell.
//     It rebuilds the cell's 34x34 two-threshold score from the strength
//     and the flags of every 30x30 cell the region touches, keeps pixels
//     >= all 8 neighbours and > 1e-9 (ties survive), zeroes pixels outside
//     the edge margin, writes the level's score plane, and keeps the 1024
//     results in registers (4 a thread). Pixels of the cell beyond the
//     level's edge are 0, as the zero padding of the plain version makes
//     them. Each rank round is then a block argmax, a (value, index)
//     reduction in which the lowest in-cell index wins a tie as
//     `torch.argmax` and `jnp.argmax` pick; the round writes (raw, pos) and
//     sets the pick to -1, below every zero.
// All arithmetic is f32 subtract, min and max, and ties are decided by the
// index alone, so every output equals the plain version and JAX exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kThreads = 256;
constexpr int TX = 64;              // strength tile: 64 x 16 pixels
constexpr int TY = 16;
constexpr int R = 3;                // circle radius
constexpr int SX = TX + 8;          // tile column j holds x0 - 4 + j
constexpr int SY = TY + 2 * R;      // tile row i holds y0 - 3 + i
constexpr int RC = 32;              // ranking cell: 32 x 32 pixels
constexpr int kPer = RC * RC / kThreads;  // ranked pixels a thread

struct Level {
  const float* img;
  float* strength;
  float* score;
  float* raw;
  int* pos;
  int* flags;
  int h, w;
  int tile0, tiles_x;   // first strength tile, tiles across
  int cell0, cells_x;   // first ranking cell, ranking cells across
  int cells;            // ranking cells of the level
  int flags_x;          // fallback cells across
  int rounds;           // rank rounds (0: no ranking)
  int vec;              // rows are 16-byte aligned
};

struct Levels {
  Level lv[kMaxLevels];
  int n;
};

__device__ __forceinline__ float fast_strength(const float (*tile)[SX],
                                               int cy, int cx) {
  constexpr int dx[16] = {0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3, -3, -3, -2, -1};
  constexpr int dy[16] = {-3, -3, -2, -1, 0, 1, 2, 3, 3, 3, 2, 1, 0, -1, -2, -3};
  const float c = tile[cy][cx];
  float d[16];
#pragma unroll
  for (int k = 0; k < 16; ++k) d[k] = tile[cy + dy[k]][cx + dx[k]] - c;
  // doubling cascade: lo/hi of the circular windows of 2, 4, 8, then 9
  float lo2[16], hi2[16], lo4[16], hi4[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo2[i] = fminf(d[i], d[(i + 1) & 15]);
    hi2[i] = fmaxf(d[i], d[(i + 1) & 15]);
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    lo4[i] = fminf(lo2[i], lo2[(i + 2) & 15]);
    hi4[i] = fmaxf(hi2[i], hi2[(i + 2) & 15]);
  }
  float bright = -INFINITY, dark = INFINITY;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const float lo8 = fminf(lo4[i], lo4[(i + 4) & 15]);
    const float hi8 = fmaxf(hi4[i], hi4[(i + 4) & 15]);
    bright = fmaxf(bright, fminf(lo8, d[(i + 8) & 15]));
    dark = fminf(dark, fmaxf(hi8, d[(i + 8) & 15]));
  }
  // the dark test is the bright test of -d: max_i min(-d) = -min_i max(d)
  return fmaxf(bright, -dark);
}

__global__ void __launch_bounds__(kThreads)
strength_kernel(const __grid_constant__ Levels L, int cell, float ini_th) {
  __shared__ __align__(16) float tile[SY][SX];
  int l = 0;
  while (l + 1 < L.n && (int)blockIdx.x >= L.lv[l + 1].tile0) ++l;
  const Level& v = L.lv[l];
  const int t = blockIdx.x - v.tile0;
  const int x0 = (t % v.tiles_x) * TX, y0 = (t / v.tiles_x) * TY;
  const int h = v.h, w = v.w, tid = threadIdx.x;
  // Halo reads past the image are clamped; they only feed pixels within 3
  // px of the border, whose strength is 0.
  if (v.vec && x0 >= 4 && x0 + TX + 4 <= w) {
    for (int i = tid; i < SY * (SX / 4); i += kThreads) {
      const int r = i / (SX / 4), q = i % (SX / 4);
      const int gy = min(max(y0 - R + r, 0), h - 1);
      *reinterpret_cast<float4*>(&tile[r][4 * q]) =
          *reinterpret_cast<const float4*>(v.img + (size_t)gy * w + x0 - 4 +
                                           4 * q);
    }
  } else {
    for (int i = tid; i < SY * SX; i += kThreads) {
      const int r = i / SX, c = i % SX;
      const int gy = min(max(y0 - R + r, 0), h - 1);
      const int gx = min(max(x0 - 4 + c, 0), w - 1);
      tile[r][c] = v.img[(size_t)gy * w + gx];
    }
  }
  __syncthreads();
  const int tx = tid % TX, x = x0 + tx;
  for (int ty = tid / TX; ty < TY; ty += kThreads / TX) {
    const int y = y0 + ty;
    if (x >= w || y >= h) continue;
    float s = 0.f;
    if (y >= 3 && y < h - 3 && x >= 3 && x < w - 3)
      s = fast_strength(tile, ty + R, tx + 4);
    v.strength[(size_t)y * w + x] = s;
    if (s - ini_th > 0.f) v.flags[(y / cell) * v.flags_x + x / cell] = 1;
  }
}

// (value, index) merge: the larger value, the lower index on a tie
__device__ __forceinline__ void take_better(float& bv, int& bi, float ov,
                                            int oi) {
  if (ov > bv || (ov == bv && oi < bi)) {
    bv = ov;
    bi = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
nms_rank_kernel(const __grid_constant__ Levels L, int cell, int margin,
                float ini_th, float min_th) {
  __shared__ float sc[RC + 2][RC + 2];
  __shared__ float red_v[kThreads / 32];
  __shared__ int red_i[kThreads / 32];
  int l = 0;
  while (l + 1 < L.n && (int)blockIdx.x >= L.lv[l + 1].cell0) ++l;
  const Level& v = L.lv[l];
  const int c = blockIdx.x - v.cell0;
  const int x0 = (c % v.cells_x) * RC, y0 = (c / v.cells_x) * RC;
  const int h = v.h, w = v.w, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  for (int i = tid; i < (RC + 2) * (RC + 2); i += kThreads) {
    const int y = y0 + i / (RC + 2) - 1, x = x0 + i % (RC + 2) - 1;
    float s = 0.f;
    if (y >= 0 && y < h && x >= 0 && x < w) {
      const float th =
          v.flags[(y / cell) * v.flags_x + x / cell] ? ini_th : min_th;
      s = fmaxf(v.strength[(size_t)y * w + x] - th, 0.f);
    }
    (&sc[0][0])[i] = s;
  }
  __syncthreads();
  // thread tid holds in-cell pixels tid + 256 j: a warp covers one row
  float val[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int p = tid + kThreads * j, ly = p / RC, lx = p % RC;
    const int y = y0 + ly, x = x0 + lx;
    float out = 0.f;
    if (y < h && x < w) {
      const int cy = ly + 1, cx = lx + 1;
      const float s = sc[cy][cx];
      float nmax = sc[cy - 1][cx - 1];
      nmax = fmaxf(nmax, sc[cy - 1][cx]);
      nmax = fmaxf(nmax, sc[cy - 1][cx + 1]);
      nmax = fmaxf(nmax, sc[cy][cx - 1]);
      nmax = fmaxf(nmax, sc[cy][cx + 1]);
      nmax = fmaxf(nmax, sc[cy + 1][cx - 1]);
      nmax = fmaxf(nmax, sc[cy + 1][cx]);
      nmax = fmaxf(nmax, sc[cy + 1][cx + 1]);
      const bool keep = s >= fmaxf(nmax, 1e-9f);
      const bool inside =
          y >= margin && y < h - margin && x >= margin && x < w - margin;
      out = (keep && inside) ? s : 0.f;
      v.score[(size_t)y * w + x] = out;
    }
    val[j] = out;
  }
  for (int r = 0; r < v.rounds; ++r) {
    float bv = val[0];
    int bi = tid;
#pragma unroll
    for (int j = 1; j < kPer; ++j)
      if (val[j] > bv) {
        bv = val[j];
        bi = tid + kThreads * j;
      }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      take_better(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
                  __shfl_xor_sync(0xffffffffu, bi, off));
    if (lane == 0) {
      red_v[warp] = bv;
      red_i[warp] = bi;
    }
    __syncthreads();
    // every warp merges the 8 warp winners, so every thread holds the pick
    bv = red_v[lane & 7];
    bi = red_i[lane & 7];
#pragma unroll
    for (int off = 4; off > 0; off >>= 1)
      take_better(bv, bi, __shfl_xor_sync(0xffffffffu, bv, off),
                  __shfl_xor_sync(0xffffffffu, bi, off));
    if (tid == 0) {
      v.raw[r * v.cells + c] = bv;
      v.pos[r * v.cells + c] = bi;
    }
#pragma unroll
    for (int j = 0; j < kPer; ++j)
      if (bi == tid + kThreads * j) val[j] = -1.f;
    __syncthreads();  // red_v and red_i are rewritten by the next round
  }
}

}  // namespace

// imgs[n]: f32 level images; dims: (h, w) of each level, then each level's
// rank rounds; planes: f32[2 * sum(h*w)], every level's strength, then
// every level's score; ints: int32[flags + sum(rounds * cells)], every
// level's 30x30 fallback flags, then every level's pos[rounds, cells];
// raw: f32[sum(rounds * cells)].
extern "C" int fast_rank_levels(int n, const void* const* imgs,
                                const int* dims, void* planes, void* ints,
                                void* raw, int cell, int margin, float ini_th,
                                float min_th, void* stream) {
  if (n < 1 || n > kMaxLevels || cell < 1) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  size_t total_px = 0, total_flags = 0;
  for (int l = 0; l < n; ++l) {
    const int h = dims[2 * l], w = dims[2 * l + 1];
    if (h < 1 || w < 1 || dims[2 * n + l] < 0)
      return (int)cudaErrorInvalidValue;
    total_px += (size_t)h * w;
    total_flags += (size_t)((h + cell - 1) / cell) * ((w + cell - 1) / cell);
  }
  float* strength = (float*)planes;
  float* score = strength + total_px;
  int* flags = (int*)ints;
  int* pos = flags + total_flags;
  Levels L;
  L.n = n;
  size_t px = 0, fl = 0, rk = 0;
  int tiles = 0, cells = 0;
  for (int l = 0; l < n; ++l) {
    Level& v = L.lv[l];
    v.h = dims[2 * l];
    v.w = dims[2 * l + 1];
    v.rounds = dims[2 * n + l];
    v.img = (const float*)imgs[l];
    v.strength = strength + px;
    v.score = score + px;
    v.flags = flags + fl;
    v.raw = (float*)raw + rk;
    v.pos = pos + rk;
    v.tiles_x = (v.w + TX - 1) / TX;
    v.tile0 = tiles;
    tiles += v.tiles_x * ((v.h + TY - 1) / TY);
    v.cells_x = (v.w + RC - 1) / RC;
    v.cells = v.cells_x * ((v.h + RC - 1) / RC);
    v.cell0 = cells;
    cells += v.cells;
    v.flags_x = (v.w + cell - 1) / cell;
    v.vec = v.w % 4 == 0 && (uintptr_t)v.img % 16 == 0;
    px += (size_t)v.h * v.w;
    fl += (size_t)v.flags_x * ((v.h + cell - 1) / cell);
    rk += (size_t)v.rounds * v.cells;
  }
  cudaError_t err = cudaMemsetAsync(flags, 0, sizeof(int) * total_flags, st);
  if (err != cudaSuccess) return (int)err;
  strength_kernel<<<tiles, kThreads, 0, st>>>(L, cell, ini_th);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  nms_rank_kernel<<<cells, kThreads, 0, st>>>(L, cell, margin, ini_th, min_th);
  return (int)cudaGetLastError();
}
