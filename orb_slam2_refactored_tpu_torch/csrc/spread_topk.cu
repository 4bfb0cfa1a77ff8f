// The rank-boosted global top-k of every pyramid level, with the clamps,
// the level-0 coordinates and the level ids, in one launch a frame
// (kernel K9).
//
// Replaces, in the JAX package (orb_slam2_refactored_tpu/):
//   - the global top-k of `select_spread_topk` (ops/orb.py:146-212: the
//     keys at :193, `jax.lax.top_k` at :203, the decode at :204-212), whose
//     rank rounds kernel K2 already runs (`csrc/fast.cu`);
//   - the per-level clamps to the edge margin, the level-0 coordinates and
//     the level ids of `OrbExtractor._extract_impl_pyr` (ops/orb.py:520-540).
// The plain PyTorch version (`ops/orb.py::spread_topk_levels_plain`) runs
// ~30 torch operations a level in a Python loop, among them a radix sort.
//
// What it computes. Level l's candidates are K2's rank rounds, raw f32 and
// pos int32 [rounds, C] (C cells of 32 x 32 px). Candidate i = r C + c of
// round r is keyed boost[r] + raw, boost[r] = 1e6 max(rank_rounds - r, 0),
// when raw > 0 (a corner), and -1 otherwise. The k largest keys are taken,
// equal keys lowest flat index first (`jax.lax.top_k`'s order), and
// decoded as `topk_from_ranks` decodes them: cell c = i mod C, in-cell
// index p = pos[i], y = (c / wc) 32 + p / 32 and x = (c mod wc) 32 + p mod
// 32, clamped into the level, then to [margin, size - 1 - margin]; the
// response raw[i], valid = key > 0, the level-0 coordinates (x, y) times
// the level's scale as one f32 product each, and the level id. The output
// slot of level l's keypoints starts at the sum of the earlier budgets.
//
// What bounds it on the H100. It reads 8 bytes a candidate (1,500 on the
// bench's VGA level 0, ~4,700 a frame) and writes 25 bytes a keypoint
// (1000 a frame): ~60 KB, 0.02 us at 3.35 TB/s; a sort of n keys is
// n log2 n compares. So nothing but latency bounds it: one launch, a
// block of 1024 threads a level (so up to 16 blocks run side by side), the
// level's (key, index) pairs packed into one 64-bit word each (the key's
// order-preserving bits above the complemented index, so one compare
// orders keys descending and ties by ascending index) and sorted in
// shared memory by a bitonic sort over the next power of two (~66
// compare-exchange steps for 2,048 slots), then the first k decoded and
// written. The sort buffer holds at most 8,192 candidates a level
// (`SPREAD_MAX_KEYS` in ops/orb.py, which raises past it).
// Every value written is an exact integer or one f32 add or product, so
// the outputs equal the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxKeys = 8192;  // `SPREAD_MAX_KEYS` in ops/orb.py
constexpr int kThreads = 1024;

struct TopkLevel {
  const float* raw;
  const int* pos;
  int h, w, k, rounds, cells, cells_x, level, out0, slots;
  float scale;
};

struct TopkArgs {
  TopkLevel lv[kMaxLevels];
  int cell, rank_rounds, margin;
  int* ys;
  int* xs;
  float* xy;
  int* level;
  float* resp;
  unsigned char* valid;
};

// f32 bits whose unsigned order is the floats' order
__device__ __forceinline__ uint32_t ordered_bits(float f) {
  const uint32_t u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered_bits(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__global__ void __launch_bounds__(kThreads)
spread_topk_kernel(const __grid_constant__ TopkArgs a) {
  extern __shared__ unsigned long long s_key[];
  const TopkLevel& v = a.lv[blockIdx.x];
  if (v.k <= 0) return;
  const int n = v.rounds * v.cells, P = v.slots, tid = threadIdx.x;
  for (int i = tid; i < P; i += kThreads) {
    unsigned long long word = 0;  // padding: below every candidate
    if (i < n) {
      const int r = i / v.cells;
      const float raw = v.raw[i];
      const float boost =
          1e6f * (float)(a.rank_rounds - r > 0 ? a.rank_rounds - r : 0);
      const float key = raw > 0.f ? __fadd_rn(boost, raw) : -1.f;
      word = ((unsigned long long)ordered_bits(key) << 32) |
             (uint32_t)(0xffffffffu - (uint32_t)i);
    }
    s_key[i] = word;
  }
  __syncthreads();
  // bitonic sort, descending
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P; i += kThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long x = s_key[i], y = s_key[j];
          const bool down = (i & size) == 0;
          if (down ? x < y : x > y) {
            s_key[i] = y;
            s_key[j] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int t = tid; t < v.k; t += kThreads) {
    const unsigned long long word = s_key[t];
    const int i = (int)(0xffffffffu - (uint32_t)(word & 0xffffffffu));
    const float key = from_ordered_bits((uint32_t)(word >> 32));
    const int c = i % v.cells, p = v.pos[i];
    int y = (c / v.cells_x) * a.cell + p / a.cell;
    int x = (c % v.cells_x) * a.cell + p % a.cell;
    y = min(y, v.h - 1);
    x = min(x, v.w - 1);
    y = min(max(y, a.margin), v.h - 1 - a.margin);
    x = min(max(x, a.margin), v.w - 1 - a.margin);
    const int o = v.out0 + t;
    a.ys[o] = y;
    a.xs[o] = x;
    a.xy[2 * o] = __fmul_rn((float)x, v.scale);
    a.xy[2 * o + 1] = __fmul_rn((float)y, v.scale);
    a.level[o] = v.level;
    a.resp[o] = v.raw[i];
    a.valid[o] = key > 0.f;
  }
}

}  // namespace

// Every level's top-k in one launch. raws, poss: per level the rank rounds
// [rounds, C]; params: per level (h, w, k, rounds, C, level id); scales:
// per level the level-0 scale; K: the sum of the budgets, the length of
// every output.
extern "C" int spread_topk_levels(int n, const void* const* raws,
                                  const void* const* poss, const int* params,
                                  const float* scales, int cell,
                                  int rank_rounds, int margin, int K,
                                  void* ys, void* xs, void* xy, void* level,
                                  void* resp, void* valid, void* stream) {
  if (n < 1 || n > kMaxLevels || cell < 1 || K < 0)
    return (int)cudaErrorInvalidValue;
  TopkArgs a;
  a.cell = cell;
  a.rank_rounds = rank_rounds;
  a.margin = margin;
  a.ys = (int*)ys;
  a.xs = (int*)xs;
  a.xy = (float*)xy;
  a.level = (int*)level;
  a.resp = (float*)resp;
  a.valid = (unsigned char*)valid;
  int out = 0, slots = 1;
  for (int l = 0; l < n; ++l) {
    TopkLevel& v = a.lv[l];
    const int* q = params + 6 * l;
    v.raw = (const float*)raws[l];
    v.pos = (const int*)poss[l];
    v.h = q[0];
    v.w = q[1];
    v.k = q[2];
    v.rounds = q[3];
    v.cells = q[4];
    v.level = q[5];
    v.scale = scales[l];
    v.cells_x = (v.w + cell - 1) / cell;
    v.out0 = out;
    const long long keys = (long long)v.rounds * v.cells;
    if (v.h < 1 || v.w < 1 || v.k < 0 || v.rounds < 0 ||
        v.cells != v.cells_x * ((v.h + cell - 1) / cell) ||
        (v.k > 0 && (keys < v.k || keys > kMaxKeys)))
      return (int)cudaErrorInvalidValue;
    v.slots = 1;
    while (v.slots < keys) v.slots <<= 1;
    if (v.k > 0 && v.slots > slots) slots = v.slots;
    out += v.k;
  }
  if (out != K) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  const int smem = slots * (int)sizeof(unsigned long long);
  // above 48 KB of dynamic shared memory only after opting in
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        spread_topk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  spread_topk_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
