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
// What bounds it on the H100. It reads 4 bytes a candidate (1,500 on the
// bench's VGA level 0, ~4,700 a frame) and the pos and 25 bytes out a
// keypoint (1000 a frame): ~60 KB, 0.02 us at 3.35 TB/s. So nothing but
// latency bounds it, and the design counts barriers: one launch, a block
// of 1024 threads a level (so up to 16 blocks run side by side), each
// thread keeping a contiguous run of at most 8 candidates' keys in
// registers; then select, and order only what is selected:
//   - the k-th largest key T by a radix select over the key's 32
//     order-preserving bits, 8 bits a pass: a shared histogram of the
//     candidates still in the running (warp-aggregated: one atomic a digit
//     a warp, `__match_any_sync`), warp 0 finds the digit where the count
//     from the top reaches k; 2 barriers a pass;
//   - the k selected compacted in index order by one block scan of two
//     counts a thread (keys above T; keys equal to T, of which the first
//     `need` in index order are taken, `jax.lax.top_k`'s tie order), each
//     written as one 64-bit word (the key's bits above the complemented
//     index, so one compare orders keys descending and ties by ascending
//     index);
//   - each selected word's rank is the count of selected words above it
//     (up to kRankMax selected a level: a group of threads a word, the
//     count split over the group and added by shuffles), and the thread
//     that holds it decodes and writes output slot `rank`. Past kRankMax a
//     bitonic sort of the selected words (padded to a power of two) orders
//     them.
// That is 12 barriers a level where a bitonic sort of every candidate took
// ~66 at VGA's level 0. The register path takes a level of at most 8,192
// candidates (`SPREAD_MAX_KEYS` in ops/orb.py).
//
// Larger levels (a camera past ~1920x1080 at 1000 features: 32,640
// candidates on 3840x2160's level 0) take a second kernel, launched after
// the first on the same stream, whose block of a level keeps no key in
// registers: each radix pass reads the level's raw responses again from
// device memory (130 KB at 32,640 keys, resident in the L2 after the first
// pass) a candidate a thread, neighbouring threads on neighbouring
// candidates; the compaction reads a contiguous run of candidates a
// thread twice (to count, then to write) and scans the two counts as one
// 64-bit word, so no count is capped. It selects and orders exactly as
// the register path does, so the outputs are the same. A level holds at
// most 2^24 candidates (`SPREAD_MAX_KEYS_LARGE`) and a budget of at most
// 16,384 (`SPREAD_MAX_BUDGET`: its selected words, padded to a power of
// two, fill at most 128 KB of shared memory); ops/orb.py raises past
// either.
// Every value written is an exact integer or one f32 add or product, so
// the outputs equal the plain version's bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kMaxKeys = 8192;  // `SPREAD_MAX_KEYS` in ops/orb.py
constexpr int kMaxKeysLarge = 1 << 24;  // `SPREAD_MAX_KEYS_LARGE`
constexpr int kThreads = 1024;
constexpr int kPer = kMaxKeys / kThreads;  // candidates a thread, at most
constexpr int kRankMax = 1024;  // selected a level ranked by counting
constexpr int kParams = 8;      // `SPREAD_PARAMS` in ops/orb.py

struct TopkLevel {
  int off, h, w, k, rounds, cells, cells_x, level, out0, slots;
  float scale;
};

struct TopkArgs {
  TopkLevel lv[kMaxLevels];
  const float* raw;   // every level's rank rounds, level l from lv[l].off
  const int* pos;
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

// keypoint `word` (a selected candidate) of level v into output slot t
__device__ __forceinline__ void decode(const TopkArgs& a, const TopkLevel& v,
                                       unsigned long long word, int t) {
  const int i = (int)(0xffffffffu - (uint32_t)(word & 0xffffffffu));
  const float key = from_ordered_bits((uint32_t)(word >> 32));
  const int c = i % v.cells, p = a.pos[v.off + i];
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
  a.resp[o] = a.raw[v.off + i];
  a.valid[o] = key > 0.f;
}

// the key of level v's candidate i (of round i / C): boost + raw for a
// corner, -1 otherwise, as order-preserving bits
__device__ __forceinline__ uint32_t key_at(const TopkArgs& a,
                                           const TopkLevel& v, int i) {
  const int r = i / v.cells;
  const float raw = a.raw[v.off + i];
  const float boost =
      1e6f * (float)(a.rank_rounds - r > 0 ? a.rank_rounds - r : 0);
  return ordered_bits(raw > 0.f ? __fadd_rn(boost, raw) : -1.f);
}

// warp 0, after a radix pass's histogram `hist` of the keys still in the
// running: the digit at which the count from the top reaches kk, into
// s_pick (the prefix with it, and how many of the keys with that prefix
// are still to take)
__device__ __forceinline__ void pick_digit(const unsigned int* hist,
                                           int lane, uint32_t prefix,
                                           uint32_t kk, int shift,
                                           unsigned int* s_pick) {
  // lane L holds bins 255 - 8L down to 248 - 8L
  unsigned int c[8], s = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    c[q] = hist[255 - 8 * lane - q];
    s += c[q];
  }
  unsigned int incl = s;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  const unsigned int excl = incl - s;
  if (excl < kk && kk <= incl) {  // exactly one lane
    unsigned int run = excl;
    int d = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      if (d == 0 && run + c[q] >= kk) d = 256 + 255 - 8 * lane - q;
      if (d == 0) run += c[q];
    }
    s_pick[0] = prefix | ((uint32_t)(d - 256) << shift);
    s_pick[1] = kk - run;
  }
}

// the k selected words of level v, compacted into s_sel[0, k) by every
// thread of the block: each decoded into output slot `rank`, its rank
// counted (k <= kRankMax) or found by a bitonic sort
__device__ __forceinline__ void order_selected(const TopkArgs& a,
                                               const TopkLevel& v,
                                               unsigned long long* s_sel,
                                               int tid) {
  const int k = v.k;
  if (k <= kRankMax) {
    __syncthreads();
    // g threads a selected word: its rank, the selected words above it
    int g = 1;
    while (g < 32 && 2 * g * k <= kThreads) g <<= 1;
    const int e = tid / g, m = tid % g;
    const unsigned long long word = e < k ? s_sel[e] : 0ull;
    unsigned int rank = 0;
    if (e < k)
      for (int j = m; j < k; j += g) rank += s_sel[j] > word;
    for (int o = 1; o < g; o <<= 1)
      rank += __shfl_xor_sync(0xffffffffu, rank, o);
    if (e < k && m == 0) decode(a, v, word, (int)rank);
    return;
  }
  // past kRankMax: a bitonic sort of the selected, descending; padding
  // (0) is below every word
  const int P = v.slots;
  for (int i = k + tid; i < P; i += kThreads) s_sel[i] = 0ull;
  __syncthreads();
  for (int size = 2; size <= P; size <<= 1) {
    for (int stride = size >> 1; stride > 0; stride >>= 1) {
      for (int i = tid; i < P; i += kThreads) {
        const int j = i ^ stride;
        if (j > i) {
          const unsigned long long x = s_sel[i], y = s_sel[j];
          const bool down = (i & size) == 0;
          if (down ? x < y : x > y) {
            s_sel[i] = y;
            s_sel[j] = x;
          }
        }
      }
      __syncthreads();
    }
  }
  for (int t = tid; t < k; t += kThreads) decode(a, v, s_sel[t], t);
}

// levels of at most kMaxKeys candidates, each thread's keys in registers
__global__ void __launch_bounds__(kThreads)
spread_topk_kernel(const __grid_constant__ TopkArgs a) {
  extern __shared__ unsigned long long s_sel[];  // the selected words
  __shared__ unsigned int s_hist[4][256];        // a histogram a pass
  __shared__ unsigned int s_warp[32];
  __shared__ unsigned int s_pick[2];
  const TopkLevel& v = a.lv[blockIdx.x];
  const int n = v.rounds * v.cells;
  if (v.k <= 0 || n > kMaxKeys) return;  // the large kernel's level
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int per = (n + kThreads - 1) / kThreads;
  const int i0 = tid * per;
  // the keys' order-preserving bits, candidates i0 .. i0 + per - 1
  uint32_t key[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    key[j] = 0;
    const int i = i0 + j;
    if (j < per && i < n) key[j] = key_at(a, v, i);
  }
  s_hist[tid >> 8][tid & 255] = 0;
  __syncthreads();
  // radix select: T = the k-th largest key; kk of the keys equal to T are
  // taken
  uint32_t prefix = 0, kk = (uint32_t)v.k;
#pragma unroll
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t high = pass == 0 ? 0u : 0xffffffffu << (shift + 8);
    unsigned int* hist = s_hist[pass];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      if (j < per) {  // the same for every thread: the ballot is whole
        const bool in = i0 + j < n && (key[j] & high) == prefix;
        const unsigned int who = __ballot_sync(0xffffffffu, in);
        if (in) {
          const uint32_t d = (key[j] >> shift) & 255u;
          const unsigned int same = __match_any_sync(who, d);
          if (lane == __ffs(same) - 1) atomicAdd(hist + d, __popc(same));
        }
      }
    }
    __syncthreads();
    if (warp == 0) pick_digit(hist, lane, prefix, kk, shift, s_pick);
    __syncthreads();
    prefix = s_pick[0];
    kk = s_pick[1];
  }
  // compaction in index order: a candidate's slot is the keys above T
  // before it plus the ties before it, at most kk
  unsigned int above = 0, ties = 0;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    if (j < per && i0 + j < n) {
      above += key[j] > prefix;
      ties += key[j] == prefix;
    }
  }
  const unsigned int mine = (above << 16) | ties;  // each <= 8192
  unsigned int incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned int t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned int tot = s_warp[lane];
    unsigned int x = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned int t = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += t;
    }
    s_warp[lane] = x - tot;
  }
  __syncthreads();
  const unsigned int before = s_warp[warp] + incl - mine;
  unsigned int a_before = before >> 16, t_before = before & 0xffffu;
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = i0 + j;
    if (j < per && i < n) {
      const unsigned long long word =
          ((unsigned long long)key[j] << 32) |
          (uint32_t)(0xffffffffu - (uint32_t)i);
      if (key[j] > prefix) {
        s_sel[a_before + min(t_before, kk)] = word;
        ++a_before;
      } else if (key[j] == prefix) {
        if (t_before < kk) s_sel[a_before + t_before] = word;
        ++t_before;
      }
    }
  }
  order_selected(a, v, s_sel, tid);
}

// levels of more than kMaxKeys candidates: the same select and order, the
// keys read again from device memory wherever they are needed
__global__ void __launch_bounds__(kThreads)
spread_topk_large_kernel(const __grid_constant__ TopkArgs a) {
  extern __shared__ unsigned long long s_sel[];  // the selected words
  __shared__ unsigned int s_hist[4][256];        // a histogram a pass
  __shared__ unsigned long long s_warp[32];
  __shared__ unsigned int s_pick[2];
  const TopkLevel& v = a.lv[blockIdx.x];
  const int n = v.rounds * v.cells;
  if (v.k <= 0 || n <= kMaxKeys) return;  // the register kernel's level
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  s_hist[tid >> 8][tid & 255] = 0;
  __syncthreads();
  uint32_t prefix = 0, kk = (uint32_t)v.k;
  for (int pass = 0; pass < 4; ++pass) {
    const int shift = 24 - 8 * pass;
    const uint32_t high = pass == 0 ? 0u : 0xffffffffu << (shift + 8);
    unsigned int* hist = s_hist[pass];
    // a candidate a thread, coalesced; the bound is the same for every
    // thread, so the ballot is whole
    for (int base = 0; base < n; base += kThreads) {
      const int i = base + tid;
      const uint32_t key = i < n ? key_at(a, v, i) : 0u;
      const bool in = i < n && (key & high) == prefix;
      const unsigned int who = __ballot_sync(0xffffffffu, in);
      if (in) {
        const uint32_t d = (key >> shift) & 255u;
        const unsigned int same = __match_any_sync(who, d);
        if (lane == __ffs(same) - 1) atomicAdd(hist + d, __popc(same));
      }
    }
    __syncthreads();
    if (warp == 0) pick_digit(hist, lane, prefix, kk, shift, s_pick);
    __syncthreads();
    prefix = s_pick[0];
    kk = s_pick[1];
  }
  // compaction in index order over a contiguous run a thread; the counts
  // above and tied as one 64-bit word (ties in the low half, < 2^24)
  const int per = (n + kThreads - 1) / kThreads;
  const int i0 = min(tid * per, n), i1 = min(i0 + per, n);
  unsigned int above = 0, ties = 0;
  for (int i = i0; i < i1; ++i) {
    const uint32_t key = key_at(a, v, i);
    above += key > prefix;
    ties += key == prefix;
  }
  const unsigned long long mine = ((unsigned long long)above << 32) | ties;
  unsigned long long incl = mine;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long t = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += t;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const unsigned long long tot = s_warp[lane];
    unsigned long long x = tot;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long t = __shfl_up_sync(0xffffffffu, x, o);
      if (lane >= o) x += t;
    }
    s_warp[lane] = x - tot;
  }
  __syncthreads();
  const unsigned long long before = s_warp[warp] + incl - mine;
  unsigned int a_before = (unsigned int)(before >> 32);
  unsigned int t_before = (unsigned int)(before & 0xffffffffull);
  for (int i = i0; i < i1; ++i) {
    const uint32_t key = key_at(a, v, i);
    const unsigned long long word = ((unsigned long long)key << 32) |
                                    (uint32_t)(0xffffffffu - (uint32_t)i);
    if (key > prefix) {
      s_sel[a_before + min(t_before, kk)] = word;
      ++a_before;
    } else if (key == prefix) {
      if (t_before < kk) s_sel[a_before + t_before] = word;
      ++t_before;
    }
  }
  order_selected(a, v, s_sel, tid);
}

}  // namespace

// Every level's top-k: one launch of the register kernel for the levels of
// at most kMaxKeys candidates, and one of the large kernel after it where
// a level has more. raw, pos: every level's rank rounds in one buffer
// each; params: per level kParams ints (the offset of its rank rounds in
// both buffers, h, w, k, rounds, C, level id, the f32 bits of its level-0
// scale); K: the sum of the budgets; out: int32 [6 K + ceil(K / 4)]
// holding ys, xs, level ids, xy (f32 [K, 2]), responses (f32) and valid
// (K bytes), in that order; smem: bytes of the selected words of the
// largest level (`ops/orb.py::SpreadPlan`).
extern "C" int spread_topk_levels(int n, const void* raw, const void* pos,
                                  const int* params, int cell,
                                  int rank_rounds, int margin, int K,
                                  void* out, int smem, void* stream) {
  if (n < 1 || n > kMaxLevels || cell < 1 || K < 0 || smem < 0)
    return (int)cudaErrorInvalidValue;
  TopkArgs a;
  a.raw = (const float*)raw;
  a.pos = (const int*)pos;
  a.cell = cell;
  a.rank_rounds = rank_rounds;
  a.margin = margin;
  int* o = (int*)out;
  a.ys = o;
  a.xs = o + K;
  a.level = o + 2 * K;
  a.xy = (float*)(o + 3 * K);
  a.resp = (float*)(o + 5 * K);
  a.valid = (unsigned char*)(o + 6 * K);
  int total = 0, need = 0, small = 0, large = 0;
  for (int l = 0; l < n; ++l) {
    TopkLevel& v = a.lv[l];
    const int* q = params + kParams * l;
    v.off = q[0];
    v.h = q[1];
    v.w = q[2];
    v.k = q[3];
    v.rounds = q[4];
    v.cells = q[5];
    v.level = q[6];
    memcpy(&v.scale, q + 7, sizeof(float));
    v.cells_x = (v.w + cell - 1) / cell;
    v.out0 = total;
    const long long keys = (long long)v.rounds * v.cells;
    if (v.off < 0 || v.h < 1 || v.w < 1 || v.k < 0 || v.rounds < 0 ||
        v.cells != v.cells_x * ((v.h + cell - 1) / cell) ||
        (v.k > 0 && (keys < v.k || keys > kMaxKeysLarge)))
      return (int)cudaErrorInvalidValue;
    if (v.k > 0) ++(keys > kMaxKeys ? large : small);
    v.slots = 1;
    while (v.slots < v.k) v.slots <<= 1;
    const int bytes = (int)sizeof(unsigned long long) *
                      (v.k > kRankMax ? v.slots : v.k);
    if (bytes > need) need = bytes;
    total += v.k;
  }
  if (total != K || smem < need) return (int)cudaErrorInvalidValue;
  if (K == 0) return 0;
  // above 48 KB of dynamic shared memory only after opting in
  if (smem > 48 * 1024) {
    const void* kernels[2] = {(const void*)spread_topk_kernel,
                              (const void*)spread_topk_large_kernel};
    for (int f = 0; f < 2; ++f) {
      const cudaError_t e = cudaFuncSetAttribute(
          kernels[f], cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (e != cudaSuccess) return (int)e;
    }
  }
  if (small > 0) {
    spread_topk_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(a);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  if (large > 0)
    spread_topk_large_kernel<<<n, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
