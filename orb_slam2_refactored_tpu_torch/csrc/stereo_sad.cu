// Stereo association after the Hamming best-2 (kernel B9): from K1's
// (idx, best) to the frame's (u_right, depth, ok) in one launch, with no
// host read; and the SAD refinement alone (`stereo_sad`), its phase (c).
//
// Replaces: `refine_subpixel_pyramid` of the JAX package
// (orb_slam2_refactored_tpu/ops/stereo.py:120-221) together with
// `stereo_match`'s tail after the best-2 (:46-59). XLA gathers the matched
// u, builds the integer level coordinates, flattens both pyramids into a
// zero-padded [sum H, W0] plane, gathers 11 rows of it a keypoint, stacks
// the 11 windows ([N, 11, 11, 11]), reduces them, and sorts twice for the
// distance median and the SAD nanmedian.
//
// What bounds it on the H100: neither bytes nor arithmetic. A VGA stereo
// frame's 1000 keypoints read ~1.0 MB of f32 pixels (the union of their
// 11x11 patches and 11x21 strips, 0.3 us at 3.35 TB/s) and need ~5.3 M f32
// operations (0.02 us). What is left is latency: a keypoint's loads, then
// a chain of 121 dependent adds a lane, then one CTA's median of the SADs
// over all keypoints, which waits for every keypoint.
//
// Design:
//   - one warp a keypoint, 8 warps a block (1000 keypoints: 125 blocks),
//     and one block more for the distance median (126 blocks, one wave on
//     132 SMs). Per keypoint, in the plain version's order of
//     operations (`associate_from_best2_plain`, bit-equal to this file):
//     (a) ok1 = best <= max_dist, the matched u = r_x[clamp(idx)] or -1;
//     (b) the level coordinates: inv = 1 / sf[lvl] (one IEEE division),
//         v * inv rounded half-to-even (rintf under the default rounding
//         mode, as torch.round and jnp.round), clipped to the level;
//     (c) the SAD at 11 disparities: each lane issues all of its patch and
//         strip loads (4 + 8) before storing any to shared memory, so the
//         warp waits for one round trip; lane r < 11 sums window r over
//         the 121 offsets in row-major order, one f32 add at a time (the
//         plain version adds in that order); the argmin, lowest index on
//         ties as `jnp.argmin`, by a butterfly of (value, index) shuffles;
//         the parabola and its gates;
//     (d) ur_ref = ur_lvl * sf[lvl], disparity = l_x - ur_ref, the gates
//         (0.01 < disparity < bf, |delta| <= 1, no border argmin). The file
//         is built with -fmad=false: `l_x - ur_lvl * sf` must round the
//         product before the subtraction, as torch and XLA do.
//     The row writes u = ur_ref and depth = bf / max(disparity, 0.01) as if
//     it were accepted, its SAD to scratch and its gate to the ok byte.
//   - (e) the distance median depends on K1's distances alone, so the extra
//     block takes it while the others take the SADs: `jnp.median` of best,
//     misses at BIG, the midpoint of the two middle values in f32; the
//     bound c * med, c = (float)(1.5 * 1.4) as torch and JAX round the
//     product of the two literals, goes to a scratch f32.
//   - the grid meets in the last block to finish: every block fences its
//     writes and takes a ticket; the block that takes the last one runs
//     (f) over all N and resets the ticket, so no memset is launched:
//     good = ok1 & (float(best) < bound) & gate; the SAD nanmedian over the
//     good rows (none: inf, no filter); good &= sad < c * med; rejected
//     rows get -1. The ticket and the scratch f32 are one buffer per
//     device, owned by the wrapper, so two launches may not run at once:
//     the port issues every launch on the tensors' current stream, one
//     after the other.
//   - both medians take their middle values from an order-preserving key
//     in shared memory: counted into 2048 buckets of equal key ranges from
//     the least key, the bucket of the lower middle rank found by a block
//     scan; a bucket of one key value is the answer, one of at most 32 keys
//     is gathered and ranked by counting, a larger one becomes the next
//     range (the distances at VGA take two rounds, the SADs one); then the
//     next key up when the upper middle value lies past that bucket. It is
//     exact, so it is bit-equal to indexing a sort.
//   - the SAD of a keypoint that fails (e) is taken at its matched u, where
//     the plain version takes it at u = -1 (clipped): such rows are
//     rejected in both, so the outputs agree and only the scratch differs.
//   - the levels are read in place through a by-value table of each level's
//     left and right image and shape (as K2 and K3); the scale factors are
//     the caller's device tensor, read through its pointer; bf, max_dist and
//     BIG go by value, so nothing is uploaded. Coordinates are clamped again
//     in the kernel, so no input can read outside a level.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 16;
constexpr int kW = 5;                 // half patch
constexpr int kR = 5;                 // half disparity range
constexpr int kP = 2 * kW + 1;        // patch side, 11
constexpr int kS = kP + 2 * kR;       // strip width, 21
constexpr int kD = 2 * kR + 1;        // disparities, 11
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;
// both filters' factor: the f32 that torch and JAX round 1.5 * 1.4 to
constexpr float kC = (float)(1.5 * 1.4);
// the static shared memory of `associate_kernel`, for the dynamic limit
constexpr int kStaticSmem =
    kWarps * (kP * kP + kP * kS) * 4 + (8 * kThreads + 32) * 4 + 256;

struct SLevel {
  const float* left;
  const float* right;
  int h;
  int w;
};

struct SLevels {
  SLevel lv[kMaxLevels];
  int n;
};

struct SAssoc {
  SLevels L;
  const float* sf;       // f32[L.n], the caller's scale factors
  const float* l_xy;     // f32[N, 2]
  const int* l_level;    // i32[N]
  const float* r_xy;     // f32[M, 2]
  const int* idx;        // i32[N], K1's best index
  const int* best;       // i32[N], K1's best distance
  int N, M;
  float bf;
  int max_dist, big;
  float* out_u;          // f32[N]
  float* out_depth;      // f32[N]
  float* sad;            // f32[N] scratch
  unsigned char* ok;     // bool[N]; the gate until the last block ends
  unsigned int* ticket;  // zero between launches
  float* thr_d;          // the distance bound, from the extra block
};

struct SadOut {
  float ur;   // refined right u at the keypoint's level
  float s0;   // SAD at the clipped argmin
  bool ok;    // |delta| <= 1 and an interior argmin
};

// One warp: the 11 SADs of the left patch centred at (y, x) of level `lv`
// against the right windows centred at (y, u - 5 + r), the argmin, the
// parabola and its gates. Every lane returns the same result. P and S are
// this warp's shared buffers.
__device__ __forceinline__ SadOut sad_warp(const SLevel& lv, int y, int x,
                                           int u, float* P, float* S,
                                           int lane) {
  const int w = lv.w;
  const float* pl = lv.left + (size_t)(y - kW) * w + (x - kW);
  const float* pr = lv.right + (size_t)(y - kW) * w + (u - kW - kR);
  float pv[4], sv[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = lane + 32 * j;
    pv[j] = k < kP * kP ? __ldg(pl + (k / kP) * w + k % kP) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int k = lane + 32 * j;
    sv[j] = k < kP * kS ? __ldg(pr + (k / kS) * w + k % kS) : 0.f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (lane + 32 * j < kP * kP) P[lane + 32 * j] = pv[j];
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (lane + 32 * j < kP * kS) S[lane + 32 * j] = sv[j];
  __syncwarp();
  float s = INFINITY;
  if (lane < kD) {
    const float cl = P[kW * kP + kW];
    const float cr = S[kW * kS + lane + kW];
    float a = 0.f;
#pragma unroll
    for (int dy = 0; dy < kP; ++dy) {
#pragma unroll
      for (int dx = 0; dx < kP; ++dx)
        a += fabsf((P[dy * kP + dx] - cl) - (S[dy * kS + lane + dx] - cr));
    }
    s = a;
  }
  // argmin over lanes 0..10 (the others hold +inf): (value, index)
  // lexicographically, so the lowest index wins a tie
  float v = s;
  int b = lane;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(kFull, v, o);
    const int ob = __shfl_xor_sync(kFull, b, o);
    if (ov < v || (ov == v && ob < b)) {
      v = ov;
      b = ob;
    }
  }
  const int bi = min(max(b, 1), kD - 2);
  const float sm = __shfl_sync(kFull, s, bi - 1);
  const float s0 = __shfl_sync(kFull, s, bi);
  const float sp = __shfl_sync(kFull, s, bi + 1);
  const float denom = (sm + sp) - 2.f * s0;
  // 2 marks a flat valley: rejected, as |delta| > 1 is
  const float delta = fabsf(denom) > 1e-6f ? (0.5f * (sm - sp)) / denom : 2.f;
  SadOut r;
  r.ur = ((float)u + (float)(bi - kR)) + fminf(fmaxf(delta, -1.f), 1.f);
  r.s0 = s0;
  r.ok = fabsf(delta) <= 1.f && b != 0 && b != kD - 1;
  return r;
}

// round half-to-even, then clip to [lo, hi] (NaN -> lo, as torch's
// `.long()` then clamp gives)
__device__ __forceinline__ int clip_round(float v, int lo, int hi) {
  const float r = rintf(v);
  if (!(r >= (float)lo)) return lo;
  if (r > (float)hi) return hi;
  return (int)r;
}

// order-preserving keys: unsigned order = numeric order
__device__ __forceinline__ unsigned int_key(int v) {
  return (unsigned)v ^ 0x80000000u;
}
__device__ __forceinline__ float int_of_key(unsigned k) {
  return (float)(int)(k ^ 0x80000000u);
}
__device__ __forceinline__ unsigned float_key(float f) {
  const unsigned b = __float_as_uint(f);
  return b ^ ((b >> 31) ? 0xffffffffu : 0x80000000u);
}
__device__ __forceinline__ float float_of_key(unsigned k) {
  return __uint_as_float(k ^ ((k >> 31) ? 0x80000000u : 0xffffffffu));
}

constexpr int kBuckets = 8 * kThreads;  // 2048, 8 a thread

struct Scratch {
  unsigned hist[kBuckets];
  unsigned list[32];  // the keys of one bucket
  unsigned wsum[kWarps][3];
  unsigned bucket, below, count, n_list, lo, hi;
};

// inclusive scan of one value a thread over the block (one barrier)
__device__ __forceinline__ unsigned block_scan(unsigned v, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned n = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += n;
  }
  if (lane == 31) sc.wsum[warp][0] = v;
  __syncthreads();
  for (int w = 0; w < warp; ++w) v += sc.wsum[w][0];
  return v;
}

// over the block, to every thread (one barrier): the least of a, the least
// of b and the sum of c
__device__ __forceinline__ void block_reduce(unsigned& a, unsigned& b,
                                             unsigned& c, Scratch& sc) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a = min(a, __shfl_xor_sync(kFull, a, o));
    b = min(b, __shfl_xor_sync(kFull, b, o));
    c += __shfl_xor_sync(kFull, c, o);
  }
  if (lane == 0) {
    sc.wsum[warp][0] = a;
    sc.wsum[warp][1] = b;
    sc.wsum[warp][2] = c;
  }
  __syncthreads();
  a = sc.wsum[0][0];
  b = sc.wsum[0][1];
  c = sc.wsum[0][2];
  for (int w = 1; w < kWarps; ++w) {
    a = min(a, sc.wsum[w][0]);
    b = min(b, sc.wsum[w][1]);
    c += sc.wsum[w][2];
  }
  __syncthreads();  // every thread has read wsum
}

// The keys of rank lo and hi (0-based; hi = lo or lo + 1) among key[i]
// with (bits[i] & want) == want, i < n, at least one. A window [a, b] of
// keys holds rank k; at first every key. Its keys are counted into 2048
// buckets of 2^s keys each ((v - a) >> s), and a block scan finds the
// bucket that holds rank k. A bucket of one key value (s = 0) is the
// answer; a bucket of at most 32 keys is gathered and ranked by counting;
// a larger one becomes the window (s falls by 11 a round, so three rounds
// at most). Then, when hi lies past lo's bucket, the least key above lo.
// Exact, so equal to indexing a sort. Every thread of the block calls it
// and gets both keys.
__device__ void select_pair(const unsigned* key, const unsigned char* bits,
                            unsigned want, int n, unsigned lo, unsigned hi,
                            Scratch& sc, unsigned& klo, unsigned& khi) {
  const int t = threadIdx.x;
  unsigned a = 0xffffffffu, nb = 0xffffffffu, cnt = 0;  // nb: ~max
  for (int i = t; i < n; i += kThreads)
    if ((bits[i] & want) == want) {
      a = min(a, key[i]);
      nb = min(nb, ~key[i]);
      ++cnt;
    }
#pragma unroll
  for (int j = 0; j < 8; ++j) sc.hist[8 * t + j] = 0;
  if (t == 0) sc.n_list = 0;
  block_reduce(a, nb, cnt, sc);
  unsigned b = ~nb, k = lo;
  while (a != b) {
    const int s = max(32 - __clz(b - a) - 11, 0);
#pragma unroll 4
    for (int i = t; i < n; i += kThreads) {
      const unsigned v = key[i];
      if ((bits[i] & want) == want && v >= a && v <= b)
        atomicAdd(&sc.hist[(v - a) >> s], 1u);
    }
    __syncthreads();
    unsigned h[8], mine = 0;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      h[j] = sc.hist[8 * t + j];
      sc.hist[8 * t + j] = 0;  // for the next round
      mine += h[j];
    }
    unsigned below = block_scan(mine, sc) - mine;
    if (below <= k && k < below + mine) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (below <= k && k < below + h[j]) {
          sc.bucket = 8 * t + j;
          sc.below = below;
          sc.count = h[j];
        }
        below += h[j];
      }
    }
    __syncthreads();
    const unsigned bucket = sc.bucket;
    k -= sc.below;
    cnt = sc.count;
    const unsigned first = a + (bucket << s);
    if (s > 0 && cnt <= 32u) {
      // gather the bucket's keys, rank them by counting
      for (int i = t; i < n; i += kThreads) {
        const unsigned v = key[i];
        if ((bits[i] & want) == want && v >= a && v <= b &&
            ((v - a) >> s) == bucket)
          sc.list[atomicAdd(&sc.n_list, 1u)] = v;
      }
      __syncthreads();
      if (t < (int)cnt) {
        const unsigned v = sc.list[t];
        unsigned r = 0;
        for (unsigned j = 0; j < cnt; ++j) {
          const unsigned u = sc.list[j];
          r += u < v || (u == v && j < (unsigned)t);
        }
        if (r == k) sc.lo = v;
        if (r == k + 1) sc.hi = v;
      }
      __syncthreads();
      klo = sc.lo;
      khi = sc.hi;
      if (hi == lo) khi = klo;
      if (hi == lo || k + 1 < cnt) return;
      a = b = klo;  // the next key up lies in a later bucket
      break;
    }
    // the bucket's keys are the new window (one value when s = 0)
    a = first;
    b = (unsigned)min((unsigned long long)b,
                      (unsigned long long)first + ((1ull << s) - 1));
  }
  // rank k of the window [a, a] of cnt equal keys, or the gathered klo
  klo = a;
  if (hi == lo || k + 1 < cnt) {
    khi = a;
    return;
  }
  unsigned m = 0xffffffffu, unused = 0, zero = 0;
  for (int i = t; i < n; i += kThreads)
    if ((bits[i] & want) == want && key[i] > a) m = min(m, key[i]);
  block_reduce(m, unused, zero, sc);
  khi = m;
}

// (e) the distance median over every row, misses at BIG, by the extra
// block while the others take the SADs: the bound c * med into *A.thr_d.
// dyn holds N keys and N flags.
__device__ void distance_bound(const SAssoc& A, unsigned char* dyn,
                               Scratch& sc) {
  const int N = A.N, t = threadIdx.x;
  unsigned* key = reinterpret_cast<unsigned*>(dyn);
  unsigned char* bits = dyn + 4 * (size_t)N;
#pragma unroll 4
  for (int i = t; i < N; i += kThreads) {
    const int b = A.best[i];
    key[i] = int_key(b <= A.max_dist ? b : A.big);
    bits[i] = 0;
  }
  __syncthreads();
  unsigned a, z;
  select_pair(key, bits, 0u, N, (N - 1) / 2, N / 2, sc, a, z);
  if (t == 0) *A.thr_d = kC * ((int_of_key(a) + int_of_key(z)) * 0.5f);
}

// (f) by the last block to finish (see the file note): the good rows, the
// median of their SADs, the rejections. dyn holds N keys and N flags.
__device__ void finish(const SAssoc& A, unsigned char* dyn, Scratch& sc) {
  const int N = A.N, t = threadIdx.x;
  unsigned* key = reinterpret_cast<unsigned*>(dyn);
  unsigned char* bits = dyn + 4 * (size_t)N;
  const float thr_d = __ldcg(A.thr_d);
  // every row once: the other blocks' writes from L2
  unsigned n_good = 0;
#pragma unroll 4
  for (int i = t; i < N; i += kThreads) {
    const int b = A.best[i];
    const bool good = b <= A.max_dist && (float)b < thr_d &&
                      __ldcg(A.ok + i) != 0;
    key[i] = float_key(__ldcg(A.sad + i));
    bits[i] = good;
    n_good += good;
  }
  {
    unsigned x = 0, y = 0;
    block_reduce(x, y, n_good, sc);
  }
  float med = INFINITY;  // no good SAD: no filter
  if (n_good > 0) {
    unsigned a, z;
    select_pair(key, bits, 1u, N, (n_good - 1) / 2, n_good / 2, sc, a, z);
    med = (float_of_key(a) + float_of_key(z)) * 0.5f;
  }
  const float thr_s = kC * med;
  for (int i = t; i < N; i += kThreads) {
    const bool good = bits[i] && float_of_key(key[i]) < thr_s;
    if (!good) {
      A.out_u[i] = -1.f;
      A.out_depth[i] = -1.f;
    }
    A.ok[i] = good;
  }
  if (t == 0) *A.ticket = 0u;
}

__global__ void __launch_bounds__(kThreads)
associate_kernel(const __grid_constant__ SAssoc A) {
  __shared__ float patch[kWarps][kP * kP];
  __shared__ float strip[kWarps][kP * kS];
  __shared__ Scratch sc;
  __shared__ int last;
  extern __shared__ __align__(16) unsigned char dyn[];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;  // >= N in the extra block
  if (blockIdx.x == gridDim.x - 1) distance_bound(A, dyn, sc);
  if (i < A.N) {
    // (a) the matched u
    const int b = A.best[i];
    const bool ok1 = b <= A.max_dist;
    const int j = min(max(A.idx[i], 0), A.M - 1);
    const float mu = ok1 ? A.r_xy[2 * j] : -1.f;
    // (b) the integer coordinates at the keypoint's level
    const int l = min(max(A.l_level[i], 0), A.L.n - 1);
    const SLevel& lv = A.L.lv[l];
    const float sfl = A.sf[l];
    const float inv = 1.f / sfl;
    const float lx = A.l_xy[2 * i], ly = A.l_xy[2 * i + 1];
    const int y = clip_round(ly * inv, kW, lv.h - kW - 1);
    const int x = clip_round(lx * inv, kW, lv.w - kW - 1);
    const int u = clip_round(mu * inv, kW + kR, lv.w - kW - kR - 1);
    // (c) the SAD, argmin and parabola
    const SadOut r = sad_warp(lv, y, x, u, patch[warp], strip[warp], lane);
    // (d) back to level 0, the gates
    const float ur_ref = r.ur * sfl;
    const float disp = lx - ur_ref;
    if (lane == 0) {
      A.out_u[i] = ur_ref;
      A.out_depth[i] = A.bf / fmaxf(disp, 0.01f);
      A.sad[i] = r.s0;
      A.ok[i] = disp > 0.01f && disp < A.bf && r.ok;
    }
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(A.ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  finish(A, dyn, sc);
}

// the SAD refinement alone, on coordinates the caller gives
__global__ void __launch_bounds__(kThreads)
stereo_sad_kernel(const __grid_constant__ SLevels L,
                  const int* __restrict__ lvl, const int* __restrict__ ys,
                  const int* __restrict__ xs, const int* __restrict__ urs,
                  int N,
                  float* __restrict__ out_ur, float* __restrict__ out_sad,
                  bool* __restrict__ out_ok) {
  __shared__ float patch[kWarps][kP * kP];
  __shared__ float strip[kWarps][kP * kS];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * kWarps + warp;
  if (i >= N) return;  // whole warps only: no block barrier below
  const int l = min(max(lvl[i], 0), L.n - 1);
  const int h = L.lv[l].h, w = L.lv[l].w;
  const int y = min(max(ys[i], kW), h - kW - 1);
  const int x = min(max(xs[i], kW), w - kW - 1);
  const int u = min(max(urs[i], kW + kR), w - kW - kR - 1);
  const SadOut r = sad_warp(L.lv[l], y, x, u, patch[warp], strip[warp], lane);
  if (lane == 0) {
    out_ur[i] = r.ur;
    out_sad[i] = r.s0;
    out_ok[i] = r.ok;
  }
}

int fill_levels(SLevels& L, int n, const void* const* imgs_l,
                const void* const* imgs_r, const int* dims) {
  if (n < 1 || n > kMaxLevels) return (int)cudaErrorInvalidValue;
  L.n = n;
  for (int l = 0; l < n; ++l) {
    const int h = dims[2 * l], w = dims[2 * l + 1];
    if (h < kP || w < kS) return (int)cudaErrorInvalidValue;
    L.lv[l].left = (const float*)imgs_l[l];
    L.lv[l].right = (const float*)imgs_r[l];
    L.lv[l].h = h;
    L.lv[l].w = w;
  }
  return 0;
}

}  // namespace

// imgs_l[n], imgs_r[n]: f32 level images, the same shapes; dims: (h, w) of
// each level; sf: f32[n] on the device; l_xy f32[N, 2], l_level i32[N],
// r_xy f32[M, 2], idx and best i32[N] (K1's); out: f32[4, N], its rows
// u_right, depth, the SAD scratch and ok (bool[N] in the row's first N
// bytes); ticket: a zero u32 on the device, left zero, and an f32 of
// scratch after it.
extern "C" int stereo_associate(int n, const void* const* imgs_l,
                                const void* const* imgs_r, const int* dims,
                                const void* sf, float bf, int max_dist,
                                int big, const void* l_xy,
                                const void* l_level, const void* r_xy, int M,
                                const void* idx, const void* best, int N,
                                void* out, void* ticket, void* stream) {
  SAssoc A;
  const int err = fill_levels(A.L, n, imgs_l, imgs_r, dims);
  if (err != 0) return err;
  if (N < 0 || (N > 0 && M < 1)) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  const size_t dyn = 5 * (size_t)N;
  if (dyn + kStaticSmem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        associate_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)dyn);
    if (e != cudaSuccess) return (int)e;
  }
  A.sf = (const float*)sf;
  A.l_xy = (const float*)l_xy;
  A.l_level = (const int*)l_level;
  A.r_xy = (const float*)r_xy;
  A.idx = (const int*)idx;
  A.best = (const int*)best;
  A.N = N;
  A.M = M;
  A.bf = bf;
  A.max_dist = max_dist;
  A.big = big;
  float* base = (float*)out;
  A.out_u = base;
  A.out_depth = base + N;
  A.sad = base + 2 * (size_t)N;
  A.ok = (unsigned char*)(base + 3 * (size_t)N);
  A.ticket = (unsigned int*)ticket;
  A.thr_d = (float*)ticket + 1;
  // a block a kWarps keypoints, and one for the distance median
  associate_kernel<<<(N + kWarps - 1) / kWarps + 1, kThreads, dyn,
                     (cudaStream_t)stream>>>(A);
  return (int)cudaGetLastError();
}

// The SAD refinement alone. lvl, ys, xs, urs: int32[N], the keypoint's
// level and its patch centre and strip centre there; out_ur f32[N] (the
// refined right u at the keypoint's level), out_sad f32[N] (the SAD at the
// clipped argmin), out_ok bool[N] (|delta| <= 1 and an interior argmin).
extern "C" int stereo_sad(int n, const void* const* imgs_l,
                          const void* const* imgs_r, const int* dims,
                          const void* lvl, const void* ys, const void* xs,
                          const void* urs, int N, void* out_ur, void* out_sad,
                          void* out_ok, void* stream) {
  SLevels L;
  const int err = fill_levels(L, n, imgs_l, imgs_r, dims);
  if (err != 0) return err;
  if (N < 0) return (int)cudaErrorInvalidValue;
  if (N == 0) return (int)cudaGetLastError();
  stereo_sad_kernel<<<(N + kWarps - 1) / kWarps, kThreads, 0,
                      (cudaStream_t)stream>>>(
      L, (const int*)lvl, (const int*)ys, (const int*)xs, (const int*)urs, N,
      (float*)out_ur, (float*)out_sad, (bool*)out_ok);
  return (int)cudaGetLastError();
}
