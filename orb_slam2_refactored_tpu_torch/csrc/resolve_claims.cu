// Claim resolution after the Hamming best-2 (kernel R): per claimed
// target, keep only the claimant row with the least distance, the lowest
// row on equal distances; in the rows-with-index mode also give each row's
// kept target (-1 elsewhere); in the projection search's mode give the
// results per map point.
//
// Replaces: `resolve_duplicates` of the JAX package
// (orb_slam2_refactored_tpu/ops/hamming.py:101-115: two scatter-mins over
// the targets and their gathers), which runs after every K1 call that
// resolves claims (the projection and motion-model searches, descriptor
// matching, triangulation and fusion), the matchers' `jnp.where(keep, idx,
// -1)` after it (ops/matching.py:70, :268), and in the projection search
// the scatter of the candidates' rows back to the points
// (ops/matching.py:151-158). The port's plain versions
// (`ops/hamming.py::resolve_duplicates_plain`, `resolve_rows_plain`,
// `resolve_to_points_plain`) take ~14-22 torch operations; this is one
// launch.
//
// What bounds it on the H100: M claimant rows (1,000-8,192) read 9 bytes
// each and N targets (1,000-2,000); at most P = 32,768 points written, 9
// bytes each: ~0.4 MB, 0.0001 ms at 3.35 TB/s. Latency binds.
//
// Design: every block (up to 132 of 1024 threads, enough for an output a
// thread) builds the whole per-target table in shared memory, the least
// 64-bit key (distance, row) of the valid claimants of each target, with
// integer atomics (atomicMin), so the result does not depend on the order
// in which rows arrive; then the blocks share out the outputs. Building
// the table in every block costs a few microseconds of L2 reads (M x 9
// bytes a block) and saves a second launch or a grid-wide barrier. One
// thread block cluster instead (up to 8 blocks, the table built once, cut
// by target and pushed between the blocks' shared memory) was built,
// bit-equal, and measured on the H100: 0.0112-0.0113 ms for the tracked
// frame's two calls against this design's 0.0061, its outputs 4 a thread
// behind dependent loads (slot, row, table). Claiming through 64-bit
// atomicMin on another block's shared memory kept wrong rows there.
//
// A row is kept when it is valid and its key is its target's. Rows with
// `valid` false never claim. That is the plain version's rule: its first
// scatter takes the least distance (BIG for invalid rows), its second the
// lowest row among the valid rows at that distance; a valid row whose
// distance exceeds BIG never wins there, and none claims here. Modes:
// keep[M]; rows-with-index: keep[M] and idx_out[M] = keep ? idx : -1; the
// projection mode: for each point p its row s = slot[p] (B6's), and
// idx_p = keep ? idx[s] : -1, best_p = best[s], keep_p = keep (-1, BIG and
// false where p has no row). valid is ok & (dist <= max_dist).

#include <cuda_runtime.h>
#include <stdint.h>

// The launch record (`ops/hamming.py::_RRecord`): the per-call pointers
// and the call's sizes.
// (outside the unnamed namespace: the exported C entry takes it)
struct RArgs {
  const int* idx;            // [M] target of each row
  const int* dist;           // [M]
  const unsigned char* ok;   // [M]
  const int* slot;           // [P] row of each point, or null
  unsigned char* keep;       // [M] (slot null)
  int* idx_out;              // [M] kept target or -1 (slot null), or null
  int* idx_p;                // [P] (slot given)
  int* best_p;               // [P]
  unsigned char* keep_p;     // [P]
  int max_dist;              // valid = ok & (dist <= max_dist)
  int M, N, P;
};

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBlocks = 132;
constexpr int kBig = 10000;  // ops/hamming.py BIG
constexpr int kMaxDevices = 16;

__device__ __forceinline__ unsigned long long key_of(int d, int row) {
  // order-preserving for any int distance, then the row
  return ((unsigned long long)((unsigned)d ^ 0x80000000u) << 32) |
         (unsigned)row;
}

__device__ __forceinline__ bool claims(const RArgs& a, int r, int t, int d) {
  return a.ok[r] && d <= a.max_dist && d <= kBig && t >= 0 && t < a.N;
}

__global__ void __launch_bounds__(kThreads) resolve_kernel(RArgs a) {
  extern __shared__ unsigned long long table[];  // [N]
  for (int i = threadIdx.x; i < a.N; i += kThreads) table[i] = ~0ull;
  __syncthreads();
  for (int r = threadIdx.x; r < a.M; r += kThreads) {
    const int t = a.idx[r], d = a.dist[r];
    if (claims(a, r, t, d)) atomicMin(&table[t], key_of(d, r));
  }
  __syncthreads();
  const int stride = gridDim.x * kThreads;
  const int first = blockIdx.x * kThreads + threadIdx.x;
  if (a.slot == nullptr) {
    for (int r = first; r < a.M; r += stride) {
      const int t = a.idx[r], d = a.dist[r];
      const bool keep = claims(a, r, t, d) && table[t] == key_of(d, r);
      a.keep[r] = keep;
      if (a.idx_out != nullptr) a.idx_out[r] = keep ? t : -1;
    }
    return;
  }
  for (int p = first; p < a.P; p += stride) {
    const int s = a.slot[p];
    int idx = -1, best = kBig;
    bool keep = false;
    if (s >= 0) {
      const int t = a.idx[s];
      best = a.dist[s];
      keep = claims(a, s, t, best) && table[t] == key_of(best, s);
      if (keep) idx = t;
    }
    a.idx_p[p] = idx;
    a.best_p[p] = best;
    a.keep_p[p] = keep;
  }
}

int smem_optin(int dev) {
  static int cache[kMaxDevices] = {0};
  if (dev < kMaxDevices && cache[dev] > 0) return cache[dev];
  int most = 0;
  if (cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  if (dev < kMaxDevices) cache[dev] = most;
  return most;
}

}  // namespace

// Targets one launch can take (every block holds the whole table in its
// shared memory).
extern "C" int resolve_claims_max_targets() {
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 0;
  return smem_optin(dev) / (int)sizeof(unsigned long long);
}

// Kernel R over a->M rows and a->N targets. With `slot` null: keep [M]
// (and idx_out [M] where given). With `slot` [P]: idx_p, best_p, keep_p
// [P]. `max_dist` gates the rows' distances (INT_MAX: no gate). A launch
// the card refuses returns its CUDA error; nothing falls back.
extern "C" int resolve_claims(const RArgs* a, void* stream) {
  if (a->M <= 0 || a->N <= 0 || (a->slot != nullptr && a->P <= 0))
    return (int)cudaErrorInvalidValue;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)a->N * sizeof(unsigned long long);
  if (smem > (size_t)smem_optin(dev)) return (int)cudaErrorInvalidValue;
  static bool opted[kMaxDevices] = {false};
  // above 48 KB of dynamic shared memory only after opting in
  if (smem > 48 * 1024 && !(dev < kMaxDevices && opted[dev])) {
    e = cudaFuncSetAttribute(resolve_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem_optin(dev));
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) opted[dev] = true;
  }
  const int outputs = a->slot == nullptr ? a->M : a->P;
  int blocks = (outputs + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  resolve_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(*a);
  return (int)cudaGetLastError();
}
