// Claim resolution after the Hamming best-2 (kernel R): per claimed
// target, keep only the claimant row with the least distance, the lowest
// row on equal distances; in the projection search's mode also give the
// results per map point.
//
// Replaces: `resolve_duplicates` of the JAX package
// (orb_slam2_refactored_tpu/ops/hamming.py:101-115: two scatter-mins over
// the targets and their gathers), which runs after every K1 call that
// resolves claims (the projection and motion-model searches, descriptor
// matching, triangulation and fusion), and in the projection search the
// scatter of the candidates' rows back to the points
// (ops/matching.py:151-158). The port's plain version
// (`ops/hamming.py::resolve_duplicates_plain`) took ~14 torch operations,
// the scatter back ~8 more; this is one launch.
//
// What bounds it on the H100: M claimant rows (1,000-8,192) read 9 bytes
// each and N targets (1,000-2,000); at most P = 32,768 points written, 9
// bytes each: ~0.4 MB, 0.0001 ms at 3.35 TB/s. Latency binds.
//
// Design: every block builds the whole per-target table in shared memory,
// the least 64-bit key (distance, row) of the valid claimants of each
// target, with integer atomics (atomicMin), so the result does not depend
// on the order in which rows arrive; a row is kept when it is valid and
// its key is its target's. Rows with `valid` false never claim. That is the
// plain version's rule: its first scatter takes the least distance (BIG
// for invalid rows), its second the lowest row among the valid rows at
// that distance; a valid row whose distance exceeds BIG never wins there,
// and none claims here. Blocks share out the outputs: keep[M], or, in the
// projection mode, for each point p its row s = slot[p] (B6's), and
// idx_p = keep ? idx[s] : -1, best_p = best[s], keep_p = keep (-1, BIG and
// false where p has no row). The projection mode's valid is
// ok_r & (best <= max_dist). Building the table in every block costs a
// few microseconds of L2 reads (M x 9 bytes a block) and saves a second
// launch or a grid-wide barrier.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxBlocks = 132;
constexpr int kBig = 10000;  // ops/hamming.py BIG
constexpr int kMaxDevices = 16;

struct RArgs {
  const int* idx;            // [M] target of each row
  const int* dist;           // [M]
  const unsigned char* ok;   // [M]
  int max_dist;              // valid = ok & (dist <= max_dist)
  int M, N;
  const int* slot;           // [P] row of each point, or null
  int P;
  unsigned char* keep;       // [M] (slot null)
  int* idx_p;                // [P] (slot given)
  int* best_p;               // [P]
  unsigned char* keep_p;     // [P]
};

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
      a.keep[r] = claims(a, r, t, d) && table[t] == key_of(d, r);
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

}  // namespace

// Targets one launch can take (the table lives in shared memory).
extern "C" int resolve_claims_max_targets() {
  int dev = 0, smem = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                             dev) != cudaSuccess)
    return 0;
  return smem / (int)sizeof(unsigned long long);
}

// Kernel R over M rows and N targets. With `slot` null: keep [M]. With
// `slot` [P]: idx_p, best_p, keep_p [P] (keep unused). `max_dist` gates
// the rows' distances (INT_MAX: no gate).
extern "C" int resolve_claims(const void* idx, const void* dist,
                              const void* ok, int max_dist, int M, int N,
                              const void* slot, int P, void* keep,
                              void* idx_p, void* best_p, void* keep_p,
                              void* stream) {
  if (M <= 0 || N <= 0 || (slot != nullptr && P <= 0))
    return (int)cudaErrorInvalidValue;
  static bool opted[kMaxDevices] = {false};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  const size_t smem = (size_t)N * sizeof(unsigned long long);
  // above 48 KB of dynamic shared memory only after opting in
  if (smem > 48 * 1024 && !(dev < kMaxDevices && opted[dev])) {
    int most = 0;
    e = cudaDeviceGetAttribute(&most, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                               dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(resolve_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               most);
    if (e != cudaSuccess) return (int)e;
    if (dev < kMaxDevices) opted[dev] = true;
  }
  const int outputs = slot == nullptr ? M : P;
  int blocks = (outputs + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  RArgs a{(const int*)idx, (const int*)dist, (const unsigned char*)ok,
          max_dist, M, N, (const int*)slot, P, (unsigned char*)keep,
          (int*)idx_p, (int*)best_p, (unsigned char*)keep_p};
  resolve_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
