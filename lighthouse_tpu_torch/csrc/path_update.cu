// path_update: the whole dirty-path walk of one incremental-tree update in
// one launch. For every level l < depth and every distinct parent
// p = r >> (l + 1) of the dirty leaf rows r, level l + 1 gets
// hi[p] = hash64(lo[2p] || lo[2p+1]), in place, levels bottom up.
//
// Replaces the JAX package's lighthouse_tpu/ops/merkle_tree.py:105-135
// `_update_fn` (one jitted program: per level, gather the sibling pair,
// hash64, scatter the parent; :117-128).
//
// Bound: the distinct parents' hashes (the bound's own count), a few
// microseconds of work a level at 1,024 rows; what costs more is the
// order between the levels. Design:
// - rows are sorted and distinct (DeviceTree.update uploads np.unique of
//   them): at level l the thread of row t hashes its parent only where
//   rows[t] >> (l + 1) differs from row t - 1's, so each parent is hashed
//   once and no two threads write one node;
// - one cooperative launch (cudaLaunchCooperativeKernel): threads
//   grid-stride over the rows, and a grid barrier (this_grid().sync())
//   stands between two levels. The grid is min(ceil(R / threads), the
//   co-resident blocks), so every block is resident and the barrier
//   cannot hang; a grid too large for the card is refused, and the C
//   entry returns the launch's error;
// - once the level's parents span at most blockDim.x nodes (from level
//   ~12 on at R = 1,024 random rows of 2^20), block 0 finishes the walk
//   alone: it marks the span's dirty parents in shared memory, and each
//   level halves the marks, with __syncthreads between levels; the other
//   blocks return, and the remaining grid barriers go away.
// A level costs the latency of one SHA-256 chain and a barrier, so a walk
// is ~20 of them; 128 threads a block was the best of 64-512 at R = 1,024
// on the card (8 blocks: a warp a scheduler on 8 SMs).
// Block 0 marks the span's dirty parents by a binary search of the sorted
// rows a slot (log2 R dependent loads, where a pass over all R rows took
// R / blockDim.x of them).
// The root's zero-subtree caps (ops/merkle_tree.py `_cap_root`, the JAX
// update's last step) fold in the same launch: once the top level is
// written (after block 0's last __syncthreads, or, were the grid to walk
// every level, behind the last grid barrier: one exit, block 0's tail, for
// both), thread 0 of block 0 folds the limit_depth - depth caps
// (zero_hashes.cuh lhsha::cap_root, cap_fold.cu's fold) and writes the
// capped root, so an update launches nothing after its walk.
// The levels' pointers come by value in a struct (49 pointers, 392 bytes
// of the 4 KB parameter space), so the kernel allocates nothing.
#include <cooperative_groups.h>

#include "zero_hashes.cuh"

// the deepest tree a walk takes (levels 0..depth, depth <= this)
#define LH_PATH_MAX_DEPTH 48
// threads a block (and the span of parents block 0 finishes alone)
#define LH_PATH_THREADS 128

struct PathLevels {
  uint32_t* lv[LH_PATH_MAX_DEPTH + 1];
};

// level l + 1's node p from its two children in level l
__device__ __forceinline__ void hash_parent(const uint32_t* lo, uint32_t* hi,
                                            long long p) {
  uint32_t m[16], h[8];
  lhsha::load8(lo + p * 16, m);
  lhsha::load8(lo + p * 16 + 8, m + 8);
  lhsha::hash64(m, h);
  lhsha::store8(hi + p * 8, h);
}

__global__ void __launch_bounds__(LH_PATH_THREADS)
path_walk_kernel(PathLevels L, int depth, const int* rows, long long r,
                 int limit_depth, uint32_t* root) {
  extern __shared__ uint4 lh_smem[];
  const long long first = rows[0], last = rows[r - 1];
  const long long stride = (long long)gridDim.x * blockDim.x;
  const long long t0 = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  // a thread's first row and the one before it (-1 before row 0: no
  // parent is negative), kept for every level
  const long long row0 = t0 < r ? rows[t0] : 0;
  const long long prev0 = t0 > 0 && t0 < r ? rows[t0 - 1] : -1;
  int l = 0;
  // the grid's levels: the parents span more than a block
  for (; l < depth; ++l) {
    const int s = l + 1;
    if ((last >> s) - (first >> s) < (long long)blockDim.x) break;
    for (long long t = t0; t < r; t += stride) {
      const long long row = t == t0 ? row0 : rows[t];
      const long long prev = t == t0 ? prev0 : rows[t - 1];
      if ((prev >> s) != (row >> s))
        hash_parent(L.lv[l], L.lv[l + 1], row >> s);
    }
    cooperative_groups::this_grid().sync();
  }
  // block 0 alone from level l on (none left when the grid walked them
  // all: the top level is then in, behind the last grid barrier)
  if (blockIdx.x != 0) return;
  // slot j of the span is parent base + j
  unsigned char* mark = reinterpret_cast<unsigned char*>(lh_smem);
  unsigned char* next = mark + blockDim.x;
  const int j = threadIdx.x;
  long long base = first >> (l + 1);
  if (l < depth) {
    // slot j is dirty if a row has parent base + j: the first row at or
    // past that parent's first leaf
    const long long key = (base + j) << (l + 1);
    long long lo = 0, hi = r;
    while (lo < hi) {
      const long long mid = (lo + hi) >> 1;
      if (rows[mid] < key) lo = mid + 1; else hi = mid;
    }
    mark[j] = lo < r && ((long long)rows[lo] >> (l + 1)) == base + j;
  }
  __syncthreads();
  for (; l < depth; ++l) {
    const bool dirty = mark[j] != 0;
    if (dirty) hash_parent(L.lv[l], L.lv[l + 1], base + j);
    next[j] = 0;
    __syncthreads();
    const long long up = base >> 1;
    if (dirty) next[((base + j) >> 1) - up] = 1;
    base = up;
    unsigned char* tmp = mark;
    mark = next;
    next = tmp;
    __syncthreads();
  }
  if (threadIdx.x == 0)
    lhsha::cap_root(L.lv[depth], depth, limit_depth, root);
}

// levels: the depth + 1 level pointers (host array; level l is u32[2^(D -
// l), 8]); rows: r >= 1 sorted distinct leaf rows on the device; root:
// u32[8] for the top node capped to limit_depth (depth <= limit_depth <=
// LHSHA_ZERO_DEPTHS; limit_depth == depth: the top node itself).
// Returns a cudaError_t: a bad depth, an occupancy query's error or the
// cooperative launch's (cudaErrorCooperativeLaunchTooLarge included).
extern "C" int lh_path_walk(void* const* levels, int depth, const void* rows,
                            long long r, int limit_depth, void* root,
                            void* stream) {
  if (depth < 1 || depth > LH_PATH_MAX_DEPTH || r < 1 ||
      limit_depth < depth || limit_depth > LHSHA_ZERO_DEPTHS)
    return (int)cudaErrorInvalidValue;
  PathLevels L;
  for (int l = 0; l <= depth; ++l) L.lv[l] = (uint32_t*)levels[l];
  // the co-resident blocks of each card, asked once (0: not yet)
  static long long resident_of[64];
  const size_t smem = 2 * LH_PATH_THREADS;
  int dev = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc != cudaSuccess) return (int)rc;
  long long resident = dev < 64 ? resident_of[dev] : 0;
  if (resident == 0) {
    int sms = 0, per_sm = 0;
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess)
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, path_walk_kernel, LH_PATH_THREADS, smem);
    if (rc != cudaSuccess) return (int)rc;
    resident = (long long)sms * per_sm;
    if (dev < 64) resident_of[dev] = resident;
  }
  long long blocks = (r + LH_PATH_THREADS - 1) / LH_PATH_THREADS;
  if (blocks > resident) blocks = resident;
  if (blocks < 1) blocks = 1;   // no block fits: the launch refuses it
  const int* rows_p = (const int*)rows;
  uint32_t* root_p = (uint32_t*)root;
  void* args[] = {&L, &depth, &rows_p, &r, &limit_depth, &root_p};
  rc = cudaLaunchCooperativeKernel((const void*)path_walk_kernel,
                                   dim3((unsigned)blocks),
                                   dim3(LH_PATH_THREADS), args, smem,
                                   (cudaStream_t)stream);
  if (rc != cudaSuccess) return (int)rc;
  return (int)cudaGetLastError();
}
