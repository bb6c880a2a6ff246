// path_update: one level of a dirty-path walk up an incremental tree. For
// each dirty leaf row r, the parent p = r >> (level + 1) gets
// hi[p] = hash64(lo[2p] || lo[2p+1]), in place in level + 1.
//
// Replaces one level of the JAX package's
// lighthouse_tpu/ops/merkle_tree.py:105-135 `_update_fn` (gather the
// sibling pair, hash64, scatter the parent; :117-128).
//
// Design: one thread per dirty row, one launch per level. Two dirty rows
// under one parent (and repeated rows) write the same parent with the same
// words; that race is harmless only because level `level` is complete
// before this launch reads it, which stream order guarantees -- so the
// levels are never fused into one grid without a grid-wide barrier.
// Bound: launch latency. A 1,024-row update is 1,024 hashes a level, a few
// microseconds of work against a launch each; a 2^20-leaf tree takes 20.
// Left for later: fusing the levels of an update (cooperative launch with
// a grid barrier, or one CTA per disjoint subtree) and CUDA graphs.
#include "sha256.cuh"

namespace {

__global__ void path_update_kernel(const uint32_t* __restrict__ lo,
                                   uint32_t* __restrict__ hi,
                                   const int* __restrict__ rows,
                                   long long r, int level) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= r) return;
  const long long parent = (long long)rows[t] >> (level + 1);
  uint32_t m[16], h[8];
  lhsha::load8(lo + parent * 16, m);
  lhsha::load8(lo + parent * 16 + 8, m + 8);
  lhsha::hash64(m, h);
  lhsha::store8(hi + parent * 8, h);
}

}  // namespace

extern "C" int lh_path_update(const void* lo, void* hi, const void* rows,
                              long long r, int level, void* stream) {
  const int threads = 256;
  const unsigned blocks = (unsigned)((r + threads - 1) / threads);
  path_update_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)lo, (uint32_t*)hi, (const int*)rows, r, level);
  return (int)cudaGetLastError();
}
