// cap_fold: r = hash64(r || zero_hash[d]) for the zero-subtree caps d =
// dense_depth .. limit_depth - 1 of a tree whose dense part is
// 2^dense_depth leaves under a limit of 2^limit_depth; u32[8] -> u32[8].
//
// Replaces the JAX package's lighthouse_tpu/ops/sha256.py:135
// `_fold_zero_caps` (a lax.scan over the caps it is given), which
// ops/merkle_tree.py:65 `_cap_root` also calls.
//
// Design: one thread; the chain is serial, each hash needs the last. The
// caps come from the table of zero_hashes.cuh (generated from
// ops/sha256.py ZERO_HASH_WORDS, built into the library), so no caller
// copies them to the card; the next cap's words load while a cap hashes.
// A tree update folds its caps inside its walk (path_update.cu, the same
// lhsha::cap_root); this launch is a build's.
// Bound: latency. k = limit_depth - dense_depth = 20 for the validator
// registry (2^40 limit over a 2^20 dense tree): 40 dependent compressions
// of 64 rounds of ~7 dependent integer operations, ~35-45 us at 1.98 GHz,
// against nanoseconds of work over the card's integer rate.
#include "zero_hashes.cuh"

namespace {

__global__ void cap_fold_kernel(const uint32_t* __restrict__ root,
                                int dense_depth, int limit_depth,
                                uint32_t* __restrict__ out) {
  lhsha::cap_root(root, dense_depth, limit_depth, out);
}

}  // namespace

// 0 <= dense_depth <= limit_depth <= LHSHA_ZERO_DEPTHS
extern "C" int lh_cap_fold(const void* root, int dense_depth,
                           int limit_depth, void* out, void* stream) {
  if (dense_depth < 0 || dense_depth > limit_depth ||
      limit_depth > LHSHA_ZERO_DEPTHS)
    return (int)cudaErrorInvalidValue;
  cap_fold_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)root, dense_depth, limit_depth, (uint32_t*)out);
  return (int)cudaGetLastError();
}
