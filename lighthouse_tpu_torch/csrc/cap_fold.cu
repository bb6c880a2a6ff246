// cap_fold: r = hash64(r || zero_hash[d]) for the k zero-subtree caps
// between a tree's dense depth and its limit depth; u32[8], u32[k,8] ->
// u32[8].
//
// Replaces the JAX package's lighthouse_tpu/ops/sha256.py:135
// `_fold_zero_caps` (a lax.scan), which ops/merkle_tree.py:65 `_cap_root`
// also calls.
//
// Design: one thread; the chain is serial, each hash needs the last.
// Bound: latency. k = 20 for the validator registry (2^40 limit over a
// 2^20 dense tree), i.e. 20 dependent hashes; the op count over the card's
// rate is nanoseconds, the launch itself microseconds.
// Left for later: fusing the caps into the last launch of a build or an
// update.
#include "sha256.cuh"

namespace {

__global__ void cap_fold_kernel(const uint32_t* __restrict__ root,
                                const uint32_t* __restrict__ zeros, int k,
                                uint32_t* __restrict__ out) {
  uint32_t r[8];
  lhsha::load8(root, r);
#pragma unroll 1
  for (int d = 0; d < k; ++d) {
    uint32_t m[16];
#pragma unroll
    for (int j = 0; j < 8; ++j) m[j] = r[j];
    lhsha::load8(zeros + 8 * d, m + 8);
    lhsha::hash64(m, r);
  }
  lhsha::store8(out, r);
}

}  // namespace

extern "C" int lh_cap_fold(const void* root, const void* zeros, int k,
                           void* out, void* stream) {
  cap_fold_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)root, (const uint32_t*)zeros, k, (uint32_t*)out);
  return (int)cudaGetLastError();
}
