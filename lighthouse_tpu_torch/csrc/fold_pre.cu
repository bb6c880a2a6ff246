// fold_pre: fold each leaf unit of 2^p chunks (optionally with its pubkey
// block hashed into chunk 0) into one leaf, and write it to its slot of a
// tree's level 0 -- or a zero chunk where the slot is list padding.
//
// Replaces the JAX package's lighthouse_tpu/ops/merkle_tree.py:52
// `_fold_pre` together with the `n_live` zeroing of `_build_fn` (:88-92)
// and the leaf scatter of `_update_fn` (:116-117).
//
// Two modes, one kernel:
// - build (rows == nullptr): thread t writes slot t for t < n_threads
//   (the dense width); slots t >= n_live become zero chunks without
//   reading any input (SSZ pads the leaf level with zero chunks, not with
//   roots of zero subtrees), so the input holds only the n_live units.
// - scatter (rows != nullptr): thread t folds input unit t and writes it
//   to slot rows[t] (a dirty-row update; rows < n_live).
//
// Design: one thread per unit, all 2^p chunks and the fold in registers
// (p a template parameter: 0 for the packed-uint columns, 3 for the
// validator registry, the two the state root uses). For the validator registry (p = 3, with
// pubkeys) that is 8 hash64 per thread: the pubkey block, then 4 + 2 + 1.
// Bound: integer operations (8 x ~2.3k ops against 352 bytes a unit).
// Left for later: spreading a unit over 8 threads with shuffles, so the
// 2^20-unit build keeps more of the card busy per register budget.
#include "sha256.cuh"

namespace {

template <int P>
__device__ __forceinline__ void fold_unit(const uint32_t* __restrict__ c,
                                          const uint32_t* __restrict__ pkb,
                                          uint32_t leaf[8]) {
  constexpr int U = 1 << P;
  uint32_t nodes[U][8];
#pragma unroll
  for (int i = 0; i < U; ++i) lhsha::load8(c + i * 8, nodes[i]);
  if (pkb != nullptr) {
    uint32_t m[16];
    lhsha::load8(pkb, m);
    lhsha::load8(pkb + 8, m + 8);
    lhsha::hash64(m, nodes[0]);
  }
#pragma unroll
  for (int width = U; width > 1; width >>= 1) {
#pragma unroll
    for (int j = 0; j < width / 2; ++j) {
      uint32_t m[16];
#pragma unroll
      for (int q = 0; q < 8; ++q) {
        m[q] = nodes[2 * j][q];
        m[8 + q] = nodes[2 * j + 1][q];
      }
      lhsha::hash64(m, nodes[j]);
    }
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) leaf[q] = nodes[0][q];
}

template <int P>
__global__ void fold_pre_kernel(const uint32_t* __restrict__ chunks,
                                const uint32_t* __restrict__ pk,
                                const int* __restrict__ rows,
                                long long n_threads, long long n_live,
                                uint32_t* __restrict__ out) {
  const long long t = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (t >= n_threads) return;
  const long long dst = rows != nullptr ? (long long)rows[t] : t;
  uint32_t leaf[8] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (dst < n_live) {
    fold_unit<P>(chunks + t * (8LL << P),
                 pk != nullptr ? pk + t * 16 : nullptr, leaf);
  }
  lhsha::store8(out + dst * 8, leaf);
}

}  // namespace

extern "C" int lh_fold_pre(const void* chunks, const void* pk,
                           const void* rows, long long n_threads,
                           long long n_live, int pre_levels, void* out,
                           void* stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((n_threads + threads - 1) / threads);
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* c = (const uint32_t*)chunks;
  const uint32_t* p = (const uint32_t*)pk;
  const int* r = (const int*)rows;
  uint32_t* o = (uint32_t*)out;
  switch (pre_levels) {
    case 0: fold_pre_kernel<0><<<blocks, threads, 0, s>>>(c, p, r, n_threads, n_live, o); break;
    case 3: fold_pre_kernel<3><<<blocks, threads, 0, s>>>(c, p, r, n_threads, n_live, o); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
