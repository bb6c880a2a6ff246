// hash64: SHA-256 of n 64-byte blocks, u32[n,16] -> u32[n,8].
//
// Replaces the JAX package's lighthouse_tpu/ops/sha256.py:102 `hash64`
// (two `sha256_compress` calls, :59), which is also the level step of
// `hash_pairs` (:115), `merkleize_dense` (:123), `_mix_in_words` (:198)
// and of every level of ops/merkle_tree.py `_build_fn` (:74-102).
//
// Design: one thread per block; both compressions in registers
// (sha256.cuh), the second against the constant padding block. Input rows
// are read with four 16-byte loads, the digest written with two.
//
// Bound: integer operations. One hash64 is 1,664 ops that only the
// integer ALU pipe issues (funnel-shift rotates and LOP3 logic; its 624
// adds may issue on the FMA pipe beside them: ops/sha256.py
// HASH64_INT_OPS) against 96 bytes of traffic, so a full level of a
// 2^20-leaf tree is op-bound on an H100 by a factor of ~3.5.
// Left for later: subtree-per-CTA builds that hash several levels from
// shared memory in one launch (a full tree is 21 launches now).
#include "sha256.cuh"

namespace {

__global__ void hash64_kernel(const uint32_t* __restrict__ in,
                              uint32_t* __restrict__ out, long long n) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t m[16], h[8];
  lhsha::load8(in + i * 16, m);
  lhsha::load8(in + i * 16 + 8, m + 8);
  lhsha::hash64(m, h);
  lhsha::store8(out + i * 8, h);
}

}  // namespace

extern "C" int lh_hash64(const void* in, void* out, long long n,
                         void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  hash64_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, n);
  return (int)cudaGetLastError();
}
