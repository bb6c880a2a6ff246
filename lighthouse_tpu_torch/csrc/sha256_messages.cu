// sha256_messages: SHA-256 of n equal-length messages, each pre-padded
// into B 64-byte blocks (FIPS 180-4), u32[n, B, 16] -> u32[n, 8].
//
// Replaces the JAX package's lighthouse_tpu/ops/sha256.py:211
// `sha256_messages` (B `sha256_compress` calls, :59, from the IV); the
// padding stays on the host (ops/sha256.py `pad_messages`, as :223).
//
// Design: one thread a message; its B compressions run in registers
// (sha256.cuh), each block read with four 16-byte loads, the digest written
// with two. Bound: integer operations, B x one compression with its
// message schedule (ops/sha256.py SHA256_COMPRESS_INT_OPS) against 64 B
// of input a block.
#include "sha256.cuh"

namespace {

__global__ void sha256_messages_kernel(const uint32_t* __restrict__ in,
                                       uint32_t* __restrict__ out,
                                       long long n, int nblocks) {
  const long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i >= n) return;
  uint32_t st[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  const uint32_t* msg = in + i * nblocks * 16;
  for (int b = 0; b < nblocks; ++b) {
    uint32_t m[16];
    lhsha::load8(msg + b * 16, m);
    lhsha::load8(msg + b * 16 + 8, m + 8);
    lhsha::compress(st, m);
  }
  lhsha::store8(out + i * 8, st);
}

}  // namespace

extern "C" int lh_sha256_messages(const void* in, void* out, long long n,
                                  int nblocks, void* stream) {
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  sha256_messages_kernel<<<(unsigned)blocks, threads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)in, (uint32_t*)out, n, nblocks);
  return (int)cudaGetLastError();
}
