// SHA-256 of one 64-byte message, in registers, for the merkle kernels.
//
// Words are the big-endian u32 words of the message (ops/sha256.py
// chunks_to_words), handed over as the bit patterns of int32 tensors and
// read here as uint32_t. The 64 rounds and the rolling 16-word message
// schedule are fully unrolled, so every schedule index is a compile-time
// constant and the schedule lives in registers; rotates are funnel shifts.
// The second compression runs against the constant padding block of a
// 64-byte message, whose schedule the compiler folds to constants.
#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

namespace lhsha {

// Round constants, as immediates of the unrolled rounds (for the constant
// padding block the compiler folds K[t] + W[t] into one constant a round).
#define LHSHA_K_LIST                                                        \
  0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,         \
      0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,     \
      0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,     \
      0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,     \
      0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,     \
      0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,     \
      0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,     \
      0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,     \
      0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,     \
      0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,     \
      0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,     \
      0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,     \
      0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u

__device__ __forceinline__ uint32_t rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// One compression: st <- st + rounds(st, w). w is consumed (it holds the
// rolling schedule window).
__device__ __forceinline__ void compress(uint32_t st[8], uint32_t w[16]) {
  constexpr uint32_t kImm[64] = {LHSHA_K_LIST};
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    uint32_t wt;
    if (t < 16) {
      wt = w[t];
    } else {
      const uint32_t w15 = w[(t - 15) & 15];
      const uint32_t w2 = w[(t - 2) & 15];
      const uint32_t s0 = rotr(w15, 7) ^ rotr(w15, 18) ^ (w15 >> 3);
      const uint32_t s1 = rotr(w2, 17) ^ rotr(w2, 19) ^ (w2 >> 10);
      wt = w[t & 15] + s0 + w[(t - 7) & 15] + s1;
      w[t & 15] = wt;
    }
    const uint32_t S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + S1 + ch + kImm[t] + wt;
    const uint32_t S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = S0 + maj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// SHA-256 of the 64-byte message m (16 big-endian words) into out[8].
// m is consumed.
__device__ __forceinline__ void hash64(uint32_t m[16], uint32_t out[8]) {
  uint32_t st[8] = {0x6a09e667u, 0xbb67ae85u, 0x3c6ef372u, 0xa54ff53au,
                    0x510e527fu, 0x9b05688cu, 0x1f83d9abu, 0x5be0cd19u};
  compress(st, m);
  uint32_t pad[16] = {0x80000000u, 0, 0, 0, 0, 0, 0, 0,
                      0,           0, 0, 0, 0, 0, 0, 512u};
  compress(st, pad);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = st[i];
}

// 16-byte vector loads and stores of 8-word chunks (callers check 16-byte
// alignment of every base pointer; rows are 32 bytes).
__device__ __forceinline__ void load8(const uint32_t* p, uint32_t* dst) {
  const uint4 lo = reinterpret_cast<const uint4*>(p)[0];
  const uint4 hi = reinterpret_cast<const uint4*>(p)[1];
  dst[0] = lo.x; dst[1] = lo.y; dst[2] = lo.z; dst[3] = lo.w;
  dst[4] = hi.x; dst[5] = hi.y; dst[6] = hi.z; dst[7] = hi.w;
}

__device__ __forceinline__ void store8(uint32_t* p, const uint32_t* src) {
  reinterpret_cast<uint4*>(p)[0] = make_uint4(src[0], src[1], src[2], src[3]);
  reinterpret_cast<uint4*>(p)[1] = make_uint4(src[4], src[5], src[6], src[7]);
}

}  // namespace lhsha
