// SHA-256 of one 64-byte message, as __host__ __device__ functions.
//
// The arithmetic of the Hopper kernel in sha256.cu. The header is plain
// C++ outside nvcc (the qualifier macro is empty there), so g++ builds the
// same functions for the CPU tests that hold them against hashlib.
//
// A 64-byte message compresses in exactly two blocks: the message itself,
// then the constant pad block (0x80000000, 14 zero words, bit length 512).
// Words are SHA-256's big-endian words as uint32.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SHA256_HD __host__ __device__ __forceinline__
#else
#define SHA256_HD inline
#endif

#define SHA256_K_VALUES                                                       \
  0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,            \
      0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,        \
      0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,        \
      0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,        \
      0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,        \
      0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,        \
      0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,        \
      0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,        \
      0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,        \
      0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,        \
      0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,        \
      0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,        \
      0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u

namespace sha256_core {

// Round constants: in __constant__ memory on the card, where every lane of
// a warp reads the same one in a round; a plain array on the host.
#ifdef __CUDACC__
__constant__ uint32_t kRoundDevice[64] = {SHA256_K_VALUES};
#endif
static const uint32_t kRoundHost[64] = {SHA256_K_VALUES};

SHA256_HD uint32_t round_constant(int t) {
#ifdef __CUDA_ARCH__
  return kRoundDevice[t];
#else
  return kRoundHost[t];
#endif
}

SHA256_HD uint32_t rotr(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

// One compression of block `w` into `state`. `w` is the rolling 16-word
// message schedule and is overwritten: after round t, w[t % 16] holds W[t].
SHA256_HD void compress(uint32_t state[8], uint32_t w[16]) {
  uint32_t a = state[0], b = state[1], c = state[2], d = state[3];
  uint32_t e = state[4], f = state[5], g = state[6], h = state[7];
#ifdef __CUDACC__
#pragma unroll
#endif
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
    const uint32_t big_s1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t t1 = h + big_s1 + ch + round_constant(t) + wt;
    const uint32_t big_s0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    const uint32_t t2 = big_s0 + maj;
    h = g;
    g = f;
    f = e;
    e = d + t1;
    d = c;
    c = b;
    b = a;
    a = t1 + t2;
  }
  state[0] += a;
  state[1] += b;
  state[2] += c;
  state[3] += d;
  state[4] += e;
  state[5] += f;
  state[6] += g;
  state[7] += h;
}

// SHA-256 of the 64-byte message `msg` (16 words, consumed) into `out`.
SHA256_HD void digest_64b(uint32_t msg[16], uint32_t out[8]) {
  out[0] = 0x6a09e667u;
  out[1] = 0xbb67ae85u;
  out[2] = 0x3c6ef372u;
  out[3] = 0xa54ff53au;
  out[4] = 0x510e527fu;
  out[5] = 0x9b05688cu;
  out[6] = 0x1f83d9abu;
  out[7] = 0x5be0cd19u;
  compress(out, msg);
  uint32_t pad[16] = {0x80000000u, 0, 0, 0, 0, 0, 0, 0,
                      0,           0, 0, 0, 0, 0, 0, 512u};
  compress(out, pad);
}

}  // namespace sha256_core
