// Exact unsigned 64-bit division by a divisor fixed for a whole sweep, as
// __host__ __device__ functions: one multiply-high by a magic number made
// once, a subtraction, an add and two shifts, in place of a software 64-bit
// division (a loop of some 60 dependent integer operations on the card).
//
// The method is Granlund and Montgomery's ("Division by invariant integers
// using multiplication", PLDI 1994, figure 4.1), round-up form: for a
// divisor d >= 1 let l = ceil(log2(d)) and
//     m = floor(2^64 * (2^l - d) / d) + 1     (m < 2^64);
// then for every numerator 0 <= n < 2^64
//     t = mulhi(m, n),  n / d = (t + ((n - t) >> min(l, 1))) >> max(l - 1, 0).
// The halving of n - t keeps the sum inside 64 bits where the 65-bit
// multiplier 2^64 + m would not fit. d = 1 gives m = 1, t = 0 and n; a
// power of two gives m = 1 and a plain shift; d > 2^63 gives l = 64.
//
// The header is plain C++ outside nvcc, so g++ builds the same functions for
// the CPU test that holds them against Python's // on every u64 edge.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define UDIV64_HD __host__ __device__ __forceinline__
#else
#define UDIV64_HD inline
#endif

namespace udiv64_core {

// A divisor made ready: the magic number and the two shifts.
struct UDiv64 {
  uint64_t magic;
  uint32_t shift1;
  uint32_t shift2;
};

// The high 64 bits of the 128-bit product a * b.
UDIV64_HD uint64_t mulhi(uint64_t a, uint64_t b) {
#ifdef __CUDA_ARCH__
  return __umul64hi(a, b);
#else
  return static_cast<uint64_t>((static_cast<unsigned __int128>(a) * b) >> 64);
#endif
}

// floor(hi * 2^64 / d) for hi < d: the quotient fits in 64 bits. Bit by bit,
// since it runs once a sweep (no 128-bit division on the card).
UDIV64_HD uint64_t div_high(uint64_t hi, uint64_t d) {
  uint64_t r = hi;
  uint64_t q = 0;
  for (int i = 0; i < 64; ++i) {
    const uint64_t carry = r >> 63;  // 2r would pass 2^64: then 2r > d
    r <<= 1;
    q <<= 1;
    if (carry || r >= d) {
      r -= d;  // the true 2r - d is below d, so the wrap is exact
      q |= 1;
    }
  }
  return q;
}

// The magic number and shifts of divisor d >= 1.
UDIV64_HD UDiv64 prepare(uint64_t d) {
  int l = 0;
  while (l < 64 && (uint64_t{1} << l) < d) ++l;  // ceil(log2(d))
  const uint64_t below = l == 64 ? 0 - d : (uint64_t{1} << l) - d;  // 2^l - d < d
  UDiv64 out;
  out.magic = div_high(below, d) + 1;
  out.shift1 = l < 1 ? l : 1;
  out.shift2 = l > 1 ? l - 1 : 0;
  return out;
}

// n / d for every u64 n, with d made ready by prepare().
UDIV64_HD uint64_t divide(uint64_t n, const UDiv64& d) {
  const uint64_t t = mulhi(d.magic, n);
  return (t + ((n - t) >> d.shift1)) >> d.shift2;
}

}  // namespace udiv64_core
