// One index through the swap-or-not shuffle, as __host__ __device__
// functions.
//
// The arithmetic of the Hopper kernel in shuffle.cu. The header is plain
// C++ outside nvcc, so g++ builds the same functions for the CPU tests that
// hold them against the spec's compute_shuffled_index.
//
// A round r maps index i to flip = (pivot_r + count - i) mod count when bit
// (max(i, flip) mod 8) of byte max(i, flip) / 8 of the round's source table
// is set, and keeps i otherwise. The source table of round r concatenates
// sha256(seed || r || chunk) for every 256-index chunk; the pivots and
// tables are a host precompute. Arithmetic is 64-bit, so count may exceed
// 2^31.

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define SHUFFLE_HD __host__ __device__ __forceinline__
#else
#define SHUFFLE_HD inline
#endif

namespace shuffle_core {

SHUFFLE_HD uint8_t load_source(const uint8_t* p) {
#ifdef __CUDA_ARCH__
  return __ldg(p);
#else
  return *p;
#endif
}

// One round. idx < count and pivot < count, so pivot + count - idx lies in
// (0, 2 count) and one conditional subtraction takes it mod count.
SHUFFLE_HD uint64_t swap_or_not(uint64_t idx, uint64_t pivot, uint64_t count,
                                const uint8_t* source) {
  uint64_t flip = pivot + count - idx;
  if (flip >= count) flip -= count;
  const uint64_t position = idx > flip ? idx : flip;
  const uint8_t byte = load_source(source + (position >> 3));
  return ((byte >> (position & 7)) & 1) ? flip : idx;
}

// All rounds for one index: pivots (rounds,), sources (rounds, row_bytes).
SHUFFLE_HD uint64_t shuffled_index(uint64_t idx, uint64_t count, int rounds,
                                   const int64_t* pivots,
                                   const uint8_t* sources, int64_t row_bytes) {
  for (int r = 0; r < rounds; ++r) {
    idx = swap_or_not(idx, static_cast<uint64_t>(pivots[r]), count,
                      sources + r * row_bytes);
  }
  return idx;
}

}  // namespace shuffle_core
