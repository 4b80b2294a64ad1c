// One validator through the effective-balance hysteresis sweep, as a
// __host__ __device__ function.
//
// The arithmetic of the Hopper kernel in sweeps.cu. The header is plain C++
// outside nvcc, so g++ builds the same function for the CPU tests that hold
// it against the reference package's sweep.
//
// For a balance b and an effective balance e (phase0
// process_effective_balance_updates):
//
//   update = (b + down < e) | (e + up < b)
//   out    = update ? min(b - b % increment, max_effective) : e
//
// All arithmetic is unsigned 64-bit and wraps as the reference's jnp.uint64
// program does (a balance near 2^64 wraps b + down below e).
//
// Two forms of the floor b - b % increment: the divided form (sweeps.cu, a
// software 64-bit remainder on the card), and the reciprocal form
// (chain_step.cu): divide(b, by_increment) * increment with the increment
// made ready once a sweep by udiv64_core::prepare. The quotient times the
// increment never exceeds b, so the product is exact for every u64 b and
// both forms give the same bits.

#pragma once

#include <stdint.h>

#include "udiv64_core.h"

#ifdef __CUDACC__
#define SWEEPS_HD __host__ __device__ __forceinline__
#else
#define SWEEPS_HD inline
#endif

namespace sweeps_core {

SWEEPS_HD uint64_t effective_balance_update(uint64_t balance, uint64_t effective,
                                            uint64_t increment,
                                            uint64_t max_effective,
                                            uint64_t down, uint64_t up) {
  const bool update = (balance + down < effective) | (effective + up < balance);
  const uint64_t floor = balance - balance % increment;
  const uint64_t candidate = floor < max_effective ? floor : max_effective;
  return update ? candidate : effective;
}

// effective_balance_update on the increment's reciprocal.
SWEEPS_HD uint64_t effective_balance_update(uint64_t balance, uint64_t effective,
                                            uint64_t increment,
                                            const udiv64_core::UDiv64& by_increment,
                                            uint64_t max_effective,
                                            uint64_t down, uint64_t up) {
  const bool update = (balance + down < effective) | (effective + up < balance);
  const uint64_t floor = udiv64_core::divide(balance, by_increment) * increment;
  const uint64_t candidate = floor < max_effective ? floor : max_effective;
  return update ? candidate : effective;
}

}  // namespace sweeps_core
