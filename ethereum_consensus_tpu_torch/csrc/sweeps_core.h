// One validator through the effective-balance hysteresis sweep, as a
// __host__ __device__ function, and the sweep's columns on warp_chunks.h's
// partition with its schedule run on the host (effective_balance_host).
//
// The arithmetic of the Hopper kernels in sweeps.cu and chain_step.cu. The
// header is plain C++ outside nvcc, so g++ builds the same functions for the
// CPU tests that hold them against the reference package's sweep.
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
// Two forms of the floor b - b % increment: the divided form (a software
// 64-bit remainder on the card; the form the tests hold the other against),
// and the reciprocal form (sweeps.cu, chain_step.cu): divide(b, by_increment)
// * increment with the increment made ready once a sweep by
// udiv64_core::prepare (hysteresis()). The quotient times the increment never
// exceeds b, so the product is exact for every u64 b and both forms give the
// same bits.

#pragma once

#include <stdint.h>

#include "udiv64_core.h"
#include "warp_chunks.h"

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

// The hysteresis constants: the increment and its reciprocal, the cap, and
// the downward and upward thresholds ((increment / quotient) * multiplier).
struct Hysteresis {
  uint64_t increment;
  udiv64_core::UDiv64 by_increment;
  uint64_t max_effective;
  uint64_t down;
  uint64_t up;
};

// The constants made ready; the increment must be nonzero (the launchers
// refuse it otherwise).
SWEEPS_HD Hysteresis hysteresis(uint64_t increment, uint64_t max_effective, uint64_t down,
                                uint64_t up) {
  return {increment, udiv64_core::prepare(increment), max_effective, down, up};
}

// effective_balance_update on the constants made ready.
SWEEPS_HD uint64_t effective_balance_update(uint64_t balance, uint64_t effective,
                                            const Hysteresis& h) {
  return effective_balance_update(balance, effective, h.increment, h.by_increment,
                                  h.max_effective, h.down, h.up);
}

// The sweep's columns, all (n,) words: balances and effective balances in,
// the new effective balances out. `chunks` whole warp chunks take the vector
// path (0 where a column is not 16-byte aligned).
struct BalanceColumns {
  const uint64_t* balances;
  const uint64_t* effective;
  int64_t n;
  int64_t chunks;
  uint64_t* out;
};

inline BalanceColumns balance_columns(const void* balances, const void* effective, int64_t n,
                                      void* out) {
  using warp_chunks::aligned;
  const bool vector = aligned(balances, 16) && aligned(effective, 16) && aligned(out, 16);
  return {static_cast<const uint64_t*>(balances), static_cast<const uint64_t*>(effective), n,
          vector ? n / warp_chunks::kChunk : 0, static_cast<uint64_t*>(out)};
}

#ifndef __CUDACC__

// sweeps.cu's kernel on a grid of `grid` blocks, run on the host in its order
// (warp_chunks::schedule_host). visits, where not null, counts each
// validator's visits.
inline void effective_balance_host(const BalanceColumns& c, const Hysteresis& h, int64_t grid,
                                   uint8_t* visits) {
  warp_chunks::schedule_host(c.chunks, c.n, grid, [&](int64_t, int64_t i) {
    if (visits) visits[i] = static_cast<uint8_t>(visits[i] + 1);
    c.out[i] = effective_balance_update(c.balances[i], c.effective[i], h);
  });
}

#endif  // __CUDACC__

}  // namespace sweeps_core
