// The per-lane arithmetic of the sharded chain step and of the sharded
// epoch sweep step, as __host__ __device__ functions.
//
// The arithmetic of the Hopper kernels in chain_step.cu. The header is plain
// C++ outside nvcc, so g++ builds the same functions for the CPU tests that
// hold them against the reference package's steps
// (ethereum_consensus_tpu/parallel/step.py).
//
// The chain step (step.py:112-145) for one SSZ chunk of four validators:
// the hysteresis update of each (sweeps_core.h), the sum of the new
// effective balances of the active ones, and the chunk's eight big-endian
// 32-bit words (u64_to_be_words, step.py:56: SSZ packs each balance little
// endian, and word 2k is the byte swap of balance k's low half, word 2k + 1
// of its high half).
//
// The epoch sweep step (step.py:294-383): the per-epoch scalars made from
// the four summed words (three participation flags over the unslashed
// validators active in the previous epoch, and the effective balances active
// in the current one; masked_sums.h's lane, which K2 runs). The element pass is
// altair_core.h's fused_epoch_lane on those scalars (the kernel runs it on
// their reciprocals, altair_core::fused_sweep of them): the step floors
// nothing but the total (max(total, increment)), where the fused epoch
// kernel floors each flag sum at one increment too, so its scalars differ on
// a flag sum below one increment (a sum that wrapped mod 2^64, or no
// participant) and are made here.
//
// All arithmetic is unsigned 64-bit and wraps as the reference's jnp.uint64
// programs do.

#pragma once

#include <stdint.h>

#include "altair_core.h"
#include "sweeps_core.h"

#ifdef __CUDACC__
#define CHAIN_HD __host__ __device__ __forceinline__
#else
#define CHAIN_HD inline
#endif

namespace chain_step_core {

// Validators of one SSZ chunk of a List[uint64, N].
constexpr int kPerChunk = 4;

// The hysteresis constants: the increment, the cap, and the downward and
// upward thresholds ((increment / quotient) * multiplier, as step.py:106-110).
struct Hysteresis {
  uint64_t increment;
  uint64_t max_effective;
  uint64_t down;
  uint64_t up;
};

CHAIN_HD uint32_t bswap32(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) | (x << 24);
}

// One chunk through the chain step: the four new effective balances into
// new_effective, the chunk's eight words into words, and the sum of the new
// effective balances of the active validators (mod 2^64) returned.
CHAIN_HD uint64_t chunk_lane(const Hysteresis& h, const uint64_t balances[kPerChunk],
                             const uint64_t effective[kPerChunk],
                             const bool active[kPerChunk],
                             uint64_t new_effective[kPerChunk], uint32_t words[8]) {
  uint64_t sum = 0;
  for (int k = 0; k < kPerChunk; ++k) {
    const uint64_t b = balances[k];
    const uint64_t e = sweeps_core::effective_balance_update(
        b, effective[k], h.increment, h.max_effective, h.down, h.up);
    new_effective[k] = e;
    sum += active[k] ? e : 0;
    words[2 * k] = bswap32(static_cast<uint32_t>(b));
    words[2 * k + 1] = bswap32(static_cast<uint32_t>(b >> 32));
  }
  return sum;
}

// The chain constants of the epoch step (make_epoch_sweep_step's five, and
// the altair flag constants).
struct EpochConstants {
  uint64_t increment;
  uint64_t base_reward_factor;
  uint64_t bias;
  uint64_t recovery_rate;
  uint64_t inactivity_quotient;
  uint64_t weights[3];
  uint64_t weight_denominator;
  bool leaking;
  int head_flag_index;
  int target_flag_index;
};

// The per-epoch scalars of the element pass from the summed words (sums[0..2]
// the flag sums, sums[3] the active-current total), step.py:317-342 and :367:
// total_active = max(sums[3], increment), the base reward per increment off
// isqrt(total_active) (the reference's _isqrt, step for step altair_core.h's
// isqrt_u64), each flag's unslashed increments as sum / increment (no floor).
CHAIN_HD altair_core::FusedScalars epoch_step_scalars(const EpochConstants& c,
                                                      const uint64_t sums[4],
                                                      uint64_t* total_active) {
  altair_core::FusedScalars s;
  const uint64_t total = altair_core::umax(sums[3], c.increment);
  *total_active = total;
  s.increment = c.increment;
  s.brpi = c.increment * c.base_reward_factor / altair_core::isqrt_u64(total);
  s.divisor = (total / c.increment) * c.weight_denominator;
  s.denominator = c.bias * c.inactivity_quotient;
  s.bias = c.bias;
  s.recovery_rate = c.recovery_rate;
  for (int f = 0; f < 3; ++f) {
    s.weights[f] = c.weights[f];
    s.unslashed_increments[f] = sums[f] / c.increment;
  }
  s.weight_denominator = c.weight_denominator;
  s.leaking = c.leaking;
  s.head_flag_index = c.head_flag_index;
  s.target_flag_index = c.target_flag_index;
  return s;
}

}  // namespace chain_step_core
