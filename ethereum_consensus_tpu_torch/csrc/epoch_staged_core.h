// The per-validator arithmetic and columns of the staged epoch kernels
// (epoch_staged.cu), as __host__ __device__ functions: one flag's deltas
// from given base rewards, and the delta pairs applied in order. The third
// staged kernel, the inactivity update, is altair_core.h's lane
// (inactivity_update on update_columns). The header is plain C++ outside
// nvcc, so g++ builds the same functions and schedules (flag_deltas_host,
// apply_pairs_host on warp_chunks::schedule_host) for the CPU tests that
// hold them against the reference package's numpy kernels.
//
// All arithmetic is unsigned 64-bit and wraps where numpy's uint64 wraps.

#pragma once

#include <stdint.h>

#include "udiv64_core.h"
#include "warp_chunks.h"

#ifdef __CUDACC__
#define STAGED_HD __host__ __device__ __forceinline__
#else
#define STAGED_HD inline
#endif

namespace epoch_staged {

// One flag's scalars, made once a call by the launcher: the reward
// numerator's factor weight * unslashed_increments (mod 2^64, as numpy's
// base_reward * weight * increments wraps), the weight, and the two
// divisors made ready for udiv64_core::divide. A zero divisor gives a zero
// quotient, as numpy's integer division does: the launcher then turns the
// deltas it divides off (rewards, penalties false).
struct StagedFlag {
  uint64_t weight;
  uint64_t weight_increments;
  udiv64_core::UDiv64 by_divisor;             // active_increments * weight_denominator
  udiv64_core::UDiv64 by_weight_denominator;
  bool rewards;    // not leaking, and a nonzero reward divisor
  bool penalties;  // not the head flag, and a nonzero weight denominator
};

// One flag's scalars from the call's: every product and reciprocal the
// lanes share.
STAGED_HD StagedFlag staged_flag(uint64_t weight, uint64_t unslashed_increments,
                                 uint64_t reward_divisor, uint64_t weight_denominator,
                                 bool leaking, bool is_head) {
  StagedFlag s;
  s.weight = weight;
  s.weight_increments = weight * unslashed_increments;
  s.rewards = !leaking && reward_divisor != 0;
  s.penalties = !is_head && weight_denominator != 0;
  s.by_divisor = udiv64_core::prepare(reward_divisor != 0 ? reward_divisor : 1);
  s.by_weight_denominator = udiv64_core::prepare(weight_denominator != 0 ? weight_denominator : 1);
  return s;
}

// The reference's flag_deltas_kernel (models/epoch_vector.py:251) for one
// validator: a reward where it is eligible and unslashed, a penalty where it
// is eligible and not; each a multiply-high by its divisor's reciprocal.
STAGED_HD void flag_delta(const StagedFlag& s, uint64_t base_reward, bool eligible,
                          bool unslashed, uint64_t* reward, uint64_t* penalty) {
  *reward = (s.rewards && eligible && unslashed)
                ? udiv64_core::divide(base_reward * s.weight_increments, s.by_divisor)
                : 0;
  *penalty = (s.penalties && eligible && !unslashed)
                 ? udiv64_core::divide(base_reward * s.weight, s.by_weight_denominator)
                 : 0;
}

// The reference's apply_delta_pairs_kernel (models/epoch_vector.py:285) for
// one validator: pair j's reward and penalty at rewards[j * stride] and
// penalties[j * stride], applied in order with zero saturation between
// pairs; each add wraps.
STAGED_HD uint64_t apply_pairs(uint64_t balance, const uint64_t* rewards,
                               const uint64_t* penalties, int64_t k, int64_t stride) {
  for (int64_t j = 0; j < k; ++j) {
    const uint64_t raised = balance + rewards[j * stride];
    const uint64_t penalty = penalties[j * stride];
    balance = raised >= penalty ? raised - penalty : 0;
  }
  return balance;
}

// The flag deltas' columns, all (n,): the base rewards, the eligible and
// unslashed flags as one byte each, the rewards and penalties out.
// `chunks` whole warp chunks take the vector path (0 where a column is not
// aligned for it: the words to 16 bytes, the flags to 2).
struct FlagColumns {
  const uint64_t* base_reward;
  const uint8_t* eligible;
  const uint8_t* unslashed;
  int64_t n;
  int64_t chunks;
  uint64_t* rewards;
  uint64_t* penalties;
};

inline FlagColumns flag_columns(const void* base_reward, const void* eligible,
                                const void* unslashed, int64_t n, void* rewards,
                                void* penalties) {
  using warp_chunks::aligned;
  const bool vector = aligned(base_reward, 16) && aligned(rewards, 16) &&
                      aligned(penalties, 16) && aligned(eligible, 2) && aligned(unslashed, 2);
  return {static_cast<const uint64_t*>(base_reward), static_cast<const uint8_t*>(eligible),
          static_cast<const uint8_t*>(unslashed), n, vector ? n / warp_chunks::kChunk : 0,
          static_cast<uint64_t*>(rewards), static_cast<uint64_t*>(penalties)};
}

// The pairs' columns: the balances (n,), the rewards and penalties (k, n)
// row-major, the new balances out. A row starts 8 n bytes after the one
// before it, so the vector path needs an even n where k > 1.
struct PairColumns {
  const uint64_t* balances;
  const uint64_t* rewards;
  const uint64_t* penalties;
  int64_t n;
  int64_t k;
  int64_t chunks;
  uint64_t* out;
};

inline PairColumns pair_columns(const void* balances, const void* rewards, const void* penalties,
                                int64_t n, int64_t k, void* out) {
  using warp_chunks::aligned;
  const bool vector = aligned(balances, 16) && aligned(rewards, 16) && aligned(penalties, 16) &&
                      aligned(out, 16) && (k <= 1 || n % 2 == 0);
  return {static_cast<const uint64_t*>(balances), static_cast<const uint64_t*>(rewards),
          static_cast<const uint64_t*>(penalties), n, k, vector ? n / warp_chunks::kChunk : 0,
          static_cast<uint64_t*>(out)};
}

#ifndef __CUDACC__

// The kernels on a grid of `grid` blocks, run on the host in their order
// (warp_chunks::schedule_host). visits, where not null, counts each
// validator's visits.
inline void flag_deltas_host(const FlagColumns& c, const StagedFlag& s, int64_t grid,
                             uint8_t* visits) {
  warp_chunks::schedule_host(c.chunks, c.n, grid, [&](int64_t, int64_t i) {
    if (visits) visits[i] = static_cast<uint8_t>(visits[i] + 1);
    flag_delta(s, c.base_reward[i], c.eligible[i] != 0, c.unslashed[i] != 0, c.rewards + i,
               c.penalties + i);
  });
}

inline void apply_pairs_host(const PairColumns& c, int64_t grid, uint8_t* visits) {
  warp_chunks::schedule_host(c.chunks, c.n, grid, [&](int64_t, int64_t i) {
    if (visits) visits[i] = static_cast<uint8_t>(visits[i] + 1);
    c.out[i] = apply_pairs(c.balances[i], c.rewards + i, c.penalties + i, c.k, c.n);
  });
}

#endif  // __CUDACC__

}  // namespace epoch_staged
