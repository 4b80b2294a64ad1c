// The per-validator arithmetic of the altair-family epoch sweeps, as
// __host__ __device__ functions.
//
// The arithmetic of the Hopper kernels in altair_sweeps.cu (flag deltas,
// inactivity updates, inactivity penalties), fused_epoch.cu (the fused
// epoch kernel) and chain_step.cu (the epoch step's element pass), and the
// warp-chunk partition of altair_sweeps.cu with the inactivity penalties'
// schedule run on the host (inactivity_penalties_host). The header is plain
// C++ outside nvcc, so g++ builds the same functions for the CPU tests that
// hold them against the reference package's programs.
//
// All arithmetic is unsigned 64-bit and wraps as the reference's jnp.uint64
// programs do: the literal route has no lane guard, so a product past 2^64
// wraps silently there, and here.

#pragma once

#include <math.h>
#include <stdint.h>

#include "udiv64_core.h"

#ifdef __CUDACC__
#define ALTAIR_HD __host__ __device__ __forceinline__
#else
#define ALTAIR_HD inline
#endif

namespace altair_core {

ALTAIR_HD uint64_t umin(uint64_t a, uint64_t b) { return a < b ? a : b; }

ALTAIR_HD uint64_t umax(uint64_t a, uint64_t b) { return a > b ? a : b; }

// The reference's _isqrt_u64 (ops/sweeps.py:45), step for step: a float64
// seed (round to nearest, square root, truncate) plus one, six Newton steps
// each after a floor of one, then the two clamps. Its last clamp squares
// g + 1 in u64, which wraps for x near 2^64: at x = 2^64 - 1 it returns
// 2^32, one more than the exact root, and so does this.
ALTAIR_HD uint64_t isqrt_u64(uint64_t x) {
  uint64_t g = static_cast<uint64_t>(sqrt(static_cast<double>(x))) + 1;
  for (int i = 0; i < 6; ++i) {
    g = umax(g, 1);
    g = (g + x / g) >> 1;
  }
  if (g * g > x) g -= 1;
  if ((g + 1) * (g + 1) <= x) g += 1;
  return g;
}

// altair process_inactivity_updates for one validator (the reference's
// _inactivity_updates, ops/sweeps.py:147, and the first stage of
// fused_epoch_kernel).
ALTAIR_HD uint64_t inactivity_update(uint64_t score, bool participating,
                                     bool eligible, uint64_t bias,
                                     uint64_t recovery_rate, bool leaking) {
  if (!eligible) return score;
  score = participating ? score - umin(1, score) : score + bias;
  if (!leaking) score -= umin(recovery_rate, score);
  return score;
}

// The scalars of one flag's deltas (ops/sweeps.py:79-94): the base reward
// per increment from the total active balance, the flag's participating
// increments, and the divisor of its rewards. With flag_delta below, the
// reference's arithmetic with its divisions as written: the form that the
// CPU tests hold the kernel's lane (flag_base_reward, flag_penalty,
// flag_reward) against.
struct FlagScalars {
  uint64_t brpi;
  uint64_t unslashed_increments;
  uint64_t reward_divisor;
};

ALTAIR_HD FlagScalars flag_scalars(uint64_t total_active,
                                   uint64_t participating_sum,
                                   uint64_t increment,
                                   uint64_t base_reward_factor,
                                   uint64_t weight_denominator) {
  FlagScalars s;
  s.brpi = increment * base_reward_factor / isqrt_u64(total_active);
  s.unslashed_increments = participating_sum / increment;
  s.reward_divisor = (total_active / increment) * weight_denominator;
  return s;
}

// One flag's (reward, penalty) for one validator (ops/sweeps.py:84-111):
// the reward product is formed for every lane and wraps like the
// reference's.
ALTAIR_HD void flag_delta(uint64_t eff, bool participating, bool eligible,
                          const FlagScalars& s, uint64_t weight,
                          uint64_t increment, uint64_t weight_denominator,
                          bool leaking, bool is_head, uint64_t* reward,
                          uint64_t* penalty) {
  const uint64_t base_reward = (eff / increment) * s.brpi;
  const uint64_t numerator = base_reward * weight * s.unslashed_increments;
  *reward = (participating && eligible && !leaking)
                ? numerator / s.reward_divisor
                : 0;
  *penalty = (!is_head && eligible && !participating)
                 ? base_reward * weight / weight_denominator
                 : 0;
}

// What the flag-delta kernel's lanes share, made once a call on the host:
// the base reward per increment and its three fixed divisors made ready
// for udiv64_core::divide (the increment, the reward divisor, the weight
// denominator). The participating increments wait for the masked sum; they
// are divide(sum, increment).
struct FlagSweep {
  uint64_t brpi;
  udiv64_core::UDiv64 increment;
  udiv64_core::UDiv64 reward_divisor;
  udiv64_core::UDiv64 weight_denominator;
};

// flag_scalars' sum-free part; every divisor must be nonzero (the launcher
// refuses the inputs otherwise).
ALTAIR_HD FlagSweep flag_sweep(uint64_t total_active, uint64_t increment,
                               uint64_t base_reward_factor,
                               uint64_t weight_denominator) {
  FlagSweep s;
  s.brpi = increment * base_reward_factor / isqrt_u64(total_active);
  s.increment = udiv64_core::prepare(increment);
  s.reward_divisor =
      udiv64_core::prepare((total_active / increment) * weight_denominator);
  s.weight_denominator = udiv64_core::prepare(weight_denominator);
  return s;
}

// flag_delta on the sweep's reciprocals, in three parts: the base reward,
// the penalty (which needs no sum) and the reward; each division a
// multiply-high, and only where its lane needs it.
ALTAIR_HD uint64_t flag_base_reward(uint64_t eff, const FlagSweep& s) {
  return udiv64_core::divide(eff, s.increment) * s.brpi;
}

ALTAIR_HD uint64_t flag_penalty(uint64_t base_reward, bool participating,
                                bool eligible, const FlagSweep& s,
                                uint64_t weight, bool is_head) {
  return (!is_head && eligible && !participating)
             ? udiv64_core::divide(base_reward * weight, s.weight_denominator)
             : 0;
}

ALTAIR_HD uint64_t flag_reward(uint64_t base_reward, bool participating,
                               bool eligible, const FlagSweep& s,
                               uint64_t unslashed_increments, uint64_t weight,
                               bool leaking) {
  return (participating && eligible && !leaking)
             ? udiv64_core::divide(base_reward * weight * unslashed_increments,
                                   s.reward_divisor)
             : 0;
}


// The inactivity penalty of one validator (ops/sweeps.py:191).
ALTAIR_HD uint64_t inactivity_penalty(uint64_t eff, uint64_t score,
                                      bool not_target, uint64_t denominator) {
  return not_target ? eff * score / denominator : 0;
}

// inactivity_penalty on the denominator's reciprocal (made once a sweep by
// udiv64_core::prepare): the wrapped product's quotient by one multiply-high.
// The lane of the inactivity-penalties kernel and of B3's and K3's
// (sweep_inactivity_penalty).
ALTAIR_HD uint64_t inactivity_penalty(uint64_t eff, uint64_t score, bool not_target,
                                      const udiv64_core::UDiv64& by_denominator) {
  return not_target ? udiv64_core::divide(eff * score, by_denominator) : 0;
}

// The warp-chunk partition of the literal sweeps' kernels (altair_sweeps.cu:
// the flag deltas and the inactivity penalties). Blocks of kSweepThreads; a
// warp's chunk is kChunk consecutive validators in kChunkSteps steps: at
// step j lane t takes validators 64 j + 2 t and 64 j + 2 t + 1 (a 16-byte
// load of each word column, a 2-byte load of each flag column), so that
// each of the warp's loads is contiguous. The validators past the last
// whole chunk (all of them where a column is not aligned for the chunks)
// go one a thread: thread t of block b takes C + b kSweepThreads + t, C
// the chunks' validators, stepping by the grid's threads.
constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kChunkSteps = 4;
constexpr int kChunk = kChunkSteps * 64;

// The first of the two validators of `lane` at `step` of chunk `chunk`.
ALTAIR_HD int64_t chunk_index(int64_t chunk, int step, int lane) {
  return chunk * kChunk + 64 * step + 2 * lane;
}

// The first validator past the chunks of thread `thread` of block `block`.
ALTAIR_HD int64_t tail_first(int64_t chunks, int64_t block, int thread) {
  return chunks * kChunk + block * kSweepThreads + thread;
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The inactivity penalties' columns, all (n,): words, the not-target flags
// as one byte, the penalties out. `chunks` whole warp chunks take the
// vector path (0 where a column is not aligned for it: the words to 16
// bytes, the flags to 2).
struct PenaltyColumns {
  const uint64_t* eff;
  const uint64_t* scores;
  const uint8_t* not_target;
  int64_t n;
  int64_t chunks;
  uint64_t* out;
};

inline PenaltyColumns penalty_columns(const void* eff, const void* scores, const void* not_target,
                                      int64_t n, void* out) {
  const bool vector = aligned(eff, 16) && aligned(scores, 16) && aligned(out, 16) &&
                      aligned(not_target, 2);
  return {static_cast<const uint64_t*>(eff), static_cast<const uint64_t*>(scores),
          static_cast<const uint8_t*>(not_target), n, vector ? n / kChunk : 0,
          static_cast<uint64_t*>(out)};
}

// The grid of a warp chunk a warp (2,048 validators a block), at least one
// block: the penalties' (grids of one, two and four blocks an SM measured
// slower, tools/step_penalty_forms.py) and K1's (chain_step_core.h).
ALTAIR_HD int64_t chunk_grid(int64_t n) {
  const int64_t per_block = int64_t{kSweepWarps} * kChunk;
  const int64_t grid = (n + per_block - 1) / per_block;
  return grid > 1 ? grid : 1;
}

// Warp `warp` of block `block`, counted over the grid: its first chunk; its
// next are the grid's warps apart.
ALTAIR_HD int64_t warp_rank(int64_t block, int warp) { return block * kSweepWarps + warp; }

#ifndef __CUDACC__

// The penalties' kernel on a grid of `grid` blocks, run on the host in its
// order: each block's threads, each thread's chunks step by step (its two
// validators a step), then its validators past the chunks. visits, where
// not null, counts each validator's visits.
inline void inactivity_penalties_host(const PenaltyColumns& c,
                                      const udiv64_core::UDiv64& by_denominator, int64_t grid,
                                      uint8_t* visits) {
  const auto visit = [&](int64_t i) {
    if (visits) visits[i] = static_cast<uint8_t>(visits[i] + 1);
    c.out[i] = inactivity_penalty(c.eff[i], c.scores[i], c.not_target[i] != 0, by_denominator);
  };
  for (int64_t b = 0; b < grid; ++b) {
    for (int t = 0; t < kSweepThreads; ++t) {
      for (int64_t k = warp_rank(b, t / 32); k < c.chunks; k += grid * kSweepWarps) {
        for (int j = 0; j < kChunkSteps; ++j) {
          for (int h = 0; h < 2; ++h) visit(chunk_index(k, j, t % 32) + h);
        }
      }
      for (int64_t i = tail_first(c.chunks, b, t); i < c.n; i += grid * kSweepThreads) visit(i);
    }
  }
}

#endif  // __CUDACC__

// The constants and per-epoch scalars of the fused epoch kernel
// (epoch_vector.py:297): three flags, weights, flag sums already reduced.
struct FusedScalars {
  uint64_t increment;
  uint64_t brpi;
  uint64_t divisor;  // active_increments * weight_denominator
  uint64_t denominator;
  uint64_t bias;
  uint64_t recovery_rate;
  uint64_t weights[3];
  uint64_t unslashed_increments[3];  // max(increment, flag sum) / increment
  uint64_t weight_denominator;
  bool leaking;
  int head_flag_index;
  int target_flag_index;
};

// max(increment, flag_sum) / increment for each flag (epoch_vector.py:356).
ALTAIR_HD void fused_flag_increments(FusedScalars* s, const uint64_t sums[3]) {
  for (int f = 0; f < 3; ++f) {
    s->unslashed_increments[f] = umax(s->increment, sums[f]) / s->increment;
  }
}

// One validator's rewards and penalties, operation for operation the
// reference's fused_epoch_kernel after its inactivity update: three flag
// pairs, the inactivity penalty off `score` (the POST-update score), then the
// four pairs applied in sequence with zero saturation between them. Returns
// the number of pairs whose add wrapped (the reference's wrap census). The
// lane of the reference's mesh twin _rewards_sharded (parallel/epoch.py:132),
// which reads the scores after the update.
ALTAIR_HD int rewards_lane(const FusedScalars& s, uint64_t balance, uint64_t eff,
                           uint8_t part, bool slashed, bool active_prev, bool eligible,
                           uint64_t score, uint64_t* new_balance) {
  const bool unslashed_active = active_prev && !slashed;
  const bool participating =
      unslashed_active && ((part >> s.target_flag_index) & 1);
  const uint64_t base_reward = (eff / s.increment) * s.brpi;
  int wrapped = 0;
  uint64_t bal = balance;
  for (int f = 0; f < 3; ++f) {
    const bool unslashed = unslashed_active && ((part >> f) & 1);
    const uint64_t w = s.weights[f];
    const uint64_t reward =
        (!s.leaking && eligible && unslashed)
            ? base_reward * w * s.unslashed_increments[f] / s.divisor
            : 0;
    const uint64_t penalty =
        (f != s.head_flag_index && eligible && !unslashed)
            ? base_reward * w / s.weight_denominator
            : 0;
    const uint64_t raised = bal + reward;
    wrapped += raised < bal;
    bal = raised >= penalty ? raised - penalty : 0;
  }
  const uint64_t penalty =
      (eligible && !participating) ? eff * score / s.denominator : 0;
  bal = bal >= penalty ? bal - penalty : 0;  // the pair's reward is 0
  *new_balance = bal;
  return wrapped;
}

// One validator through the fused epoch kernel, operation for operation the
// reference's fused_epoch_kernel: the inactivity update, then the lane of
// rewards_lane off the POST-update score.
ALTAIR_HD int fused_epoch_lane(const FusedScalars& s, uint64_t balance,
                               uint64_t eff, uint8_t part, bool slashed,
                               bool active_prev, bool eligible,
                               uint64_t score, uint64_t* new_score,
                               uint64_t* new_balance) {
  const bool participating =
      active_prev && !slashed && ((part >> s.target_flag_index) & 1);
  const uint64_t score_out = inactivity_update(
      score, participating, eligible, s.bias, s.recovery_rate, s.leaking);
  *new_score = score_out;
  return rewards_lane(s, balance, eff, part, slashed, active_prev, eligible,
                      score_out, new_balance);
}

// What the lanes of the fused epoch kernel and the epoch step share, made
// once a call on the host (fused_sweep): FusedScalars with its four fixed
// divisors (the increment, the reward divisor, the weight denominator, the
// penalty denominator) made ready for udiv64_core::divide. With the lane
// below, fused_epoch_lane and rewards_lane with every division a
// multiply-high; the lanes above, with the divisions as written, are the
// form the CPU tests hold these against.
struct FusedSweep {
  uint64_t increment;
  uint64_t brpi;
  uint64_t bias;
  uint64_t recovery_rate;
  uint64_t weights[3];
  uint64_t unslashed_increments[3];
  udiv64_core::UDiv64 by_increment;
  udiv64_core::UDiv64 by_divisor;
  udiv64_core::UDiv64 by_weight_denominator;
  udiv64_core::UDiv64 by_denominator;
  bool leaking;
  int head_flag_index;
  int target_flag_index;
};

// The scalars' reciprocals; every divisor must be nonzero (the launchers
// refuse the inputs otherwise). The unslashed increments are copied: the
// epoch step's (no floor) or those fused_flag_increments made; the fused
// kernel makes its own from the grid's sums (floored_increments).
ALTAIR_HD FusedSweep fused_sweep(const FusedScalars& s) {
  FusedSweep out;
  out.increment = s.increment;
  out.brpi = s.brpi;
  out.bias = s.bias;
  out.recovery_rate = s.recovery_rate;
  for (int f = 0; f < 3; ++f) {
    out.weights[f] = s.weights[f];
    out.unslashed_increments[f] = s.unslashed_increments[f];
  }
  out.by_increment = udiv64_core::prepare(s.increment);
  out.by_divisor = udiv64_core::prepare(s.divisor);
  out.by_weight_denominator = udiv64_core::prepare(s.weight_denominator);
  out.by_denominator = udiv64_core::prepare(s.denominator);
  out.leaking = s.leaking;
  out.head_flag_index = s.head_flag_index;
  out.target_flag_index = s.target_flag_index;
  return out;
}

// fused_flag_increments for one flag: max(increment, sum) / increment.
ALTAIR_HD uint64_t floored_increments(const FusedSweep& s, uint64_t sum) {
  return udiv64_core::divide(umax(s.increment, sum), s.by_increment);
}

// A validator's four flags as the lane reads them: bit f (0..2) its
// participation flag f if it is unslashed and was active in the previous
// epoch, bit 3 eligible.
ALTAIR_HD unsigned lane_flags(uint8_t part, bool slashed, bool active_prev, bool eligible) {
  return ((active_prev && !slashed) ? (part & 7u) : 0u) | (eligible ? 8u : 0u);
}

ALTAIR_HD bool flags_participating(const FusedSweep& s, unsigned flags) {
  return (flags >> s.target_flag_index) & 1;
}

// The inactivity update on the lane's flags.
ALTAIR_HD uint64_t sweep_update(const FusedSweep& s, uint64_t score, unsigned flags) {
  return inactivity_update(score, flags_participating(s, flags), flags & 8u, s.bias,
                           s.recovery_rate, s.leaking);
}

ALTAIR_HD uint64_t sweep_base_reward(const FusedSweep& s, uint64_t eff) {
  return udiv64_core::divide(eff, s.by_increment) * s.brpi;
}

// The inactivity penalty off `score` (the POST-update score).
ALTAIR_HD uint64_t sweep_inactivity_penalty(const FusedSweep& s, uint64_t eff, uint64_t score,
                                            unsigned flags) {
  return inactivity_penalty(eff, score, (flags & 8u) && !flags_participating(s, flags),
                            s.by_denominator);
}

// The four pairs applied in sequence with zero saturation between them,
// from the base reward and the inactivity penalty: the part of the lane
// that needs the flag sums, each flag's unslashed increments in
// `increments`. A validator earns a flag's reward or pays its penalty, never
// both, so each flag takes one division: the reward's numerator
// base_reward * (weight * increments) by the reward divisor (the products
// wrap mod 2^64 as base_reward * weight * increments does), or the
// penalty's base_reward * weight by the weight denominator. Returns the
// number of adds that wrapped.
ALTAIR_HD int sweep_apply(const FusedSweep& s, const uint64_t (&increments)[3], uint64_t balance,
                          uint64_t base_reward, uint64_t inactivity_penalty, unsigned flags,
                          uint64_t* new_balance) {
  const bool eligible = flags & 8u;
  int wrapped = 0;
  uint64_t bal = balance;
  for (int f = 0; f < 3; ++f) {
    const bool unslashed = (flags >> f) & 1;
    const uint64_t w = s.weights[f];
    const uint64_t quotient = udiv64_core::divide(
        base_reward * (unslashed ? w * increments[f] : w),
        unslashed ? s.by_divisor : s.by_weight_denominator);
    const uint64_t reward = (!s.leaking && eligible && unslashed) ? quotient : 0;
    const uint64_t penalty = (f != s.head_flag_index && eligible && !unslashed) ? quotient : 0;
    const uint64_t raised = bal + reward;
    wrapped += raised < bal;
    bal = raised >= penalty ? raised - penalty : 0;
  }
  bal = bal >= inactivity_penalty ? bal - inactivity_penalty : 0;  // the pair's reward is 0
  *new_balance = bal;
  return wrapped;
}

// sweep_apply on the sweep's own increments.
ALTAIR_HD int sweep_apply(const FusedSweep& s, uint64_t balance, uint64_t base_reward,
                          uint64_t inactivity_penalty, unsigned flags, uint64_t* new_balance) {
  return sweep_apply(s, s.unslashed_increments, balance, base_reward, inactivity_penalty, flags,
                     new_balance);
}

// rewards_lane on the sweep's reciprocals.
ALTAIR_HD int rewards_lane(const FusedSweep& s, uint64_t balance, uint64_t eff, uint8_t part,
                           bool slashed, bool active_prev, bool eligible, uint64_t score,
                           uint64_t* new_balance) {
  const unsigned flags = lane_flags(part, slashed, active_prev, eligible);
  return sweep_apply(s, balance, sweep_base_reward(s, eff),
                     sweep_inactivity_penalty(s, eff, score, flags), flags, new_balance);
}

// fused_epoch_lane on the sweep's reciprocals.
ALTAIR_HD int fused_epoch_lane(const FusedSweep& s, uint64_t balance, uint64_t eff,
                               uint8_t part, bool slashed, bool active_prev, bool eligible,
                               uint64_t score, uint64_t* new_score, uint64_t* new_balance) {
  const unsigned flags = lane_flags(part, slashed, active_prev, eligible);
  const uint64_t score_out = sweep_update(s, score, flags);
  *new_score = score_out;
  return sweep_apply(s, balance, sweep_base_reward(s, eff),
                     sweep_inactivity_penalty(s, eff, score_out, flags), flags, new_balance);
}

}  // namespace altair_core
