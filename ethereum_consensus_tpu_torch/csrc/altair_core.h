// The per-validator arithmetic of the altair-family epoch sweeps, as
// __host__ __device__ functions.
//
// The arithmetic of the Hopper kernels in altair_sweeps.cu (flag deltas,
// inactivity updates, inactivity penalties), fused_epoch.cu (the fused
// epoch kernel) and chain_step.cu (the epoch step's element pass), and the
// columns of altair_sweeps.cu's kernels on warp_chunks.h's partition, with
// the inactivity updates' and penalties' schedules run on the host
// (inactivity_updates_host, inactivity_penalties_host). The header is plain
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
#include "warp_chunks.h"

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
// the flag deltas, the inactivity updates and the inactivity penalties),
// warp_chunks.h's, under the names the kernels and tests use.
using warp_chunks::aligned;
using warp_chunks::chunk_grid;
using warp_chunks::chunk_index;
using warp_chunks::kChunk;
using warp_chunks::kChunkSteps;
using warp_chunks::kSweepThreads;
using warp_chunks::kSweepWarps;
using warp_chunks::tail_first;
using warp_chunks::warp_rank;

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

// The inactivity updates' columns, all (n,): the scores, the participating
// and eligible flags as one byte each, the new scores out; `chunks` as in
// PenaltyColumns (the words 16-byte aligned, both flag columns 2-byte), of
// kSteps steps each.
struct UpdateColumns {
  const uint64_t* scores;
  const uint8_t* participating;
  const uint8_t* eligible;
  int64_t n;
  int64_t chunks;
  uint64_t* out;
};

template <int kSteps>
inline UpdateColumns update_columns(const void* scores, const void* participating,
                                    const void* eligible, int64_t n, void* out) {
  const bool vector = aligned(scores, 16) && aligned(out, 16) && aligned(participating, 2) &&
                      aligned(eligible, 2);
  return {static_cast<const uint64_t*>(scores), static_cast<const uint8_t*>(participating),
          static_cast<const uint8_t*>(eligible), n, vector ? n / (64 * kSteps) : 0,
          static_cast<uint64_t*>(out)};
}

// The steps of the inactivity updates' warp chunks: one (64 validators a
// warp, 512 blocks at 2^18, 2,048 at 2^20). Four, the other sweeps' count,
// left an SM one block of 8 warps at 2^18 (a shard of a 4-way mesh) and lost
// to one validator a thread there; one step came level with that at 2^18,
// with four at 2^20 and beat four at 2^21 + 5 (tools/sweep_forms.py).
constexpr int kUpdateSteps = 1;

#ifdef __CUDACC__

// The inactivity updates' kernel (B5-altair's, altair_sweeps.cu, and the
// staged update of epoch_staged.cu): a warp's chunks of kSteps steps (from
// its rank, a grid's warps apart), each step's loads issued before the
// first update; then this thread's validators past the chunks. A plain
// launch of chunk_grid<kSteps>(n) blocks of kSweepThreads.
template <int kSteps>
__global__ void __launch_bounds__(warp_chunks::kSweepThreads)
    inactivity_updates_kernel(UpdateColumns c, uint64_t bias, uint64_t recovery_rate,
                              bool leaking) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * warp_chunks::kSweepWarps;
  for (int64_t k = warp_chunks::warp_rank(blockIdx.x, static_cast<int>(threadIdx.x >> 5));
       k < c.chunks; k += warps) {
    ulonglong2 score[kSteps];
    unsigned part[kSteps], elig[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t i = warp_chunks::chunk_index<kSteps>(k, j, lane);
      score[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.scores + i));
      part[j] = __ldcs(reinterpret_cast<const unsigned short*>(c.participating + i));
      elig[j] = __ldcs(reinterpret_cast<const unsigned short*>(c.eligible + i));
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t i = warp_chunks::chunk_index<kSteps>(k, j, lane);
      *reinterpret_cast<ulonglong2*>(c.out + i) = make_ulonglong2(
          inactivity_update(score[j].x, part[j] & 0xffu, elig[j] & 0xffu, bias, recovery_rate,
                            leaking),
          inactivity_update(score[j].y, part[j] >> 8, elig[j] >> 8, bias, recovery_rate,
                            leaking));
    }
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * warp_chunks::kSweepThreads;
  for (int64_t i = warp_chunks::tail_first<kSteps>(c.chunks, blockIdx.x, threadIdx.x); i < c.n;
       i += threads) {
    c.out[i] = inactivity_update(c.scores[i], c.participating[i] != 0, c.eligible[i] != 0, bias,
                                 recovery_rate, leaking);
  }
}

#endif  // __CUDACC__

#ifndef __CUDACC__

// The penalties' and the updates' kernels on a grid of `grid` blocks, run
// on the host in their order (warp_chunks::schedule_host). visits, where not
// null, counts each validator's visits.
inline void inactivity_penalties_host(const PenaltyColumns& c,
                                      const udiv64_core::UDiv64& by_denominator, int64_t grid,
                                      uint8_t* visits) {
  warp_chunks::schedule_host(c.chunks, c.n, grid, [&](int64_t, int64_t i) {
    if (visits) visits[i] = static_cast<uint8_t>(visits[i] + 1);
    c.out[i] = inactivity_penalty(c.eff[i], c.scores[i], c.not_target[i] != 0, by_denominator);
  });
}

template <int kSteps = kUpdateSteps>
inline void inactivity_updates_host(const UpdateColumns& c, uint64_t bias, uint64_t recovery_rate,
                                    bool leaking, int64_t grid, uint8_t* visits) {
  warp_chunks::schedule_host<kSteps>(c.chunks, c.n, grid, [&](int64_t, int64_t i) {
    if (visits) visits[i] = static_cast<uint8_t>(visits[i] + 1);
    c.out[i] = inactivity_update(c.scores[i], c.participating[i] != 0, c.eligible[i] != 0, bias,
                                 recovery_rate, leaking);
  });
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
