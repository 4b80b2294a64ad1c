// The per-lane arithmetic of the sharded chain step and of the sharded
// epoch sweep step, as __host__ __device__ functions.
//
// The arithmetic of the Hopper kernels in chain_step.cu. The header is plain
// C++ outside nvcc, so g++ builds the same functions for the CPU tests that
// hold them against the reference package's steps
// (ethereum_consensus_tpu/parallel/step.py).
//
// The chain step (step.py:112-145) for one validator: its hysteresis
// update (sweeps_core.h, on the increment's reciprocal made once a call on
// the host by hysteresis()), its new effective balance's share of the
// total if it is active, and its two of its SSZ chunk's eight big-endian
// 32-bit words (u64_to_be_words, step.py:56: SSZ packs each balance little
// endian, and word 2k of a chunk is the byte swap of balance k's low half,
// word 2k + 1 of its high half).
//
// K1's partition (chain_step.cu) is the warp-chunk partition of
// warp_chunks.h, the other byte-bound sweeps': a warp
// takes kChunk consecutive validators, at step j lane t validators 64 j +
// 2 t and 64 j + 2 t + 1 (a 16-byte load of each word column and 2 bytes
// of the flags; a 16-byte store of their new effective balances; the four
// words of their half of SSZ chunk (64 j + 2 t) / 4: rows 0..3 for an even
// lane, 4..7 for an odd one), all four steps' loads issued before the
// first division; the validators past the last whole warp chunk (all of
// them where a column is not aligned: the word columns to 16 bytes, the
// flags to 2) go one a thread. The grid: a warp chunk a warp
// (warp_chunks::chunk_grid, 512 blocks at 2^20 validators: one wave at 4
// blocks an SM). Each block adds its share of the total into the zeroed
// total word with one atomic (addition mod 2^64: any order gives the same
// bits). chain_step_host runs that schedule for g++ (block by block, thread
// by thread, step by step, then the blocks' shares in block order).
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
#include "udiv64_core.h"
#include "warp_chunks.h"

#ifndef __CUDACC__
#include <vector>
#endif

#ifdef __CUDACC__
#define CHAIN_HD __host__ __device__ __forceinline__
#else
#define CHAIN_HD inline
#endif

namespace chain_step_core {

// Validators of one SSZ chunk of a List[uint64, N].
constexpr int kPerChunk = 4;

// The hysteresis constants made ready (sweeps_core.h).
using sweeps_core::Hysteresis;
using sweeps_core::hysteresis;

CHAIN_HD uint32_t bswap32(uint32_t x) {
  return (x >> 24) | ((x >> 8) & 0xFF00u) | ((x << 8) & 0xFF0000u) | (x << 24);
}

// One validator through the chain step: its new effective balance and its
// two chunk words (the byte swaps of its balance's low and high halves)
// written, its share of the total (its new effective balance if active)
// returned.
CHAIN_HD uint64_t validator_lane(const Hysteresis& h, uint64_t balance, uint64_t effective,
                                 bool active, uint64_t* new_effective, uint32_t* lo,
                                 uint32_t* hi) {
  const uint64_t e = sweeps_core::effective_balance_update(balance, effective, h);
  *new_effective = e;
  *lo = bswap32(static_cast<uint32_t>(balance));
  *hi = bswap32(static_cast<uint32_t>(balance >> 32));
  return active ? e : 0;
}

// K1's columns, all (n,) but words (8, n / 4): words and flags as in
// chain_step.cu's launcher. `chunks` whole warp chunks take the vector path
// (0 where a column is not aligned for it).
struct ChainColumns {
  const uint64_t* balances;
  const uint64_t* effective;
  const uint8_t* active;
  int64_t n;
  int64_t chunks;
  uint64_t* new_effective;
  uint32_t* words;
};

inline ChainColumns chain_columns(const void* balances, const void* effective, const void* active,
                                  int64_t n, void* new_effective, void* words) {
  using warp_chunks::aligned;
  const bool vector = aligned(balances, 16) && aligned(effective, 16) &&
                      aligned(new_effective, 16) && aligned(active, 2);
  return {static_cast<const uint64_t*>(balances), static_cast<const uint64_t*>(effective),
          static_cast<const uint8_t*>(active), n, vector ? n / warp_chunks::kChunk : 0,
          static_cast<uint64_t*>(new_effective), static_cast<uint32_t*>(words)};
}

// Validator i's two words into their rows: 2 (i % 4) and 2 (i % 4) + 1 of
// column i / 4.
CHAIN_HD void store_words(const ChainColumns& c, int64_t i, uint32_t lo, uint32_t hi) {
  const uint64_t v = static_cast<uint64_t>(i);
  const uint64_t columns = static_cast<uint64_t>(c.n) / kPerChunk;
  uint32_t* word = c.words + 2 * (v % kPerChunk) * columns + v / kPerChunk;
  word[0] = lo;
  word[columns] = hi;
}

#ifndef __CUDACC__

// K1 on a grid of `grid` blocks, run on the host in its order: each block's
// threads, each thread's warp chunks step by step (its two validators a
// step), then its validators past the chunks, each through the lane into
// the outputs and the block's share of the total; then the shares added in
// block order. Returns the total; visits, where not null, counts each
// validator's visits.
inline uint64_t chain_step_host(const ChainColumns& c, const Hysteresis& h, int64_t grid,
                                uint8_t* visits) {
  std::vector<uint64_t> partials(static_cast<size_t>(grid), 0);
  warp_chunks::schedule_host(c.chunks, c.n, grid, [&](int64_t b, int64_t i) {
    if (visits) visits[i] = static_cast<uint8_t>(visits[i] + 1);
    uint32_t lo, hi;
    partials[static_cast<size_t>(b)] += validator_lane(
        h, c.balances[i], c.effective[i], c.active[i] != 0, &c.new_effective[i], &lo, &hi);
    store_words(c, i, lo, hi);
  });
  uint64_t total = 0;
  for (const uint64_t p : partials) total += p;
  return total;
}

#endif  // __CUDACC__

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
