// The shard kernels of the sharded chain step and of the sharded epoch sweep
// step, for Hopper (sm_90a).
//
// Replace the per-shard bodies of the reference package's two shard_map
// programs, ethereum_consensus_tpu/parallel/step.py:75 make_chain_step (body
// :112-145) and :254 _epoch_sweep_step (body :294-383). The arithmetic is
// chain_step_core.h's; the reductions across shards (the reference's psum
// and all_gather) and the merkle reduction (B2, merkle.cu) run outside.
//
//   chain_step_shard_launch  one pass over a shard's balances, effective
//     balances and active flags on chain_step_core.h's partition (the warp
//     chunks of the flag deltas and the penalties: a lane two validators a
//     step, a 16-byte load of each word column and 2 bytes of the flags, one
//     wave of a warp chunk a warp at 2^20): the new effective balances (the
//     hysteresis sweep, the remainder by the increment a multiply-high by its
//     reciprocal, made once a call here), the balance chunk words written
//     straight into the (8, n/4) int32 layout that merkle.cu reads (word w
//     of chunk c at w * n/4 + c: a lane writes the four words of its half
//     chunk, sixteen lanes of a warp each row's 64 contiguous bytes), and
//     the sum of the active new effective balances: the total zeroed on the
//     stream, then each block's sum (masked_sums::block_sum) added with one
//     64-bit atomicAdd. That finish was 0.3-0.6 us faster at 2^20 than a
//     cooperative launch whose block 0 adds the blocks' partial words after
//     a grid sync, in three calls of four (tools/step_forms.cu form 3).
//   epoch_step_sums_launch  masked_sums.h's kernel at K = 4: the three flag
//     sums over the unslashed validators active in the previous epoch and
//     the effective balance active in the current epoch, four words mod
//     2^64; a thread takes 8 consecutive validators a step (four 16-byte
//     loads of the effective balances, one 8-byte load of each byte column),
//     each block a contiguous range, and the blocks' partial words are added
//     after a grid sync in the same cooperative launch.
//   epoch_step_apply_launch  the element pass: epoch_pass.h's apply_kernel
//     (warp chunks of 256 validators, one launch a chunk a warp, 4 blocks an
//     SM at 64 registers; each lane's two validators a step read 16 bytes of
//     each word column and 2 of each byte column, and written 16 bytes of
//     each output), running altair_core.h's lane on reciprocals over the
//     scalars that chain_step_core.h's epoch_step_scalars makes from the
//     summed words; the launcher makes the scalars and the reciprocals of
//     their four fixed divisors (udiv64_core.h) once on the host, so a lane
//     divides by multiply-highs alone, one a flag (a validator earns a flag's
//     reward or pays its penalty, never both).
//
// Inputs: unsigned 64-bit words (int64 tensors carry the bit patterns),
// participation flags as bytes, booleans as one byte; all contiguous on the
// current device. Outputs are written whole; the chain step's total is
// zeroed here on the stream, the epoch step's sums need no zeroing.
//
// What bounds them on an H100: bytes. The chain step reads 17 bytes a
// validator (two words, a flag) and writes 16 (the new effective balance,
// two chunk words): 33 bytes, 34.6 MB at 2^20 validators, about 10.3 us at
// 3.35 TB/s; the sums read 12 bytes a validator (a word, four flags), about
// 3.8 us at 2^20; the element pass reads 28 and writes 16, about 13.8 us.
// The integer work is a few dozen operations a validator for the first two
// (the hysteresis remainder one multiply-high) and about a hundred for the
// element pass, with up to five multiply-high divisions of about 17 each,
// below the byte time at the dispatch rate. The alternatives the chain step
// was measured against (a block's range of chunks a chunk or two a thread,
// a grid-stride partition, the grid-sync finish, the earlier two-wave
// schedule) live in tools/step_forms.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_step_core.h"
#include "epoch_pass.h"
#include "masked_sums.h"

namespace {

constexpr int kThreads = masked_sums::kThreads;
// Blocks an SM the kernel's registers must allow (64 a thread), so that
// 2^20 validators (512 blocks of a warp chunk a warp) run in one wave.
constexpr int kMinBlocks = masked_sums::kThreadsPerSm / kThreads;

using chain_step_core::kPerChunk;

// K1. total: one word, zeroed before the launch.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    chain_step_shard_kernel(chain_step_core::Hysteresis h, chain_step_core::ChainColumns c,
                            unsigned long long* __restrict__ total) {
  using altair_core::kChunkSteps;
  __shared__ uint64_t warp_sums[1][masked_sums::kWarps];
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * masked_sums::kWarps;
  uint64_t acc[1] = {0};
  for (int64_t k = altair_core::warp_rank(blockIdx.x, threadIdx.x >> 5); k < c.chunks;
       k += warps) {
    ulonglong2 bal[kChunkSteps], eff[kChunkSteps];
    unsigned act[kChunkSteps];
#pragma unroll
    for (int j = 0; j < kChunkSteps; ++j) {
      const int64_t i = altair_core::chunk_index(k, j, lane);
      bal[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.balances + i));
      eff[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.effective + i));
      act[j] = __ldcs(reinterpret_cast<const unsigned short*>(c.active + i));
    }
#pragma unroll
    for (int j = 0; j < kChunkSteps; ++j) {
      const int64_t i = altair_core::chunk_index(k, j, lane);
      uint64_t out0, out1;
      uint32_t lo0, hi0, lo1, hi1;
      acc[0] += chain_step_core::validator_lane(h, bal[j].x, eff[j].x, act[j] & 0xffu, &out0,
                                                &lo0, &hi0);
      acc[0] += chain_step_core::validator_lane(h, bal[j].y, eff[j].y, act[j] >> 8, &out1, &lo1,
                                                &hi1);
      *reinterpret_cast<ulonglong2*>(c.new_effective + i) = make_ulonglong2(out0, out1);
      chain_step_core::store_words(c, i, lo0, hi0);
      chain_step_core::store_words(c, i + 1, lo1, hi1);
    }
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = altair_core::tail_first(c.chunks, blockIdx.x, threadIdx.x); i < c.n;
       i += threads) {
    uint32_t lo, hi;
    acc[0] += chain_step_core::validator_lane(h, c.balances[i], c.effective[i], c.active[i] != 0,
                                              &c.new_effective[i], &lo, &hi);
    chain_step_core::store_words(c, i, lo, hi);
  }
  masked_sums::block_sum<1>(acc, warp_sums);
  if (threadIdx.x == 0 && acc[0] != 0) atomicAdd(total, static_cast<unsigned long long>(acc[0]));
}

}  // namespace

// balances, effective, new_effective: (n,) 64-bit words; active: (n,)
// one-byte booleans; words: (8, n / 4) 32-bit words; total: one 64-bit
// word, zeroed here. n must be a multiple of 4 and the increment nonzero.
// Launches on `stream` and returns cudaGetLastError() (0 = launched); n ==
// 0 launches nothing but the zeroing.
extern "C" int chain_step_shard_launch(const void* balances, const void* effective,
                                       const void* active, int64_t n, uint64_t increment,
                                       uint64_t max_effective, uint64_t down, uint64_t up,
                                       void* new_effective, void* words, void* total,
                                       void* stream) {
  if (n < 0 || n % kPerChunk != 0 || increment == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(total, 0, sizeof(uint64_t), s);
  if (rc != cudaSuccess || n == 0) return static_cast<int>(rc);
  chain_step_shard_kernel<<<static_cast<unsigned>(altair_core::chunk_grid(n)), kThreads, 0, s>>>(
      chain_step_core::hysteresis(increment, max_effective, down, up),
      chain_step_core::chain_columns(balances, effective, active, n, new_effective, words),
      static_cast<unsigned long long*>(total));
  return static_cast<int>(cudaGetLastError());
}

// eff: (n,) 64-bit words; part: (n,) bytes; slashed, active_prev,
// active_cur: (n,) one-byte booleans. words: word_count 64-bit words, at
// least 8: after the kernel words[0..3] hold the three flag sums and the
// active-current total; the rest takes four partial words a block (the grid
// is cut to fit them). One cooperative launch, also at n == 0; returns its
// error (0 = launched).
extern "C" int epoch_step_sums_launch(const void* eff, const void* part, const void* slashed,
                                      const void* active_prev, const void* active_cur,
                                      int64_t n, void* words, int64_t word_count,
                                      void* stream) {
  return masked_sums::launch<4>(eff, part, slashed, active_prev, active_cur, n, words,
                                word_count, stream);
}

// The element pass on the summed words (flag0, flag1, flag2, active-current
// total, mod 2^64) and the chain constants. balances, eff, scores,
// out_scores, out_balances: (n,) 64-bit words; part: (n,) bytes; slashed,
// active_prev, eligible: (n,) one-byte booleans. A zero increment, weight
// denominator, reward divisor or penalty denominator, or a flag index outside
// 0..2, is refused. Returns cudaGetLastError(); n == 0 launches nothing.
extern "C" int epoch_step_apply_launch(
    const void* balances, const void* eff, const void* part, const void* slashed,
    const void* active_prev, const void* eligible, const void* scores, int64_t n,
    uint64_t sum0, uint64_t sum1, uint64_t sum2, uint64_t active_total, uint64_t increment,
    uint64_t base_reward_factor, uint64_t bias, uint64_t recovery_rate,
    uint64_t inactivity_quotient, uint64_t weight0, uint64_t weight1, uint64_t weight2,
    uint64_t weight_denominator, int leaking, int head_flag_index, int target_flag_index,
    void* out_scores, void* out_balances, void* stream) {
  if (n < 0 || increment == 0 || weight_denominator == 0 || head_flag_index < 0 ||
      head_flag_index > 2 || target_flag_index < 0 || target_flag_index > 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const chain_step_core::EpochConstants c{
      increment, base_reward_factor, bias, recovery_rate, inactivity_quotient,
      {weight0, weight1, weight2}, weight_denominator, leaking != 0, head_flag_index,
      target_flag_index};
  const uint64_t sums[4] = {sum0, sum1, sum2, active_total};
  uint64_t total_active = 0;
  const altair_core::FusedScalars scalars =
      chain_step_core::epoch_step_scalars(c, sums, &total_active);
  if (scalars.divisor == 0 || scalars.denominator == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  // the wrap census of the fused epoch kernel has no counterpart in the step
  const epoch_pass::Columns columns = epoch_pass::make_columns(
      balances, eff, part, slashed, active_prev, eligible, scores, n, out_scores,
      out_balances);
  epoch_pass::apply_kernel<true, false>
      <<<static_cast<unsigned>(epoch_pass::blocks_for(n)), epoch_pass::kThreads, 0,
         static_cast<cudaStream_t>(stream)>>>(columns, altair_core::fused_sweep(scalars),
                                              nullptr);
  return static_cast<int>(cudaGetLastError());
}
