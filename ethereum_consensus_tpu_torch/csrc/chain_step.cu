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
//     balances and active flags, a thread per SSZ chunk of four validators:
//     the new effective balances (the hysteresis sweep), the balance chunk
//     words written straight into the (8, n/4) int32 layout that merkle.cu
//     reads (word w of chunk c at w * n/4 + c, so each of the eight stores of
//     a warp is coalesced), and the sum of the active new effective balances
//     into one device word (warp shuffles, one 64-bit atomicAdd a block).
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
// (the hysteresis remainder is a software division) and about a hundred for
// the element pass, with up to five multiply-high divisions of about 17
// each, below the byte time at the dispatch rate. The chain step is a simple design: plain
// 8-byte loads, one thread per chunk.

#include <cuda_runtime.h>
#include <stdint.h>

#include "chain_step_core.h"
#include "epoch_pass.h"
#include "masked_sums.h"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceBlocks = 1056;  // 8 per SM of an H100

using masked_sums::warp_sum;

// Adds the block's sum of acc (one per thread) into *total, one atomicAdd
// a block.
__device__ __forceinline__ void block_sum_into(uint64_t acc, unsigned long long* total) {
  __shared__ uint64_t warp_sums[kThreads / 32];
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    const uint64_t v = warp_sum(threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0);
    if (threadIdx.x == 0 && v != 0) atomicAdd(total, static_cast<unsigned long long>(v));
  }
}

unsigned grid_for(int64_t items) {
  const int64_t blocks = (items + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kReduceBlocks ? blocks : kReduceBlocks);
}

__global__ void __launch_bounds__(kThreads)
    chain_step_shard_kernel(chain_step_core::Hysteresis h,
                            const uint64_t* __restrict__ balances,
                            const uint64_t* __restrict__ effective,
                            const bool* __restrict__ active, int64_t chunks,
                            uint64_t* __restrict__ new_effective,
                            uint32_t* __restrict__ words,
                            unsigned long long* __restrict__ total) {
  uint64_t acc = 0;
  for (int64_t c = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       c < chunks; c += static_cast<int64_t>(gridDim.x) * kThreads) {
    const int64_t base = c * chain_step_core::kPerChunk;
    uint64_t bal[chain_step_core::kPerChunk], eff[chain_step_core::kPerChunk];
    bool act[chain_step_core::kPerChunk];
    for (int k = 0; k < chain_step_core::kPerChunk; ++k) {
      bal[k] = balances[base + k];
      eff[k] = effective[base + k];
      act[k] = active[base + k];
    }
    uint64_t out[chain_step_core::kPerChunk];
    uint32_t w[8];
    acc += chain_step_core::chunk_lane(h, bal, eff, act, out, w);
    for (int k = 0; k < chain_step_core::kPerChunk; ++k) new_effective[base + k] = out[k];
    for (int r = 0; r < 8; ++r) words[r * chunks + c] = w[r];
  }
  block_sum_into(acc, total);
}

}  // namespace

// balances, effective, new_effective: (n,) 64-bit words; active: (n,)
// one-byte booleans; words: (8, n / 4) 32-bit words; total: one 64-bit
// word, zeroed here. n must be a multiple of 4. Launches on `stream` and
// returns cudaGetLastError() (0 = launched); n == 0 launches nothing but
// the zeroing.
extern "C" int chain_step_shard_launch(const void* balances, const void* effective,
                                       const void* active, int64_t n, uint64_t increment,
                                       uint64_t max_effective, uint64_t down, uint64_t up,
                                       void* new_effective, void* words, void* total,
                                       void* stream) {
  if (n < 0 || n % chain_step_core::kPerChunk != 0 || increment == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(total, 0, sizeof(uint64_t), s);
  if (rc != cudaSuccess || n == 0) return static_cast<int>(rc);
  const int64_t chunks = n / chain_step_core::kPerChunk;
  const chain_step_core::Hysteresis h{increment, max_effective, down, up};
  chain_step_shard_kernel<<<grid_for(chunks), kThreads, 0, s>>>(
      h, static_cast<const uint64_t*>(balances), static_cast<const uint64_t*>(effective),
      static_cast<const bool*>(active), chunks, static_cast<uint64_t*>(new_effective),
      static_cast<uint32_t*>(words), static_cast<unsigned long long*>(total));
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
