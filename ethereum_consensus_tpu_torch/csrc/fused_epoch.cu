// The fused altair-family epoch kernel, for Hopper (sm_90a).
//
// Replaces the XLA program of the reference package
// ethereum_consensus_tpu/models/epoch_vector.py:297 fused_epoch_kernel
// (jitted at :188): the inactivity update, three participation-flag delta
// pairs off masked effective-balance sums, the inactivity penalty off the
// post-update scores, and the four pairs applied in sequence with zero
// saturation between them, with a census of the adds that wrapped. The
// per-validator arithmetic is altair_core.h's lane on reciprocals
// (FusedSweep), the partition and the chunk code epoch_pass.h's.
//
// Inputs: balances, effective balances and inactivity scores as unsigned
// 64-bit words (int64 tensors carry the bit patterns); previous-epoch
// participation flags as bytes; slashed, active-in-the-previous-epoch and
// eligible as one-byte booleans; all (n,). The per-epoch scalars and the
// chain constants arrive as kernel arguments. Outputs: new scores and new
// balances (n,), the three flag sums and the wrap census in device words.
//
// Design: one cooperative launch, its grid no larger than the blocks that
// fit on the card at once: 4 an SM at 64 registers, so that at 2^20 (512
// blocks) every warp has one chunk of 256 validators. The rewards need the
// three flag sums, so phase 1 reads the columns it needs once (the
// effective balances and scores 16 bytes a lane, the four byte columns two
// bytes a lane), writes the updated scores (they need no sum), sums its
// block's share of the three masked sums into three words of the call's
// scratch, and keeps each thread's first chunk in shared memory (32 KB a
// block): the base rewards, the inactivity penalties off the updated scores,
// and the flags. A grid sync; then every block adds the partial words
// (addition mod 2^64 is associative, so every block has the same totals) and
// makes each flag's increments with one multiply-high. Phase 2 reads the
// balances (the one column phase 1 does not need), applies the four pairs
// from what was kept, one division a flag (a validator earns a flag's reward
// or pays its penalty, never both), and writes the balances 16 bytes a
// lane; chunks past a warp's first (a registry larger than the grid holds)
// and the validators past the whole chunks are read again, one at a time.
// Every division is by a value fixed for the epoch: a multiply-high by a
// reciprocal (udiv64_core.h) that the launcher makes once on the host. The
// wrap census (zero for a real state) is summed per warp and per block, so
// a block adds to the device word at most once.
//
// The reference's mesh twins add every shard's sums before any shard
// applies them, so the pass's halves are entries of their own too:
// fused_flag_sums_launch (the three sums: masked_sums.h's kernel at K = 3,
// one cooperative launch that adds the blocks' partial words after a grid
// sync) and, on sums the caller gives, fused_epoch_apply_launch and rewards_apply_launch
// (the rewards alone off post-update scores): one launch each of
// epoch_pass.h's apply_kernel, a chunk a warp, the increments made by the
// launcher.
//
// What bounds it on an H100: bytes. The pass reads 28 bytes a validator
// (three words, four one-byte columns) and writes 16: 44 bytes, 46 MB at
// 2^20, about 13.8 us at 3.35 TB/s, plus what phase 2 reads again where the
// grid keeps less than the whole registry. A lane makes one to five
// multiply-high divisions, about 17 integer operations each; chip_smoke.py
// counts those its data needs against the dispatch rate and reports
// whichever bound is larger. tools/epoch_forms.py times the kernel beside
// the earlier design and a copy of the same bytes.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "altair_core.h"
#include "epoch_pass.h"
#include "masked_sums.h"

namespace {

using epoch_pass::kChunkSteps;
using epoch_pass::kPerLane;
using epoch_pass::kThreads;
using epoch_pass::kWarps;

using masked_sums::warp_sum;

// The block's three sums of acc, mod 2^64, to every thread.
__device__ __forceinline__ void block_sums(uint64_t (&acc)[3], uint64_t (*warp_sums)[kWarps]) {
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    acc[f] = warp_sum(acc[f]);
    if ((threadIdx.x & 31) == 0) warp_sums[f][threadIdx.x >> 5] = acc[f];
  }
  __syncthreads();
#pragma unroll
  for (int f = 0; f < 3; ++f) {
    acc[f] = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc[f] += warp_sums[f][w];
  }
  __syncthreads();  // warp_sums is free again
}

// Dynamic shared memory of the fused kernel: what phase 1 keeps of a
// thread's first chunk for phase 2, each validator's base reward and
// inactivity penalty (validator v of thread t at v * kThreads + t, so that a
// warp's accesses are contiguous).
constexpr int kKeptWords = kPerLane * kThreads;
static_assert(4 * kPerLane <= 64, "a thread's kept flags fill one word");
constexpr int kFusedSmem = 2 * kKeptWords * 8;

// The fused epoch kernel: phase 1, the grid sync, phase 2 (the file's head).
// words: [0..2] the flag sums (out), [3] the census (zeroed here), then
// three partial sums a block, flag f of block b at 4 + f * gridDim.x + b.
__global__ void __launch_bounds__(kThreads, epoch_pass::kMinBlocks)
    fused_epoch_kernel(epoch_pass::Columns c, altair_core::FusedSweep s,
                       unsigned long long* __restrict__ words) {
  extern __shared__ uint64_t kept_base[];
  uint64_t* kept_penalty = kept_base + kKeptWords;
  __shared__ uint64_t warp_sums[3][kWarps];
  __shared__ uint64_t increments[3];
  __shared__ unsigned block_wraps;
  // the flags of the kept validators: bits 4 v..4 v + 3 of a thread's word
  __shared__ uint64_t kept_flags[kThreads];
  kept_flags[threadIdx.x] = 0;
  const int64_t first = epoch_pass::global_warp();
  uint64_t* partials = reinterpret_cast<uint64_t*>(words) + 4;

  // phase 1: the scores, the sums, the first chunk kept
  uint64_t acc[3] = {0, 0, 0};
  const auto update = [&](int64_t t, int64_t i, const epoch_pass::Step& d, bool keep) {
    uint64_t new_score[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned flags = epoch_pass::half_flags(d.flags, h);
      const uint64_t e = h ? d.eff.y : d.eff.x;
      new_score[h] = altair_core::sweep_update(s, h ? d.score.y : d.score.x, flags);
#pragma unroll
      for (int g = 0; g < 3; ++g) acc[g] += ((flags >> g) & 1) ? e : 0;
      if (keep) {
        const int v = 2 * static_cast<int>(t) + h;
        kept_base[v * kThreads + threadIdx.x] = altair_core::sweep_base_reward(s, e);
        kept_penalty[v * kThreads + threadIdx.x] =
            altair_core::sweep_inactivity_penalty(s, e, new_score[h], flags);
        kept_flags[threadIdx.x] |= static_cast<uint64_t>(flags) << (4 * v);
      }
    }
    epoch_pass::store16(c.out_scores + i, new_score[0], new_score[1]);
  };
  epoch_pass::for_each_step<false, true>(
      c, first, c.chunks,
      [&](int64_t t, int64_t i, const epoch_pass::Step& d) { update(t, i, d, t < kChunkSteps); });
  for (int64_t i = epoch_pass::tail_first(c.chunks, blockIdx.x, threadIdx.x); i < c.n;
       i += epoch_pass::grid_threads()) {
    const unsigned flags = epoch_pass::column_flags(c, i);
    c.out_scores[i] = altair_core::sweep_update(s, c.scores[i], flags);
#pragma unroll
    for (int g = 0; g < 3; ++g) acc[g] += ((flags >> g) & 1) ? c.eff[i] : 0;
  }
  block_sums(acc, warp_sums);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int g = 0; g < 3; ++g) partials[g * gridDim.x + blockIdx.x] = acc[g];
    if (blockIdx.x == 0) words[3] = 0;
    block_wraps = 0;
  }
  cooperative_groups::this_grid().sync();

  // every block: the totals and the increments
  uint64_t total[3] = {0, 0, 0};
#pragma unroll 1
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
#pragma unroll
    for (int g = 0; g < 3; ++g) {
      total[g] += __ldcg(reinterpret_cast<const unsigned long long*>(partials) +
                         g * gridDim.x + b);
    }
  }
  block_sums(total, warp_sums);
  if (threadIdx.x == 0) {
    for (int g = 0; g < 3; ++g) {
      increments[g] = altair_core::floored_increments(s, total[g]);
      if (blockIdx.x == 0) words[g] = total[g];
    }
  }
  __syncthreads();

  // phase 2: the balances, the first chunk from what phase 1 kept
  unsigned wrapped = 0;
  epoch_pass::for_each_step<true, false>(
      c, first, 1, [&](int64_t t, int64_t i, const epoch_pass::Step& d) {
        uint64_t out[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int v = 2 * static_cast<int>(t) + h;
          wrapped += altair_core::sweep_apply(
              s, increments, h ? d.bal.y : d.bal.x, kept_base[v * kThreads + threadIdx.x],
              kept_penalty[v * kThreads + threadIdx.x],
              static_cast<unsigned>(kept_flags[threadIdx.x] >> (4 * v)) & 15u, &out[h]);
        }
        epoch_pass::store16(c.out_balances + i, out[0], out[1]);
      });
  // the rest (rare: a grid smaller than a chunk a warp, or the validators
  // past the whole chunks) one validator at a time, read again
  const auto again = [&](int64_t i) {
    const unsigned flags = epoch_pass::column_flags(c, i);
    const uint64_t updated = altair_core::sweep_update(s, c.scores[i], flags);
    wrapped += altair_core::sweep_apply(
        s, increments, c.balances[i], altair_core::sweep_base_reward(s, c.eff[i]),
        altair_core::sweep_inactivity_penalty(s, c.eff[i], updated, flags), flags,
        &c.out_balances[i]);
  };
  for (int64_t k = first + epoch_pass::grid_warps(); k < c.chunks;
       k += epoch_pass::grid_warps()) {
#pragma unroll 1
    for (int v = 0; v < kPerLane; ++v) {
      again(epoch_pass::chunk_index(k, v >> 1, threadIdx.x & 31, v & 1));
    }
  }
  for (int64_t i = epoch_pass::tail_first(c.chunks, blockIdx.x, threadIdx.x); i < c.n;
       i += epoch_pass::grid_threads()) {
    again(i);
  }
  epoch_pass::census_add(wrapped, &block_wraps, words + 3);
}

// The kernel's scalars, or false for a zero divisor or a flag index outside
// 0..2 (the launchers then refuse).
bool make_scalars(uint64_t increment, uint64_t brpi, uint64_t active_increments,
                  uint64_t denominator, uint64_t bias, uint64_t recovery_rate,
                  uint64_t weight0, uint64_t weight1, uint64_t weight2,
                  uint64_t weight_denominator, int leaking, int head_flag_index,
                  int target_flag_index, altair_core::FusedScalars* scalars) {
  const uint64_t divisor = active_increments * weight_denominator;
  if (increment == 0 || weight_denominator == 0 || divisor == 0 ||
      denominator == 0 || head_flag_index < 0 || head_flag_index > 2 ||
      target_flag_index < 0 || target_flag_index > 2) {
    return false;
  }
  scalars->increment = increment;
  scalars->brpi = brpi;
  scalars->divisor = divisor;
  scalars->denominator = denominator;
  scalars->bias = bias;
  scalars->recovery_rate = recovery_rate;
  scalars->weights[0] = weight0;
  scalars->weights[1] = weight1;
  scalars->weights[2] = weight2;
  scalars->weight_denominator = weight_denominator;
  scalars->leaking = leaking != 0;
  scalars->head_flag_index = head_flag_index;
  scalars->target_flag_index = target_flag_index;
  for (int f = 0; f < 3; ++f) scalars->unslashed_increments[f] = 0;
  return true;
}

// The fused kernel's blocks that fit on the current device at once (cached
// a device): the cooperative launch's largest grid.
int co_resident_blocks() {
  static int cached[64];
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 0;
  if (cached[device] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaFuncSetAttribute(fused_epoch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kFusedSmem) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_epoch_kernel, kThreads,
                                                      kFusedSmem) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      return 0;
    }
    cached[device] = per_sm * sms;
  }
  return cached[device];
}

// epoch_pass::apply_kernel on sums the caller gives: the launcher makes the
// increments (each sum floored at one increment), zeroes the census word
// and launches a chunk a warp.
template <bool kUpdate>
int launch_apply(altair_core::FusedScalars scalars, const uint64_t sums[3],
                 const epoch_pass::Columns& c, void* census, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(census, 0, sizeof(uint64_t), s);
  if (rc != cudaSuccess || c.n == 0) return static_cast<int>(rc);
  altair_core::fused_flag_increments(&scalars, sums);
  const altair_core::FusedSweep sweep = altair_core::fused_sweep(scalars);
  epoch_pass::apply_kernel<kUpdate, true>
      <<<static_cast<unsigned>(epoch_pass::blocks_for(c.n)), kThreads, 0, s>>>(
          c, sweep, static_cast<unsigned long long*>(census));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// balances, eff, scores, out_scores, out_balances: (n,) 64-bit words;
// prev_part: (n,) bytes; slashed, active_prev, eligible: (n,) one-byte
// booleans; all contiguous on the current device. scratch: scratch_words
// 64-bit words of device memory, at least 7: after the kernel scratch[0..2]
// hold the three flag sums and scratch[3] the wrap census; the rest takes
// three partial sums a block (the grid is cut to fit them). Launches on
// `stream` and returns the launch's error (0 = launched); n == 0 launches
// nothing but the zeroing of scratch[0..3]. A zero divisor is refused.
extern "C" int fused_epoch_launch(
    const void* balances, const void* eff, const void* prev_part,
    const void* slashed, const void* active_prev, const void* eligible,
    const void* scores, int64_t n, uint64_t increment, uint64_t brpi,
    uint64_t active_increments, uint64_t denominator, uint64_t bias,
    uint64_t recovery_rate, uint64_t weight0, uint64_t weight1,
    uint64_t weight2, uint64_t weight_denominator, int leaking,
    int head_flag_index, int target_flag_index, void* scratch, int64_t scratch_words,
    void* out_scores, void* out_balances, void* stream) {
  altair_core::FusedScalars scalars;
  if (n < 0 || scratch_words < 7 ||
      !make_scalars(increment, brpi, active_increments, denominator, bias, recovery_rate,
                    weight0, weight1, weight2, weight_denominator, leaking, head_flag_index,
                    target_flag_index, &scalars)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 0) return static_cast<int>(cudaMemsetAsync(scratch, 0, 4 * sizeof(uint64_t), s));
  epoch_pass::Columns c = epoch_pass::make_columns(balances, eff, prev_part, slashed,
                                                   active_prev, eligible, scores, n,
                                                   out_scores, out_balances);
  altair_core::FusedSweep sweep = altair_core::fused_sweep(scalars);
  const int64_t fit = co_resident_blocks();
  if (fit <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int64_t grid = epoch_pass::fused_grid(n, fit, (scratch_words - 4) / 3);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  void* args[] = {&c, &sweep, &words};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(fused_epoch_kernel), dim3(static_cast<unsigned>(grid)),
      dim3(kThreads), args, kFusedSmem, s));
}

// The pass's halves as entries of their own, for the reference's mesh twins
// (parallel/epoch.py:88 _fused_sharded, :132 _rewards_sharded): every
// shard's flag sums must be complete, and added across the shards mod 2^64
// (the reference's psum), before any shard applies them.

// The three flag sums of the (n,) columns into words[0..2]: words holds
// word_count 64-bit words, at least 6; the rest takes three partial words a
// block (the grid is cut to fit them). One cooperative launch, also at
// n == 0; returns its error (0 = launched).
extern "C" int fused_flag_sums_launch(const void* eff, const void* prev_part,
                                      const void* slashed, const void* active_prev,
                                      int64_t n, void* words, int64_t word_count,
                                      void* stream) {
  return masked_sums::launch<3>(eff, prev_part, slashed, active_prev, nullptr, n, words,
                                word_count, stream);
}

// fused_epoch_launch's pass on given sums (sum0..sum2, the three flag sums
// added over every shard): census is one 64-bit word, zeroed here, that
// receives the wrap census. Returns cudaGetLastError(); n == 0 launches
// nothing but the zeroing.
extern "C" int fused_epoch_apply_launch(
    const void* balances, const void* eff, const void* prev_part,
    const void* slashed, const void* active_prev, const void* eligible,
    const void* scores, int64_t n, uint64_t sum0, uint64_t sum1, uint64_t sum2,
    uint64_t increment, uint64_t brpi, uint64_t active_increments, uint64_t denominator,
    uint64_t bias, uint64_t recovery_rate, uint64_t weight0, uint64_t weight1,
    uint64_t weight2, uint64_t weight_denominator, int leaking,
    int head_flag_index, int target_flag_index, void* census,
    void* out_scores, void* out_balances, void* stream) {
  altair_core::FusedScalars scalars;
  if (n < 0 || !make_scalars(increment, brpi, active_increments, denominator, bias,
                             recovery_rate, weight0, weight1, weight2,
                             weight_denominator, leaking, head_flag_index,
                             target_flag_index, &scalars)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint64_t sums[3] = {sum0, sum1, sum2};
  return launch_apply<true>(scalars, sums,
                            epoch_pass::make_columns(balances, eff, prev_part, slashed,
                                                     active_prev, eligible, scores, n,
                                                     out_scores, out_balances),
                            census, stream);
}

// The rewards lane alone (no inactivity update; `scores` are the
// post-update scores) on given sums, as fused_epoch_apply_launch.
extern "C" int rewards_apply_launch(
    const void* balances, const void* eff, const void* prev_part,
    const void* slashed, const void* active_prev, const void* eligible,
    const void* scores, int64_t n, uint64_t sum0, uint64_t sum1, uint64_t sum2,
    uint64_t increment, uint64_t brpi, uint64_t active_increments, uint64_t denominator,
    uint64_t weight0, uint64_t weight1, uint64_t weight2, uint64_t weight_denominator,
    int leaking, int head_flag_index, int target_flag_index, void* census,
    void* out_balances, void* stream) {
  altair_core::FusedScalars scalars;
  if (n < 0 || !make_scalars(increment, brpi, active_increments, denominator, 0, 0,
                             weight0, weight1, weight2, weight_denominator, leaking,
                             head_flag_index, target_flag_index, &scalars)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const uint64_t sums[3] = {sum0, sum1, sum2};
  return launch_apply<false>(scalars, sums,
                             epoch_pass::make_columns(balances, eff, prev_part, slashed,
                                                      active_prev, eligible, scores, n,
                                                      nullptr, out_balances),
                             census, stream);
}
