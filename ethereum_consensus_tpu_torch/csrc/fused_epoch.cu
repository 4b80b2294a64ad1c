// The fused altair-family epoch kernel, for Hopper (sm_90a).
//
// Replaces the XLA program of the reference package
// ethereum_consensus_tpu/models/epoch_vector.py:297 fused_epoch_kernel
// (jitted at :188): the inactivity update, three participation-flag delta
// pairs off masked effective-balance sums, the inactivity penalty off the
// post-update scores, and the four pairs applied in sequence with zero
// saturation between them, with a census of the adds that wrapped. The
// per-validator arithmetic is altair_core.h's fused_epoch_lane.
//
// Inputs: balances, effective balances and inactivity scores as unsigned
// 64-bit words (int64 tensors carry the bit patterns); previous-epoch
// participation flags as bytes; slashed, active-in-the-previous-epoch and
// eligible as one-byte booleans; all (n,). The per-epoch scalars and the
// chain constants arrive as kernel arguments. Outputs: new scores and new
// balances (n,), and the wrap census in a device word.
//
// Design: two launches. The three flag sums must be complete before any
// lane can form its rewards, so a grid-stride reduction runs first (warp
// shuffles, one 64-bit atomicAdd per block and flag into words the launcher
// zeroes; addition mod 2^64 is associative, so the sums do not depend on the
// order). Then one thread per validator runs the whole lane; thread 0 of
// each block turns the sums into increments in shared memory. The wrap
// census (zero for a real state) is summed per warp and per block, so a
// block adds to the device word at most once. The two launches are also
// entries of their own (fused_flag_sums_launch, fused_epoch_apply_launch),
// and rewards_apply_launch runs the element pass without the inactivity
// update: the reference's mesh twins add every shard's sums before any shard
// applies them.
//
// What bounds it on an H100: the element pass reads 28 bytes a validator
// (three words, four one-byte columns) and writes 16; the reduction reads the
// effective balance and the three bytes again, 11 more: 55 bytes, 58 MB at
// 2^20, about 17 us at 3.35 TB/s. Each lane also makes one to five 64-bit
// divisions, by its flags, by values fixed for the epoch: software routines
// of a few dozen integer operations each; chip_smoke.py counts those its
// data needs against the dispatch rate and reports whichever bound is larger.

#include <cuda_runtime.h>
#include <stdint.h>

#include "altair_core.h"

namespace {

constexpr int kThreads = 256;
constexpr int kReduceBlocks = 1056;  // 8 per SM of an H100

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// sums[f] += eff[i] over the unslashed validators active in the previous
// epoch whose flag f is set, mod 2^64.
__global__ void __launch_bounds__(kThreads)
    flag_sums_kernel(const uint64_t* __restrict__ eff,
                     const uint8_t* __restrict__ prev_part,
                     const bool* __restrict__ slashed,
                     const bool* __restrict__ active_prev, int64_t n,
                     unsigned long long* __restrict__ sums) {
  __shared__ uint64_t warp_sums[3][kThreads / 32];
  uint64_t acc[3] = {0, 0, 0};
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    if (active_prev[i] && !slashed[i]) {
      const uint8_t part = prev_part[i];
      const uint64_t e = eff[i];
      for (int f = 0; f < 3; ++f) {
        if ((part >> f) & 1) acc[f] += e;
      }
    }
  }
  for (int f = 0; f < 3; ++f) {
    acc[f] = warp_sum(acc[f]);
    if ((threadIdx.x & 31) == 0) warp_sums[f][threadIdx.x >> 5] = acc[f];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    for (int f = 0; f < 3; ++f) {
      uint64_t v = threadIdx.x < kThreads / 32 ? warp_sums[f][threadIdx.x] : 0;
      v = warp_sum(v);
      if (threadIdx.x == 0 && v != 0) {
        atomicAdd(&sums[f], static_cast<unsigned long long>(v));
      }
    }
  }
}

// kScores: the inactivity update, then the rewards (the fused epoch kernel,
// scores written to out_scores); otherwise the rewards alone off the given
// scores (the reference's mesh twin _rewards_sharded), out_scores unused.
template <bool kScores>
__global__ void __launch_bounds__(kThreads)
    fused_epoch_kernel(altair_core::FusedScalars scalars,
                       const uint64_t* __restrict__ balances,
                       const uint64_t* __restrict__ eff,
                       const uint8_t* __restrict__ prev_part,
                       const bool* __restrict__ slashed,
                       const bool* __restrict__ active_prev,
                       const bool* __restrict__ eligible,
                       const uint64_t* __restrict__ scores, int64_t n,
                       unsigned long long* __restrict__ sums_and_wraps,
                       uint64_t* __restrict__ out_scores,
                       uint64_t* __restrict__ out_balances) {
  __shared__ altair_core::FusedScalars s;
  __shared__ unsigned int block_wraps;
  if (threadIdx.x == 0) {
    const uint64_t sums[3] = {sums_and_wraps[0], sums_and_wraps[1],
                              sums_and_wraps[2]};
    s = scalars;
    altair_core::fused_flag_increments(&s, sums);
    block_wraps = 0;
  }
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  unsigned int wrapped = 0;
  if (i < n) {
    if (kScores) {
      wrapped = altair_core::fused_epoch_lane(
          s, balances[i], eff[i], prev_part[i], slashed[i], active_prev[i],
          eligible[i], scores[i], &out_scores[i], &out_balances[i]);
    } else {
      wrapped = altair_core::rewards_lane(
          s, balances[i], eff[i], prev_part[i], slashed[i], active_prev[i],
          eligible[i], scores[i], &out_balances[i]);
    }
  }
  // the census: a warp sum, one shared add per warp, one global add per
  // block, so lanes that wrap together do not queue on one word
  wrapped = __reduce_add_sync(0xffffffffu, wrapped);
  if ((threadIdx.x & 31) == 0 && wrapped != 0) atomicAdd(&block_wraps, wrapped);
  __syncthreads();
  if (threadIdx.x == 0 && block_wraps != 0) {
    atomicAdd(&sums_and_wraps[3], static_cast<unsigned long long>(block_wraps));
  }
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

// The flag sums into words[0..2], which the caller zeroed.
cudaError_t launch_flag_sums(const void* eff, const void* prev_part, const void* slashed,
                             const void* active_prev, int64_t n,
                             unsigned long long* words, cudaStream_t s) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  const unsigned reduce_blocks =
      static_cast<unsigned>(blocks < kReduceBlocks ? blocks : kReduceBlocks);
  flag_sums_kernel<<<reduce_blocks, kThreads, 0, s>>>(
      static_cast<const uint64_t*>(eff), static_cast<const uint8_t*>(prev_part),
      static_cast<const bool*>(slashed), static_cast<const bool*>(active_prev),
      n, words);
  return cudaGetLastError();
}

// The element pass on the sums in words[0..2], the census into words[3].
template <bool kScores>
cudaError_t launch_lanes(const altair_core::FusedScalars& scalars, const void* balances,
                         const void* eff, const void* prev_part, const void* slashed,
                         const void* active_prev, const void* eligible, const void* scores,
                         int64_t n, unsigned long long* words, void* out_scores,
                         void* out_balances, cudaStream_t s) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  fused_epoch_kernel<kScores><<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      scalars, static_cast<const uint64_t*>(balances),
      static_cast<const uint64_t*>(eff), static_cast<const uint8_t*>(prev_part),
      static_cast<const bool*>(slashed), static_cast<const bool*>(active_prev),
      static_cast<const bool*>(eligible), static_cast<const uint64_t*>(scores),
      n, words, static_cast<uint64_t*>(out_scores),
      static_cast<uint64_t*>(out_balances));
  return cudaGetLastError();
}

}  // namespace

// balances, eff, scores, out_scores, out_balances: (n,) 64-bit words;
// prev_part: (n,) bytes; slashed, active_prev, eligible: (n,) one-byte
// booleans; all contiguous on the current device. scratch: four 64-bit
// words of device memory, zeroed here on the stream; after the kernel
// scratch[0..2] hold the three flag sums and scratch[3] the wrap census.
// Launches on `stream` and returns cudaGetLastError() (0 = launched); n == 0
// launches nothing but the zeroing. A zero divisor is refused.
extern "C" int fused_epoch_launch(
    const void* balances, const void* eff, const void* prev_part,
    const void* slashed, const void* active_prev, const void* eligible,
    const void* scores, int64_t n, uint64_t increment, uint64_t brpi,
    uint64_t active_increments, uint64_t denominator, uint64_t bias,
    uint64_t recovery_rate, uint64_t weight0, uint64_t weight1,
    uint64_t weight2, uint64_t weight_denominator, int leaking,
    int head_flag_index, int target_flag_index, void* scratch,
    void* out_scores, void* out_balances, void* stream) {
  altair_core::FusedScalars scalars;
  if (n < 0 || !make_scalars(increment, brpi, active_increments, denominator, bias,
                             recovery_rate, weight0, weight1, weight2,
                             weight_denominator, leaking, head_flag_index,
                             target_flag_index, &scalars)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(scratch, 0, 4 * sizeof(uint64_t), s);
  if (rc != cudaSuccess || n == 0) return static_cast<int>(rc);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  rc = launch_flag_sums(eff, prev_part, slashed, active_prev, n, words, s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  return static_cast<int>(launch_lanes<true>(scalars, balances, eff, prev_part, slashed,
                                             active_prev, eligible, scores, n, words,
                                             out_scores, out_balances, s));
}

// The two launches of fused_epoch_launch as entries of their own, for the
// reference's mesh twins (parallel/epoch.py:88 _fused_sharded, :132
// _rewards_sharded): every shard's flag sums must be complete, and added
// across the shards mod 2^64 (the reference's psum), before any shard
// applies them.

// The three flag sums of the (n,) columns into sums[0..2] (zeroed here).
// Returns cudaGetLastError() (0 = launched); n == 0 launches nothing but the
// zeroing.
extern "C" int fused_flag_sums_launch(const void* eff, const void* prev_part,
                                      const void* slashed, const void* active_prev,
                                      int64_t n, void* sums, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(sums, 0, 3 * sizeof(uint64_t), s);
  if (rc != cudaSuccess || n == 0) return static_cast<int>(rc);
  return static_cast<int>(launch_flag_sums(eff, prev_part, slashed, active_prev, n,
                                           static_cast<unsigned long long*>(sums), s));
}

// fused_epoch_launch's element pass on given sums: scratch[0..2] hold the
// three flag sums (the caller's), scratch[3] is zeroed here and receives the
// wrap census.
extern "C" int fused_epoch_apply_launch(
    const void* balances, const void* eff, const void* prev_part,
    const void* slashed, const void* active_prev, const void* eligible,
    const void* scores, int64_t n, uint64_t increment, uint64_t brpi,
    uint64_t active_increments, uint64_t denominator, uint64_t bias,
    uint64_t recovery_rate, uint64_t weight0, uint64_t weight1,
    uint64_t weight2, uint64_t weight_denominator, int leaking,
    int head_flag_index, int target_flag_index, void* scratch,
    void* out_scores, void* out_balances, void* stream) {
  altair_core::FusedScalars scalars;
  if (n < 0 || !make_scalars(increment, brpi, active_increments, denominator, bias,
                             recovery_rate, weight0, weight1, weight2,
                             weight_denominator, leaking, head_flag_index,
                             target_flag_index, &scalars)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  cudaError_t rc = cudaMemsetAsync(words + 3, 0, sizeof(uint64_t), s);
  if (rc != cudaSuccess || n == 0) return static_cast<int>(rc);
  return static_cast<int>(launch_lanes<true>(scalars, balances, eff, prev_part, slashed,
                                             active_prev, eligible, scores, n, words,
                                             out_scores, out_balances, s));
}

// The rewards lane alone (no inactivity update; `scores` are the
// post-update scores) on given sums, as fused_epoch_apply_launch.
extern "C" int rewards_apply_launch(
    const void* balances, const void* eff, const void* prev_part,
    const void* slashed, const void* active_prev, const void* eligible,
    const void* scores, int64_t n, uint64_t increment, uint64_t brpi,
    uint64_t active_increments, uint64_t denominator, uint64_t weight0,
    uint64_t weight1, uint64_t weight2, uint64_t weight_denominator, int leaking,
    int head_flag_index, int target_flag_index, void* scratch,
    void* out_balances, void* stream) {
  altair_core::FusedScalars scalars;
  if (n < 0 || !make_scalars(increment, brpi, active_increments, denominator, 0, 0,
                             weight0, weight1, weight2, weight_denominator, leaking,
                             head_flag_index, target_flag_index, &scalars)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned long long* words = static_cast<unsigned long long*>(scratch);
  cudaError_t rc = cudaMemsetAsync(words + 3, 0, sizeof(uint64_t), s);
  if (rc != cudaSuccess || n == 0) return static_cast<int>(rc);
  return static_cast<int>(launch_lanes<false>(scalars, balances, eff, prev_part, slashed,
                                              active_prev, eligible, scores, n, words,
                                              nullptr, out_balances, s));
}
