// The altair epoch sweeps of the literal route, for Hopper (sm_90a): flag
// deltas, inactivity updates and inactivity penalties.
//
// Replaces the XLA programs of the reference package
// ethereum_consensus_tpu/ops/sweeps.py: _flag_deltas (:67, with the isqrt
// of :45 inside), _inactivity_updates (:147) and _inactivity_penalties
// (:191). The per-validator arithmetic is in altair_core.h.
//
// Inputs and outputs are unsigned 64-bit words (int64 tensors carry the bit
// patterns) and one-byte booleans, all (n,), contiguous on one device.
//
// Design: one thread per validator, unsigned long long throughout, loads
// and stores coalesced. Flag deltas need the masked sum of the effective
// balances before any lane can finish, so they take two launches: a
// grid-stride reduction (warp shuffles, one 64-bit atomicAdd per block into
// a word the launcher zeroes; addition mod 2^64 is associative, so the sum
// does not depend on the order), then the element pass, where thread 0 of
// each block derives the scalars (isqrt, base reward per increment,
// increments, divisor) into shared memory.
//
// What bounds them on an H100: bytes, narrowly. Flag deltas move 26 bytes a
// validator (8 + 1 + 1 in, two words out) plus the reduction's 9 again, 35
// bytes in all, 37 MB at 2^20, about 11 us at 3.35 TB/s; inactivity
// updates 18 bytes, penalties 25. The divisions by values fixed for the
// sweep (the increment, the reward divisor, the weight denominator, the
// penalty denominator) compile to software 64-bit divisions of a few dozen
// integer operations each; chip_smoke.py counts them against the
// dispatch rate and reports whichever bound is larger.

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

// out[0] += sum of eff[i] where participating[i], mod 2^64.
__global__ void __launch_bounds__(kThreads)
    masked_sum_kernel(const uint64_t* __restrict__ eff,
                      const bool* __restrict__ participating, int64_t n,
                      unsigned long long* __restrict__ out) {
  __shared__ uint64_t warp_sums[kThreads / 32];
  uint64_t acc = 0;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += static_cast<int64_t>(gridDim.x) * kThreads) {
    if (participating[i]) acc += eff[i];
  }
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    acc = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0;
    acc = warp_sum(acc);
    if (threadIdx.x == 0 && acc != 0) {
      atomicAdd(out, static_cast<unsigned long long>(acc));
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    flag_deltas_kernel(const uint64_t* __restrict__ eff,
                       const bool* __restrict__ participating,
                       const bool* __restrict__ eligible, int64_t n,
                       const unsigned long long* __restrict__ participating_sum,
                       uint64_t total_active, uint64_t weight,
                       uint64_t increment, uint64_t base_reward_factor,
                       uint64_t weight_denominator, bool leaking, bool is_head,
                       uint64_t* __restrict__ rewards,
                       uint64_t* __restrict__ penalties) {
  __shared__ altair_core::FlagScalars scalars;
  if (threadIdx.x == 0) {
    scalars = altair_core::flag_scalars(total_active, *participating_sum,
                                        increment, base_reward_factor,
                                        weight_denominator);
  }
  __syncthreads();
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  altair_core::flag_delta(eff[i], participating[i], eligible[i], scalars,
                          weight, increment, weight_denominator, leaking,
                          is_head, &rewards[i], &penalties[i]);
}

__global__ void __launch_bounds__(kThreads)
    inactivity_updates_kernel(const uint64_t* __restrict__ scores,
                              const bool* __restrict__ participating,
                              const bool* __restrict__ eligible, int64_t n,
                              uint64_t bias, uint64_t recovery_rate,
                              bool leaking, uint64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = altair_core::inactivity_update(scores[i], participating[i],
                                          eligible[i], bias, recovery_rate,
                                          leaking);
}

__global__ void __launch_bounds__(kThreads)
    inactivity_penalties_kernel(const uint64_t* __restrict__ eff,
                                const uint64_t* __restrict__ scores,
                                const bool* __restrict__ not_target,
                                int64_t n, uint64_t denominator,
                                uint64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = altair_core::inactivity_penalty(eff[i], scores[i], not_target[i],
                                           denominator);
}

unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

unsigned reduce_grid_for(int64_t n) {
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  return static_cast<unsigned>(blocks < kReduceBlocks ? blocks : kReduceBlocks);
}

}  // namespace

// Every launcher: pointers to (n,) columns contiguous on the current device;
// launches on `stream` and returns cudaGetLastError() (0 = launched); n == 0
// launches nothing. A zero divisor is refused (cudaErrorInvalidValue).

// sum_scratch: one 64-bit word of device memory, zeroed here on the stream.
extern "C" int flag_deltas_launch(const void* eff, const void* participating,
                                  const void* eligible, int64_t n,
                                  uint64_t total_active, uint64_t weight,
                                  uint64_t increment,
                                  uint64_t base_reward_factor,
                                  uint64_t weight_denominator, int leaking,
                                  int is_head, void* sum_scratch,
                                  void* rewards, void* penalties,
                                  void* stream) {
  if (n < 0 || increment == 0 || weight_denominator == 0 || total_active == 0 ||
      (total_active / increment) * weight_denominator == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t rc = cudaMemsetAsync(sum_scratch, 0, sizeof(uint64_t), s);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  masked_sum_kernel<<<reduce_grid_for(n), kThreads, 0, s>>>(
      static_cast<const uint64_t*>(eff), static_cast<const bool*>(participating),
      n, static_cast<unsigned long long*>(sum_scratch));
  rc = cudaGetLastError();
  if (rc != cudaSuccess) return static_cast<int>(rc);
  flag_deltas_kernel<<<grid_for(n), kThreads, 0, s>>>(
      static_cast<const uint64_t*>(eff), static_cast<const bool*>(participating),
      static_cast<const bool*>(eligible), n,
      static_cast<const unsigned long long*>(sum_scratch), total_active, weight,
      increment, base_reward_factor, weight_denominator, leaking != 0,
      is_head != 0, static_cast<uint64_t*>(rewards),
      static_cast<uint64_t*>(penalties));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int inactivity_updates_launch(const void* scores,
                                         const void* participating,
                                         const void* eligible, int64_t n,
                                         uint64_t bias, uint64_t recovery_rate,
                                         int leaking, void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  inactivity_updates_kernel<<<grid_for(n), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(scores),
      static_cast<const bool*>(participating),
      static_cast<const bool*>(eligible), n, bias, recovery_rate, leaking != 0,
      static_cast<uint64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int inactivity_penalties_launch(const void* eff, const void* scores,
                                           const void* not_target, int64_t n,
                                           uint64_t denominator, void* out,
                                           void* stream) {
  if (n < 0 || denominator == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  inactivity_penalties_kernel<<<grid_for(n), kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(eff), static_cast<const uint64_t*>(scores),
      static_cast<const bool*>(not_target), n, denominator,
      static_cast<uint64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
