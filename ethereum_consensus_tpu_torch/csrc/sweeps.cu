// The effective-balance hysteresis sweep of the epoch boundary, for Hopper
// (sm_90a).
//
// Replaces the XLA program of the reference package
// ethereum_consensus_tpu/ops/sweeps.py:246 _effective_balance_updates
// (jitted at :240): for every validator, the new effective balance from
// its balance and its current effective balance (sweeps_core.h).
//
// Inputs: balances (n,) and effective balances (n,), unsigned 64-bit
// words (int64 tensors carry the bit patterns). Output (n,) likewise. The
// spec constants arrive as kernel arguments: increment, the cap, and the
// downward and upward thresholds.
//
// Design: one thread per validator, unsigned long long throughout; loads
// and the store are coalesced 8-byte accesses.
//
// What bounds it on an H100: bytes. A validator moves 24 bytes (two words
// read, one written), 25 MB at 2^20 validators, about 7.5 us at
// 3.35 TB/s. The remainder by a runtime 64-bit divisor compiles to a
// software division (the card has no 64-bit integer divide); its few
// dozen integer operations per validator overlap the loads, and at 2^20
// validators the kernel runs at about half the byte rate.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweeps_core.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    effective_balance_kernel(const uint64_t* __restrict__ balances,
                             const uint64_t* __restrict__ effective,
                             int64_t n, uint64_t increment,
                             uint64_t max_effective, uint64_t down, uint64_t up,
                             uint64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  out[i] = sweeps_core::effective_balance_update(
      balances[i], effective[i], increment, max_effective, down, up);
}

}  // namespace

// balances, effective, out: (n,) 64-bit words, contiguous on the current
// device; launches on `stream` and returns cudaGetLastError() (0 =
// launched). n == 0 launches nothing.
extern "C" int effective_balance_launch(const void* balances,
                                        const void* effective, int64_t n,
                                        uint64_t increment,
                                        uint64_t max_effective, uint64_t down,
                                        uint64_t up, void* out, void* stream) {
  if (n < 0 || increment == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  effective_balance_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint64_t*>(balances),
      static_cast<const uint64_t*>(effective), n, increment, max_effective,
      down, up, static_cast<uint64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
