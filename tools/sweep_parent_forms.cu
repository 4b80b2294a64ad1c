// B5-hysteresis and B5-altair's inactivity updates as their parent design
// (tools/sweep_forms.py): one validator a thread in 256-thread blocks, 8-byte
// loads of each word column and 1 byte of each flag, the hysteresis floor
// a software 64-bit remainder. The kernels and launchers of
// csrc/sweeps.cu and csrc/altair_sweeps.cu before the warp chunks,
// verbatim, with the same C interfaces, so that a wrapper's arguments launch
// them. Not part of the program.

#include <cuda_runtime.h>
#include <stdint.h>

#include "altair_core.h"
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

unsigned grid_for(int64_t n) {
  return static_cast<unsigned>((n + kThreads - 1) / kThreads);
}

}  // namespace

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
