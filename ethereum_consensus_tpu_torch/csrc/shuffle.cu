// The whole-list swap-or-not shuffle (committee shuffling), for Hopper
// (sm_90a).
//
// Replaces the XLA program of the reference package
// ethereum_consensus_tpu/ops/shuffle.py:57 _shuffle_rounds (jitted at
// :78): out[i] == compute_shuffled_index(i, count, seed) for every
// i < count.
//
// Inputs: pivots (rounds,) int64 and sources (rounds, row_bytes) uint8,
// the host precompute of ops/shuffle.py (row_bytes = 32 * ceil(count /
// 256)). Output (count,) int64.
//
// Design: one thread per index, all rounds in registers
// (shuffle_core.h); no shared memory and no synchronisation. Round r's
// table is read through the read-only cache (__ldg): it is 128 KB at
// 2^20 indices, so all 90 rounds (11.25 MB) stay in the 50 MB L2 and the
// neighbouring indices of a warp read neighbouring bytes.
//
// What bounds it on an H100: integer issue. An index costs about 12
// integer operations per round (the 64-bit flip and its conditional
// subtraction, the max, the byte address, the bit test and the select)
// against 8 bytes written and the shared tables read once: at 2^20
// indices and 90 rounds that is about 1.1e9 operations against 20 MB,
// some 10x more issue time than byte time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shuffle_core.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    shuffle_kernel(const int64_t* __restrict__ pivots,
                   const uint8_t* __restrict__ sources, int64_t row_bytes,
                   int rounds, int64_t count, int64_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= count) return;
  out[i] = static_cast<int64_t>(shuffle_core::shuffled_index(
      static_cast<uint64_t>(i), static_cast<uint64_t>(count), rounds, pivots,
      sources, row_bytes));
}

}  // namespace

// pivots: (rounds,) int64, sources: (rounds, row_bytes) uint8, out:
// (count,) int64, all contiguous on the current device; launches on
// `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int shuffle_launch(const void* pivots, const void* sources,
                              int64_t row_bytes, int rounds, int64_t count,
                              void* out, void* stream) {
  if (count <= 0 || rounds < 0 || row_bytes < 32 * ((count + 255) / 256)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t blocks = (count + kThreads - 1) / kThreads;
  shuffle_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int64_t*>(pivots),
      static_cast<const uint8_t*>(sources), row_bytes, rounds, count,
      static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
