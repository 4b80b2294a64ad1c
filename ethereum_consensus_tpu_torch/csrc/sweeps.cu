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
// spec constants arrive as launcher arguments: increment, the cap, and the
// downward and upward thresholds.
//
// Design: warp_chunks.h's partition, the other byte-bound sweeps' (a warp
// 256 consecutive validators in four steps, a lane two a step: a 16-byte
// streaming load of each word column and one 16-byte store; the four
// steps' loads issued before any arithmetic; the validators past the last
// whole chunk, or all of them where a column is not 16-byte aligned, one a
// thread), a plain launch of a chunk a warp (512 blocks at 2^20). The floor
// b - b % increment is a multiply-high by the increment's reciprocal
// (sweeps_core.h's Hysteresis, made once a call by the launcher): the card
// has no 64-bit integer divide, and the remainder by a runtime divisor was
// a software division of a few dozen dependent operations.
//
// What bounds it on an H100: bytes. A validator moves 24 bytes (two words
// read, one written), 25 MB at 2^20 validators, about 7.5 us at
// 3.35 TB/s. The parent design (one validator a thread, the software
// remainder) lives in tools/sweep_parent_forms.cu.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sweeps_core.h"
#include "warp_chunks.h"

namespace {

constexpr int kThreads = warp_chunks::kSweepThreads;
using warp_chunks::kChunkSteps;

// A warp's chunks (from warp_rank, a grid's warps apart), each step's loads
// issued before the first update; then this thread's validators past the
// chunks.
__global__ void __launch_bounds__(kThreads)
    effective_balance_kernel(sweeps_core::BalanceColumns c, sweeps_core::Hysteresis h) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * warp_chunks::kSweepWarps;
  for (int64_t k = warp_chunks::warp_rank(blockIdx.x, threadIdx.x >> 5); k < c.chunks;
       k += warps) {
    ulonglong2 bal[kChunkSteps], eff[kChunkSteps];
#pragma unroll
    for (int j = 0; j < kChunkSteps; ++j) {
      const int64_t i = warp_chunks::chunk_index(k, j, lane);
      bal[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.balances + i));
      eff[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.effective + i));
    }
#pragma unroll
    for (int j = 0; j < kChunkSteps; ++j) {
      const int64_t i = warp_chunks::chunk_index(k, j, lane);
      *reinterpret_cast<ulonglong2*>(c.out + i) =
          make_ulonglong2(sweeps_core::effective_balance_update(bal[j].x, eff[j].x, h),
                          sweeps_core::effective_balance_update(bal[j].y, eff[j].y, h));
    }
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = warp_chunks::tail_first(c.chunks, blockIdx.x, threadIdx.x); i < c.n;
       i += threads) {
    c.out[i] = sweeps_core::effective_balance_update(c.balances[i], c.effective[i], h);
  }
}

}  // namespace

// balances, effective, out: (n,) 64-bit words, contiguous on the current
// device; launches on `stream` and returns cudaGetLastError() (0 =
// launched). A zero increment is refused (cudaErrorInvalidValue); n == 0
// launches nothing.
extern "C" int effective_balance_launch(const void* balances,
                                        const void* effective, int64_t n,
                                        uint64_t increment,
                                        uint64_t max_effective, uint64_t down,
                                        uint64_t up, void* out, void* stream) {
  if (n < 0 || increment == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  effective_balance_kernel<<<static_cast<unsigned>(warp_chunks::chunk_grid(n)), kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      sweeps_core::balance_columns(balances, effective, n, out),
      sweeps_core::hysteresis(increment, max_effective, down, up));
  return static_cast<int>(cudaGetLastError());
}
