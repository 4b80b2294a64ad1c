// The three staged epoch programs of the columnar engine, for Hopper
// (sm_90a): the inactivity update, one flag's deltas from given base
// rewards, and the delta pairs applied in order.
//
// Replaces the XLA programs of the reference package
// ethereum_consensus_tpu/models/epoch_vector.py jitted_kernels() (:143):
// inactivity_scores_kernel (:234, jitted at :166), flag_deltas_kernel
// (:251, :173) and apply_delta_pairs_kernel (:285, :181). The
// per-validator arithmetic is altair_core.h's inactivity_update and
// epoch_staged_core.h's flag_delta and apply_pairs.
//
// Inputs and outputs are unsigned 64-bit words (int64 tensors carry the bit
// patterns) and one-byte booleans, contiguous on one device; the pairs are
// (k, n) row-major.
//
// Design. The update is B5-altair's kernel (altair_core.h
// inactivity_updates_kernel) on the two bool columns. Each kernel is one
// plain launch on warp_chunks.h's partition, a chunk a warp: at each step a
// lane takes two consecutive validators with one 16-byte streaming load of
// each word column and one 2-byte load of each flag column, the chunk's
// loads issued before its arithmetic, and stores two results as one 16-byte
// vector; validators past the last whole chunk, or all of them where a
// column is not aligned (the pairs at odd n with k > 1), go one a thread.
// The updates take chunks of one step (altair_core::kUpdateSteps,
// B5-altair's measured choice), the flag deltas and the pairs four. The
// flag deltas' two divisions are multiply-highs by reciprocals
// (udiv64_core.h) the launcher makes once a call; the pairs kernel reads
// each of its 2 k + 1 words a validator once.
//
// What bounds them on an H100: bytes. Per validator the updates move 18
// (8 + 1 + 1 in, 8 out), the flag deltas 26 (8 + 1 + 1 in, 16 out), the
// pairs 16 k + 16 (80 at k = 4).

#include <cuda_runtime.h>
#include <stdint.h>

#include "altair_core.h"
#include "epoch_staged_core.h"

namespace {

constexpr int kThreads = warp_chunks::kSweepThreads;
constexpr int kWarps = warp_chunks::kSweepWarps;
constexpr int kSteps = warp_chunks::kChunkSteps;

__device__ __forceinline__ int64_t global_warp() {
  return warp_chunks::warp_rank(blockIdx.x, static_cast<int>(threadIdx.x >> 5));
}

}  // namespace

// One flag's deltas: a warp's chunks, then this thread's validators past
// them.
__global__ void __launch_bounds__(kThreads)
    staged_flag_deltas_kernel(epoch_staged::FlagColumns c, epoch_staged::StagedFlag s) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t k = global_warp(); k < c.chunks; k += warps) {
    ulonglong2 base[kSteps];
    unsigned elig[kSteps], unsl[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t i = warp_chunks::chunk_index(k, j, lane);
      base[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.base_reward + i));
      elig[j] = __ldcs(reinterpret_cast<const unsigned short*>(c.eligible + i));
      unsl[j] = __ldcs(reinterpret_cast<const unsigned short*>(c.unslashed + i));
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t i = warp_chunks::chunk_index(k, j, lane);
      uint64_t r0, p0, r1, p1;
      epoch_staged::flag_delta(s, base[j].x, elig[j] & 0xffu, unsl[j] & 0xffu, &r0, &p0);
      epoch_staged::flag_delta(s, base[j].y, elig[j] >> 8, unsl[j] >> 8, &r1, &p1);
      *reinterpret_cast<ulonglong2*>(c.rewards + i) = make_ulonglong2(r0, r1);
      *reinterpret_cast<ulonglong2*>(c.penalties + i) = make_ulonglong2(p0, p1);
    }
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = warp_chunks::tail_first(c.chunks, blockIdx.x, threadIdx.x); i < c.n;
       i += threads) {
    epoch_staged::flag_delta(s, c.base_reward[i], c.eligible[i] != 0, c.unslashed[i] != 0,
                             c.rewards + i, c.penalties + i);
  }
}

// The pairs applied in order: a warp's chunks (each step's balance loaded,
// then the k pairs' words of its two validators), then this thread's
// validators past them.
__global__ void __launch_bounds__(kThreads)
    staged_apply_pairs_kernel(epoch_staged::PairColumns c) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t k = global_warp(); k < c.chunks; k += warps) {
    ulonglong2 bal[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      bal[j] = __ldcs(reinterpret_cast<const ulonglong2*>(
          c.balances + warp_chunks::chunk_index(k, j, lane)));
    }
    for (int64_t p = 0; p < c.k; ++p) {
      const uint64_t* rewards = c.rewards + p * c.n;
      const uint64_t* penalties = c.penalties + p * c.n;
#pragma unroll
      for (int j = 0; j < kSteps; ++j) {
        const int64_t i = warp_chunks::chunk_index(k, j, lane);
        const ulonglong2 r = __ldcs(reinterpret_cast<const ulonglong2*>(rewards + i));
        const ulonglong2 q = __ldcs(reinterpret_cast<const ulonglong2*>(penalties + i));
        const uint64_t x = bal[j].x + r.x;
        const uint64_t y = bal[j].y + r.y;
        bal[j].x = x >= q.x ? x - q.x : 0;
        bal[j].y = y >= q.y ? y - q.y : 0;
      }
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      *reinterpret_cast<ulonglong2*>(c.out + warp_chunks::chunk_index(k, j, lane)) = bal[j];
    }
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = warp_chunks::tail_first(c.chunks, blockIdx.x, threadIdx.x); i < c.n;
       i += threads) {
    c.out[i] = epoch_staged::apply_pairs(c.balances[i], c.rewards + i, c.penalties + i, c.k, c.n);
  }
}

namespace {

unsigned grid_of(int64_t n, int steps) {
  return static_cast<unsigned>(steps == 1 ? warp_chunks::chunk_grid<1>(n)
                                          : warp_chunks::chunk_grid(n));
}

}  // namespace

extern "C" int staged_inactivity_launch(const void* scores, const void* eligible,
                                        const void* participating, int64_t n, uint64_t bias,
                                        uint64_t recovery_rate, int leaking, void* out,
                                        void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  constexpr int kUpdate = altair_core::kUpdateSteps;
  altair_core::inactivity_updates_kernel<kUpdate>
      <<<grid_of(n, kUpdate), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
          altair_core::update_columns<kUpdate>(scores, participating, eligible, n, out), bias,
          recovery_rate, leaking != 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int staged_flag_deltas_launch(const void* base_reward, const void* eligible,
                                         const void* unslashed, int64_t n, uint64_t weight,
                                         uint64_t unslashed_increments, uint64_t reward_divisor,
                                         uint64_t weight_denominator, int leaking, int is_head,
                                         void* rewards, void* penalties, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const epoch_staged::StagedFlag s =
      epoch_staged::staged_flag(weight, unslashed_increments, reward_divisor, weight_denominator,
                                leaking != 0, is_head != 0);
  staged_flag_deltas_kernel<<<grid_of(n, kSteps), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      epoch_staged::flag_columns(base_reward, eligible, unslashed, n, rewards, penalties), s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int staged_apply_pairs_launch(const void* balances, const void* rewards,
                                         const void* penalties, int64_t n, int64_t k, void* out,
                                         void* stream) {
  if (n < 0 || k < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  staged_apply_pairs_kernel<<<grid_of(n, kSteps), kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      epoch_staged::pair_columns(balances, rewards, penalties, n, k, out));
  return static_cast<int>(cudaGetLastError());
}
