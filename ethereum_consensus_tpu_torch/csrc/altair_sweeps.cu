// The altair epoch sweeps of the literal route, for Hopper (sm_90a): flag
// deltas, inactivity updates and inactivity penalties.
//
// Replaces the XLA programs of the reference package
// ethereum_consensus_tpu/ops/sweeps.py: _flag_deltas (:67, with the isqrt
// of :45 inside), _inactivity_updates (:147) and _inactivity_penalties
// (:191). The per-validator arithmetic is in altair_core.h, and so is the
// inactivity updates' kernel, which epoch_staged.cu launches too.
//
// Inputs and outputs are unsigned 64-bit words (int64 tensors carry the bit
// patterns) and one-byte booleans, all (n,), contiguous on one device.
//
// Design. The inactivity updates and the inactivity penalties: the flag
// deltas' warp chunks (warp_chunks.h's partition: a lane two validators a
// step, one 16-byte streaming load of each word column and one 2-byte load
// of each flag column, one 16-byte store of the two results, the four
// steps' loads issued before any arithmetic; validators past the last whole
// chunk, or all of them where a column is not aligned, one a thread) and a
// plain launch of a chunk a warp (the updates' chunks of one step,
// altair_core::kUpdateSteps); the penalties' wrapped product's quotient
// by the denominator a multiply-high by its reciprocal, made once a call by
// the launcher. The flag deltas' rewards need
// the masked sum of the effective balances, their penalties do not: one
// cooperative launch, its grid no larger than the blocks that fit on the
// card at once. Phase 1 reads the columns once (grid-stride over warp chunks
// of 256 validators, 16-byte loads of the balances, two flag bytes a load),
// writes every penalty, and sums its block's share into one word of the
// call's scratch; each thread keeps its first chunk's base rewards and flags
// in registers. A grid sync; then every block adds the partial sums
// (addition mod 2^64 is associative, so every block has the same total) and
// writes the rewards, from the registers (a chunk past the first, or past
// the vector path, is read again). Stores go as 16-byte vectors. The
// sweep's scalars (isqrt, base reward per increment, reward divisor) and the
// reciprocals of its three fixed divisors (udiv64_core.h) are made once a
// call by the launcher on the host; a block makes the participating
// increments from the sum with one multiply-high.
//
// What bounds them on an H100: bytes. Flag deltas move 26 bytes a validator
// (8 + 1 + 1 in, two words out), 27 MB at 2^20, about 8 us at 3.35 TB/s;
// inactivity updates 18 bytes, penalties 25. Every division by a value
// fixed for the sweep (in the flag deltas and the inactivity penalties) is
// a multiply-high by a reciprocal and a correction, about 17 integer
// operations. The penalty grids the kernel was measured against live in
// tools/penalty_forms.cu, the updates' parent (one validator a thread) in
// tools/sweep_parent_forms.cu.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "altair_core.h"

namespace {

// The warp chunks of the three sweeps (warp_chunks.h):
// step j, lane t takes validators 64 j + 2 t and 64 j + 2 t + 1 (one 16-byte
// load of each word column, one 2-byte load of each flag column), so each
// load of the warp is contiguous.
constexpr int kThreads = altair_core::kSweepThreads;
constexpr int kWarps = altair_core::kSweepWarps;
using altair_core::kChunk;
using altair_core::kChunkSteps;

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// The block's sum of v, mod 2^64, to every thread.
__device__ __forceinline__ uint64_t block_sum(uint64_t v, uint64_t* warp_sums) {
  v = warp_sum(v);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = v;
  __syncthreads();
  v = 0;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) v += warp_sums[w];
  __syncthreads();  // warp_sums is free again
  return v;
}

// The flag-delta columns: (n,) words and flags in, (n,) words out. `chunks`
// whole warp chunks take the vector path (0 where a column is not aligned
// for it); the rest go one validator a thread.
struct FlagColumns {
  const uint64_t* eff;
  const bool* participating;
  const bool* eligible;
  int64_t n;
  int64_t chunks;
  uint64_t* rewards;
  uint64_t* penalties;
};

__device__ __forceinline__ int64_t global_warp() {
  return static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
}

// What a thread keeps of its first warp chunk between the two phases: the
// base rewards of its 8 validators and their flags (bit 2v participating,
// bit 2v + 1 eligible), so that the second phase reads nothing again.
struct Kept {
  uint64_t base[2 * kChunkSteps];
  unsigned flags;
  bool valid;
};

// Phase 1: this block's share of the masked sum into partials[blockIdx.x],
// and every penalty (a penalty needs no sum). Each thread keeps its first
// chunk in `kept`.
__device__ __forceinline__ void sums_and_penalties(const FlagColumns& c,
                                                   const altair_core::FlagSweep& s,
                                                   uint64_t weight, bool is_head,
                                                   uint64_t* partials, uint64_t* warp_sums,
                                                   Kept& kept) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  uint64_t acc = 0;
  kept.flags = 0;
  kept.valid = false;
  for (int64_t k = global_warp(); k < c.chunks; k += warps) {
    const bool keep = !kept.valid;
#pragma unroll
    for (int j = 0; j < kChunkSteps; ++j) {
      const int64_t i = k * kChunk + 64 * j + 2 * lane;
      const ulonglong2 e = *reinterpret_cast<const ulonglong2*>(c.eff + i);
      const unsigned p = *reinterpret_cast<const unsigned short*>(c.participating + i);
      const unsigned q = *reinterpret_cast<const unsigned short*>(c.eligible + i);
      uint64_t penalty[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const uint64_t eff = h ? e.y : e.x;
        const bool part = (p >> (8 * h)) & 0xff;
        const bool elig = (q >> (8 * h)) & 0xff;
        const uint64_t base = altair_core::flag_base_reward(eff, s);
        acc += part ? eff : 0;
        penalty[h] = altair_core::flag_penalty(base, part, elig, s, weight, is_head);
        if (keep) {
          kept.base[2 * j + h] = base;
          kept.flags |= (part ? 1u : 0u) << (2 * (2 * j + h));
          kept.flags |= (elig ? 2u : 0u) << (2 * (2 * j + h));
        }
      }
      *reinterpret_cast<ulonglong2*>(c.penalties + i) = make_ulonglong2(penalty[0], penalty[1]);
    }
    kept.valid = true;
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = c.chunks * kChunk + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < c.n; i += threads) {
    const uint64_t base = altair_core::flag_base_reward(c.eff[i], s);
    acc += c.participating[i] ? c.eff[i] : 0;
    c.penalties[i] =
        altair_core::flag_penalty(base, c.participating[i], c.eligible[i], s, weight, is_head);
  }
  acc = block_sum(acc, warp_sums);
  if (threadIdx.x == 0) partials[blockIdx.x] = acc;
}

// The sum of the `count` partial sums (written by other blocks before a grid
// sync or an earlier launch: read past L1), to every thread.
__device__ __forceinline__ uint64_t gathered_sum(const uint64_t* partials, int count,
                                                 uint64_t* warp_sums) {
  uint64_t acc = 0;
  for (int b = threadIdx.x; b < count; b += kThreads) {
    acc += __ldcg(reinterpret_cast<const unsigned long long*>(partials) + b);
  }
  return block_sum(acc, warp_sums);
}

// Phase 2: every reward, the first chunk of each thread from `kept`, any
// other read again.
__device__ __forceinline__ void rewards_pass(const FlagColumns& c, const altair_core::FlagSweep& s,
                                             uint64_t increments, uint64_t weight, bool leaking,
                                             const Kept& kept) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t k = global_warp(); k < c.chunks; k += warps) {
    const bool from_kept = kept.valid && k == global_warp();
#pragma unroll
    for (int j = 0; j < kChunkSteps; ++j) {
      const int64_t i = k * kChunk + 64 * j + 2 * lane;
      uint64_t base[2];
      unsigned flags;
      if (from_kept) {
        base[0] = kept.base[2 * j];
        base[1] = kept.base[2 * j + 1];
        flags = kept.flags >> (4 * j);
      } else {
        const ulonglong2 e = *reinterpret_cast<const ulonglong2*>(c.eff + i);
        const unsigned p = *reinterpret_cast<const unsigned short*>(c.participating + i);
        const unsigned q = *reinterpret_cast<const unsigned short*>(c.eligible + i);
        base[0] = altair_core::flag_base_reward(e.x, s);
        base[1] = altair_core::flag_base_reward(e.y, s);
        flags = ((p & 0xff) ? 1u : 0u) | ((q & 0xff) ? 2u : 0u) | ((p >> 8) ? 4u : 0u) |
                ((q >> 8) ? 8u : 0u);
      }
      uint64_t reward[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        reward[h] = altair_core::flag_reward(base[h], (flags >> (2 * h)) & 1,
                                             (flags >> (2 * h + 1)) & 1, s, increments, weight,
                                             leaking);
      }
      *reinterpret_cast<ulonglong2*>(c.rewards + i) = make_ulonglong2(reward[0], reward[1]);
    }
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = c.chunks * kChunk + static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < c.n; i += threads) {
    const uint64_t base = altair_core::flag_base_reward(c.eff[i], s);
    c.rewards[i] = altair_core::flag_reward(base, c.participating[i], c.eligible[i], s,
                                            increments, weight, leaking);
  }
}

// One flag's deltas in one cooperative launch: the partial sums into
// `partials` (a word a block) and the penalties, a grid sync, then the total
// in every block and the rewards.
__global__ void __launch_bounds__(kThreads)
    flag_deltas_kernel(FlagColumns c, altair_core::FlagSweep s, uint64_t weight, int leaking,
                       int is_head, uint64_t* __restrict__ partials) {
  __shared__ uint64_t warp_sums[kWarps];
  Kept kept;
  sums_and_penalties(c, s, weight, is_head != 0, partials, warp_sums, kept);
  cooperative_groups::this_grid().sync();
  const uint64_t total = gathered_sum(partials, gridDim.x, warp_sums);
  rewards_pass(c, s, udiv64_core::divide(total, s.increment), weight, leaking != 0, kept);
}

// The inactivity penalties: a warp's chunks (from global_warp, a grid's
// warps apart), each step's loads issued before the first division; then
// this thread's validators past the chunks.
__global__ void __launch_bounds__(kThreads)
    inactivity_penalties_kernel(altair_core::PenaltyColumns c,
                                udiv64_core::UDiv64 by_denominator) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * kWarps;
  for (int64_t k = global_warp(); k < c.chunks; k += warps) {
    ulonglong2 eff[kChunkSteps], score[kChunkSteps];
    unsigned flags[kChunkSteps];
#pragma unroll
    for (int j = 0; j < kChunkSteps; ++j) {
      const int64_t i = altair_core::chunk_index(k, j, lane);
      eff[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.eff + i));
      score[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.scores + i));
      flags[j] = __ldcs(reinterpret_cast<const unsigned short*>(c.not_target + i));
    }
#pragma unroll
    for (int j = 0; j < kChunkSteps; ++j) {
      const int64_t i = altair_core::chunk_index(k, j, lane);
      *reinterpret_cast<ulonglong2*>(c.out + i) = make_ulonglong2(
          altair_core::inactivity_penalty(eff[j].x, score[j].x, flags[j] & 0xffu,
                                          by_denominator),
          altair_core::inactivity_penalty(eff[j].y, score[j].y, flags[j] >> 8, by_denominator));
    }
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = altair_core::tail_first(c.chunks, blockIdx.x, threadIdx.x); i < c.n;
       i += threads) {
    c.out[i] = altair_core::inactivity_penalty(c.eff[i], c.scores[i], c.not_target[i] != 0,
                                               by_denominator);
  }
}

using altair_core::aligned;

// The inactivity updates on chunks of kSteps steps, a chunk a warp.
template <int kSteps>
int launch_updates(const void* scores, const void* participating, const void* eligible, int64_t n,
                   uint64_t bias, uint64_t recovery_rate, bool leaking, void* out,
                   cudaStream_t stream) {
  altair_core::inactivity_updates_kernel<kSteps>
      <<<static_cast<unsigned>(altair_core::chunk_grid<kSteps>(n)), kThreads, 0, stream>>>(
          altair_core::update_columns<kSteps>(scores, participating, eligible, n, out), bias,
          recovery_rate, leaking);
  return static_cast<int>(cudaGetLastError());
}

// The flag-delta blocks that fit on the current device at once (cached a
// device): the cooperative launch's largest grid.
int co_resident_blocks() {
  static int cached[64];
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return 0;
  if (cached[device] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flag_deltas_kernel, kThreads, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) {
      return 0;
    }
    cached[device] = per_sm * sms;
  }
  return cached[device];
}

// The flag-delta columns as the kernels take them: the vector path where
// the balances and outputs are 16-byte aligned and the flags 2-byte.
FlagColumns flag_columns(const void* eff, const void* participating, const void* eligible,
                         int64_t n, void* rewards, void* penalties) {
  const bool vector = aligned(eff, 16) && aligned(rewards, 16) && aligned(penalties, 16) &&
                      aligned(participating, 2) && aligned(eligible, 2);
  return {static_cast<const uint64_t*>(eff), static_cast<const bool*>(participating),
          static_cast<const bool*>(eligible), n, vector ? n / kChunk : 0,
          static_cast<uint64_t*>(rewards), static_cast<uint64_t*>(penalties)};
}

}  // namespace

// Every launcher: pointers to (n,) columns contiguous on the current device;
// launches on `stream` and returns cudaGetLastError() (0 = launched); n == 0
// launches nothing. A zero divisor is refused (cudaErrorInvalidValue).

// sum_scratch: scratch_words 64-bit words of device memory, a partial sum
// a block (the grid is cut to fit them); no zeroing needed.
extern "C" int flag_deltas_launch(const void* eff, const void* participating,
                                  const void* eligible, int64_t n,
                                  uint64_t total_active, uint64_t weight,
                                  uint64_t increment,
                                  uint64_t base_reward_factor,
                                  uint64_t weight_denominator, int leaking,
                                  int is_head, void* sum_scratch,
                                  int64_t scratch_words, void* rewards,
                                  void* penalties, void* stream) {
  if (n < 0 || scratch_words < 1 || increment == 0 || weight_denominator == 0 ||
      total_active == 0 || (total_active / increment) * weight_denominator == 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return 0;
  FlagColumns c = flag_columns(eff, participating, eligible, n, rewards, penalties);
  altair_core::FlagSweep sweep = altair_core::flag_sweep(
      total_active, increment, base_reward_factor, weight_denominator);
  const int64_t fit = co_resident_blocks();
  if (fit <= 0) return static_cast<int>(cudaErrorInvalidConfiguration);
  int64_t grid = (n + 8 * kThreads - 1) / (8 * kThreads);  // about 8 validators a thread
  grid = grid < fit ? grid : fit;
  grid = grid < scratch_words ? grid : scratch_words;
  uint64_t* partials = static_cast<uint64_t*>(sum_scratch);
  void* args[] = {&c, &sweep, &weight, &leaking, &is_head, &partials};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(flag_deltas_kernel), dim3(static_cast<unsigned>(grid)),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream)));
}

extern "C" int inactivity_updates_launch(const void* scores,
                                         const void* participating,
                                         const void* eligible, int64_t n,
                                         uint64_t bias, uint64_t recovery_rate,
                                         int leaking, void* out, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return launch_updates<altair_core::kUpdateSteps>(scores, participating, eligible, n, bias,
                                                   recovery_rate, leaking != 0, out,
                                                   static_cast<cudaStream_t>(stream));
}

extern "C" int inactivity_penalties_launch(const void* eff, const void* scores,
                                           const void* not_target, int64_t n,
                                           uint64_t denominator, void* out,
                                           void* stream) {
  if (n < 0 || denominator == 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  inactivity_penalties_kernel<<<static_cast<unsigned>(altair_core::chunk_grid(n)), kThreads,
                                0, static_cast<cudaStream_t>(stream)>>>(
      altair_core::penalty_columns(eff, scores, not_target, n, out),
      udiv64_core::prepare(denominator));
  return static_cast<int>(cudaGetLastError());
}
