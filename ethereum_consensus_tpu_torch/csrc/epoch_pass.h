// The element pass of the fused altair epoch kernel (fused_epoch.cu: B3 and
// its two apply entries) and of the epoch step (chain_step.cu: K3): the
// partition of the validators into blocks, warps and chunks, the chunk code
// on the card, and the fused kernel's whole schedule run on the host.
//
// The partition. Whole warp chunks of kChunk validators take the vector path
// where every column is aligned for it (the words to 16 bytes, the byte
// columns to 2): at step j of a chunk, lane t takes validators 64 j + 2 t
// and 64 j + 2 t + 1, 16 bytes of each word column and 2 of each byte
// column, so that each of the warp's reads is contiguous.
// Warp w of a grid of W warps takes chunks w, w + W, w + 2 W, ...; the
// validators past the last whole chunk (all of them where a column is not
// aligned) go one a thread: thread t of block b takes C + b kThreads + t, C
// the chunks' validators, stepping by the grid's threads.
//
// The chunk code and the apply kernel are for nvcc only. The schedule's
// helpers are plain C++ outside nvcc too, and fused_pass_host runs the
// fused kernel's schedule for g++ (block by block, warp by warp, lane by
// lane: phase 1, the sums, phase 2), so that the CPU tests hold its
// partition and its lanes against the reference.

#pragma once

#include <stdint.h>

#include "altair_core.h"

#ifndef __CUDACC__
#include <vector>
#endif

#ifdef __CUDACC__
#define EPOCH_PASS_HD __host__ __device__ __forceinline__
#else
#define EPOCH_PASS_HD inline
#endif

namespace epoch_pass {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Blocks an SM: 4 at 64 registers, so that the 512 blocks of a chunk a warp
// at 2^20 validators run in one wave.
constexpr int kMinBlocks = 4;
constexpr int kChunkSteps = 4;  // steps of 64 validators in a warp chunk
constexpr int kChunk = 64 * kChunkSteps;
constexpr int kPerLane = 2 * kChunkSteps;  // a lane's validators in a chunk

// The pass's columns, all (n,): words as unsigned 64-bit, the participation
// flags as bytes, booleans as one byte (0 or 1). `chunks` whole warp chunks
// take the vector path (0 where a column is not aligned for it).
// out_scores is null where the pass writes no scores.
struct Columns {
  const uint64_t* balances;
  const uint64_t* eff;
  const uint8_t* part;
  const uint8_t* slashed;
  const uint8_t* active_prev;
  const uint8_t* eligible;
  const uint64_t* scores;
  int64_t n;
  int64_t chunks;
  uint64_t* out_scores;
  uint64_t* out_balances;
};

EPOCH_PASS_HD int64_t chunk_count(int64_t n, bool vector) { return vector ? n / kChunk : 0; }

// Validator `half` (0 or 1) of `lane` at `step` of chunk `chunk`.
EPOCH_PASS_HD int64_t chunk_index(int64_t chunk, int step, int lane, int half) {
  return chunk * kChunk + 64 * step + 2 * lane + half;
}

// The first validator past the chunks of thread `thread` of block `block`;
// the next are a grid's threads apart.
EPOCH_PASS_HD int64_t tail_first(int64_t chunks, int64_t block, int thread) {
  return chunks * kChunk + block * kThreads + thread;
}

// Blocks of a pass that gives every warp one chunk, or one block.
EPOCH_PASS_HD int64_t blocks_for(int64_t n) {
  const int64_t per_block = int64_t{kWarps} * kChunk;
  const int64_t blocks = (n + per_block - 1) / per_block;
  return blocks < 1 ? 1 : blocks;
}

// The fused kernel's grid: a chunk a warp where the card holds that many
// blocks at once and the scratch has their partial sums (three words a
// block), else as many as it can.
EPOCH_PASS_HD int64_t fused_grid(int64_t n, int64_t co_resident, int64_t partial_blocks) {
  int64_t grid = blocks_for(n);
  grid = grid < co_resident ? grid : co_resident;
  return grid < partial_blocks ? grid : partial_blocks;
}

// The pass's columns as the kernels take them: the vector path where the
// words are 16-byte aligned and the byte columns 2-byte. out_scores may be
// null.
inline Columns make_columns(const void* balances, const void* eff, const void* part,
                            const void* slashed, const void* active_prev, const void* eligible,
                            const void* scores, int64_t n, void* out_scores,
                            void* out_balances) {
  const auto aligned = [](const void* p, uintptr_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
  };
  const bool vector = aligned(balances, 16) && aligned(eff, 16) && aligned(scores, 16) &&
                      aligned(out_scores, 16) && aligned(out_balances, 16) &&
                      aligned(part, 2) && aligned(slashed, 2) && aligned(active_prev, 2) &&
                      aligned(eligible, 2);
  return {static_cast<const uint64_t*>(balances), static_cast<const uint64_t*>(eff),
          static_cast<const uint8_t*>(part), static_cast<const uint8_t*>(slashed),
          static_cast<const uint8_t*>(active_prev), static_cast<const uint8_t*>(eligible),
          static_cast<const uint64_t*>(scores), n, chunk_count(n, vector),
          static_cast<uint64_t*>(out_scores), static_cast<uint64_t*>(out_balances)};
}

#ifdef __CUDACC__

__device__ __forceinline__ int64_t global_warp() {
  return static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
}

__device__ __forceinline__ int64_t grid_warps() {
  return static_cast<int64_t>(gridDim.x) * kWarps;
}

__device__ __forceinline__ int64_t grid_threads() {
  return static_cast<int64_t>(gridDim.x) * kThreads;
}

__device__ __forceinline__ void store16(uint64_t* p, uint64_t x, uint64_t y) {
  *reinterpret_cast<ulonglong2*>(p) = make_ulonglong2(x, y);
}

// The four byte columns of a lane's two validators at one step, as loaded
// (two bytes each).
struct StepFlags {
  unsigned part;
  unsigned slashed;
  unsigned active_prev;
  unsigned eligible;
};

// A lane's two validators at one step: the balances (with kBal), the
// effective balances, scores and flags (with kRest).
struct Step {
  ulonglong2 bal;
  ulonglong2 eff;
  ulonglong2 score;
  StepFlags flags;
};

// altair_core::lane_flags of validator `half` of the step.
__device__ __forceinline__ unsigned half_flags(const StepFlags& f, int half) {
  const int shift = 8 * half;
  return altair_core::lane_flags(static_cast<uint8_t>(f.part >> shift),
                                 (f.slashed >> shift) & 0xffu, (f.active_prev >> shift) & 0xffu,
                                 (f.eligible >> shift) & 0xffu);
}

__device__ __forceinline__ unsigned column_flags(const Columns& c, int64_t i) {
  return altair_core::lane_flags(c.part[i], c.slashed[i], c.active_prev[i], c.eligible[i]);
}

// A lane's two validators at step i of the columns: 16 bytes of each word
// column, 2 of each byte column.
template <bool kBal, bool kRest>
__device__ __forceinline__ Step load_step(const Columns& c, int64_t i) {
  Step d{};
  if (kBal) d.bal = __ldg(reinterpret_cast<const ulonglong2*>(c.balances + i));
  if (kRest) {
    d.eff = __ldg(reinterpret_cast<const ulonglong2*>(c.eff + i));
    d.score = __ldg(reinterpret_cast<const ulonglong2*>(c.scores + i));
    d.flags = {__ldg(reinterpret_cast<const unsigned short*>(c.part + i)),
               __ldg(reinterpret_cast<const unsigned short*>(c.slashed + i)),
               __ldg(reinterpret_cast<const unsigned short*>(c.active_prev + i)),
               __ldg(reinterpret_cast<const unsigned short*>(c.eligible + i))};
  }
  return d;
}

// body(t, i, step) for every step of the warp's chunks from `first_chunk`,
// a grid's warps apart, at most max_chunks of them, in order: t counts the warp's
// steps from 0 (t < kChunkSteps: its first chunk), i is the lane's first
// validator, and step holds what the lane loaded there (the balances with
// kBal, the rest with kRest).
template <bool kBal, bool kRest, class Body>
__device__ __forceinline__ void for_each_step(const Columns& c, int64_t first_chunk,
                                              int64_t max_chunks, Body body) {
  int64_t chunks =
      first_chunk < c.chunks ? (c.chunks - 1 - first_chunk) / grid_warps() + 1 : 0;
  chunks = chunks < max_chunks ? chunks : max_chunks;
  for (int64_t t = 0; t < chunks * kChunkSteps; ++t) {
    const int64_t i = chunk_index(first_chunk + (t / kChunkSteps) * grid_warps(),
                                  static_cast<int>(t % kChunkSteps), threadIdx.x & 31, 0);
    body(t, i, load_step<kBal, kRest>(c, i));
  }
}

// The wrap census: a warp sum, one shared add per warp, one global add per
// block, so that lanes that wrap together do not queue on one word.
// block_wraps is zeroed before a __syncthreads that precedes this.
__device__ __forceinline__ void census_add(unsigned wrapped, unsigned* block_wraps,
                                           unsigned long long* census) {
  wrapped = __reduce_add_sync(0xffffffffu, wrapped);
  if ((threadIdx.x & 31) == 0 && wrapped != 0) atomicAdd(block_wraps, wrapped);
  __syncthreads();
  if (threadIdx.x == 0 && *block_wraps != 0) {
    atomicAdd(census, static_cast<unsigned long long>(*block_wraps));
  }
}

// The element pass on sums already made (the increments in `s`): kUpdate,
// the inactivity update first, its scores written, the penalty off them
// (fused_epoch_lane); otherwise the rewards off the given scores
// (rewards_lane). kCensus adds the wrapped adds into *census (zeroed by the
// launcher). One launch, a chunk a warp (blocks_for).
template <bool kUpdate, bool kCensus>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    apply_kernel(Columns c, altair_core::FusedSweep s, unsigned long long* census) {
  __shared__ unsigned block_wraps;
  if (kCensus) {
    if (threadIdx.x == 0) block_wraps = 0;
    __syncthreads();
  }
  unsigned wrapped = 0;
  for_each_step<true, true>(
      c, global_warp(), c.chunks, [&](int64_t, int64_t i, const Step& d) {
        uint64_t new_score[2], new_balance[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const unsigned flags = half_flags(d.flags, h);
          const uint64_t e = h ? d.eff.y : d.eff.x;
          const uint64_t sc = h ? d.score.y : d.score.x;
          new_score[h] = kUpdate ? altair_core::sweep_update(s, sc, flags) : sc;
          wrapped += altair_core::sweep_apply(
              s, h ? d.bal.y : d.bal.x, altair_core::sweep_base_reward(s, e),
              altair_core::sweep_inactivity_penalty(s, e, new_score[h], flags), flags,
              &new_balance[h]);
        }
        if (kUpdate) store16(c.out_scores + i, new_score[0], new_score[1]);
        store16(c.out_balances + i, new_balance[0], new_balance[1]);
      });
  for (int64_t i = tail_first(c.chunks, blockIdx.x, threadIdx.x); i < c.n; i += grid_threads()) {
    if (kUpdate) {
      wrapped += altair_core::fused_epoch_lane(s, c.balances[i], c.eff[i], c.part[i],
                                               c.slashed[i], c.active_prev[i], c.eligible[i],
                                               c.scores[i], &c.out_scores[i],
                                               &c.out_balances[i]);
    } else {
      wrapped += altair_core::rewards_lane(s, c.balances[i], c.eff[i], c.part[i], c.slashed[i],
                                           c.active_prev[i], c.eligible[i], c.scores[i],
                                           &c.out_balances[i]);
    }
  }
  if (kCensus) census_add(wrapped, &block_wraps, census);
}

#else  // the host

// The fused kernel (fused_epoch.cu fused_epoch_kernel) on a grid of `grid`
// blocks, run on the host in its order: every thread's phase 1 (the
// inactivity update and its scores written, the block's three flag sums,
// the base reward and inactivity penalty of the thread's first chunk kept),
// the sums added as every block adds them after the grid sync and the
// increments made from them, then every thread's phase 2 (the kept chunk
// from what it kept, the other chunks and the tail read again). `vector`
// as the launcher finds the columns. sums[0..2] receive the flag sums;
// returns the wrap census. visits, where not null, counts each validator's
// passes: phase 1 adds 1, phase 2 adds 16.
inline uint64_t fused_pass_host(const Columns& c, const altair_core::FusedSweep& sweep,
                                int64_t grid, uint64_t sums[3], uint8_t* visits) {
  struct Kept {
    uint64_t base[kPerLane];
    uint64_t penalty[kPerLane];
    unsigned flags;
  };
  const int64_t warps = grid * kWarps;
  const int64_t threads = grid * kThreads;
  std::vector<Kept> kept(static_cast<size_t>(threads));
  std::vector<uint64_t> partials(static_cast<size_t>(3 * grid), 0);
  auto visit = [&](int64_t i, uint8_t by) {
    if (visits) visits[i] = static_cast<uint8_t>(visits[i] + by);
  };
  for (int64_t b = 0; b < grid; ++b) {
    for (int t = 0; t < kThreads; ++t) {
      Kept& mine = kept[static_cast<size_t>(b * kThreads + t)];
      mine.flags = 0;
      const int64_t first = b * kWarps + t / 32;
      const int lane = t % 32;
      for (int64_t k = first; k < c.chunks; k += warps) {
        for (int j = 0; j < kChunkSteps; ++j) {
          for (int h = 0; h < 2; ++h) {
            const int64_t i = chunk_index(k, j, lane, h);
            visit(i, 1);
            const unsigned flags = altair_core::lane_flags(c.part[i], c.slashed[i],
                                                           c.active_prev[i], c.eligible[i]);
            const uint64_t score = altair_core::sweep_update(sweep, c.scores[i], flags);
            c.out_scores[i] = score;
            for (int f = 0; f < 3; ++f) partials[3 * b + f] += ((flags >> f) & 1) ? c.eff[i] : 0;
            if (k == first) {
              const int v = 2 * j + h;
              mine.base[v] = altair_core::sweep_base_reward(sweep, c.eff[i]);
              mine.penalty[v] = altair_core::sweep_inactivity_penalty(sweep, c.eff[i], score,
                                                                      flags);
              mine.flags |= flags << (4 * v);
            }
          }
        }
      }
      for (int64_t i = tail_first(c.chunks, b, t); i < c.n; i += threads) {
        visit(i, 1);
        const unsigned flags = altair_core::lane_flags(c.part[i], c.slashed[i],
                                                       c.active_prev[i], c.eligible[i]);
        c.out_scores[i] = altair_core::sweep_update(sweep, c.scores[i], flags);
        for (int f = 0; f < 3; ++f) partials[3 * b + f] += ((flags >> f) & 1) ? c.eff[i] : 0;
      }
    }
  }
  altair_core::FusedSweep s = sweep;
  uint64_t increments[3];
  for (int f = 0; f < 3; ++f) {
    sums[f] = 0;
    for (int64_t b = 0; b < grid; ++b) sums[f] += partials[3 * b + f];
    increments[f] = altair_core::floored_increments(sweep, sums[f]);
    s.unslashed_increments[f] = increments[f];
  }
  uint64_t wrapped = 0;
  for (int64_t b = 0; b < grid; ++b) {
    for (int t = 0; t < kThreads; ++t) {
      const Kept& mine = kept[static_cast<size_t>(b * kThreads + t)];
      const int64_t first = b * kWarps + t / 32;
      const int lane = t % 32;
      for (int64_t k = first; k < c.chunks; k += warps) {
        for (int j = 0; j < kChunkSteps; ++j) {
          for (int h = 0; h < 2; ++h) {
            const int64_t i = chunk_index(k, j, lane, h);
            visit(i, 16);
            if (k == first) {
              const int v = 2 * j + h;
              wrapped += altair_core::sweep_apply(s, increments, c.balances[i], mine.base[v],
                                                  mine.penalty[v], (mine.flags >> (4 * v)) & 15u,
                                                  &c.out_balances[i]);
            } else {
              uint64_t score;
              wrapped += altair_core::fused_epoch_lane(
                  s, c.balances[i], c.eff[i], c.part[i], c.slashed[i], c.active_prev[i],
                  c.eligible[i], c.scores[i], &score, &c.out_balances[i]);
            }
          }
        }
      }
      for (int64_t i = tail_first(c.chunks, b, t); i < c.n; i += threads) {
        visit(i, 16);
        uint64_t score;
        wrapped += altair_core::fused_epoch_lane(s, c.balances[i], c.eff[i], c.part[i],
                                                 c.slashed[i], c.active_prev[i], c.eligible[i],
                                                 c.scores[i], &score, &c.out_balances[i]);
      }
    }
  }
  return wrapped;
}

#endif  // __CUDACC__

}  // namespace epoch_pass
