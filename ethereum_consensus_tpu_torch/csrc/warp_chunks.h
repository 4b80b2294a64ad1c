// The warp-chunk partition of the byte-bound sweeps, as __host__ __device__
// functions: the flag deltas, the inactivity updates and the inactivity
// penalties (altair_sweeps.cu), the hysteresis sweep (sweeps.cu) and K1
// (chain_step.cu).
//
// Blocks of kSweepThreads; a warp's chunk is 64 kSteps consecutive
// validators in kSteps steps (kChunkSteps, a chunk of kChunk, unless a
// kernel names another count): at step j lane t takes validators 64 j + 2 t and
// 64 j + 2 t + 1 (a 16-byte load of each word column, a 2-byte load of each
// flag column), so that each of the warp's loads is contiguous. A warp takes
// its chunks from warp_rank, the grid's warps apart. The validators past the
// last whole chunk (all of them where a column is not aligned for the
// chunks) go one a thread: thread t of block b takes C + b kSweepThreads +
// t, C the chunks' validators, stepping by the grid's threads. The launchers
// take chunk_grid(n) blocks: a chunk a warp.
//
// The header is plain C++ outside nvcc, so g++ builds the same functions for
// the CPU tests, which run each kernel's schedule on the host
// (schedule_host).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define WARP_CHUNKS_HD __host__ __device__ __forceinline__
#else
#define WARP_CHUNKS_HD inline
#endif

namespace warp_chunks {

constexpr int kSweepThreads = 256;
constexpr int kSweepWarps = kSweepThreads / 32;
constexpr int kChunkSteps = 4;
constexpr int kChunk = kChunkSteps * 64;

// The first of the two validators of `lane` at `step` of chunk `chunk`.
template <int kSteps = kChunkSteps>
WARP_CHUNKS_HD int64_t chunk_index(int64_t chunk, int step, int lane) {
  return chunk * (64 * kSteps) + 64 * step + 2 * lane;
}

// The first validator past the chunks of thread `thread` of block `block`.
template <int kSteps = kChunkSteps>
WARP_CHUNKS_HD int64_t tail_first(int64_t chunks, int64_t block, int thread) {
  return chunks * (64 * kSteps) + block * kSweepThreads + thread;
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// The grid of a warp chunk a warp (512 kSteps validators a block: 512
// blocks at 2^20 and four steps), at least one block. Grids of one, two and
// four blocks an SM were measured slower for the penalties
// (tools/step_penalty_forms.py).
template <int kSteps = kChunkSteps>
WARP_CHUNKS_HD int64_t chunk_grid(int64_t n) {
  const int64_t per_block = int64_t{kSweepWarps} * (64 * kSteps);
  const int64_t grid = (n + per_block - 1) / per_block;
  return grid > 1 ? grid : 1;
}

// Warp `warp` of block `block`, counted over the grid: its first chunk; its
// next are the grid's warps apart.
WARP_CHUNKS_HD int64_t warp_rank(int64_t block, int warp) { return block * kSweepWarps + warp; }

#ifndef __CUDACC__

// A kernel's schedule on a grid of `grid` blocks, run on the host in its
// order: each block's threads, each thread's `chunks` whole chunks step by
// step (its two validators a step), then its validators past the chunks up
// to n; visit(block, i) for each.
template <int kSteps = kChunkSteps, typename Visit>
inline void schedule_host(int64_t chunks, int64_t n, int64_t grid, Visit&& visit) {
  for (int64_t b = 0; b < grid; ++b) {
    for (int t = 0; t < kSweepThreads; ++t) {
      for (int64_t k = warp_rank(b, t / 32); k < chunks; k += grid * kSweepWarps) {
        for (int j = 0; j < kSteps; ++j) {
          for (int h = 0; h < 2; ++h) visit(b, chunk_index<kSteps>(k, j, t % 32) + h);
        }
      }
      for (int64_t i = tail_first<kSteps>(chunks, b, t); i < n; i += grid * kSweepThreads) {
        visit(b, i);
      }
    }
  }
}

#endif  // __CUDACC__

}  // namespace warp_chunks
