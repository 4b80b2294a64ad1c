// The masked sums of the epoch passes, for Hopper (sm_90a): one kernel body
// for the epoch step's four sums (chain_step.cu, K2) and the three flag sums
// of the sharded fused pass (fused_epoch.cu), and its schedule run on the
// host.
//
// Replace the sums of the reference package's shard_map bodies
// ethereum_consensus_tpu/parallel/step.py:254 _epoch_sweep_step (:316-342:
// the active-current total and the three flag sums) and parallel/epoch.py:88
// _fused_sharded (the three flag sums of epoch_vector.py fused_epoch_kernel),
// each one shard's share before the psum. Sum f (0..2) adds the effective
// balances of the unslashed validators active in the previous epoch whose
// participation flag f is set; with K = 4, sum 3 adds those of the
// validators active in the current epoch. Every sum is mod 2^64, and that
// addition is associative and commutative, so any order of adding gives the
// same bits.
//
// The partition. The vector path takes whole steps of kStep consecutive
// validators where the effective balances are 16-byte aligned and every byte
// column kStep-byte aligned: a thread loads the step's effective balances 16
// bytes at a time and kStep bytes of each byte column, all before the first
// add, as streaming loads (every byte is read once). Block b of a grid of
// G blocks of T threads takes the contiguous steps [b S, b S + S), S =
// ceil(steps / G); thread t takes steps b S + t, b S + t + T, ... The
// validators past the last whole step (all of them where a column is not
// aligned) go one a thread: thread t of block b takes V + b T + t, V the
// steps' validators, stepping by the grid's threads.
//
// The finish. Each block adds its threads' sums (warp shuffles, then one
// warp) and writes its K partial words into the call's scratch; a grid sync
// (a cooperative launch, its grid no larger than the blocks that fit on the
// card at once); block 0 adds the partials (each thread's loads issued at
// once) and writes the K output words.
// The kernel writes every word it reads, so the caller zeroes nothing and a
// call is one launch; nothing is kept from one call to the next. The
// alternatives these choices were measured against (16 validators a step,
// read-only loads, other finishes and blocks) live in tools/sums_forms.cu.
//
// The grid: a step a thread where the card holds that many blocks at once
// (512 blocks of 256 threads at 2^20 validators, in one wave at 4 blocks an
// SM), at least one block an SM where the work gives every block a warp's
// steps (2^18 validators spread over all 132 SMs of an H100), and no more
// than the scratch holds.
//
// What bounds it on an H100: bytes. K = 4 reads 12 bytes a validator (a word
// and four flags), 3.8 us at 2^20 at 3.35 TB/s; K = 3 reads 11, 3.4 us. The
// integer work is a dozen operations a validator.
//
// The lane and the schedule's helpers are plain C++ outside nvcc too, and
// masked_sums_host runs the kernel's schedule for g++ (block by block,
// thread by thread, step by step; the vector and one-a-thread paths; then
// the finish in block order), so that the CPU tests hold its partition
// against the reference.

#pragma once

#include <stddef.h>
#include <stdint.h>

#ifdef __CUDACC__
#include <cooperative_groups.h>
#include <cuda_runtime.h>
#define MASKED_SUMS_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define MASKED_SUMS_HD inline
#endif

namespace masked_sums {

// Threads a block, and its warps.
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
// Threads an SM the kernel's registers must allow (64 registers a thread):
// a step a thread at 2^20 validators then runs in one wave.
constexpr int kThreadsPerSm = 1024;
// Validators a thread takes a step on the vector path: two of them a
// 16-byte load of the effective balances, all of them one 8-byte load of
// each byte column.
constexpr int kStep = 8;
// Partial blocks a thread of the finish loads at once.
constexpr int kRounds = 4;

// The columns, all (n,): the effective balances as unsigned 64-bit words,
// the participation flags as bytes, the booleans as one byte (0 or 1);
// active_cur is null where K = 3. `steps` whole steps take the vector path
// (0 where a column is not aligned for it).
struct Columns {
  const uint64_t* eff;
  const uint8_t* part;
  const uint8_t* slashed;
  const uint8_t* active_prev;
  const uint8_t* active_cur;
  int64_t n;
  int64_t steps;
};

// One validator's share of the K sums (acc[0..K)): sums 0..2 the flags over
// the unslashed validators active in the previous epoch, sum 3 (K = 4) the
// validators active in the current epoch.
template <int K>
MASKED_SUMS_HD void lane(uint64_t eff, uint8_t part, uint8_t slashed, uint8_t active_prev,
                         uint8_t active_cur, uint64_t* acc) {
  static_assert(K == 3 || K == 4, "three flag sums, and the active-current total with K = 4");
  const bool unslashed_active = active_prev != 0 && slashed == 0;
  for (int f = 0; f < 3; ++f) {
    acc[f] += (unslashed_active && ((part >> f) & 1)) ? eff : 0;
  }
  if constexpr (K == 4) acc[3] += active_cur != 0 ? eff : 0;
}

// The columns as the kernel takes them: the vector path where the words are
// 16-byte aligned and the byte columns kStep-byte.
inline Columns make_columns(const void* eff, const void* part, const void* slashed,
                            const void* active_prev, const void* active_cur, int64_t n) {
  const auto aligned = [](const void* p, uintptr_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
  };
  const bool vector = aligned(eff, 16) && aligned(part, kStep) && aligned(slashed, kStep) &&
                      aligned(active_prev, kStep) && aligned(active_cur, kStep);
  return {static_cast<const uint64_t*>(eff), static_cast<const uint8_t*>(part),
          static_cast<const uint8_t*>(slashed), static_cast<const uint8_t*>(active_prev),
          static_cast<const uint8_t*>(active_cur), n, vector ? n / kStep : 0};
}

// The grid of blocks of `threads`: a step (or, off the vector path, a
// validator) a thread, at least `sms` blocks where the work gives each a
// warp's steps, at most `co_resident` blocks and `partial_blocks`, at least
// one.
MASKED_SUMS_HD int64_t grid_for(const Columns& c, int threads, int64_t co_resident, int64_t sms,
                                int64_t partial_blocks) {
  const int64_t items = c.steps > 0 ? c.steps : c.n;
  int64_t grid = (items + threads - 1) / threads;
  const int64_t spread = (items + 31) / 32;
  const int64_t least = spread < sms ? spread : sms;
  grid = grid > least ? grid : least;
  grid = grid < co_resident ? grid : co_resident;
  grid = grid < partial_blocks ? grid : partial_blocks;
  return grid > 1 ? grid : 1;
}

// The steps of block `block` of `grid`: [*first, *last).
MASKED_SUMS_HD void block_steps(int64_t steps, int64_t grid, int64_t block, int64_t* first,
                                int64_t* last) {
  const int64_t per_block = (steps + grid - 1) / grid;
  const int64_t begin = block * per_block;
  const int64_t end = begin + per_block;
  *first = begin < steps ? begin : steps;
  *last = end < steps ? end : steps;
}

// The first validator past the steps of thread `thread` of block `block`
// (blocks of `threads`); the next are a grid's threads apart.
MASKED_SUMS_HD int64_t tail_first(const Columns& c, int threads, int64_t block, int thread) {
  return c.steps * kStep + block * threads + thread;
}

#ifdef __CUDACC__

__device__ __forceinline__ uint64_t warp_sum(uint64_t v) {
  for (int offset = 16; offset > 0; offset >>= 1) {
    v += __shfl_down_sync(0xffffffffu, v, offset);
  }
  return v;
}

// kStep bytes of a byte column in one streaming load (ld.global.cs, evict
// first: every byte is read once), and byte v of them.
__device__ __forceinline__ uint64_t load_bytes(const uint8_t* p) {
  return __ldcs(reinterpret_cast<const unsigned long long*>(p));
}

__device__ __forceinline__ uint8_t byte_at(uint64_t bytes, int v) {
  return static_cast<uint8_t>(bytes >> (8 * v));
}

// The lanes of step s: every load issued, then the adds.
template <int K>
__device__ __forceinline__ void step(const Columns& c, int64_t s, uint64_t* acc) {
  const int64_t i = s * kStep;
  ulonglong2 eff[kStep / 2];
#pragma unroll
  for (int j = 0; j < kStep / 2; ++j) {
    eff[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.eff + i) + j);
  }
  const uint64_t part = load_bytes(c.part + i);
  const uint64_t slashed = load_bytes(c.slashed + i);
  const uint64_t active_prev = load_bytes(c.active_prev + i);
  uint64_t active_cur = 0;
  if constexpr (K == 4) active_cur = load_bytes(c.active_cur + i);
#pragma unroll
  for (int v = 0; v < kStep; ++v) {
    lane<K>((v & 1) ? eff[v / 2].y : eff[v / 2].x, byte_at(part, v), byte_at(slashed, v),
            byte_at(active_prev, v), byte_at(active_cur, v), acc);
  }
}

// This thread's share of the block's sums, added into acc[0..K): its steps
// of the block's range, then its validators past the steps.
template <int K>
__device__ __forceinline__ void thread_sums(const Columns& c, uint64_t* acc) {
  int64_t first, last;
  block_steps(c.steps, gridDim.x, blockIdx.x, &first, &last);
  for (int64_t s = first + threadIdx.x; s < last; s += kThreads) step<K>(c, s, acc);
  for (int64_t i = tail_first(c, kThreads, blockIdx.x, threadIdx.x); i < c.n;
       i += static_cast<int64_t>(gridDim.x) * kThreads) {
    lane<K>(c.eff[i], c.part[i], c.slashed[i], c.active_prev[i],
            K == 4 ? c.active_cur[i] : 0, acc);
  }
}

// The block's K sums of every thread's acc, to thread 0. warp_sums is free
// on entry (a __syncthreads lies between this and its last use).
template <int K>
__device__ __forceinline__ void block_sum(uint64_t* acc, uint64_t (*warp_sums)[kWarps]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    acc[k] = warp_sum(acc[k]);
    if ((threadIdx.x & 31) == 0) warp_sums[k][threadIdx.x >> 5] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] = warp_sum(threadIdx.x < kWarps ? warp_sums[k][threadIdx.x] : 0);
    }
  }
}

// The finish of one block: the K sums of the grid's partial words (sum k of
// block b at partials[k gridDim.x + b]) into words[0..K), a thread's blocks
// kRounds at a time, all their loads issued before the first add. warp_sums
// is free on entry.
template <int K>
__device__ __forceinline__ void finish(const uint64_t* partials, uint64_t (*warp_sums)[kWarps],
                                       unsigned long long* words) {
  const auto* from = reinterpret_cast<const unsigned long long*>(partials);
  const int grid = static_cast<int>(gridDim.x);
  uint64_t total[K] = {};
#pragma unroll 1
  for (int first = threadIdx.x; first < grid; first += kRounds * kThreads) {
    uint64_t got[kRounds][K];
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int b = first + r * kThreads;
#pragma unroll
      for (int k = 0; k < K; ++k) got[r][k] = b < grid ? __ldcg(from + k * grid + b) : 0;
    }
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
#pragma unroll
      for (int k = 0; k < K; ++k) total[k] += got[r][k];
    }
  }
  block_sum<K>(total, warp_sums);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) words[k] = total[k];
  }
}

// The kernel. words: [0..K) the sums (out), then K partial words a block,
// sum k of block b at K + k gridDim.x + b.
template <int K>
__global__ void __launch_bounds__(kThreads, kThreadsPerSm / kThreads)
    masked_sums_kernel(Columns c, unsigned long long* __restrict__ words) {
  __shared__ uint64_t warp_sums[K][kWarps];
  uint64_t acc[K] = {};
  thread_sums<K>(c, acc);
  block_sum<K>(acc, warp_sums);
  uint64_t* partials = reinterpret_cast<uint64_t*>(words) + K;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) partials[k * gridDim.x + blockIdx.x] = acc[k];
  }
  cooperative_groups::this_grid().sync();
  if (blockIdx.x == 0) finish<K>(partials, warp_sums, words);
}

// The kernel's blocks that fit on the current device at once and the
// device's SMs (cached a device), false where the runtime cannot say.
template <int K>
bool device_fit(int64_t* co_resident, int64_t* sms) {
  static int cached[64][2];
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return false;
  if (cached[device][0] == 0) {
    int per_sm = 0, count = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, masked_sums_kernel<K>, kThreads,
                                                      0) != cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) !=
            cudaSuccess ||
        per_sm * count <= 0) {
      return false;
    }
    cached[device][1] = count;
    cached[device][0] = per_sm * count;
  }
  *co_resident = cached[device][0];
  *sms = cached[device][1];
  return true;
}

// K sums of the (n,) columns into words[0..K), in one cooperative launch on
// `stream`: words holds word_count 64-bit words of device memory, at least
// 2 K (the partials take the rest; the grid is cut to fit them). n == 0
// launches one block, which writes zeros. Returns the launch's error (0 =
// launched).
template <int K>
int launch(const void* eff, const void* part, const void* slashed, const void* active_prev,
           const void* active_cur, int64_t n, void* words, int64_t word_count, void* stream) {
  if (n < 0 || word_count < 2 * K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t co_resident = 0, sms = 0;
  if (!device_fit<K>(&co_resident, &sms)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  Columns c = make_columns(eff, part, slashed, active_prev, active_cur, n);
  const int64_t grid = grid_for(c, kThreads, co_resident, sms, (word_count - K) / K);
  unsigned long long* out = static_cast<unsigned long long*>(words);
  void* args[] = {&c, &out};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(masked_sums_kernel<K>), dim3(static_cast<unsigned>(grid)),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream)));
}

#else  // the host

// The kernel on a grid of `grid` blocks of `threads`, run on the host in
// its order: each block's threads, each thread's steps and then its
// validators past the steps, into the block's K partial words; then the
// partials added in block order into sums[0..K). visits, where not null,
// counts each validator's visits.
template <int K>
inline void masked_sums_host(const Columns& c, int64_t grid, int threads, uint64_t* sums,
                             uint8_t* visits) {
  std::vector<uint64_t> partials(static_cast<size_t>(K * grid), 0);
  const auto visit = [&](int64_t i, uint64_t* acc) {
    if (visits) visits[i] = static_cast<uint8_t>(visits[i] + 1);
    lane<K>(c.eff[i], c.part[i], c.slashed[i], c.active_prev[i], K == 4 ? c.active_cur[i] : 0,
            acc);
  };
  for (int64_t b = 0; b < grid; ++b) {
    int64_t first, last;
    block_steps(c.steps, grid, b, &first, &last);
    uint64_t* acc = partials.data() + K * b;
    for (int t = 0; t < threads; ++t) {
      for (int64_t s = first + t; s < last; s += threads) {
        for (int v = 0; v < kStep; ++v) visit(s * kStep + v, acc);
      }
      for (int64_t i = tail_first(c, threads, b, t); i < c.n; i += grid * threads) {
        visit(i, acc);
      }
    }
  }
  for (int k = 0; k < K; ++k) {
    sums[k] = 0;
    for (int64_t b = 0; b < grid; ++b) sums[k] += partials[static_cast<size_t>(K * b + k)];
  }
}

#endif  // __CUDACC__

}  // namespace masked_sums
