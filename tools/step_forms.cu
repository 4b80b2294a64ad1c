// Measured alternatives of K1, the chain step's shard kernel
// (csrc/chain_step.cu), for tools/step_penalty_forms.py: the program's lane
// on other partitions, schedules and finishes. These are measurements, not
// part of the program.
//
// Two finishes of the total: the grid sync (a cooperative launch, each
// block's partial word written, a grid sync, block 0 adds them) and the
// program's (the total zeroed on the stream, then a plain launch whose
// blocks each add their sum with one 64-bit atomicAdd).
//
// The block ranges (the first design built for this kernel): block b of G
// takes the contiguous SSZ chunks [b S, b S + S), S = ceil(chunks / G),
// thread t chunks b S + t, b S + t + T, ... (T threads a block), kStep of
// them a step, two 16-byte streaming loads of each word column and a 4-byte
// load of the flags a chunk, all before the step's first division; the grid
// a step a thread, no more than the card holds at once (512 blocks at 2^20
// at two a step, 528 at one):
//   form 1  two chunks a step, the grid sync;
//   form 2  one chunk a step, the grid sync;
//   form 10 form 1 with the program's finish;
//   form 11 form 2 with the program's finish;
//   form 17 one chunk a step staged in shared memory: a block's 256 chunks
//           loaded and their new effective balances stored 16 bytes a
//           thread at consecutive addresses, the grid sync;
//   form 18 form 1 on plain loads (ld.global) in place of streaming ones;
//   form 19 form 1 at three blocks an SM (85 registers; 396 blocks);
// other schedules of chunks:
//   form 4  the parent's: a chunk a thread, a block per 256 chunks (two
//           waves at 2^20), the program's finish;
//   form 5  a grid-stride partition, thread g of the grid's G taking chunks
//           g, g + G, ..., one a step (528 blocks at 2^20), the grid sync;
//   form 20 form 5 at two chunks a step (512 blocks);
//   form 21 form 20 with the program's finish;
//   form 22 form 5 with the program's finish;
//   form 15 a persistent grid of one block an SM, each thread's chunks a
//           block's range apart as in form 2, its next chunk loaded before
//           it computes the current one, the grid sync;
//   form 16 form 15 at two blocks an SM;
// the program's warp chunks (a warp 64 k consecutive validators, a lane two
// of them a step; the program's kernel at k = 4):
//   form 3  the program's kernel with the grid sync, one cooperative launch
//           of a warp chunk a warp up to the co-resident blocks;
//   form 8  form 3 on warp chunks of 128 validators (k = 2);
//   form 9  form 3 on warp chunks of 512 validators (k = 8; 256 blocks at
//           2^20);
// and probes that compute no total (timed, not checked):
//   form 6  form 3 without its grid sync and finish (the blocks' partial
//           words written);
//   form 7  form 6 with no arithmetic (the new effective balances are the
//           old, the words the balances' halves unswapped): the program's
//           loads and stores alone;
//   form 12 form 1 without its grid sync and finish;
//   form 13 form 12 with no arithmetic, as form 7;
//   form 14 form 4 with no arithmetic.
//
// total: total_words 64-bit words, [0] the total, then a partial word a
// block.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I ethereum_consensus_tpu_torch/csrc \
//        -o libstep_forms.so tools/step_forms.cu

#include <cooperative_groups.h>

#include "chain_step.cu"

namespace {

enum class Finish { kGridSync, kAtomic, kNone };

// A chunk's columns as loaded: four balances, four effective balances, the
// four flags (validator k's in byte k).
struct Chunk {
  uint64_t bal[kPerChunk];
  uint64_t eff[kPerChunk];
  uint32_t act;
};

template <bool kStreaming, class T>
__device__ __forceinline__ T load(const T* p) {
  if constexpr (kStreaming) {
    return __ldcs(p);
  } else {
    return *p;
  }
}

// Chunk `chunk`: two 16-byte loads of each word column and one 4-byte load
// of the flags (the columns are aligned for them here), streaming or plain.
template <bool kStreaming = true>
__device__ __forceinline__ Chunk load_chunk(const chain_step_core::ChainColumns& c, int64_t chunk) {
  const int64_t i = chunk * kPerChunk;
  const auto* b = reinterpret_cast<const ulonglong2*>(c.balances + i);
  const auto* e = reinterpret_cast<const ulonglong2*>(c.effective + i);
  const ulonglong2 b0 = load<kStreaming>(b), b1 = load<kStreaming>(b + 1);
  const ulonglong2 e0 = load<kStreaming>(e), e1 = load<kStreaming>(e + 1);
  Chunk d;
  d.act = load<kStreaming>(reinterpret_cast<const unsigned*>(c.active + i));
  const uint64_t bal[kPerChunk] = {b0.x, b0.y, b1.x, b1.y};
  const uint64_t eff[kPerChunk] = {e0.x, e0.y, e1.x, e1.y};
#pragma unroll
  for (int k = 0; k < kPerChunk; ++k) {
    d.bal[k] = bal[k];
    d.eff[k] = eff[k];
  }
  return d;
}

// Chunk `chunk` through the program's lane (kLane) or no arithmetic: two
// 16-byte stores of its new effective balances, its eight words; returns
// its share of the total.
template <bool kLane = true>
__device__ __forceinline__ uint64_t run_chunk(const chain_step_core::Hysteresis& h,
                                              const chain_step_core::ChainColumns& c,
                                              int64_t chunk, const Chunk& d) {
  const int64_t i = chunk * kPerChunk;
  uint64_t out[kPerChunk];
  uint64_t sum = 0;
#pragma unroll
  for (int k = 0; k < kPerChunk; ++k) {
    uint32_t lo, hi;
    if (kLane) {
      sum += chain_step_core::validator_lane(h, d.bal[k], d.eff[k], (d.act >> (8 * k)) & 0xffu,
                                             &out[k], &lo, &hi);
    } else {
      out[k] = d.eff[k] ^ (k == 0 ? d.act : 0);
      lo = static_cast<uint32_t>(d.bal[k]);
      hi = static_cast<uint32_t>(d.bal[k] >> 32);
    }
    chain_step_core::store_words(c, i + k, lo, hi);
  }
  auto* o = reinterpret_cast<ulonglong2*>(c.new_effective + i);
  o[0] = make_ulonglong2(out[0], out[1]);
  o[1] = make_ulonglong2(out[2], out[3]);
  return sum;
}

// The block's total from each thread's acc, then the finish: the grid sync
// (partial words, a grid sync, block 0 adds them), one atomicAdd a block
// into the zeroed total (the program's), or the partial words alone.
template <Finish kFinish>
__device__ __forceinline__ void finish_total(uint64_t acc0, unsigned long long* total) {
  __shared__ uint64_t warp_sums[1][masked_sums::kWarps];
  uint64_t acc[1] = {acc0};
  masked_sums::block_sum<1>(acc, warp_sums);
  if (kFinish == Finish::kAtomic) {
    if (threadIdx.x == 0 && acc[0] != 0) atomicAdd(total, static_cast<unsigned long long>(acc[0]));
    return;
  }
  uint64_t* partials = reinterpret_cast<uint64_t*>(total) + 1;
  if (threadIdx.x == 0) partials[blockIdx.x] = acc[0];
  if (kFinish == Finish::kNone) return;
  cooperative_groups::this_grid().sync();
  if (blockIdx.x == 0) masked_sums::finish<1>(partials, warp_sums, total);
}

// Chunks `s`, `s + stride`, ... (kStep of them, those before `last`): every
// load, then the lane.
template <int kStep, bool kStreaming, bool kLane>
__device__ __forceinline__ uint64_t step_chunks(const chain_step_core::Hysteresis& h,
                                                const chain_step_core::ChainColumns& c,
                                                int64_t s, int64_t stride, int64_t last) {
  Chunk d[kStep];
#pragma unroll
  for (int k = 0; k < kStep; ++k) {
    if (s + k * stride < last) d[k] = load_chunk<kStreaming>(c, s + k * stride);
  }
  uint64_t acc = 0;
#pragma unroll
  for (int k = 0; k < kStep; ++k) {
    if (s + k * stride < last) acc += run_chunk<kLane>(h, c, s + k * stride, d[k]);
  }
  return acc;
}

// Forms 1, 2, 4, 10 to 14, 18 and 19: a block's range of chunks, kStep
// chunks a thread a step.
template <int kStep, Finish kFinish, bool kLane = true, bool kStreaming = true,
          int kMin = kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMin)
    range_form_kernel(chain_step_core::Hysteresis h, chain_step_core::ChainColumns c,
                      unsigned long long* __restrict__ total) {
  uint64_t acc = 0;
  int64_t first, last;
  masked_sums::block_steps(c.n / kPerChunk, gridDim.x, blockIdx.x, &first, &last);
  for (int64_t s = first + threadIdx.x; s < last; s += kStep * kThreads) {
    acc += step_chunks<kStep, kStreaming, kLane>(h, c, s, kThreads, last);
  }
  finish_total<kFinish>(acc, total);
}

// Forms 5 and 20 to 22: thread g of the grid's G takes chunks g, g + G, ...
template <int kStep, Finish kFinish>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    stride_form_kernel(chain_step_core::Hysteresis h, chain_step_core::ChainColumns c,
                       unsigned long long* __restrict__ total) {
  uint64_t acc = 0;
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t s = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       s < c.n / kPerChunk; s += kStep * threads) {
    acc += step_chunks<kStep, true, true>(h, c, s, threads, c.n / kPerChunk);
  }
  finish_total<kFinish>(acc, total);
}

// Forms 15 and 16: a block's range, each thread's next chunk loaded before
// the current chunk's arithmetic.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    prefetch_form_kernel(chain_step_core::Hysteresis h, chain_step_core::ChainColumns c,
                         unsigned long long* __restrict__ total) {
  uint64_t acc = 0;
  int64_t first, last;
  masked_sums::block_steps(c.n / kPerChunk, gridDim.x, blockIdx.x, &first, &last);
  int64_t s = first + threadIdx.x;
  Chunk next;
  if (s < last) next = load_chunk(c, s);
  for (; s < last; s += kThreads) {
    const Chunk d = next;
    if (s + kThreads < last) next = load_chunk(c, s + kThreads);
    acc += run_chunk(h, c, s, d);
  }
  finish_total<Finish::kGridSync>(acc, total);
}

// Form 17: a block's next kThreads chunks of its range staged in shared
// memory.
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    tile_form_kernel(chain_step_core::Hysteresis h, chain_step_core::ChainColumns c,
                     unsigned long long* __restrict__ total) {
  __shared__ ulonglong2 bal_tile[2 * kThreads], eff_tile[2 * kThreads], out_tile[2 * kThreads];
  __shared__ unsigned act_tile[kThreads];
  uint64_t acc = 0;
  int64_t first, last;
  masked_sums::block_steps(c.n / kPerChunk, gridDim.x, blockIdx.x, &first, &last);
  for (int64_t base = first; base < last; base += kThreads) {
    const int count = static_cast<int>(last - base < kThreads ? last - base : kThreads);
    const auto* b = reinterpret_cast<const ulonglong2*>(c.balances + base * kPerChunk);
    const auto* e = reinterpret_cast<const ulonglong2*>(c.effective + base * kPerChunk);
    for (int j = threadIdx.x; j < 2 * count; j += kThreads) {
      bal_tile[j] = __ldcs(b + j);
      eff_tile[j] = __ldcs(e + j);
    }
    if (static_cast<int>(threadIdx.x) < count) {
      act_tile[threadIdx.x] =
          __ldcs(reinterpret_cast<const unsigned*>(c.active + base * kPerChunk) + threadIdx.x);
    }
    __syncthreads();
    if (static_cast<int>(threadIdx.x) < count) {
      const int t = threadIdx.x;
      const int64_t i = (base + t) * kPerChunk;
      const ulonglong2 b0 = bal_tile[2 * t], b1 = bal_tile[2 * t + 1];
      const ulonglong2 e0 = eff_tile[2 * t], e1 = eff_tile[2 * t + 1];
      const uint64_t bal[kPerChunk] = {b0.x, b0.y, b1.x, b1.y};
      const uint64_t eff[kPerChunk] = {e0.x, e0.y, e1.x, e1.y};
      uint64_t out[kPerChunk];
#pragma unroll
      for (int k = 0; k < kPerChunk; ++k) {
        uint32_t lo, hi;
        acc += chain_step_core::validator_lane(h, bal[k], eff[k], (act_tile[t] >> (8 * k)) & 0xffu,
                                               &out[k], &lo, &hi);
        chain_step_core::store_words(c, i + k, lo, hi);
      }
      out_tile[2 * t] = make_ulonglong2(out[0], out[1]);
      out_tile[2 * t + 1] = make_ulonglong2(out[2], out[3]);
    }
    __syncthreads();
    auto* o = reinterpret_cast<ulonglong2*>(c.new_effective + base * kPerChunk);
    for (int j = threadIdx.x; j < 2 * count; j += kThreads) o[j] = out_tile[j];
  }
  finish_total<Finish::kGridSync>(acc, total);
}

// Forms 3 and 6 to 9: the program's kernel with kSteps steps a warp chunk
// (64 kSteps validators), the lane or none (kLane), and the finish.
template <int kSteps, bool kLane, Finish kFinish>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    warp_form_kernel(chain_step_core::Hysteresis h, chain_step_core::ChainColumns c,
                     unsigned long long* __restrict__ total) {
  const int lane = threadIdx.x & 31;
  const int64_t warps = static_cast<int64_t>(gridDim.x) * masked_sums::kWarps;
  const int64_t chunks = c.chunks > 0 ? c.n / (64 * kSteps) : 0;
  uint64_t acc = 0;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * masked_sums::kWarps + (threadIdx.x >> 5);
       k < chunks; k += warps) {
    ulonglong2 bal[kSteps], eff[kSteps];
    unsigned act[kSteps];
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t i = k * 64 * kSteps + 64 * j + 2 * lane;
      bal[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.balances + i));
      eff[j] = __ldcs(reinterpret_cast<const ulonglong2*>(c.effective + i));
      act[j] = __ldcs(reinterpret_cast<const unsigned short*>(c.active + i));
    }
#pragma unroll
    for (int j = 0; j < kSteps; ++j) {
      const int64_t i = k * 64 * kSteps + 64 * j + 2 * lane;
      uint64_t out0, out1;
      uint32_t lo0, hi0, lo1, hi1;
      if (kLane) {
        acc += chain_step_core::validator_lane(h, bal[j].x, eff[j].x, act[j] & 0xffu, &out0,
                                               &lo0, &hi0);
        acc += chain_step_core::validator_lane(h, bal[j].y, eff[j].y, act[j] >> 8, &out1, &lo1,
                                               &hi1);
      } else {
        out0 = eff[j].x ^ act[j];
        out1 = eff[j].y;
        lo0 = static_cast<uint32_t>(bal[j].x), hi0 = static_cast<uint32_t>(bal[j].x >> 32);
        lo1 = static_cast<uint32_t>(bal[j].y), hi1 = static_cast<uint32_t>(bal[j].y >> 32);
      }
      *reinterpret_cast<ulonglong2*>(c.new_effective + i) = make_ulonglong2(out0, out1);
      chain_step_core::store_words(c, i, lo0, hi0);
      chain_step_core::store_words(c, i + 1, lo1, hi1);
    }
  }
  const int64_t threads = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = chunks * 64 * kSteps + static_cast<int64_t>(blockIdx.x) * kThreads +
                   threadIdx.x;
       i < c.n; i += threads) {
    uint32_t lo, hi;
    acc += chain_step_core::validator_lane(h, c.balances[i], c.effective[i], c.active[i] != 0,
                                           &c.new_effective[i], &lo, &hi);
    chain_step_core::store_words(c, i, lo, hi);
  }
  finish_total<kFinish>(acc, total);
}

using Kernel = void (*)(chain_step_core::Hysteresis, chain_step_core::ChainColumns,
                        unsigned long long*);

// A form's grid rule: a step of `steps` chunks a thread (at least an SM's
// worth where each block gets a warp's steps) up to the co-resident blocks;
// a block per kThreads chunks, uncapped; a warp chunk of 64 `steps`
// validators a warp up to the co-resident blocks; or `steps` blocks an SM.
enum class Grid { kThreadSteps, kTwoWaves, kWarpChunks, kPerSm };

int64_t form_grid(Grid rule, int64_t n, int steps, int64_t co_resident, int64_t sms) {
  const int64_t chunks = n / kPerChunk;
  int64_t grid = 1;
  switch (rule) {
    case Grid::kThreadSteps: {
      const int64_t items = (chunks + steps - 1) / steps;
      grid = (items + kThreads - 1) / kThreads;
      const int64_t least = (items + 31) / 32 < sms ? (items + 31) / 32 : sms;
      grid = grid > least ? grid : least;
      grid = grid < co_resident ? grid : co_resident;
      break;
    }
    case Grid::kTwoWaves:
      grid = (chunks + kThreads - 1) / kThreads;
      break;
    case Grid::kWarpChunks:
      grid = (n + int64_t{64} * steps * masked_sums::kWarps - 1) /
             (int64_t{64} * steps * masked_sums::kWarps);
      grid = grid < co_resident ? grid : co_resident;
      break;
    case Grid::kPerSm:
      grid = sms * steps;
      break;
  }
  return grid > 1 ? grid : 1;
}

// The blocks of form `form`'s kernel that fit on the current device at once
// and its SMs (cached a form and a device), false where the runtime cannot
// say.
bool fit(int form, Kernel kernel, int64_t* co_resident, int64_t* sms) {
  static int cached[32][64][2];
  int device = 0;
  if (cudaGetDevice(&device) != cudaSuccess || device < 0 || device >= 64) return false;
  int* row = cached[form][device];
  if (row[0] == 0) {
    int per_sm = 0, count = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) !=
            cudaSuccess ||
        cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device) != cudaSuccess ||
        per_sm * count <= 0) {
      return false;
    }
    row[1] = count;
    row[0] = per_sm * count;
  }
  *co_resident = row[0];
  *sms = row[1];
  return true;
}

int launch_form(int form, Kernel kernel, bool cooperative, Grid rule, int steps,
                const void* balances, const void* effective, const void* active, int64_t n,
                uint64_t increment, uint64_t max_effective, uint64_t down, uint64_t up,
                void* new_effective, void* words, void* total, int64_t total_words,
                cudaStream_t stream) {
  if (n < 0 || n % kPerChunk != 0 || increment == 0 || total_words < 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int64_t co_resident = 0, sms = 0;
  if (!fit(form, kernel, &co_resident, &sms)) {
    return static_cast<int>(cudaErrorInvalidConfiguration);
  }
  chain_step_core::ChainColumns c =
      chain_step_core::chain_columns(balances, effective, active, n, new_effective, words);
  if (c.chunks == 0 && rule != Grid::kWarpChunks) {
    return static_cast<int>(cudaErrorInvalidValue);  // the chunk forms need aligned columns
  }
  chain_step_core::Hysteresis h = chain_step_core::hysteresis(increment, max_effective, down, up);
  int64_t grid = form_grid(rule, n, steps, co_resident, sms);
  grid = grid < total_words - 1 ? grid : total_words - 1;
  unsigned long long* out = static_cast<unsigned long long*>(total);
  if (cooperative) {
    void* args[] = {&h, &c, &out};
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<void*>(kernel), dim3(static_cast<unsigned>(grid)), dim3(kThreads), args,
        0, stream));
  }
  const cudaError_t rc = cudaMemsetAsync(total, 0, sizeof(uint64_t), stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  kernel<<<static_cast<unsigned>(grid), kThreads, 0, stream>>>(h, c, out);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kSteps = altair_core::kChunkSteps;

}  // namespace

// Form `form` (1..22) on K1's arguments; returns the launch's error.
extern "C" int step_form_launch(int form, const void* balances, const void* effective,
                                const void* active, int64_t n, uint64_t increment,
                                uint64_t max_effective, uint64_t down, uint64_t up,
                                void* new_effective, void* words, void* total,
                                int64_t total_words, void* stream) {
  Kernel kernel = nullptr;
  bool cooperative = true;
  Grid rule = Grid::kThreadSteps;
  int steps = 2;
  switch (form) {
    case 1: kernel = range_form_kernel<2, Finish::kGridSync>; break;
    case 2: kernel = range_form_kernel<1, Finish::kGridSync>; steps = 1; break;
    case 3: kernel = warp_form_kernel<kSteps, true, Finish::kGridSync>;
            rule = Grid::kWarpChunks; steps = kSteps; break;
    case 4: kernel = range_form_kernel<1, Finish::kAtomic>; cooperative = false;
            rule = Grid::kTwoWaves; break;
    case 5: kernel = stride_form_kernel<1, Finish::kGridSync>; steps = 1; break;
    case 6: kernel = warp_form_kernel<kSteps, true, Finish::kNone>; rule = Grid::kWarpChunks;
            steps = kSteps; break;
    case 7: kernel = warp_form_kernel<kSteps, false, Finish::kNone>; rule = Grid::kWarpChunks;
            steps = kSteps; break;
    case 8: kernel = warp_form_kernel<2, true, Finish::kGridSync>; rule = Grid::kWarpChunks;
            steps = 2; break;
    case 9: kernel = warp_form_kernel<8, true, Finish::kGridSync>; rule = Grid::kWarpChunks;
            steps = 8; break;
    case 10: kernel = range_form_kernel<2, Finish::kAtomic>; cooperative = false; break;
    case 11: kernel = range_form_kernel<1, Finish::kAtomic>; cooperative = false; steps = 1;
             break;
    case 12: kernel = range_form_kernel<2, Finish::kNone>; break;
    case 13: kernel = range_form_kernel<2, Finish::kNone, false>; break;
    case 14: kernel = range_form_kernel<1, Finish::kAtomic, false>; cooperative = false;
             rule = Grid::kTwoWaves; break;
    case 15: kernel = prefetch_form_kernel; rule = Grid::kPerSm; steps = 1; break;
    case 16: kernel = prefetch_form_kernel; rule = Grid::kPerSm; steps = 2; break;
    case 17: kernel = tile_form_kernel; steps = 1; break;
    case 18: kernel = range_form_kernel<2, Finish::kGridSync, true, false>; break;
    case 19: kernel = range_form_kernel<2, Finish::kGridSync, true, true, 3>; break;
    case 20: kernel = stride_form_kernel<2, Finish::kGridSync>; break;
    case 21: kernel = stride_form_kernel<2, Finish::kAtomic>; cooperative = false; break;
    case 22: kernel = stride_form_kernel<1, Finish::kAtomic>; cooperative = false; steps = 1;
             break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return launch_form(form, kernel, cooperative, rule, steps, balances, effective, active, n,
                     increment, max_effective, down, up, new_effective, words, total,
                     total_words, static_cast<cudaStream_t>(stream));
}
