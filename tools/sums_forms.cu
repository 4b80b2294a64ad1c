// Measured alternatives of the masked-sum kernel (csrc/masked_sums.h), for
// tools/sums_forms.py: the same partition and lanes with other finishes and
// step widths. These are measurements, not part of the program.
//
//   form 0  the program's kernel (masked_sums::launch): 8 validators a step,
//           streaming loads, 256-thread blocks, a cooperative launch, block 0
//           adds the partials after a grid sync, four partial blocks a thread
//           at once;
//   form 1  the same at 16 validators a step (eight 16-byte loads of the
//           effective balances, one 16-byte load of each byte column);
//   form 2  a last-block ticket: the ticket word zeroed on the stream, then
//           one launch; the block that draws the last ticket adds the
//           partials;
//   form 3  the ticket without the zeroing: the last block sets the word
//           back to 0, so the word carries from one call to the next (state
//           the program must not hold; its first call needs a zeroed word);
//   form 4  the parent's finish: the K words zeroed on the stream, then one
//           64-bit atomicAdd a sum a block.
//   form 5  the warp layout: a lane's 8 validators a step in pairs 64 apart
//           (each of a warp's four 16-byte loads of the effective balances
//           contiguous, 2 bytes of each byte column a pair, as
//           epoch_pass.h reads), the kernel's finish;
//   form 8  the kernel with its loads on the read-only path (__ldg) in place
//           of streaming loads;
//   form 9  the kernel with a finish that loads one partial block a thread
//           at a time;
//   form 10 the kernel with the grid barrier split: the blocks other than 0
//           arrive and end, block 0 waits (cooperative_groups'
//           barrier_arrive and barrier_wait, where the toolkit has them;
//           sums_forms_split_barrier says whether it does);
//   form 13 the kernel on blocks of 512 threads (2 an SM at 64 registers);
//   form 14 the kernel on blocks of 1,024 threads (one an SM): a quarter of
//           the blocks arrive at the grid barrier and leave partial words;
// and probes that compute no sums (timed, not checked), each at the
// kernel's grid (form 15 at form 14's):
//   form 6  a cooperative launch of a kernel with nothing but a grid sync;
//   form 7  the kernel without its grid sync and finish (the blocks' partial
//           words written, a plain launch);
//   form 11 a plain launch of an empty kernel;
//   form 12 a cooperative launch of an empty kernel;
//   form 15 a cooperative launch of a kernel with nothing but a grid sync,
//           on blocks of 1,024 threads.
//
// words: word_count 64-bit words, [0..K) the sums, then (forms 2 and 3) the
// ticket, then K partial words a block.
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
//        -Xcompiler -fPIC -I ethereum_consensus_tpu_torch/csrc \
//        -o libsums_forms.so tools/sums_forms.cu

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>
#include <utility>

#include "masked_sums.h"

namespace {

namespace ms = masked_sums;

// The program's kernel with its choices open, for forms 1, 8, 9, 13 and 14:
// V validators a step; streaming loads or the read-only path (__ldg); the
// partial blocks a thread of the finish loads at once; the threads a block.
// At Form<8, true, 4, 256> it is masked_sums_kernel.
template <int V_, bool kStreaming_, int kRounds_, int kBlock_>
struct Form {
  static constexpr int V = V_;
  static constexpr bool kStreaming = kStreaming_;
  static constexpr int kRounds = kRounds_;
  static constexpr int kBlock = kBlock_;
  static constexpr int kWarps = kBlock / 32;
  static constexpr int kMinBlocks = ms::kThreadsPerSm / kBlock;
};

template <bool kStreaming, class T>
__device__ __forceinline__ T load_as(const T* p) {
  if constexpr (kStreaming) {
    return __ldcs(p);
  } else {
    return __ldg(p);
  }
}

// V bytes of a byte column, in one load.
template <int V>
struct Bytes;

template <>
struct Bytes<8> {
  uint64_t w;
  template <bool kStreaming>
  __device__ __forceinline__ static Bytes load(const uint8_t* p) {
    return {load_as<kStreaming>(reinterpret_cast<const unsigned long long*>(p))};
  }
  __device__ __forceinline__ uint8_t operator[](int v) const {
    return static_cast<uint8_t>(w >> (8 * v));
  }
};

template <>
struct Bytes<16> {
  ulonglong2 w;
  template <bool kStreaming>
  __device__ __forceinline__ static Bytes load(const uint8_t* p) {
    return {load_as<kStreaming>(reinterpret_cast<const ulonglong2*>(p))};
  }
  __device__ __forceinline__ uint8_t operator[](int v) const {
    return static_cast<uint8_t>((v < 8 ? w.x : w.y) >> (8 * (v & 7)));
  }
};

// The columns with the vector path at V validators a step.
template <int V>
ms::Columns form_columns(const void* eff, const void* part, const void* slashed,
                         const void* active_prev, const void* active_cur, int64_t n) {
  const auto aligned = [](const void* p, uintptr_t bytes) {
    return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
  };
  const bool vector = aligned(eff, 16) && aligned(part, V) && aligned(slashed, V) &&
                      aligned(active_prev, V) && aligned(active_cur, V);
  return {static_cast<const uint64_t*>(eff), static_cast<const uint8_t*>(part),
          static_cast<const uint8_t*>(slashed), static_cast<const uint8_t*>(active_prev),
          static_cast<const uint8_t*>(active_cur), n, vector ? n / V : 0};
}

template <int K, class F>
__device__ __forceinline__ void form_step(const ms::Columns& c, int64_t s, uint64_t* acc) {
  constexpr int V = F::V;
  const int64_t i = s * V;
  ulonglong2 eff[V / 2];
#pragma unroll
  for (int j = 0; j < V / 2; ++j) {
    eff[j] = load_as<F::kStreaming>(reinterpret_cast<const ulonglong2*>(c.eff + i) + j);
  }
  const auto part = Bytes<V>::template load<F::kStreaming>(c.part + i);
  const auto slashed = Bytes<V>::template load<F::kStreaming>(c.slashed + i);
  const auto active_prev = Bytes<V>::template load<F::kStreaming>(c.active_prev + i);
  Bytes<V> active_cur{};
  if constexpr (K == 4) active_cur = Bytes<V>::template load<F::kStreaming>(c.active_cur + i);
#pragma unroll
  for (int v = 0; v < V; ++v) {
    ms::lane<K>((v & 1) ? eff[v / 2].y : eff[v / 2].x, part[v], slashed[v], active_prev[v],
                K == 4 ? active_cur[v] : 0, acc);
  }
}

template <int K, class F>
__device__ __forceinline__ void form_thread_sums(const ms::Columns& c, uint64_t* acc) {
  int64_t first, last;
  ms::block_steps(c.steps, gridDim.x, blockIdx.x, &first, &last);
  for (int64_t s = first + threadIdx.x; s < last; s += F::kBlock) form_step<K, F>(c, s, acc);
  for (int64_t i = c.steps * F::V + blockIdx.x * F::kBlock + threadIdx.x; i < c.n;
       i += static_cast<int64_t>(gridDim.x) * F::kBlock) {
    ms::lane<K>(c.eff[i], c.part[i], c.slashed[i], c.active_prev[i],
                K == 4 ? c.active_cur[i] : 0, acc);
  }
}

template <int K, int kWarps>
__device__ __forceinline__ void form_block_sum(uint64_t* acc, uint64_t (*warp_sums)[kWarps]) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    acc[k] = ms::warp_sum(acc[k]);
    if ((threadIdx.x & 31) == 0) warp_sums[k][threadIdx.x >> 5] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < 32) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      acc[k] = ms::warp_sum(threadIdx.x < kWarps ? warp_sums[k][threadIdx.x] : 0);
    }
  }
}

template <int K, class F>
__device__ __forceinline__ void form_finish(const uint64_t* partials,
                                            uint64_t (*warp_sums)[F::kWarps],
                                            unsigned long long* words) {
  const auto* from = reinterpret_cast<const unsigned long long*>(partials);
  const int grid = static_cast<int>(gridDim.x);
  uint64_t total[K] = {};
#pragma unroll 1
  for (int first = threadIdx.x; first < grid; first += F::kRounds * F::kBlock) {
    uint64_t got[F::kRounds][K];
#pragma unroll
    for (int r = 0; r < F::kRounds; ++r) {
      const int b = first + r * F::kBlock;
#pragma unroll
      for (int k = 0; k < K; ++k) got[r][k] = b < grid ? __ldcg(from + k * grid + b) : 0;
    }
#pragma unroll
    for (int r = 0; r < F::kRounds; ++r) {
#pragma unroll
      for (int k = 0; k < K; ++k) total[k] += got[r][k];
    }
  }
  form_block_sum<K, F::kWarps>(total, warp_sums);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) words[k] = total[k];
  }
}

template <int K, class F>
__global__ void __launch_bounds__(F::kBlock, F::kMinBlocks)
    form_kernel(ms::Columns c, unsigned long long* __restrict__ words) {
  __shared__ uint64_t warp_sums[K][F::kWarps];
  uint64_t acc[K] = {};
  form_thread_sums<K, F>(c, acc);
  form_block_sum<K, F::kWarps>(acc, warp_sums);
  uint64_t* partials = reinterpret_cast<uint64_t*>(words) + K;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) partials[k * gridDim.x + blockIdx.x] = acc[k];
  }
  cooperative_groups::this_grid().sync();
  if (blockIdx.x == 0) form_finish<K, F>(partials, warp_sums, words);
}

template <int K, bool kReset>
__global__ void __launch_bounds__(ms::kThreads, ms::kThreadsPerSm / ms::kThreads)
    ticket_kernel(ms::Columns c, unsigned long long* __restrict__ words) {
  __shared__ uint64_t warp_sums[K][ms::kWarps];
  __shared__ bool last;
  uint64_t acc[K] = {};
  ms::thread_sums<K>(c, acc);
  ms::block_sum<K>(acc, warp_sums);
  uint64_t* partials = reinterpret_cast<uint64_t*>(words) + K + 1;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) partials[k * gridDim.x + blockIdx.x] = acc[k];
    __threadfence();
    last = atomicAdd(words + K, 1ull) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  ms::finish<K>(partials, warp_sums, words);
  if (kReset && threadIdx.x == 0) words[K] = 0;
}

// A warp's share in the warp layout: groups of 256 validators (32 steps of
// the kernel), the block's contiguous range of groups a warp at a time; in
// group g lane t takes validators 256 g + 64 j + 2 t and + 1, j = 0..3.
template <int K>
__device__ __forceinline__ void warp_layout_sums(const ms::Columns& c, uint64_t* acc) {
  const int64_t groups = c.steps / 32;
  int64_t first, last;
  ms::block_steps(groups, gridDim.x, blockIdx.x, &first, &last);
  const int lane = threadIdx.x & 31;
  for (int64_t g = first + (threadIdx.x >> 5); g < last; g += ms::kWarps) {
    ulonglong2 eff[4];
    unsigned part[4], slashed[4], active_prev[4], active_cur[4] = {};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int64_t i = 256 * g + 64 * j + 2 * lane;
      eff[j] = __ldg(reinterpret_cast<const ulonglong2*>(c.eff + i));
      part[j] = __ldg(reinterpret_cast<const unsigned short*>(c.part + i));
      slashed[j] = __ldg(reinterpret_cast<const unsigned short*>(c.slashed + i));
      active_prev[j] = __ldg(reinterpret_cast<const unsigned short*>(c.active_prev + i));
      if (K == 4) active_cur[j] = __ldg(reinterpret_cast<const unsigned short*>(c.active_cur + i));
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ms::lane<K>(h ? eff[j].y : eff[j].x, static_cast<uint8_t>(part[j] >> (8 * h)),
                    static_cast<uint8_t>(slashed[j] >> (8 * h)),
                    static_cast<uint8_t>(active_prev[j] >> (8 * h)),
                    static_cast<uint8_t>(active_cur[j] >> (8 * h)), acc);
      }
    }
  }
  for (int64_t i = groups * 256 + blockIdx.x * ms::kThreads + threadIdx.x; i < c.n;
       i += static_cast<int64_t>(gridDim.x) * ms::kThreads) {
    ms::lane<K>(c.eff[i], c.part[i], c.slashed[i], c.active_prev[i],
                K == 4 ? c.active_cur[i] : 0, acc);
  }
}

template <int K>
__global__ void __launch_bounds__(ms::kThreads, ms::kThreadsPerSm / ms::kThreads)
    warp_layout_kernel(ms::Columns c, unsigned long long* __restrict__ words) {
  __shared__ uint64_t warp_sums[K][ms::kWarps];
  uint64_t acc[K] = {};
  warp_layout_sums<K>(c, acc);
  ms::block_sum<K>(acc, warp_sums);
  uint64_t* partials = reinterpret_cast<uint64_t*>(words) + K;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) partials[k * gridDim.x + blockIdx.x] = acc[k];
  }
  cooperative_groups::this_grid().sync();
  if (blockIdx.x == 0) ms::finish<K>(partials, warp_sums, words);
}

// Whether cooperative_groups splits the grid barrier (barrier_arrive,
// barrier_wait) in this toolkit.
template <class G, class = void>
struct HasSplit : std::false_type {};
template <class G>
struct HasSplit<G, std::void_t<decltype(std::declval<G&>().barrier_arrive())>>
    : std::true_type {};

// The grid barrier with only block 0 waiting where the split exists (the
// other blocks arrive and end), the whole barrier otherwise.
template <class G>
__device__ __forceinline__ void arrive_or_sync(G& grid) {
  if constexpr (HasSplit<G>::value) {
    auto token = grid.barrier_arrive();
    if (blockIdx.x == 0) grid.barrier_wait(std::move(token));
  } else {
    grid.sync();
  }
}

template <int K>
__global__ void __launch_bounds__(ms::kThreads, ms::kThreadsPerSm / ms::kThreads)
    split_barrier_kernel(ms::Columns c, unsigned long long* __restrict__ words) {
  __shared__ uint64_t warp_sums[K][ms::kWarps];
  uint64_t acc[K] = {};
  ms::thread_sums<K>(c, acc);
  ms::block_sum<K>(acc, warp_sums);
  uint64_t* partials = reinterpret_cast<uint64_t*>(words) + K;
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) partials[k * gridDim.x + blockIdx.x] = acc[k];
  }
  auto grid = cooperative_groups::this_grid();
  arrive_or_sync(grid);
  if (blockIdx.x == 0) ms::finish<K>(partials, warp_sums, words);
}

__global__ void __launch_bounds__(ms::kThreads, ms::kThreadsPerSm / ms::kThreads) empty_kernel() {}

template <int kBlock>
__global__ void __launch_bounds__(kBlock, ms::kThreadsPerSm / kBlock) sync_only_kernel() {
  cooperative_groups::this_grid().sync();
}

template <int K>
__global__ void __launch_bounds__(ms::kThreads, ms::kThreadsPerSm / ms::kThreads)
    no_finish_kernel(ms::Columns c, unsigned long long* __restrict__ words) {
  __shared__ uint64_t warp_sums[K][ms::kWarps];
  uint64_t acc[K] = {};
  ms::thread_sums<K>(c, acc);
  ms::block_sum<K>(acc, warp_sums);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) words[K + k * gridDim.x + blockIdx.x] = acc[k];
  }
}

template <int K>
__global__ void __launch_bounds__(ms::kThreads, ms::kThreadsPerSm / ms::kThreads)
    atomic_kernel(ms::Columns c, unsigned long long* __restrict__ words) {
  __shared__ uint64_t warp_sums[K][ms::kWarps];
  uint64_t acc[K] = {};
  ms::thread_sums<K>(c, acc);
  ms::block_sum<K>(acc, warp_sums);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      if (acc[k] != 0) atomicAdd(words + k, static_cast<unsigned long long>(acc[k]));
    }
  }
}

// The kernel's blocks of `threads` that fit on the device at once.
template <class Kernel>
int64_t fit(Kernel kernel, int threads = ms::kThreads) {
  int per_sm = 0, sms = 0, device = 0;
  cudaGetDevice(&device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  return static_cast<int64_t>(per_sm) * sms;
}

int64_t sms() {
  int count = 0, device = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&count, cudaDevAttrMultiProcessorCount, device);
  return count;
}

// form_kernel<K, F> as masked_sums::launch launches the program's kernel.
template <int K, class F>
int form_launch(const void* eff, const void* part, const void* slashed, const void* active_prev,
                const void* active_cur, int64_t n, void* words, int64_t word_count,
                cudaStream_t s) {
  ms::Columns c = form_columns<F::V>(eff, part, slashed, active_prev, active_cur, n);
  const int64_t grid =
      ms::grid_for(c, F::kBlock, fit(form_kernel<K, F>, F::kBlock), sms(), (word_count - K) / K);
  unsigned long long* out = static_cast<unsigned long long*>(words);
  void* args[] = {&c, &out};
  return static_cast<int>(cudaLaunchCooperativeKernel(
      reinterpret_cast<void*>(form_kernel<K, F>), dim3(static_cast<unsigned>(grid)),
      dim3(F::kBlock), args, 0, s));
}

template <int K>
int launch_form(int form, const void* eff, const void* part, const void* slashed,
                const void* active_prev, const void* active_cur, int64_t n, void* words,
                int64_t word_count, cudaStream_t s) {
  constexpr int V = ms::kStep;
  if (form == 0) {
    return ms::launch<K>(eff, part, slashed, active_prev, active_cur, n, words, word_count, s);
  }
  if (form == 1) {
    return form_launch<K, Form<16, true, 4, 256>>(eff, part, slashed, active_prev, active_cur,
                                                  n, words, word_count, s);
  }
  const ms::Columns c = ms::make_columns(eff, part, slashed, active_prev, active_cur, n);
  unsigned long long* out = static_cast<unsigned long long*>(words);
  if (form == 2 || form == 3) {
    const auto kernel = form == 2 ? ticket_kernel<K, false> : ticket_kernel<K, true>;
    const int64_t grid = ms::grid_for(c, ms::kThreads, fit(kernel), sms(),
                                      (word_count - K - 1) / K);
    if (form == 2) {
      cudaError_t rc = cudaMemsetAsync(out + K, 0, sizeof(uint64_t), s);
      if (rc != cudaSuccess) return static_cast<int>(rc);
    }
    kernel<<<static_cast<unsigned>(grid), ms::kThreads, 0, s>>>(c, out);
    return static_cast<int>(cudaGetLastError());
  }
  if (form == 4) {
    const int64_t grid = ms::grid_for(c, ms::kThreads, fit(atomic_kernel<K>), sms(), 1 << 30);
    cudaError_t rc = cudaMemsetAsync(out, 0, K * sizeof(uint64_t), s);
    if (rc != cudaSuccess) return static_cast<int>(rc);
    atomic_kernel<K><<<static_cast<unsigned>(grid), ms::kThreads, 0, s>>>(c, out);
    return static_cast<int>(cudaGetLastError());
  }
  if ((form >= 5 && form <= 7) || (form >= 10 && form <= 12)) {
    int64_t co_resident = 0, count = 0;
    if (!ms::device_fit<K>(&co_resident, &count)) {
      return static_cast<int>(cudaErrorInvalidConfiguration);
    }
    // the kernel's grid, its steps as the program's (the warp layout's
    // alignment, 16 and 2 bytes, holds wherever the kernel's does)
    ms::Columns cols = c;
    const int64_t grid =
        ms::grid_for(cols, ms::kThreads, co_resident, count, (word_count - K) / K);
    if (form == 7 || form == 11) {
      if (form == 7) {
        no_finish_kernel<K><<<static_cast<unsigned>(grid), ms::kThreads, 0, s>>>(c, out);
      } else {
        empty_kernel<<<static_cast<unsigned>(grid), ms::kThreads, 0, s>>>();
      }
      return static_cast<int>(cudaGetLastError());
    }
    void* args[] = {&cols, &out};
    const bool sums = form == 5 || form == 10;
    const void* kernel =
        form == 5    ? reinterpret_cast<const void*>(warp_layout_kernel<K>)
        : form == 10 ? reinterpret_cast<const void*>(split_barrier_kernel<K>)
        : form == 6  ? reinterpret_cast<const void*>(sync_only_kernel<ms::kThreads>)
                     : reinterpret_cast<const void*>(empty_kernel);
    return static_cast<int>(cudaLaunchCooperativeKernel(
        kernel, dim3(static_cast<unsigned>(grid)), dim3(ms::kThreads), sums ? args : nullptr, 0,
        s));
  }
  if (form == 8) {
    return form_launch<K, Form<V, false, 4, 256>>(eff, part, slashed, active_prev, active_cur,
                                                  n, words, word_count, s);
  }
  if (form == 9) {
    return form_launch<K, Form<V, true, 1, 256>>(eff, part, slashed, active_prev, active_cur,
                                                  n, words, word_count, s);
  }
  if (form == 13) {
    return form_launch<K, Form<V, true, 4, 512>>(eff, part, slashed, active_prev, active_cur,
                                                  n, words, word_count, s);
  }
  if (form == 14) {
    return form_launch<K, Form<V, true, 4, 1024>>(eff, part, slashed, active_prev, active_cur,
                                                  n, words, word_count, s);
  }
  if (form == 15) {
    // the sync-only probe at the grid of 1,024-thread blocks
    const ms::Columns cols = ms::make_columns(eff, part, slashed, active_prev, active_cur, n);
    const int64_t grid = ms::grid_for(cols, 1024, fit(sync_only_kernel<1024>, 1024), sms(),
                                      (word_count - K) / K);
    return static_cast<int>(cudaLaunchCooperativeKernel(
        reinterpret_cast<const void*>(sync_only_kernel<1024>), dim3(static_cast<unsigned>(grid)),
        dim3(1024), nullptr, 0, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// 1 where form 10 splits the grid barrier, 0 where it falls back to the
// whole barrier.
extern "C" int sums_forms_split_barrier() {
  return HasSplit<cooperative_groups::grid_group>::value ? 1 : 0;
}

// Form `form` of the K = k sums (3: the flag sums, active_cur ignored; 4:
// the epoch step's) of the (n,) columns. Returns the launch's error.
extern "C" int sums_form_launch(int form, int k, const void* eff, const void* part,
                                const void* slashed, const void* active_prev,
                                const void* active_cur, int64_t n, void* words,
                                int64_t word_count, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n < 0 || word_count < 2 * k + 1) return static_cast<int>(cudaErrorInvalidValue);
  if (k == 3) {
    return launch_form<3>(form, eff, part, slashed, active_prev, nullptr, n, words, word_count,
                          s);
  }
  if (k == 4) {
    return launch_form<4>(form, eff, part, slashed, active_prev, active_cur, n, words,
                          word_count, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
