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
// 256), 16-byte aligned rows). Output (count,) int64.
//
// What bounds it on an H100: each index does one byte lookup a round in
// that round's row (128 KB at 2^20 indices), at a place that depends on the
// index, so after the first round a warp's lookups scatter. Read from L2,
// every lookup is its own 32-byte sector: 2^20 x 90 x 32 B = 3.0 GB of L2
// traffic, which bounds a one-thread-an-index kernel at L2's rate (about
// 0.5 ms); the index arithmetic is 12 operations a round (0.034 ms at
// 2^20 x 90 on the integer pipes).
//
// Design: the rows go through shared memory, not the lookups through L2.
// A persistent grid, one CTA an SM: 16 warps hold the indices in registers
// (up to 32 a thread), and one more warp loads. A round reads only half its
// row (shuffle_core.h: the two position ranges its pivot allows, 64 KB at
// 2^20; rows below 16 KB go whole, a stage's rows in one copy); the loading
// warp copies them with TMA bulk copies (cp.async.bulk, completion on an
// mbarrier) into a ring of three stage buffers of about 66 KB, each as many
// rounds as it holds (2^15: 16 rounds a stage; 2^20: one), and every
// lookup reads the CTA's own shared memory.
// The index warps wait on a buffer's "full" barrier and release it on its
// "empty" one; the loader refills a buffer once all 16 warps have released
// it, so two loads are in flight while one buffer is read, and no barrier
// spans the CTA. A span larger than a buffer is looked up a window at a
// time.

#include <cuda_runtime.h>
#include <stdint.h>

#include "shuffle_core.h"

namespace {

constexpr int kIndexWarps = 16;
constexpr int kThreads = 32 * kIndexWarps;   // threads that hold indices
constexpr int kBlockThreads = kThreads + 32;  // and the loading warp
constexpr int64_t kBudget = 200 * 1024;       // a CTA's stage buffers
constexpr int kBuffers = 3;                   // the ring: two load while one is read
constexpr int kMaxPer = 32;                   // indices a thread
constexpr int kWidePer = 16;                  // indices a thread at 64-bit indices
constexpr int kPivotCache = 256;              // rounds whose pivots a CTA keeps in shared memory

using shuffle_core::Plan;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_wait(const uint64_t* bar, int64_t use) {
  const uint32_t parity = static_cast<uint32_t>(use & 1);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  }
}

__device__ __forceinline__ int64_t pivot_at(const int64_t* pivots, const int64_t* cache, int r) {
  return r < kPivotCache ? cache[r] : __ldg(pivots + r);
}

// A bulk copy of `len` bytes from global `src` to shared `dst`, completing
// on the barrier `bar`
__device__ __forceinline__ void bulk_copy(uint32_t dst, const uint8_t* src, uint32_t len,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(dst), "l"(src), "r"(len), "r"(bar)
      : "memory");
}

// The loading warp's lane 0: every stage of every batch into the ring,
// once the index warps have released the stage that held the buffer; the
// copies of a stage that continue each other (whole rows) go as one
__device__ void load_stages(const Plan& p, const int64_t* pivots, const int64_t* cache,
                            const uint8_t* sources, uint8_t* buf, uint64_t* full,
                            uint64_t* empty, int64_t total) {
  const int64_t chunks = static_cast<int64_t>(p.rounds) * p.parts;
  const int64_t buffer = p.per_stage * p.window;
#pragma unroll 1
  for (int64_t v = 0; v < total; ++v) {
    const int b = static_cast<int>(v % kBuffers);
    if (v >= kBuffers) mbar_wait(empty + b, v / kBuffers - 1);
    const int64_t c0 = (v % p.stages) * p.per_stage;
    const int in_stage = static_cast<int>(chunks - c0 < p.per_stage ? chunks - c0 : p.per_stage);
    const uint32_t bar = smem_addr(full + b);
    if (!shuffle_core::half_rows(p.row_bytes)) {  // whole rows: the stage's rows in one copy
      const uint32_t bytes = static_cast<uint32_t>(in_stage * p.row_bytes);
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar), "r"(bytes)
                   : "memory");
      bulk_copy(smem_addr(buf + b * buffer), sources + c0 * p.row_bytes, bytes, bar);
      continue;
    }
    for (int pass = 0; pass < 2; ++pass) {  // count the bytes, then copy them
      int64_t bytes = 0, from = 0, to = 0, run = 0;  // the copy being gathered
      int r = static_cast<int>(c0 / p.parts), part = static_cast<int>(c0 % p.parts);
      for (int ci = 0; ci < in_stage; ++ci) {
        const shuffle_core::Span<int64_t> span =
            shuffle_core::span_of<int64_t>(pivot_at(pivots, cache, r), p.count, p.row_bytes);
        for (int i = 0; i < 2; ++i) {
          int64_t src, dst, len;
          shuffle_core::chunk_copy(p, span, r, part, i, src, dst, len);
          if (len == 0) continue;
          bytes += len;
          dst += b * buffer + ci * p.window;
          if (run > 0 && src == from + run && dst == to + run) {
            run += len;
            continue;
          }
          if (pass == 1 && run > 0) {
            bulk_copy(smem_addr(buf + to), sources + from, static_cast<uint32_t>(run), bar);
          }
          from = src;
          to = dst;
          run = len;
        }
        if (++part == p.parts) {
          part = 0;
          ++r;
        }
      }
      if (pass == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
                     "r"(static_cast<uint32_t>(bytes))
                     : "memory");
      } else if (run > 0) {
        bulk_copy(smem_addr(buf + to), sources + from, static_cast<uint32_t>(run), bar);
      }
    }
  }
}

// CTA b's index thread t holds indices base + (b PER + j) kThreads + t,
// j < PER, of each batch; Idx holds 2 count. HALF: the rows go as half
// rows (shuffle_core.h half_rows); else a position's byte is its offset.
template <typename Idx, int PER, bool HALF>
__global__ void __launch_bounds__(kBlockThreads, 1)
    shuffle_kernel(const int64_t* __restrict__ pivots, const uint8_t* __restrict__ sources,
                   const Plan p, int64_t* __restrict__ out) {
  extern __shared__ __align__(128) uint8_t buf[];
  __shared__ __align__(8) uint64_t full[kBuffers];
  __shared__ __align__(8) uint64_t empty[kBuffers];
  __shared__ int64_t pivot_cache[kPivotCache];
  const int tid = threadIdx.x;
  const int64_t batch_indices = static_cast<int64_t>(gridDim.x) * kThreads * PER;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * PER * kThreads + tid;
  if (p.stages == 0) {  // no rounds: the identity
    for (int64_t base = 0; tid < kThreads && base < p.count; base += batch_indices) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int64_t i = base + first + j * kThreads;
        if (i < p.count) out[i] = i;
      }
    }
    return;
  }
  const int64_t total = shuffle_core::ceil_div(p.count, batch_indices) * p.stages;
  for (int r = tid; r < p.rounds && r < kPivotCache; r += kBlockThreads) {
    pivot_cache[r] = pivots[r];
  }
  if (tid == 0) {
    for (int b = 0; b < kBuffers; ++b) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(full + b)) : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(empty + b)),
                   "r"(kIndexWarps)
                   : "memory");
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (tid >= kThreads) {  // the loading warp
    if (tid == kThreads) load_stages(p, pivots, pivot_cache, sources, buf, full, empty, total);
    return;
  }
  const Idx count = static_cast<Idx>(p.count);
  const Idx window = static_cast<Idx>(p.window);
  const Idx row_bytes = static_cast<Idx>(p.row_bytes);
  const int64_t chunks = static_cast<int64_t>(p.rounds) * p.parts;
  const int64_t buffer = p.per_stage * p.window;
  Idx v[PER];
  int64_t s = 0, base = 0;  // the stage within the batch, the batch's first index
  int r = 0, part = 0;      // the next chunk's round and window
#pragma unroll 1
  for (int64_t vs = 0; vs < total; ++vs) {
    const int b = static_cast<int>(vs % kBuffers);
    if (s == 0) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int64_t i = base + first + j * kThreads;
        v[j] = i < p.count ? static_cast<Idx>(i) : Idx{0};
      }
    }
    mbar_wait(full + b, vs / kBuffers);
    const int64_t c0 = s * p.per_stage;
    const int in_stage = static_cast<int>(chunks - c0 < p.per_stage ? chunks - c0 : p.per_stage);
#pragma unroll 4
    for (int ci = 0; ci < in_stage; ++ci) {
      const Idx pivot = static_cast<Idx>(pivot_at(pivots, pivot_cache, r));
      const shuffle_core::Span<Idx> span = shuffle_core::span_of<Idx>(pivot, count, row_bytes);
      const Idx start = static_cast<Idx>(part) * window;
      const uint8_t* chunk = buf + b * buffer + ci * p.window;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const Idx flip = shuffle_core::flip_of<Idx>(v[j], pivot, count);
        const Idx pos = v[j] > flip ? v[j] : flip;
        if (HALF) {
          // below the window's start the difference wraps past the window
          const Idx rel =
              shuffle_core::span_offset<Idx>(pos, pivot, span.a_lo, span.a_len, span.b_lo) - start;
          if (rel < window && ((chunk[rel] >> static_cast<uint32_t>(pos & 7)) & 1)) v[j] = flip;
        } else if ((chunk[pos >> 3] >> static_cast<uint32_t>(pos & 7)) & 1) {
          v[j] = flip;
        }
      }
      if (++part == p.parts) {
        part = 0;
        ++r;
      }
    }
    __syncwarp();
    if ((tid & 31) == 0) {
      asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_addr(empty + b))
                   : "memory");
    }
    if (++s == p.stages) {
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const int64_t i = base + first + j * kThreads;
        if (i < p.count) out[i] = static_cast<int64_t>(v[j]);
      }
      s = 0;
      r = 0;
      base += batch_indices;
    }
  }
}

using Kernel = void (*)(const int64_t*, const uint8_t*, Plan, int64_t*);

template <bool HALF>
Kernel kernel_for(bool wide, int per) {
  if (wide) return shuffle_kernel<uint64_t, kWidePer, HALF>;
  switch (per) {
    case 1: return shuffle_kernel<uint32_t, 1, HALF>;
    case 2: return shuffle_kernel<uint32_t, 2, HALF>;
    case 4: return shuffle_kernel<uint32_t, 4, HALF>;
    case 8: return shuffle_kernel<uint32_t, 8, HALF>;
    case 16: return shuffle_kernel<uint32_t, 16, HALF>;
    default: return shuffle_kernel<uint32_t, kMaxPer, HALF>;
  }
}

Kernel kernel_for(bool half, bool wide, int per) {
  return half ? kernel_for<true>(wide, per) : kernel_for<false>(wide, per);
}

// CTAs resident at once on the current device (one an SM: the stage
// budget), asked once a device; every kernel may take the budget as
// dynamic shared memory, set once
int resident_blocks(int* blocks) {
  constexpr int kDevices = 16;
  static int cache[kDevices];  // 0: not asked yet
  static bool allowed = false;
  if (!allowed) {
    for (int half = 0; half < 2; ++half) {
      for (int wide = 0; wide < 2; ++wide) {
        for (int per = 1; per <= kMaxPer; per *= 2) {
          const cudaError_t err = cudaFuncSetAttribute(
              reinterpret_cast<const void*>(kernel_for(half, wide, per)),
              cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kBudget));
          if (err != cudaSuccess) return static_cast<int>(err);
        }
      }
    }
    allowed = true;
  }
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device < kDevices && cache[device]) {
    *blocks = cache[device];
    return 0;
  }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, reinterpret_cast<const void*>(kernel_for(true, false, kMaxPer)), kBlockThreads,
      static_cast<size_t>(kBudget));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err != cudaSuccess) return static_cast<int>(err);
  *blocks = per_sm * sms;
  if (*blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  if (device < kDevices) cache[device] = *blocks;
  return 0;
}

}  // namespace

// pivots: (rounds,) int64, sources: (rounds, row_bytes) uint8 (rows 16-byte
// aligned), out: (count,) int64, all contiguous on the current device.
// Launches on `stream` and returns the CUDA error (0 = launched).
extern "C" int shuffle_launch(const void* pivots, const void* sources, int64_t row_bytes,
                              int rounds, int64_t count, void* out, void* stream) {
  if (count <= 0 || rounds < 0 || row_bytes < 32 * ((count + 255) / 256) || row_bytes % 16 ||
      reinterpret_cast<uintptr_t>(sources) % 16) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Plan plan = shuffle_core::make_plan(count, rounds, row_bytes, kBuffers, kBudget);
  const bool wide = count >= (int64_t{1} << 31);
  int resident = 0;
  const int rc = resident_blocks(&resident);
  if (rc) return rc;
  const int64_t needed = shuffle_core::ceil_div(count, kThreads);
  const int64_t blocks = needed < resident ? needed : resident;
  int per = 1;
  while (per < kMaxPer && blocks * kThreads * per < count) per *= 2;
  const Kernel kernel = kernel_for(shuffle_core::half_rows(row_bytes), wide, per);
  kernel<<<static_cast<unsigned>(blocks), kBlockThreads, static_cast<size_t>(kBudget),
           static_cast<cudaStream_t>(stream)>>>(static_cast<const int64_t*>(pivots),
                                                 static_cast<const uint8_t*>(sources), plan,
                                                 static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
