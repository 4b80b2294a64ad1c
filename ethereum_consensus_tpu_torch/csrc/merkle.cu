// The multi-level merkle root of (8, N) node words, for Hopper (sm_90a).
//
// Replaces the XLA program of the reference package
// ethereum_consensus_tpu/ops/merkle.py:44 reduce_levels (jitted as :73
// merkle_root_words, behind :83 merkleize_chunks_device): every level of a
// binary merkle tree, odd levels padded with the level's zero-subtree word,
// then the zero siblings chained up to the SSZ limit's depth. The reference
// traces one SHA-256 call per level into one program; here the levels stay
// in shared memory.
//
// Layout, as the reference keeps it: nodes (8, n) big-endian uint32 words,
// lanes last; the zero-word table (64, 8), row d the root of a zero subtree
// of height d; the root (8,). int32 tensors on the torch side carry the
// uint32 bit patterns.
//
// Design (merkle_core.h has the arithmetic): each block of 256 threads takes
// 2^b consecutive nodes, b in [8, 11] (the least that keeps the grid within
// about four blocks an SM, so a small tree spreads over the SMs and a large
// one runs in one wave with up to eight leaves a thread), and reduces them
// level by level: thread t computes outputs t, t + 256, ... of a level, each
// leaf word read by a 4-byte load past L1 (ld.global.cg), each level's outputs
// in one of two shared-memory buffers (50 KB with the zero-word table, four
// blocks an SM), one barrier a level below the root. At 2^20 leaves the
// first three levels, seven eighths of the messages, keep all eight warps of
// a block busy, and four blocks an SM overlap their narrow top levels. The
// block roots go to the call's scratch; a second launch of one block (the
// tail) reduces them to one and chains the zero siblings to the depth, the
// zero-word table in shared memory, one thread alone above the root with no
// barrier. A tree of at most 2^8 nodes is one tail launch; block launches
// repeat only where the roots are more than the tail takes (n > 2^22). The
// loops are not unrolled and call the message code at one site, so the
// kernel holds one copy of the SHA-256 rounds (64 registers, no spill). A
// form in which each thread first reduces 4 or 8 leaves in registers from
// 16-byte loads (tools/merkle_forms.cu) took the same time at 2^20 leaves
// and more at 2^15: the loads, buffers and barriers are not what bounds it.
//
// What bounds it on an H100: integer issue (2,288 operations a message
// against 32 bytes read a leaf), then the tree's depth. Every level, the zero
// chain's included, waits for the one below, and one message on one thread
// takes about 5,000 cycles: some 2,080 of its instructions are shifts, logic
// and adds, which a sub-partition's 16 integer lanes issue in two cycles
// each. At 2^15 leaves and limit 2^40 the 40 levels of that chain are the
// whole time; at 2^20 the tail's 29 are about a third.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merkle_core.h"

namespace {

using merkle_core::kBufA;
using merkle_core::kBufB;
using merkle_core::kMaxDepth;
using merkle_core::kThreads;
using merkle_core::Reduction;

struct Shared {
  uint32_t a[8 * kBufA];
  uint32_t b[8 * kBufB];
  uint32_t zero[8 * kMaxDepth];
};

// The kernels' dynamic shared memory (above the 48 KB of a static array).
__device__ __forceinline__ Shared& shared() {
  extern __shared__ __align__(16) uint32_t dynamic[];
  return *reinterpret_cast<Shared*>(dynamic);
}

// One launch over the (8, n) nodes `nodes` of tree level `level`.
// depth < 0: blocks of 2^b nodes, block roots to column blockIdx.x of the
// (8, gridDim.x) `roots`. Else one block, the tail: the zero-word table into
// shared memory, the nodes reduced to one and chained on to `depth`, and
// thread 0 writes the root to `out`.
__global__ void __launch_bounds__(kThreads, 4)
    merkle_tree_kernel(const uint32_t* __restrict__ nodes, int64_t n,
                       const uint32_t* __restrict__ zero_words, int level, int b, int depth,
                       uint32_t* __restrict__ roots, uint32_t* __restrict__ out) {
  Shared& s = shared();
  const bool tail = depth >= 0;
  Reduction r{nodes, n, blockIdx.x, level, b, zero_words, zero_words};
  int levels = b;
  if (tail) {
    for (int i = threadIdx.x; i < 8 * kMaxDepth; i += kThreads) s.zero[i] = zero_words[i];
    __syncthreads();
    r = {nodes, n, 0, level, merkle_core::ceil_log2(n), zero_words, s.zero};
    levels = merkle_core::tail_levels(n, level, depth);
  }
  // not unrolled nor peeled: the rounds stay one copy
#pragma unroll 1
  for (int L = 1; L <= levels; ++L) {
    merkle_core::run_level(r, L, threadIdx.x, kThreads, s.a, s.b);
    if (L < r.b) __syncthreads();  // below the root a level's outputs come from many threads
  }
  if (threadIdx.x == 0) {
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const uint32_t word = merkle_core::top_word(r, levels, w, s.a, s.b);
      if (tail) {
        out[w] = word;
      } else {
        roots[static_cast<int64_t>(w) * gridDim.x + blockIdx.x] = word;
      }
    }
  }
}

// One thread: `steps` levels of the zero chain above the zero leaf (the
// tail's code path), timed with clock64: the latency of one dependent
// message, the floor under every level of the tree.
__global__ void merkle_latency_kernel(const uint32_t* __restrict__ zero_words, int steps,
                                      long long* __restrict__ cycles, uint32_t* __restrict__ out) {
  Shared& s = shared();
  for (int i = 0; i < 8 * kMaxDepth; ++i) s.zero[i] = zero_words[i];
  const Reduction r{zero_words, 1, 0, 0, 0, zero_words, s.zero};
  const long long start = clock64();
  for (int L = 1; L <= steps; ++L) merkle_core::run_level(r, L, 0, 1, s.a, s.b);
  const long long end = clock64();
  *cycles = end - start;
#pragma unroll
  for (int w = 0; w < 8; ++w) out[w] = merkle_core::top_word(r, steps, w, s.a, s.b);
}

// The kernels' shared memory above 48 KB, allowed once a device.
cudaError_t allow_shared() {
  static bool allowed[64];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < 0 || device >= 64) return cudaErrorInvalidDevice;
  if (!allowed[device]) {
    const int bytes = static_cast<int>(sizeof(Shared));
    err = cudaFuncSetAttribute(merkle_tree_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
    if (err == cudaSuccess) {
      err = cudaFuncSetAttribute(merkle_latency_kernel,
                                 cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    }
    if (err != cudaSuccess) return err;
    allowed[device] = true;
  }
  return cudaSuccess;
}

}  // namespace

// nodes: (8, n) uint32 words of a level at tree level start_level;
// zero_words: (64, 8); work: merkle_core::work_nodes(n) nodes of scratch
// (each block launch's roots); out: (8,) the root of the depth-`depth` tree.
// All contiguous on the current device. Launches on `stream` and returns
// the number of grid launches (> 0), or -cudaError of a refused one
// (-cudaErrorInvalidValue for a bad count or level).
extern "C" int merkle_root_launch(const void* nodes, int64_t n, const void* zero_words,
                                  int start_level, int depth, void* work, void* out,
                                  void* stream) {
  if (n <= 0 || n > (int64_t{1} << 40) || start_level < 0 || depth < start_level ||
      depth > kMaxDepth) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = allow_shared();
  if (err != cudaSuccess) return -static_cast<int>(err);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* src = static_cast<const uint32_t*>(nodes);
  const uint32_t* zero = static_cast<const uint32_t*>(zero_words);
  uint32_t* roots = static_cast<uint32_t*>(work);
  uint32_t* root = static_cast<uint32_t*>(out);
  int level = start_level;
  int launches = 0;
  for (;;) {
    const int b = merkle_core::block_log2(n);
    const int64_t blocks = merkle_core::level_count(n, b);
    if (blocks > 1) {
      merkle_tree_kernel<<<static_cast<unsigned>(blocks), kThreads, sizeof(Shared), s>>>(
          src, n, zero, level, b, -1, roots, root);
      ++launches;
      src = roots;
      roots += 8 * blocks;
      n = blocks;
      level += b;
    }
    if (n <= merkle_core::kTailNodes) {
      merkle_tree_kernel<<<1, kThreads, sizeof(Shared), s>>>(src, n, zero, level, 0, depth,
                                                             roots, root);
      ++launches;
    }
    err = cudaGetLastError();
    if (err != cudaSuccess) return -static_cast<int>(err);
    if (n <= merkle_core::kTailNodes) return launches;
  }
}

// One thread's latency of `steps` dependent messages (clock64 cycles into
// cycles[0]) and the chain's root (the zero word of level `steps`) into
// out[8]; steps in [0, 64]. Returns cudaGetLastError().
extern "C" int merkle_latency_launch(const void* zero_words, int steps, void* cycles, void* out,
                                     void* stream) {
  if (steps < 0 || steps > kMaxDepth) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err = allow_shared();
  if (err != cudaSuccess) return static_cast<int>(err);
  merkle_latency_kernel<<<1, 1, sizeof(Shared), static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(zero_words), steps, static_cast<long long*>(cycles),
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
