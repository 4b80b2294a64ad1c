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
// Design: each block loads a 512-node subtree of the level into shared
// memory (16 KB, the reference's column layout), coalesced by word row, and
// reduces it level by level, one thread per parent node, with a barrier
// between levels; nodes past the level's end read as the level's zero word
// (merkle_core.h). Each block writes one root. Launches repeat on the roots
// until one block holds the rest; that block reduces on to the tree's depth
// (above the last live node a level is the node and the zero word) and its
// thread 0 chains the remaining zero siblings. 2^20 leaves at limit 2^40 take
// three launches: 2,048 blocks, 4 blocks, then one block that reduces 9 levels
// and chains 13. The leaves are read once and the levels never leave the SM.
//
// What bounds it on an H100: integer issue, as B1 (sha256.cu): 2,288
// operations a message against 32 bytes read a leaf. The levels above the
// first halve the threads at work in each block; the first level is half the
// messages, so a block's later levels cost at most as much again.

#include <cuda_runtime.h>
#include <stdint.h>

#include "merkle_core.h"

namespace {

using merkle_core::kLeaves;
using merkle_core::kThreads;

// One launch: block b reduces nodes [512 b, 512 b + 512) of the (8, n) level
// at tree level `level` by `levels` levels, chains zero siblings from
// level + levels to `chain_to`, and writes its root at column b of the
// (8, gridDim.x) `out`.
__global__ void __launch_bounds__(kThreads)
    merkle_levels_kernel(const uint32_t* __restrict__ nodes, int64_t n,
                         const uint32_t* __restrict__ zero_words, int level, int levels,
                         int chain_to, uint32_t* __restrict__ out) {
  __shared__ uint32_t s[8 * kLeaves];
  const int64_t block = blockIdx.x;
  const uint32_t* zero_leaf = merkle_core::zero_row(zero_words, level);
#pragma unroll
  for (int w = 0; w < 8; ++w) {
    for (int i = threadIdx.x; i < kLeaves; i += kThreads) {
      s[w * kLeaves + i] = merkle_core::leaf_word(nodes, n, block, i, w, zero_leaf);
    }
  }
  __syncthreads();
  for (int k = 0; k < levels; ++k) {
    const int half = kLeaves >> (k + 1);
    const int j = threadIdx.x;
    uint32_t node[8];
    if (j < half) {
      merkle_core::parent(s, j, merkle_core::live_nodes(n, block, k + 1),
                          merkle_core::zero_row(zero_words, level + k + 1), node);
    }
    __syncthreads();  // every child read before any parent lands on it
    if (j < half) {
#pragma unroll
      for (int w = 0; w < 8; ++w) s[w * kLeaves + j] = node[w];
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    uint32_t root[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) root[w] = s[w * kLeaves];
    merkle_core::chain_zeros(root, zero_words, level + levels, chain_to);
#pragma unroll
    for (int w = 0; w < 8; ++w) out[w * gridDim.x + block] = root[w];
  }
}

}  // namespace

// nodes: (8, n) uint32 words of a level at tree level start_level;
// zero_words: (64, 8); work: merkle_core::work_nodes(n) nodes of
// scratch, (8, m) per launch in turn; out: (8,) the root of the
// depth-`depth` tree. All contiguous on the current device. Launches on
// `stream` and returns the number of grid launches (> 0), or -cudaError of a
// refused one (-cudaErrorInvalidValue for a bad count or level).
extern "C" int merkle_root_launch(const void* nodes, int64_t n, const void* zero_words,
                                  int start_level, int depth, void* work, void* out,
                                  void* stream) {
  if (n <= 0 || n > (int64_t{1} << 40) || start_level < 0 || depth < start_level ||
      depth > merkle_core::kMaxDepth) {
    return -static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* src = static_cast<const uint32_t*>(nodes);
  const uint32_t* zero = static_cast<const uint32_t*>(zero_words);
  uint32_t* scratch = static_cast<uint32_t*>(work);
  int level = start_level;
  int launches = 0;
  for (;;) {
    const int levels = merkle_core::block_levels(n, level, depth);
    const int64_t blocks = merkle_core::level_count(n, merkle_core::kLog2Leaves);
    const bool last = blocks == 1;
    uint32_t* dst = last ? static_cast<uint32_t*>(out) : scratch;
    merkle_levels_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
        src, n, zero, level, levels, last ? depth : level + levels, dst);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return -static_cast<int>(err);
    ++launches;
    if (last) return launches;
    src = dst;
    scratch += 8 * blocks;
    n = blocks;
    level += levels;
  }
}
