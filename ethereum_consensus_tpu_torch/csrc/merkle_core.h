// The block reduction of the multi-level merkle kernel, as __host__
// __device__ functions, and the kernel's launches emulated on the host.
//
// The arithmetic of the Hopper kernel in merkle.cu. The header is plain C++
// outside nvcc, so g++ builds the same functions for the CPU tests that hold
// them against hashlib and the reference package's reduce_levels.
//
// Nodes are 32-byte SHA-256 digests as 8 big-endian uint32 words, in the
// reference's column layout: word w of node i of an (8, n) level at
// w * n + i. A block reduces the subtree of kLeaves consecutive nodes of a
// level in shared memory (the same column layout, kLeaves wide), one parent
// per thread and level. The reference pads an odd level with that level's
// zero-subtree word (ops/merkle.py:58-60); here every node past a level's end
// reads as that word, so the parents of two such nodes are the next level's
// zero word and the root is the reference's.

#pragma once

#include <stdint.h>

#include "sha256_core.h"

#ifdef __CUDACC__
#define MERKLE_HD __host__ __device__ __forceinline__
#else
#define MERKLE_HD inline
#endif

namespace merkle_core {

constexpr int kLog2Leaves = 9;
constexpr int kLeaves = 1 << kLog2Leaves;  // nodes of one block's subtree
constexpr int kThreads = kLeaves / 2;      // one thread per parent of the first level
constexpr int kMaxDepth = 64;              // rows of the zero-word table

// ceil(log2(n)) for n >= 1.
MERKLE_HD int ceil_log2(int64_t n) {
  int r = 0;
  while ((int64_t{1} << r) < n) ++r;
  return r;
}

// The node count k levels above a level of n >= 1 nodes: ceil(n / 2^k).
MERKLE_HD int64_t level_count(int64_t n, int k) { return ((n - 1) >> k) + 1; }

// The levels that each block of one launch over n nodes at tree level
// `level` reduces. While more than one block is needed, the whole subtree.
// For the last launch (n <= kLeaves): the levels that take n nodes to one
// (the reference's loop) and, where the tree is deeper, more up to kLeaves'
// height or the depth: above the last live node a level is the node and the
// zero word, the reference's zero chain.
MERKLE_HD int block_levels(int64_t n, int level, int depth) {
  if (n > kLeaves) return kLog2Leaves;
  const int to_one = ceil_log2(n);
  const int room = depth - level < kLog2Leaves ? depth - level : kLog2Leaves;
  return to_one > room ? to_one : room;
}

// The live nodes of block `block` k levels above the launch's n nodes: the
// nodes of the level before its end, at most the block's kLeaves >> k.
MERKLE_HD int live_nodes(int64_t n, int64_t block, int k) {
  const int64_t width = kLeaves >> k;
  const int64_t live = level_count(n, k) - block * width;
  return static_cast<int>(live < 0 ? 0 : (live > width ? width : live));
}

// The zero-subtree word row of tree level `level` (the table has kMaxDepth
// rows; a row past it is never a live node's sibling).
MERKLE_HD const uint32_t* zero_row(const uint32_t* zero_words, int level) {
  return zero_words + 8 * (level < kMaxDepth ? level : kMaxDepth - 1);
}

// Word w of leaf i of block `block`: the input node, or past the level's end
// the level's zero word.
MERKLE_HD uint32_t leaf_word(const uint32_t* nodes, int64_t n, int64_t block, int i, int w,
                             const uint32_t* zero_level) {
  const int64_t g = block * kLeaves + i;
  return g < n ? nodes[w * n + g] : zero_level[w];
}

// Parent j of the level held in `s` (column layout, kLeaves wide): the hash
// of nodes 2j and 2j + 1, or the next level's zero word past its end.
MERKLE_HD void parent(const uint32_t* s, int j, int live_next, const uint32_t* zero_next,
                      uint32_t out[8]) {
  if (j >= live_next) {
    for (int w = 0; w < 8; ++w) out[w] = zero_next[w];
    return;
  }
  uint32_t msg[16];
  for (int w = 0; w < 8; ++w) {
    msg[w] = s[w * kLeaves + 2 * j];
    msg[8 + w] = s[w * kLeaves + 2 * j + 1];
  }
  sha256_core::digest_64b(msg, out);
}

// The zero chain: root = H(root || zero[d]) for d in [from, to).
MERKLE_HD void chain_zeros(uint32_t root[8], const uint32_t* zero_words, int from, int to) {
  for (int d = from; d < to; ++d) {
    uint32_t msg[16];
    for (int w = 0; w < 8; ++w) {
      msg[w] = root[w];
      msg[8 + w] = zero_words[8 * d + w];
    }
    sha256_core::digest_64b(msg, root);
  }
}

// Intermediate nodes the launches write before the last one: the roots of
// every launch over more than kLeaves nodes (the launcher's `work`).
MERKLE_HD int64_t work_nodes(int64_t n) {
  int64_t total = 0;
  while (n > kLeaves) {
    n = level_count(n, kLog2Leaves);
    total += n;
  }
  return total;
}

// --- the launches on the host, for the CPU tests ---------------------------

// One block of one launch, its threads taken in turn between the barriers of
// the kernel: writes the block's root (after the zero chain to `chain_to`)
// at column `block` of the (8, blocks) `out`.
inline void reduce_block_host(const uint32_t* nodes, int64_t n, int64_t block,
                              const uint32_t* zero_words, int level, int levels, int chain_to,
                              uint32_t* out, int64_t blocks) {
  static thread_local uint32_t s[8 * kLeaves];
  for (int i = 0; i < kLeaves; ++i) {
    for (int w = 0; w < 8; ++w) {
      s[w * kLeaves + i] = leaf_word(nodes, n, block, i, w, zero_row(zero_words, level));
    }
  }
  for (int k = 0; k < levels; ++k) {
    const int half = kLeaves >> (k + 1);
    const int live_next = live_nodes(n, block, k + 1);
    static thread_local uint32_t next[8 * kThreads];
    for (int j = 0; j < half; ++j) {
      uint32_t node[8];
      parent(s, j, live_next, zero_row(zero_words, level + k + 1), node);
      for (int w = 0; w < 8; ++w) next[w * kThreads + j] = node[w];
    }
    for (int j = 0; j < half; ++j) {
      for (int w = 0; w < 8; ++w) s[w * kLeaves + j] = next[w * kThreads + j];
    }
  }
  uint32_t root[8];
  for (int w = 0; w < 8; ++w) root[w] = s[w * kLeaves];
  chain_zeros(root, zero_words, level + levels, chain_to);
  for (int w = 0; w < 8; ++w) out[w * blocks + block] = root[w];
}

// The root of (8, n) nodes at tree level start_level of a depth-`depth`
// tree, launch by launch as merkle.cu's launcher makes them; `work` holds
// work_nodes(n) nodes. Returns the number of launches.
inline int merkle_root_host(const uint32_t* nodes, int64_t n, const uint32_t* zero_words,
                            int start_level, int depth, uint32_t* work, uint32_t root[8]) {
  int level = start_level;
  int launches = 0;
  const uint32_t* src = nodes;
  for (;;) {
    const int levels = block_levels(n, level, depth);
    const int64_t blocks = level_count(n, kLog2Leaves);
    const bool last = blocks == 1;
    uint32_t* dst = last ? root : work;
    for (int64_t b = 0; b < blocks; ++b) {
      reduce_block_host(src, n, b, zero_words, level, levels, last ? depth : level + levels, dst,
                        blocks);
    }
    ++launches;
    if (last) return launches;
    src = dst;
    work += 8 * blocks;
    n = blocks;
    level += levels;
  }
}

}  // namespace merkle_core
