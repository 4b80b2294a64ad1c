// The tree reduction of the multi-level merkle kernel, as __host__
// __device__ functions, and the kernel's schedule run on the host.
//
// The arithmetic of the Hopper kernel in merkle.cu. The header is plain C++
// outside nvcc, so g++ builds the same functions for the CPU tests that hold
// them against hashlib and the reference package's reduce_levels.
//
// Nodes are 32-byte SHA-256 digests as 8 big-endian uint32 words, in the
// reference's column layout: word w of node i of an (8, n) level at
// w * n + i. A reduction takes the n nodes of one tree level in blocks of
// 2^b consecutive nodes; each block reduces its nodes level by level, the
// outputs of each level in one of two shared-memory buffers (odd levels in
// A, even ones in B, the same column layout). The reference pads an odd
// level with that level's zero-subtree word (ops/merkle.py:58-60); here
// every node past a level's end reads as that word, and an output past the
// end is that word without a hash, so the root is the reference's. Above a
// block's root a level is one node, paired with the level's zero word: the
// reference's zero chain, run by the tail.

#pragma once

#include <stdint.h>

#include "sha256_core.h"

#ifdef __CUDACC__
#define MERKLE_HD __host__ __device__ __forceinline__
#define MERKLE_UNROLL _Pragma("unroll")
#else
#define MERKLE_HD inline
#define MERKLE_UNROLL
#endif

namespace merkle_core {

constexpr int kThreads = 256;         // threads of a block
constexpr int kMinLog2Block = 8;      // a block takes one node a thread at least,
constexpr int kMaxLog2Block = 11;     // and eight at most
constexpr int64_t kFillBlocks = 512;  // about four blocks an SM of an H100 (132 SMs)
constexpr int kTailNodes = 1 << kMaxLog2Block;  // the most block roots the tail takes
constexpr int kBufA = kTailNodes / 2;  // nodes of a block's first (odd) level
constexpr int kBufB = kTailNodes / 4;  // and of its second (even) level
constexpr int kMaxDepth = 64;          // rows of the zero-word table

// ceil(log2(n)) for n >= 1.
MERKLE_HD int ceil_log2(int64_t n) {
  int r = 0;
  while ((int64_t{1} << r) < n) ++r;
  return r;
}

// The node count k levels above a level of n >= 1 nodes: ceil(n / 2^k).
MERKLE_HD int64_t level_count(int64_t n, int k) { return k > 62 ? 1 : ((n - 1) >> k) + 1; }

// log2 of the nodes each block takes in a launch over n nodes: the least in
// [kMinLog2Block, kMaxLog2Block] whose grid fits kFillBlocks, else the most.
// Small trees spread over the SMs, since their time is the chain of
// dependent levels; large ones give each thread up to eight leaves, so that
// more of the tree is hashed while every warp of a block is busy, in one
// wave of blocks.
MERKLE_HD int block_log2(int64_t n) {
  int b = kMinLog2Block;
  while (b < kMaxLog2Block && level_count(n, b) > kFillBlocks) ++b;
  return b;
}

// The zero-subtree word row of tree level `level` (the table has kMaxDepth
// rows; a row past it is never a live node's sibling).
MERKLE_HD const uint32_t* zero_row(const uint32_t* zero_words, int level) {
  return zero_words + 8 * (level < kMaxDepth ? level : kMaxDepth - 1);
}

// Nodes of level L (1-based) of a block of 2^b nodes: 2^(b - L) up to the
// block's root, then one (the zero chain above it).
MERKLE_HD int level_span(int b, int L) { return L < b ? 1 << (b - L) : 1; }

// One block's reduction: the (8, n) nodes `src` of tree level `level` in
// device memory, cut in blocks of 2^b nodes, of which this is block
// `block`. The (64, 8) zero-word table twice: `zero_src` in device memory,
// for the padding of the input level, and `zero` (device memory, or the
// tail's copy in shared memory) for the levels above.
struct Reduction {
  const uint32_t* src;
  int64_t n;
  int64_t block;
  int level;
  int b;
  const uint32_t* zero_src;
  const uint32_t* zero;
};

// A word of the input level. On the card past the L1 cache (ld.global.cg):
// the tail reads the block roots that other blocks wrote during the launch.
MERKLE_HD uint32_t load_input(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

// Output p of level L of the block into column p of `dst` (row stride
// dst_cap): the hash of children 2p and 2p + 1, or past the level's end the
// level's zero word. Level 1 reads the children from `src` (a child past n
// is the input level's zero word), a later level from `prev`, level L - 1's
// outputs (row stride prev_cap), where every child is written: the level's
// dead nodes hold their zero word.
MERKLE_HD void level_output(const Reduction& r, int L, int p, const uint32_t* prev, int prev_cap,
                            uint32_t* dst, int dst_cap) {
  const int64_t live = level_count(r.n, L) - r.block * level_span(r.b, L);
  if (p >= live) {
    const uint32_t* zero = zero_row(r.zero, r.level + L);
    for (int w = 0; w < 8; ++w) dst[w * dst_cap + p] = zero[w];
    return;
  }
  uint32_t msg[16];
  if (L == 1) {
    const int64_t g = (r.block << r.b) + 2 * static_cast<int64_t>(p);  // g < n: p is live
    const bool paired = g + 1 < r.n;
    const uint32_t* right = paired ? r.src + g + 1 : zero_row(r.zero_src, r.level);
    const int64_t right_stride = paired ? r.n : 1;
    MERKLE_UNROLL
    for (int w = 0; w < 8; ++w) {
      msg[w] = load_input(r.src + w * r.n + g);
      msg[8 + w] = load_input(right + w * right_stride);
    }
  } else {
    MERKLE_UNROLL
    for (int w = 0; w < 8; ++w) {
#ifdef __CUDA_ARCH__
      const uint2 v = *reinterpret_cast<const uint2*>(prev + w * prev_cap + 2 * p);
      msg[w] = v.x;
      msg[8 + w] = v.y;
#else
      msg[w] = prev[w * prev_cap + 2 * p];
      msg[8 + w] = prev[w * prev_cap + 2 * p + 1];
#endif
    }
  }
  uint32_t out[8];
  sha256_core::digest_64b(msg, out);
  MERKLE_UNROLL
  for (int w = 0; w < 8; ++w) dst[w * dst_cap + p] = out[w];
}

// The outputs of level L that thread `thread` of `threads` computes, from
// and into the two buffers (level L's outputs in A if L is odd, else in B).
// Below the block's root the threads share the level's nodes; from the root
// up thread 0 alone computes the one node and writes beside it the zero
// word of its dead sibling, which the next level reads: no barrier there.
MERKLE_HD void run_level(const Reduction& r, int L, int thread, int threads, uint32_t* buf_a,
                         uint32_t* buf_b) {
  const bool odd = L & 1;
  uint32_t* dst = odd ? buf_a : buf_b;
  const uint32_t* prev = odd ? buf_b : buf_a;
  const int dst_cap = odd ? kBufA : kBufB;
  const int prev_cap = odd ? kBufB : kBufA;
  const int span = level_span(r.b, L);
  if (span == 1 && thread == 0) {
    const uint32_t* zero = zero_row(r.zero, r.level + L);
    for (int w = 0; w < 8; ++w) dst[w * dst_cap + 1] = zero[w];
  }
  // one call site of level_output: one copy of the rounds in a kernel
#ifdef __CUDACC__
#pragma unroll 1
#endif
  for (int p = thread; p < span; p += threads) level_output(r, L, p, prev, prev_cap, dst, dst_cap);
}

// The levels a tail takes: its m nodes to one, then the zero chain up to
// `depth` (none where the nodes already pass it).
MERKLE_HD int tail_levels(int64_t m, int level, int depth) {
  const int b = ceil_log2(m);
  return b > depth - level ? b : depth - level;
}

// Word w of the block's node after `levels` levels: the root in the buffer
// of the last level, or with no level the block's one input node.
MERKLE_HD uint32_t top_word(const Reduction& r, int levels, int w, const uint32_t* buf_a,
                            const uint32_t* buf_b) {
  if (levels == 0) return load_input(r.src + w * r.n + (r.block << r.b));
  return (levels & 1) ? buf_a[w * kBufA] : buf_b[w * kBufB];
}

// Intermediate nodes a call writes into its scratch (the launcher's `work`):
// the block roots of every launch of more than one block.
MERKLE_HD int64_t work_nodes(int64_t n) {
  int64_t total = 0;
  for (;;) {
    const int64_t blocks = level_count(n, block_log2(n));
    if (blocks == 1) return total;
    total += blocks;
    if (blocks <= kTailNodes) return total;
    n = blocks;
  }
}

// --- the kernel's schedule on the host, for the CPU tests ------------------

// The tail: m nodes at `level` (block roots, or a small input) reduced to
// one, then chained with the zero words up to `depth`, with the zero-word
// table copied first as the kernel copies it into shared memory.
inline void tail_host(const uint32_t* src, int64_t m, int level, int depth,
                      const uint32_t* zero_words, uint32_t root[8]) {
  static thread_local uint32_t buf_a[8 * kBufA], buf_b[8 * kBufB], zero_s[8 * kMaxDepth];
  for (int i = 0; i < 8 * kMaxDepth; ++i) zero_s[i] = zero_words[i];
  const Reduction r{src, m, 0, level, ceil_log2(m), zero_words, zero_s};
  const int levels = tail_levels(m, level, depth);
  for (int L = 1; L <= levels; ++L) run_level(r, L, 0, 1, buf_a, buf_b);
  for (int w = 0; w < 8; ++w) root[w] = top_word(r, levels, w, buf_a, buf_b);
}

// The root of (8, n) nodes at tree level start_level of a depth-`depth`
// tree, launch by launch and block by block as merkle.cu runs them, the
// threads of a level in turn: block launches while the nodes are more than
// one block, then the tail's launch of one block. `work` holds
// work_nodes(n) nodes. Returns the number of launches.
inline int merkle_root_host(const uint32_t* nodes, int64_t n, const uint32_t* zero_words,
                            int start_level, int depth, uint32_t* work, uint32_t root[8]) {
  static thread_local uint32_t buf_a[8 * kBufA], buf_b[8 * kBufB];
  uint32_t* roots = work;
  const uint32_t* src = nodes;
  int level = start_level;
  int launches = 0;
  for (;;) {
    const int b = block_log2(n);
    const int64_t blocks = level_count(n, b);
    if (blocks == 1) {
      tail_host(src, n, level, depth, zero_words, root);
      return launches + 1;
    }
    for (int64_t block = 0; block < blocks; ++block) {
      const Reduction r{src, n, block, level, b, zero_words, zero_words};
      for (int L = 1; L <= b; ++L) run_level(r, L, 0, 1, buf_a, buf_b);
      for (int w = 0; w < 8; ++w) roots[w * blocks + block] = top_word(r, b, w, buf_a, buf_b);
    }
    ++launches;
    src = roots;
    roots += 8 * blocks;
    n = blocks;
    level += b;
    if (n <= kTailNodes) {
      tail_host(src, n, level, depth, zero_words, root);
      return launches + 1;
    }
  }
}

}  // namespace merkle_core
