// B2's measured alternatives (tools/merkle_flag_forms.py), over the kernel of
// csrc/merkle.cu as the include path gives it. Not part of the program.
//
// merkle_form_launch: the kernel's block launch at a chosen block size, and
// its two launches apart. merkle_subtree_launch: the register-subtree form.
// Each thread reduces a subtree of 2^SUBTREE_K leaves in registers, one
// compression after another, its leaves read as one 16-byte vector of each
// word row a quad of leaves (a 4-byte load a leaf where n or the pointer does
// not allow it); the block's 256 subtree roots then go through a
// shared-memory tree of 8 levels, and the kernel's tail launch reduces the
// block roots. The steps run in one loop with one call site of the message
// code, so the kernel holds one copy of the rounds, as merkle.cu's does.
// Built with -DSUBTREE_K=2|3 and -DSUBTREE_MIN_BLOCKS (the
// __launch_bounds__ minimum of blocks an SM: 4 gives at most 64 registers).

#include "merkle.cu"

#ifndef SUBTREE_K
#define SUBTREE_K 3
#endif
#ifndef SUBTREE_MIN_BLOCKS
#define SUBTREE_MIN_BLOCKS 4
#endif

namespace {

constexpr int kSubtreeLeaves = 1 << SUBTREE_K;
constexpr int kRegisterSteps = kSubtreeLeaves - 1;  // compressions of a thread's subtree
constexpr int kSharedLevels = 8;                     // log2(kThreads)
static_assert(SUBTREE_K == 2 || SUBTREE_K == 3, "a thread's subtree is 4 or 8 leaves");

// Word row w of leaves first .. first + 3 into q[w][0..3]: a 16-byte load a
// row where `vector`, else a 4-byte load a leaf, a leaf past n reading as
// the level's zero word.
__device__ __forceinline__ void load_quad(const uint32_t* __restrict__ src, int64_t n,
                                          int64_t first, bool vector,
                                          const uint32_t* __restrict__ zero, uint32_t q[8][4]) {
  if (vector) {
#pragma unroll
    for (int w = 0; w < 8; ++w) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(src + w * n + first));
      q[w][0] = v.x;
      q[w][1] = v.y;
      q[w][2] = v.z;
      q[w][3] = v.w;
    }
  } else {
#pragma unroll
    for (int w = 0; w < 8; ++w) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        q[w][j] = first + j < n ? __ldcs(src + w * n + first + j) : __ldg(zero + w);
      }
    }
  }
}

// Blocks of 256 threads a 256 * 2^SUBTREE_K leaves of the (8, n) level
// `src` at tree level `level`; block roots to column blockIdx.x of the
// (8, gridDim.x) `roots`. Steps 0 .. kRegisterSteps - 1 are the thread's
// subtree in post-order (quads of leaves, their roots, and for k = 3 the
// two quads' roots); the steps after are the shared tree's levels.
__global__ void __launch_bounds__(kThreads, SUBTREE_MIN_BLOCKS)
    merkle_subtree_kernel(const uint32_t* __restrict__ src, int64_t n,
                          const uint32_t* __restrict__ zero_words, int level,
                          uint32_t* __restrict__ roots) {
  __shared__ __align__(16) uint32_t buf_a[8 * kThreads];
  __shared__ __align__(16) uint32_t buf_b[8 * kThreads / 2];
  const int t = threadIdx.x;
  const int64_t base = (static_cast<int64_t>(blockIdx.x) * kThreads + t) * kSubtreeLeaves;
  const uint32_t* zero = merkle_core::zero_row(zero_words, level);
  const bool rows_aligned =
      (n & 3) == 0 && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
  uint32_t q[8][4], held[8], half[8], out[8];
#pragma unroll 1
  for (int s = 0; s < kRegisterSteps + kSharedLevels; ++s) {
    uint32_t msg[16];
    bool active = true;
    if (s < kRegisterSteps) {
      const int j = s % 3;  // step within a quad: its two pairs, then their parent
      if (s == 6) {         // k = 3: the two quads' roots
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          msg[w] = half[w];
          msg[8 + w] = out[w];
        }
      } else if (j == 0) {
        const int64_t first = base + 4 * (s / 3);
        load_quad(src, n, first, rows_aligned && first + 3 < n, zero, q);
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          msg[w] = q[w][0];
          msg[8 + w] = q[w][1];
        }
      } else if (j == 1) {
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          msg[w] = q[w][2];
          msg[8 + w] = q[w][3];
        }
      } else {
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          msg[w] = held[w];
          msg[8 + w] = out[w];
        }
      }
    } else {
      // shared level L = s - kRegisterSteps + 1 reads level L - 1's nodes
      const int L = s - kRegisterSteps + 1;
      const int span = kThreads >> L;
      active = t < span;
      const uint32_t* prev = (L & 1) ? buf_a : buf_b;
      const int prev_cap = (L & 1) ? kThreads : kThreads / 2;
      if (active) {
#pragma unroll
        for (int w = 0; w < 8; ++w) {
          const uint2 v = *reinterpret_cast<const uint2*>(prev + w * prev_cap + 2 * t);
          msg[w] = v.x;
          msg[8 + w] = v.y;
        }
      }
    }
    if (active) {
      uint32_t digest[8];
      sha256_core::digest_64b(msg, digest);
#pragma unroll
      for (int w = 0; w < 8; ++w) out[w] = digest[w];
    }
    if (s < kRegisterSteps) {
      if (s % 3 == 0 && s != 6) {
#pragma unroll
        for (int w = 0; w < 8; ++w) held[w] = out[w];
      }
      if (s == 2) {
#pragma unroll
        for (int w = 0; w < 8; ++w) half[w] = out[w];
      }
    }
    if (s >= kRegisterSteps - 1) {
      // the thread's subtree root (into A), or shared level L's node t
      const int L = s - kRegisterSteps + 1;
      uint32_t* dst = (L & 1) ? buf_b : buf_a;
      const int cap = (L & 1) ? kThreads / 2 : kThreads;
      if (L == 0 || t < (kThreads >> L)) {
#pragma unroll
        for (int w = 0; w < 8; ++w) dst[w * cap + t] = out[w];
      }
      __syncthreads();
    }
  }
  if (t == 0) {
    // level 8 (even) wrote into A
#pragma unroll
    for (int w = 0; w < 8; ++w) roots[static_cast<int64_t>(w) * gridDim.x + blockIdx.x] = out[w];
  }
}

}  // namespace

// n <= 2^b * kTailNodes nodes in blocks of 2^b. mode 1: the block launch,
// then the tail's (the program's form); 2: the block launch alone; 3: the
// tail's launch alone, on the roots a mode-2 call left in `work`. Returns
// the launches made, or -1.
extern "C" int merkle_form_launch(const void* nodes, int64_t n, const void* zero_words,
                                  int start_level, int depth, void* work, void* out, void* stream,
                                  int b, int mode) {
  const int64_t blocks = merkle_core::level_count(n, b);
  if (blocks < 2 || blocks > merkle_core::kTailNodes || allow_shared() != cudaSuccess) {
    return -1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* roots = static_cast<uint32_t*>(work);
  const uint32_t* zero = static_cast<const uint32_t*>(zero_words);
  uint32_t* root = static_cast<uint32_t*>(out);
  int launches = 0;
  if (mode == 1 || mode == 2) {
    merkle_tree_kernel<<<static_cast<unsigned>(blocks), kThreads, sizeof(Shared), s>>>(
        static_cast<const uint32_t*>(nodes), n, zero, start_level, b, -1, roots, root);
    ++launches;
  }
  if (mode == 1 || mode == 3) {
    merkle_tree_kernel<<<1, kThreads, sizeof(Shared), s>>>(roots, blocks, zero, start_level + b,
                                                           0, depth, roots, root);
    ++launches;
  }
  return cudaGetLastError() == cudaSuccess && launches > 0 ? launches : -1;
}

// The register-subtree form, merkle_root_launch's arguments: its block
// launch, then the kernel's tail launch on the block roots (mode 1), or
// the block launch alone (mode 2). Needs 2 <= blocks <= kTailNodes, blocks
// of 256 * 2^SUBTREE_K leaves. Returns the launches made, or -1.
extern "C" int merkle_subtree_launch(const void* nodes, int64_t n, const void* zero_words,
                                     int start_level, int depth, void* work, void* out,
                                     void* stream, int mode) {
  constexpr int b = SUBTREE_K + kSharedLevels;
  const int64_t blocks = merkle_core::level_count(n, b);
  if (blocks < 2 || blocks > merkle_core::kTailNodes || allow_shared() != cudaSuccess) {
    return -1;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  uint32_t* roots = static_cast<uint32_t*>(work);
  const uint32_t* zero = static_cast<const uint32_t*>(zero_words);
  merkle_subtree_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(
      static_cast<const uint32_t*>(nodes), n, zero, start_level, roots);
  int launches = 1;
  if (mode == 1) {
    merkle_tree_kernel<<<1, kThreads, sizeof(Shared), s>>>(roots, blocks, zero, start_level + b, 0,
                                                           depth, roots,
                                                           static_cast<uint32_t*>(out));
    ++launches;
  }
  return cudaGetLastError() == cudaSuccess ? launches : -1;
}
