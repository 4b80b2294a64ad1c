// Batched SHA-256 of N independent 64-byte messages, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ethereum_consensus_tpu/ops/sha256.py:197
// sha256_64b_pallas (body _sha256_kernel :189, rounds _compress_unrolled
// :119): the merkle-level hash of SSZ hash_tree_root.
//
// Layout, as the reference keeps it: in (16, N) big-endian message words,
// lanes last; out (8, N) digest words. int32 tensors on the torch side carry
// the uint32 bit patterns.
//
// Design: one thread per message. Thread i reads word w at w*N + i, so a
// warp's 32 loads of one word are one coalesced 128-byte transaction, and
// writes its digest the same way. The 64 round constants sit in __constant__
// memory (every lane reads the same one in a round); the rolling 16-word
// message schedule is held in registers (the rounds are fully unrolled, so
// every schedule index is a compile-time constant). The second compression
// runs over the fixed pad block. Any N >= 1: the ragged last block masks its
// tail. No shared memory, no synchronisation.
//
// What bounds it on an H100: integer issue. One message needs the 32-bit
// integer operations of 2 x 64 rounds (about 2.3k at one funnel shift per
// rotate, one LOP3 per three-input logic op and one IADD3 per three-input
// add), against 96 bytes of device memory traffic (64 in, 32 out). At the
// card's 64 INT32 lanes per SM per clock that is about 137 ns per thousand
// messages of issue against 29 ns of bytes at 3.35 TB/s: the kernel is
// bound by operations, by some 4.8x. So the design spends nothing on memory
// staging and keeps every value in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sha256_core.h"

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    sha256_64b_kernel(const uint32_t* __restrict__ in,
                      uint32_t* __restrict__ out, int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= n) return;
  uint32_t msg[16];
#pragma unroll
  for (int w = 0; w < 16; ++w) msg[w] = __ldg(in + w * n + i);
  uint32_t digest[8];
  sha256_core::digest_64b(msg, digest);
#pragma unroll
  for (int w = 0; w < 8; ++w) out[w * n + i] = digest[w];
}

}  // namespace

// in: (16, n) uint32, out: (8, n) uint32, both contiguous on the current
// device; launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int sha256_64b_launch(const void* in, void* out, int64_t n,
                                 void* stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  sha256_64b_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(in), static_cast<uint32_t*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
