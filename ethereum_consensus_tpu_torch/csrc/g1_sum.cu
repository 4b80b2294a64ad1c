// S independent sums of BLS12-381 G1 points (the pubkey-set aggregation of
// batched BLS verification), for Hopper (sm_90a).
//
// Replaces the XLA program of the reference package
// ethereum_consensus_tpu/ops/pairing.py:594 _g1_tree_reduce_segmented
// (reached through :616 g1_sum_sets; its strict-field twin is
// ops/g1.py:163 _tree_reduce_segmented behind :244
// aggregate_pubkeys_device): one aggregation per signature set, all sets
// in one launch.
//
// Input, ragged as CSR: points (K, 2, 12) uint32 — canonical affine x and
// y, 12 limbs each, least significant first; all zero is the point at
// infinity — and offsets (S + 1,) int64, set s being points
// [offsets[s], offsets[s + 1]). Output (S, 3, 12) uint32: each set's sum
// as canonical (not Montgomery) Jacobian limbs; Z = 0 is infinity. The
// caller converts to affine on the host (one inversion per set).
//
// The sums: a set's 128 lanes, lane t adding the points offsets[s] + t,
// + 128, ... in turn, then the 128 partial sums folding in 7 levels (lane t
// takes lane t + 64, then t + 32, ..., then t + 1). The plain version in
// ops/g1.py adds in the same order with the same formulas, so the Jacobian
// outputs agree limb for limb. The field is 12 x 32-bit limbs in Montgomery
// form with CIOS multiplication (fp381_core.h), fully reduced after every
// operation.
//
// What bounds it on an H100: a lane's additions are one dependent chain,
// and each is 11 to 16 Fp products of about 3 us each on one thread (the
// CIOS carry chain); the integer work of all lanes is small against the
// card (a mixed addition is about 3.0k multiply-adds per key). So the
// kernel is bound by the chain's latency, and its design shortens the
// chain and fills the card:
//   - u64 build: a lane is a crew of 4 threads (g1_sum_lanes.h), each
//     addition a table of steps of at most 4 independent products, one a
//     thread (a key's mixed addition 5 product steps, the next key's
//     conversion to Montgomery form beside it; a fold's addition 5). Two
//     launches: the chains, 32 lanes a block (4 blocks a set, so the
//     block's 66 sets fill all 132 SMs), each lane's sum to scratch (the
//     wrapper's); then the fold, one block of 64 crews a set, its 7 levels
//     in shared memory, and crew 0 writes the output. A chain's block
//     leaves when its chains are done, so no block holds its slots through
//     the fold's narrowing levels (measured against the fold in the set's
//     last block to arrive, an atomic ticket: PERF.md).
//   - mxu build (-DFP381_MUL_MXU, the "mxu" library, ops/fq8.py's switch;
//     the reference's EC_PAIRING_MULT=mxu reaches its set sums through
//     ops/g1.py:253 aggregate_pubkey_sets_device -> ops/pairing.py:616
//     g1_sum_sets on the lazy field): every Fp product is the
//     warp-cooperative int8 tensor-core product of fp_mma.h, which a whole
//     warp computes with the same operands in every thread. One block a
//     set holds 8 warps, and warp w runs the chains of the 128 lanes w,
//     w + 8, ... in turn; the 128 partial sums fold in the same 7 levels in
//     shared memory, warp w taking the pairs w, w + 8, ... of each, so the
//     sums agree limb for limb with the u64 kernel's. Lane 0 of a warp
//     stores. Bounded by each product's chain of dependent steps (eight
//     mma.sync steps and three carry passes split across the warp), and by
//     the 16 chains a warp runs in turn.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp381_core.h"
#ifndef FP381_MUL_MXU
#include "g1_sum_lanes.h"
#endif

namespace {

#ifdef FP381_MUL_MXU
constexpr int kThreads = 128;  // the lanes of a set, whose partial sums fold
constexpr int kWarps = fp_mma::kMaxWarps;
constexpr int kBlockThreads = 32 * kWarps;

__device__ __forceinline__ fp381::Fp load_fp(const uint32_t* p) {
  fp381::Fp r;
#pragma unroll
  for (int i = 0; i < fp381::kLimbs; ++i) r.v[i] = __ldg(p + i);
  return r;
}

__device__ __forceinline__ void store_fp(uint32_t* p, const fp381::Fp& a) {
#pragma unroll
  for (int i = 0; i < fp381::kLimbs; ++i) p[i] = a.v[i];
}

__global__ void __launch_bounds__(kBlockThreads)
    g1_sum_sets_kernel(const uint32_t* __restrict__ points,
                       const int64_t* __restrict__ offsets,
                       uint32_t* __restrict__ out) {
  __shared__ fp381::G1Jac partial[kThreads];
  const int64_t set = blockIdx.x;
  const int tid = threadIdx.x;
  const int64_t begin = offsets[set];
  const int64_t end = offsets[set + 1];
  const int warp = tid >> 5;
  const bool storing = (tid & 31) == 0;
#pragma unroll 1
  for (int lane = warp; lane < kThreads; lane += kWarps) {
    fp381::G1Jac acc = fp381::g1_infinity();
#pragma unroll 1
    for (int64_t k = begin + lane; k < end; k += kThreads) {
      const uint32_t* p = points + k * 2 * fp381::kLimbs;
      acc = fp381::g1_add(acc, fp381::g1_from_affine(load_fp(p), load_fp(p + fp381::kLimbs)));
    }
    if (storing) partial[lane] = acc;
  }
  __syncthreads();
#pragma unroll 1
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
#pragma unroll 1
    for (int lane = warp; lane < stride; lane += kWarps) {
      const fp381::G1Jac a = partial[lane];
      const fp381::G1Jac b = partial[lane + stride];
      const fp381::G1Jac r = fp381::g1_add(a, b);
      __syncwarp();
      if (storing) partial[lane] = r;
    }
    __syncthreads();
  }
  if (tid < 32) {
    const fp381::G1Jac sum = fp381::g1_to_canonical(partial[0]);
    if (tid == 0) {
      uint32_t* o = out + set * 3 * fp381::kLimbs;
      store_fp(o, sum.x);
      store_fp(o + fp381::kLimbs, sum.y);
      store_fp(o + 2 * fp381::kLimbs, sum.z);
    }
  }
}
#else
using g1sum::kChainLanes;
using g1sum::kCrew;
using g1sum::kFoldCrews;
using g1sum::kJacWords;
using g1sum::kLanes;

__device__ __forceinline__ lanes::FpCrew crew_of(fp381::Fp (*slots)[g1sum::kSlots]) {
  return lanes::FpCrew{slots[threadIdx.x / kCrew], static_cast<int>(threadIdx.x % kCrew), kCrew,
                       0xfu << (threadIdx.x & 28)};
}

// The chains: crew c of block b runs lane 32 b + c (set (32 b + c) / 128)
// and writes its sum, Montgomery Jacobian, to lane_sums.
__global__ void __launch_bounds__(kCrew * kChainLanes)
    g1_sum_chains_kernel(const uint32_t* __restrict__ points,
                         const int64_t* __restrict__ offsets,
                         uint32_t* __restrict__ lane_sums) {
  __shared__ fp381::Fp slots[kChainLanes][g1sum::kSlots];
  const lanes::FpCrew c = crew_of(slots);
  const int64_t lane = static_cast<int64_t>(blockIdx.x) * kChainLanes + threadIdx.x / kCrew;
  const int64_t set = lane / kLanes;
  g1sum::crew_constants(c);
  g1sum::chain_crew(c, points, offsets[set] + lane % kLanes, offsets[set + 1]);
  const uint32_t* w = g1sum::words(c, g1sum::X1);
  for (int i = c.t; i < kJacWords; i += kCrew) lane_sums[lane * kJacWords + i] = w[i];
}

// The fold: block s folds set s's 128 lane sums in 7 levels (crew cr adds
// lanes cr and cr + 64, then the crews below 32, 16, ..., 1 add the next
// crews' sums) and writes the output. Its slots are dynamic shared memory
// (kFoldSmem).
constexpr size_t kFoldSmem = sizeof(fp381::Fp) * kFoldCrews * g1sum::kSlots;

__global__ void __launch_bounds__(kCrew * kFoldCrews)
    g1_sum_fold_kernel(const uint32_t* __restrict__ lane_sums, uint32_t* __restrict__ out) {
  extern __shared__ fp381::Fp fold_slots[];
  fp381::Fp (*slots)[g1sum::kSlots] = reinterpret_cast<fp381::Fp (*)[g1sum::kSlots]>(fold_slots);
  const int64_t set = blockIdx.x;
  const int cr = threadIdx.x / kCrew;
  const lanes::FpCrew c = crew_of(slots);
  g1sum::crew_constants(c);
  g1sum::first_level_crew(c, cr, lane_sums + set * kLanes * kJacWords);
#pragma unroll 1
  for (int half = kFoldCrews / 2; half >= 1; half >>= 1) {
    __syncthreads();
    if (cr < half) {
      g1sum::crew_partner(c, slots[cr + half]);
      g1sum::fold_crew(c, half == 1);
    }
  }
  if (cr == 0) g1sum::store_out_crew(c, out + set * kJacWords);
}
#endif

}  // namespace

// points: (K, 2, 12) uint32, offsets: (n_sets + 1,) int64, out:
// (n_sets, 3, 12) uint32, all contiguous on the current device; scratch
// (the u64 build; the mxu build takes none): n_sets * 128 * 36 int32, the
// lanes' sums. Launches on `stream` (u64: the chains, then the fold) and
// returns the CUDA error (0 = launched).
extern "C" int g1_sum_sets_launch(const void* points, const void* offsets, void* out,
                                  void* scratch, int64_t n_sets, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint32_t* p = static_cast<const uint32_t*>(points);
  const int64_t* o = static_cast<const int64_t*>(offsets);
  uint32_t* r = static_cast<uint32_t*>(out);
#ifdef FP381_MUL_MXU
  (void)scratch;
  if (n_sets <= 0 || n_sets > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  g1_sum_sets_kernel<<<static_cast<unsigned>(n_sets), kBlockThreads, 0, s>>>(p, o, r);
#else
  if (n_sets <= 0 || n_sets > 0x7fffffff / (kLanes / kChainLanes) || scratch == nullptr) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool fold_smem_allowed = false;  // the attribute is the kernel's, per process
  if (!fold_smem_allowed) {
    const cudaError_t err = cudaFuncSetAttribute(
        g1_sum_fold_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(kFoldSmem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fold_smem_allowed = true;
  }
  uint32_t* lane_sums = static_cast<uint32_t*>(scratch);
  g1_sum_chains_kernel<<<static_cast<unsigned>(n_sets * (kLanes / kChainLanes)),
                         kCrew * kChainLanes, 0, s>>>(p, o, lane_sums);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  g1_sum_fold_kernel<<<static_cast<unsigned>(n_sets), kCrew * kFoldCrews, kFoldSmem, s>>>(
      lane_sums, r);
#endif
  return static_cast<int>(cudaGetLastError());
}
