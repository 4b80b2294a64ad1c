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
// Design: one block of 128 threads per set. Thread t converts points
// offsets[s] + t, + 128, ... to Montgomery Jacobian form and adds them
// into its own running sum; the 128 partial sums then fold in shared
// memory (a 144-byte Jacobian point each: 18 KB), halving the active
// threads at each of 7 levels. The plain version in ops/g1.py adds in the
// same order, so the Jacobian outputs agree limb for limb. The field is
// 12 x 32-bit limbs in Montgomery form with CIOS multiplication
// (fp381_core.h), fully reduced after every operation, instead of the
// reference's lazy 16-bit columns: the card multiplies 32x32->64 bits
// natively, so there is no column headroom to manage.
//
// What bounds it on an H100: integer multiply-adds. A general Jacobian
// addition is 16 field multiplications of 288 32x32->64-bit
// multiply-adds each (144 for the product, 144 for the reduction), about
// 4.6k per point, against 96 bytes read per point; at 64 integer lanes
// per SM per clock that is some 10x more issue time than byte time. At
// the block-verification shape (66 sets, 32,770 keys) only 66 of the 132
// SMs hold a block, and each thread's additions form one dependent chain,
// so this simple kernel is latency-bound well above that bound.
//
// Built with -DFP381_MUL_MXU (the "mxu" library, ops/fq8.py's switch; the
// reference's EC_PAIRING_MULT=mxu reaches its set sums through
// ops/g1.py:253 aggregate_pubkey_sets_device -> ops/pairing.py:616
// g1_sum_sets on the lazy field), every Fp product is the warp-cooperative
// int8 tensor-core product of fp_mma.h, which a whole warp computes with
// the same operands in every thread. The block then holds 8 warps, and
// warp w runs the chains of the 128 lanes w, w + 8, ... in turn (lane t
// adds points offsets[s] + t, + 128, ...); the 128 partial sums fold in the
// same 7 levels, warp w taking the pairs w, w + 8, ... of each, so the
// Jacobian sums agree limb for limb with the u64 kernel's and with the
// plain version. Lane 0 of a warp stores. Bounded by each product's byte
// reduction, which all 32 threads repeat, and by the 16 chains a warp runs
// in turn.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp381_core.h"

namespace {

constexpr int kThreads = 128;  // the lanes of a set, whose partial sums fold
#ifdef FP381_MUL_MXU
constexpr int kWarps = fp_mma::kMaxWarps;
constexpr int kBlockThreads = 32 * kWarps;
#else
constexpr int kBlockThreads = kThreads;
#endif

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

#ifdef FP381_MUL_MXU
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
#else
  fp381::G1Jac acc = fp381::g1_infinity();
  for (int64_t k = begin + tid; k < end; k += kThreads) {
    const uint32_t* p = points + k * 2 * fp381::kLimbs;
    acc = fp381::g1_add(acc, fp381::g1_from_affine(load_fp(p),
                                                   load_fp(p + fp381::kLimbs)));
  }
  partial[tid] = acc;
  __syncthreads();
#pragma unroll 1
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      partial[tid] = fp381::g1_add(partial[tid], partial[tid + stride]);
    }
    __syncthreads();
  }
  if (tid == 0) {
    const fp381::G1Jac sum = fp381::g1_to_canonical(partial[0]);
    uint32_t* o = out + set * 3 * fp381::kLimbs;
    store_fp(o, sum.x);
    store_fp(o + fp381::kLimbs, sum.y);
    store_fp(o + 2 * fp381::kLimbs, sum.z);
  }
#endif
}

}  // namespace

// points: (K, 2, 12) uint32, offsets: (n_sets + 1,) int64, out:
// (n_sets, 3, 12) uint32, all contiguous on the current device; launches
// on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int g1_sum_sets_launch(const void* points, const void* offsets,
                                  void* out, int64_t n_sets, void* stream) {
  if (n_sets <= 0 || n_sets > 0x7fffffff) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  g1_sum_sets_kernel<<<static_cast<unsigned>(n_sets), kBlockThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(points),
      static_cast<const int64_t*>(offsets), static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
