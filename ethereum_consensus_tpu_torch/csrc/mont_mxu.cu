// B8 alone: the batched Montgomery product of n independent operand pairs
// on the int8 tensor cores, for Hopper (sm_90a). The counterpart of calling
// the reference's ethereum_consensus_tpu/ops/fq8.py:300 mont7r on a batch,
// as its tests do (tests/test_ops_pairing.py:233-305); its arithmetic
// (digits, the three mma.sync.m16n8k32 steps, the byte reduction) is
// fp_mma.h's, the same product that the mxu builds of pairing.cu and
// g1_sum.cu call for every Fp product.
//
// In and out: (n, 12) uint32 limbs, least significant first, Montgomery
// form with R = 2^384, canonical (below p); out = a * b * 2^-384 mod p.
//
// Design: one warp per product, kWarps products a block. Every thread of
// the warp loads the pair (the same addresses: one broadcast load), the
// warp computes the product together, and lane 0 stores it. What bounds it
// on an H100: the least work is 144 bytes a product (two operands read,
// one result written) at 3.35 TB/s, 0.045 ms at 2^20 products, above the
// 288 multiply-adds of one CIOS product at the card's integer rate; this
// kernel is bound instead by the byte reduction that each of the 32
// threads repeats on the CUDA cores (fp_mma.h), which a later design can
// split across the warp or send through a GEMM that shares p.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_mma.h"

namespace {

constexpr int kWarps = 4;

__device__ __forceinline__ fp381::Fp load_fp(const uint32_t* p) {
  const uint4* q = reinterpret_cast<const uint4*>(p);
  fp381::Fp r;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint4 v = __ldg(q + i);
    r.v[4 * i] = v.x;
    r.v[4 * i + 1] = v.y;
    r.v[4 * i + 2] = v.z;
    r.v[4 * i + 3] = v.w;
  }
  return r;
}

__global__ void __launch_bounds__(32 * kWarps)
    mont_mxu_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ b, int64_t n,
                    uint32_t* __restrict__ out) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (i >= n) return;  // the whole warp
  const fp381::Fp r = fp_mma::mont(load_fp(a + i * fp381::kLimbs), load_fp(b + i * fp381::kLimbs));
  if ((threadIdx.x & 31) == 0) {
    uint4* o = reinterpret_cast<uint4*>(out + i * fp381::kLimbs);
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      o[k] = make_uint4(r.v[4 * k], r.v[4 * k + 1], r.v[4 * k + 2], r.v[4 * k + 3]);
    }
  }
}

}  // namespace

// a, b, out: (n, 12) uint32, contiguous and 16-byte aligned on the current
// device; launches on `stream` and returns cudaGetLastError() (0 = launched).
extern "C" int mont_mxu_launch(const void* a, const void* b, int64_t n, void* out,
                               void* stream) {
  if (n <= 0 || n > (int64_t{1} << 32)) return static_cast<int>(cudaErrorInvalidValue);
  const int64_t blocks = (n + kWarps - 1) / kWarps;
  mont_mxu_kernel<<<static_cast<unsigned>(blocks), 32 * kWarps, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(a), static_cast<const uint32_t*>(b), n,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}
