// B8 as its parent design (tools/mxu_forms.py): one warp a product on
// tools/mxu_parent_fp_mma.h, every thread loading the pair and repeating
// the byte-round reduction, lane 0 storing. The same C interface as
// csrc/mont_mxu.cu, so the program's wrapper can launch it. Not part of
// the program.

#include <cuda_runtime.h>
#include <stdint.h>

#include "mxu_parent_fp_mma.h"

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
