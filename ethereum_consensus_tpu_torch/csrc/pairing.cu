// The device half of BLS12-381 RLC batch verification,
//     prod_i e([r_i] pk_i, H_i) * e(-G, sum_i [r_i] sig_i) == 1,
// for Hopper (sm_90a): four kernels, each one thread per lane, over the
// field and tower of fp381_core.h and fp_tower.h.
//
//   g1_mul_affine  replaces the reference's (ethereum_consensus_tpu
//                  ops/pairing.py) :316 _mul_scan_g1 (via :349
//                  g1_mul_batched) and :530 _g1_jacobian_to_affine:
//                  [r_i] pk_i for 128-bit blinders, MSB first, on the
//                  Jacobian formulas of fp381_core.h (those of g1_sum.cu),
//                  then affine through one Fermat inversion per lane.
//   g2_mul_sum     replaces :332 _mul_scan_g2 (via :354 g2_mul_batched)
//                  and :292 g2_sum_points -> :275 _g2_tree_reduce:
//                  sum_i [r_i] sig_i as one Jacobian point. Each block's
//                  lanes multiply, then fold pairwise in shared memory;
//                  further launches fold the block partials the same way;
//                  g2_sum_launch runs that fold alone over Jacobian points.
//                  The fold pairs neighbours at strides 1, 2, 4, ... with
//                  infinity past the last lane: the reference's XOR-fold
//                  tree over its power-of-two padding, so the Jacobian sum
//                  agrees limb for limb. The affine conversion stays on the
//                  host (the reference's :543 _g2_point_to_raw).
//   miller_loop    replaces :416 miller_loop_batched with :362
//                  _double_step, :387 _add_step and ops/fq12.py :134
//                  fp12_sqr, :150 fp12_mul_by_line, :145 fp12_conj:
//                  f_{|x|,Q_i}(P_i), conjugated, per lane.
//   fp12_product   replaces :474 fp12_product -> :454 _fp12_tree: the
//                  product of N Fq12 values, a per-block tree, then
//                  launches over the partials (exact: the order of a field
//                  product does not change its value).
//
// Values cross the boundary canonical (not Montgomery), 12 x 32-bit limbs,
// least significant first: G1 affine (x, y); G2 affine (x.c0, x.c1, y.c0,
// y.c1); G2 Jacobian (x, y, z) of Fp2, all zero for infinity; Fq12 as 12 Fp
// in the order c0.a0.c0, c0.a0.c1, ..., c1.a2.c1. Scalars are 4 words,
// least significant first.
//
// What bounds them on an H100: integer multiply-adds. One Fp product is 288
// 32x32->64-bit multiply-adds (144 for the product, 144 for the Montgomery
// reduction); these kernels square with the general product, and a lane's
// Miller loop makes 9,426 Fp products, its G2 blinder multiplication about
// 4,800 for a random 128-bit blinder, its G1 one about 1,900 and the affine
// conversion 612 (1.2 to 1.5 times the least work of each function, which
// chip_smoke.py's bounds count). At the window's shape (528 lanes)
// one thread per lane fills 17 warps (g1_mul_affine, miller_loop) or 9
// blocks of 64 threads (g2_mul_sum) on 132 SMs: the card is mostly idle and
// each lane's products form one dependent chain, so these simple kernels
// are bound by latency far above the operation bound. Each lane carries f
// (144 words), T (72) and the inputs through a call tree that stays rolled
// and out of line (fp_tower.h): the tower's values pass through the stack
// frames in local memory (ptxas: 4,000 bytes for the Miller kernel) and
// builds take about 90 s instead of many minutes. The folds keep one point
// or Fq12 per thread in shared memory (18 and 36 KB per block).
//
// Built with -DFP381_MUL_MXU (the "mxu" library, ops/fq8.py's switch), every
// Fp product is the warp-cooperative int8 tensor-core product of fp_mma.h
// (the reference's EC_PAIRING_MULT=mxu, fql.py:140 -> fq8.py:300 mont7r), so
// the kernels run one WARP per lane: every thread of the warp holds the
// lane's values, takes the same branches (the blinders' bits, the special
// cases of the point additions: the same data in every thread) and calls
// each product together, and lane 0 stores. A warp whose lane is past n
// exits whole. G2's products and the sum become two passes: one warp per
// lane writes [r_i] sig_i, then the fold kernel folds the n points; the
// folds hold their 64 values a block as before, with 8 warps taking the
// pairs of each level in the same order, so the G2 sum and the Fq12 product
// agree limb for limb with the u64 kernels'. What bounds this mapping: each
// product's byte reduction, which all 32 threads repeat (fp_mma.h); at 528
// lanes it fills 528 warps, four per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fp_tower.h"

namespace {

using fp381::Fp;
using fp381::G1Jac;
using fp381::kLimbs;
using tower::Fp12;
using tower::Fp2;
using tower::G2Jac;

constexpr int kTreeThreads = 64;  // g2_mul_sum and fp12_product: lanes, then the fold
#ifdef FP381_MUL_MXU
constexpr int kLaneWarps = 4;                      // lanes (one a warp) a block
constexpr int kLanesPerBlock = kLaneWarps;
constexpr int kLaneBlockThreads = 32 * kLaneWarps;
constexpr int kTreeWarps = fp_mma::kMaxWarps;      // a fold block's warps (64 values)
constexpr int kTreeBlockThreads = 32 * kTreeWarps;
#else
constexpr int kLaneThreads = 32;  // g1_mul_affine and miller_loop
constexpr int kLanesPerBlock = kLaneThreads;
constexpr int kLaneBlockThreads = kLaneThreads;
constexpr int kTreeBlockThreads = kTreeThreads;
#endif
constexpr int kFp2Words = 2 * kLimbs;
constexpr int kG2JacWords = 3 * kFp2Words;
constexpr int kFp12Words = 6 * kFp2Words;

#ifdef FP381_MUL_MXU
// a warp per lane: warp w of the block
__device__ __forceinline__ int64_t lane_index() {
  return static_cast<int64_t>(blockIdx.x) * kLaneWarps + (threadIdx.x >> 5);
}
__device__ __forceinline__ bool storing_thread() { return (threadIdx.x & 31) == 0; }
// the thread or warp that stores a fold block's result
__device__ __forceinline__ bool block_leader() { return threadIdx.x < 32; }
#else
__device__ __forceinline__ int64_t lane_index() {
  return static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
}
__device__ __forceinline__ bool storing_thread() { return true; }
__device__ __forceinline__ bool block_leader() { return threadIdx.x == 0; }
#endif

__device__ __forceinline__ Fp load_mont(const uint32_t* p) {
  Fp r;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) r.v[i] = __ldg(p + i);
  return fp381::to_mont(r);
}

__device__ __forceinline__ void store_canonical(uint32_t* p, const Fp& a) {
  const Fp c = fp381::from_mont(a);
  if (!storing_thread()) return;
#pragma unroll
  for (int i = 0; i < kLimbs; ++i) p[i] = c.v[i];
}

__device__ __forceinline__ Fp2 load_fp2(const uint32_t* p) {
  return Fp2{load_mont(p), load_mont(p + kLimbs)};
}

__device__ __forceinline__ void store_fp2(uint32_t* p, const Fp2& a) {
  store_canonical(p, a.c0);
  store_canonical(p + kLimbs, a.c1);
}

__device__ G2Jac load_g2_jac(const uint32_t* p) {
  return G2Jac{load_fp2(p), load_fp2(p + kFp2Words), load_fp2(p + 2 * kFp2Words)};
}

__device__ void store_g2_jac(uint32_t* p, const G2Jac& a) {
  store_fp2(p, a.x);
  store_fp2(p + kFp2Words, a.y);
  store_fp2(p + 2 * kFp2Words, a.z);
}

__device__ Fp12 load_fp12(const uint32_t* p) {
  Fp12 r;
  r.c0 = tower::Fp6{load_fp2(p), load_fp2(p + kFp2Words), load_fp2(p + 2 * kFp2Words)};
  p += 3 * kFp2Words;
  r.c1 = tower::Fp6{load_fp2(p), load_fp2(p + kFp2Words), load_fp2(p + 2 * kFp2Words)};
  return r;
}

__device__ void store_fp12(uint32_t* p, const Fp12& a) {
  store_fp2(p, a.c0.a0);
  store_fp2(p + kFp2Words, a.c0.a1);
  store_fp2(p + 2 * kFp2Words, a.c0.a2);
  p += 3 * kFp2Words;
  store_fp2(p, a.c1.a0);
  store_fp2(p + kFp2Words, a.c1.a1);
  store_fp2(p + 2 * kFp2Words, a.c1.a2);
}

// points (n, 2, 12), scalars (n, 4) -> out (n, 2, 12) affine
__global__ void __launch_bounds__(kLaneBlockThreads)
    g1_mul_affine_kernel(const uint32_t* __restrict__ points,
                         const uint32_t* __restrict__ scalars, int64_t n,
                         uint32_t* __restrict__ out) {
  const int64_t i = lane_index();
  if (i >= n) return;  // under mxu the whole warp
  const uint32_t* p = points + i * 2 * kLimbs;
  const G1Jac pk{load_mont(p), load_mont(p + kLimbs), fp381::one_mont()};
  uint32_t k[tower::kScalarWords];
#pragma unroll
  for (int w = 0; w < tower::kScalarWords; ++w) k[w] = __ldg(scalars + i * tower::kScalarWords + w);
  const G1Jac acc = tower::g1_mul(pk, k);
  const Fp z_inv = tower::fp_inv(acc.z);
  const Fp z_inv2 = fp381::sqr(z_inv);
  uint32_t* o = out + i * 2 * kLimbs;
  store_canonical(o, fp381::mul(acc.x, z_inv2));
  store_canonical(o + kLimbs, fp381::mul(acc.y, fp381::mul(z_inv2, z_inv)));
}

// Pairwise fold of the block's values at strides 1, 2, 4, ...: lane t (a
// multiple of 2s) takes op(own, lane t + s), the reference's argument
// order. Leaves the block's result in s[0].
template <typename T, typename Op>
__device__ void fold(T* s, Op op) {
#ifdef FP381_MUL_MXU
  // warp w takes the pairs w, w + 8, ... of each level; values are copied
  // out before the product and stored by lane 0 after the warp has read them
  const int warp = threadIdx.x >> 5;
#pragma unroll 1
  for (int stride = 1; stride < kTreeThreads; stride <<= 1) {
    __syncthreads();
#pragma unroll 1
    for (int t = 2 * stride * warp; t < kTreeThreads; t += 2 * stride * kTreeWarps) {
      const T a = s[t];
      const T b = s[t + stride];
      const T r = op(a, b);
      __syncwarp();
      if (storing_thread()) s[t] = r;
    }
  }
  __syncthreads();
#else
  const int tid = threadIdx.x;
#pragma unroll 1
  for (int stride = 1; stride < kTreeThreads; stride <<= 1) {
    __syncthreads();
    if ((tid & (2 * stride - 1)) == 0) s[tid] = op(s[tid], s[tid + stride]);
  }
  __syncthreads();
#endif
}

// The block's 64 values: load(i) for the items i < n of the block, the
// identity past n (under mxu one warp a value, lane 0 storing it).
template <typename T, typename Load>
__device__ void fill(T* s, int64_t n, Load load, const T& identity) {
#ifdef FP381_MUL_MXU
#pragma unroll 1
  for (int v = threadIdx.x >> 5; v < kTreeThreads; v += kTreeWarps) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kTreeThreads + v;
    const T x = i < n ? load(i) : identity;
    if (storing_thread()) s[v] = x;
  }
#else
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTreeThreads + threadIdx.x;
  s[threadIdx.x] = i < n ? load(i) : identity;
#endif
}

struct G2Add {
  __device__ G2Jac operator()(const G2Jac& a, const G2Jac& b) const { return tower::g2_add(a, b); }
};

struct Fp12Mul {
  __device__ Fp12 operator()(const Fp12& a, const Fp12& b) const {
    return tower::fp12_mul(a, b);
  }
};

__device__ __forceinline__ G2Jac g2_mul_lane(const uint32_t* points, const uint32_t* scalars,
                                           int64_t i) {
  const uint32_t* p = points + i * 2 * kFp2Words;
  const G2Jac sig{load_fp2(p), load_fp2(p + kFp2Words), tower::fp2_one()};
  uint32_t k[tower::kScalarWords];
#pragma unroll
  for (int w = 0; w < tower::kScalarWords; ++w) k[w] = __ldg(scalars + i * tower::kScalarWords + w);
  return tower::g2_mul(sig, k);
}

#ifdef FP381_MUL_MXU
// affine points (n, 2, 2, 12), scalars (n, 4) -> (n, 3, 2, 12) Jacobian
// [k_i] Q_i, one warp a lane (the first pass of the sum)
__global__ void __launch_bounds__(kLaneBlockThreads)
    g2_mul_lanes_kernel(const uint32_t* __restrict__ points,
                        const uint32_t* __restrict__ scalars, int64_t n,
                        uint32_t* __restrict__ lanes) {
  const int64_t i = lane_index();
  if (i >= n) return;  // the whole warp
  store_g2_jac(lanes + i * kG2JacWords, g2_mul_lane(points, scalars, i));
}
#else
// affine points (n, 2, 2, 12), scalars (n, 4) -> one Jacobian partial sum
// (3, 2, 12) per block
__global__ void __launch_bounds__(kTreeThreads)
    g2_mul_fold_kernel(const uint32_t* __restrict__ points,
                       const uint32_t* __restrict__ scalars, int64_t n,
                       uint32_t* __restrict__ partials) {
  __shared__ G2Jac s[kTreeThreads];
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kTreeThreads + threadIdx.x;
  s[threadIdx.x] = i < n ? g2_mul_lane(points, scalars, i) : tower::g2_infinity();
  fold(s, G2Add());
  if (threadIdx.x == 0) store_g2_jac(partials + blockIdx.x * kG2JacWords, s[0]);
}
#endif

// Jacobian points (n, 3, 2, 12) -> one partial sum per block
__global__ void __launch_bounds__(kTreeBlockThreads)
    g2_fold_kernel(const uint32_t* __restrict__ points, int64_t n,
                   uint32_t* __restrict__ partials) {
  __shared__ G2Jac s[kTreeThreads];
  fill(s, n, [&](int64_t i) { return load_g2_jac(points + i * kG2JacWords); },
       tower::g2_infinity());
  fold(s, G2Add());
  if (block_leader()) store_g2_jac(partials + blockIdx.x * kG2JacWords, s[0]);
}

// G1 affine xp, yp (n, 12) and G2 affine xq, yq (n, 2, 12) -> (n, 12, 12)
__global__ void __launch_bounds__(kLaneBlockThreads)
    miller_loop_kernel(const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
                       const uint32_t* __restrict__ xq, const uint32_t* __restrict__ yq,
                       int64_t n, uint32_t* __restrict__ out) {
  const int64_t i = lane_index();
  if (i >= n) return;  // under mxu the whole warp
  const Fp12 f = tower::miller_loop(load_mont(xp + i * kLimbs), load_mont(yp + i * kLimbs),
                                    load_fp2(xq + i * kFp2Words), load_fp2(yq + i * kFp2Words));
  store_fp12(out + i * kFp12Words, f);
}

// Fq12 values (n, 12, 12) -> one partial product per block
__global__ void __launch_bounds__(kTreeBlockThreads)
    fp12_fold_kernel(const uint32_t* __restrict__ values, int64_t n,
                     uint32_t* __restrict__ partials) {
  __shared__ Fp12 s[kTreeThreads];
  fill(s, n, [&](int64_t i) { return load_fp12(values + i * kFp12Words); }, tower::fp12_one());
  fold(s, Fp12Mul());
  if (block_leader()) store_fp12(partials + blockIdx.x * kFp12Words, s[0]);
}

int64_t blocks_for(int64_t n, int threads) { return (n + threads - 1) / threads; }

bool bad_count(int64_t n) { return n <= 0 || n > (int64_t{1} << 30); }

// Folds `count` items of `words` words at `src` with `kernel` until one is
// left, which lands in `out`; the levels between use `work`. Returns the
// number of grid launches, or -cudaError of a refused one.
using FoldKernel = void (*)(const uint32_t*, int64_t, uint32_t*);

int fold_levels(FoldKernel kernel, const uint32_t* src, int64_t count, int words, uint32_t* work,
                uint32_t* out, cudaStream_t stream) {
  int launches = 0;
  while (count > 1) {
    const int64_t blocks = blocks_for(count, kTreeThreads);
    uint32_t* dst = blocks == 1 ? out : work;
    kernel<<<static_cast<unsigned>(blocks), kTreeBlockThreads, 0, stream>>>(src, count, dst);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return -static_cast<int>(err);
    ++launches;
    src = dst;
    work += blocks * words;
    count = blocks;
  }
  return launches;
}

// The count of one grid launch, or -cudaError if it was refused.
int launched_once() {
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 1 : -static_cast<int>(err);
}

constexpr int kBadCount = -static_cast<int>(cudaErrorInvalidValue);

}  // namespace

// Each entry takes contiguous tensors on the current device, launches on
// `stream` and returns the number of grid launches it made (> 0), or
// -cudaError of the launch that was refused.

// points (n, 2, 12), scalars (n, 4) -> out (n, 2, 12)
extern "C" int g1_mul_affine_launch(const void* points, const void* scalars, int64_t n,
                                    void* out, void* stream) {
  if (bad_count(n)) return kBadCount;
  g1_mul_affine_kernel<<<static_cast<unsigned>(blocks_for(n, kLanesPerBlock)), kLaneBlockThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(points), static_cast<const uint32_t*>(scalars), n,
      static_cast<uint32_t*>(out));
  return launched_once();
}

// points (n, 2, 2, 12), scalars (n, 4) -> out (3, 2, 12); work holds the
// block partials and the fold's levels (ops/pairing.py g2_mul_sum_cuda),
// under mxu the n lanes' points before them
extern "C" int g2_mul_sum_launch(const void* points, const void* scalars, int64_t n, void* work,
                                 void* out, void* stream) {
  if (bad_count(n)) return kBadCount;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
#ifdef FP381_MUL_MXU
  // the lanes' products into work (out for one lane), then their fold
  uint32_t* lanes = n == 1 ? static_cast<uint32_t*>(out) : static_cast<uint32_t*>(work);
  g2_mul_lanes_kernel<<<static_cast<unsigned>(blocks_for(n, kLanesPerBlock)), kLaneBlockThreads,
                        0, s>>>(static_cast<const uint32_t*>(points),
                                static_cast<const uint32_t*>(scalars), n, lanes);
  const int lanes_rc = launched_once();
  if (lanes_rc < 0 || n == 1) return lanes_rc;
  const int lane_folds = fold_levels(g2_fold_kernel, lanes, n, kG2JacWords,
                                     lanes + n * kG2JacWords, static_cast<uint32_t*>(out), s);
  return lane_folds < 0 ? lane_folds : lanes_rc + lane_folds;
#else
  const int64_t blocks = blocks_for(n, kTreeThreads);
  uint32_t* first = blocks == 1 ? static_cast<uint32_t*>(out) : static_cast<uint32_t*>(work);
  g2_mul_fold_kernel<<<static_cast<unsigned>(blocks), kTreeThreads, 0, s>>>(
      static_cast<const uint32_t*>(points), static_cast<const uint32_t*>(scalars), n, first);
  const int rc = launched_once();
  if (rc < 0 || blocks == 1) return rc;
  const int folds = fold_levels(g2_fold_kernel, first, blocks, kG2JacWords,
                                first + blocks * kG2JacWords, static_cast<uint32_t*>(out), s);
  return folds < 0 ? folds : rc + folds;
#endif
}

// Jacobian points (n, 3, 2, 12) -> out (3, 2, 12), their sum by the fold of
// g2_mul_sum (the reference's g2_sum_points, which folds the mesh twin's
// per-shard partials); work holds the fold's levels (ops/pairing.py
// g2_sum_points_cuda)
extern "C" int g2_sum_launch(const void* points, int64_t n, void* work, void* out, void* stream) {
  if (bad_count(n)) return kBadCount;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 1) {  // one point: the fold of one block (a Montgomery round trip)
    g2_fold_kernel<<<1, kTreeBlockThreads, 0, s>>>(static_cast<const uint32_t*>(points), 1,
                                              static_cast<uint32_t*>(out));
    return launched_once();
  }
  return fold_levels(g2_fold_kernel, static_cast<const uint32_t*>(points), n, kG2JacWords,
                     static_cast<uint32_t*>(work), static_cast<uint32_t*>(out), s);
}

// xp, yp (n, 12), xq, yq (n, 2, 12) -> out (n, 12, 12)
extern "C" int miller_loop_launch(const void* xp, const void* yp, const void* xq, const void* yq,
                                  int64_t n, void* out, void* stream) {
  if (bad_count(n)) return kBadCount;
  miller_loop_kernel<<<static_cast<unsigned>(blocks_for(n, kLanesPerBlock)), kLaneBlockThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(xp), static_cast<const uint32_t*>(yp),
      static_cast<const uint32_t*>(xq), static_cast<const uint32_t*>(yq), n,
      static_cast<uint32_t*>(out));
  return launched_once();
}

// values (n, 12, 12) -> out (12, 12); work holds the fold's levels
// (ops/pairing.py fp12_product_cuda)
extern "C" int fp12_product_launch(const void* values, int64_t n, void* work, void* out,
                                   void* stream) {
  if (bad_count(n)) return kBadCount;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n == 1) {  // one value: the fold of one block (a Montgomery round trip)
    fp12_fold_kernel<<<1, kTreeBlockThreads, 0, s>>>(static_cast<const uint32_t*>(values), 1,
                                                static_cast<uint32_t*>(out));
    return launched_once();
  }
  return fold_levels(fp12_fold_kernel, static_cast<const uint32_t*>(values), n, kFp12Words,
                     static_cast<uint32_t*>(work), static_cast<uint32_t*>(out), s);
}
