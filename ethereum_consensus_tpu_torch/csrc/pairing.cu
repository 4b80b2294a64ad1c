// The device half of BLS12-381 RLC batch verification,
//     prod_i e([r_i] pk_i, H_i) * e(-G, sum_i [r_i] sig_i) == 1,
// for Hopper (sm_90a): four kernels over the field and tower of
// fp381_core.h and fp_tower.h, in this u64 build all four on the crews of
// pairing_lanes.h.
//
//   g1_mul_affine  replaces the reference's (ethereum_consensus_tpu
//                  ops/pairing.py) :316 _mul_scan_g1 (via :349
//                  g1_mul_batched) and :530 _g1_jacobian_to_affine:
//                  [r_i] pk_i for 128-bit blinders, MSB first, then affine.
//   g2_mul_sum     replaces :332 _mul_scan_g2 (via :354 g2_mul_batched)
//                  and :292 g2_sum_points -> :275 _g2_tree_reduce:
//                  sum_i [r_i] sig_i as one Jacobian point. A lanes pass
//                  writes each [r_i] sig_i; fold launches pair neighbours at
//                  strides 1, 2, 4, ... inside each 64-lane block with
//                  infinity past the last lane, then the block partials the
//                  same way (the reference's XOR-fold tree over its
//                  power-of-two padding, so the Jacobian sum agrees limb for
//                  limb); g2_sum_launch runs the fold alone over Jacobian
//                  points (the mesh twin's partials). The affine conversion
//                  stays on the host (the reference's :543 _g2_point_to_raw).
//   miller_loop    replaces :416 miller_loop_batched with :362
//                  _double_step, :387 _add_step and ops/fq12.py :134
//                  fp12_sqr, :150 fp12_mul_by_line, :145 fp12_conj:
//                  f_{|x|,Q_i}(P_i), conjugated, per lane.
//   fp12_product   replaces :474 fp12_product -> :454 _fp12_tree: the
//                  product of N Fq12 values, a tree inside each block, then
//                  launches over the block partials (exact: the order of a
//                  field product does not change its value).
//
// Values cross the boundary canonical (not Montgomery), 12 x 32-bit limbs,
// least significant first: G1 affine (x, y); G2 affine (x.c0, x.c1, y.c0,
// y.c1); G2 Jacobian (x, y, z) of Fp2, all zero for infinity; Fq12 as 12 Fp
// in the order c0.a0.c0, c0.a0.c1, ..., c1.a2.c1. Scalars are 4 words,
// least significant first.
//
// What bounds them on an H100: integer multiply-adds and, at the window's
// 528 lanes, latency. One Fp product is 288 32x32->64-bit multiply-adds;
// a lane's Miller loop makes 9,426 Fp products, its G2 blinder
// multiplication about 4,800 for a random 128-bit blinder, its G1 one about
// 1,900 (1.2 to 1.5 times the least work of each function, which
// chip_smoke.py's bounds count).
//
// The first design ran every kernel one thread per lane: at 528 lanes 17
// warps on 17 of the 132 SMs (g1_mul_affine, miller_loop) or 9 blocks of 64
// threads on 9 SMs (g2_mul_sum, lanes and fold in one kernel; fp12_product,
// whose fold kept half its threads idle at every level), each lane's
// thousands of products one dependent chain, and the tower's values passed
// through out-of-line calls (fp_tower.h's __noinline__ policy) in stack
// frames in local memory (ptxas: 4,000 bytes for the Miller kernel). The
// G1 lane ended in a Fermat inversion: 380 dependent squarings, about a
// quarter of its chain.
//
// Every u64 kernel now runs on crews (pairing_lanes.h): a lane's values in
// shared memory, its work split into steps of independent products and
// linear sums, the products on the crew's threads, the crew synced between
// steps.
//   - miller_loop, g2_mul_sum's lanes pass and g1_mul_affine run a warp a
//     lane, 4 lanes a block: at 528 lanes 132 blocks, a warp on every
//     scheduler of every SM. A Miller doubling iteration is 4 product steps
//     (the widest 22 Fp2 products, each three Fp products on three threads);
//     g2_mul_sum's folds run 32 crews of 4 threads a block.
//   - g1_mul_affine works on Fp slots, one Fp product a thread: a doubling
//     is 3 product steps, the mixed addition (the base is affine) 4, each
//     product's operands short linear sums that the thread forms first. The
//     inverse of z is a binary extended Euclid on one thread (534 halvings
//     and 267 subtractions of 12 limbs on average, at most 762 halvings,
//     against the Fermat chain's 380 dependent squarings and 190 products,
//     each of 288 multiply-adds): variable time, which the batch allows,
//     since its inputs are public keys and blinders drawn after the sets
//     are fixed.
//   - fp12_product runs a warp a product of two values, 16 crews and 32
//     values a block: the Fq12 product is 18 Fp2 products (Karatsuba over
//     the w-halves of Karatsuba Fq6 products, 54 Fp products on the warp's
//     32 threads) between steps of linear sums, and each level of the
//     block's tree runs its pairs on as many warps. At the window's 529
//     values: 17 blocks, then one block over their partials, 10 levels.
// What still bounds them: the latency of one lane's steps (each a chain of
// Fp products on a thread, then the combine and the linear sums),
// __syncwarp between them, and the idle threads of narrow steps (G1's
// widest is 6 products of the warp's 32 threads); the work of 528 lanes
// keeps only four warps on each SM.

// Built with -DFP381_MUL_MXU (the "mxu" library, ops/fq8.py's switch), every
// Fp product is the warp-cooperative int8 tensor-core product of fp_mma.h
// (the reference's EC_PAIRING_MULT=mxu, fql.py:140 -> fq8.py:300 mont7r), so
// the kernels run one WARP per lane on the tower's functions: every thread
// of the warp holds the lane's values, takes the same branches (the
// blinders' bits, the special cases of the point additions: the same data
// in every thread) and calls each product together, and lane 0 stores. A
// warp whose lane is past n exits whole. G2's products and the sum are two
// passes: one warp per lane writes [r_i] sig_i, then the fold kernel folds
// the n points; the folds hold their 64 values a block, with 8 warps taking
// the pairs of each level in the same order, so the G2 sum agrees limb for
// limb with the u64 kernels' (the Fq12 product's value is unique, so the
// u64 fold's 32 values a block give the same limbs). What bounds this
// mapping: each product's chain of dependent steps (fp_mma.h: eight
// mma.sync steps and three carry passes split across the warp, with n' and
// p constant operands), which a warp of the lane waits on; at 528 lanes it
// fills 528 warps, four per SM.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

#include "fp_tower.h"
#ifndef FP381_MUL_MXU
#include "pairing_lanes.h"
#endif

namespace {

using fp381::Fp;
using fp381::G1Jac;
using fp381::kLimbs;
using tower::Fp12;
using tower::Fp2;
using tower::G2Jac;

constexpr int kTreeThreads = 64;  // the G2 fold's points a block (the mxu build's Fq12 values)
#ifdef FP381_MUL_MXU
constexpr int kLaneWarps = 4;                      // lanes (one a warp) a block
constexpr int kLanesPerBlock = kLaneWarps;
constexpr int kLaneBlockThreads = 32 * kLaneWarps;
constexpr int kTreeWarps = fp_mma::kMaxWarps;      // a fold block's warps (64 values)
constexpr int kTreeBlockThreads = 32 * kTreeWarps;
constexpr int kMillerLanes = kLanesPerBlock;
constexpr int kMillerBlockThreads = kLaneBlockThreads;
constexpr int kG2LanesPerBlock = kLanesPerBlock;
constexpr int kG2LaneBlockThreads = kLaneBlockThreads;
constexpr int kG2FoldThreads = kTreeBlockThreads;
constexpr size_t kG2FoldSmem = 0;
constexpr int kFp12FoldValues = kTreeThreads;
constexpr int kFp12FoldThreads = kTreeBlockThreads;
constexpr size_t kFp12FoldSmem = 0;
#else
constexpr int kG1Lanes = 4;  // g1_mul_affine: a warp a lane
constexpr int kG1BlockThreads = 32 * kG1Lanes;
constexpr int kMillerLanes = 4;  // a warp a lane
constexpr int kMillerBlockThreads = 32 * kMillerLanes;
constexpr int kG2LanesPerBlock = 4;  // a warp a lane
constexpr int kG2LaneBlockThreads = 32 * kG2LanesPerBlock;
constexpr int kG2FoldCrews = kTreeThreads / 2;  // the first level's pairs
constexpr int kG2FoldCrewThreads = lanes::kG2Width;  // a crew an addition
constexpr int kG2FoldThreads = kG2FoldCrews * kG2FoldCrewThreads;
constexpr size_t kG2FoldSmem =
    kG2FoldCrews * (lanes::kG2Slots * sizeof(Fp2) + 3 * lanes::kG2Width * sizeof(Fp));
constexpr int kFp12FoldCrews = 16;  // a warp a product
constexpr int kFp12FoldValues = 2 * kFp12FoldCrews;  // a fold block's values
constexpr int kFp12FoldThreads = 32 * kFp12FoldCrews;
constexpr size_t kFp12FoldSmem =
    kFp12FoldCrews * (lanes::fq12::kSlots * sizeof(Fp2) + 3 * lanes::kFp12Products * sizeof(Fp));
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
// the warp that stores a fold block's result
__device__ __forceinline__ bool block_leader() { return threadIdx.x < 32; }
#else
__device__ __forceinline__ bool storing_thread() { return true; }
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

#ifdef FP381_MUL_MXU
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

// points (n, 2, 12), scalars (n, 4) -> out (n, 2, 12) affine, a warp a lane
__global__ void __launch_bounds__(kLaneBlockThreads)
    g1_mul_affine_kernel(const uint32_t* __restrict__ points,
                         const uint32_t* __restrict__ scalars, int64_t n,
                         uint32_t* __restrict__ out) {
  const int64_t i = lane_index();
  if (i >= n) return;  // the whole warp
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
}

// The block's 64 values: load(i) for the items i < n of the block, the
// identity past n (one warp a value, lane 0 storing it).
template <typename T, typename Load>
__device__ void fill(T* s, int64_t n, Load load, const T& identity) {
#pragma unroll 1
  for (int v = threadIdx.x >> 5; v < kTreeThreads; v += kTreeWarps) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * kTreeThreads + v;
    const T x = i < n ? load(i) : identity;
    if (storing_thread()) s[v] = x;
  }
}

struct Fp12Mul {
  __device__ Fp12 operator()(const Fp12& a, const Fp12& b) const {
    return tower::fp12_mul(a, b);
  }
};

__device__ G2Jac load_g2_jac(const uint32_t* p) {
  return G2Jac{load_fp2(p), load_fp2(p + kFp2Words), load_fp2(p + 2 * kFp2Words)};
}

__device__ void store_g2_jac(uint32_t* p, const G2Jac& a) {
  store_fp2(p, a.x);
  store_fp2(p + kFp2Words, a.y);
  store_fp2(p + 2 * kFp2Words, a.z);
}

struct G2Add {
  __device__ G2Jac operator()(const G2Jac& a, const G2Jac& b) const { return tower::g2_add(a, b); }
};

// affine points (n, 2, 2, 12), scalars (n, 4) -> (n, 3, 2, 12) Jacobian
// [k_i] Q_i, one warp a lane (the first pass of the sum)
__global__ void __launch_bounds__(kLaneBlockThreads)
    g2_mul_lanes_kernel(const uint32_t* __restrict__ points,
                        const uint32_t* __restrict__ scalars, int64_t n,
                        uint32_t* __restrict__ lanes) {
  const int64_t i = lane_index();
  if (i >= n) return;  // the whole warp
  const uint32_t* p = points + i * 2 * kFp2Words;
  const G2Jac sig{load_fp2(p), load_fp2(p + kFp2Words), tower::fp2_one()};
  uint32_t k[tower::kScalarWords];
#pragma unroll
  for (int w = 0; w < tower::kScalarWords; ++w) k[w] = __ldg(scalars + i * tower::kScalarWords + w);
  store_g2_jac(lanes + i * kG2JacWords, tower::g2_mul(sig, k));
}

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
  if (i >= n) return;  // the whole warp
  const Fp12 f = tower::miller_loop(load_mont(xp + i * kLimbs), load_mont(yp + i * kLimbs),
                                    load_fp2(xq + i * kFp2Words), load_fp2(yq + i * kFp2Words));
  store_fp12(out + i * kFp12Words, f);
}

// Fq12 values (n, 12, 12) -> one partial product per 64 values
__global__ void __launch_bounds__(kTreeBlockThreads)
    fp12_fold_kernel(const uint32_t* __restrict__ values, int64_t n,
                     uint32_t* __restrict__ partials) {
  __shared__ Fp12 s[kTreeThreads];
  fill(s, n, [&](int64_t i) { return load_fp12(values + i * kFp12Words); }, tower::fp12_one());
  fold(s, Fp12Mul());
  if (block_leader()) store_fp12(partials + blockIdx.x * kFp12Words, s[0]);
}
#else
// Component k of the value in the Fp2 slots from first on: of a G2 point
// 0..5 (x.c0, x.c1, y.c0, y.c1, z.c0, z.c1), of an Fq12 value 0..11.
__device__ __forceinline__ Fp& component(Fp2* s, int first, int k) {
  Fp2& v = s[first + k / 2];
  return (k & 1) ? v.c1 : v.c0;
}

// points (n, 2, 12), scalars (n, 4) -> out (n, 2, 12) affine: a warp a
// lane, kG1Lanes lanes a block. The bound's 1 (a block an SM, as the
// window's 528 lanes run) lets ptxas keep the lane in registers: without
// it, 80 registers and 16 bytes spilled.
__global__ void __launch_bounds__(kG1BlockThreads, 1)
    g1_mul_affine_kernel(const uint32_t* __restrict__ points,
                         const uint32_t* __restrict__ scalars, int64_t n,
                         uint32_t* __restrict__ out) {
  __shared__ Fp slots[kG1Lanes][lanes::g1::kSlots];
  const int lane = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kG1Lanes + lane;
  if (i >= n) return;  // the whole warp
  Fp* s = slots[lane];
  if (t < 2) s[lanes::g1::PX + t] = load_mont(points + (i * 2 + t) * kLimbs);
  const uint32_t* k = scalars + i * tower::kScalarWords;
  const lanes::Scalar scalar{__ldg(k), __ldg(k + 1), __ldg(k + 2), __ldg(k + 3)};
  const lanes::FpCrew c{s, t, 32, 0xffffffffu};
  lanes::crew_sync(c);
  lanes::g1::mul_affine_crew(c, scalar);
  if (t < 2) store_canonical(out + (i * 2 + t) * kLimbs, s[lanes::g1::PX + t]);
}

// affine points (n, 2, 2, 12), scalars (n, 4) -> (n, 3, 2, 12) Jacobian
// [k_i] Q_i: a warp a lane, kG2LanesPerBlock lanes a block (the first pass
// of the sum)
__global__ void __launch_bounds__(kG2LaneBlockThreads)
    g2_mul_lanes_kernel(const uint32_t* __restrict__ points,
                        const uint32_t* __restrict__ scalars, int64_t n,
                        uint32_t* __restrict__ lanes_out) {
  __shared__ Fp2 slots[kG2LanesPerBlock][lanes::kG2Slots];
  __shared__ Fp scratch[kG2LanesPerBlock][3 * lanes::kG2Width];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kG2LanesPerBlock + warp;
  if (i >= n) return;  // the whole warp
  Fp2* s = slots[warp];
  // q = (x, y, 1): x.c0, x.c1, y.c0, y.c1 one a thread
  if (t < 4) component(s, lanes::X2, t) = load_mont(points + i * 2 * kFp2Words + t * kLimbs);
  if (t == 4) s[lanes::Z2] = tower::fp2_one();
  const uint32_t* k = scalars + i * tower::kScalarWords;
  const lanes::Scalar scalar{__ldg(k), __ldg(k + 1), __ldg(k + 2), __ldg(k + 3)};
  const lanes::Crew c{s, scratch[warp], t, 32, 0xffffffffu};
  lanes::crew_sync(c);
  lanes::g2_crew(c, true, scalar);
  if (t < 6) store_canonical(lanes_out + i * kG2JacWords + t * kLimbs, component(s, lanes::X1, t));
}

// Jacobian points (n, 3, 2, 12) -> one partial sum per 64 points: crew g
// adds points 2g and 2g + 1 of the block (infinity past n), then at point
// stride s = 2, 4, ..., 32 the crews g at multiples of s add the partial of
// crew g + s/2 to their own.
__global__ void __launch_bounds__(kG2FoldThreads)
    g2_fold_kernel(const uint32_t* __restrict__ points, int64_t n,
                   uint32_t* __restrict__ partials) {
  extern __shared__ Fp2 fold_slots[];  // the crews' slots, then their scratch
  Fp* fold_scratch = &fold_slots[kG2FoldCrews * lanes::kG2Slots].c0;
  const int crew = threadIdx.x / kG2FoldCrewThreads;
  const int t = threadIdx.x % kG2FoldCrewThreads;
  const lanes::Crew c{fold_slots + crew * lanes::kG2Slots, fold_scratch + crew * 3 * lanes::kG2Width, t,
                      kG2FoldCrewThreads,
                      ((1u << kG2FoldCrewThreads) - 1) << (threadIdx.x & 31 & ~(kG2FoldCrewThreads - 1))};
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kTreeThreads + 2 * crew;
  for (int f = t; f < 12; f += kG2FoldCrewThreads) {  // p's six components, then q's
    const int64_t j = first + f / 6;
    component(c.s, f < 6 ? lanes::X1 : lanes::X2, f % 6) =
        j < n ? load_mont(points + j * kG2JacWords + (f % 6) * kLimbs) : fp381::zero();
  }
#pragma unroll 1
  for (int stride = 1; stride < kTreeThreads; stride <<= 1) {
    if (stride > 1) __syncthreads();
    if (crew % stride != 0) continue;
    if (stride > 1) {
      const Fp2* partner = fold_slots + (crew + stride / 2) * lanes::kG2Slots;
      for (int f = t; f < 3; f += kG2FoldCrewThreads) c.s[lanes::X2 + f] = partner[lanes::X1 + f];
    }
    lanes::crew_sync(c);
    lanes::g2_crew(c, false, lanes::Scalar{});
  }
  __syncthreads();
  if (crew != 0) return;
  for (int f = t; f < 6; f += kG2FoldCrewThreads)
    store_canonical(partials + blockIdx.x * kG2JacWords + f * kLimbs, component(c.s, lanes::X1, f));
}

// G1 affine xp, yp (n, 12) and G2 affine xq, yq (n, 2, 12) -> (n, 12, 12):
// a warp a lane, kMillerLanes lanes a block
__global__ void __launch_bounds__(kMillerBlockThreads)
    miller_loop_kernel(const uint32_t* __restrict__ xp, const uint32_t* __restrict__ yp,
                       const uint32_t* __restrict__ xq, const uint32_t* __restrict__ yq,
                       int64_t n, uint32_t* __restrict__ out) {
  __shared__ Fp2 slots[kMillerLanes][lanes::kMillerSlots];
  __shared__ Fp scratch[kMillerLanes][3 * lanes::kMillerThreads];
  const int warp = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kMillerLanes + warp;
  if (i >= n) return;  // the whole warp
  Fp2* s = slots[warp];
  if (t < 2) {  // P: (xp, 0), (yp, 0)
    s[lanes::XP + t] = Fp2{load_mont((t == 0 ? xp : yp) + i * kLimbs), fp381::zero()};
  } else if (t < 6) {  // Q and T = (xq, yq, 1)
    const Fp v = load_mont((t < 4 ? xq : yq) + i * kFp2Words + (t & 1) * kLimbs);
    component(s, lanes::QX, t - 2) = v;
    component(s, lanes::TX, t - 2) = v;
  } else if (t < 12) {  // f = 1
    s[lanes::F0 + t - 6] = t == 6 ? tower::fp2_one() : tower::fp2_zero();
  } else if (t == 12) {
    s[lanes::TZ] = tower::fp2_one();
  }
  __syncwarp();
  lanes::miller_crew(lanes::Crew{s, scratch[warp], t, 32, 0xffffffffu});
  if (t < 12) {  // conjugated: c1 negated
    const Fp v = component(s, lanes::F0 + 3 * (t / 6), t % 6);
    store_canonical(out + i * kFp12Words + t * kLimbs, t < 6 ? v : tower::fp_neg(v));
  }
}

// Fq12 values (n, 12, 12) -> one partial product per kFp12FoldValues: crew
// g multiplies values 2g and 2g + 1 of the block, then at stride s = 2, 4,
// ..., 16 the crews g at multiples of s multiply their product by that of
// crew g + s/2. Past n the values are one: a crew whose partner starts past
// n keeps its product.
__global__ void __launch_bounds__(kFp12FoldThreads, 1)
    fp12_fold_kernel(const uint32_t* __restrict__ values, int64_t n,
                     uint32_t* __restrict__ partials) {
  using namespace lanes::fq12;
  extern __shared__ Fp2 fold_slots[];  // the crews' slots, then their scratch
  Fp* fold_scratch = &fold_slots[kFp12FoldCrews * kSlots].c0;
  const int crew = threadIdx.x >> 5;
  const int t = threadIdx.x & 31;
  const lanes::Crew c{fold_slots + crew * kSlots, fold_scratch + crew * 3 * lanes::kFp12Products, t,
                      32, 0xffffffffu};
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kFp12FoldValues + 2 * crew;
  if (t < 24) {  // the pair's 24 Fp: a into FA, b into FB
    const int64_t j = first + t / 12;
    const int f = t % 12;
    component(c.s, FA0, t) = j < n ? load_mont(values + j * kFp12Words + f * kLimbs)
                             : f == 0 ? fp381::one_mont()
                                      : fp381::zero();
  }
#pragma unroll 1
  for (int stride = 1; stride <= kFp12FoldCrews; stride <<= 1) {
    if (stride > 1) __syncthreads();
    // the partner's first value: this crew's second, then crew g + s/2's
    if (crew % stride != 0 || first + stride >= n) continue;
    if (stride > 1) {
      const Fp2* partner = fold_slots + (crew + stride / 2) * kSlots;
      if (t < 6) c.s[FB0 + t] = partner[FA0 + t];
    }
    lanes::crew_sync(c);
    lanes::fq12::mul_crew(c);
  }
  if (crew != 0) return;
  if (t < 12) store_canonical(partials + blockIdx.x * kFp12Words + t * kLimbs, component(c.s, FA0, t));
}
#endif

int64_t blocks_for(int64_t n, int threads) { return (n + threads - 1) / threads; }

bool bad_count(int64_t n) { return n <= 0 || n > (int64_t{1} << 30); }

using FoldKernel = void (*)(const uint32_t*, int64_t, uint32_t*);

constexpr int kMaxDevices = 64;

// Opts a fold kernel in to its `smem` bytes of dynamic shared memory (above
// 48 KB it must), once for each device (`ready`, one flag a device): 0, or
// -cudaError.
int fold_opt_in(FoldKernel kernel, size_t smem, std::atomic<bool>* ready) {
  if (smem == 0) return 0;
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return -static_cast<int>(err);
  const bool cached = device >= 0 && device < kMaxDevices;
  if (cached && ready[device].load(std::memory_order_acquire)) return 0;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return -static_cast<int>(err);
  if (cached) ready[device].store(true, std::memory_order_release);
  return 0;
}

int g2_fold_opt_in() {
  static std::atomic<bool> ready[kMaxDevices];
  return fold_opt_in(g2_fold_kernel, kG2FoldSmem, ready);
}

int fp12_fold_opt_in() {
  static std::atomic<bool> ready[kMaxDevices];
  return fold_opt_in(fp12_fold_kernel, kFp12FoldSmem, ready);
}

// One launch of a fold kernel over `count` items: -cudaError if refused, else 0.
int launch_fold(FoldKernel kernel, int threads, size_t smem, int64_t blocks, const uint32_t* src,
                int64_t count, uint32_t* dst, cudaStream_t stream) {
  kernel<<<static_cast<unsigned>(blocks), threads, smem, stream>>>(src, count, dst);
  const cudaError_t err = cudaGetLastError();
  return err == cudaSuccess ? 0 : -static_cast<int>(err);
}

// Folds `count` items of `words` words at `src` with `kernel`, `per_block`
// items a block, until one is left, which lands in `out`; the levels between
// use `work`. Returns the number of grid launches, or -cudaError of a
// refused one.
int fold_levels(FoldKernel kernel, int threads, size_t smem, int per_block, const uint32_t* src,
                int64_t count, int words, uint32_t* work, uint32_t* out, cudaStream_t stream) {
  int launches = 0;
  while (count > 1) {
    const int64_t blocks = blocks_for(count, per_block);
    uint32_t* dst = blocks == 1 ? out : work;
    const int rc = launch_fold(kernel, threads, smem, blocks, src, count, dst, stream);
    if (rc < 0) return rc;
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
#ifdef FP381_MUL_MXU
  g1_mul_affine_kernel<<<static_cast<unsigned>(blocks_for(n, kLanesPerBlock)), kLaneBlockThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(points), static_cast<const uint32_t*>(scalars), n,
      static_cast<uint32_t*>(out));
#else
  g1_mul_affine_kernel<<<static_cast<unsigned>(blocks_for(n, kG1Lanes)), kG1BlockThreads, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(points), static_cast<const uint32_t*>(scalars), n,
      static_cast<uint32_t*>(out));
#endif
  return launched_once();
}

// points (n, 2, 2, 12), scalars (n, 4) -> out (3, 2, 12); work holds the
// n lanes' points and the fold's levels (ops/pairing.py g2_mul_sum_cuda)
extern "C" int g2_mul_sum_launch(const void* points, const void* scalars, int64_t n, void* work,
                                 void* out, void* stream) {
  if (bad_count(n)) return kBadCount;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // the lanes' products into work (out for one lane), then their fold
  uint32_t* lane_points = n == 1 ? static_cast<uint32_t*>(out) : static_cast<uint32_t*>(work);
  g2_mul_lanes_kernel<<<static_cast<unsigned>(blocks_for(n, kG2LanesPerBlock)),
                        kG2LaneBlockThreads, 0, s>>>(static_cast<const uint32_t*>(points),
                                                     static_cast<const uint32_t*>(scalars), n,
                                                     lane_points);
  const int lanes_rc = launched_once();
  if (lanes_rc < 0 || n == 1) return lanes_rc;
  const int opt_in = g2_fold_opt_in();
  if (opt_in < 0) return opt_in;
  const int lane_folds = fold_levels(g2_fold_kernel, kG2FoldThreads, kG2FoldSmem, kTreeThreads,
                                     lane_points, n, kG2JacWords, lane_points + n * kG2JacWords,
                                     static_cast<uint32_t*>(out), s);
  return lane_folds < 0 ? lane_folds : lanes_rc + lane_folds;
}

// Jacobian points (n, 3, 2, 12) -> out (3, 2, 12), their sum by the fold of
// g2_mul_sum (the reference's g2_sum_points, which folds the mesh twin's
// per-shard partials); work holds the fold's levels (ops/pairing.py
// g2_sum_points_cuda)
extern "C" int g2_sum_launch(const void* points, int64_t n, void* work, void* out, void* stream) {
  if (bad_count(n)) return kBadCount;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int opt_in = g2_fold_opt_in();
  if (opt_in < 0) return opt_in;
  if (n == 1) {  // one point: the fold of one block (a Montgomery round trip)
    const int rc = launch_fold(g2_fold_kernel, kG2FoldThreads, kG2FoldSmem, 1,
                               static_cast<const uint32_t*>(points), 1,
                               static_cast<uint32_t*>(out), s);
    return rc < 0 ? rc : 1;
  }
  return fold_levels(g2_fold_kernel, kG2FoldThreads, kG2FoldSmem, kTreeThreads,
                     static_cast<const uint32_t*>(points), n, kG2JacWords,
                     static_cast<uint32_t*>(work), static_cast<uint32_t*>(out), s);
}

// xp, yp (n, 12), xq, yq (n, 2, 12) -> out (n, 12, 12)
extern "C" int miller_loop_launch(const void* xp, const void* yp, const void* xq, const void* yq,
                                  int64_t n, void* out, void* stream) {
  if (bad_count(n)) return kBadCount;
  miller_loop_kernel<<<static_cast<unsigned>(blocks_for(n, kMillerLanes)), kMillerBlockThreads, 0,
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
  const int opt_in = fp12_fold_opt_in();
  if (opt_in < 0) return opt_in;
  if (n == 1) {  // one value: the fold of one block (a Montgomery round trip)
    const int rc = launch_fold(fp12_fold_kernel, kFp12FoldThreads, kFp12FoldSmem, 1,
                               static_cast<const uint32_t*>(values), 1,
                               static_cast<uint32_t*>(out), s);
    return rc < 0 ? rc : 1;
  }
  return fold_levels(fp12_fold_kernel, kFp12FoldThreads, kFp12FoldSmem, kFp12FoldValues,
                     static_cast<const uint32_t*>(values), n, kFp12Words,
                     static_cast<uint32_t*>(work), static_cast<uint32_t*>(out), s);
}
