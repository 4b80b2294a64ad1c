// The u64 build of g1_sum.cu (the G1 set sums) as crews of threads that
// share one lane, on the Fp slots of pairing_lanes.h (FpCrew, run_fp_steps:
// an op is one Fp product of two short linear sums, or one linear sum; one
// op a thread of the crew, the crew synced after each step).
//
// A set still has 128 lanes, and lane t still adds the keys offsets[s] + t,
// + 128, ... in turn, then the 128 sums fold in 7 levels, lane t taking
// lane t + 64, then t + 32, ..., then t + 1: the order of ops/g1.py
// g1_sum_sets_plain. What changed is where that work runs:
//
//   - a lane is a crew of kCrew = 4 threads, and each addition is a table of
//     steps of at most 4 independent products: a key's addition (the mixed
//     addition, 8M + 3S) is 5 product steps, a fold's (add-2007-bl, 12M +
//     4S) 5; the conversion of the next key to Montgomery form rides in the
//     mixed addition's first step, beside its two products;
//   - two launches: the chains, 32 lanes a block (4 blocks a set), each
//     lane's sum written to scratch; then the fold, a block of 64 crews a
//     set: crew c adds lanes c and c + 64, then the crews below 32, 16, ...,
//     1 add the next crews' sums, and crew 0 converts the result out of
//     Montgomery form;
//   - so the lanes of every set spread over the grid, and a chain's block
//     leaves as soon as its chains are done: no block holds its slots
//     through the fold's narrowing levels.
//
// The formulas are fp381_core.h's (g1_add, g1_double), regrouped only where
// the regrouping is exact: every value is fully reduced Montgomery, so a
// sum of the same values in another order, or a product by one dropped, is
// the same canonical value. The mixed addition is g1_add at z2 = 1 (z2z2 =
// 1, u1 = x1, s1 = y1, z1 z2 = z1), x3 = rr - hhh - 2v and v - x3 = 3v + hhh
// - rr; the doubling is dbl-2009-l with x3 = e^2 - 4 (x + b)^2 + 4a + 4c.
// g1_add's branches are the state machines' selects: a key at infinity is
// skipped, a sum at infinity takes the key (or the partner), h = 0 doubles
// (r = 0) or gives infinity (every coordinate zero).
//
// The header is plain C++ outside nvcc: the host version (sum_sets_host)
// runs each crew's ops one after another inside every step, the crews of a
// block one after another between the block's barriers, and the blocks in
// grid order, so g++ builds the kernel's schedule for the CPU tests
// (tests/test_torch_g1.py).

#pragma once

#include <stdint.h>

#ifndef __CUDA_ARCH__
#include <vector>
#endif

#include "pairing_lanes.h"

namespace g1sum {

using fp381::Fp;
using lanes::FpCrew;
using lanes::Op;

constexpr int kLanes = 128;                    // a set's lanes (ops/g1.py THREADS)
constexpr int kCrew = 4;                       // threads a lane
constexpr int kChainLanes = 32;                // lanes (crews) a chain block
constexpr int kFoldCrews = kLanes / 2;         // crews a fold block, one a set
constexpr int kWidth = 8;                      // ops a step at most
constexpr int kKeyWords = 2 * fp381::kLimbs;   // a raw key: x, then y
constexpr int kJacWords = 3 * fp381::kLimbs;   // a Jacobian point: x, y, z

enum Slot : int {
  X1, Y1, Z1,  // the lane's sum (Montgomery Jacobian); the fold's left operand
  X2, Y2, Z2,  // the fold's right operand (the partner lane's sum); the output
  KX, KY,      // the key being added (Montgomery, z = 1)
  NX, NY,      // the next key, converted beside the addition
  RX, RY,      // a raw key (canonical limbs) waiting for conversion
  CR2, CONE, CUNIT,  // R^2 (into Montgomery form), R (one), 1 (out of it)
  T0, T1, T2, T3, T4, T5, T6, T7, T8, T9, T10, T11, T12,
  kSlots,
  // the start: the second raw key
  QX = T0, QY = T1,
  // the mixed addition: zz = z1^2, yz = ky z1, u2 = kx zz, s2 = yz zz,
  // h = u2 - x1, r = s2 - y1, hh = h^2, rr = r^2, zh = z1 h, hhh = h hh,
  // v = x1 hh, t = r (v - x3), s1h = y1 hhh
  MZZ = T0, MYZ, MU2, MS2, MH, MR, MHH, MRR, MZH, MHHH, MV, MT, MS1H,
  // the general addition (the fold): z1z1, z2z2, y1 z2, y2 z1, u1 = x1 z2z2,
  // u2 = x2 z1z1, s1 = y1z2 z2z2, s2 = y2z1 z1z1, h, r, hh, rr, z1z2 = z1 z2,
  // hhh, v = u1 hh, zh = z1z2 h, t = r (v - x3), s1h = s1 hhh
  FZ1Z1 = KX, FZ2Z2 = KY, FY1Z2 = NX, FY2Z1 = NY, FU1 = RX, FU2 = RY,
  FS1 = T0, FS2, FH, FR, FHH, FRR, FZ1Z2, FHHH, FV, FZH, FT, FS1H,
  // the doubling (dbl-2009-l): a = x^2, b = y^2, yz = y z, c = b^2,
  // xb2 = (x + b)^2, esq = (3a)^2, em = 3a (d - x3); N is kept
  DA = T0, DB, DYZ, DC, DXB2, DESQ, DEM,
};
static_assert(kSlots <= 128, "slot indices are 7 bits");
static_assert(FS1H <= T12 && MS1H <= T12 && DEM <= T12, "the temporaries fit T0..T12");

// A term: slot times a small nonzero integer (pairing_lanes.h's LT)
#define G1S_T(slot, coeff) static_cast<uint16_t>(((slot) & 0x7f) | (((coeff) & 0xff) << 8))
// out = (the sum of the first na terms) * (the sum of the rest)
#define G1S_MUL(o, na, ...) {lanes::kFpMul, (o), (na), 0, {__VA_ARGS__}}
// out = the sum of the terms
#define G1S_LIN(o, ...) {lanes::kFpLin, (o), 0, 0, {__VA_ARGS__}}
#define G1S_SQR(o, a) G1S_MUL(o, 1, G1S_T(a, 1), G1S_T(a, 1))
#define G1S_PROD(o, a, b) G1S_MUL(o, 1, G1S_T(a, 1), G1S_T(b, 1))
#define G1S_COPY(o, a) G1S_LIN(o, G1S_T(a, 1))

// The start of a lane: its first key into the sum (z = one), its second
// converted into K. A first key at infinity (all zero) leaves the sum's x
// and y zero; the state machine then zeroes z.
#define G1S_INIT_STEPS 1
#define G1S_INIT                                                                      \
  {G1S_PROD(X1, RX, CR2), G1S_PROD(Y1, RY, CR2), G1S_PROD(KX, QX, CR2),               \
   G1S_PROD(KY, QY, CR2), G1S_COPY(Z1, CONE)}

// A sum at infinity takes the key (z = one); then, or for a key at
// infinity alone, the next key converted: K = R in Montgomery form.
#define G1S_SET_STEPS 1
#define G1S_SET {G1S_COPY(X1, KX), G1S_COPY(Y1, KY), G1S_COPY(Z1, CONE)}
#define G1S_CONVERT_STEPS 1
#define G1S_CONVERT {G1S_PROD(KX, RX, CR2), G1S_PROD(KY, RY, CR2)}

// The mixed addition sum += K, the next key N = R converted in its first
// step and moved into K in its fourth. Its head ends with h and r, which
// choose the rest.
#define G1S_MH G1S_T(MU2, 1), G1S_T(X1, -1)
#define G1S_MR G1S_T(MS2, 1), G1S_T(Y1, -1)
#define G1S_MADD_HEAD_STEPS 3
#define G1S_MADD_HEAD                                                                 \
  {G1S_SQR(MZZ, Z1), G1S_PROD(MYZ, KY, Z1), G1S_PROD(NX, RX, CR2),                    \
   G1S_PROD(NY, RY, CR2)},                                                            \
  {G1S_PROD(MU2, KX, MZZ), G1S_PROD(MS2, MYZ, MZZ)},                                  \
  {G1S_MUL(MHH, 2, G1S_MH, G1S_MH), G1S_MUL(MRR, 2, G1S_MR, G1S_MR),                  \
   G1S_MUL(MZH, 1, G1S_T(Z1, 1), G1S_MH), G1S_LIN(MH, G1S_MH), G1S_LIN(MR, G1S_MR)}
#define G1S_MADD_TAIL_STEPS 3
#define G1S_MADD_TAIL                                                                 \
  {G1S_PROD(MHHH, MH, MHH), G1S_PROD(MV, X1, MHH), G1S_COPY(KX, NX), G1S_COPY(KY, NY)}, \
  {G1S_MUL(MT, 1, G1S_T(MR, 1), G1S_T(MV, 3), G1S_T(MHHH, 1), G1S_T(MRR, -1)),        \
   G1S_PROD(MS1H, Y1, MHHH), G1S_LIN(X1, G1S_T(MRR, 1), G1S_T(MHHH, -1), G1S_T(MV, -2)), \
   G1S_COPY(Z1, MZH)},                                                                \
  {G1S_LIN(Y1, G1S_T(MT, 1), G1S_T(MS1H, -1))}

// dbl-2009-l (fp381_core.h g1_double) on the sum; then, in the chain, N
// moved into K (the doubling replaced the addition's tail).
#define G1S_DBL_STEPS 4
#define G1S_DBL                                                                       \
  {G1S_SQR(DA, X1), G1S_SQR(DB, Y1), G1S_PROD(DYZ, Y1, Z1)},                          \
  {G1S_SQR(DC, DB), G1S_MUL(DXB2, 2, G1S_T(X1, 1), G1S_T(DB, 1), G1S_T(X1, 1), G1S_T(DB, 1)), \
   G1S_MUL(DESQ, 1, G1S_T(DA, 3), G1S_T(DA, 3)), G1S_LIN(Z1, G1S_T(DYZ, 2))},        \
  {G1S_MUL(DEM, 1, G1S_T(DA, 3), G1S_T(DXB2, 6), G1S_T(DA, -6), G1S_T(DC, -6),        \
           G1S_T(DESQ, -1)),                                                          \
   G1S_LIN(X1, G1S_T(DESQ, 1), G1S_T(DXB2, -4), G1S_T(DA, 4), G1S_T(DC, 4))},         \
  {G1S_LIN(Y1, G1S_T(DEM, 1), G1S_T(DC, -8))}
#define G1S_NEXT_STEPS 1
#define G1S_NEXT {G1S_COPY(KX, NX), G1S_COPY(KY, NY)}

// The fold: a sum at infinity takes the partner's; else add-2007-bl
// (fp381_core.h g1_add), its head ending with h and r.
#define G1S_TAKE_STEPS 1
#define G1S_TAKE {G1S_COPY(X1, X2), G1S_COPY(Y1, Y2), G1S_COPY(Z1, Z2)}
#define G1S_FH G1S_T(FU2, 1), G1S_T(FU1, -1)
#define G1S_FR G1S_T(FS2, 1), G1S_T(FS1, -1)
#define G1S_ADD_HEAD_STEPS 3
#define G1S_ADD_HEAD                                                                  \
  {G1S_SQR(FZ1Z1, Z1), G1S_SQR(FZ2Z2, Z2), G1S_PROD(FY1Z2, Y1, Z2),                   \
   G1S_PROD(FY2Z1, Y2, Z1)},                                                          \
  {G1S_PROD(FU1, X1, FZ2Z2), G1S_PROD(FU2, X2, FZ1Z1), G1S_PROD(FS1, FY1Z2, FZ2Z2),   \
   G1S_PROD(FS2, FY2Z1, FZ1Z1)},                                                      \
  {G1S_MUL(FHH, 2, G1S_FH, G1S_FH), G1S_MUL(FRR, 2, G1S_FR, G1S_FR),                  \
   G1S_PROD(FZ1Z2, Z1, Z2), G1S_LIN(FH, G1S_FH), G1S_LIN(FR, G1S_FR)}
#define G1S_ADD_TAIL_STEPS 3
#define G1S_ADD_TAIL                                                                  \
  {G1S_PROD(FHHH, FH, FHH), G1S_PROD(FV, FU1, FHH), G1S_PROD(FZH, FZ1Z2, FH)},        \
  {G1S_MUL(FT, 1, G1S_T(FR, 1), G1S_T(FV, 3), G1S_T(FHHH, 1), G1S_T(FRR, -1)),        \
   G1S_PROD(FS1H, FS1, FHHH), G1S_LIN(X1, G1S_T(FRR, 1), G1S_T(FHHH, -1), G1S_T(FV, -2)), \
   G1S_COPY(Z1, FZH)},                                                                \
  {G1S_LIN(Y1, G1S_T(FT, 1), G1S_T(FS1H, -1))}

// The set's sum out of Montgomery form, into X2, Y2, Z2
#define G1S_OUT_STEPS 1
#define G1S_OUT {G1S_PROD(X2, X1, CUNIT), G1S_PROD(Y2, Y1, CUNIT), G1S_PROD(Z2, Z1, CUNIT)}

enum Range : int {
  kInit = 0,
  kSet = kInit + G1S_INIT_STEPS,
  kConvert = kSet + G1S_SET_STEPS,
  kMaddHead = kConvert + G1S_CONVERT_STEPS,
  kMaddTail = kMaddHead + G1S_MADD_HEAD_STEPS,
  kDbl = kMaddTail + G1S_MADD_TAIL_STEPS,
  kNext = kDbl + G1S_DBL_STEPS,
  kTake = kNext + G1S_NEXT_STEPS,
  kAddHead = kTake + G1S_TAKE_STEPS,
  kAddTail = kAddHead + G1S_ADD_HEAD_STEPS,
  kOut = kAddTail + G1S_ADD_TAIL_STEPS,
  kSteps = kOut + G1S_OUT_STEPS,
};

#define G1S_TABLE                                                                     \
  {G1S_INIT, G1S_SET, G1S_CONVERT, G1S_MADD_HEAD, G1S_MADD_TAIL, G1S_DBL, G1S_NEXT,   \
   G1S_TAKE, G1S_ADD_HEAD, G1S_ADD_TAIL, G1S_OUT}

#ifdef __CUDACC__
__device__ const Op kTableDev[kSteps][kWidth] = G1S_TABLE;
#endif
static const Op kTableHost[kSteps][kWidth] = G1S_TABLE;

LANES_HD const Op (*table())[kWidth] {
#ifdef __CUDA_ARCH__
  return kTableDev;
#else
  return kTableHost;
#endif
}

// The slots from `first` on as one array of words (the slots are contiguous)
LANES_HD uint32_t* words(const FpCrew& c, int first) {
  return reinterpret_cast<uint32_t*>(c.s + first);
}

LANES_HD int crew_first(const FpCrew& c) {
#ifdef __CUDA_ARCH__
  return c.t;
#else
  (void)c;
  return 0;
#endif
}

LANES_HD int crew_stride(const FpCrew& c) {
#ifdef __CUDA_ARCH__
  return c.threads;
#else
  (void)c;
  return 1;
#endif
}

// A word of device memory that another block may have written (the
// scratch), or that is read once (a key): through L2, not L1
LANES_HD uint32_t load_word(const uint32_t* p) {
#ifdef __CUDA_ARCH__
  return __ldcg(p);
#else
  return *p;
#endif
}

// n words of slots from `first` on <- src (zero where src is null), this
// thread's share of them; then a sync
LANES_HD void crew_fill(const FpCrew& c, int first, const uint32_t* src, int n) {
  uint32_t* w = words(c, first);
  for (int i = crew_first(c); i < n; i += crew_stride(c)) w[i] = src ? load_word(src + i) : 0u;
  lanes::crew_sync(c);
}

// R^2, R and 1: the slots CR2, CONE, CUNIT
#define G1S_CONSTANTS {FP381_R2_LIMBS, FP381_ONE_LIMBS, 1u}
#ifdef __CUDACC__
__device__ const uint32_t kConstantsDev[3 * fp381::kLimbs] = G1S_CONSTANTS;
#endif
static const uint32_t kConstantsHost[3 * fp381::kLimbs] = G1S_CONSTANTS;
#undef G1S_CONSTANTS

LANES_HD void crew_constants(const FpCrew& c) {
#ifdef __CUDA_ARCH__
  crew_fill(c, CR2, kConstantsDev, 3 * fp381::kLimbs);
#else
  crew_fill(c, CR2, kConstantsHost, 3 * fp381::kLimbs);
#endif
}

// The raw key k (x then y, canonical limbs) into slots `first`, `first` +
// 1, or zeros past the set's end
LANES_HD void crew_key(const FpCrew& c, int first, const uint32_t* points, int64_t k,
                       int64_t end) {
  crew_fill(c, first, k < end ? points + k * kKeyWords : nullptr, kKeyWords);
}

// The lane's sum of the keys k0, k0 + kLanes, ... below end, into X1, Y1,
// Z1 (all zero for infinity): ops/g1.py's acc = point_add(acc, key) in
// turn. At the top of key k, K holds key k in Montgomery form and R the
// raw key k + kLanes. Every flag is read after a sync, by every thread of
// the crew, and the crew syncs again before it writes.
LANES_HD void chain_crew(const FpCrew& c, const uint32_t* points, int64_t k0, int64_t end) {
  if (k0 >= end) {
    crew_fill(c, X1, nullptr, kJacWords);
    return;
  }
  enum Phase { kStart, kAfterInit, kKey, kAfterFirst, kAfterHead, kAdvance };
  crew_key(c, RX, points, k0, end);
  crew_key(c, QX, points, k0 + kLanes, end);
  int phase = kStart;
  int64_t k = k0 + kLanes;
  TOWER_ROLLED
  for (;;) {
    int first = 0, count = 0;
    if (phase == kStart) {
      first = kInit;
      count = G1S_INIT_STEPS;
      phase = kAfterInit;
    } else if (phase == kAfterInit) {
      const bool dead = fp381::is_zero(c.s[X1]) && fp381::is_zero(c.s[Y1]);
      lanes::crew_sync(c);
      if (dead) crew_fill(c, Z1, nullptr, fp381::kLimbs);
      crew_key(c, RX, points, k + kLanes, end);
      phase = kKey;
      continue;
    } else if (phase == kKey) {
      if (k >= end) return;
      const bool key_dead = fp381::is_zero(c.s[KX]) && fp381::is_zero(c.s[KY]);
      const bool sum_dead = fp381::is_zero(c.s[Z1]);
      lanes::crew_sync(c);
      if (key_dead || sum_dead) {
        // the sum takes a live key; then the next key is converted alone
        first = key_dead ? kConvert : kSet;
        count = key_dead ? G1S_CONVERT_STEPS : G1S_SET_STEPS + G1S_CONVERT_STEPS;
        phase = kAdvance;
      } else {
        first = kMaddHead;  // its first step converts R into N
        count = 1;
        phase = kAfterFirst;
      }
    } else if (phase == kAfterFirst) {
      crew_key(c, RX, points, k + 2 * kLanes, end);
      first = kMaddHead + 1;
      count = G1S_MADD_HEAD_STEPS - 1;
      phase = kAfterHead;
    } else if (phase == kAfterHead) {
      const bool h0 = fp381::is_zero(c.s[MH]), r0 = fp381::is_zero(c.s[MR]);
      lanes::crew_sync(c);
      if (h0 && !r0) crew_fill(c, X1, nullptr, kJacWords);  // P + -P: infinity
      // h = 0 and r = 0 (the key equals the sum): the doubling; each way
      // N then moves into K
      first = !h0 ? kMaddTail : r0 ? kDbl : kNext;
      count = !h0 ? G1S_MADD_TAIL_STEPS : r0 ? G1S_DBL_STEPS + G1S_NEXT_STEPS : G1S_NEXT_STEPS;
      k += kLanes;
      phase = kKey;
    } else {  // kAdvance: K took R alone
      crew_key(c, RX, points, k + 2 * kLanes, end);
      k += kLanes;
      phase = kKey;
      continue;
    }
    lanes::run_fp_steps(c, table() + first, count);
  }
}

// X1, Y1, Z1 += X2, Y2, Z2 (ops/g1.py point_add, fp381_core.h g1_add);
// then, with `out`, the sum out of Montgomery form into X2, Y2, Z2.
LANES_HD void fold_crew(const FpCrew& c, bool out) {
  enum Phase { kStart, kAfterHead, kOutPhase, kDone };
  int phase = kStart;
  TOWER_ROLLED
  for (;;) {
    int first = 0, count = 0;
    if (phase == kStart) {
      const bool q_inf = fp381::is_zero(c.s[Z2]), p_inf = fp381::is_zero(c.s[Z1]);
      lanes::crew_sync(c);
      if (q_inf) {
        phase = kOutPhase;
        continue;
      }
      first = p_inf ? kTake : kAddHead;
      count = p_inf ? G1S_TAKE_STEPS : G1S_ADD_HEAD_STEPS;
      phase = p_inf ? kOutPhase : kAfterHead;
    } else if (phase == kAfterHead) {
      const bool h0 = fp381::is_zero(c.s[FH]), r0 = fp381::is_zero(c.s[FR]);
      lanes::crew_sync(c);
      phase = kOutPhase;
      if (h0 && !r0) {  // P + -P
        crew_fill(c, X1, nullptr, kJacWords);
        continue;
      }
      first = h0 ? kDbl : kAddTail;
      count = h0 ? G1S_DBL_STEPS : G1S_ADD_TAIL_STEPS;
    } else if (phase == kOutPhase) {
      if (!out) return;
      first = kOut;
      count = G1S_OUT_STEPS;
      phase = kDone;
    } else {
      return;
    }
    lanes::run_fp_steps(c, table() + first, count);
  }
}

// The partner's sum (its X1, Y1, Z1) into X2, Y2, Z2; then a sync
LANES_HD void crew_partner(const FpCrew& c, const Fp* partner) {
  uint32_t* w = words(c, X2);
  const uint32_t* src = reinterpret_cast<const uint32_t*>(partner + X1);
  for (int i = crew_first(c); i < kJacWords; i += crew_stride(c)) w[i] = src[i];
  lanes::crew_sync(c);
}

// Fold crew cr: the fold's first level, lanes cr and cr + 64 of a set's
// lane sums (lane_sums: (kLanes, 3, 12) words)
LANES_HD void first_level_crew(const FpCrew& c, int cr, const uint32_t* lane_sums) {
  crew_fill(c, X1, lane_sums + cr * kJacWords, kJacWords);
  crew_fill(c, X2, lane_sums + (cr + kFoldCrews) * kJacWords, kJacWords);
  fold_crew(c, false);
}

// Crew 0 at the end of the fold: the set's sum, out of Montgomery form (in
// X2, Y2, Z2), stored as canonical Jacobian limbs to out
LANES_HD void store_out_crew(const FpCrew& c, uint32_t* out) {
  const uint32_t* w = words(c, X2);
  for (int i = crew_first(c); i < kJacWords; i += crew_stride(c)) out[i] = w[i];
}

#ifndef __CUDA_ARCH__
// The kernels' schedule on the host, for n_sets sets of points (K, 2, 12)
// canonical limbs and offsets (n_sets + 1): the chains, `chain_lanes` lanes
// a block (the kernel's kChainLanes; other widths put two sets' lanes in
// one block), each crew's ops one after another inside a step; then each
// set's fold block, its crews one after another between its barriers.
// out: (n_sets, 3, 12) canonical Jacobian limbs.
inline void sum_sets_host(const uint32_t* points, const int64_t* offsets, int64_t n_sets,
                          int chain_lanes, uint32_t* out) {
  static Fp slots[kFoldCrews][kSlots];
  std::vector<Fp> chain_slots(static_cast<std::size_t>(chain_lanes) * kSlots);
  std::vector<uint32_t> lane_sums(static_cast<std::size_t>(n_sets) * kLanes * kJacWords);
  for (int64_t block = 0; block * chain_lanes < n_sets * kLanes; ++block) {
    for (int cr = 0; cr < chain_lanes; ++cr) {
      const int64_t lane = block * chain_lanes + cr;
      if (lane >= n_sets * kLanes) break;
      const int64_t set = lane / kLanes;
      const FpCrew c{chain_slots.data() + cr * kSlots, 0, 1, 0};
      crew_constants(c);
      chain_crew(c, points, offsets[set] + lane % kLanes, offsets[set + 1]);
      const uint32_t* sum = words(c, X1);
      for (int w = 0; w < kJacWords; ++w) lane_sums[lane * kJacWords + w] = sum[w];
    }
  }
  for (int64_t set = 0; set < n_sets; ++set) {
    for (int cr = 0; cr < kFoldCrews; ++cr) {
      const FpCrew c{slots[cr], 0, 1, 0};
      crew_constants(c);
      first_level_crew(c, cr, lane_sums.data() + set * kLanes * kJacWords);
    }
    for (int half = kFoldCrews / 2; half >= 1; half >>= 1) {
      for (int cr = 0; cr < half; ++cr) {
        const FpCrew c{slots[cr], 0, 1, 0};
        crew_partner(c, slots[cr + half]);
        fold_crew(c, half == 1);
      }
    }
    store_out_crew(FpCrew{slots[0], 0, 1, 0}, out + set * kJacWords);
  }
}
#endif

}  // namespace g1sum

#undef G1S_T
#undef G1S_MUL
#undef G1S_LIN
#undef G1S_SQR
#undef G1S_PROD
#undef G1S_COPY
#undef G1S_INIT
#undef G1S_SET
#undef G1S_CONVERT
#undef G1S_MH
#undef G1S_MR
#undef G1S_MADD_HEAD
#undef G1S_MADD_TAIL
#undef G1S_DBL
#undef G1S_NEXT
#undef G1S_TAKE
#undef G1S_FH
#undef G1S_FR
#undef G1S_ADD_HEAD
#undef G1S_ADD_TAIL
#undef G1S_OUT
#undef G1S_TABLE
