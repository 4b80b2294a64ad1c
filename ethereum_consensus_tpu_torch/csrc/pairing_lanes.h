// The u64 build's Miller loop and G2 blinder multiplication and sum
// (pairing.cu) as crews of threads that share one lane: a lane's values live
// in shared memory as Fp2 "slots", and the lane's work is a fixed schedule
// of steps. A step is a row of independent ops: Fp2 products and small
// linear combinations of slots. Each product is three Fp products (units),
// each linear op two (a component each); the crew's threads take the step's
// units in turn, sync, combine each product's three parts into its Fp2
// value (a component a unit), and sync again. No op of a step reads a slot that another op of the step writes
// (check_steps).
//
//   miller_crew  a warp per lane: f (6 slots), T (3) and the lane's
//                products. A doubling iteration is 8 steps, 4 with products:
//                the 18 products of f^2 beside T's first 4 (66 units), T's
//                next 6, T's last 3 beside the 6 line products with c11, the
//                other 12 line products; with the addition 15 steps.
//   g2_crew      [k] Q (double-and-add, MSB first) or p + q, on the
//                reference's formulas and selects: steps of at most 4
//                products, a warp a lane in the lanes pass, 4 threads an
//                addition in the fold.
//
// What the schedule must keep: each Miller value depends on the native
// library's line scaling (c00, c11, c12) and T's doubling and mixed-addition
// formulas, and the G2 sum's coordinates on the reference's point formulas.
// The steps compute exactly those quantities; every field value is fully
// reduced Montgomery, so computing an algebraic quantity by another sum or
// product of the same values (c00 * f as -2 xi (ly * f), x3 = e^2 - 2d as
// e^2 - 4 xb2 + 4a + 4c) gives the same canonical value, limb for limb.
//
// The step tables are data: one copy of the product code serves every step
// (a state machine around one run_steps call per crew function), so nvcc
// inlines fp381::mul a few times rather than once per product, and no
// tower value passes through a call.
//
// The header is plain C++ outside nvcc: the host driver runs a crew's units
// one after another inside each step, so g++ builds the same schedules for
// the CPU tests (tests/test_torch_pairing_lanes.py).

#pragma once

#include <stdint.h>

#include "fp_tower.h"

#ifdef __CUDACC__
#define LANES_HD __host__ __device__ __forceinline__
#else
#define LANES_HD inline
#endif

namespace lanes {

using fp381::Fp;
using tower::Fp2;

// ---------------------------------------------------------------------------
// Ops and steps
// ---------------------------------------------------------------------------

enum Kind : uint8_t {
  kNone = 0,   // an idle thread of the step
  kMul = 1,    // out = a * b (Karatsuba, three Fp products)
  kSqr = 2,    // out = a^2 (two Fp products)
  kScale = 3,  // out = a * b.c0 (an Fp2 by the Fp in b's first half)
  kLin = 4,    // out = the sum of up to kTerms terms c * xi^e * slot
};

constexpr int kTerms = 6;

struct alignas(16) Op {
  uint8_t kind, out, pad0, pad1;
  uint16_t arg[kTerms];  // products: arg[0], arg[1] are slots; kLin: terms
};

// A term of a linear op: slot (bits 0-6), times xi (bit 7), times a nonzero
// small integer (bits 8-15, signed); 0 ends the term list.
#define LT(slot, coeff) static_cast<uint16_t>(((slot) & 0x7f) | (((coeff) & 0xff) << 8))
#define LX(slot, coeff) static_cast<uint16_t>(((slot) & 0x7f) | 0x80 | (((coeff) & 0xff) << 8))

#define MUL(o, a, b) {kMul, (o), 0, 0, {(a), (b), 0, 0, 0, 0}}
#define SQR(o, a) {kSqr, (o), 0, 0, {(a), (a), 0, 0, 0, 0}}
#define SCALE(o, a, k) {kScale, (o), 0, 0, {(a), (k), 0, 0, 0, 0}}
#define LIN(o, ...) {kLin, (o), 0, 0, {__VA_ARGS__}}

// The Fp products of a product op: unit j (0, 1, 2) of product p computes
// m_j (Karatsuba for kMul: a0 b0, a1 b1, (a0 + a1)(b0 + b1); for kSqr
// (a0 + a1)(a0 - a1) and a0 a1; for kScale a0 b0 and a1 b0) into the
// crew's scratch[3p + j]; combine then writes the Fp2 value, one component
// a unit.
LANES_HD bool is_product(int kind) { return kind == kMul || kind == kSqr || kind == kScale; }

LANES_HD void product_unit(const Fp2* s, Fp* scratch, const Op& op, int p, int j) {
  const bool sqr = op.kind == kSqr;
  if (j == 2 && op.kind != kMul) return;
  const Fp2 a = s[op.arg[0]];
  const Fp2 b = s[op.arg[1]];
  Fp x, y;
  if (j == 0) {
    x = sqr ? fp381::add(a.c0, a.c1) : a.c0;
    y = sqr ? fp381::sub(a.c0, a.c1) : b.c0;
  } else if (j == 1) {
    x = sqr ? a.c0 : a.c1;
    y = sqr ? a.c1 : op.kind == kScale ? b.c0 : b.c1;
  } else {
    x = fp381::add(a.c0, a.c1);
    y = fp381::add(b.c0, b.c1);
  }
  scratch[3 * p + j] = fp381::mul(x, y);
}

// Component i of product p's value from its m_j.
LANES_HD void combine(Fp2* s, const Fp* scratch, const Op& op, int p, int i) {
  const Fp m0 = scratch[3 * p], m1 = scratch[3 * p + 1];
  if (i == 0) {
    s[op.out].c0 = op.kind == kMul ? fp381::sub(m0, m1) : m0;
  } else {
    s[op.out].c1 = op.kind == kMul   ? fp381::sub(fp381::sub(scratch[3 * p + 2], m0), m1)
                   : op.kind == kSqr ? fp381::add(m1, m1)
                                     : m1;
  }
}

// small * v for small in 1..15, from the top bit
LANES_HD Fp small_multiple(const Fp& v, int small) {
  const int top = small >= 8 ? 3 : small >= 4 ? 2 : small >= 2 ? 1 : 0;
  Fp r = v;
  for (int b = top - 1; b >= 0; --b) {
    r = fp381::add(r, r);
    if ((small >> b) & 1) r = fp381::add(r, v);
  }
  return r;
}

// Component i of a linear op on the slots s (xi v = (v0 - v1) + (v0 + v1) u):
// its inputs are read before its output is written.
LANES_HD void linear(Fp2* s, const Op& op, int i) {
  Fp acc = fp381::zero();
  for (int k = 0; k < kTerms; ++k) {
    const uint16_t term = op.arg[k];
    const int coeff = static_cast<int8_t>(term >> 8);
    if (coeff == 0) break;
    const Fp2 v = s[term & 0x7f];
    Fp x = i == 0 ? v.c0 : v.c1;
    if (term & 0x80) x = i == 0 ? fp381::sub(v.c0, v.c1) : fp381::add(v.c0, v.c1);
    x = small_multiple(x, coeff < 0 ? -coeff : coeff);
    acc = coeff < 0 ? fp381::sub(acc, x) : fp381::add(acc, x);
  }
  if (i == 0) {
    s[op.out].c0 = acc;
  } else {
    s[op.out].c1 = acc;
  }
}

// The threads that share a lane: its slots and its products' scratch (three
// Fp a product of a step), this thread's index in the crew, the crew's size
// and, on the card, the crew's threads in the warp (their __syncwarp and
// ballot mask).
struct Crew {
  Fp2* s;
  Fp* scratch;
  int t;
  int threads;
  unsigned mask;
};

LANES_HD void crew_sync(const Crew& c) {
#ifdef __CUDA_ARCH__
  __syncwarp(c.mask);
#else
  (void)c;
#endif
}

// Steps [0, count) of a table of W-wide steps, each row its product ops
// first, then its linear ops (check_steps). A row's P products are 3P units
// (unit 3p + j is product p's m_j), its L linear ops 2L more (one a
// component); thread t of the crew runs units t, t + threads, ...; the crew
// syncs, runs the products' 2P combine units the same way, and syncs again.
// A crew reads the row's kinds one op a thread, so W <= threads. On the
// host the units run in turn.
template <int W>
LANES_HD void run_steps(const Crew& c, const Op (*steps)[W], int count) {
  TOWER_ROLLED
  for (int k = 0; k < count; ++k) {
    const Op* row = steps[k];
#ifdef __CUDA_ARCH__
    const int kind = c.t < W ? row[c.t].kind : kNone;
    const int products = __popc(__ballot_sync(c.mask, is_product(kind)));
    const int units = 3 * products + 2 * __popc(__ballot_sync(c.mask, kind == kLin));
    const int first = c.t;
    const int stride = c.threads;
#else
    int products = 0, units = 0;
    for (int t = 0; t < W; ++t) {
      products += is_product(row[t].kind);
      units += 2 * (row[t].kind == kLin);
    }
    units += 3 * products;
    const int first = 0;
    const int stride = 1;
#endif
    for (int u = first; u < units; u += stride) {
      if (u < 3 * products) {
        product_unit(c.s, c.scratch, row[u / 3], u / 3, u % 3);
      } else {
        const int v = u - 3 * products;
        linear(c.s, row[products + v / 2], v % 2);
      }
    }
    crew_sync(c);
    if (products == 0) continue;
    for (int u = first; u < 2 * products; u += stride) combine(c.s, c.scratch, row[u / 2], u / 2, u % 2);
    crew_sync(c);
  }
}

#ifndef __CUDA_ARCH__
// The first step of the table whose ops are not independent (two write one
// slot, or one reads a slot another writes, itself included) or not in
// run_steps' order, or -1.
template <int W>
inline int check_steps(const Op (*steps)[W], int count, int slots) {
  for (int k = 0; k < count; ++k) {
    // products, then linear ops, then idle threads
    int order = 0;
    for (int t = 0; t < W; ++t) {
      const int rank = is_product(steps[k][t].kind) ? 0 : steps[k][t].kind == kLin ? 1 : 2;
      if (rank < order) return k;
      order = rank;
    }
    bool written[128] = {};
    for (int t = 0; t < W; ++t) {
      const Op& op = steps[k][t];
      if (op.kind == kNone) continue;
      if (op.out >= slots || written[op.out]) return k;
      written[op.out] = true;
    }
    for (int t = 0; t < W; ++t) {
      const Op& op = steps[k][t];
      if (op.kind == kNone) continue;
      for (int i = 0; i < kTerms; ++i) {
        const uint16_t arg = op.arg[i];
        if (op.kind == kLin && (arg >> 8) == 0) break;
        if (op.kind != kLin && i >= 2) break;
        if ((arg & 0x7f) >= slots || written[arg & 0x7f]) return k;
      }
    }
  }
  return -1;
}
#endif

// ---------------------------------------------------------------------------
// The Miller loop: a warp per lane (native miller_double_step,
// miller_add_step and multi_miller_loop for one pair, as tower::miller_loop)
// ---------------------------------------------------------------------------

constexpr int kMillerThreads = 32;

enum MillerSlot : int {
  F0, F1, F2, F3, F4, F5,  // f: c0.a0, c0.a1, c0.a2, c1.a0, c1.a1, c1.a2
  TX, TY, TZ, QX, QY,
  XP, YP,  // (xp, 0), (yp, 0)
  // f^2: A = c0 + c1 and B = c0 + v c1, then u_ij = c0_i c1_j, w_ij = A_i B_j;
  // the line product reuses them (LA = f.c0 + f.c1 in SA; products in U, W)
  SA0, SA1, SA2, SB0, SB1, SB2,
  U00, U01, U02, U10, U11, U12, U20, U21, U22,
  W00, W01, W02, W10, W11, W12, W20, W21, W22,
  // the doubling: a = x^2, b = y^2, z2 = z^2, yz = y z, ...
  DA, DB, DZ2, DYZ, U0, U1, U2, W0, W1, W2, DE, DXB,
  DC, DX3C, DXB2, DEZ2, DYZ3, DESQ, DX3, DDX, C11, LY, C12, DEM,
  // the addition's first products
  AZ2, AXZ, AXQZ, AYQZ, AU2, AS2, AXQZ3,
  kMillerSlots,
  // the addition's later values reuse the doubling's slots
  LAMD = DA, AH = DB, LAMN = DZ2, ARR = DYZ, AZH = U0,
  LYA = U1, C12A = U2, AK1 = W0, AK2 = W1, AHH = W2, ARR2 = DE, AZH2 = DXB, AYH = DC,
  C11A = DX3C, AI4 = DXB2, AJ = DEZ2, AV = DYZ3, AYJ = DESQ, AVX3 = DX3, AYM = DDX,
};
static_assert(kMillerSlots <= 128, "slot indices are 7 bits");

// f <- f^2 l_{T,T}(P), T <- 2T. The line is c00 + (c11 v + c12 v^2) w with
// c00 = -2 xi ly, ly = y z^3 yp: f's products with c00 are taken with ly
// and the -2 xi applied in the sums.
#define MILLER_SQUARE_AND_T1                                                          \
  {LIN(SA0, LT(F0, 1), LT(F3, 1)), LIN(SA1, LT(F1, 1), LT(F4, 1)),                    \
   LIN(SA2, LT(F2, 1), LT(F5, 1)), LIN(SB0, LT(F0, 1), LX(F5, 1)),                    \
   LIN(SB1, LT(F1, 1), LT(F3, 1)), LIN(SB2, LT(F2, 1), LT(F4, 1))},                   \
  {MUL(U00, F0, F3), MUL(U01, F0, F4), MUL(U02, F0, F5), MUL(U10, F1, F3),            \
   MUL(U11, F1, F4), MUL(U12, F1, F5), MUL(U20, F2, F3), MUL(U21, F2, F4),            \
   MUL(U22, F2, F5), MUL(W00, SA0, SB0), MUL(W01, SA0, SB1), MUL(W02, SA0, SB2),      \
   MUL(W10, SA1, SB0), MUL(W11, SA1, SB1), MUL(W12, SA1, SB2), MUL(W20, SA2, SB0),    \
   MUL(W21, SA2, SB1), MUL(W22, SA2, SB2), SQR(DA, TX), SQR(DB, TY), SQR(DZ2, TZ),    \
   MUL(DYZ, TY, TZ)},                                                                 \
  {LIN(U0, LT(U00, 1), LX(U12, 1), LX(U21, 1)), LIN(U1, LT(U01, 1), LT(U10, 1), LX(U22, 1)), \
   LIN(U2, LT(U02, 1), LT(U11, 1), LT(U20, 1)), LIN(W0, LT(W00, 1), LX(W12, 1), LX(W21, 1)), \
   LIN(W1, LT(W01, 1), LT(W10, 1), LX(W22, 1)), LIN(W2, LT(W02, 1), LT(W11, 1), LT(W20, 1)), \
   LIN(DE, LT(DA, 3)), LIN(DXB, LT(TX, 1), LT(DB, 1))},                               \
  {SQR(DC, DB), MUL(DX3C, DA, TX), SQR(DXB2, DXB), MUL(DEZ2, DE, DZ2),                \
   MUL(DYZ3, DYZ, DZ2), SQR(DESQ, DE), LIN(F0, LT(W0, 1), LT(U0, -1), LX(U2, -1)),    \
   LIN(F1, LT(W1, 1), LT(U1, -1), LT(U0, -1)), LIN(F2, LT(W2, 1), LT(U2, -1), LT(U1, -1)), \
   LIN(F3, LT(U0, 2)), LIN(F4, LT(U1, 2)), LIN(F5, LT(U2, 2))},                       \
  {LIN(DX3, LT(DESQ, 1), LT(DXB2, -4), LT(DA, 4), LT(DC, 4)),                         \
   LIN(DDX, LT(DXB2, 6), LT(DA, -6), LT(DC, -6), LT(DESQ, -1)),                       \
   LIN(C11, LT(DB, 2), LT(DX3C, -3)), LIN(SA0, LT(F0, 1), LT(F3, 1)),                 \
   LIN(SA1, LT(F1, 1), LT(F4, 1)), LIN(SA2, LT(F2, 1), LT(F5, 1)), LIN(TZ, LT(DYZ, 2))}, \
  {SCALE(LY, DYZ3, YP), SCALE(C12, DEZ2, XP), MUL(DEM, DE, DDX), MUL(U20, F5, C11),   \
   MUL(U21, F3, C11), MUL(U22, F4, C11), MUL(W01, SA0, C11), MUL(W11, SA1, C11),      \
   MUL(W21, SA2, C11), LIN(TX, LT(DX3, 1))}

#define MILLER_LINE_PRODUCTS(ly, c12)                                                 \
  MUL(U00, F0, ly), MUL(U01, F1, ly), MUL(U02, F2, ly), MUL(U10, F4, c12),            \
      MUL(U11, F5, c12), MUL(U12, F3, c12), MUL(W00, SA0, ly), MUL(W10, SA1, ly),     \
      MUL(W20, SA2, ly), MUL(W02, SA0, c12), MUL(W12, SA1, c12), MUL(W22, SA2, c12)

// f from the line products: c0 = t0 + v t1, c1 = t2 - t0 - t1 (native
// fp12_mul_by_line), with c00 = k xi (ly) for k = -2 (doubling) or -1
// (addition). U0k = f.c0_k ly; U10, U11, U12 = f4 c12, f5 c12, f3 c12;
// U20, U21, U22 = f5 c11, f3 c11, f4 c11; W_i0 = LA_i ly, W_i1 = LA_i c11,
// W_i2 = LA_i c12.
#define MILLER_LINE_SUMS(k)                                                           \
  LIN(F0, LX(U00, k), LX(U12, 1), LX(U22, 1)),                                        \
      LIN(F1, LX(U01, k), LX(U10, 1), LX(U20, 1)),                                    \
      LIN(F2, LX(U02, k), LT(U21, 1), LX(U11, 1)),                                    \
      LIN(F3, LX(W00, k), LX(W12, 1), LX(W21, 1), LX(U00, -(k)), LX(U10, -1), LX(U20, -1)), \
      LIN(F4, LT(W01, 1), LX(W10, k), LX(W22, 1), LX(U01, -(k)), LT(U21, -1), LX(U11, -1)), \
      LIN(F5, LT(W02, 1), LT(W11, 1), LX(W20, k), LX(U02, -(k)), LT(U12, -1), LT(U22, -1))

#define MILLER_DBL_STEPS 8
#define MILLER_DBL_TABLE                                                              \
  {MILLER_SQUARE_AND_T1,                                                              \
   {MILLER_LINE_PRODUCTS(LY, C12), LIN(TY, LT(DEM, 1), LT(DC, -8))},                  \
   {MILLER_LINE_SUMS(-2)}}

// The same, then f <- f l_{T,Q}(P), T <- T + Q (madd-2007-bl): its first
// products share the doubling's last two steps. The line: lam_d = (x - u2) z
// = xz - xq z z^2, lam_n = y - s2, c00 = -xi lam_d yp, c11 = yq lam_d -
// lam_n xq, c12 = lam_n xp.
#define MILLER_DBL_ADD_STEPS 15
#define MILLER_DBL_ADD_TABLE                                                          \
  {MILLER_SQUARE_AND_T1,                                                              \
   {MILLER_LINE_PRODUCTS(LY, C12), SQR(AZ2, TZ), MUL(AXZ, TX, TZ), MUL(AXQZ, QX, TZ), \
    MUL(AYQZ, QY, TZ), LIN(TY, LT(DEM, 1), LT(DC, -8))},                              \
   {MUL(AU2, QX, AZ2), MUL(AS2, AYQZ, AZ2), MUL(AXQZ3, AXQZ, AZ2), MILLER_LINE_SUMS(-2)}, \
   {LIN(LAMD, LT(AXZ, 1), LT(AXQZ3, -1)), LIN(AH, LT(AU2, 1), LT(TX, -1)),            \
    LIN(LAMN, LT(TY, 1), LT(AS2, -1)), LIN(ARR, LT(AS2, 2), LT(TY, -2)),              \
    LIN(AZH, LT(TZ, 1), LT(AU2, 1), LT(TX, -1)), LIN(SA0, LT(F0, 1), LT(F3, 1)),      \
    LIN(SA1, LT(F1, 1), LT(F4, 1)), LIN(SA2, LT(F2, 1), LT(F5, 1))},                  \
   {SCALE(LYA, LAMD, YP), SCALE(C12A, LAMN, XP), MUL(AK1, QY, LAMD), MUL(AK2, LAMN, QX), \
    SQR(AHH, AH), SQR(ARR2, ARR), SQR(AZH2, AZH), MUL(AYH, TY, AH)},                  \
   {LIN(C11A, LT(AK1, 1), LT(AK2, -1)), LIN(AI4, LT(AHH, 4)),                         \
    LIN(TZ, LT(AZH2, 1), LT(AZ2, -1), LT(AHH, -1))},                                  \
   {MILLER_LINE_PRODUCTS(LYA, C12A), MUL(U20, F5, C11A), MUL(U21, F3, C11A),          \
    MUL(U22, F4, C11A), MUL(W01, SA0, C11A), MUL(W11, SA1, C11A), MUL(W21, SA2, C11A), \
    MUL(AJ, AH, AI4), MUL(AV, TX, AI4), MUL(AYJ, AYH, AI4)},                          \
   {MILLER_LINE_SUMS(-1), LIN(TX, LT(ARR2, 1), LT(AJ, -1), LT(AV, -2)),               \
    LIN(AVX3, LT(AV, 3), LT(AJ, 1), LT(ARR2, -1))},                                   \
   {MUL(AYM, ARR, AVX3)},                                                             \
   {LIN(TY, LT(AYM, 1), LT(AYJ, -2))}}

#ifdef __CUDACC__
__device__ const Op kMillerDblDev[MILLER_DBL_STEPS][kMillerThreads] = MILLER_DBL_TABLE;
__device__ const Op kMillerDblAddDev[MILLER_DBL_ADD_STEPS][kMillerThreads] =
    MILLER_DBL_ADD_TABLE;
#endif
static const Op kMillerDblHost[MILLER_DBL_STEPS][kMillerThreads] = MILLER_DBL_TABLE;
static const Op kMillerDblAddHost[MILLER_DBL_ADD_STEPS][kMillerThreads] = MILLER_DBL_ADD_TABLE;

// The Miller loop on the lane's slots: F, T, Q, XP and YP loaded (Montgomery;
// F = 1, T = (xq, yq, 1)). Leaves f_{|x|,Q}(P) in F, not yet conjugated.
LANES_HD void miller_crew(const Crew& c) {
  TOWER_ROLLED
  for (int bit = 62; bit >= 0; --bit) {  // the bits below the top bit of |x|
    const bool add = (tower::kBlsXAbs >> bit) & 1u;
#ifdef __CUDA_ARCH__
    const Op (*steps)[kMillerThreads] = kMillerDblDev;
    if (add) steps = kMillerDblAddDev;
#else
    const Op (*steps)[kMillerThreads] = kMillerDblHost;
    if (add) steps = kMillerDblAddHost;
#endif
    run_steps(c, steps, add ? MILLER_DBL_ADD_STEPS : MILLER_DBL_STEPS);
  }
}

// ---------------------------------------------------------------------------
// G2: the reference's g2_point_double and g2_point_add (as tower::g2_dbl and
// tower::g2_add), 4 threads per lane
// ---------------------------------------------------------------------------

constexpr int kG2Width = 4;  // the widest step of the G2 tables

enum G2Slot : int {
  X1, Y1, Z1,  // p: the accumulator, the sum
  X2, Y2, Z2,  // q
  G0, G1, G2, G3, G4, G5, G6, G7, G8, G9, G10, G11, G12, G13,
  kG2Slots,
  // the doubling's values (in place on p)
  GA = G0, GB = G1, GYZ = G2, GE = G3, GXB = G4, GC = G5, GXB2 = G6, GESQ = G7,
  GX3 = G8, GDX = G9, GEM = G10,
  // the addition's (in place on p)
  Z1Z1 = G0, Z2Z2 = G1, S1P = G2, S2P = G3, GU1 = G4, GU2 = G5, GS1 = G6, GS2 = G7,
  GH = G8, GR = G9, GHH = G0, GRR = G1, GZZ = G2, S1H = G3, GJ = G5, GV = G7,
  GZ3 = G10, S1J = G11, VX3 = G12, GYM = G13,
};

// dbl-2009-l: a = x^2, b = y^2, c = b^2, d = 2((x + b)^2 - a - c), e = 3a,
// x3 = e^2 - 2d, y3 = e (d - x3) - 8c, z3 = 2 y z
#define G2_DBL_STEPS 6
#define G2_DBL                                                                        \
  {SQR(GA, X1), SQR(GB, Y1), MUL(GYZ, Y1, Z1)},                                       \
  {LIN(GE, LT(GA, 3)), LIN(GXB, LT(X1, 1), LT(GB, 1))},                               \
  {SQR(GC, GB), SQR(GXB2, GXB), SQR(GESQ, GE)},                                       \
  {LIN(GX3, LT(GESQ, 1), LT(GXB2, -4), LT(GA, 4), LT(GC, 4)),                         \
   LIN(GDX, LT(GXB2, 6), LT(GA, -6), LT(GC, -6), LT(GESQ, -1)), LIN(Z1, LT(GYZ, 2))},  \
  {MUL(GEM, GE, GDX), LIN(X1, LT(GX3, 1))},                                           \
  {LIN(Y1, LT(GEM, 1), LT(GC, -8))}

// add-2007-bl with the reference's doubled slopes: h = u2 - u1, r = s2 - s1,
// i4 = (2h)^2, j = h i4, v = u1 i4, x3 = (2r)^2 - j - 2v,
// y3 = 2r (v - x3) - 2 s1 j, z3 = 2 z1 z2 h; taken as 4h^2 and h^3 times 4.
// The head ends with h and r, which choose the rest.
#define G2_HEAD_STEPS 3
#define G2_HEAD                                                                       \
  {SQR(Z1Z1, Z1), SQR(Z2Z2, Z2), MUL(S1P, Y1, Z2), MUL(S2P, Y2, Z1)},                 \
  {MUL(GU1, X1, Z2Z2), MUL(GU2, X2, Z1Z1), MUL(GS1, S1P, Z2Z2), MUL(GS2, S2P, Z1Z1)}, \
  {LIN(GH, LT(GU2, 1), LT(GU1, -1)), LIN(GR, LT(GS2, 1), LT(GS1, -1))}

#define G2_TAIL_STEPS 5
#define G2_TAIL                                                                       \
  {SQR(GHH, GH), SQR(GRR, GR), MUL(GZZ, Z1, Z2), MUL(S1H, GS1, GH)},                  \
  {MUL(GJ, GH, GHH), MUL(GV, GU1, GHH), MUL(GZ3, GZZ, GH), MUL(S1J, S1H, GHH)},       \
  {LIN(X1, LT(GRR, 4), LT(GJ, -4), LT(GV, -8)), LIN(VX3, LT(GV, 12), LT(GJ, 4), LT(GRR, -4)), \
   LIN(Z1, LT(GZ3, 2))},                                                              \
  {MUL(GYM, GR, VX3)},                                                                \
  {LIN(Y1, LT(GYM, 2), LT(S1J, -8))}

enum G2Range : int {
  kG2Dbl = 0,
  kG2Head = kG2Dbl + G2_DBL_STEPS,
  kG2Tail = kG2Head + G2_HEAD_STEPS,
  kG2Steps = kG2Tail + G2_TAIL_STEPS,
};

#define G2_TABLE {G2_DBL, G2_HEAD, G2_TAIL}

#ifdef __CUDACC__
__device__ const Op kG2Dev[kG2Steps][kG2Width] = G2_TABLE;
#endif
static const Op kG2Host[kG2Steps][kG2Width] = G2_TABLE;

LANES_HD const Op (*g2_table())[kG2Width] {
#ifdef __CUDA_ARCH__
  return kG2Dev;
#else
  return kG2Host;
#endif
}

// Slots [dst, dst + 3) <- [src, src + 3), or zero (src < 0); then a sync.
LANES_HD void crew_copy_point(const Crew& c, int dst, int src) {
#ifdef __CUDA_ARCH__
  for (int i = c.t; i < 3; i += c.threads) c.s[dst + i] = src < 0 ? tower::fp2_zero() : c.s[src + i];
  __syncwarp(c.mask);
#else
  for (int i = 0; i < 3; ++i) c.s[dst + i] = src < 0 ? tower::fp2_zero() : c.s[src + i];
#endif
}

LANES_HD bool slot_is_zero(const Crew& c, int slot) { return tower::fp2_is_zero(c.s[slot]); }

// A 128-bit blinder, least significant word first, held in registers.
struct Scalar {
  uint32_t w0, w1, w2, w3;
};

LANES_HD bool scalar_bit(const Scalar& k, int bit) {
  const int i = bit / 32;
  const uint32_t w = i == 0 ? k.w0 : i == 1 ? k.w1 : i == 2 ? k.w2 : k.w3;
  return (w >> (bit % 32)) & 1u;
}

// With k: p <- [k] q for a 128-bit k, MSB first (tower::g2_mul: from
// infinity, the top bit's addition gives q). Without: p <- p + q
// (tower::g2_add: q at infinity gives p, else p at infinity q, else P == -Q
// infinity, else P == Q the doubling). Every flag is read after a sync, by
// every thread of the crew, and the crew syncs again before it writes.
LANES_HD void g2_crew(const Crew& c, bool multiply, const Scalar& k) {
  enum Phase { kNextBit, kAdd, kAfterHead, kDone };
  int bit = 4 * 32;
  int phase = kAdd;
  if (multiply) {
    do --bit;
    while (bit >= 0 && !scalar_bit(k, bit));
    crew_copy_point(c, X1, bit < 0 ? -1 : X2);
    phase = kNextBit;
  }
  int first = 0, count = 0;
  TOWER_ROLLED
  for (;;) {
    if (phase == kNextBit) {
      if (!multiply || --bit < 0) return;
      first = kG2Dbl;
      count = G2_DBL_STEPS;
      phase = scalar_bit(k, bit) ? kAdd : kNextBit;
    } else if (phase == kAdd) {
      const bool q_inf = slot_is_zero(c, Z2), p_inf = slot_is_zero(c, Z1);
      crew_sync(c);
      if (q_inf || p_inf) {
        if (!q_inf) crew_copy_point(c, X1, X2);
        if (!multiply) return;
        phase = kNextBit;
        continue;
      }
      first = kG2Head;
      count = G2_HEAD_STEPS;
      phase = kAfterHead;
    } else if (phase == kAfterHead) {
      const bool h0 = slot_is_zero(c, GH), r0 = slot_is_zero(c, GR);
      crew_sync(c);
      if (h0 && !r0) {
        crew_copy_point(c, X1, -1);
        if (!multiply) return;
        phase = kNextBit;
        continue;
      }
      first = h0 ? kG2Dbl : kG2Tail;
      count = h0 ? G2_DBL_STEPS : G2_TAIL_STEPS;
      phase = multiply ? kNextBit : kDone;
    } else {
      return;
    }
    run_steps(c, g2_table() + first, count);
  }
}

// ---------------------------------------------------------------------------
// Host drivers (the CPU tests): one lane's crew, its threads in turn
// ---------------------------------------------------------------------------

#ifndef __CUDA_ARCH__
// f_{|x|,Q}(P), conjugated: tower::miller_loop
inline tower::Fp12 miller_loop_host(const Fp& xp, const Fp& yp, const Fp2& xq, const Fp2& yq) {
  Fp2 s[kMillerSlots];
  for (auto& v : s) v = tower::fp2_zero();
  s[F0] = tower::fp2_one();
  s[TX] = s[QX] = xq;
  s[TY] = s[QY] = yq;
  s[TZ] = tower::fp2_one();
  s[XP] = Fp2{xp, fp381::zero()};
  s[YP] = Fp2{yp, fp381::zero()};
  Fp scratch[3 * kMillerThreads];
  miller_crew(Crew{s, scratch, 0, 1, 0});
  tower::Fp12 f;
  f.c0 = tower::Fp6{s[F0], s[F1], s[F2]};
  f.c1 = tower::Fp6{s[F3], s[F4], s[F5]};
  return tower::fp12_conj(f);
}

// [k] q for an affine q (z = 1): tower::g2_mul
inline tower::G2Jac g2_mul_host(const tower::G2Jac& q, const uint32_t* k) {
  Fp2 s[kG2Slots];
  for (auto& v : s) v = tower::fp2_zero();
  s[X2] = q.x;
  s[Y2] = q.y;
  s[Z2] = q.z;
  Fp scratch[3 * kG2Width];
  g2_crew(Crew{s, scratch, 0, 1, 0}, true, Scalar{k[0], k[1], k[2], k[3]});
  return tower::G2Jac{s[X1], s[Y1], s[Z1]};
}

// p + q: tower::g2_add
inline tower::G2Jac g2_add_host(const tower::G2Jac& p, const tower::G2Jac& q) {
  Fp2 s[kG2Slots];
  for (auto& v : s) v = tower::fp2_zero();
  s[X1] = p.x;
  s[Y1] = p.y;
  s[Z1] = p.z;
  s[X2] = q.x;
  s[Y2] = q.y;
  s[Z2] = q.z;
  Fp scratch[3 * kG2Width];
  g2_crew(Crew{s, scratch, 0, 1, 0}, false, Scalar{});
  return tower::G2Jac{s[X1], s[Y1], s[Z1]};
}
#endif

}  // namespace lanes

#undef LT
#undef LX
#undef MUL
#undef SQR
#undef SCALE
#undef LIN
#undef MILLER_SQUARE_AND_T1
#undef MILLER_LINE_PRODUCTS
#undef MILLER_LINE_SUMS
#undef MILLER_DBL_TABLE
#undef MILLER_DBL_ADD_TABLE
#undef G2_DBL
#undef G2_HEAD
#undef G2_TAIL
#undef G2_TABLE
