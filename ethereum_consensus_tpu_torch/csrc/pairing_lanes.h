// The u64 build's four pairing kernels (pairing.cu) as crews of threads that
// share one lane: a lane's values live in shared memory as "slots", and the
// lane's work is a fixed schedule of steps. A step is a row of independent
// ops: Fp2 products and small linear combinations of slots. Each product is
// three Fp products (units), each linear op two (a component each); the
// crew's threads take the step's units in turn, sync, combine each
// product's three parts into its Fp2 value (a component a unit), and sync
// again. No op of a step reads a slot that another op of the step writes
// (check_steps).
//
//   miller_crew          a warp per lane: f (6 slots), T (3) and the lane's
//                        products. A doubling iteration is 8 steps, 4 with
//                        products: the 18 products of f^2 beside T's first
//                        4 (66 units), T's next 6, T's last 3 beside the 6
//                        line products with c11, the other 12 line products;
//                        with the addition 15 steps.
//   g2_crew              [k] Q (double-and-add, MSB first) or p + q, on the
//                        reference's formulas and selects: steps of at most
//                        4 products, a warp a lane in the lanes pass, 4
//                        threads an addition in the fold.
//   fq12::mul_crew       a * b in Fq12 for the product's fold, a warp a
//                        product: Karatsuba over the w-halves of Karatsuba
//                        Fq6 products, 18 Fp2 products (54 units) in one
//                        step, one step of linear sums before it, two after.
//   g1::mul_affine_crew  [k] P, then affine, on Fp slots (run_fp_steps: an
//                        op is one Fp product of two short linear sums, or
//                        one linear sum, one op a thread): a doubling is 3
//                        product steps and a linear one, the mixed addition
//                        4 and 1; the inverse of z is one thread's binary
//                        extended Euclid, not a Fermat chain.
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
  // on Fp slots (run_fp_steps)
  kFpMul = 5,  // out = (the sum of the first pad0 terms) * (the sum of the rest)
  kFpLin = 6,  // out = the sum of up to kTerms terms c * slot
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
#define FMUL(o, na, ...) {kFpMul, (o), (na), 0, {__VA_ARGS__}}
#define FLIN(o, ...) {kFpLin, (o), 0, 0, {__VA_ARGS__}}

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

// A crew's sync (Crew, or the G1 crew's FpCrew): its threads' __syncwarp.
template <typename C>
LANES_HD void crew_sync(const C& c) {
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
// slot, or one reads a slot another writes, itself included), not in
// run_steps' order or, for an Fp product, without two operands, or -1.
template <int W>
inline int check_steps(const Op (*steps)[W], int count, int slots) {
  for (int k = 0; k < count; ++k) {
    // products, then linear ops, then idle threads
    int order = 0;
    for (int t = 0; t < W; ++t) {
      const int kind = steps[k][t].kind;
      const int rank = is_product(kind) || kind == kFpMul ? 0 : kind == kLin || kind == kFpLin ? 1 : 2;
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
      if (op.kind == kFpMul) {
        for (int i = 0; i < op.pad0 && i < kTerms; ++i) {
          if ((op.arg[i] >> 8) == 0) return k;
        }
        if (op.pad0 < 1 || op.pad0 >= kTerms || (op.arg[op.pad0] >> 8) == 0) return k;
      }
      const bool terms = op.kind == kLin || op.kind == kFpLin || op.kind == kFpMul;
      for (int i = 0; i < kTerms; ++i) {
        const uint16_t arg = op.arg[i];
        if (terms ? (arg >> 8) == 0 : i >= 2) continue;
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
// Fq12: a * b for the product's fold, a warp a product
// ---------------------------------------------------------------------------

constexpr int kFp12Width = 24;    // the widest step: the operands' 24 sums
constexpr int kFp12Products = 18;  // the product step's Fp2 products

// The slots and the table live in their own namespace: their names repeat
// the Miller loop's.
namespace fq12 {

// Karatsuba over the w-halves, t0 = a.c0 b.c0, t1 = a.c1 b.c1, t2 = (a.c0 +
// a.c1)(b.c0 + b.c1), each a Karatsuba Fq6 product x y: with v_i = x_i y_i
// and m_ij = (x_i + x_j)(y_i + y_j), t = (v0 + xi (m12 - v1 - v2), m01 - v0 -
// v1 + xi v2, m02 - v0 - v2 + v1); then a b = (t0 + v t1) + (t2 - t0 - t1) w.
enum Slot : int {
  FA0, FA1, FA2, FA3, FA4, FA5,  // a: c0.a0, c0.a1, c0.a2, c1.a0, c1.a1, c1.a2; a b lands here
  FB0, FB1, FB2, FB3, FB4, FB5,  // b
  // the operands: SA = a.c0 + a.c1, SB = b.c0 + b.c1, and for the factors of
  // t_i their pair sums x0 + x1, x1 + x2, x0 + x2 (KiA for a's, KiB for b's)
  SA0, SA1, SA2, SB0, SB1, SB2,
  K0A01, K0A12, K0A02, K0B01, K0B12, K0B02,
  K1A01, K1A12, K1A02, K1B01, K1B12, K1B02,
  K2A01, K2A12, K2A02, K2B01, K2B12, K2B02,
  // t_i's products v0, v1, v2, m01, m12, m02
  P00, P01, P02, P03, P04, P05,
  P10, P11, P12, P13, P14, P15,
  P20, P21, P22, P23, P24, P25,
  kSlots,
  // t_i's coefficients reuse the operands' slots
  T00 = SA0, T01, T02, T10, T11, T12, T20, T21, T22,
};
static_assert(kSlots <= 128, "slot indices are 7 bits");

#define FP12_PAIRS(k, x0, x1, x2, y0, y1, y2)                                        \
  LIN(K##k##A01, LT(x0, 1), LT(x1, 1)), LIN(K##k##A12, LT(x1, 1), LT(x2, 1)),        \
      LIN(K##k##A02, LT(x0, 1), LT(x2, 1)), LIN(K##k##B01, LT(y0, 1), LT(y1, 1)),    \
      LIN(K##k##B12, LT(y1, 1), LT(y2, 1)), LIN(K##k##B02, LT(y0, 1), LT(y2, 1))
#define FP12_PRODUCTS(k, x0, x1, x2, y0, y1, y2)                                     \
  MUL(P##k##0, x0, y0), MUL(P##k##1, x1, y1), MUL(P##k##2, x2, y2),                  \
      MUL(P##k##3, K##k##A01, K##k##B01), MUL(P##k##4, K##k##A12, K##k##B12),        \
      MUL(P##k##5, K##k##A02, K##k##B02)
#define FP12_COEFFS(k)                                                                \
  LIN(T##k##0, LT(P##k##0, 1), LX(P##k##4, 1), LX(P##k##1, -1), LX(P##k##2, -1)),    \
      LIN(T##k##1, LT(P##k##3, 1), LT(P##k##0, -1), LT(P##k##1, -1), LX(P##k##2, 1)), \
      LIN(T##k##2, LT(P##k##5, 1), LT(P##k##0, -1), LT(P##k##2, -1), LT(P##k##1, 1))

#define FP12_MUL_STEPS 4
#define FP12_MUL_TABLE                                                                \
  {{LIN(SA0, LT(FA0, 1), LT(FA3, 1)), LIN(SA1, LT(FA1, 1), LT(FA4, 1)),               \
    LIN(SA2, LT(FA2, 1), LT(FA5, 1)), LIN(SB0, LT(FB0, 1), LT(FB3, 1)),               \
    LIN(SB1, LT(FB1, 1), LT(FB4, 1)), LIN(SB2, LT(FB2, 1), LT(FB5, 1)),               \
    FP12_PAIRS(0, FA0, FA1, FA2, FB0, FB1, FB2), FP12_PAIRS(1, FA3, FA4, FA5, FB3, FB4, FB5), \
    LIN(K2A01, LT(FA0, 1), LT(FA3, 1), LT(FA1, 1), LT(FA4, 1)),                       \
    LIN(K2A12, LT(FA1, 1), LT(FA4, 1), LT(FA2, 1), LT(FA5, 1)),                       \
    LIN(K2A02, LT(FA0, 1), LT(FA3, 1), LT(FA2, 1), LT(FA5, 1)),                       \
    LIN(K2B01, LT(FB0, 1), LT(FB3, 1), LT(FB1, 1), LT(FB4, 1)),                       \
    LIN(K2B12, LT(FB1, 1), LT(FB4, 1), LT(FB2, 1), LT(FB5, 1)),                       \
    LIN(K2B02, LT(FB0, 1), LT(FB3, 1), LT(FB2, 1), LT(FB5, 1))},                      \
   {FP12_PRODUCTS(0, FA0, FA1, FA2, FB0, FB1, FB2),                                   \
    FP12_PRODUCTS(1, FA3, FA4, FA5, FB3, FB4, FB5),                                   \
    FP12_PRODUCTS(2, SA0, SA1, SA2, SB0, SB1, SB2)},                                  \
   {FP12_COEFFS(0), FP12_COEFFS(1), FP12_COEFFS(2)},                                  \
   {LIN(FA0, LT(T00, 1), LX(T12, 1)), LIN(FA1, LT(T01, 1), LT(T10, 1)),               \
    LIN(FA2, LT(T02, 1), LT(T11, 1)), LIN(FA3, LT(T20, 1), LT(T00, -1), LT(T10, -1)), \
    LIN(FA4, LT(T21, 1), LT(T01, -1), LT(T11, -1)),                                   \
    LIN(FA5, LT(T22, 1), LT(T02, -1), LT(T12, -1))}}

#ifdef __CUDACC__
__device__ const Op kMulDev[FP12_MUL_STEPS][kFp12Width] = FP12_MUL_TABLE;
#endif
static const Op kMulHost[FP12_MUL_STEPS][kFp12Width] = FP12_MUL_TABLE;

// FA <- FA * FB on the crew's slots (all loaded, Montgomery).
LANES_HD void mul_crew(const Crew& c) {
#ifdef __CUDA_ARCH__
  run_steps(c, kMulDev, FP12_MUL_STEPS);
#else
  run_steps(c, kMulHost, FP12_MUL_STEPS);
#endif
}

}  // namespace fq12

// ---------------------------------------------------------------------------
// G1: [k] P, then affine, on Fp slots
// ---------------------------------------------------------------------------

// The threads that share a G1 lane: as Crew, with Fp slots and no scratch
// (an Fp product is one thread's).
struct FpCrew {
  Fp* s;
  int t;
  int threads;
  unsigned mask;
};

// The sum of terms [0, count) of a term list on Fp slots (LT: no xi); a
// zero coefficient ends it.
LANES_HD Fp fp_terms(const Fp* s, const uint16_t* terms, int count) {
  Fp acc = fp381::zero();
  for (int k = 0; k < count; ++k) {
    const int coeff = static_cast<int8_t>(terms[k] >> 8);
    if (coeff == 0) break;
    const Fp x = small_multiple(s[terms[k] & 0x7f], coeff < 0 ? -coeff : coeff);
    acc = k == 0 && coeff > 0 ? x : coeff < 0 ? fp381::sub(acc, x) : fp381::add(acc, x);
  }
  return acc;
}

// One Fp op: its inputs are read before its output is written.
LANES_HD void fp_op(Fp* s, const Op& op) {
  const bool product = op.kind == kFpMul;
  const int split = product ? op.pad0 : kTerms;
  const Fp x = fp_terms(s, op.arg, split);
  s[op.out] = product ? fp381::mul(x, fp_terms(s, op.arg + split, kTerms - split)) : x;
}

// Steps [0, count) of a table of W-wide steps of Fp ops: thread t of the
// crew runs ops t, t + threads, ... of each row, then the crew syncs. On the
// host the ops run in turn.
template <int W>
LANES_HD void run_fp_steps(const FpCrew& c, const Op (*steps)[W], int count) {
#ifdef __CUDA_ARCH__
  const int first = c.t;
  const int stride = c.threads;
#else
  const int first = 0;
  const int stride = 1;
#endif
  TOWER_ROLLED
  for (int k = 0; k < count; ++k) {
    for (int t = first; t < W; t += stride) {
      if (steps[k][t].kind != kNone) fp_op(c.s, steps[k][t]);
    }
    crew_sync(c);
  }
}

// R^3 mod p: a plain inverse of a Montgomery value aR, times R^3 by one
// Montgomery product, is the Montgomery value of a^-1
#define FP381_R3_LIMBS                                                    \
  0xd94ca1e0u, 0xed48ac6bu, 0x03a7adf8u, 0x315f831eu, 0x615e29ddu,        \
      0x9a53352au, 0x921e1761u, 0x34c04e5eu, 0x65724728u, 0x2512d435u,    \
      0x91755d4du, 0x0aa63460u

// Raw 12-limb helpers of the inverse
LANES_HD bool limbs_are_one(const uint32_t* a) {
  uint32_t rest = a[0] ^ 1u;
  FP381_UNROLL
  for (int i = 1; i < fp381::kLimbs; ++i) rest |= a[i];
  return rest == 0;
}

LANES_HD void shift_right_one(uint32_t* a) {
  FP381_UNROLL
  for (int i = 0; i < fp381::kLimbs - 1; ++i) a[i] = (a[i] >> 1) | (a[i + 1] << 31);
  a[fp381::kLimbs - 1] >>= 1;
}

// a - b into d; the borrow out
LANES_HD uint32_t limbs_sub(const uint32_t* a, const uint32_t* b, uint32_t* d) {
  uint64_t borrow = 0;
  FP381_UNROLL
  for (int i = 0; i < fp381::kLimbs; ++i) {
    const uint64_t diff = static_cast<uint64_t>(a[i]) - b[i] - borrow;
    d[i] = static_cast<uint32_t>(diff);
    borrow = (diff >> 32) & 1;
  }
  return static_cast<uint32_t>(borrow);
}

// x / 2 mod p for x in [0, p): (x + p) / 2 when x is odd (x + p < 2^382)
LANES_HD void half_mod(Fp& x) {
  const uint32_t p[fp381::kLimbs] = {FP381_P_LIMBS};
  const uint32_t mask = (x.v[0] & 1u) ? 0xffffffffu : 0u;
  uint64_t carry = 0;
  FP381_UNROLL
  for (int i = 0; i < fp381::kLimbs; ++i) {
    const uint64_t sum = static_cast<uint64_t>(x.v[i]) + (p[i] & mask) + carry;
    x.v[i] = static_cast<uint32_t>(sum);
    carry = sum >> 32;
  }
  shift_right_one(x.v);
}

// a^-1 in Montgomery form for a Montgomery a (0 for 0): the binary extended
// Euclid on the plain value (Guide to Elliptic Curve Cryptography, Alg.
// 2.22; x1 a = u and x2 a = v mod p throughout), then one product by R^3.
// Its halvings (534 on average, at most 762) and subtractions (267) are
// shifts and 12-limb subtractions, against the Fermat chain's 380 dependent
// squarings; it runs in variable time, on public data only (public keys, and
// blinders drawn after the sets are fixed).
LANES_HD Fp mont_inverse(const Fp& a) {
  if (fp381::is_zero(a)) return a;
  Fp u = a, v, x1 = fp381::zero(), x2 = fp381::zero();
  const uint32_t p[fp381::kLimbs] = {FP381_P_LIMBS};
  FP381_UNROLL
  for (int i = 0; i < fp381::kLimbs; ++i) v.v[i] = p[i];
  x1.v[0] = 1;
  while (!limbs_are_one(u.v) && !limbs_are_one(v.v)) {
    while (!(u.v[0] & 1u)) {
      shift_right_one(u.v);
      half_mod(x1);
    }
    while (!(v.v[0] & 1u)) {
      shift_right_one(v.v);
      half_mod(x2);
    }
    Fp d;
    if (!limbs_sub(u.v, v.v, d.v)) {  // u >= v
      u = d;
      x1 = fp381::sub(x1, x2);
    } else {
      limbs_sub(v.v, u.v, v.v);
      x2 = fp381::sub(x2, x1);
    }
  }
  const uint32_t r3[fp381::kLimbs] = {FP381_R3_LIMBS};
  Fp r3_fp;
  FP381_UNROLL
  for (int i = 0; i < fp381::kLimbs; ++i) r3_fp.v[i] = r3[i];
  return fp381::mul(limbs_are_one(u.v) ? x1 : x2, r3_fp);
}

constexpr int kG1Width = 8;  // the widest step of the G1 tables

// As fq12: the slot names repeat the G2 and Miller schedules'.
namespace g1 {

enum Slot : int {
  PX, PY,      // P, affine; the affine result lands here
  X1, Y1, Z1,  // the accumulator
  // the doubling: a = x^2, b = y^2, yz = y z, c = b^2, xb2 = (x + b)^2,
  // esq = (3a)^2, em = 3a (d - x3)
  DA, DB, DYZ, DC, DXB2, DESQ, DEM,
  // the mixed addition: zz = z^2, yz = yp z, u2 = xp zz, s2 = yz zz,
  // h = u2 - x, r = 2 (s2 - y), then hh = h^2, rr = r^2, zh = z h, rx = r x,
  // rh = r h, yh = y h, j = h hh, v = x hh, and rx hh, r rr, rh hh, yh hh
  AZZ, AYZ, AU2, AS2, AH, AR, AHH, ARR, AZH, ARX, ARH, AYH,
  AJ, AV, ARXH, ARRR, ARHH, AYHH,
  // the affine conversion: z^-1, z^-2, y z^-1
  ZI, ZI2, YZI,
  kSlots,
};
static_assert(kSlots <= 128, "slot indices are 7 bits");

// dbl-2009-l: x3 = e^2 - 2d, y3 = e (d - x3) - 8c, z3 = 2 y z with e = 3a,
// d = 2 ((x + b)^2 - a - c); taken as x3 = esq - 4 xb2 + 4a + 4c and d - x3 =
// 6 xb2 - 6a - 6c - esq. Infinity (z = 0) stays infinity.
#define G1_DBL_STEPS 4
#define G1_DBL                                                                        \
  {FMUL(DA, 1, LT(X1, 1), LT(X1, 1)), FMUL(DB, 1, LT(Y1, 1), LT(Y1, 1)),              \
   FMUL(DYZ, 1, LT(Y1, 1), LT(Z1, 1))},                                               \
  {FMUL(DC, 1, LT(DB, 1), LT(DB, 1)),                                                 \
   FMUL(DXB2, 2, LT(X1, 1), LT(DB, 1), LT(X1, 1), LT(DB, 1)),                         \
   FMUL(DESQ, 1, LT(DA, 3), LT(DA, 3)), FLIN(Z1, LT(DYZ, 2))},                        \
  {FMUL(DEM, 1, LT(DA, 3), LT(DXB2, 6), LT(DA, -6), LT(DC, -6), LT(DESQ, -1)),        \
   FLIN(X1, LT(DESQ, 1), LT(DXB2, -4), LT(DA, 4), LT(DC, 4))},                        \
  {FLIN(Y1, LT(DEM, 1), LT(DC, -8))}

// madd-2007-bl (add-2007-bl at z2 = 1): with i = 4hh, j = h i, v = x i,
// x3 = r^2 - j - 2v, y3 = r (v - x3) - 2 y j, z3 = 2 z h; taken as x3 = rr -
// 4 AJ - 8 AV and y3 = 12 (rx hh) - r rr + 4 (rh hh) - 8 (yh hh), so the
// products after h and r are two steps deep. The head ends with h and r,
// which choose the rest.
#define G1_H LT(AU2, 1), LT(X1, -1)
#define G1_R LT(AS2, 2), LT(Y1, -2)
#define G1_HEAD_STEPS 3
#define G1_HEAD                                                                       \
  {FMUL(AZZ, 1, LT(Z1, 1), LT(Z1, 1)), FMUL(AYZ, 1, LT(PY, 1), LT(Z1, 1))},           \
  {FMUL(AU2, 1, LT(PX, 1), LT(AZZ, 1)), FMUL(AS2, 1, LT(AYZ, 1), LT(AZZ, 1))},        \
  {FMUL(AHH, 2, G1_H, G1_H), FMUL(ARR, 2, G1_R, G1_R), FMUL(AZH, 1, LT(Z1, 1), G1_H), \
   FMUL(ARX, 2, G1_R, LT(X1, 1)), FMUL(ARH, 2, G1_R, G1_H), FMUL(AYH, 1, LT(Y1, 1), G1_H), \
   FLIN(AH, G1_H), FLIN(AR, G1_R)}

#define G1_TAIL_STEPS 2
#define G1_TAIL                                                                       \
  {FMUL(AJ, 1, LT(AH, 1), LT(AHH, 1)), FMUL(AV, 1, LT(X1, 1), LT(AHH, 1)),            \
   FMUL(ARXH, 1, LT(ARX, 1), LT(AHH, 1)), FMUL(ARRR, 1, LT(AR, 1), LT(ARR, 1)),       \
   FMUL(ARHH, 1, LT(ARH, 1), LT(AHH, 1)), FMUL(AYHH, 1, LT(AYH, 1), LT(AHH, 1)),      \
   FLIN(Z1, LT(AZH, 2))},                                                             \
  {FLIN(X1, LT(ARR, 1), LT(AJ, -4), LT(AV, -8)),                                      \
   FLIN(Y1, LT(ARXH, 12), LT(ARRR, -1), LT(ARHH, 4), LT(AYHH, -8))}

// x = X z^-2, y = (Y z^-1) z^-2 into PX, PY, after ZI = z^-1
#define G1_AFFINE_STEPS 2
#define G1_AFFINE                                                                     \
  {FMUL(ZI2, 1, LT(ZI, 1), LT(ZI, 1)), FMUL(YZI, 1, LT(Y1, 1), LT(ZI, 1))},           \
  {FMUL(PX, 1, LT(X1, 1), LT(ZI2, 1)), FMUL(PY, 1, LT(YZI, 1), LT(ZI2, 1))}

enum G1Range : int {
  kG1Dbl = 0,
  kG1Head = kG1Dbl + G1_DBL_STEPS,
  kG1Tail = kG1Head + G1_HEAD_STEPS,
  kG1Affine = kG1Tail + G1_TAIL_STEPS,
  kG1Steps = kG1Affine + G1_AFFINE_STEPS,
};

#define G1_TABLE {G1_DBL, G1_HEAD, G1_TAIL, G1_AFFINE}

#ifdef __CUDACC__
__device__ const Op kG1Dev[kG1Steps][kG1Width] = G1_TABLE;
#endif
static const Op kG1Host[kG1Steps][kG1Width] = G1_TABLE;

LANES_HD const Op (*g1_table())[kG1Width] {
#ifdef __CUDA_ARCH__
  return kG1Dev;
#else
  return kG1Host;
#endif
}

// The accumulator <- P (z = 1), or infinity (all zero); then a sync.
LANES_HD void crew_set_accumulator(const FpCrew& c, bool to_p) {
#ifdef __CUDA_ARCH__
  for (int i = c.t; i < 3; i += c.threads)
#else
  for (int i = 0; i < 3; ++i)
#endif
    c.s[X1 + i] = !to_p ? fp381::zero() : i < 2 ? c.s[PX + i] : fp381::one_mont();
  crew_sync(c);
}

// PX, PY <- [k] P, affine (all zero for infinity), for P = (PX, PY) with
// z = 1, as tower::g1_mul and the affine conversion (tower::fp_inv): the
// top bit's addition to infinity gives P; at a set bit an accumulator at
// infinity becomes P, else the mixed addition, whose h = 0 gives the
// doubling (r = 0) or infinity. Each Jacobian value is a rescaling of
// tower::g1_mul's (the mixed addition's doubled h and r), so every choice
// is the same and the affine result the same limb for limb. Every flag is
// read after a sync, by every thread of the crew, and the crew syncs again
// before it writes.
LANES_HD void mul_affine_crew(const FpCrew& c, const Scalar& k) {
  enum Phase { kNextBit, kAdd, kAfterHead, kInvert, kDone };
  int bit = 4 * 32;
  do --bit;
  while (bit >= 0 && !scalar_bit(k, bit));
  crew_set_accumulator(c, bit >= 0);
  int phase = kNextBit;
  int first = 0, count = 0;
  TOWER_ROLLED
  for (;;) {
    if (phase == kNextBit) {
      if (--bit < 0) {
        phase = kInvert;
        continue;
      }
      first = kG1Dbl;
      count = G1_DBL_STEPS;
      phase = scalar_bit(k, bit) ? kAdd : kNextBit;
    } else if (phase == kAdd) {
      const bool p_inf = fp381::is_zero(c.s[Z1]);
      crew_sync(c);
      if (p_inf) {
        crew_set_accumulator(c, true);
        phase = kNextBit;
        continue;
      }
      first = kG1Head;
      count = G1_HEAD_STEPS;
      phase = kAfterHead;
    } else if (phase == kAfterHead) {
      const bool h0 = fp381::is_zero(c.s[AH]), r0 = fp381::is_zero(c.s[AR]);
      crew_sync(c);
      if (h0 && !r0) {
        crew_set_accumulator(c, false);
        phase = kNextBit;
        continue;
      }
      first = h0 ? kG1Dbl : kG1Tail;
      count = h0 ? G1_DBL_STEPS : G1_TAIL_STEPS;
      phase = kNextBit;
    } else if (phase == kInvert) {
      if (c.t == 0) c.s[ZI] = mont_inverse(c.s[Z1]);
      crew_sync(c);
      first = kG1Affine;
      count = G1_AFFINE_STEPS;
      phase = kDone;
    } else {
      return;
    }
    run_fp_steps(c, g1_table() + first, count);
  }
}

}  // namespace g1

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

// [k] P for an affine P = (x, y) (z = 1), affine: xy[0], xy[1] (all zero
// for infinity), as tower::g1_mul and the affine conversion
inline void g1_mul_affine_host(const Fp& x, const Fp& y, const uint32_t* k, Fp* xy) {
  Fp s[g1::kSlots];
  for (auto& v : s) v = fp381::zero();
  s[g1::PX] = x;
  s[g1::PY] = y;
  g1::mul_affine_crew(FpCrew{s, 0, 1, 0}, Scalar{k[0], k[1], k[2], k[3]});
  xy[0] = s[g1::PX];
  xy[1] = s[g1::PY];
}

// a * b: tower::fp12_mul
inline tower::Fp12 fp12_mul_host(const tower::Fp12& a, const tower::Fp12& b) {
  Fp2 s[fq12::kSlots];
  for (auto& v : s) v = tower::fp2_zero();
  const Fp2 in[12] = {a.c0.a0, a.c0.a1, a.c0.a2, a.c1.a0, a.c1.a1, a.c1.a2,
                      b.c0.a0, b.c0.a1, b.c0.a2, b.c1.a0, b.c1.a1, b.c1.a2};
  for (int i = 0; i < 12; ++i) s[fq12::FA0 + i] = in[i];
  Fp scratch[3 * kFp12Products];
  fq12::mul_crew(Crew{s, scratch, 0, 1, 0});
  tower::Fp12 r;
  r.c0 = tower::Fp6{s[fq12::FA0], s[fq12::FA1], s[fq12::FA2]};
  r.c1 = tower::Fp6{s[fq12::FA3], s[fq12::FA4], s[fq12::FA5]};
  return r;
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
#undef FMUL
#undef FLIN
#undef FP12_PAIRS
#undef FP12_PRODUCTS
#undef FP12_COEFFS
#undef FP12_MUL_TABLE
#undef G1_DBL
#undef G1_H
#undef G1_R
#undef G1_HEAD
#undef G1_TAIL
#undef G1_AFFINE
#undef G1_TABLE
