// The BLS12-381 tower (Fp2, Fp6, Fp12), G1 and G2 Jacobian arithmetic of
// the RLC blinder multiplications, and the fused Miller-loop steps, as
// __host__ __device__ functions on top of fp381_core.h: the arithmetic of
// the batched pairing kernels in pairing.cu.
//
// The header is plain C++ outside nvcc, so g++ builds the same functions
// for the CPU tests that hold them against Python integers and against the
// native library's Miller loop.
//
// Tower (that of crypto/fields.py and native/bls12_381.cpp):
//   Fp2  = Fp[u]/(u^2 + 1)
//   Fp6  = Fp2[v]/(v^3 - xi), xi = u + 1
//   Fp12 = Fp6[w]/(w^2 - v)
// Every field value is fully reduced Montgomery (R = 2^384), so any
// correct product formula gives the same canonical value.
//
// What the formulas must copy: a Jacobian point's coordinates depend on the
// addition and doubling formulas, and a Miller value on how each line is
// scaled. The G2 formulas here are the reference's (ethereum_consensus_tpu
// ops/pairing.py g2_point_add, g2_point_double, with their selects as
// branches), so the Jacobian G2 sum agrees limb for limb; the Miller steps
// copy native/bls12_381.cpp miller_double_step and miller_add_step formula
// for formula, so each Miller value equals the native miller_loop_raw. The
// G1 multiplication ends affine, so it takes fp381_core.h's formulas.
//
// The big functions stay calls under nvcc (TOWER_CALL is __noinline__):
// inlined into the 63-step loop, the tower makes a kernel that takes nvcc
// minutes to build.

#pragma once

#include <stdint.h>

#include "fp381_core.h"

#ifdef __CUDACC__
#define TOWER_HD __host__ __device__ __forceinline__
#define TOWER_CALL __host__ __device__ __noinline__
#define TOWER_ROLLED _Pragma("unroll 1")
#else
#define TOWER_HD inline
#define TOWER_CALL inline
#define TOWER_ROLLED
#endif

namespace tower {

using fp381::Fp;
using fp381::G1Jac;

struct Fp2 {
  Fp c0, c1;
};
struct Fp6 {
  Fp2 a0, a1, a2;
};
struct Fp12 {
  Fp6 c0, c1;
};
struct G2Jac {
  Fp2 x, y, z;
};

// |x| of the BLS12-381 curve parameter (x itself is negative)
constexpr uint64_t kBlsXAbs = 0xd201000000010000ull;
constexpr int kScalarWords = 4;  // 128-bit blinders, least significant first

// ---------------------------------------------------------------------------
// Fp
// ---------------------------------------------------------------------------

TOWER_HD Fp fp_neg(const Fp& a) { return fp381::sub(fp381::zero(), a); }
TOWER_HD Fp fp_dbl(const Fp& a) { return fp381::add(a, a); }

// a^(p - 2): the inverse, 0 for 0. Square and multiply from the top bit.
TOWER_CALL Fp fp_inv(const Fp& a) {
  const uint32_t p[fp381::kLimbs] = {FP381_P_LIMBS};
  Fp acc = a;
  TOWER_ROLLED
  for (int bit = 379; bit >= 0; --bit) {
    // p - 2 differs from p only in its lowest limb (0x...aaab - 2)
    const uint32_t limb = bit < 32 ? p[0] - 2u : p[bit / 32];
    acc = fp381::sqr(acc);
    if ((limb >> (bit % 32)) & 1u) acc = fp381::mul(acc, a);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// Fp2
// ---------------------------------------------------------------------------

TOWER_HD Fp2 fp2_zero() { return Fp2{fp381::zero(), fp381::zero()}; }
TOWER_HD Fp2 fp2_one() { return Fp2{fp381::one_mont(), fp381::zero()}; }
TOWER_HD bool fp2_is_zero(const Fp2& a) {
  return fp381::is_zero(a.c0) && fp381::is_zero(a.c1);
}
TOWER_HD Fp2 fp2_add(const Fp2& a, const Fp2& b) {
  return Fp2{fp381::add(a.c0, b.c0), fp381::add(a.c1, b.c1)};
}
TOWER_HD Fp2 fp2_sub(const Fp2& a, const Fp2& b) {
  return Fp2{fp381::sub(a.c0, b.c0), fp381::sub(a.c1, b.c1)};
}
TOWER_HD Fp2 fp2_dbl(const Fp2& a) { return fp2_add(a, a); }
TOWER_HD Fp2 fp2_neg(const Fp2& a) { return Fp2{fp_neg(a.c0), fp_neg(a.c1)}; }
TOWER_HD Fp2 fp2_conj(const Fp2& a) { return Fp2{a.c0, fp_neg(a.c1)}; }
// a (u + 1) = (a0 - a1) + (a0 + a1) u
TOWER_HD Fp2 fp2_mul_by_xi(const Fp2& a) {
  return Fp2{fp381::sub(a.c0, a.c1), fp381::add(a.c0, a.c1)};
}
TOWER_HD Fp2 fp2_scalar_mul(const Fp2& a, const Fp& k) {
  return Fp2{fp381::mul(a.c0, k), fp381::mul(a.c1, k)};
}

// Karatsuba: three Fp products
TOWER_CALL Fp2 fp2_mul(const Fp2& a, const Fp2& b) {
  const Fp t0 = fp381::mul(a.c0, b.c0);
  const Fp t1 = fp381::mul(a.c1, b.c1);
  const Fp t2 = fp381::mul(fp381::add(a.c0, a.c1), fp381::add(b.c0, b.c1));
  return Fp2{fp381::sub(t0, t1), fp381::sub(fp381::sub(t2, t0), t1)};
}

// (a0 + a1)(a0 - a1) + 2 a0 a1 u: two Fp products
TOWER_CALL Fp2 fp2_sqr(const Fp2& a) {
  const Fp t = fp381::mul(a.c0, a.c1);
  return Fp2{fp381::mul(fp381::add(a.c0, a.c1), fp381::sub(a.c0, a.c1)), fp_dbl(t)};
}

// (a0 - a1 u) / (a0^2 + a1^2); 0 for 0
TOWER_CALL Fp2 fp2_inv(const Fp2& a) {
  const Fp norm_inv = fp_inv(fp381::add(fp381::sqr(a.c0), fp381::sqr(a.c1)));
  return Fp2{fp381::mul(a.c0, norm_inv), fp381::mul(fp_neg(a.c1), norm_inv)};
}

// ---------------------------------------------------------------------------
// Fp6 and Fp12
// ---------------------------------------------------------------------------

TOWER_HD Fp6 fp6_add(const Fp6& a, const Fp6& b) {
  return Fp6{fp2_add(a.a0, b.a0), fp2_add(a.a1, b.a1), fp2_add(a.a2, b.a2)};
}
TOWER_HD Fp6 fp6_sub(const Fp6& a, const Fp6& b) {
  return Fp6{fp2_sub(a.a0, b.a0), fp2_sub(a.a1, b.a1), fp2_sub(a.a2, b.a2)};
}
TOWER_HD Fp6 fp6_neg(const Fp6& a) {
  return Fp6{fp2_neg(a.a0), fp2_neg(a.a1), fp2_neg(a.a2)};
}
// (a0, a1, a2) v = (xi a2, a0, a1)
TOWER_HD Fp6 fp6_mul_by_v(const Fp6& a) { return Fp6{fp2_mul_by_xi(a.a2), a.a0, a.a1}; }

// schoolbook: c0 = a0b0 + xi(a1b2 + a2b1), c1 = a0b1 + a1b0 + xi(a2b2),
// c2 = a0b2 + a1b1 + a2b0
TOWER_CALL Fp6 fp6_mul(const Fp6& a, const Fp6& b) {
  Fp6 c;
  c.a0 = fp2_add(fp2_mul(a.a0, b.a0),
                 fp2_mul_by_xi(fp2_add(fp2_mul(a.a1, b.a2), fp2_mul(a.a2, b.a1))));
  c.a1 = fp2_add(fp2_add(fp2_mul(a.a0, b.a1), fp2_mul(a.a1, b.a0)),
                 fp2_mul_by_xi(fp2_mul(a.a2, b.a2)));
  c.a2 = fp2_add(fp2_add(fp2_mul(a.a0, b.a2), fp2_mul(a.a1, b.a1)), fp2_mul(a.a2, b.a0));
  return c;
}

TOWER_HD Fp12 fp12_one() {
  Fp12 r;
  r.c0 = Fp6{fp2_one(), fp2_zero(), fp2_zero()};
  r.c1 = Fp6{fp2_zero(), fp2_zero(), fp2_zero()};
  return r;
}

// Karatsuba over the w-halves: three Fp6 products
TOWER_CALL Fp12 fp12_mul(const Fp12& a, const Fp12& b) {
  const Fp6 t0 = fp6_mul(a.c0, b.c0);
  const Fp6 t1 = fp6_mul(a.c1, b.c1);
  const Fp6 t2 = fp6_mul(fp6_add(a.c0, a.c1), fp6_add(b.c0, b.c1));
  return Fp12{fp6_add(t0, fp6_mul_by_v(t1)), fp6_sub(fp6_sub(t2, t0), t1)};
}

// complex squaring: two Fp6 products
TOWER_CALL Fp12 fp12_sqr(const Fp12& a) {
  const Fp6 u = fp6_mul(a.c0, a.c1);
  const Fp6 t = fp6_sub(fp6_mul(fp6_add(a.c0, a.c1), fp6_add(a.c0, fp6_mul_by_v(a.c1))), u);
  return Fp12{fp6_sub(t, fp6_mul_by_v(u)), fp6_add(u, u)};
}

// a^(p^6): negate the w-half
TOWER_HD Fp12 fp12_conj(const Fp12& a) { return Fp12{a.c0, fp6_neg(a.c1)}; }

// f (A + B w) with A = (c00, 0, 0), B = (0, c11, c12): the sparse line
// product (native fp12_mul_by_line)
TOWER_CALL Fp12 fp12_mul_by_line(const Fp12& f, const Fp2& c00, const Fp2& c11,
                                 const Fp2& c12) {
  const Fp6 t0{fp2_mul(f.c0.a0, c00), fp2_mul(f.c0.a1, c00), fp2_mul(f.c0.a2, c00)};
  Fp6 t1;
  t1.a0 = fp2_mul_by_xi(fp2_add(fp2_mul(f.c1.a1, c12), fp2_mul(f.c1.a2, c11)));
  t1.a1 = fp2_add(fp2_mul(f.c1.a0, c11), fp2_mul_by_xi(fp2_mul(f.c1.a2, c12)));
  t1.a2 = fp2_add(fp2_mul(f.c1.a0, c12), fp2_mul(f.c1.a1, c11));
  const Fp6 t2 = fp6_mul(fp6_add(f.c0, f.c1), Fp6{c00, c11, c12});
  return Fp12{fp6_add(t0, fp6_mul_by_v(t1)), fp6_sub(fp6_sub(t2, t0), t1)};
}

// ---------------------------------------------------------------------------
// G1: [k] P on the complete Jacobian formulas of fp381_core.h (those of the
// G1 set sums). The kernel's output is affine, so the choice of formulas
// cannot change it.
// ---------------------------------------------------------------------------

// [k] P for a 128-bit k, MSB first from the point at infinity: double, then
// add P where the bit is set (the reference's _mul_scan_g1)
TOWER_CALL G1Jac g1_mul(const G1Jac& p, const uint32_t* k) {
  G1Jac acc = fp381::g1_infinity();
  TOWER_ROLLED
  for (int bit = 32 * kScalarWords - 1; bit >= 0; --bit) {
    acc = fp381::g1_double(acc);
    if ((k[bit / 32] >> (bit % 32)) & 1u) acc = fp381::g1_add(acc, p);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// G2: the reference's g2_point_double and g2_point_add
// ---------------------------------------------------------------------------

TOWER_HD G2Jac g2_infinity() { return G2Jac{fp2_zero(), fp2_zero(), fp2_zero()}; }

// dbl-2009-l; infinity stays infinity
TOWER_CALL G2Jac g2_dbl(const G2Jac& p) {
  const Fp2 a = fp2_sqr(p.x);
  const Fp2 b = fp2_sqr(p.y);
  const Fp2 c = fp2_sqr(b);
  Fp2 d = fp2_sub(fp2_sub(fp2_sqr(fp2_add(p.x, b)), a), c);
  d = fp2_dbl(d);
  const Fp2 e = fp2_add(fp2_dbl(a), a);
  G2Jac r;
  r.x = fp2_sub(fp2_sqr(e), fp2_dbl(d));
  const Fp2 c8 = fp2_dbl(fp2_dbl(fp2_dbl(c)));
  r.y = fp2_sub(fp2_mul(e, fp2_sub(d, r.x)), c8);
  r.z = fp2_dbl(fp2_mul(p.y, p.z));
  return r;
}

// add-2007-bl with the doubled slopes (2h, 2r) of the reference's
// g2_point_add, and its selects in its order: q at infinity gives p, else p
// at infinity q, else P == -Q infinity, else P == Q the doubling.
TOWER_CALL G2Jac g2_add(const G2Jac& p, const G2Jac& q) {
  if (fp2_is_zero(q.z)) return p;
  if (fp2_is_zero(p.z)) return q;
  const Fp2 z1z1 = fp2_sqr(p.z);
  const Fp2 z2z2 = fp2_sqr(q.z);
  const Fp2 u1 = fp2_mul(p.x, z2z2);
  const Fp2 u2 = fp2_mul(q.x, z1z1);
  const Fp2 s1 = fp2_mul(fp2_mul(p.y, q.z), z2z2);
  const Fp2 s2 = fp2_mul(fp2_mul(q.y, p.z), z1z1);
  const Fp2 h = fp2_sub(u2, u1);
  const Fp2 r = fp2_sub(s2, s1);
  if (fp2_is_zero(h)) return fp2_is_zero(r) ? g2_dbl(p) : g2_infinity();
  const Fp2 i4 = fp2_sqr(fp2_dbl(h));
  const Fp2 j = fp2_mul(h, i4);
  const Fp2 v = fp2_mul(u1, i4);
  const Fp2 r2 = fp2_dbl(r);
  G2Jac out;
  out.x = fp2_sub(fp2_sub(fp2_sqr(r2), j), fp2_dbl(v));
  out.y = fp2_sub(fp2_mul(r2, fp2_sub(v, out.x)), fp2_dbl(fp2_mul(s1, j)));
  out.z = fp2_mul(fp2_dbl(fp2_mul(p.z, q.z)), h);
  return out;
}

TOWER_CALL G2Jac g2_mul(const G2Jac& p, const uint32_t* k) {
  G2Jac acc = g2_infinity();
  TOWER_ROLLED
  for (int bit = 32 * kScalarWords - 1; bit >= 0; --bit) {
    acc = g2_dbl(acc);
    if ((k[bit / 32] >> (bit % 32)) & 1u) acc = g2_add(acc, p);
  }
  return acc;
}

// ---------------------------------------------------------------------------
// The Miller loop (native miller_double_step, miller_add_step,
// multi_miller_loop for one pair)
// ---------------------------------------------------------------------------

// tangent line at T evaluated at (xp, yp), multiplied into f, fused with
// T <- 2T (dbl-2009-l)
TOWER_CALL void miller_double_step(Fp12& f, G2Jac& t, const Fp& xp, const Fp& yp) {
  const Fp2 x = t.x, y = t.y, z = t.z;
  const Fp2 a = fp2_sqr(x);  // X^2
  const Fp2 b = fp2_sqr(y);  // Y^2
  const Fp2 c = fp2_sqr(b);  // Y^4
  const Fp2 z2 = fp2_sqr(z);
  const Fp2 z3c = fp2_mul(z2, z);
  // c00 = -xi (2 Y Z^3 yp)
  const Fp2 c00 = fp2_neg(fp2_mul_by_xi(fp2_scalar_mul(fp2_dbl(fp2_mul(y, z3c)), yp)));
  // c11 = 2 Y^2 - 3 X^3
  const Fp2 x3c = fp2_mul(a, x);
  const Fp2 c11 = fp2_sub(fp2_dbl(b), fp2_add(fp2_add(x3c, x3c), x3c));
  // c12 = 3 X^2 Z^2 xp (E = 3 X^2 is also the doubling's slope term)
  const Fp2 e = fp2_add(fp2_add(a, a), a);
  const Fp2 c12 = fp2_scalar_mul(fp2_mul(e, z2), xp);
  f = fp12_mul_by_line(f, c00, c11, c12);
  // T <- 2T reusing a, b, c, e
  Fp2 d = fp2_sub(fp2_sub(fp2_sqr(fp2_add(x, b)), a), c);
  d = fp2_dbl(d);
  const Fp2 x3 = fp2_sub(fp2_sub(fp2_sqr(e), d), d);
  const Fp2 c8 = fp2_dbl(fp2_dbl(fp2_dbl(c)));
  t.y = fp2_sub(fp2_mul(e, fp2_sub(d, x3)), c8);
  t.z = fp2_dbl(fp2_mul(y, z));
  t.x = x3;
}

// line through T and the affine (xq, yq) evaluated at (xp, yp), multiplied
// into f, fused with the mixed addition T <- T + Q (madd-2007-bl). T == +-Q
// never occurs inside the loop (T = [k]Q with 1 < k < |x|, far below r).
TOWER_CALL void miller_add_step(Fp12& f, G2Jac& t, const Fp& xp, const Fp& yp,
                                const Fp2& xq, const Fp2& yq) {
  const Fp2 x = t.x, y = t.y, z = t.z;
  const Fp2 z2 = fp2_sqr(z);
  const Fp2 z3c = fp2_mul(z2, z);
  const Fp2 u2 = fp2_mul(xq, z2);   // xq Z^2
  const Fp2 s2 = fp2_mul(yq, z3c);  // yq Z^3
  const Fp2 lam_n = fp2_sub(y, s2);
  const Fp2 lam_d = fp2_mul(fp2_sub(x, u2), z);
  const Fp2 c00 = fp2_neg(fp2_mul_by_xi(fp2_scalar_mul(lam_d, yp)));
  const Fp2 c11 = fp2_sub(fp2_mul(yq, lam_d), fp2_mul(lam_n, xq));
  const Fp2 c12 = fp2_scalar_mul(lam_n, xp);
  f = fp12_mul_by_line(f, c00, c11, c12);
  // T <- T + Q reusing z2, u2, s2
  const Fp2 h = fp2_sub(u2, x);
  const Fp2 hh = fp2_sqr(h);
  const Fp2 i4 = fp2_dbl(fp2_dbl(hh));
  const Fp2 j = fp2_mul(h, i4);
  const Fp2 rr = fp2_dbl(fp2_sub(s2, y));
  const Fp2 v = fp2_mul(x, i4);
  const Fp2 x3 = fp2_sub(fp2_sub(fp2_sub(fp2_sqr(rr), j), v), v);
  t.y = fp2_sub(fp2_mul(rr, fp2_sub(v, x3)), fp2_dbl(fp2_mul(y, j)));
  t.z = fp2_sub(fp2_sub(fp2_sqr(fp2_add(z, h)), z2), hh);
  t.x = x3;
}

// f_{|x|,Q}(P), conjugated for the negative x; (xp, yp) and (xq, yq) are
// finite affine points in Montgomery form
TOWER_CALL Fp12 miller_loop(const Fp& xp, const Fp& yp, const Fp2& xq, const Fp2& yq) {
  G2Jac t{xq, yq, fp2_one()};
  Fp12 f = fp12_one();
  TOWER_ROLLED
  for (int bit = 62; bit >= 0; --bit) {  // the bits below the top bit of |x|
    f = fp12_sqr(f);
    miller_double_step(f, t, xp, yp);
    if ((kBlsXAbs >> bit) & 1u) miller_add_step(f, t, xp, yp, xq, yq);
  }
  return fp12_conj(f);
}

}  // namespace tower
