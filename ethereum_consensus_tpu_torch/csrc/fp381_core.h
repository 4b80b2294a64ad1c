// BLS12-381 base field Fp and G1 Jacobian point arithmetic, as
// __host__ __device__ functions.
//
// The arithmetic of the Hopper kernel in g1_sum.cu. The header is plain
// C++ outside nvcc (the qualifier macro is empty there), so g++ builds the
// same functions for the CPU tests that hold them against Python integers
// and against the native BLS library.
//
// Field: 12 x 32-bit limbs, least significant first, in Montgomery form
// with R = 2^384. Multiplication is CIOS (coarsely integrated operand
// scanning) with 32x32->64-bit products; every operation returns a fully
// reduced value in [0, p).
//
// The multiplier is a compile-time policy: by default mul is the CIOS
// product below; built with -DFP381_MUL_MXU it is the warp-cooperative int8
// tensor-core product of fp_mma.h (the reference's EC_PAIRING_MULT=mxu), a
// call (not inlined), and every thread of a warp must then hold the same
// operands. Either gives the same canonical value.
//
// G1 (y^2 = x^3 + 4, a = 0): Jacobian (X, Y, Z), Z = 0 encodes infinity.
// Addition is add-2007-bl and doubling dbl-2009-l, the formulas of the
// reference's strict-field kernels; the addition is complete: either
// operand at infinity, P == Q (doubling) and P == -Q (infinity).

#pragma once

#include <stdint.h>

#ifdef __CUDACC__
#define FP381_HD __host__ __device__ __forceinline__
#define FP381_UNROLL _Pragma("unroll")
#else
#define FP381_HD inline
#define FP381_UNROLL
#endif

// p, least significant limb first
#define FP381_P_LIMBS                                                     \
  0xffffaaabu, 0xb9feffffu, 0xb153ffffu, 0x1eabfffeu, 0xf6b0f624u,        \
      0x6730d2a0u, 0xf38512bfu, 0x64774b84u, 0x434bacd7u, 0x4b1ba7b6u,    \
      0x397fe69au, 0x1a0111eau
// R^2 mod p (to Montgomery form by one multiplication)
#define FP381_R2_LIMBS                                                    \
  0x1c341746u, 0xf4df1f34u, 0x09d104f1u, 0x0a76e6a6u, 0x4c95b6d5u,        \
      0x8de5476cu, 0x939d83c0u, 0x67eb88a9u, 0xb519952du, 0x9a793e85u,    \
      0x92cae3aau, 0x11988fe5u
// R mod p (one in Montgomery form)
#define FP381_ONE_LIMBS                                                   \
  0x0002fffdu, 0x76090000u, 0xc40c0002u, 0xebf4000bu, 0x53c758bau,        \
      0x5f489857u, 0x70525745u, 0x77ce5853u, 0xa256ec6du, 0x5c071a97u,    \
      0xfa80e493u, 0x15f65ec3u

// the qualifiers of fp_mma.h's product: a call, not inlined, under nvcc
#ifdef __CUDACC__
#define FP381_MUL_CALL __host__ __device__ __noinline__
#else
#define FP381_MUL_CALL inline
#endif

namespace fp381 {

constexpr int kLimbs = 12;
constexpr uint32_t kN0 = 0xfffcfffdu;  // -p^-1 mod 2^32

struct Fp {
  uint32_t v[kLimbs];
};

struct G1Jac {
  Fp x, y, z;
};

FP381_HD Fp zero() {
  Fp r;
  FP381_UNROLL
  for (int i = 0; i < kLimbs; ++i) r.v[i] = 0;
  return r;
}

FP381_HD Fp one_mont() {
  const uint32_t one[kLimbs] = {FP381_ONE_LIMBS};
  Fp r;
  FP381_UNROLL
  for (int i = 0; i < kLimbs; ++i) r.v[i] = one[i];
  return r;
}

FP381_HD bool is_zero(const Fp& a) {
  uint32_t acc = 0;
  FP381_UNROLL
  for (int i = 0; i < kLimbs; ++i) acc |= a.v[i];
  return acc == 0;
}

// t (12 limbs plus a top word) minus p when t >= p; t < 2p on entry.
FP381_HD Fp reduce_once(const uint32_t* t, uint32_t top) {
  const uint32_t p[kLimbs] = {FP381_P_LIMBS};
  Fp d;
  uint64_t borrow = 0;
  FP381_UNROLL
  for (int i = 0; i < kLimbs; ++i) {
    const uint64_t diff = static_cast<uint64_t>(t[i]) - p[i] - borrow;
    d.v[i] = static_cast<uint32_t>(diff);
    borrow = (diff >> 32) & 1;
  }
  const bool keep = top == 0 && borrow != 0;  // t < p
  Fp r;
  FP381_UNROLL
  for (int i = 0; i < kLimbs; ++i) r.v[i] = keep ? t[i] : d.v[i];
  return r;
}

FP381_HD Fp add(const Fp& a, const Fp& b) {
  uint32_t s[kLimbs];
  uint64_t carry = 0;
  FP381_UNROLL
  for (int i = 0; i < kLimbs; ++i) {
    const uint64_t sum = static_cast<uint64_t>(a.v[i]) + b.v[i] + carry;
    s[i] = static_cast<uint32_t>(sum);
    carry = sum >> 32;
  }
  return reduce_once(s, static_cast<uint32_t>(carry));
}

FP381_HD Fp sub(const Fp& a, const Fp& b) {
  const uint32_t p[kLimbs] = {FP381_P_LIMBS};
  Fp d;
  uint64_t borrow = 0;
  FP381_UNROLL
  for (int i = 0; i < kLimbs; ++i) {
    const uint64_t diff = static_cast<uint64_t>(a.v[i]) - b.v[i] - borrow;
    d.v[i] = static_cast<uint32_t>(diff);
    borrow = (diff >> 32) & 1;
  }
  const uint32_t mask = borrow ? 0xffffffffu : 0u;  // a < b: add p back
  uint64_t carry = 0;
  FP381_UNROLL
  for (int i = 0; i < kLimbs; ++i) {
    const uint64_t sum = static_cast<uint64_t>(d.v[i]) + (p[i] & mask) + carry;
    d.v[i] = static_cast<uint32_t>(sum);
    carry = sum >> 32;
  }
  return d;
}

}  // namespace fp381

#ifdef FP381_MUL_MXU
namespace fp_mma {
FP381_MUL_CALL fp381::Fp mont(fp381::Fp a, fp381::Fp b);  // fp_mma.h
}  // namespace fp_mma
#endif

namespace fp381 {

#ifdef FP381_MUL_MXU
// a * b * R^-1 mod p on the int8 tensor cores (fp_mma.h)
FP381_HD Fp mul(const Fp& a, const Fp& b) { return fp_mma::mont(a, b); }
#else
// a * b * R^-1 mod p (CIOS). Each step's sum a_j*b_i + t_j + carry is at
// most (2^32-1)^2 + 2(2^32-1) = 2^64 - 1, so one uint64_t holds it.
FP381_HD Fp mul(const Fp& a, const Fp& b) {
  const uint32_t p[kLimbs] = {FP381_P_LIMBS};
  uint32_t t[kLimbs + 2];
  FP381_UNROLL
  for (int i = 0; i < kLimbs + 2; ++i) t[i] = 0;
  FP381_UNROLL
  for (int i = 0; i < kLimbs; ++i) {
    uint64_t c = 0;
    FP381_UNROLL
    for (int j = 0; j < kLimbs; ++j) {
      c += static_cast<uint64_t>(a.v[j]) * b.v[i] + t[j];
      t[j] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[kLimbs];
    t[kLimbs] = static_cast<uint32_t>(c);
    t[kLimbs + 1] = static_cast<uint32_t>(c >> 32);

    const uint32_t m = t[0] * kN0;
    c = (static_cast<uint64_t>(m) * p[0] + t[0]) >> 32;
    FP381_UNROLL
    for (int j = 1; j < kLimbs; ++j) {
      c += static_cast<uint64_t>(m) * p[j] + t[j];
      t[j - 1] = static_cast<uint32_t>(c);
      c >>= 32;
    }
    c += t[kLimbs];
    t[kLimbs - 1] = static_cast<uint32_t>(c);
    t[kLimbs] = t[kLimbs + 1] + static_cast<uint32_t>(c >> 32);
  }
  return reduce_once(t, t[kLimbs]);  // t < 2p
}
#endif

FP381_HD Fp sqr(const Fp& a) { return mul(a, a); }

FP381_HD Fp to_mont(const Fp& a) {
  const uint32_t r2[kLimbs] = {FP381_R2_LIMBS};
  Fp b;
  FP381_UNROLL
  for (int i = 0; i < kLimbs; ++i) b.v[i] = r2[i];
  return mul(a, b);
}

FP381_HD Fp from_mont(const Fp& a) {
  Fp one = zero();
  one.v[0] = 1;
  return mul(a, one);
}

FP381_HD G1Jac g1_infinity() { return G1Jac{zero(), zero(), zero()}; }

FP381_HD bool g1_is_infinity(const G1Jac& p) { return is_zero(p.z); }

// dbl-2009-l; infinity stays infinity (Z3 = 2YZ = 0).
FP381_HD G1Jac g1_double(const G1Jac& p) {
  const Fp a = sqr(p.x);
  const Fp b = sqr(p.y);
  const Fp c = sqr(b);
  Fp d = sub(sub(sqr(add(p.x, b)), a), c);
  d = add(d, d);
  const Fp e = add(add(a, a), a);
  const Fp f = sqr(e);
  G1Jac r;
  r.x = sub(f, add(d, d));
  Fp c8 = add(c, c);
  c8 = add(c8, c8);
  c8 = add(c8, c8);
  r.y = sub(mul(e, sub(d, r.x)), c8);
  const Fp yz = mul(p.y, p.z);
  r.z = add(yz, yz);
  return r;
}

// add-2007-bl, complete.
FP381_HD G1Jac g1_add(const G1Jac& p, const G1Jac& q) {
  if (g1_is_infinity(q)) return p;
  if (g1_is_infinity(p)) return q;
  const Fp z1z1 = sqr(p.z);
  const Fp z2z2 = sqr(q.z);
  const Fp u1 = mul(p.x, z2z2);
  const Fp u2 = mul(q.x, z1z1);
  const Fp s1 = mul(mul(p.y, q.z), z2z2);
  const Fp s2 = mul(mul(q.y, p.z), z1z1);
  const Fp h = sub(u2, u1);
  const Fp r = sub(s2, s1);
  if (is_zero(h)) {
    return is_zero(r) ? g1_double(p) : g1_infinity();
  }
  const Fp hh = sqr(h);
  const Fp hhh = mul(h, hh);
  const Fp v = mul(u1, hh);
  G1Jac out;
  out.x = sub(sub(sqr(r), hhh), add(v, v));
  out.y = sub(mul(r, sub(v, out.x)), mul(s1, hhh));
  out.z = mul(mul(p.z, q.z), h);
  return out;
}

// Canonical affine (x, y) limbs, all zero for infinity -> Montgomery
// Jacobian with Z = 1 (or the point at infinity).
FP381_HD G1Jac g1_from_affine(const Fp& x, const Fp& y) {
  if (is_zero(x) && is_zero(y)) return g1_infinity();
  return G1Jac{to_mont(x), to_mont(y), one_mont()};
}

// Montgomery Jacobian -> canonical Jacobian limbs.
FP381_HD G1Jac g1_to_canonical(const G1Jac& p) {
  return G1Jac{from_mont(p.x), from_mont(p.y), from_mont(p.z)};
}

}  // namespace fp381

#ifdef FP381_MUL_MXU
#include "fp_mma.h"
#endif
