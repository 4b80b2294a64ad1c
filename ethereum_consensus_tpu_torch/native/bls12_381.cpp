// From-scratch BLS12-381 host backend (the role blst plays for the
// reference, ethereum-consensus/src/crypto/bls.rs): Montgomery Fp,
// Fp2/Fp6/Fp12 tower, G1/G2, optimal ate pairing with a shared final
// exponentiation, RFC 9380 hash-to-G2, Pippenger MSM, and the eth BLS
// verification APIs. Semantics mirror the pure-Python oracle in
// crypto/{fields,curves,pairing,hash_to_curve}.py bit-for-bit at the API
// boundary; tests cross-check the two.
//
// Built by native/bls.py with g++ -O3 -shared; exposed via ctypes.

#include <cstdint>
#include <cstring>
#include <cstddef>

#if defined(__x86_64__)
#include <immintrin.h>
#define EC_FP8_COMPILED 1
#endif

#include "bls12_381_constants.h"

typedef uint64_t u64;
typedef unsigned __int128 u128;
typedef uint8_t u8;
typedef uint32_t u32;

// ---------------------------------------------------------------------------
// Fp: 6x64-bit Montgomery arithmetic
// ---------------------------------------------------------------------------

struct Fp { u64 l[6]; };

static const int NL = 6;

static u64 FP_INV;      // -p^{-1} mod 2^64
static Fp FP_R2;        // 2^768 mod p (standard-form limbs)
static Fp FP_ONE;       // 2^384 mod p == Montgomery form of 1
static Fp FP_ZERO = {{0, 0, 0, 0, 0, 0}};
static Fp FP_TWO_INV;   // 2^{-1} (Montgomery form), for the Fp2 sqrt norm method

// big exponents, computed at init from p
static u64 EXP_P_MINUS_2[6];
static u64 EXP_P_PLUS_1_DIV_4[6];
static u64 EXP_P_MINUS_3_DIV_4[6];
static u64 EXP_P_MINUS_1_DIV_2[6];
static u64 EXP_P_MINUS_1_DIV_6[6];
static u64 P_MINUS_1_DIV_2_STD[6];  // for lexicographic-largest compares

static inline u64 adc(u64 a, u64 b, u64& carry) {
  u128 t = (u128)a + b + carry;
  carry = (u64)(t >> 64);
  return (u64)t;
}

static inline u64 sbb(u64 a, u64 b, u64& borrow) {
  u128 t = (u128)a - b - borrow;
  borrow = (u64)((t >> 64) & 1);
  return (u64)t;
}

static inline int fp_cmp_raw(const u64* a, const u64* b) {
  for (int i = NL - 1; i >= 0; i--) {
    if (a[i] < b[i]) return -1;
    if (a[i] > b[i]) return 1;
  }
  return 0;
}

static inline bool fp_is_zero(const Fp& a) {
  u64 acc = 0;
  for (int i = 0; i < NL; i++) acc |= a.l[i];
  return acc == 0;
}

static inline bool fp_eq(const Fp& a, const Fp& b) {
  u64 acc = 0;
  for (int i = 0; i < NL; i++) acc |= a.l[i] ^ b.l[i];
  return acc == 0;
}

static inline void fp_add(Fp& out, const Fp& a, const Fp& b) {
  u64 carry = 0;
  for (int i = 0; i < NL; i++) out.l[i] = adc(a.l[i], b.l[i], carry);
  if (carry || fp_cmp_raw(out.l, P_RAW.l) >= 0) {
    u64 borrow = 0;
    for (int i = 0; i < NL; i++) out.l[i] = sbb(out.l[i], P_RAW.l[i], borrow);
  }
}

static inline void fp_sub(Fp& out, const Fp& a, const Fp& b) {
  u64 borrow = 0;
  for (int i = 0; i < NL; i++) out.l[i] = sbb(a.l[i], b.l[i], borrow);
  if (borrow) {
    u64 carry = 0;
    for (int i = 0; i < NL; i++) out.l[i] = adc(out.l[i], P_RAW.l[i], carry);
  }
}

static inline void fp_neg(Fp& out, const Fp& a) {
  if (fp_is_zero(a)) { out = a; return; }
  u64 borrow = 0;
  for (int i = 0; i < NL; i++) out.l[i] = sbb(P_RAW.l[i], a.l[i], borrow);
}

static inline void fp_dbl(Fp& out, const Fp& a) { fp_add(out, a, a); }

// Montgomery "no-carry" CIOS multiplication: out = a*b*2^-384 mod p.
// Valid because p's top limb (0x1a01..., 61 bits) leaves enough slack that
// the per-round high words never overflow a single u64 accumulator
// (requires top limb < (2^64-1)/2; the same precondition gnark documents).
// ~30% faster than the classic 8-word CIOS on this compiler.
static inline void madd1(u64 a, u64 b, u64 c, u64& hi, u64& lo) {
  u128 r = (u128)a * b + c; hi = (u64)(r >> 64); lo = (u64)r;
}
static inline void madd2(u64 a, u64 b, u64 c, u64 d, u64& hi, u64& lo) {
  u128 r = (u128)a * b + c + d; hi = (u64)(r >> 64); lo = (u64)r;
}

#if defined(__x86_64__) && defined(__ADX__) && defined(__BMI2__)
#define EC_FP_MUL_ADX 1
// ADX/BMI2 dual-carry-chain rounds: the a*b[i] row streams lo words into
// t[j] on the ADCX (CF) chain and hi words into t[j+1] on the ADOX (OF)
// chain, so the two carry chains run in parallel; the m*p reduction row
// does the same with t0 annihilated. Same no-carry invariant as the C
// path (t6 never produces a carry-out) — the chains are folded into t6
// with the zero register. ~25% faster than what the compiler emits for
// the u128 formulation.
static void fp_mul(Fp& out, const Fp& a, const Fp& b) {
  u64 t0 = 0, t1 = 0, t2 = 0, t3 = 0, t4 = 0, t5 = 0, t6 = 0;
  const u64* ap = a.l;
  const u64* pp = P_RAW.l;
  for (int i = 0; i < NL; i++) {
    u64 bi = b.l[i];
    asm volatile(
        "xor %%r15d, %%r15d\n\t"
        "movq %[bi], %%rdx\n\t"
        "mulxq 0(%[ap]), %%rax, %%rbx\n\t"
        "adcxq %%rax, %[t0]\n\t"
        "adoxq %%rbx, %[t1]\n\t"
        "mulxq 8(%[ap]), %%rax, %%rbx\n\t"
        "adcxq %%rax, %[t1]\n\t"
        "adoxq %%rbx, %[t2]\n\t"
        "mulxq 16(%[ap]), %%rax, %%rbx\n\t"
        "adcxq %%rax, %[t2]\n\t"
        "adoxq %%rbx, %[t3]\n\t"
        "mulxq 24(%[ap]), %%rax, %%rbx\n\t"
        "adcxq %%rax, %[t3]\n\t"
        "adoxq %%rbx, %[t4]\n\t"
        "mulxq 32(%[ap]), %%rax, %%rbx\n\t"
        "adcxq %%rax, %[t4]\n\t"
        "adoxq %%rbx, %[t5]\n\t"
        "mulxq 40(%[ap]), %%rax, %%rbx\n\t"
        "adcxq %%rax, %[t5]\n\t"
        "adoxq %%rbx, %[t6]\n\t"
        "adcxq %%r15, %[t6]\n\t"
        : [t0]"+r"(t0), [t1]"+r"(t1), [t2]"+r"(t2), [t3]"+r"(t3),
          [t4]"+r"(t4), [t5]"+r"(t5), [t6]"+r"(t6)
        : [ap]"r"(ap), [bi]"r"(bi), "m"(*(const u64(*)[6])ap)
        : "rax", "rbx", "rdx", "r15", "cc");
    u64 m = t0 * FP_INV;
    asm volatile(
        "xor %%r15d, %%r15d\n\t"
        "movq %[m], %%rdx\n\t"
        "mulxq 0(%[pp]), %%rax, %%rbx\n\t"
        "adcxq %%rax, %[t0]\n\t"
        "adoxq %%rbx, %[t1]\n\t"
        "mulxq 8(%[pp]), %%rax, %%rbx\n\t"
        "adcxq %%rax, %[t1]\n\t"
        "adoxq %%rbx, %[t2]\n\t"
        "mulxq 16(%[pp]), %%rax, %%rbx\n\t"
        "adcxq %%rax, %[t2]\n\t"
        "adoxq %%rbx, %[t3]\n\t"
        "mulxq 24(%[pp]), %%rax, %%rbx\n\t"
        "adcxq %%rax, %[t3]\n\t"
        "adoxq %%rbx, %[t4]\n\t"
        "mulxq 32(%[pp]), %%rax, %%rbx\n\t"
        "adcxq %%rax, %[t4]\n\t"
        "adoxq %%rbx, %[t5]\n\t"
        "mulxq 40(%[pp]), %%rax, %%rbx\n\t"
        "adcxq %%rax, %[t5]\n\t"
        "adoxq %%rbx, %[t6]\n\t"
        "adcxq %%r15, %[t6]\n\t"
        : [t0]"+r"(t0), [t1]"+r"(t1), [t2]"+r"(t2), [t3]"+r"(t3),
          [t4]"+r"(t4), [t5]"+r"(t5), [t6]"+r"(t6)
        : [pp]"r"(pp), [m]"r"(m), "m"(*(const u64(*)[6])pp)
        : "rax", "rbx", "rdx", "r15", "cc");
    t0 = t1; t1 = t2; t2 = t3; t3 = t4; t4 = t5; t5 = t6; t6 = 0;
  }
  out.l[0] = t0; out.l[1] = t1; out.l[2] = t2;
  out.l[3] = t3; out.l[4] = t4; out.l[5] = t5;
  if (fp_cmp_raw(out.l, P_RAW.l) >= 0) {
    u64 borrow = 0;
    for (int i = 0; i < NL; i++) out.l[i] = sbb(out.l[i], P_RAW.l[i], borrow);
  }
}
#else
static void fp_mul(Fp& out, const Fp& a, const Fp& b) {
  u64 t0, t1, t2, t3, t4, t5;
  u64 A, C, m;
  {
    u128 r = (u128)a.l[0] * b.l[0]; t0 = (u64)r; A = (u64)(r >> 64);
    m = t0 * FP_INV;
    r = (u128)m * P_RAW.l[0] + t0; C = (u64)(r >> 64);
    madd1(a.l[1], b.l[0], A, A, t1); madd2(m, P_RAW.l[1], C, t1, C, t0);
    madd1(a.l[2], b.l[0], A, A, t2); madd2(m, P_RAW.l[2], C, t2, C, t1);
    madd1(a.l[3], b.l[0], A, A, t3); madd2(m, P_RAW.l[3], C, t3, C, t2);
    madd1(a.l[4], b.l[0], A, A, t4); madd2(m, P_RAW.l[4], C, t4, C, t3);
    madd1(a.l[5], b.l[0], A, A, t5); madd2(m, P_RAW.l[5], C, t5, C, t4);
    t5 = C + A;
  }
  for (int i = 1; i < NL; i++) {
    u64 bi = b.l[i];
    madd1(a.l[0], bi, t0, A, t0);
    m = t0 * FP_INV;
    { u128 r = (u128)m * P_RAW.l[0] + t0; C = (u64)(r >> 64); }
    madd2(a.l[1], bi, A, t1, A, t1); madd2(m, P_RAW.l[1], C, t1, C, t0);
    madd2(a.l[2], bi, A, t2, A, t2); madd2(m, P_RAW.l[2], C, t2, C, t1);
    madd2(a.l[3], bi, A, t3, A, t3); madd2(m, P_RAW.l[3], C, t3, C, t2);
    madd2(a.l[4], bi, A, t4, A, t4); madd2(m, P_RAW.l[4], C, t4, C, t3);
    madd2(a.l[5], bi, A, t5, A, t5); madd2(m, P_RAW.l[5], C, t5, C, t4);
    t5 = C + A;
  }
  out.l[0] = t0; out.l[1] = t1; out.l[2] = t2;
  out.l[3] = t3; out.l[4] = t4; out.l[5] = t5;
  if (fp_cmp_raw(out.l, P_RAW.l) >= 0) {
    u64 borrow = 0;
    for (int i = 0; i < NL; i++) out.l[i] = sbb(out.l[i], P_RAW.l[i], borrow);
  }
}
#endif  // EC_FP_MUL_ADX

#ifdef EC_FP_MUL_ADX
// With the ADX multiplier, mul(a, a) beats the dedicated C squaring
// (measured 36ns vs 72ns: the 12-limb stack buffer costs more than the
// saved cross products).
static inline void fp_sqr(Fp& out, const Fp& a) { fp_mul(out, a, a); }
#else
// Dedicated Montgomery squaring: full 12-limb square (cross products
// doubled by a 1-bit shift, diagonal added) + 6-round reduction.
// ~30% faster again than fp_mul(a, a).
static void fp_sqr(Fp& out, const Fp& a) {
  u64 t[12];
  u64 c;
  {
    u128 r;
    r = (u128)a.l[0] * a.l[1];            t[1] = (u64)r; c = (u64)(r >> 64);
    r = (u128)a.l[0] * a.l[2] + c;        t[2] = (u64)r; c = (u64)(r >> 64);
    r = (u128)a.l[0] * a.l[3] + c;        t[3] = (u64)r; c = (u64)(r >> 64);
    r = (u128)a.l[0] * a.l[4] + c;        t[4] = (u64)r; c = (u64)(r >> 64);
    r = (u128)a.l[0] * a.l[5] + c;        t[5] = (u64)r; t[6] = (u64)(r >> 64);
  }
  {
    u128 r;
    r = (u128)a.l[1] * a.l[2] + t[3];     t[3] = (u64)r; c = (u64)(r >> 64);
    r = (u128)a.l[1] * a.l[3] + t[4] + c; t[4] = (u64)r; c = (u64)(r >> 64);
    r = (u128)a.l[1] * a.l[4] + t[5] + c; t[5] = (u64)r; c = (u64)(r >> 64);
    r = (u128)a.l[1] * a.l[5] + t[6] + c; t[6] = (u64)r; t[7] = (u64)(r >> 64);
  }
  {
    u128 r;
    r = (u128)a.l[2] * a.l[3] + t[5];     t[5] = (u64)r; c = (u64)(r >> 64);
    r = (u128)a.l[2] * a.l[4] + t[6] + c; t[6] = (u64)r; c = (u64)(r >> 64);
    r = (u128)a.l[2] * a.l[5] + t[7] + c; t[7] = (u64)r; t[8] = (u64)(r >> 64);
  }
  {
    u128 r;
    r = (u128)a.l[3] * a.l[4] + t[7];     t[7] = (u64)r; c = (u64)(r >> 64);
    r = (u128)a.l[3] * a.l[5] + t[8] + c; t[8] = (u64)r; t[9] = (u64)(r >> 64);
  }
  {
    u128 r;
    r = (u128)a.l[4] * a.l[5] + t[9];     t[9] = (u64)r; t[10] = (u64)(r >> 64);
  }
  t[11] = t[10] >> 63;
  for (int i = 10; i > 1; i--) t[i] = (t[i] << 1) | (t[i - 1] >> 63);
  t[1] <<= 1;
  u64 carry = 0;
  t[0] = 0;
  for (int i = 0; i < NL; i++) {
    u128 sq = (u128)a.l[i] * a.l[i];
    u128 lo = (u128)t[2 * i] + (u64)sq + carry;
    t[2 * i] = (u64)lo;
    u128 hi = (u128)t[2 * i + 1] + (u64)(sq >> 64) + (u64)(lo >> 64);
    t[2 * i + 1] = (u64)hi;
    carry = (u64)(hi >> 64);
  }
  u64 carry2 = 0;
  for (int i = 0; i < NL; i++) {
    u64 m = t[i] * FP_INV;
    u64 cc = 0;
    for (int j = 0; j < NL; j++) {
      u128 cur = (u128)t[i + j] + (u128)m * P_RAW.l[j] + cc;
      t[i + j] = (u64)cur;
      cc = (u64)(cur >> 64);
    }
    u128 cur = (u128)t[i + 6] + cc + carry2;
    t[i + 6] = (u64)cur;
    carry2 = (u64)(cur >> 64);
  }
  for (int i = 0; i < NL; i++) out.l[i] = t[i + 6];
  if (carry2 || fp_cmp_raw(out.l, P_RAW.l) >= 0) {
    u64 borrow = 0;
    for (int i = 0; i < NL; i++) out.l[i] = sbb(out.l[i], P_RAW.l[i], borrow);
  }
}
#endif  // !EC_FP_MUL_ADX

static void fp_to_mont(Fp& out, const Fp& std_form) { fp_mul(out, std_form, FP_R2); }
static void fp_from_mont(Fp& out, const Fp& mont) {
  Fp one_std = {{1, 0, 0, 0, 0, 0}};
  fp_mul(out, mont, one_std);
}

// exponent is a little-endian limb array; 4-bit fixed window (windows are
// 4-aligned so they never straddle a limb). Halves the multiply count of
// plain square-and-multiply on the 381-bit sqrt/legendre exponents.
static void fp_pow(Fp& out, const Fp& base, const u64* exp, int exp_limbs) {
  int bits = exp_limbs * 64;
  while (bits > 0 && !((exp[(bits - 1) >> 6] >> ((bits - 1) & 63)) & 1)) bits--;
  if (bits == 0) { out = FP_ONE; return; }
  Fp tbl[15];  // base^1 .. base^15
  tbl[0] = base;
  for (int i = 1; i < 15; i++) fp_mul(tbl[i], tbl[i - 1], base);
  Fp result = FP_ONE;
  bool started = false;
  for (int w = ((bits - 1) / 4) * 4; w >= 0; w -= 4) {
    if (started) {
      fp_sqr(result, result); fp_sqr(result, result);
      fp_sqr(result, result); fp_sqr(result, result);
    }
    int d = (int)((exp[w >> 6] >> (w & 63)) & 15);
    if (d) {
      if (started) fp_mul(result, result, tbl[d - 1]);
      else { result = tbl[d - 1]; started = true; }
    }
  }
  out = result;
}

// Binary extended Euclid on standard-form limbs — ~10x faster than the
// Fermat p-2 power ladder. Variable-time is fine here: inversion inputs
// are public curve data (coordinates, pairing values), never secret keys.
static inline bool limbs6_is_zero(const u64* a) {
  return !(a[0] | a[1] | a[2] | a[3] | a[4] | a[5]);
}
static inline bool limbs6_is_one(const u64* a) {
  return a[0] == 1 && !(a[1] | a[2] | a[3] | a[4] | a[5]);
}
static inline void limbs6_shr1(u64* a) {
  for (int i = 0; i < 5; i++) a[i] = (a[i] >> 1) | (a[i + 1] << 63);
  a[5] >>= 1;
}
static inline void limbs6_add_p_shr1(u64* a) {
  // (a + p) / 2 where a + p may carry into a 7th word
  u64 carry = 0;
  u64 t[6];
  for (int i = 0; i < 6; i++) {
    u128 cur = (u128)a[i] + P_RAW.l[i] + carry;
    t[i] = (u64)cur;
    carry = (u64)(cur >> 64);
  }
  for (int i = 0; i < 5; i++) a[i] = (t[i] >> 1) | (t[i + 1] << 63);
  a[5] = (t[5] >> 1) | (carry << 63);
}
static inline void limbs6_sub(u64* a, const u64* b) {
  u64 borrow = 0;
  for (int i = 0; i < 6; i++) a[i] = sbb(a[i], b[i], borrow);
}
static inline void limbs6_sub_mod_p(u64* a, const u64* b) {
  // a = (a - b) mod p for a, b < p
  u64 borrow = 0;
  for (int i = 0; i < 6; i++) a[i] = sbb(a[i], b[i], borrow);
  if (borrow) {
    u64 carry = 0;
    for (int i = 0; i < 6; i++) {
      u128 cur = (u128)a[i] + P_RAW.l[i] + carry;
      a[i] = (u64)cur;
      carry = (u64)(cur >> 64);
    }
  }
}

static void fp_inv(Fp& out, const Fp& a) {
  if (fp_is_zero(a)) { out = FP_ZERO; return; }  // matches 0^(p-2) == 0
  Fp a_std;
  fp_from_mont(a_std, a);
  u64 u[6], v[6], x1[6] = {1, 0, 0, 0, 0, 0}, x2[6] = {0, 0, 0, 0, 0, 0};
  for (int i = 0; i < 6; i++) { u[i] = a_std.l[i]; v[i] = P_RAW.l[i]; }
  while (!limbs6_is_one(u) && !limbs6_is_one(v)) {
    while (!(u[0] & 1)) {
      limbs6_shr1(u);
      if (x1[0] & 1) limbs6_add_p_shr1(x1); else limbs6_shr1(x1);
    }
    while (!(v[0] & 1)) {
      limbs6_shr1(v);
      if (x2[0] & 1) limbs6_add_p_shr1(x2); else limbs6_shr1(x2);
    }
    if (fp_cmp_raw(u, v) >= 0) {
      limbs6_sub(u, v);
      limbs6_sub_mod_p(x1, x2);
    } else {
      limbs6_sub(v, u);
      limbs6_sub_mod_p(x2, x1);
    }
  }
  Fp inv_std;
  const u64* r = limbs6_is_one(u) ? x1 : x2;
  for (int i = 0; i < 6; i++) inv_std.l[i] = r[i];
  fp_to_mont(out, inv_std);
}

// returns false if not a square
static bool fp_sqrt(Fp& out, const Fp& a) {
  Fp cand, check;
  fp_pow(cand, a, EXP_P_PLUS_1_DIV_4, 6);
  fp_sqr(check, cand);
  if (!fp_eq(check, a)) return false;
  out = cand;
  return true;
}

static int fp_sgn0(const Fp& mont) {
  Fp std_form;
  fp_from_mont(std_form, mont);
  return (int)(std_form.l[0] & 1);
}

static bool fp_is_lex_largest(const Fp& mont) {
  Fp std_form;
  fp_from_mont(std_form, mont);
  return fp_cmp_raw(std_form.l, P_MINUS_1_DIV_2_STD) > 0;
}

// big-endian 48-byte IO (standard form)
static void fp_to_bytes(u8 out[48], const Fp& mont) {
  Fp s;
  fp_from_mont(s, mont);
  for (int i = 0; i < NL; i++) {
    u64 w = s.l[NL - 1 - i];
    for (int j = 0; j < 8; j++) out[i * 8 + j] = (u8)(w >> (56 - 8 * j));
  }
}

// returns false if value >= p
static bool fp_from_bytes(Fp& out, const u8 in[48]) {
  Fp s;
  for (int i = 0; i < NL; i++) {
    u64 w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | in[i * 8 + j];
    s.l[NL - 1 - i] = w;
  }
  if (fp_cmp_raw(s.l, P_RAW.l) >= 0) return false;
  fp_to_mont(out, s);
  return true;
}

static void fp_from_u64(Fp& out, u64 v) {
  Fp s = {{v, 0, 0, 0, 0, 0}};
  fp_to_mont(out, s);
}

// ---------------------------------------------------------------------------
// Fp2 = Fp[u]/(u^2+1)
// ---------------------------------------------------------------------------

struct Fp2 { Fp c0, c1; };

static Fp2 FP2_ZERO, FP2_ONE;

static inline bool fp2_is_zero(const Fp2& a) { return fp_is_zero(a.c0) && fp_is_zero(a.c1); }
static inline bool fp2_eq(const Fp2& a, const Fp2& b) { return fp_eq(a.c0, b.c0) && fp_eq(a.c1, b.c1); }

static inline void fp2_add(Fp2& o, const Fp2& a, const Fp2& b) {
  fp_add(o.c0, a.c0, b.c0); fp_add(o.c1, a.c1, b.c1);
}
static inline void fp2_sub(Fp2& o, const Fp2& a, const Fp2& b) {
  fp_sub(o.c0, a.c0, b.c0); fp_sub(o.c1, a.c1, b.c1);
}
static inline void fp2_neg(Fp2& o, const Fp2& a) { fp_neg(o.c0, a.c0); fp_neg(o.c1, a.c1); }
static inline void fp2_dbl(Fp2& o, const Fp2& a) { fp2_add(o, a, a); }

static void fp2_mul(Fp2& o, const Fp2& a, const Fp2& b) {
  Fp t0, t1, t2, s0, s1;
  fp_mul(t0, a.c0, b.c0);
  fp_mul(t1, a.c1, b.c1);
  fp_add(s0, a.c0, a.c1);
  fp_add(s1, b.c0, b.c1);
  fp_mul(t2, s0, s1);
  fp_sub(o.c0, t0, t1);
  fp_sub(t2, t2, t0);
  fp_sub(o.c1, t2, t1);
}

static void fp2_sqr(Fp2& o, const Fp2& a) {
  Fp s, d, t;
  fp_add(s, a.c0, a.c1);
  fp_sub(d, a.c0, a.c1);
  fp_mul(t, a.c0, a.c1);
  fp_mul(o.c0, s, d);
  fp_add(o.c1, t, t);
}

static void fp2_scalar_mul(Fp2& o, const Fp2& a, const Fp& k) {
  fp_mul(o.c0, a.c0, k); fp_mul(o.c1, a.c1, k);
}

// xi = u + 1: (a + bu)(1 + u) = (a - b) + (a + b)u
static void fp2_mul_by_xi(Fp2& o, const Fp2& a) {
  Fp t0, t1;
  fp_sub(t0, a.c0, a.c1);
  fp_add(t1, a.c0, a.c1);
  o.c0 = t0; o.c1 = t1;
}

static inline void fp2_conj(Fp2& o, const Fp2& a) { o.c0 = a.c0; fp_neg(o.c1, a.c1); }

static void fp2_inv(Fp2& o, const Fp2& a) {
  Fp n0, n1, norm, inv;
  fp_sqr(n0, a.c0);
  fp_sqr(n1, a.c1);
  fp_add(norm, n0, n1);
  fp_inv(inv, norm);
  fp_mul(o.c0, a.c0, inv);
  Fp t;
  fp_mul(t, a.c1, inv);
  fp_neg(o.c1, t);
}

// 4-bit fixed window, same shape as fp_pow
static void fp2_pow(Fp2& out, const Fp2& base, const u64* exp, int exp_limbs) {
  int bits = exp_limbs * 64;
  while (bits > 0 && !((exp[(bits - 1) >> 6] >> ((bits - 1) & 63)) & 1)) bits--;
  if (bits == 0) { out = FP2_ONE; return; }
  Fp2 tbl[15];
  tbl[0] = base;
  for (int i = 1; i < 15; i++) fp2_mul(tbl[i], tbl[i - 1], base);
  Fp2 result = FP2_ONE;
  bool started = false;
  for (int w = ((bits - 1) / 4) * 4; w >= 0; w -= 4) {
    if (started) {
      fp2_sqr(result, result); fp2_sqr(result, result);
      fp2_sqr(result, result); fp2_sqr(result, result);
    }
    int d = (int)((exp[w >> 6] >> (w & 63)) & 15);
    if (d) {
      if (started) fp2_mul(result, result, tbl[d - 1]);
      else { result = tbl[d - 1]; started = true; }
    }
  }
  out = result;
}

static int fp2_sgn0(const Fp2& a) {
  Fp s0;
  fp_from_mont(s0, a.c0);
  int sign0 = (int)(s0.l[0] & 1);
  bool zero0 = fp_is_zero(a.c0);
  Fp s1;
  fp_from_mont(s1, a.c1);
  int sign1 = (int)(s1.l[0] & 1);
  return sign0 | ((zero0 ? 1 : 0) & sign1);
}

static bool fp2_is_lex_largest(const Fp2& a) {
  if (!fp_is_zero(a.c1)) return fp_is_lex_largest(a.c1);
  return fp_is_lex_largest(a.c0);
}

// Fp2 sqrt via the norm map, ~2x cheaper than the direct p≡3 mod 4 tower
// algorithm (2-3 Fp pow chains instead of 2 Fp2 pow chains, and a
// non-square input is rejected after the FIRST chain — which also makes
// the failing gx1 probe inside SSWU cheap). With z = a + b·i, i² = −1:
// z is a square in Fp2 iff N = a² + b² is a square in Fp; for s = √N,
// exactly one of (a ± s)/2 is a nonzero square in Fp (their product is
// −(b/2)², a non-residue when b ≠ 0 since χ(−1) = −1 for p ≡ 3 mod 4);
// with x² = (a ± s)/2, the root is x + (b / 2x)·i.
static bool fp2_sqrt(Fp2& out, const Fp2& a) {
  if (fp2_is_zero(a)) { out = a; return true; }
  if (fp_is_zero(a.c1)) {
    // real input: always a square in Fp2 — √a0, or i·√(−a0) when a0 is
    // a non-residue (exactly one works, again because χ(−1) = −1)
    Fp r;
    if (fp_sqrt(r, a.c0)) { out.c0 = r; out.c1 = FP_ZERO; return true; }
    Fp na;
    fp_neg(na, a.c0);
    fp_sqrt(r, na);
    out.c0 = FP_ZERO; out.c1 = r;
    return true;
  }
  Fp n, t, s, x;
  fp_sqr(n, a.c0);
  fp_sqr(t, a.c1);
  fp_add(n, n, t);
  if (!fp_sqrt(s, n)) return false;  // norm non-square => no root in Fp2
  fp_add(t, a.c0, s);
  fp_mul(t, t, FP_TWO_INV);
  if (!fp_sqrt(x, t) || fp_is_zero(x)) {
    fp_sub(t, a.c0, s);
    fp_mul(t, t, FP_TWO_INV);
    if (!fp_sqrt(x, t) || fp_is_zero(x)) return false;  // unreachable for b != 0
  }
  Fp d, y;
  fp_dbl(d, x);
  fp_inv(d, d);
  fp_mul(y, a.c1, d);
  out.c0 = x;
  out.c1 = y;
  return true;
}

static void fp2_from_raw(Fp2& out, const Fp2Raw& r) {
  Fp c0s, c1s;
  for (int i = 0; i < NL; i++) { c0s.l[i] = r.c0.l[i]; c1s.l[i] = r.c1.l[i]; }
  fp_to_mont(out.c0, c0s);
  fp_to_mont(out.c1, c1s);
}

// ---------------------------------------------------------------------------
// Batched scalar inversion (Montgomery's trick): one fp_inv plus 3(n-1)
// multiplies for n inverses. Zero inputs pass through as zero (matching
// fp_inv). Used by the eight-wide batch paths below, where per-element
// fp_inv calls would otherwise dominate the scalar epilogues.
// ---------------------------------------------------------------------------
static void fp_inv_batch(Fp* vals, int n) {
  if (n <= 0) return;
  Fp pre[64];
  Fp acc = FP_ONE;
  int nz[64];
  int m = 0;
  for (int i = 0; i < n; i++) {
    if (fp_is_zero(vals[i])) continue;
    pre[m] = acc;
    fp_mul(acc, acc, vals[i]);
    nz[m++] = i;
  }
  if (m == 0) return;
  Fp inv;
  fp_inv(inv, acc);
  for (int k = m - 1; k >= 0; k--) {
    Fp v;
    fp_mul(v, inv, pre[k]);
    fp_mul(inv, inv, vals[nz[k]]);
    vals[nz[k]] = v;
  }
}

// n Fp2 inverses via the same trick on the norms: inv(a+bi) =
// (a-bi)/(a^2+b^2), so n Fp2 inversions cost one fp_inv + O(n) muls.
static void fp2_inv_batch(Fp2* vals, int n) {
  if (n <= 0) return;
  Fp norms[64];
  for (int i = 0; i < n; i++) {
    Fp t0, t1;
    fp_sqr(t0, vals[i].c0);
    fp_sqr(t1, vals[i].c1);
    fp_add(norms[i], t0, t1);
  }
  fp_inv_batch(norms, n);
  for (int i = 0; i < n; i++) {
    fp_mul(vals[i].c0, vals[i].c0, norms[i]);
    fp_mul(vals[i].c1, vals[i].c1, norms[i]);
    fp_neg(vals[i].c1, vals[i].c1);
  }
}

// ===========================================================================
// FP8: eight-way SoA Fp arithmetic on AVX-512 IFMA (radix-2^52 Montgomery).
//
// The RLC batch-verification hot path spends most of its per-set scalar
// time in fixed-exponent Fp power chains — the norm-method Fp2 square
// roots inside hash-to-G2's SSWU maps and G2 signature decompression.
// Those chains are identical instruction sequences over independent
// data, so they vectorize losslessly: each __m512i holds limb j of
// EIGHT field elements and vpmadd52{lo,hi}uq performs eight 52x52-bit
// multiply-accumulates per instruction. The Montgomery radix here is
// 2^416 (8 limbs x 52 bits) — distinct from the scalar path's 2^384 —
// and values cross between domains through canonical limbs at batch
// boundaries only.
//
// Dispatch is at RUN time (__builtin_cpu_supports + a self-check), so a
// build cached on one machine can never execute IFMA on a host without
// it; every batch entry point falls back to the scalar routines.
// ===========================================================================

static bool FP8_READY = false;
static u64 P52[8];        // p, radix-2^52 limbs
static u64 P52_INV;       // -p^{-1} mod 2^52
static u64 R52SQ_52[8];   // 2^832 mod p (canonical radix-52): to-Montgomery multiplier
static u64 TWOINV_M52[8]; // 2^{-1} in R52-Montgomery form == 2^415 mod p
static u64 X2_448_52[8];  // 2^448 mod p: scalar-Montgomery -> R52-Montgomery
static u64 X2_384_52[8];  // 2^384 mod p: R52-Montgomery -> scalar-Montgomery
static const u64 MASK52 = (1ULL << 52) - 1;

// 384-bit value: 6x64 canonical limbs <-> 8x52 canonical limbs
static void limbs6_to_52(u64 out[8], const u64 in[6]) {
  out[0] = in[0] & MASK52;
  out[1] = ((in[0] >> 52) | (in[1] << 12)) & MASK52;
  out[2] = ((in[1] >> 40) | (in[2] << 24)) & MASK52;
  out[3] = ((in[2] >> 28) | (in[3] << 36)) & MASK52;
  out[4] = ((in[3] >> 16) | (in[4] << 48)) & MASK52;
  out[5] = (in[4] >> 4) & MASK52;
  out[6] = ((in[4] >> 56) | (in[5] << 8)) & MASK52;
  out[7] = in[5] >> 44;
}

static void limbs52_to_6(u64 out[6], const u64 in[8]) {
  out[0] = in[0] | (in[1] << 52);
  out[1] = (in[1] >> 12) | (in[2] << 40);
  out[2] = (in[2] >> 24) | (in[3] << 28);
  out[3] = (in[3] >> 36) | (in[4] << 16);
  out[4] = (in[4] >> 48) | (in[5] << 4) | (in[6] << 56);
  out[5] = (in[6] >> 8) | (in[7] << 44);
}

#ifdef EC_FP8_COMPILED
#define EC_FP8_TARGET \
  __attribute__((target("avx512f,avx512ifma,avx512vl,avx512dq,avx512bw")))

struct Fp8 { __m512i l[8]; };  // l[j] = limb j of lanes 0..7

EC_FP8_TARGET static void fp8_bcast(Fp8& o, const u64 limbs[8]) {
  for (int j = 0; j < 8; j++) o.l[j] = _mm512_set1_epi64((long long)limbs[j]);
}

// Montgomery product, CIOS over radix 2^52. Accumulator limbs live in
// 64-bit lanes with 12 bits of headroom; each physical slot receives at
// most four sub-2^52 addends per iteration across eight iterations
// (< 2^57 total), so no intra-loop carries are needed. Inputs must be
// canonical (< p, 52-bit limbs); output is canonical.
EC_FP8_TARGET static void fp8_montmul(Fp8& o, const Fp8& a, const Fp8& b) {
  const __m512i zero = _mm512_setzero_si512();
  const __m512i pinv = _mm512_set1_epi64((long long)P52_INV);
  __m512i pv[8];
  for (int j = 0; j < 8; j++) pv[j] = _mm512_set1_epi64((long long)P52[j]);
  __m512i acc[9];
  for (int j = 0; j < 9; j++) acc[j] = zero;
  for (int i = 0; i < 8; i++) {
    const __m512i bi = b.l[i];
    for (int j = 0; j < 8; j++)
      acc[j] = _mm512_madd52lo_epu64(acc[j], a.l[j], bi);
    const __m512i m = _mm512_madd52lo_epu64(zero, acc[0], pinv);
    acc[0] = _mm512_madd52lo_epu64(acc[0], m, pv[0]);
    const __m512i carry = _mm512_srli_epi64(acc[0], 52);
    for (int j = 1; j < 8; j++)
      acc[j] = _mm512_madd52lo_epu64(acc[j], m, pv[j]);
    for (int j = 0; j < 8; j++)
      acc[j + 1] = _mm512_madd52hi_epu64(acc[j + 1], a.l[j], bi);
    for (int j = 0; j < 8; j++)
      acc[j + 1] = _mm512_madd52hi_epu64(acc[j + 1], m, pv[j]);
    acc[1] = _mm512_add_epi64(acc[1], carry);
    for (int j = 0; j < 8; j++) acc[j] = acc[j + 1];
    acc[8] = zero;
  }
  // carry-normalize to 52-bit limbs (result < 2p fits 416 bits)
  const __m512i mask = _mm512_set1_epi64((long long)MASK52);
  __m512i cr = zero;
  for (int j = 0; j < 8; j++) {
    acc[j] = _mm512_add_epi64(acc[j], cr);
    cr = _mm512_srli_epi64(acc[j], 52);
    acc[j] = _mm512_and_si512(acc[j], mask);
  }
  // conditional subtract p, lanewise
  __m512i d[8], bor = zero;
  const __m512i two52 = _mm512_set1_epi64(1LL << 52);
  for (int j = 0; j < 8; j++) {
    __m512i t = _mm512_sub_epi64(
        _mm512_add_epi64(acc[j], two52), _mm512_add_epi64(pv[j], bor));
    d[j] = _mm512_and_si512(t, mask);
    bor = _mm512_xor_si512(_mm512_srli_epi64(t, 52), _mm512_set1_epi64(1));
  }
  const __mmask8 ge_p = _mm512_cmpeq_epu64_mask(bor, zero);
  for (int j = 0; j < 8; j++)
    o.l[j] = _mm512_mask_blend_epi64(ge_p, acc[j], d[j]);
}

EC_FP8_TARGET static void fp8_sqr(Fp8& o, const Fp8& a) { fp8_montmul(o, a, a); }

// lanewise a + b mod p
EC_FP8_TARGET static void fp8_add(Fp8& o, const Fp8& a, const Fp8& b) {
  const __m512i zero = _mm512_setzero_si512();
  const __m512i mask = _mm512_set1_epi64((long long)MASK52);
  const __m512i two52 = _mm512_set1_epi64(1LL << 52);
  __m512i acc[8], cr = zero;
  for (int j = 0; j < 8; j++) {
    acc[j] = _mm512_add_epi64(_mm512_add_epi64(a.l[j], b.l[j]), cr);
    cr = _mm512_srli_epi64(acc[j], 52);
    acc[j] = _mm512_and_si512(acc[j], mask);
  }
  __m512i pv[8];
  for (int j = 0; j < 8; j++) pv[j] = _mm512_set1_epi64((long long)P52[j]);
  __m512i d[8], bor = zero;
  for (int j = 0; j < 8; j++) {
    __m512i t = _mm512_sub_epi64(
        _mm512_add_epi64(acc[j], two52), _mm512_add_epi64(pv[j], bor));
    d[j] = _mm512_and_si512(t, mask);
    bor = _mm512_xor_si512(_mm512_srli_epi64(t, 52), _mm512_set1_epi64(1));
  }
  // note: sum < 2p always (inputs canonical), so one subtract suffices
  const __mmask8 ge_p = _mm512_cmpeq_epu64_mask(bor, zero);
  for (int j = 0; j < 8; j++)
    o.l[j] = _mm512_mask_blend_epi64(ge_p, acc[j], d[j]);
}

// lanewise a - b mod p
EC_FP8_TARGET static void fp8_sub(Fp8& o, const Fp8& a, const Fp8& b) {
  const __m512i zero = _mm512_setzero_si512();
  const __m512i mask = _mm512_set1_epi64((long long)MASK52);
  const __m512i two52 = _mm512_set1_epi64(1LL << 52);
  __m512i acc[8], bor = zero;
  for (int j = 0; j < 8; j++) {
    __m512i t = _mm512_sub_epi64(
        _mm512_add_epi64(a.l[j], two52), _mm512_add_epi64(b.l[j], bor));
    acc[j] = _mm512_and_si512(t, mask);
    bor = _mm512_xor_si512(_mm512_srli_epi64(t, 52), _mm512_set1_epi64(1));
  }
  // lanes that borrowed get +p
  const __mmask8 neg = _mm512_cmpeq_epu64_mask(bor, _mm512_set1_epi64(1));
  __m512i cr = zero;
  for (int j = 0; j < 8; j++) {
    __m512i addend = _mm512_maskz_set1_epi64(neg, (long long)P52[j]);
    acc[j] = _mm512_add_epi64(_mm512_add_epi64(acc[j], addend), cr);
    cr = _mm512_srli_epi64(acc[j], 52);
    acc[j] = _mm512_and_si512(acc[j], mask);
  }
  for (int j = 0; j < 8; j++) o.l[j] = acc[j];
}

// per-lane equality of canonical values -> bitmask
EC_FP8_TARGET static __mmask8 fp8_eq_mask(const Fp8& a, const Fp8& b) {
  __m512i diff = _mm512_setzero_si512();
  for (int j = 0; j < 8; j++)
    diff = _mm512_or_si512(diff, _mm512_xor_si512(a.l[j], b.l[j]));
  return _mm512_cmpeq_epu64_mask(diff, _mm512_setzero_si512());
}

EC_FP8_TARGET static __mmask8 fp8_is_zero_mask(const Fp8& a) {
  __m512i acc = _mm512_setzero_si512();
  for (int j = 0; j < 8; j++) acc = _mm512_or_si512(acc, a.l[j]);
  return _mm512_cmpeq_epu64_mask(acc, _mm512_setzero_si512());
}

// scalar-Montgomery Fp lanes -> R52-Montgomery SoA vector (lanes >= n
// replicate lane 0 so padding never contains surprise values). The
// scalar-Montgomery LIMBS repack directly (a*2^384 as an integer) and
// one vector multiply by 2^448 rebases them: a*2^384 * 2^448 * 2^-416 =
// a*2^416 — no per-element scalar conversion.
EC_FP8_TARGET static void fp8_load(Fp8& o, const Fp* in, int n) {
  u64 t[8][8];
  for (int k = 0; k < 8; k++) limbs6_to_52(t[k], in[k < n ? k : 0].l);
  for (int j = 0; j < 8; j++)
    o.l[j] = _mm512_setr_epi64(
        (long long)t[0][j], (long long)t[1][j], (long long)t[2][j],
        (long long)t[3][j], (long long)t[4][j], (long long)t[5][j],
        (long long)t[6][j], (long long)t[7][j]);
  Fp8 c;
  fp8_bcast(c, X2_448_52);
  fp8_montmul(o, o, c);
}

// R52-Montgomery SoA vector -> scalar-Montgomery Fp lanes: one vector
// multiply by 2^384 (a*2^416 * 2^384 * 2^-416 = a*2^384), then repack.
EC_FP8_TARGET static void fp8_store(Fp* out, const Fp8& a, int n) {
  Fp8 c, red;
  fp8_bcast(c, X2_384_52);
  fp8_montmul(red, a, c);
  u64 t[8][8];
  for (int j = 0; j < 8; j++) {
    alignas(64) u64 lane[8];
    _mm512_store_si512((__m512i*)lane, red.l[j]);
    for (int k = 0; k < 8; k++) t[k][j] = lane[k];
  }
  for (int k = 0; k < n; k++) limbs52_to_6(out[k].l, t[k]);
}

// shared-exponent windowed power (all lanes raise to the SAME public
// exponent, so the 4-bit window digit schedule is lane-independent)
EC_FP8_TARGET static void fp8_pow(Fp8& out, const Fp8& base, const u64* exp,
                                  int exp_limbs) {
  int bits = exp_limbs * 64;
  while (bits > 0 && !((exp[(bits - 1) >> 6] >> ((bits - 1) & 63)) & 1)) bits--;
  if (bits == 0) {
    // x^0 = 1 in Montgomery form: montmul(2^832, 1) = 2^416 mod p
    static const u64 ONEP[8] = {1, 0, 0, 0, 0, 0, 0, 0};
    Fp8 r2, onep;
    fp8_bcast(r2, R52SQ_52);
    fp8_bcast(onep, ONEP);
    fp8_montmul(out, r2, onep);
    return;
  }
  Fp8 tbl[15];
  tbl[0] = base;
  for (int i = 1; i < 15; i++) fp8_montmul(tbl[i], tbl[i - 1], base);
  Fp8 result;
  bool started = false;
  for (int w = ((bits - 1) / 4) * 4; w >= 0; w -= 4) {
    if (started) {
      fp8_sqr(result, result);
      fp8_sqr(result, result);
      fp8_sqr(result, result);
      fp8_sqr(result, result);
    }
    int d = (int)((exp[w >> 6] >> (w & 63)) & 15);
    if (d) {
      if (started) fp8_montmul(result, result, tbl[d - 1]);
      else { result = tbl[d - 1]; started = true; }
    }
  }
  out = result;
}

// Eight candidate square roots x_i = a_i^((p+1)/4) with per-lane
// verification (x^2 == a); returns the success bitmask.
EC_FP8_TARGET static __mmask8 fp8_sqrt(Fp8& out, const Fp8& a) {
  fp8_pow(out, a, EXP_P_PLUS_1_DIV_4, 6);
  Fp8 chk;
  fp8_sqr(chk, out);
  return fp8_eq_mask(chk, a);
}

// Batched norm-method Fp2 sqrt (the vector twin of fp2_sqrt above):
// three batched Fp power chains — norm, (a+s)/2, (a-s)/2 — cover eight
// roots, where the scalar path pays 2-3 chains EACH. Lanes with
// c1 == 0 (real inputs) take the scalar path; every produced root is
// verified per-lane, with scalar recomputation as the safety net, so
// verdict semantics cannot drift from the scalar routine.
EC_FP8_TARGET static u32 fp2_sqrt_x8_ifma(Fp2* out, const Fp2* const* in,
                                          int n) {
  u32 okbits = 0;
  Fp av[8], bv[8];
  int idx[8];
  int m = 0;
  for (int k = 0; k < n; k++) {
    if (fp_is_zero(in[k]->c1)) {
      Fp2 r;
      if (fp2_sqrt(r, *in[k])) { out[k] = r; okbits |= 1u << k; }
      continue;
    }
    av[m] = in[k]->c0;
    bv[m] = in[k]->c1;
    idx[m] = k;
    m++;
  }
  if (!m) return okbits;
  Fp8 a8, b8, n8, t, s8;
  fp8_load(a8, av, m);
  fp8_load(b8, bv, m);
  fp8_sqr(n8, a8);
  fp8_sqr(t, b8);
  fp8_add(n8, n8, t);
  const __mmask8 sq_ok = fp8_sqrt(s8, n8);   // norm must be square in Fp
  Fp8 half, t1, t2, x1, x2;
  fp8_bcast(half, TWOINV_M52);
  fp8_add(t1, a8, s8);
  fp8_montmul(t1, t1, half);
  fp8_sub(t2, a8, s8);
  fp8_montmul(t2, t2, half);
  const __mmask8 x1_ok = fp8_sqrt(x1, t1);
  const __mmask8 x1_nz = ~fp8_is_zero_mask(x1);
  fp8_sqrt(x2, t2);
  const __mmask8 use1 = x1_ok & x1_nz;
  Fp8 x;
  for (int j = 0; j < 8; j++)
    x.l[j] = _mm512_mask_blend_epi64(use1, x2.l[j], x1.l[j]);
  Fp xs[8];
  fp8_store(xs, x, m);
  // y = b / (2x): batch the lane inversions through one fp_inv
  Fp dens[8];
  for (int k = 0; k < m; k++) fp_dbl(dens[k], xs[k]);
  fp_inv_batch(dens, m);
  for (int k = 0; k < m; k++) {
    if (!((sq_ok >> k) & 1)) continue;  // non-square input: leave unset
    Fp2 r;
    r.c0 = xs[k];
    fp_mul(r.c1, bv[k], dens[k]);
    Fp2 chk;
    fp2_sqr(chk, r);
    if (fp2_eq(chk, *in[idx[k]])) {
      out[idx[k]] = r;
      okbits |= 1u << idx[k];
    } else {
      // engine disagreement: defer to the scalar routine (never expected;
      // keeps verdicts exactly equal to the scalar path by construction)
      Fp2 r2;
      if (fp2_sqrt(r2, *in[idx[k]])) { out[idx[k]] = r2; okbits |= 1u << idx[k]; }
    }
  }
  return okbits;
}
#endif  // EC_FP8_COMPILED

#ifdef EC_FP8_COMPILED
// eight Fp square roots through one batched (p+1)/4 chain
EC_FP8_TARGET static u32 fp_sqrt_x8_ifma(Fp* out, const Fp* const* in, int n) {
  Fp vals[8];
  for (int k = 0; k < 8; k++) vals[k] = *in[k < n ? k : 0];
  Fp8 a8, r8;
  fp8_load(a8, vals, 8);
  const __mmask8 okm = fp8_sqrt(r8, a8);
  Fp roots[8];
  fp8_store(roots, r8, 8);
  u32 okbits = 0;
  for (int k = 0; k < n; k++) {
    if ((okm >> k) & 1) {
      out[k] = roots[k];
      okbits |= 1u << k;
    } else {
      // engine said non-square; scalar confirm keeps verdicts pinned
      Fp r;
      if (fp_sqrt(r, *in[k])) { out[k] = r; okbits |= 1u << k; }
    }
  }
  return okbits;
}
#endif  // EC_FP8_COMPILED

// Dispatch: batched Fp sqrt over up to 8 independent inputs
static u32 fp_sqrt_x8(Fp* out, const Fp* const* in, int n) {
#ifdef EC_FP8_COMPILED
  if (FP8_READY) return fp_sqrt_x8_ifma(out, in, n);
#endif
  u32 okbits = 0;
  for (int k = 0; k < n; k++) {
    Fp r;
    if (fp_sqrt(r, *in[k])) { out[k] = r; okbits |= 1u << k; }
  }
  return okbits;
}

// Dispatch wrapper: batched Fp2 sqrt over up to 8 independent inputs
// (pointer array), scalar fallback when the IFMA engine is unavailable.
static u32 fp2_sqrt_x8(Fp2* out, const Fp2* const* in, int n) {
#ifdef EC_FP8_COMPILED
  if (FP8_READY) return fp2_sqrt_x8_ifma(out, in, n);
#endif
  u32 okbits = 0;
  for (int k = 0; k < n; k++) {
    Fp2 r;
    if (fp2_sqrt(r, *in[k])) { out[k] = r; okbits |= 1u << k; }
  }
  return okbits;
}

#ifdef EC_FP8_COMPILED
// init-time self-check: random-ish vectors must round-trip and agree
// with the scalar field on mul/add/sub/pow before FP8_READY flips on
EC_FP8_TARGET static bool fp8_selfcheck() {
  u64 seed = 0x9e3779b97f4a7c15ULL;
  Fp vals[16];
  for (int i = 0; i < 16; i++) {
    Fp s;
    for (int j = 0; j < 6; j++) {
      seed ^= seed << 13; seed ^= seed >> 7; seed ^= seed << 17;
      s.l[j] = seed;
    }
    s.l[5] &= (1ULL << 61) - 1;  // < p after reduction headroom
    // reduce below p: conditional subtract a few times
    for (int r = 0; r < 4; r++) {
      if (fp_cmp_raw(s.l, P_RAW.l) >= 0) {
        u64 borrow = 0;
        for (int j = 0; j < 6; j++) s.l[j] = sbb(s.l[j], P_RAW.l[j], borrow);
      }
    }
    fp_to_mont(vals[i], s);
  }
  vals[14] = FP_ZERO;
  vals[15] = FP_ONE;
  Fp8 a8, b8, r8;
  fp8_load(a8, vals, 8);
  fp8_load(b8, vals + 8, 8);
  // round-trip
  Fp back[8];
  fp8_store(back, a8, 8);
  for (int i = 0; i < 8; i++)
    if (!fp_eq(back[i], vals[i])) return false;
  // mul / add / sub vs scalar
  Fp want[8], got[8];
  fp8_montmul(r8, a8, b8);
  fp8_store(got, r8, 8);
  for (int i = 0; i < 8; i++) {
    fp_mul(want[i], vals[i], vals[8 + i]);
    if (!fp_eq(got[i], want[i])) return false;
  }
  fp8_add(r8, a8, b8);
  fp8_store(got, r8, 8);
  for (int i = 0; i < 8; i++) {
    fp_add(want[i], vals[i], vals[8 + i]);
    if (!fp_eq(got[i], want[i])) return false;
  }
  fp8_sub(r8, a8, b8);
  fp8_store(got, r8, 8);
  for (int i = 0; i < 8; i++) {
    fp_sub(want[i], vals[i], vals[8 + i]);
    if (!fp_eq(got[i], want[i])) return false;
  }
  fp8_pow(r8, a8, EXP_P_PLUS_1_DIV_4, 6);
  fp8_store(got, r8, 8);
  for (int i = 0; i < 8; i++) {
    fp_pow(want[i], vals[i], EXP_P_PLUS_1_DIV_4, 6);
    if (!fp_eq(got[i], want[i])) return false;
  }
  return true;
}
#endif  // EC_FP8_COMPILED

#ifdef EC_FP8_COMPILED
// randomized engine-vs-scalar cross-check (driven by ec_fp8_selftest)
EC_FP8_TARGET static int fp8_selftest_deep(u64 seed, int rounds) {
  if (!seed) seed = 0x853c49e6748fea9bULL;
  for (int r = 0; r < rounds; r++) {
    Fp va[8], vb[8];
    for (int i = 0; i < 8; i++) {
      Fp s;
      for (int j = 0; j < 6; j++) {
        seed ^= seed << 13; seed ^= seed >> 7; seed ^= seed << 17;
        s.l[j] = seed;
      }
      s.l[5] &= (1ULL << 60) - 1;
      fp_to_mont(va[i], s);
      for (int j = 0; j < 6; j++) {
        seed ^= seed << 13; seed ^= seed >> 7; seed ^= seed << 17;
        s.l[j] = seed;
      }
      s.l[5] &= (1ULL << 60) - 1;
      fp_to_mont(vb[i], s);
    }
    if (r == 0) { va[0] = FP_ZERO; vb[1] = FP_ZERO; va[2] = FP_ONE; }
    Fp8 a8, b8, r8;
    fp8_load(a8, va, 8);
    fp8_load(b8, vb, 8);
    Fp got[8], want;
    fp8_montmul(r8, a8, b8);
    fp8_store(got, r8, 8);
    for (int i = 0; i < 8; i++) {
      fp_mul(want, va[i], vb[i]);
      if (!fp_eq(got[i], want)) return 1;
    }
    fp8_add(r8, a8, b8);
    fp8_store(got, r8, 8);
    for (int i = 0; i < 8; i++) {
      fp_add(want, va[i], vb[i]);
      if (!fp_eq(got[i], want)) return 2;
    }
    fp8_sub(r8, a8, b8);
    fp8_store(got, r8, 8);
    for (int i = 0; i < 8; i++) {
      fp_sub(want, va[i], vb[i]);
      if (!fp_eq(got[i], want)) return 3;
    }
    // batched Fp2 sqrt agrees with the scalar routine, both on known
    // squares and on raw random candidates (~half non-squares)
    Fp2 roots[4], squares[4], outs[4];
    const Fp2* ptrs[4];
    for (int i = 0; i < 4; i++) {
      roots[i].c0 = va[i];
      roots[i].c1 = vb[i];
      fp2_sqr(squares[i], roots[i]);
      ptrs[i] = &squares[i];
    }
    u32 okb = fp2_sqrt_x8(outs, ptrs, 4);
    if (okb != 0xF) return 4;
    for (int i = 0; i < 4; i++) {
      Fp2 chk;
      fp2_sqr(chk, outs[i]);
      if (!fp2_eq(chk, squares[i])) return 5;
    }
    Fp2 rawin[4], rawout[4];
    const Fp2* rawptr[4];
    for (int i = 0; i < 4; i++) {
      rawin[i].c0 = va[4 + i];
      rawin[i].c1 = vb[4 + i];
      rawptr[i] = &rawin[i];
    }
    u32 gotmask = fp2_sqrt_x8(rawout, rawptr, 4);
    for (int i = 0; i < 4; i++) {
      Fp2 want2;
      bool want_ok = fp2_sqrt(want2, rawin[i]);
      if (((gotmask >> i) & 1) != (want_ok ? 1u : 0u)) return 6;
    }
  }
  return 0;
}
#endif  // EC_FP8_COMPILED

// called from ensure_init once the scalar Montgomery machinery is up
static void fp8_engine_init() {
  FP8_READY = false;
#ifdef EC_FP8_COMPILED
  if (!__builtin_cpu_supports("avx512ifma") ||
      !__builtin_cpu_supports("avx512f") ||
      !__builtin_cpu_supports("avx512dq") ||
      !__builtin_cpu_supports("avx512bw") ||
      !__builtin_cpu_supports("avx512vl"))
    return;
  limbs6_to_52(P52, P_RAW.l);
  P52_INV = FP_INV & MASK52;  // inverse mod 2^64 truncates to mod 2^52
  // powers of two mod p by doubling (canonical limbs)
  Fp acc = {{1, 0, 0, 0, 0, 0}};
  for (int i = 0; i < 384; i++) fp_add(acc, acc, acc);
  limbs6_to_52(X2_384_52, acc.l);
  for (int i = 384; i < 415; i++) fp_add(acc, acc, acc);
  limbs6_to_52(TWOINV_M52, acc.l);
  for (int i = 415; i < 448; i++) fp_add(acc, acc, acc);
  limbs6_to_52(X2_448_52, acc.l);
  for (int i = 448; i < 832; i++) fp_add(acc, acc, acc);
  limbs6_to_52(R52SQ_52, acc.l);
  FP8_READY = fp8_selfcheck();
#endif
}

// ---------------------------------------------------------------------------
// Fp6 = Fp2[v]/(v^3 - xi), Fp12 = Fp6[w]/(w^2 - v)
// ---------------------------------------------------------------------------

struct Fp6 { Fp2 a0, a1, a2; };
struct Fp12 { Fp6 c0, c1; };

static Fp6 FP6_ZERO, FP6_ONE;
static Fp12 FP12_ONE;
static Fp2 FROB_GAMMA1[6];  // xi^(i*(p-1)/6), i = 0..5

static inline bool fp6_is_zero(const Fp6& a) {
  return fp2_is_zero(a.a0) && fp2_is_zero(a.a1) && fp2_is_zero(a.a2);
}
static inline void fp6_add(Fp6& o, const Fp6& a, const Fp6& b) {
  fp2_add(o.a0, a.a0, b.a0); fp2_add(o.a1, a.a1, b.a1); fp2_add(o.a2, a.a2, b.a2);
}
static inline void fp6_sub(Fp6& o, const Fp6& a, const Fp6& b) {
  fp2_sub(o.a0, a.a0, b.a0); fp2_sub(o.a1, a.a1, b.a1); fp2_sub(o.a2, a.a2, b.a2);
}
static inline void fp6_neg(Fp6& o, const Fp6& a) {
  fp2_neg(o.a0, a.a0); fp2_neg(o.a1, a.a1); fp2_neg(o.a2, a.a2);
}

static void fp6_mul(Fp6& o, const Fp6& a, const Fp6& b) {
  Fp2 t0, t1, t2, s, u, x, y;
  fp2_mul(t0, a.a0, b.a0);
  fp2_mul(t1, a.a1, b.a1);
  fp2_mul(t2, a.a2, b.a2);
  // c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
  fp2_add(s, a.a1, a.a2);
  fp2_add(u, b.a1, b.a2);
  fp2_mul(x, s, u);
  fp2_sub(x, x, t1);
  fp2_sub(x, x, t2);
  fp2_mul_by_xi(y, x);
  Fp2 c0, c1, c2;
  fp2_add(c0, t0, y);
  // c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
  fp2_add(s, a.a0, a.a1);
  fp2_add(u, b.a0, b.a1);
  fp2_mul(x, s, u);
  fp2_sub(x, x, t0);
  fp2_sub(x, x, t1);
  fp2_mul_by_xi(y, t2);
  fp2_add(c1, x, y);
  // c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
  fp2_add(s, a.a0, a.a2);
  fp2_add(u, b.a0, b.a2);
  fp2_mul(x, s, u);
  fp2_sub(x, x, t0);
  fp2_sub(x, x, t2);
  fp2_add(c2, x, t1);
  o.a0 = c0; o.a1 = c1; o.a2 = c2;
}

static inline void fp6_sqr(Fp6& o, const Fp6& a) { fp6_mul(o, a, a); }

// multiply by v: (a0, a1, a2) -> (xi*a2, a0, a1)
static void fp6_mul_by_v(Fp6& o, const Fp6& a) {
  Fp2 t;
  fp2_mul_by_xi(t, a.a2);
  Fp2 old_a0 = a.a0, old_a1 = a.a1;
  o.a0 = t; o.a1 = old_a0; o.a2 = old_a1;
}

static void fp6_scalar_mul_fp2(Fp6& o, const Fp6& a, const Fp2& k) {
  fp2_mul(o.a0, a.a0, k); fp2_mul(o.a1, a.a1, k); fp2_mul(o.a2, a.a2, k);
}

static void fp6_inv(Fp6& o, const Fp6& a) {
  // c0 = a0^2 - xi*a1*a2 ; c1 = xi*a2^2 - a0*a1 ; c2 = a1^2 - a0*a2
  Fp2 c0, c1, c2, t, u;
  fp2_sqr(c0, a.a0);
  fp2_mul(t, a.a1, a.a2);
  fp2_mul_by_xi(u, t);
  fp2_sub(c0, c0, u);
  fp2_sqr(t, a.a2);
  fp2_mul_by_xi(u, t);
  fp2_mul(t, a.a0, a.a1);
  fp2_sub(c1, u, t);
  fp2_sqr(t, a.a1);
  fp2_mul(u, a.a0, a.a2);
  fp2_sub(c2, t, u);
  // t = a0*c0 + xi*(a2*c1 + a1*c2)
  Fp2 acc, x;
  fp2_mul(acc, a.a2, c1);
  fp2_mul(x, a.a1, c2);
  fp2_add(acc, acc, x);
  fp2_mul_by_xi(acc, acc);
  fp2_mul(x, a.a0, c0);
  fp2_add(acc, acc, x);
  Fp2 inv;
  fp2_inv(inv, acc);
  fp2_mul(o.a0, c0, inv);
  fp2_mul(o.a1, c1, inv);
  fp2_mul(o.a2, c2, inv);
}

static inline bool fp12_eq(const Fp12& a, const Fp12& b) {
  return fp2_eq(a.c0.a0, b.c0.a0) && fp2_eq(a.c0.a1, b.c0.a1) && fp2_eq(a.c0.a2, b.c0.a2) &&
         fp2_eq(a.c1.a0, b.c1.a0) && fp2_eq(a.c1.a1, b.c1.a1) && fp2_eq(a.c1.a2, b.c1.a2);
}

static void fp12_mul(Fp12& o, const Fp12& a, const Fp12& b) {
  Fp6 t0, t1, s0, s1, t2, vt;
  fp6_mul(t0, a.c0, b.c0);
  fp6_mul(t1, a.c1, b.c1);
  fp6_add(s0, a.c0, a.c1);
  fp6_add(s1, b.c0, b.c1);
  fp6_mul(t2, s0, s1);
  fp6_sub(t2, t2, t0);
  fp6_sub(t2, t2, t1);
  fp6_mul_by_v(vt, t1);
  fp6_add(o.c0, t0, vt);
  o.c1 = t2;
}

static void fp12_sqr(Fp12& o, const Fp12& a) {
  // c0 = A0^2 + v*A1^2 ; c1 = 2*A0*A1, karatsuba form
  Fp6 u, s, t, vt;
  fp6_mul(u, a.c0, a.c1);
  fp6_add(s, a.c0, a.c1);
  fp6_mul_by_v(vt, a.c1);
  fp6_add(t, a.c0, vt);
  fp6_mul(t, s, t);       // (A0+A1)(A0+v*A1) = A0^2 + v*A1^2 + (1+v)*A0*A1
  fp6_sub(t, t, u);
  fp6_mul_by_v(vt, u);
  fp6_sub(o.c0, t, vt);
  fp6_add(o.c1, u, u);
}

static inline void fp12_conj(Fp12& o, const Fp12& a) {
  o.c0 = a.c0;
  fp6_neg(o.c1, a.c1);
}

static void fp12_inv(Fp12& o, const Fp12& a) {
  Fp6 t0, t1, vt, inv;
  fp6_sqr(t0, a.c0);
  fp6_sqr(t1, a.c1);
  fp6_mul_by_v(vt, t1);
  fp6_sub(t0, t0, vt);
  fp6_inv(inv, t0);
  fp6_mul(o.c0, a.c0, inv);
  Fp6 t;
  fp6_mul(t, a.c1, inv);
  fp6_neg(o.c1, t);
}

// Frobenius x -> x^p. Basis powers of w: w^0..w^5 live at
// (c0.a0, c1.a0, c0.a1, c1.a1, c0.a2, c1.a2); b_i -> conj(b_i)*gamma1^i.
static void fp12_frob(Fp12& o, const Fp12& a) {
  Fp2 b[6] = {a.c0.a0, a.c1.a0, a.c0.a1, a.c1.a1, a.c0.a2, a.c1.a2};
  Fp2 r[6];
  for (int i = 0; i < 6; i++) {
    Fp2 c;
    fp2_conj(c, b[i]);
    fp2_mul(r[i], c, FROB_GAMMA1[i]);
  }
  o.c0.a0 = r[0]; o.c1.a0 = r[1]; o.c0.a1 = r[2];
  o.c1.a1 = r[3]; o.c0.a2 = r[4]; o.c1.a2 = r[5];
}

static void fp12_frob_n(Fp12& o, const Fp12& a, int n) {
  Fp12 t = a;
  for (int i = 0; i < n; i++) fp12_frob(t, t);
  o = t;
}

static bool fp12_is_one(const Fp12& a) { return fp12_eq(a, FP12_ONE); }

// ---------------------------------------------------------------------------
// Curve groups: Jacobian coordinates, templated over the field
// ---------------------------------------------------------------------------

struct FpOps {
  typedef Fp F;
  static void add(F& o, const F& a, const F& b) { fp_add(o, a, b); }
  static void sub(F& o, const F& a, const F& b) { fp_sub(o, a, b); }
  static void mul(F& o, const F& a, const F& b) { fp_mul(o, a, b); }
  static void sqr(F& o, const F& a) { fp_sqr(o, a); }
  static void neg(F& o, const F& a) { fp_neg(o, a); }
  static void inv(F& o, const F& a) { fp_inv(o, a); }
  static bool is_zero(const F& a) { return fp_is_zero(a); }
  static bool eq(const F& a, const F& b) { return fp_eq(a, b); }
  static F zero() { return FP_ZERO; }
  static F one() { return FP_ONE; }
};

struct Fp2Ops {
  typedef Fp2 F;
  static void add(F& o, const F& a, const F& b) { fp2_add(o, a, b); }
  static void sub(F& o, const F& a, const F& b) { fp2_sub(o, a, b); }
  static void mul(F& o, const F& a, const F& b) { fp2_mul(o, a, b); }
  static void sqr(F& o, const F& a) { fp2_sqr(o, a); }
  static void neg(F& o, const F& a) { fp2_neg(o, a); }
  static void inv(F& o, const F& a) { fp2_inv(o, a); }
  static bool is_zero(const F& a) { return fp2_is_zero(a); }
  static bool eq(const F& a, const F& b) { return fp2_eq(a, b); }
  static F zero() { return FP2_ZERO; }
  static F one() { return FP2_ONE; }
};

template <class Ops>
struct Point {
  typename Ops::F x, y, z;
  bool is_inf() const { return Ops::is_zero(z); }
};

typedef Point<FpOps> G1;
typedef Point<Fp2Ops> G2;

// fast-path subgroup membership (endomorphism criteria; defined with the
// psi machinery below, validated before first use)
static bool g1_in_subgroup(const G1& p);
static bool g2_in_subgroup(const G2& p);
static void validate_endomorphism_fast_paths();

static Fp G1_B;    // 4
static Fp2 G2_B;   // 4(u+1)
static G1 G1_GEN;
static G2 G2_GEN;

template <class Ops>
static Point<Ops> pt_infinity() {
  Point<Ops> p;
  p.x = Ops::one(); p.y = Ops::one(); p.z = Ops::zero();
  return p;
}

// dbl-2009-l, mirrors curves.py _JacobianPoint.double
template <class Ops>
static void pt_double(Point<Ops>& o, const Point<Ops>& p) {
  typedef typename Ops::F F;
  if (p.is_inf()) { o = p; return; }
  F a, b, c, d, e, f, t, x3, y3, z3;
  Ops::sqr(a, p.x);
  Ops::sqr(b, p.y);
  Ops::sqr(c, b);
  Ops::add(t, p.x, b);
  Ops::sqr(t, t);
  Ops::sub(t, t, a);
  Ops::sub(d, t, c);
  Ops::add(d, d, d);
  Ops::add(e, a, a);
  Ops::add(e, e, a);
  Ops::sqr(f, e);
  Ops::sub(x3, f, d);
  Ops::sub(x3, x3, d);
  F c8;
  Ops::add(c8, c, c);
  Ops::add(c8, c8, c8);
  Ops::add(c8, c8, c8);
  Ops::sub(t, d, x3);
  Ops::mul(y3, e, t);
  Ops::sub(y3, y3, c8);
  Ops::mul(z3, p.y, p.z);
  Ops::add(z3, z3, z3);
  o.x = x3; o.y = y3; o.z = z3;
}

// add-2007-bl, mirrors curves.py _JacobianPoint.__add__
template <class Ops>
static void pt_add(Point<Ops>& o, const Point<Ops>& p, const Point<Ops>& q) {
  typedef typename Ops::F F;
  if (p.is_inf()) { o = q; return; }
  if (q.is_inf()) { o = p; return; }
  F z1z1, z2z2, u1, u2, s1, s2, t;
  Ops::sqr(z1z1, p.z);
  Ops::sqr(z2z2, q.z);
  Ops::mul(u1, p.x, z2z2);
  Ops::mul(u2, q.x, z1z1);
  Ops::mul(t, p.y, q.z);
  Ops::mul(s1, t, z2z2);
  Ops::mul(t, q.y, p.z);
  Ops::mul(s2, t, z1z1);
  if (Ops::eq(u1, u2)) {
    if (Ops::eq(s1, s2)) { pt_double(o, p); return; }
    o = pt_infinity<Ops>();
    return;
  }
  F h, i, j, r, v, x3, y3, z3;
  Ops::sub(h, u2, u1);
  Ops::add(i, h, h);
  Ops::sqr(i, i);
  Ops::mul(j, h, i);
  Ops::sub(r, s2, s1);
  Ops::add(r, r, r);
  Ops::mul(v, u1, i);
  Ops::sqr(x3, r);
  Ops::sub(x3, x3, j);
  Ops::sub(x3, x3, v);
  Ops::sub(x3, x3, v);
  Ops::sub(t, v, x3);
  Ops::mul(y3, r, t);
  F sj;
  Ops::mul(sj, s1, j);
  Ops::sub(y3, y3, sj);
  Ops::sub(y3, y3, sj);
  Ops::mul(t, p.z, q.z);
  Ops::add(t, t, t);
  Ops::mul(z3, t, h);
  o.x = x3; o.y = y3; o.z = z3;
}

// madd-2007-bl: q affine (z = 1) — 7M+4S vs the general add's 11M+5S.
// The MSM bucket-accumulation hot path: base points arrive from raw
// affine bytes with z = 1.
template <class Ops>
static void pt_add_affine(Point<Ops>& o, const Point<Ops>& p,
                          const typename Ops::F& qx,
                          const typename Ops::F& qy) {
  typedef typename Ops::F F;
  if (p.is_inf()) {
    o.x = qx; o.y = qy; o.z = Ops::one();
    return;
  }
  F z1z1, u2, s2, t;
  Ops::sqr(z1z1, p.z);
  Ops::mul(u2, qx, z1z1);
  Ops::mul(t, qy, p.z);
  Ops::mul(s2, t, z1z1);
  if (Ops::eq(p.x, u2)) {
    if (Ops::eq(p.y, s2)) { pt_double(o, p); return; }
    o = pt_infinity<Ops>();
    return;
  }
  F h, hh, i, j, r, v, x3, y3, z3;
  Ops::sub(h, u2, p.x);
  Ops::sqr(hh, h);
  Ops::add(i, hh, hh);
  Ops::add(i, i, i);            // i = 4·hh
  Ops::mul(j, h, i);
  Ops::sub(r, s2, p.y);
  Ops::add(r, r, r);
  Ops::mul(v, p.x, i);
  Ops::sqr(x3, r);
  Ops::sub(x3, x3, j);
  Ops::sub(x3, x3, v);
  Ops::sub(x3, x3, v);
  Ops::sub(t, v, x3);
  Ops::mul(y3, r, t);
  F yj;
  Ops::mul(yj, p.y, j);
  Ops::sub(y3, y3, yj);
  Ops::sub(y3, y3, yj);
  Ops::add(t, p.z, h);          // z3 = (z1+h)² − z1z1 − hh
  Ops::sqr(t, t);
  Ops::sub(t, t, z1z1);
  Ops::sub(z3, t, hh);
  o.x = x3; o.y = y3; o.z = z3;
}

template <class Ops>
static void pt_neg(Point<Ops>& o, const Point<Ops>& p) {
  o.x = p.x;
  Ops::neg(o.y, p.y);
  o.z = p.z;
}

// scalar given as little-endian u64 limbs; width-4 NAF (digits in
// {0, ±1, ±3, ±5, ±7}), ~1/5 addition density vs 1/2 for double-and-add.
// Variable-time like the ladder it replaces (this backend verifies public
// data; the reference's blst wrapper is the hardened path for signing).
template <class Ops>
static void pt_mul(Point<Ops>& o, const Point<Ops>& p, const u64* scalar, int limbs) {
  if (p.is_inf() || limbs > 16) {  // limbs cap: largest caller is H_EFF (10)
    o = pt_infinity<Ops>();
    if (limbs <= 16) return;
    // oversized scalar: fall back to the plain ladder (unreachable today)
    Point<Ops> result = pt_infinity<Ops>();
    bool started = false;
    for (int i = limbs - 1; i >= 0; i--)
      for (int b = 63; b >= 0; b--) {
        if (started) pt_double(result, result);
        if ((scalar[i] >> b) & 1) {
          if (started) pt_add(result, result, p);
          else { result = p; started = true; }
        }
      }
    o = result;
    return;
  }
  u64 n[17];
  int L = limbs;
  for (int i = 0; i < L; i++) n[i] = scalar[i];
  n[L++] = 0;  // headroom for the +|d| carry in negative-digit recoding
  signed char digits[1089];
  int nd = 0;
  for (;;) {
    bool z = true;
    for (int i = 0; i < L; i++) if (n[i]) { z = false; break; }
    if (z) break;
    int d = 0;
    if (n[0] & 1) {
      d = (int)(n[0] & 15);
      if (d > 8) d -= 16;
      if (d > 0) {
        u64 borrow = (u64)d;
        for (int i = 0; i < L && borrow; i++) {
          u64 nv = n[i] - borrow;
          borrow = nv > n[i];
          n[i] = nv;
        }
      } else {
        u64 carry = (u64)(-d);
        for (int i = 0; i < L && carry; i++) {
          u64 nv = n[i] + carry;
          carry = nv < n[i];
          n[i] = nv;
        }
      }
    }
    digits[nd++] = (signed char)d;
    for (int i = 0; i < L - 1; i++) n[i] = (n[i] >> 1) | (n[i + 1] << 63);
    n[L - 1] >>= 1;
  }
  if (nd == 0) { o = pt_infinity<Ops>(); return; }
  Point<Ops> tbl[4];  // P, 3P, 5P, 7P
  tbl[0] = p;
  Point<Ops> p2;
  pt_double(p2, p);
  pt_add(tbl[1], tbl[0], p2);
  pt_add(tbl[2], tbl[1], p2);
  pt_add(tbl[3], tbl[2], p2);
  Point<Ops> result = pt_infinity<Ops>();
  for (int i = nd - 1; i >= 0; i--) {
    pt_double(result, result);
    int d = digits[i];
    if (d > 0) {
      pt_add(result, result, tbl[(d - 1) >> 1]);
    } else if (d < 0) {
      Point<Ops> m;
      pt_neg(m, tbl[((-d) - 1) >> 1]);
      pt_add(result, result, m);
    }
  }
  o = result;
}

template <class Ops>
static bool pt_in_subgroup(const Point<Ops>& p) {
  if (p.is_inf()) return true;
  Point<Ops> t;
  pt_mul(t, p, R_RAW, 4);
  return t.is_inf();
}

// affine (x, y); returns false for infinity
template <class Ops>
static bool pt_to_affine(typename Ops::F& ax, typename Ops::F& ay, const Point<Ops>& p) {
  typedef typename Ops::F F;
  if (p.is_inf()) return false;
  F zinv, z2, z3;
  Ops::inv(zinv, p.z);
  Ops::sqr(z2, zinv);
  Ops::mul(z3, z2, zinv);
  Ops::mul(ax, p.x, z2);
  Ops::mul(ay, p.y, z3);
  return true;
}

template <class Ops>
static Point<Ops> pt_from_affine(const typename Ops::F& ax, const typename Ops::F& ay) {
  Point<Ops> p;
  p.x = ax; p.y = ay; p.z = Ops::one();
  return p;
}

template <class Ops>
static bool pt_on_curve_affine(const typename Ops::F& ax, const typename Ops::F& ay,
                               const typename Ops::F& b) {
  typedef typename Ops::F F;
  F y2, x3, t;
  Ops::sqr(y2, ay);
  Ops::sqr(t, ax);
  Ops::mul(x3, t, ax);
  Ops::add(x3, x3, b);
  return Ops::eq(y2, x3);
}

// ---------------------------------------------------------------------------
// ZCash-format compressed serialization (mirrors curves.py)
// ---------------------------------------------------------------------------

enum DecodeErr {
  DEC_OK = 0,
  DEC_NOT_COMPRESSED = 2,
  DEC_BAD_INFINITY = 3,
  DEC_NOT_IN_FIELD = 4,
  DEC_NOT_ON_CURVE = 5,
  DEC_NOT_IN_SUBGROUP = 6,
};

static const u8 FLAG_COMPRESSED = 0x80;
static const u8 FLAG_INFINITY = 0x40;
static const u8 FLAG_SIGN = 0x20;

// decompress + full validation (curve + subgroup), infinity allowed
static int g1_decompress(G1& out, const u8 in[48], bool check_subgroup = true) {
  u8 flags = in[0];
  if (!(flags & FLAG_COMPRESSED)) return DEC_NOT_COMPRESSED;
  if (flags & FLAG_INFINITY) {
    if (flags & ~(FLAG_COMPRESSED | FLAG_INFINITY)) return DEC_BAD_INFINITY;
    for (int i = 1; i < 48; i++) if (in[i]) return DEC_BAD_INFINITY;
    out = pt_infinity<FpOps>();
    return DEC_OK;
  }
  u8 buf[48];
  memcpy(buf, in, 48);
  buf[0] = flags & 0x1F;
  Fp x;
  if (!fp_from_bytes(x, buf)) return DEC_NOT_IN_FIELD;
  Fp y2, t, y;
  fp_sqr(t, x);
  fp_mul(y2, t, x);
  fp_add(y2, y2, G1_B);
  if (!fp_sqrt(y, y2)) return DEC_NOT_ON_CURVE;
  if (fp_is_lex_largest(y) != !!(flags & FLAG_SIGN)) fp_neg(y, y);
  out = pt_from_affine<FpOps>(x, y);
  if (check_subgroup && !g1_in_subgroup(out)) return DEC_NOT_IN_SUBGROUP;
  return DEC_OK;
}

static int g2_decompress(G2& out, const u8 in[96], bool check_subgroup = true) {
  u8 flags = in[0];
  if (!(flags & FLAG_COMPRESSED)) return DEC_NOT_COMPRESSED;
  if (flags & FLAG_INFINITY) {
    if (flags & ~(FLAG_COMPRESSED | FLAG_INFINITY)) return DEC_BAD_INFINITY;
    for (int i = 1; i < 96; i++) if (in[i]) return DEC_BAD_INFINITY;
    out = pt_infinity<Fp2Ops>();
    return DEC_OK;
  }
  // layout: c1 (48, flags in MSB) || c0 (48)
  u8 buf[48];
  memcpy(buf, in, 48);
  buf[0] = flags & 0x1F;
  Fp2 x;
  if (!fp_from_bytes(x.c1, buf)) return DEC_NOT_IN_FIELD;
  if (!fp_from_bytes(x.c0, in + 48)) return DEC_NOT_IN_FIELD;
  Fp2 y2, t, y;
  fp2_sqr(t, x);
  fp2_mul(y2, t, x);
  fp2_add(y2, y2, G2_B);
  if (!fp2_sqrt(y, y2)) return DEC_NOT_ON_CURVE;
  if (fp2_is_lex_largest(y) != !!(flags & FLAG_SIGN)) fp2_neg(y, y);
  out = pt_from_affine<Fp2Ops>(x, y);
  if (check_subgroup && !g2_in_subgroup(out)) return DEC_NOT_IN_SUBGROUP;
  return DEC_OK;
}

static void g1_compress(u8 out[48], const G1& p) {
  if (p.is_inf()) {
    memset(out, 0, 48);
    out[0] = FLAG_COMPRESSED | FLAG_INFINITY;
    return;
  }
  Fp ax, ay;
  pt_to_affine<FpOps>(ax, ay, p);
  fp_to_bytes(out, ax);
  out[0] |= FLAG_COMPRESSED;
  if (fp_is_lex_largest(ay)) out[0] |= FLAG_SIGN;
}

static void g2_compress(u8 out[96], const G2& p) {
  if (p.is_inf()) {
    memset(out, 0, 96);
    out[0] = FLAG_COMPRESSED | FLAG_INFINITY;
    return;
  }
  Fp2 ax, ay;
  pt_to_affine<Fp2Ops>(ax, ay, p);
  fp_to_bytes(out, ax.c1);
  fp_to_bytes(out + 48, ax.c0);
  out[0] |= FLAG_COMPRESSED;
  if (fp2_is_lex_largest(ay)) out[0] |= FLAG_SIGN;
}

// ---------------------------------------------------------------------------
// Optimal ate pairing
//
// Miller loop over the M-twist with Jacobian accumulators and
// denominator-free line functions. Untwist: x = x'*xi^-1*v^2,
// y = y'*xi^-1*v*w (same map as crypto/pairing.py). Lines are scaled by
// Fq2 constants, which the final exponentiation kills (they lie in a
// proper subfield). Line slots in Fp12 (basis powers of w):
//   doubling, scale 2YZ^3:  c0.a0 = -xi*(2YZ^3 * yP)
//                           c1.a1 = 2Y^2 - 3X^3
//                           c1.a2 = (3X^2 Z^2) * xP
//   addition (T + Q, Q affine), scale lam_d = (X - xq Z^2) Z:
//     lam_n = Y - yq Z^3
//                           c0.a0 = -xi*(lam_d * yP)
//                           c1.a1 = yq*lam_d - lam_n*xq
//                           c1.a2 = lam_n * xP
// ---------------------------------------------------------------------------

struct MillerPair {
  Fp xp, yp;   // G1 affine
  Fp2 xq, yq;  // G2 affine (twist coords)
  G2 t;        // accumulator
};

// f *= line, exploiting the line's sparsity: line = A + B·w with
// A = (c00, 0, 0) and B = (0, c11, c12) in the Fp6[w]/(w²−v) tower.
// Karatsuba over the halves costs 3 + 6 + 6 = 15 fp2_mul vs the full
// fp12_mul's 18 — the saving lands on every Miller-loop step.
static void fp12_mul_by_line(Fp12& f, const Fp2& c00, const Fp2& c11, const Fp2& c12) {
  // t0 = f.c0 · A  (component scale by c00)
  Fp6 t0;
  fp2_mul(t0.a0, f.c0.a0, c00);
  fp2_mul(t0.a1, f.c0.a1, c00);
  fp2_mul(t0.a2, f.c0.a2, c00);
  // t1 = f.c1 · B:  (a0 + a1 v + a2 v²)(b v + c v²) with v³ = ξ
  //   = ξ(a1 c + a2 b) + (a0 b + ξ a2 c)·v + (a0 c + a1 b)·v²
  Fp6 t1;
  Fp2 u, w;
  fp2_mul(u, f.c1.a1, c12);
  fp2_mul(w, f.c1.a2, c11);
  fp2_add(u, u, w);
  fp2_mul_by_xi(t1.a0, u);
  fp2_mul(u, f.c1.a0, c11);
  fp2_mul(w, f.c1.a2, c12);
  fp2_mul_by_xi(w, w);
  fp2_add(t1.a1, u, w);
  fp2_mul(u, f.c1.a0, c12);
  fp2_mul(w, f.c1.a1, c11);
  fp2_add(t1.a2, u, w);
  // t2 = (f.c0 + f.c1) · (A + B); A + B = (c00, c11, c12) is dense
  Fp6 sum, ab, t2;
  fp6_add(sum, f.c0, f.c1);
  ab.a0 = c00; ab.a1 = c11; ab.a2 = c12;
  fp6_mul(t2, sum, ab);
  // o.c0 = t0 + v·t1 ; o.c1 = t2 − t0 − t1
  Fp6 vt;
  fp6_mul_by_v(vt, t1);
  fp6_add(f.c0, t0, vt);
  fp6_sub(t2, t2, t0);
  fp6_sub(f.c1, t2, t1);
}

// tangent line at pr.t evaluated at (xp, yp), multiplied into f, FUSED
// with the doubling T <- 2T (dbl-2009-l) so X², Y², Z², 3X² are computed
// once for both the line and the new point.
static void miller_double_step(Fp12& f, MillerPair& pr) {
  const Fp2 X = pr.t.x, Y = pr.t.y, Z = pr.t.z;
  Fp2 A, B, C, Z2, Z3c, L, X3c, E, c00, c11, c12, t, u;
  fp2_sqr(A, X);                     // X^2
  fp2_sqr(B, Y);                     // Y^2
  fp2_sqr(C, B);                     // Y^4
  fp2_sqr(Z2, Z);
  fp2_mul(Z3c, Z2, Z);               // Z^3
  // c00 = -xi * (2YZ^3 * yp)
  fp2_mul(L, Y, Z3c);
  fp2_dbl(L, L);
  fp2_scalar_mul(t, L, pr.yp);
  fp2_mul_by_xi(t, t);
  fp2_neg(c00, t);
  // c11 = 2Y^2 - 3X^3
  fp2_mul(X3c, A, X);
  fp2_dbl(c11, B);
  fp2_add(u, X3c, X3c);
  fp2_add(u, u, X3c);
  fp2_sub(c11, c11, u);
  // c12 = 3X^2 Z^2 * xp   (E = 3X^2 is also the doubling's slope term)
  fp2_add(E, A, A);
  fp2_add(E, E, A);
  fp2_mul(t, E, Z2);
  fp2_scalar_mul(c12, t, pr.xp);
  fp12_mul_by_line(f, c00, c11, c12);
  // T <- 2T reusing A, B, C, E (dbl-2009-l)
  Fp2 D, F, x3, y3, z3, c8;
  fp2_add(t, X, B);
  fp2_sqr(t, t);
  fp2_sub(t, t, A);
  fp2_sub(D, t, C);
  fp2_dbl(D, D);                     // 2((X+Y^2)^2 - X^2 - Y^4)
  fp2_sqr(F, E);
  fp2_sub(x3, F, D);
  fp2_sub(x3, x3, D);
  fp2_dbl(c8, C);
  fp2_dbl(c8, c8);
  fp2_dbl(c8, c8);                   // 8Y^4
  fp2_sub(t, D, x3);
  fp2_mul(y3, E, t);
  fp2_sub(y3, y3, c8);
  fp2_mul(z3, Y, Z);
  fp2_dbl(z3, z3);
  pr.t.x = x3; pr.t.y = y3; pr.t.z = z3;
}

// line through pr.t and affine (xq, yq) evaluated at (xp, yp), multiplied
// into f, FUSED with the mixed addition T <- T + Q (madd-2007-bl; Q has
// z = 1). T == ±Q never occurs inside the Miller loop: T = [k]Q with
// 1 < k < |x| << r, so the doubling/infinity arms of the generic add are
// unreachable and omitted.
static void miller_add_step(Fp12& f, MillerPair& pr) {
  const Fp2 X = pr.t.x, Y = pr.t.y, Z = pr.t.z;
  Fp2 Z2, Z3c, U2, S2, lam_n, lam_d, t, u, c00, c11, c12;
  fp2_sqr(Z2, Z);
  fp2_mul(Z3c, Z2, Z);
  fp2_mul(U2, pr.xq, Z2);            // xq Z^2
  fp2_mul(S2, pr.yq, Z3c);           // yq Z^3
  fp2_sub(lam_n, Y, S2);             // Y - yq Z^3
  fp2_sub(t, X, U2);
  fp2_mul(lam_d, t, Z);              // (X - xq Z^2) Z
  // c00 = -xi * (lam_d * yp)
  fp2_scalar_mul(u, lam_d, pr.yp);
  fp2_mul_by_xi(u, u);
  fp2_neg(c00, u);
  // c11 = yq*lam_d - lam_n*xq
  fp2_mul(t, pr.yq, lam_d);
  fp2_mul(u, lam_n, pr.xq);
  fp2_sub(c11, t, u);
  // c12 = lam_n * xp
  fp2_scalar_mul(c12, lam_n, pr.xp);
  fp12_mul_by_line(f, c00, c11, c12);
  // T <- T + Q, mixed addition reusing Z2, Z3c, U2, S2
  Fp2 H, HH, I, J, rr, V, x3, y3, z3;
  fp2_sub(H, U2, X);
  fp2_sqr(HH, H);
  fp2_dbl(I, HH);
  fp2_dbl(I, I);                     // 4 H^2
  fp2_mul(J, H, I);
  fp2_sub(rr, S2, Y);
  fp2_dbl(rr, rr);                   // 2(S2 - Y) = -2 lam_n
  fp2_mul(V, X, I);
  fp2_sqr(x3, rr);
  fp2_sub(x3, x3, J);
  fp2_sub(x3, x3, V);
  fp2_sub(x3, x3, V);
  fp2_sub(t, V, x3);
  fp2_mul(y3, rr, t);
  fp2_mul(u, Y, J);
  fp2_dbl(u, u);
  fp2_sub(y3, y3, u);
  fp2_add(z3, Z, H);
  fp2_sqr(z3, z3);
  fp2_sub(z3, z3, Z2);
  fp2_sub(z3, z3, HH);
  pr.t.x = x3; pr.t.y = y3; pr.t.z = z3;
}

// product of Miller loops, one shared squaring chain; pairs must be finite
static void multi_miller_loop(Fp12& f, MillerPair* pairs, size_t n) {
  f = FP12_ONE;
  if (n == 0) return;
  for (size_t k = 0; k < n; k++)
    pairs[k].t = pt_from_affine<Fp2Ops>(pairs[k].xq, pairs[k].yq);
  // bits of |x| MSB-first, top bit consumed by initialization
  int msb = 63;
  while (!((BLS_X_ABS >> msb) & 1)) msb--;
  for (int b = msb - 1; b >= 0; b--) {
    fp12_sqr(f, f);
    for (size_t k = 0; k < n; k++) miller_double_step(f, pairs[k]);
    if ((BLS_X_ABS >> b) & 1)
      for (size_t k = 0; k < n; k++) miller_add_step(f, pairs[k]);
  }
  // x negative: conjugate
  fp12_conj(f, f);
}

// Granger–Scott cyclotomic squaring: for elements of the cyclotomic
// subgroup (everything after the easy final-exp part), squaring costs
// three Fp4 squarings (9 fp2_sqr) instead of a generic fp12_sqr's 12
// fp2_mul — ~3x cheaper, and it dominates the exponentiation chains of
// the hard part. Validated once at init against fp12_sqr on a cyclotomic
// element (CYCLO_STATE); a mismatch demotes to the generic squaring.
static int CYCLO_STATE = -1;

// (a + b·s with s² = ξ): returns (a² + ξ·b², (a+b)² − a² − b²)
static void fp4_sqr(Fp2& out0, Fp2& out1, const Fp2& a, const Fp2& b) {
  Fp2 t0, t1, t2;
  fp2_sqr(t0, a);
  fp2_sqr(t1, b);
  fp2_mul_by_xi(out0, t1);
  fp2_add(out0, out0, t0);
  fp2_add(t2, a, b);
  fp2_sqr(t2, t2);
  fp2_sub(t2, t2, t0);
  fp2_sub(out1, t2, t1);
}

static void fp12_cyclo_sqr(Fp12& o, const Fp12& a) {
  // w-power basis components (see fp12_frob comment for the layout)
  Fp2 z0 = a.c0.a0, z4 = a.c0.a1, z3 = a.c0.a2;
  Fp2 z2 = a.c1.a0, z1 = a.c1.a1, z5 = a.c1.a2;
  Fp2 t0, t1, t2, t3, u;
  fp4_sqr(t0, t1, z0, z1);
  fp2_sub(u, t0, z0); fp2_dbl(u, u); fp2_add(z0, u, t0);   // 3t0 − 2z0
  fp2_add(u, t1, z1); fp2_dbl(u, u); fp2_add(z1, u, t1);   // 3t1 + 2z1
  fp4_sqr(t0, t1, z2, z3);
  fp4_sqr(t2, t3, z4, z5);
  fp2_sub(u, t0, z4); fp2_dbl(u, u); fp2_add(z4, u, t0);
  fp2_add(u, t1, z5); fp2_dbl(u, u); fp2_add(z5, u, t1);
  Fp2 xt3;
  fp2_mul_by_xi(xt3, t3);
  fp2_add(u, xt3, z2); fp2_dbl(u, u); fp2_add(z2, u, xt3);
  fp2_sub(u, t2, z3); fp2_dbl(u, u); fp2_add(z3, u, t2);
  o.c0.a0 = z0; o.c0.a1 = z4; o.c0.a2 = z3;
  o.c1.a0 = z2; o.c1.a1 = z1; o.c1.a2 = z5;
}

static inline void fp12_sqr_cyclotomic_input(Fp12& o, const Fp12& a) {
  if (CYCLO_STATE == 1) fp12_cyclo_sqr(o, a);
  else fp12_sqr(o, a);
}

// f^|x| then conjugate (x negative); input must be in cyclotomic subgroup
static void fp12_pow_neg_x(Fp12& o, const Fp12& a) {
  Fp12 result;
  bool started = false;
  for (int b = 63; b >= 0; b--) {
    if (started) fp12_sqr_cyclotomic_input(result, result);
    if ((BLS_X_ABS >> b) & 1) {
      if (started) fp12_mul(result, result, a);
      else { result = a; started = true; }
    }
  }
  fp12_conj(o, result);
}

// full final exponentiation up to a cube: f^(3*(p^12-1)/r).
// Hard part via (x-1)^2 (x+p) (x^2+p^2-1) + 3 == 3*(p^4-p^2+1)/r
// (verified numerically); the cube preserves the ==1 verdict since
// gcd(3, r) = 1. Only predicates are exposed, never raw pairing values.
static void final_exp_for_verdict(Fp12& o, const Fp12& f) {
  // easy: f^(p^6-1) = conj(f) * f^-1, then ^(p^2+1)
  Fp12 inv, f1, f2, t;
  fp12_inv(inv, f);
  fp12_conj(t, f);
  fp12_mul(f1, t, inv);
  fp12_frob_n(t, f1, 2);
  fp12_mul(f2, t, f1);
  // hard (cyclotomic subgroup: inverse == conjugate)
  Fp12 a, b, c, d, e;
  fp12_pow_neg_x(t, f2);
  fp12_conj(a, f2);
  fp12_mul(a, a, t);              // f2^(x-1)
  fp12_pow_neg_x(t, a);
  fp12_conj(b, a);
  fp12_mul(b, b, t);              // a^(x-1)
  fp12_pow_neg_x(t, b);
  fp12_frob(c, b);
  fp12_mul(c, c, t);              // b^(x+p)
  fp12_pow_neg_x(t, c);
  fp12_pow_neg_x(t, t);           // c^(x^2)
  fp12_frob_n(d, c, 2);
  fp12_mul(d, d, t);
  fp12_conj(e, c);
  fp12_mul(d, d, e);              // c^(x^2+p^2-1)
  // result = d * f2^3
  fp12_sqr(t, f2);
  fp12_mul(t, t, f2);
  fp12_mul(o, d, t);
}

// Π e(Pi, Qi) == 1, skipping infinite points (mirrors pairing.py)
// defined after the eight-lane tower below; false = engine unavailable,
// caller runs the scalar loop (identical Fp12 result — selftest-pinned)
static bool multi_miller_loop_x8_try(Fp12& f, MillerPair* pairs, size_t m);

static bool pairing_product_is_one(const G1* ps, const G2* qs, size_t n) {
  MillerPair pairs[129];
  MillerPair* heap_pairs = nullptr;
  MillerPair* use = pairs;
  if (n > 129) { heap_pairs = new MillerPair[n]; use = heap_pairs; }
  size_t m = 0;
  for (size_t i = 0; i < n; i++) {
    if (ps[i].is_inf() || qs[i].is_inf()) continue;
    // stash the Jacobian coords; the z inversions batch below (chunks of
    // 64 through one fp_inv each — Montgomery's trick)
    use[m].xp = ps[i].x;
    use[m].yp = ps[i].y;
    use[m].xq = qs[i].x;
    use[m].yq = qs[i].y;
    use[m].t.x = qs[i].z;  // temporary: G2 z parked in the accumulator slot
    use[m].t.z.c0 = ps[i].z;
    m++;
  }
  for (size_t base = 0; base < m; base += 64) {
    int c = (int)(m - base < 64 ? m - base : 64);
    Fp z1[64];
    Fp2 z2[64];
    for (int k = 0; k < c; k++) {
      z1[k] = use[base + k].t.z.c0;
      z2[k] = use[base + k].t.x;
    }
    fp_inv_batch(z1, c);
    fp2_inv_batch(z2, c);
    for (int k = 0; k < c; k++) {
      MillerPair& pr = use[base + k];
      Fp i2, i3;
      fp_sqr(i2, z1[k]);
      fp_mul(i3, i2, z1[k]);
      fp_mul(pr.xp, pr.xp, i2);
      fp_mul(pr.yp, pr.yp, i3);
      Fp2 j2, j3;
      fp2_sqr(j2, z2[k]);
      fp2_mul(j3, j2, z2[k]);
      fp2_mul(pr.xq, pr.xq, j2);
      fp2_mul(pr.yq, pr.yq, j3);
    }
  }
  Fp12 f, fe;
  if (!multi_miller_loop_x8_try(f, use, m)) multi_miller_loop(f, use, m);
  final_exp_for_verdict(fe, f);
  bool ok = fp12_is_one(fe);
  delete[] heap_pairs;
  return ok;
}

// ---------------------------------------------------------------------------
// init: derive every constant from p at load time
// ---------------------------------------------------------------------------

static Fp2 SSWU_A, SSWU_B, SSWU_Z, SSWU_NEG_B_OVER_A, SSWU_B_OVER_ZA;
static Fp2 ISO_XN[4], ISO_XD[3], ISO_YN[4], ISO_YD[4];

static void limbs_sub_small(u64* out, const u64* a, u64 small) {
  u64 borrow = 0;
  out[0] = sbb(a[0], small, borrow);
  for (int i = 1; i < 6; i++) out[i] = sbb(a[i], 0, borrow);
}

static void limbs_add_small(u64* out, const u64* a, u64 small) {
  u64 carry = 0;
  out[0] = adc(a[0], small, carry);
  for (int i = 1; i < 6; i++) out[i] = adc(a[i], 0, carry);
}

static void limbs_shr(u64* out, const u64* a, int k) {
  for (int i = 0; i < 6; i++) {
    u64 lo = a[i] >> k;
    u64 hi = (i + 1 < 6) ? (a[i + 1] << (64 - k)) : 0;
    out[i] = lo | hi;
  }
}

static void limbs_div3(u64* out, const u64* a) {
  u128 rem = 0;
  for (int i = 5; i >= 0; i--) {
    u128 cur = (rem << 64) | a[i];
    out[i] = (u64)(cur / 3);
    rem = cur % 3;
  }
}

static bool INITIALIZED = false;

static void ensure_init() {
  if (INITIALIZED) return;
  // -p^{-1} mod 2^64 by Newton iteration
  u64 inv = 1;
  for (int i = 0; i < 6; i++) inv *= 2 - P_RAW.l[0] * inv;
  FP_INV = (u64)0 - inv;
  // 2^768 mod p by doubling (fp_add reduces and needs no Montgomery state)
  Fp acc = {{1, 0, 0, 0, 0, 0}};
  for (int i = 0; i < 768; i++) fp_add(acc, acc, acc);
  FP_R2 = acc;
  Fp one_std = {{1, 0, 0, 0, 0, 0}};
  fp_mul(FP_ONE, one_std, FP_R2);
  // 2^{-1} = (p+1)/2 (p is odd, so (p+1)/2 * 2 = p + 1 ≡ 1)
  {
    u64 half[6];
    limbs_add_small(half, P_RAW.l, 1);
    limbs_shr(half, half, 1);
    Fp half_std;
    for (int i = 0; i < 6; i++) half_std.l[i] = half[i];
    fp_to_mont(FP_TWO_INV, half_std);
  }
  // exponents
  limbs_sub_small(EXP_P_MINUS_2, P_RAW.l, 2);
  u64 tmp[6];
  limbs_add_small(tmp, P_RAW.l, 1);
  limbs_shr(EXP_P_PLUS_1_DIV_4, tmp, 2);
  limbs_sub_small(tmp, P_RAW.l, 3);
  limbs_shr(EXP_P_MINUS_3_DIV_4, tmp, 2);
  limbs_sub_small(tmp, P_RAW.l, 1);
  limbs_shr(EXP_P_MINUS_1_DIV_2, tmp, 1);
  for (int i = 0; i < 6; i++) P_MINUS_1_DIV_2_STD[i] = EXP_P_MINUS_1_DIV_2[i];
  limbs_div3(EXP_P_MINUS_1_DIV_6, EXP_P_MINUS_1_DIV_2);
  // field constants
  FP2_ZERO.c0 = FP_ZERO; FP2_ZERO.c1 = FP_ZERO;
  FP2_ONE.c0 = FP_ONE; FP2_ONE.c1 = FP_ZERO;
  FP6_ZERO.a0 = FP2_ZERO; FP6_ZERO.a1 = FP2_ZERO; FP6_ZERO.a2 = FP2_ZERO;
  FP6_ONE.a0 = FP2_ONE; FP6_ONE.a1 = FP2_ZERO; FP6_ONE.a2 = FP2_ZERO;
  FP12_ONE.c0 = FP6_ONE; FP12_ONE.c1 = FP6_ZERO;
  // Frobenius gamma1^i = xi^(i*(p-1)/6)
  Fp2 xi;
  xi.c0 = FP_ONE; xi.c1 = FP_ONE;
  Fp2 g;
  fp2_pow(g, xi, EXP_P_MINUS_1_DIV_6, 6);
  FROB_GAMMA1[0] = FP2_ONE;
  for (int i = 1; i < 6; i++) fp2_mul(FROB_GAMMA1[i], FROB_GAMMA1[i - 1], g);
  // curve constants + generators
  fp_from_u64(G1_B, 4);
  fp_from_u64(G2_B.c0, 4);
  fp_from_u64(G2_B.c1, 4);
  Fp gx, gy;
  Fp g1x_std, g1y_std;
  for (int i = 0; i < 6; i++) { g1x_std.l[i] = G1_GEN_X.l[i]; g1y_std.l[i] = G1_GEN_Y.l[i]; }
  fp_to_mont(gx, g1x_std);
  fp_to_mont(gy, g1y_std);
  G1_GEN = pt_from_affine<FpOps>(gx, gy);
  Fp2 g2x, g2y;
  fp2_from_raw(g2x, G2_GEN_X);
  fp2_from_raw(g2y, G2_GEN_Y);
  G2_GEN = pt_from_affine<Fp2Ops>(g2x, g2y);
  // SSWU constants (RFC 9380 §8.8.2): A' = 240u, B' = 1012(1+u), Z = -(2+u)
  Fp f240, f1012, f2, f1;
  fp_from_u64(f240, 240);
  fp_from_u64(f1012, 1012);
  fp_from_u64(f2, 2);
  fp_from_u64(f1, 1);
  SSWU_A.c0 = FP_ZERO; SSWU_A.c1 = f240;
  SSWU_B.c0 = f1012; SSWU_B.c1 = f1012;
  fp_neg(SSWU_Z.c0, f2);
  fp_neg(SSWU_Z.c1, f1);
  Fp2 a_inv, t;
  fp2_inv(a_inv, SSWU_A);
  fp2_mul(t, SSWU_B, a_inv);
  fp2_neg(SSWU_NEG_B_OVER_A, t);
  Fp2 za, za_inv;
  fp2_mul(za, SSWU_Z, SSWU_A);
  fp2_inv(za_inv, za);
  fp2_mul(SSWU_B_OVER_ZA, SSWU_B, za_inv);
  // isogeny tables
  for (int i = 0; i < 4; i++) fp2_from_raw(ISO_XN[i], ISO_X_NUM[i]);
  for (int i = 0; i < 3; i++) fp2_from_raw(ISO_XD[i], ISO_X_DEN[i]);
  for (int i = 0; i < 4; i++) fp2_from_raw(ISO_YN[i], ISO_Y_NUM[i]);
  for (int i = 0; i < 4; i++) fp2_from_raw(ISO_YD[i], ISO_Y_DEN[i]);
  // validate + enable the endomorphism fast paths (psi cofactor clearing,
  // psi/GLV subgroup criteria) before any caller can race on their state
  validate_endomorphism_fast_paths();
  // eight-wide IFMA engine last: its self-check wants the exponent
  // tables and scalar field fully set up
  fp8_engine_init();
  INITIALIZED = true;
}

// ---------------------------------------------------------------------------
// SHA-256 (for expand_message_xmd); standard FIPS 180-4 constants
// ---------------------------------------------------------------------------

static const u32 SHA_K[64] = {
  0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
  0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
  0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
  0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
  0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
  0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
  0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
  0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
  0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
  0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
  0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2,
};

struct Sha256 {
  u32 h[8];
  u8 buf[64];
  u64 total;
  size_t fill;
};

static inline u32 rotr(u32 x, int n) { return (x >> n) | (x << (32 - n)); }

static void sha_init(Sha256& s) {
  static const u32 H0[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                            0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  memcpy(s.h, H0, sizeof(H0));
  s.total = 0;
  s.fill = 0;
}

static void sha_block(Sha256& s, const u8* p) {
  u32 w[64];
  for (int i = 0; i < 16; i++)
    w[i] = ((u32)p[4 * i] << 24) | ((u32)p[4 * i + 1] << 16) |
           ((u32)p[4 * i + 2] << 8) | p[4 * i + 3];
  for (int i = 16; i < 64; i++) {
    u32 s0 = rotr(w[i - 15], 7) ^ rotr(w[i - 15], 18) ^ (w[i - 15] >> 3);
    u32 s1 = rotr(w[i - 2], 17) ^ rotr(w[i - 2], 19) ^ (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  u32 a = s.h[0], b = s.h[1], c = s.h[2], d = s.h[3];
  u32 e = s.h[4], f = s.h[5], g = s.h[6], hh = s.h[7];
  for (int i = 0; i < 64; i++) {
    u32 S1 = rotr(e, 6) ^ rotr(e, 11) ^ rotr(e, 25);
    u32 ch = (e & f) ^ (~e & g);
    u32 t1 = hh + S1 + ch + SHA_K[i] + w[i];
    u32 S0 = rotr(a, 2) ^ rotr(a, 13) ^ rotr(a, 22);
    u32 maj = (a & b) ^ (a & c) ^ (b & c);
    u32 t2 = S0 + maj;
    hh = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  s.h[0] += a; s.h[1] += b; s.h[2] += c; s.h[3] += d;
  s.h[4] += e; s.h[5] += f; s.h[6] += g; s.h[7] += hh;
}

static void sha_update(Sha256& s, const u8* data, size_t len) {
  s.total += len;
  while (len) {
    if (s.fill == 0 && len >= 64) {
      sha_block(s, data);
      data += 64;
      len -= 64;
      continue;
    }
    size_t take = 64 - s.fill;
    if (take > len) take = len;
    memcpy(s.buf + s.fill, data, take);
    s.fill += take;
    data += take;
    len -= take;
    if (s.fill == 64) { sha_block(s, s.buf); s.fill = 0; }
  }
}

static void sha_final(Sha256& s, u8 out[32]) {
  u64 bits = s.total * 8;
  u8 pad = 0x80;
  sha_update(s, &pad, 1);
  u8 z = 0;
  while (s.fill != 56) sha_update(s, &z, 1);
  u8 lenb[8];
  for (int i = 0; i < 8; i++) lenb[i] = (u8)(bits >> (56 - 8 * i));
  sha_update(s, lenb, 8);
  for (int i = 0; i < 8; i++) {
    out[4 * i] = (u8)(s.h[i] >> 24);
    out[4 * i + 1] = (u8)(s.h[i] >> 16);
    out[4 * i + 2] = (u8)(s.h[i] >> 8);
    out[4 * i + 3] = (u8)s.h[i];
  }
}

// ---------------------------------------------------------------------------
// hash_to_g2 (RFC 9380, BLS12381G2_XMD:SHA-256_SSWU_RO_), mirrors
// crypto/hash_to_curve.py
// ---------------------------------------------------------------------------

// len_in_bytes <= 256 covers count=2, m=2, L=64
static bool expand_message_xmd(u8* out, size_t len_in_bytes, const u8* msg,
                               size_t msg_len, const u8* dst, size_t dst_len) {
  const size_t B = 32, RB = 64;
  size_t ell = (len_in_bytes + B - 1) / B;
  if (ell > 255 || len_in_bytes > 65535 || dst_len > 255) return false;
  u8 dst_prime[256];
  memcpy(dst_prime, dst, dst_len);
  dst_prime[dst_len] = (u8)dst_len;
  size_t dp_len = dst_len + 1;
  u8 zpad[RB];
  memset(zpad, 0, RB);
  u8 lib[2] = {(u8)(len_in_bytes >> 8), (u8)len_in_bytes};
  u8 b0[32], bi[32];
  Sha256 s;
  sha_init(s);
  sha_update(s, zpad, RB);
  sha_update(s, msg, msg_len);
  sha_update(s, lib, 2);
  u8 zero = 0;
  sha_update(s, &zero, 1);
  sha_update(s, dst_prime, dp_len);
  sha_final(s, b0);
  sha_init(s);
  sha_update(s, b0, 32);
  u8 one = 1;
  sha_update(s, &one, 1);
  sha_update(s, dst_prime, dp_len);
  sha_final(s, bi);
  size_t off = 0;
  for (size_t i = 1;; i++) {
    size_t take = len_in_bytes - off < 32 ? len_in_bytes - off : 32;
    memcpy(out + off, bi, take);
    off += take;
    if (off >= len_in_bytes) break;
    u8 x[32];
    for (int j = 0; j < 32; j++) x[j] = b0[j] ^ bi[j];
    sha_init(s);
    sha_update(s, x, 32);
    u8 idx = (u8)(i + 1);
    sha_update(s, &idx, 1);
    sha_update(s, dst_prime, dp_len);
    sha_final(s, bi);
  }
  return true;
}

// 64-byte big-endian -> Fp via Horner in the field
static void fp_from_64_bytes(Fp& out, const u8 in[64]) {
  Fp b;  // 2^64 as a field element
  fp_from_u64(b, 0);  // placeholder; set below via doubling
  // 2^64 = (2^32)^2; build from u64 1<<32 squared to stay in range
  Fp t32;
  fp_from_u64(t32, (u64)1 << 32);
  fp_mul(b, t32, t32);
  Fp acc;
  fp_from_u64(acc, 0);
  for (int i = 0; i < 8; i++) {
    u64 w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | in[i * 8 + j];
    Fp lw;
    fp_from_u64(lw, w);
    fp_mul(acc, acc, b);
    fp_add(acc, acc, lw);
  }
  out = acc;
}

static void map_to_curve_sswu(Fp2& xo, Fp2& yo, const Fp2& u) {
  Fp2 u2, zu2, tv, x1, gx1, y1, t;
  fp2_sqr(u2, u);
  fp2_mul(zu2, SSWU_Z, u2);
  fp2_sqr(tv, zu2);
  fp2_add(tv, tv, zu2);
  if (fp2_is_zero(tv)) {
    x1 = SSWU_B_OVER_ZA;
  } else {
    Fp2 tv_inv;
    fp2_inv(tv_inv, tv);
    fp2_add(t, FP2_ONE, tv_inv);
    fp2_mul(x1, SSWU_NEG_B_OVER_A, t);
  }
  // g(x) = x^3 + A x + B
  Fp2 x3, ax;
  fp2_sqr(t, x1);
  fp2_mul(x3, t, x1);
  fp2_mul(ax, SSWU_A, x1);
  fp2_add(gx1, x3, ax);
  fp2_add(gx1, gx1, SSWU_B);
  Fp2 x, y;
  if (fp2_sqrt(y1, gx1)) {
    x = x1; y = y1;
  } else {
    Fp2 x2, gx2, y2;
    fp2_mul(x2, zu2, x1);
    fp2_sqr(t, x2);
    fp2_mul(x3, t, x2);
    fp2_mul(ax, SSWU_A, x2);
    fp2_add(gx2, x3, ax);
    fp2_add(gx2, gx2, SSWU_B);
    fp2_sqrt(y2, gx2);  // must be square when gx1 is not
    x = x2; y = y2;
  }
  if (fp2_sgn0(y) != fp2_sgn0(u)) fp2_neg(y, y);
  xo = x; yo = y;
}

static void horner_fp2(Fp2& out, const Fp2* coeffs, int n, const Fp2& v) {
  Fp2 acc = FP2_ZERO;
  for (int i = n - 1; i >= 0; i--) {
    Fp2 t;
    fp2_mul(t, acc, v);
    fp2_add(acc, t, coeffs[i]);
  }
  out = acc;
}

static void iso_map_to_g2(G2& out, const Fp2& x, const Fp2& y) {
  Fp2 xn, xd, yn, yd;
  horner_fp2(xn, ISO_XN, 4, x);
  horner_fp2(xd, ISO_XD, 3, x);
  horner_fp2(yn, ISO_YN, 4, x);
  horner_fp2(yd, ISO_YD, 4, x);
  if (fp2_is_zero(xd) || fp2_is_zero(yd)) {
    out = pt_infinity<Fp2Ops>();
    return;
  }
  Fp2 xd_inv, yd_inv, xo, yo, t;
  fp2_inv(xd_inv, xd);
  fp2_mul(xo, xn, xd_inv);
  fp2_inv(yd_inv, yd);
  fp2_mul(t, yn, yd_inv);
  fp2_mul(yo, y, t);
  out = pt_from_affine<Fp2Ops>(xo, yo);
}

// ---------------------------------------------------------------------------
// Fast G2 cofactor clearing via the untwist-Frobenius-twist endomorphism
// (Budroni–Pintore): [h_eff]P == [x²−x−1]P + [x−1]ψ(P) + ψ²([2]P), where
// x is the (negative) BLS parameter. ψ(x, y) = (c_x·conj(x), c_y·conj(y))
// with c_x = 1/ξ^((p−1)/3), c_y = 1/ξ^((p−1)/2) — the inverses of the
// Frobenius gammas already computed for the pairing. Replaces the naive
// 640-bit H_EFF double-and-add (~950 group ops) with two 64-bit
// multiplications (~140 ops). The identity is cross-checked once per
// process against the H_EFF path on the first (pre-clearing, generic)
// mapped point; a mismatch demotes to the slow path permanently.
// ---------------------------------------------------------------------------

static Fp2 PSI_CX, PSI_CY;
static int PSI_STATE = -1;   // set by validate_endomorphism_fast_paths
static int G2_SUB_STATE = -1;
// BLS_X_ABS (|x|; x itself is negative) comes from bls12_381_constants.h

static void g2_psi(G2& o, const G2& p) {
  Fp2 cx, cy, cz;
  fp2_conj(cx, p.x);
  fp2_conj(cy, p.y);
  fp2_conj(cz, p.z);
  fp2_mul(o.x, cx, PSI_CX);
  fp2_mul(o.y, cy, PSI_CY);
  o.z = cz;
}

static void g2_mul_bls_x_neg(G2& o, const G2& p) {
  // [x]P = −[|x|]P
  G2 t;
  pt_mul(t, p, &BLS_X_ABS, 1);
  pt_neg(o, t);
}

template <class Ops>
static bool pt_eq_jacobian(const Point<Ops>& a, const Point<Ops>& b) {
  // X1·Z2² == X2·Z1²  and  Y1·Z2³ == Y2·Z1³ (Jacobian equality)
  typedef typename Ops::F F;
  bool ai = a.is_inf(), bi = b.is_inf();
  if (ai || bi) return ai == bi;
  F z1z1, z2z2, l, r;
  Ops::sqr(z1z1, a.z);
  Ops::sqr(z2z2, b.z);
  Ops::mul(l, a.x, z2z2);
  Ops::mul(r, b.x, z1z1);
  if (!Ops::eq(l, r)) return false;
  F z1c, z2c;
  Ops::mul(z1c, z1z1, a.z);
  Ops::mul(z2c, z2z2, b.z);
  Ops::mul(l, a.y, z2c);
  Ops::mul(r, b.y, z1c);
  return Ops::eq(l, r);
}

static bool g2_eq(const G2& a, const G2& b) { return pt_eq_jacobian<Fp2Ops>(a, b); }

// ---------------------------------------------------------------------------
// Fast G1 subgroup membership via the GLV endomorphism φ(x,y) = (βx, y)
// (β a primitive cube root of unity in Fp): on G1, φ acts as
// multiplication by λ = x²−1 (λ²+λ+1 ≡ 0 mod r), so
//   P ∈ G1  ⟺  φ(P) + P == [x²]P
// — two 64-bit multiplications instead of the 255-bit order mul. β and
// the criterion are validated at first use against the slow check on the
// generator (positive) and a synthesized off-subgroup curve point
// (negative); any disagreement demotes permanently.
// ---------------------------------------------------------------------------

static Fp G1_BETA;
static int G1_SUB_STATE = -1;  // set by validate_endomorphism_fast_paths

static bool g1_in_subgroup_fast(const G1& p) {
  if (p.is_inf()) return true;
  G1 l, r, t;
  l = p;
  fp_mul(l.x, p.x, G1_BETA);      // φ(P) — Jacobian x scales the same way
  pt_add(l, l, p);                // φ(P) + P
  pt_mul(t, p, &BLS_X_ABS, 1);
  pt_mul(r, t, &BLS_X_ABS, 1);    // [x²]P (sign of x is irrelevant squared)
  return pt_eq_jacobian<FpOps>(l, r);
}

static bool g1_validate_fast_subgroup() {
  // β = (2^((p−1)/6))² = 2^((p−1)/3); if it's 1, fall back (never for this p)
  Fp two, g;
  fp_from_u64(two, 2);
  fp_pow(g, two, EXP_P_MINUS_1_DIV_6, 6);
  fp_sqr(G1_BETA, g);
  if (FpOps::eq(G1_BETA, FP_ONE)) return false;
  // the GLV eigenvalue may correspond to β or β²; pick the one that fixes
  // the generator under the criterion
  if (!g1_in_subgroup_fast(G1_GEN)) {
    fp_sqr(G1_BETA, G1_BETA);
    if (!g1_in_subgroup_fast(G1_GEN)) return false;
  }
  if (!pt_in_subgroup(G1_GEN)) return false;
  // negative case: find a curve point (x=2,3,...) that the slow check
  // rejects (the cofactor is ~2^125, so the first few x all qualify)
  for (u64 xi = 2; xi < 40; xi++) {
    Fp x, y2, t, y;
    fp_from_u64(x, xi);
    fp_sqr(t, x);
    fp_mul(y2, t, x);
    fp_add(y2, y2, G1_B);
    if (!fp_sqrt(y, y2)) continue;
    G1 cand = pt_from_affine<FpOps>(x, y);
    if (pt_in_subgroup(cand)) continue;  // astronomically unlikely
    return !g1_in_subgroup_fast(cand);
  }
  return false;
}

static bool g1_in_subgroup(const G1& p) {
  if (G1_SUB_STATE == 1) return g1_in_subgroup_fast(p);
  return pt_in_subgroup(p);
}

static void g2_clear_cofactor_fast(G2& o, const G2& p) {
  G2 t1, t2, t3, t4, n;
  g2_mul_bls_x_neg(t1, p);          // [x]P
  g2_psi(t2, p);                    // ψ(P)
  pt_double(t3, p);
  g2_psi(t3, t3);
  g2_psi(t3, t3);                   // ψ²([2]P)
  pt_neg(n, t2);
  pt_add(t3, t3, n);                // ψ²(2P) − ψ(P)
  pt_add(t4, t1, t2);               // [x]P + ψ(P)
  g2_mul_bls_x_neg(t4, t4);         // [x²]P + [x]ψ(P)
  pt_add(t3, t3, t4);
  pt_neg(n, t1);
  pt_add(t3, t3, n);                // − [x]P
  pt_neg(n, p);
  pt_add(t3, t3, n);                // − P
  o = t3;
}

// ψ acts on G2 as multiplication by x (p ≡ x mod r for BLS curves), so
// P ∈ G2  ⟺  ψ(P) == [x]P (Scott's criterion) — a 64-bit mul + ψ instead
// of the 255-bit order multiplication.
static bool g2_in_subgroup_fast(const G2& p) {
  if (p.is_inf()) return true;
  G2 l, r;
  g2_psi(l, p);
  g2_mul_bls_x_neg(r, p);
  return g2_eq(l, r);
}

static bool g2_in_subgroup(const G2& p) {
  if (G2_SUB_STATE == 1) return g2_in_subgroup_fast(p);
  return pt_in_subgroup(p);
}

static void g2_clear_cofactor(G2& out, const G2& sum) {
  if (PSI_STATE == 1) {
    g2_clear_cofactor_fast(out, sum);
  } else {
    pt_mul(out, sum, H_EFF_G2_RAW, 10);
  }
}

// Runs once at the tail of ensure_init: derives the endomorphism
// constants, then validates every fast path against its slow reference on
// the generator (in-subgroup) and a synthesized generic curve point
// (off-subgroup, cofactors ≈ 2^125 / 2^507 make random curve points
// off-subgroup with overwhelming probability). Any disagreement leaves
// the corresponding path demoted to the slow, always-correct code.
static void validate_endomorphism_fast_paths() {
  // --- G1: GLV criterion ---
  G1_SUB_STATE = g1_validate_fast_subgroup() ? 1 : -1;

  // --- psi constants ---
  fp2_inv(PSI_CX, FROB_GAMMA1[2]);  // 1/xi^((p-1)/3)
  fp2_inv(PSI_CY, FROB_GAMMA1[3]);  // 1/xi^((p-1)/2)

  // synthesize a generic point on the twist: x = (a, 0), a = 1, 2, ...
  G2 cand;
  bool have_cand = false;
  for (u64 a = 1; a < 60 && !have_cand; a++) {
    Fp2 x, y2, t, y;
    fp_from_u64(x.c0, a);
    x.c1 = FP_ZERO;
    fp2_sqr(t, x);
    fp2_mul(y2, t, x);
    fp2_add(y2, y2, G2_B);
    if (!fp2_sqrt(y, y2)) continue;
    cand = pt_from_affine<Fp2Ops>(x, y);
    if (pt_in_subgroup(cand)) continue;  // astronomically unlikely
    have_cand = true;
  }
  if (!have_cand) {
    PSI_STATE = -1;
    G2_SUB_STATE = -1;
    return;
  }

  // cofactor clearing: fast == slow on the generic point
  G2 fast, slow;
  g2_clear_cofactor_fast(fast, cand);
  pt_mul(slow, cand, H_EFF_G2_RAW, 10);
  PSI_STATE = g2_eq(fast, slow) ? 1 : -1;

  // subgroup criterion: agree on the off-subgroup candidate (false) and
  // the cleared point + generator (true)
  if (PSI_STATE == 1) {
    bool neg_ok = !g2_in_subgroup_fast(cand);
    bool pos_ok = g2_in_subgroup_fast(slow) && pt_in_subgroup(slow) &&
                  g2_in_subgroup_fast(G2_GEN);
    G2_SUB_STATE = (neg_ok && pos_ok) ? 1 : -1;
  } else {
    G2_SUB_STATE = -1;
  }

  // --- cyclotomic squaring: build a cyclotomic-subgroup element the same
  // way the final exponentiation does (easy part of a Miller value),
  // then require fp12_cyclo_sqr == fp12_sqr on it ---
  {
    MillerPair mp;
    pt_to_affine<FpOps>(mp.xp, mp.yp, G1_GEN);
    pt_to_affine<Fp2Ops>(mp.xq, mp.yq, G2_GEN);
    Fp12 f, inv, c, f1, f2, t, a, b;
    multi_miller_loop(f, &mp, 1);
    fp12_inv(inv, f);
    fp12_conj(c, f);
    fp12_mul(f1, c, inv);           // f^(p^6 - 1)
    fp12_frob_n(t, f1, 2);
    fp12_mul(f2, t, f1);            // ^(p^2 + 1): cyclotomic
    fp12_sqr(a, f2);
    fp12_cyclo_sqr(b, f2);
    CYCLO_STATE = fp12_eq(a, b) ? 1 : -1;
  }
}

static bool hash_to_g2_point(G2& out, const u8* msg, size_t msg_len,
                             const u8* dst, size_t dst_len) {
  u8 uniform[256];
  if (!expand_message_xmd(uniform, 256, msg, msg_len, dst, dst_len)) {
    out = pt_infinity<Fp2Ops>();
    return false;
  }
  Fp2 u0, u1;
  fp_from_64_bytes(u0.c0, uniform);
  fp_from_64_bytes(u0.c1, uniform + 64);
  fp_from_64_bytes(u1.c0, uniform + 128);
  fp_from_64_bytes(u1.c1, uniform + 192);
  Fp2 x0, y0, x1, y1;
  map_to_curve_sswu(x0, y0, u0);
  map_to_curve_sswu(x1, y1, u1);
  G2 q0, q1, sum;
  iso_map_to_g2(q0, x0, y0);
  iso_map_to_g2(q1, x1, y1);
  pt_add(sum, q0, q1);
  g2_clear_cofactor(out, sum);
  return true;
}

// ---------------------------------------------------------------------------
// Eight-lane G2 point arithmetic on the IFMA engine. Straight-line
// Jacobian formulas (no per-lane branching): z == 0 IS the infinity
// representation, doubling preserves it (z3 = 2yz) and addition handles
// infinite operands by lane-blending, so the only genuinely exceptional
// case left is adding two EQUAL finite points — those lanes are flagged
// in an exception mask and recomputed scalar (cryptographically random
// inputs never hit this; correctness never depends on that).
// ---------------------------------------------------------------------------

#ifdef EC_FP8_COMPILED

EC_FP8_TARGET static void fp8_neg(Fp8& o, const Fp8& a) {
  Fp8 z;
  for (int j = 0; j < 8; j++) z.l[j] = _mm512_setzero_si512();
  fp8_sub(o, z, a);
}

struct Fp2x8 { Fp8 c0, c1; };

EC_FP8_TARGET static void fp2x8_add(Fp2x8& o, const Fp2x8& a, const Fp2x8& b) {
  fp8_add(o.c0, a.c0, b.c0);
  fp8_add(o.c1, a.c1, b.c1);
}
EC_FP8_TARGET static void fp2x8_sub(Fp2x8& o, const Fp2x8& a, const Fp2x8& b) {
  fp8_sub(o.c0, a.c0, b.c0);
  fp8_sub(o.c1, a.c1, b.c1);
}
EC_FP8_TARGET static void fp2x8_neg(Fp2x8& o, const Fp2x8& a) {
  fp8_neg(o.c0, a.c0);
  fp8_neg(o.c1, a.c1);
}
EC_FP8_TARGET static void fp2x8_conj(Fp2x8& o, const Fp2x8& a) {
  o.c0 = a.c0;
  fp8_neg(o.c1, a.c1);
}
// Karatsuba over i^2 = -1, the vector twin of fp2_mul
EC_FP8_TARGET static void fp2x8_mul(Fp2x8& o, const Fp2x8& a, const Fp2x8& b) {
  Fp8 t0, t1, sa, sb, m;
  fp8_montmul(t0, a.c0, b.c0);
  fp8_montmul(t1, a.c1, b.c1);
  fp8_add(sa, a.c0, a.c1);
  fp8_add(sb, b.c0, b.c1);
  fp8_montmul(m, sa, sb);
  fp8_sub(m, m, t0);
  fp8_sub(o.c1, m, t1);
  fp8_sub(o.c0, t0, t1);
}
EC_FP8_TARGET static void fp2x8_sqr(Fp2x8& o, const Fp2x8& a) {
  Fp8 s, d, m, t;
  fp8_add(s, a.c0, a.c1);
  fp8_sub(d, a.c0, a.c1);
  fp8_montmul(m, s, d);          // a0^2 - a1^2
  fp8_montmul(t, a.c0, a.c1);
  fp8_add(o.c1, t, t);
  o.c0 = m;
}
EC_FP8_TARGET static __mmask8 fp2x8_is_zero_mask(const Fp2x8& a) {
  return fp8_is_zero_mask(a.c0) & fp8_is_zero_mask(a.c1);
}
EC_FP8_TARGET static __mmask8 fp2x8_eq_mask(const Fp2x8& a, const Fp2x8& b) {
  return fp8_eq_mask(a.c0, b.c0) & fp8_eq_mask(a.c1, b.c1);
}
EC_FP8_TARGET static void fp8_blend(Fp8& o, __mmask8 take_b, const Fp8& a,
                                    const Fp8& b) {
  for (int j = 0; j < 8; j++)
    o.l[j] = _mm512_mask_blend_epi64(take_b, a.l[j], b.l[j]);
}
EC_FP8_TARGET static void fp2x8_blend(Fp2x8& o, __mmask8 take_b,
                                      const Fp2x8& a, const Fp2x8& b) {
  fp8_blend(o.c0, take_b, a.c0, b.c0);
  fp8_blend(o.c1, take_b, a.c1, b.c1);
}
// broadcast one scalar Fp2 into all lanes
EC_FP8_TARGET static void fp2x8_bcast_fp2(Fp2x8& o, const Fp2& v) {
  fp8_load(o.c0, &v.c0, 1);
  fp8_load(o.c1, &v.c1, 1);
}

struct G2x8 { Fp2x8 x, y, z; };

EC_FP8_TARGET static void g2x8_load(G2x8& o, const G2* pts, int n) {
  Fp xs0[8], xs1[8], ys0[8], ys1[8], zs0[8], zs1[8];
  for (int k = 0; k < 8; k++) {
    const G2& p = pts[k < n ? k : 0];
    xs0[k] = p.x.c0; xs1[k] = p.x.c1;
    ys0[k] = p.y.c0; ys1[k] = p.y.c1;
    zs0[k] = p.z.c0; zs1[k] = p.z.c1;
  }
  fp8_load(o.x.c0, xs0, 8); fp8_load(o.x.c1, xs1, 8);
  fp8_load(o.y.c0, ys0, 8); fp8_load(o.y.c1, ys1, 8);
  fp8_load(o.z.c0, zs0, 8); fp8_load(o.z.c1, zs1, 8);
}

EC_FP8_TARGET static void g2x8_store(G2* out, const G2x8& a, int n) {
  Fp xs0[8], xs1[8], ys0[8], ys1[8], zs0[8], zs1[8];
  fp8_store(xs0, a.x.c0, 8); fp8_store(xs1, a.x.c1, 8);
  fp8_store(ys0, a.y.c0, 8); fp8_store(ys1, a.y.c1, 8);
  fp8_store(zs0, a.z.c0, 8); fp8_store(zs1, a.z.c1, 8);
  for (int k = 0; k < n; k++) {
    out[k].x.c0 = xs0[k]; out[k].x.c1 = xs1[k];
    out[k].y.c0 = ys0[k]; out[k].y.c1 = ys1[k];
    out[k].z.c0 = zs0[k]; out[k].z.c1 = zs1[k];
  }
}

// dbl-2009-l, lane-complete: infinity (z=0) and y=0 both yield z3=0
EC_FP8_TARGET static void g2x8_dbl(G2x8& o, const G2x8& p) {
  Fp2x8 a, b, c, d, e, f, t, c8;
  fp2x8_sqr(a, p.x);
  fp2x8_sqr(b, p.y);
  fp2x8_sqr(c, b);
  fp2x8_add(t, p.x, b);
  fp2x8_sqr(t, t);
  fp2x8_sub(t, t, a);
  fp2x8_sub(d, t, c);
  fp2x8_add(d, d, d);
  fp2x8_add(e, a, a);
  fp2x8_add(e, e, a);
  fp2x8_sqr(f, e);
  Fp2x8 x3, y3, z3;
  fp2x8_sub(x3, f, d);
  fp2x8_sub(x3, x3, d);
  fp2x8_add(c8, c, c);
  fp2x8_add(c8, c8, c8);
  fp2x8_add(c8, c8, c8);
  fp2x8_sub(t, d, x3);
  fp2x8_mul(y3, e, t);
  fp2x8_sub(y3, y3, c8);
  fp2x8_mul(z3, p.y, p.z);
  fp2x8_add(z3, z3, z3);
  o.x = x3; o.y = y3; o.z = z3;
}

// add-2007-bl with infinity lane-blending; equal-finite-point lanes
// (the doubling case) are accumulated into *exc for scalar recomputation
EC_FP8_TARGET static void g2x8_add(G2x8& o, const G2x8& p, const G2x8& q,
                                  __mmask8& exc) {
  const __mmask8 pinf = fp2x8_is_zero_mask(p.z);
  const __mmask8 qinf = fp2x8_is_zero_mask(q.z);
  Fp2x8 z1z1, z2z2, u1, u2, s1, s2, t;
  fp2x8_sqr(z1z1, p.z);
  fp2x8_sqr(z2z2, q.z);
  fp2x8_mul(u1, p.x, z2z2);
  fp2x8_mul(u2, q.x, z1z1);
  fp2x8_mul(t, p.y, q.z);
  fp2x8_mul(s1, t, z2z2);
  fp2x8_mul(t, q.y, p.z);
  fp2x8_mul(s2, t, z1z1);
  const __mmask8 equ = fp2x8_eq_mask(u1, u2);
  const __mmask8 eqs = fp2x8_eq_mask(s1, s2);
  exc |= (__mmask8)(~pinf & ~qinf & equ & eqs);
  Fp2x8 h, i, j, r, v, x3, y3, z3;
  fp2x8_sub(h, u2, u1);            // h == 0 with s1 != s2: P = -Q, z3 = 0 below
  fp2x8_add(i, h, h);
  fp2x8_sqr(i, i);
  fp2x8_mul(j, h, i);
  fp2x8_sub(r, s2, s1);
  fp2x8_add(r, r, r);
  fp2x8_mul(v, u1, i);
  fp2x8_sqr(x3, r);
  fp2x8_sub(x3, x3, j);
  fp2x8_sub(x3, x3, v);
  fp2x8_sub(x3, x3, v);
  fp2x8_sub(t, v, x3);
  fp2x8_mul(y3, r, t);
  Fp2x8 sj;
  fp2x8_mul(sj, s1, j);
  fp2x8_sub(y3, y3, sj);
  fp2x8_sub(y3, y3, sj);
  fp2x8_mul(t, p.z, q.z);
  fp2x8_add(t, t, t);
  fp2x8_mul(z3, t, h);
  // infinite-operand lanes take the other operand verbatim
  fp2x8_blend(x3, pinf, x3, q.x);
  fp2x8_blend(y3, pinf, y3, q.y);
  fp2x8_blend(z3, pinf, z3, q.z);
  fp2x8_blend(x3, qinf, x3, p.x);
  fp2x8_blend(y3, qinf, y3, p.y);
  fp2x8_blend(z3, qinf, z3, p.z);
  o.x = x3; o.y = y3; o.z = z3;
}

EC_FP8_TARGET static void g2x8_neg(G2x8& o, const G2x8& p) {
  o.x = p.x;
  fp2x8_neg(o.y, p.y);
  o.z = p.z;
}

// vector twin of g2_psi: conjugate coordinates, scale x and y by the
// untwist-Frobenius-twist constants
EC_FP8_TARGET static void g2x8_psi(G2x8& o, const G2x8& p) {
  Fp2x8 cx, cy, cz, kx, ky;
  fp2x8_conj(cx, p.x);
  fp2x8_conj(cy, p.y);
  fp2x8_conj(cz, p.z);
  fp2x8_bcast_fp2(kx, PSI_CX);
  fp2x8_bcast_fp2(ky, PSI_CY);
  fp2x8_mul(o.x, cx, kx);
  fp2x8_mul(o.y, cy, ky);
  o.z = cz;
}

// [x]P = -[|x|]P over the sparse 64-bit |x|, shared schedule per lane
EC_FP8_TARGET static void g2x8_mul_bls_x_neg(G2x8& o, const G2x8& p,
                                             __mmask8& exc) {
  G2x8 acc = p;  // |x| has its top bit at 63
  for (int b = 62; b >= 0; b--) {
    g2x8_dbl(acc, acc);
    if ((BLS_X_ABS >> b) & 1) g2x8_add(acc, acc, p, exc);
  }
  g2x8_neg(o, acc);
}

// vector twin of g2_clear_cofactor_fast (Budroni-Pintore)
EC_FP8_TARGET static void g2x8_clear_cofactor(G2x8& o, const G2x8& p,
                                              __mmask8& exc) {
  G2x8 t1, t2, t3, t4, n;
  g2x8_mul_bls_x_neg(t1, p, exc);   // [x]P
  g2x8_psi(t2, p);                  // psi(P)
  g2x8_dbl(t3, p);
  g2x8_psi(t3, t3);
  g2x8_psi(t3, t3);                 // psi^2([2]P)
  g2x8_neg(n, t2);
  g2x8_add(t3, t3, n, exc);         // psi^2(2P) - psi(P)
  g2x8_add(t4, t1, t2, exc);        // [x]P + psi(P)
  g2x8_mul_bls_x_neg(t4, t4, exc);  // [x^2]P + [x]psi(P)
  g2x8_add(t3, t3, t4, exc);
  g2x8_neg(n, t1);
  g2x8_add(t3, t3, n, exc);         // - [x]P
  g2x8_neg(n, p);
  g2x8_add(t3, t3, n, exc);         // - P
  o = t3;
}

// Scott criterion psi(P) == [x]P per lane; lanes where either side is
// infinite (or the compare is otherwise degenerate) land in *exc
EC_FP8_TARGET static __mmask8 g2x8_in_subgroup_mask(const G2x8& p,
                                                    __mmask8& exc) {
  G2x8 l, r;
  g2x8_psi(l, p);
  g2x8_mul_bls_x_neg(r, p, exc);
  const __mmask8 linf = fp2x8_is_zero_mask(l.z);
  const __mmask8 rinf = fp2x8_is_zero_mask(r.z);
  exc |= (__mmask8)(linf | rinf);
  Fp2x8 z1z1, z2z2, a, b, z1c, z2c;
  fp2x8_sqr(z1z1, l.z);
  fp2x8_sqr(z2z2, r.z);
  fp2x8_mul(a, l.x, z2z2);
  fp2x8_mul(b, r.x, z1z1);
  const __mmask8 xeq = fp2x8_eq_mask(a, b);
  fp2x8_mul(z1c, z1z1, l.z);
  fp2x8_mul(z2c, z2z2, r.z);
  fp2x8_mul(a, l.y, z2c);
  fp2x8_mul(b, r.y, z1c);
  const __mmask8 yeq = fp2x8_eq_mask(a, b);
  return xeq & yeq;
}

// ---- G1x8: the same lane-complete Jacobian machinery over Fp ----

struct G1x8 { Fp8 x, y, z; };

EC_FP8_TARGET static void g1x8_load(G1x8& o, const G1* pts, int n) {
  Fp xs[8], ys[8], zs[8];
  for (int k = 0; k < 8; k++) {
    const G1& p = pts[k < n ? k : 0];
    xs[k] = p.x; ys[k] = p.y; zs[k] = p.z;
  }
  fp8_load(o.x, xs, 8);
  fp8_load(o.y, ys, 8);
  fp8_load(o.z, zs, 8);
}

EC_FP8_TARGET static void g1x8_store(G1* out, const G1x8& a, int n) {
  Fp xs[8], ys[8], zs[8];
  fp8_store(xs, a.x, 8);
  fp8_store(ys, a.y, 8);
  fp8_store(zs, a.z, 8);
  for (int k = 0; k < n; k++) {
    out[k].x = xs[k]; out[k].y = ys[k]; out[k].z = zs[k];
  }
}

EC_FP8_TARGET static void g1x8_dbl(G1x8& o, const G1x8& p) {
  Fp8 a, b, c, d, e, f, t, c8, x3, y3, z3;
  fp8_sqr(a, p.x);
  fp8_sqr(b, p.y);
  fp8_sqr(c, b);
  fp8_add(t, p.x, b);
  fp8_sqr(t, t);
  fp8_sub(t, t, a);
  fp8_sub(d, t, c);
  fp8_add(d, d, d);
  fp8_add(e, a, a);
  fp8_add(e, e, a);
  fp8_sqr(f, e);
  fp8_sub(x3, f, d);
  fp8_sub(x3, x3, d);
  fp8_add(c8, c, c);
  fp8_add(c8, c8, c8);
  fp8_add(c8, c8, c8);
  fp8_sub(t, d, x3);
  fp8_montmul(y3, e, t);
  fp8_sub(y3, y3, c8);
  fp8_montmul(z3, p.y, p.z);
  fp8_add(z3, z3, z3);
  o.x = x3; o.y = y3; o.z = z3;
}

EC_FP8_TARGET static void g1x8_add(G1x8& o, const G1x8& p, const G1x8& q,
                                  __mmask8& exc) {
  const __mmask8 pinf = fp8_is_zero_mask(p.z);
  const __mmask8 qinf = fp8_is_zero_mask(q.z);
  Fp8 z1z1, z2z2, u1, u2, s1, s2, t;
  fp8_sqr(z1z1, p.z);
  fp8_sqr(z2z2, q.z);
  fp8_montmul(u1, p.x, z2z2);
  fp8_montmul(u2, q.x, z1z1);
  fp8_montmul(t, p.y, q.z);
  fp8_montmul(s1, t, z2z2);
  fp8_montmul(t, q.y, p.z);
  fp8_montmul(s2, t, z1z1);
  const __mmask8 equ = fp8_eq_mask(u1, u2);
  const __mmask8 eqs = fp8_eq_mask(s1, s2);
  exc |= (__mmask8)(~pinf & ~qinf & equ & eqs);
  Fp8 h, i, j, r, v, x3, y3, z3, sj;
  fp8_sub(h, u2, u1);
  fp8_add(i, h, h);
  fp8_sqr(i, i);
  fp8_montmul(j, h, i);
  fp8_sub(r, s2, s1);
  fp8_add(r, r, r);
  fp8_montmul(v, u1, i);
  fp8_sqr(x3, r);
  fp8_sub(x3, x3, j);
  fp8_sub(x3, x3, v);
  fp8_sub(x3, x3, v);
  fp8_sub(t, v, x3);
  fp8_montmul(y3, r, t);
  fp8_montmul(sj, s1, j);
  fp8_sub(y3, y3, sj);
  fp8_sub(y3, y3, sj);
  fp8_montmul(t, p.z, q.z);
  fp8_add(t, t, t);
  fp8_montmul(z3, t, h);
  fp8_blend(x3, pinf, x3, q.x);
  fp8_blend(y3, pinf, y3, q.y);
  fp8_blend(z3, pinf, z3, q.z);
  fp8_blend(x3, qinf, x3, p.x);
  fp8_blend(y3, qinf, y3, p.y);
  fp8_blend(z3, qinf, z3, p.z);
  o.x = x3; o.y = y3; o.z = z3;
}

EC_FP8_TARGET static void g1x8_blend(G1x8& o, __mmask8 take_b, const G1x8& a,
                                     const G1x8& b) {
  fp8_blend(o.x, take_b, a.x, b.x);
  fp8_blend(o.y, take_b, a.y, b.y);
  fp8_blend(o.z, take_b, a.z, b.z);
}

// Eight independent 128-bit scalar multiplications with one shared 4-bit
// window schedule (the scalars differ per lane, so each window's table
// pick is a 16-way masked select). Used for the RLC blinder products
// r_i * aggpk_i in batch verification.
EC_FP8_TARGET static void g1x8_mul128(G1x8& o, const G1x8& p,
                                      const u64 (*r)[2], int n,
                                      __mmask8& exc) {
  G1x8 tbl[16];
  {
    Fp ones[8], zeros[8];
    for (int k = 0; k < 8; k++) { ones[k] = FP_ONE; zeros[k] = FP_ZERO; }
    fp8_load(tbl[0].x, ones, 8);
    fp8_load(tbl[0].y, ones, 8);
    fp8_load(tbl[0].z, zeros, 8);
  }
  tbl[1] = p;
  for (int d = 2; d < 16; d++) {
    if (d % 2 == 0) g1x8_dbl(tbl[d], tbl[d / 2]);
    else g1x8_add(tbl[d], tbl[d - 1], p, exc);  // (d-1)P + P, d-1 >= 2
  }
  G1x8 acc;
  bool started = false;
  for (int w = 124; w >= 0; w -= 4) {
    if (started) {
      g1x8_dbl(acc, acc);
      g1x8_dbl(acc, acc);
      g1x8_dbl(acc, acc);
      g1x8_dbl(acc, acc);
    }
    u8 digs[8];
    u8 any = 0;
    for (int k = 0; k < 8; k++) {
      const u64* rk = r[k < n ? k : 0];
      digs[k] = (u8)((rk[w >> 6] >> (w & 63)) & 15);
      any |= digs[k];
    }
    if (!started && !any) continue;
    G1x8 sel = tbl[0];
    for (int d = 1; d < 16; d++) {
      __mmask8 m = 0;
      for (int k = 0; k < 8; k++)
        if (digs[k] == d) m |= (__mmask8)(1u << k);
      if (m) g1x8_blend(sel, m, sel, tbl[d]);
    }
    if (!started) { acc = sel; started = true; }
    else g1x8_add(acc, acc, sel, exc);
  }
  if (!started) acc = tbl[0];
  o = acc;
}

// Batched blinder products out[i] = r_i * pts[i] (r 128-bit, nonzero);
// exception lanes redo the scalar ladder — mirrors pt_mul exactly
static void g1_mul128_batch(G1* out, const G1* pts, const u64 (*r)[2],
                            size_t n) {
  size_t base = 0;
  for (; FP8_READY && base < n; base += 8) {
    int c = (int)(n - base < 8 ? n - base : 8);
    G1x8 pv, ov;
    g1x8_load(pv, pts + base, c);
    __mmask8 exc = 0;
    g1x8_mul128(ov, pv, r + base, c, exc);
    g1x8_store(out + base, ov, c);
    for (int k = 0; k < c; k++)
      if ((exc >> k) & 1) {
        u64 sc[2] = {r[base + k][0], r[base + k][1]};
        pt_mul(out[base + k], pts[base + k], sc, 2);
      }
  }
  for (; base < n; base++) {
    u64 sc[2] = {r[base][0], r[base][1]};
    pt_mul(out[base], pts[base], sc, 2);
  }
}

// Eight-lane sum of n (>= 8) decompressed G2 points: running partial
// sums per lane, scalar combine; infinity operands blend through, the
// duplicate-point doubling corner patches scalar (result == serial chain)
EC_FP8_TARGET static void g2_sum_pts_x8(G2& out, const G2* pts, size_t n) {
  G2x8 accv;
  g2x8_load(accv, pts, 8);
  size_t i = 8;
  for (; i + 8 <= n; i += 8) {
    G2x8 inc;
    g2x8_load(inc, pts + i, 8);
    const G2x8 saved = accv;
    __mmask8 exc = 0;
    g2x8_add(accv, accv, inc, exc);
    if (exc) {
      G2 sv[8], nw[8];
      g2x8_store(sv, saved, 8);
      g2x8_store(nw, accv, 8);
      for (int g = 0; g < 8; g++)
        if ((exc >> g) & 1) pt_add(nw[g], sv[g], pts[i + g]);
      g2x8_load(accv, nw, 8);
    }
  }
  G2 fin[8];
  g2x8_store(fin, accv, 8);
  G2 acc = pt_infinity<Fp2Ops>();
  for (int g = 0; g < 8; g++) pt_add(acc, acc, fin[g]);
  for (; i < n; i++) pt_add(acc, acc, pts[i]);
  out = acc;
}

// ---- Fp6x8 / Fp12x8: lane-parallel tower for the eight-wide Miller loop ----

EC_FP8_TARGET static void fp2x8_mul_by_xi(Fp2x8& o, const Fp2x8& a) {
  Fp8 t0, t1;
  fp8_sub(t0, a.c0, a.c1);
  fp8_add(t1, a.c0, a.c1);
  o.c0 = t0; o.c1 = t1;
}
EC_FP8_TARGET static void fp2x8_scalar_mul(Fp2x8& o, const Fp2x8& a,
                                           const Fp8& k) {
  fp8_montmul(o.c0, a.c0, k);
  fp8_montmul(o.c1, a.c1, k);
}

struct Fp6x8 { Fp2x8 a0, a1, a2; };
struct Fp12x8 { Fp6x8 c0, c1; };

EC_FP8_TARGET static void fp6x8_add(Fp6x8& o, const Fp6x8& a, const Fp6x8& b) {
  fp2x8_add(o.a0, a.a0, b.a0);
  fp2x8_add(o.a1, a.a1, b.a1);
  fp2x8_add(o.a2, a.a2, b.a2);
}
EC_FP8_TARGET static void fp6x8_sub(Fp6x8& o, const Fp6x8& a, const Fp6x8& b) {
  fp2x8_sub(o.a0, a.a0, b.a0);
  fp2x8_sub(o.a1, a.a1, b.a1);
  fp2x8_sub(o.a2, a.a2, b.a2);
}
EC_FP8_TARGET static void fp6x8_neg(Fp6x8& o, const Fp6x8& a) {
  fp2x8_neg(o.a0, a.a0);
  fp2x8_neg(o.a1, a.a1);
  fp2x8_neg(o.a2, a.a2);
}
// vector twin of fp6_mul (Toom/Karatsuba layout kept identical)
EC_FP8_TARGET static void fp6x8_mul(Fp6x8& o, const Fp6x8& a, const Fp6x8& b) {
  Fp2x8 t0, t1, t2, s, u, x, y, c0, c1, c2;
  fp2x8_mul(t0, a.a0, b.a0);
  fp2x8_mul(t1, a.a1, b.a1);
  fp2x8_mul(t2, a.a2, b.a2);
  fp2x8_add(s, a.a1, a.a2);
  fp2x8_add(u, b.a1, b.a2);
  fp2x8_mul(x, s, u);
  fp2x8_sub(x, x, t1);
  fp2x8_sub(x, x, t2);
  fp2x8_mul_by_xi(y, x);
  fp2x8_add(c0, t0, y);
  fp2x8_add(s, a.a0, a.a1);
  fp2x8_add(u, b.a0, b.a1);
  fp2x8_mul(x, s, u);
  fp2x8_sub(x, x, t0);
  fp2x8_sub(x, x, t1);
  fp2x8_mul_by_xi(y, t2);
  fp2x8_add(c1, x, y);
  fp2x8_add(s, a.a0, a.a2);
  fp2x8_add(u, b.a0, b.a2);
  fp2x8_mul(x, s, u);
  fp2x8_sub(x, x, t0);
  fp2x8_sub(x, x, t2);
  fp2x8_add(c2, x, t1);
  o.a0 = c0; o.a1 = c1; o.a2 = c2;
}
EC_FP8_TARGET static void fp6x8_mul_by_v(Fp6x8& o, const Fp6x8& a) {
  Fp2x8 t, old_a0, old_a1;
  fp2x8_mul_by_xi(t, a.a2);
  old_a0 = a.a0;
  old_a1 = a.a1;
  o.a0 = t; o.a1 = old_a0; o.a2 = old_a1;
}
EC_FP8_TARGET static void fp12x8_sqr(Fp12x8& o, const Fp12x8& a) {
  Fp6x8 u, s, t, vt;
  fp6x8_mul(u, a.c0, a.c1);
  fp6x8_add(s, a.c0, a.c1);
  fp6x8_mul_by_v(vt, a.c1);
  fp6x8_add(t, a.c0, vt);
  fp6x8_mul(t, s, t);
  fp6x8_sub(t, t, u);
  fp6x8_mul_by_v(vt, u);
  fp6x8_sub(o.c0, t, vt);
  fp6x8_add(o.c1, u, u);
}
EC_FP8_TARGET static void fp12x8_conj(Fp12x8& o, const Fp12x8& a) {
  o.c0 = a.c0;
  fp6x8_neg(o.c1, a.c1);
}
// vector twin of fp12_mul_by_line (same sparse Karatsuba split)
EC_FP8_TARGET static void fp12x8_mul_by_line(Fp12x8& f, const Fp2x8& c00,
                                             const Fp2x8& c11,
                                             const Fp2x8& c12) {
  Fp6x8 t0;
  fp2x8_mul(t0.a0, f.c0.a0, c00);
  fp2x8_mul(t0.a1, f.c0.a1, c00);
  fp2x8_mul(t0.a2, f.c0.a2, c00);
  Fp6x8 t1;
  Fp2x8 u, w;
  fp2x8_mul(u, f.c1.a1, c12);
  fp2x8_mul(w, f.c1.a2, c11);
  fp2x8_add(u, u, w);
  fp2x8_mul_by_xi(t1.a0, u);
  fp2x8_mul(u, f.c1.a0, c11);
  fp2x8_mul(w, f.c1.a2, c12);
  fp2x8_mul_by_xi(w, w);
  fp2x8_add(t1.a1, u, w);
  fp2x8_mul(u, f.c1.a0, c12);
  fp2x8_mul(w, f.c1.a1, c11);
  fp2x8_add(t1.a2, u, w);
  Fp6x8 sum, ab, t2;
  fp6x8_add(sum, f.c0, f.c1);
  ab.a0 = c00; ab.a1 = c11; ab.a2 = c12;
  fp6x8_mul(t2, sum, ab);
  Fp6x8 vt;
  fp6x8_mul_by_v(vt, t1);
  fp6x8_add(f.c0, t0, vt);
  fp6x8_sub(t2, t2, t0);
  fp6x8_sub(f.c1, t2, t1);
}
EC_FP8_TARGET static void fp12x8_blend(Fp12x8& o, __mmask8 take_b,
                                       const Fp12x8& a, const Fp12x8& b) {
  fp2x8_blend(o.c0.a0, take_b, a.c0.a0, b.c0.a0);
  fp2x8_blend(o.c0.a1, take_b, a.c0.a1, b.c0.a1);
  fp2x8_blend(o.c0.a2, take_b, a.c0.a2, b.c0.a2);
  fp2x8_blend(o.c1.a0, take_b, a.c1.a0, b.c1.a0);
  fp2x8_blend(o.c1.a1, take_b, a.c1.a1, b.c1.a1);
  fp2x8_blend(o.c1.a2, take_b, a.c1.a2, b.c1.a2);
}
EC_FP8_TARGET static void fp12x8_store_lanes(Fp12* out, const Fp12x8& a,
                                             int n) {
  const Fp8* comps[12] = {
      &a.c0.a0.c0, &a.c0.a0.c1, &a.c0.a1.c0, &a.c0.a1.c1,
      &a.c0.a2.c0, &a.c0.a2.c1, &a.c1.a0.c0, &a.c1.a0.c1,
      &a.c1.a1.c0, &a.c1.a1.c1, &a.c1.a2.c0, &a.c1.a2.c1};
  Fp lanes[12][8];
  for (int c = 0; c < 12; c++) fp8_store(lanes[c], *comps[c], 8);
  for (int k = 0; k < n; k++) {
    out[k].c0.a0.c0 = lanes[0][k];  out[k].c0.a0.c1 = lanes[1][k];
    out[k].c0.a1.c0 = lanes[2][k];  out[k].c0.a1.c1 = lanes[3][k];
    out[k].c0.a2.c0 = lanes[4][k];  out[k].c0.a2.c1 = lanes[5][k];
    out[k].c1.a0.c0 = lanes[6][k];  out[k].c1.a0.c1 = lanes[7][k];
    out[k].c1.a1.c0 = lanes[8][k];  out[k].c1.a1.c1 = lanes[9][k];
    out[k].c1.a2.c0 = lanes[10][k]; out[k].c1.a2.c1 = lanes[11][k];
  }
}

// ---- eight-wide Miller loop: pairs round-robined over lanes ----
//
// The scalar multi_miller_loop shares ONE f-squaring chain across all
// pairs; here the pairs split into eight groups (pair i -> slot i/8,
// lane i%8), each lane accumulates its own group product through the
// same shared-squaring chain, and the eight group products multiply
// together scalar-side at the end — algebraically the identical Miller
// product, bit-for-bit (selftest-pinned against the scalar loop).

struct MillerPairX8 {
  Fp8 xp, yp;     // G1 affine lanes
  Fp2x8 xq, yq;   // G2 affine lanes (twist coords)
  G2x8 t;         // per-lane accumulator
};

EC_FP8_TARGET static void miller_double_step_x8(Fp12x8& f, MillerPairX8& pr) {
  const Fp2x8 X = pr.t.x, Y = pr.t.y, Z = pr.t.z;
  Fp2x8 A, B, C, Z2, Z3c, L, X3c, E, c00, c11, c12, t, u;
  fp2x8_sqr(A, X);
  fp2x8_sqr(B, Y);
  fp2x8_sqr(C, B);
  fp2x8_sqr(Z2, Z);
  fp2x8_mul(Z3c, Z2, Z);
  fp2x8_mul(L, Y, Z3c);
  fp2x8_add(L, L, L);
  fp2x8_scalar_mul(t, L, pr.yp);
  fp2x8_mul_by_xi(t, t);
  fp2x8_neg(c00, t);
  fp2x8_mul(X3c, A, X);
  fp2x8_add(c11, B, B);
  fp2x8_add(u, X3c, X3c);
  fp2x8_add(u, u, X3c);
  fp2x8_sub(c11, c11, u);
  fp2x8_add(E, A, A);
  fp2x8_add(E, E, A);
  fp2x8_mul(t, E, Z2);
  fp2x8_scalar_mul(c12, t, pr.xp);
  fp12x8_mul_by_line(f, c00, c11, c12);
  Fp2x8 D, F, x3, y3, z3, c8;
  fp2x8_add(t, X, B);
  fp2x8_sqr(t, t);
  fp2x8_sub(t, t, A);
  fp2x8_sub(D, t, C);
  fp2x8_add(D, D, D);
  fp2x8_sqr(F, E);
  fp2x8_sub(x3, F, D);
  fp2x8_sub(x3, x3, D);
  fp2x8_add(c8, C, C);
  fp2x8_add(c8, c8, c8);
  fp2x8_add(c8, c8, c8);
  fp2x8_sub(t, D, x3);
  fp2x8_mul(y3, E, t);
  fp2x8_sub(y3, y3, c8);
  fp2x8_mul(z3, Y, Z);
  fp2x8_add(z3, z3, z3);
  pr.t.x = x3; pr.t.y = y3; pr.t.z = z3;
}

EC_FP8_TARGET static void miller_add_step_x8(Fp12x8& f, MillerPairX8& pr) {
  const Fp2x8 X = pr.t.x, Y = pr.t.y, Z = pr.t.z;
  Fp2x8 Z2, Z3c, U2, S2, lam_n, lam_d, t, u, c00, c11, c12;
  fp2x8_sqr(Z2, Z);
  fp2x8_mul(Z3c, Z2, Z);
  fp2x8_mul(U2, pr.xq, Z2);
  fp2x8_mul(S2, pr.yq, Z3c);
  fp2x8_sub(lam_n, Y, S2);
  fp2x8_sub(t, X, U2);
  fp2x8_mul(lam_d, t, Z);
  fp2x8_scalar_mul(u, lam_d, pr.yp);
  fp2x8_mul_by_xi(u, u);
  fp2x8_neg(c00, u);
  fp2x8_mul(t, pr.yq, lam_d);
  fp2x8_mul(u, lam_n, pr.xq);
  fp2x8_sub(c11, t, u);
  fp2x8_scalar_mul(c12, lam_n, pr.xp);
  fp12x8_mul_by_line(f, c00, c11, c12);
  Fp2x8 H, HH, I, J, rr, V, x3, y3, z3;
  fp2x8_sub(H, U2, X);
  fp2x8_sqr(HH, H);
  fp2x8_add(I, HH, HH);
  fp2x8_add(I, I, I);
  fp2x8_mul(J, H, I);
  fp2x8_sub(rr, S2, Y);
  fp2x8_add(rr, rr, rr);
  fp2x8_mul(V, X, I);
  fp2x8_sqr(x3, rr);
  fp2x8_sub(x3, x3, J);
  fp2x8_sub(x3, x3, V);
  fp2x8_sub(x3, x3, V);
  fp2x8_sub(t, V, x3);
  fp2x8_mul(y3, rr, t);
  fp2x8_mul(u, Y, J);
  fp2x8_add(u, u, u);
  fp2x8_sub(y3, y3, u);
  fp2x8_add(z3, Z, H);
  fp2x8_sqr(z3, z3);
  fp2x8_sub(z3, z3, Z2);
  fp2x8_sub(z3, z3, HH);
  pr.t.x = x3; pr.t.y = y3; pr.t.z = z3;
}

EC_FP8_TARGET static void multi_miller_loop_x8_impl(Fp12& f_out,
                                                    MillerPair* pairs,
                                                    size_t m) {
  const size_t K = (m + 7) / 8;           // slots; pair i -> slot i/8, lane i%8
  // MillerPairX8 holds __m512i members (alignof 64). Plain new[] only
  // honors that from C++17's aligned-new on; under a C++14 toolchain the
  // 16-byte-aligned heap block GP-faults the first vmovdqa64. Align by
  // hand so the build is safe regardless of -std level.
  char* slots_raw = new char[K * sizeof(MillerPairX8) + 64];
  MillerPairX8* slots = reinterpret_cast<MillerPairX8*>(
      (reinterpret_cast<uintptr_t>(slots_raw) + 63) & ~uintptr_t(63));
  int acts[64];  // K <= 64 enforced by caller? no — heap-size acts
  int* act = (K > 64) ? new int[K] : acts;
  for (size_t k = 0; k < K; k++) {
    size_t lo = 8 * k;
    int c = (int)(m - lo < 8 ? m - lo : 8);
    act[k] = c;
    Fp xp[8], yp[8], xq0[8], xq1[8], yq0[8], yq1[8];
    for (int g = 0; g < 8; g++) {
      const MillerPair& p = pairs[lo + (g < c ? g : 0)];
      xp[g] = p.xp; yp[g] = p.yp;
      xq0[g] = p.xq.c0; xq1[g] = p.xq.c1;
      yq0[g] = p.yq.c0; yq1[g] = p.yq.c1;
    }
    fp8_load(slots[k].xp, xp, 8);
    fp8_load(slots[k].yp, yp, 8);
    fp8_load(slots[k].xq.c0, xq0, 8);
    fp8_load(slots[k].xq.c1, xq1, 8);
    fp8_load(slots[k].yq.c0, yq0, 8);
    fp8_load(slots[k].yq.c1, yq1, 8);
    slots[k].t.x = slots[k].xq;
    slots[k].t.y = slots[k].yq;
    // z = 1 in every lane
    Fp ones[8], zeros[8];
    for (int g = 0; g < 8; g++) { ones[g] = FP_ONE; zeros[g] = FP_ZERO; }
    fp8_load(slots[k].t.z.c0, ones, 8);
    fp8_load(slots[k].t.z.c1, zeros, 8);
  }
  // f = 1 in every lane
  Fp12x8 f;
  {
    Fp ones[8], zeros[8];
    for (int g = 0; g < 8; g++) { ones[g] = FP_ONE; zeros[g] = FP_ZERO; }
    Fp8 one8, zero8;
    fp8_load(one8, ones, 8);
    fp8_load(zero8, zeros, 8);
    f.c0.a0.c0 = one8;  f.c0.a0.c1 = zero8;
    f.c0.a1.c0 = zero8; f.c0.a1.c1 = zero8;
    f.c0.a2.c0 = zero8; f.c0.a2.c1 = zero8;
    f.c1.a0.c0 = zero8; f.c1.a0.c1 = zero8;
    f.c1.a1.c0 = zero8; f.c1.a1.c1 = zero8;
    f.c1.a2.c0 = zero8; f.c1.a2.c1 = zero8;
  }
  int msb = 63;
  while (!((BLS_X_ABS >> msb) & 1)) msb--;
  for (int b = msb - 1; b >= 0; b--) {
    fp12x8_sqr(f, f);
    for (size_t k = 0; k < K; k++) {
      if (act[k] == 8) {
        miller_double_step_x8(f, slots[k]);
      } else {
        // ragged slot: inactive lanes keep their f untouched
        Fp12x8 fsave = f;
        miller_double_step_x8(f, slots[k]);
        fp12x8_blend(f, (__mmask8)((1u << act[k]) - 1), fsave, f);
      }
    }
    if ((BLS_X_ABS >> b) & 1) {
      for (size_t k = 0; k < K; k++) {
        if (act[k] == 8) {
          miller_add_step_x8(f, slots[k]);
        } else {
          Fp12x8 fsave = f;
          miller_add_step_x8(f, slots[k]);
          fp12x8_blend(f, (__mmask8)((1u << act[k]) - 1), fsave, f);
        }
      }
    }
  }
  fp12x8_conj(f, f);  // x negative
  Fp12 lanes[8];
  fp12x8_store_lanes(lanes, f, 8);
  Fp12 total = lanes[0];
  for (int g = 1; g < 8; g++) fp12_mul(total, total, lanes[g]);
  f_out = total;
  if (act != acts) delete[] act;
  delete[] slots_raw;
}

// Batched cofactor clearing over n Jacobian sums (the hash-to-G2 tail):
// exception lanes redo the scalar chain; result identical to
// g2_clear_cofactor by construction
static void g2_clear_cofactor_batch(G2* out, const G2* in, size_t n) {
  if (!FP8_READY || PSI_STATE != 1) {
    for (size_t i = 0; i < n; i++) g2_clear_cofactor(out[i], in[i]);
    return;
  }
  for (size_t base = 0; base < n; base += 8) {
    int c = (int)(n - base < 8 ? n - base : 8);
    G2x8 pv, ov;
    g2x8_load(pv, in + base, c);
    __mmask8 exc = 0;
    g2x8_clear_cofactor(ov, pv, exc);
    g2x8_store(out + base, ov, c);
    for (int k = 0; k < c; k++)
      if ((exc >> k) & 1) g2_clear_cofactor(out[base + k], in[base + k]);
  }
}

// [|x|]P on G1 lanes, shared sparse schedule (no negate — used squared)
EC_FP8_TARGET static void g1x8_mul_bls_x_abs(G1x8& o, const G1x8& p,
                                             __mmask8& exc) {
  G1x8 acc = p;
  for (int b = 62; b >= 0; b--) {
    g1x8_dbl(acc, acc);
    if ((BLS_X_ABS >> b) & 1) g1x8_add(acc, acc, p, exc);
  }
  o = acc;
}

// GLV criterion phi(P) + P == [x^2]P per lane (vector twin of
// g1_in_subgroup_fast); degenerate lanes land in *exc
EC_FP8_TARGET static __mmask8 g1x8_in_subgroup_mask(const G1x8& p,
                                                    __mmask8& exc) {
  G1x8 l = p, r, t;
  Fp8 beta;
  fp8_load(beta, &G1_BETA, 1);
  fp8_montmul(l.x, p.x, beta);
  g1x8_add(l, l, p, exc);
  g1x8_mul_bls_x_abs(t, p, exc);
  g1x8_mul_bls_x_abs(r, t, exc);
  const __mmask8 linf = fp8_is_zero_mask(l.z);
  const __mmask8 rinf = fp8_is_zero_mask(r.z);
  exc |= (__mmask8)(linf | rinf);
  Fp8 z1z1, z2z2, a, b, z1c, z2c;
  fp8_sqr(z1z1, l.z);
  fp8_sqr(z2z2, r.z);
  fp8_montmul(a, l.x, z2z2);
  fp8_montmul(b, r.x, z1z1);
  const __mmask8 xeq = fp8_eq_mask(a, b);
  fp8_montmul(z1c, z1z1, l.z);
  fp8_montmul(z2c, z2z2, r.z);
  fp8_montmul(a, l.y, z2c);
  fp8_montmul(b, r.y, z1c);
  const __mmask8 yeq = fp8_eq_mask(a, b);
  return xeq & yeq;
}

// Batched subgroup membership for n points; mirrors g2_in_subgroup
static void g2_in_subgroup_batch(bool* ok, const G2* pts, size_t n) {
  if (!FP8_READY || G2_SUB_STATE != 1) {
    for (size_t i = 0; i < n; i++) ok[i] = g2_in_subgroup(pts[i]);
    return;
  }
  for (size_t base = 0; base < n; base += 8) {
    int c = (int)(n - base < 8 ? n - base : 8);
    G2x8 pv;
    g2x8_load(pv, pts + base, c);
    __mmask8 exc = 0;
    const __mmask8 in_sub = g2x8_in_subgroup_mask(pv, exc);
    for (int k = 0; k < c; k++) {
      if ((exc >> k) & 1) ok[base + k] = g2_in_subgroup(pts[base + k]);
      else ok[base + k] = (in_sub >> k) & 1;
    }
  }
}

// Batched G1 subgroup membership; mirrors g1_in_subgroup
static void g1_in_subgroup_batch(bool* ok, const G1* pts, size_t n) {
  if (!FP8_READY || G1_SUB_STATE != 1) {
    for (size_t i = 0; i < n; i++) ok[i] = g1_in_subgroup(pts[i]);
    return;
  }
  for (size_t base = 0; base < n; base += 8) {
    int c = (int)(n - base < 8 ? n - base : 8);
    G1x8 pv;
    g1x8_load(pv, pts + base, c);
    __mmask8 exc = 0;
    const __mmask8 in_sub = g1x8_in_subgroup_mask(pv, exc);
    for (int k = 0; k < c; k++) {
      if ((exc >> k) & 1) ok[base + k] = g1_in_subgroup(pts[base + k]);
      else ok[base + k] = (in_sub >> k) & 1;
    }
  }
}

// Eight-lane sum of n (>= 8) G1 points (the aggregate_public_keys tail)
EC_FP8_TARGET static void g1_sum_pts_x8(G1& out, const G1* pts, size_t n) {
  G1x8 accv;
  g1x8_load(accv, pts, 8);
  size_t i = 8;
  for (; i + 8 <= n; i += 8) {
    G1x8 inc;
    g1x8_load(inc, pts + i, 8);
    const G1x8 saved = accv;
    __mmask8 exc = 0;
    g1x8_add(accv, accv, inc, exc);
    if (exc) {
      G1 sv[8], nw[8];
      g1x8_store(sv, saved, 8);
      g1x8_store(nw, accv, 8);
      for (int g = 0; g < 8; g++)
        if ((exc >> g) & 1) pt_add(nw[g], sv[g], pts[i + g]);
      g1x8_load(accv, nw, 8);
    }
  }
  G1 fin[8];
  g1x8_store(fin, accv, 8);
  G1 acc = pt_infinity<FpOps>();
  for (int g = 0; g < 8; g++) pt_add(acc, acc, fin[g]);
  for (; i < n; i++) pt_add(acc, acc, pts[i]);
  out = acc;
}

#else  // !EC_FP8_COMPILED

static void g2_clear_cofactor_batch(G2* out, const G2* in, size_t n) {
  for (size_t i = 0; i < n; i++) g2_clear_cofactor(out[i], in[i]);
}
static void g2_in_subgroup_batch(bool* ok, const G2* pts, size_t n) {
  for (size_t i = 0; i < n; i++) ok[i] = g2_in_subgroup(pts[i]);
}
static void g1_in_subgroup_batch(bool* ok, const G1* pts, size_t n) {
  for (size_t i = 0; i < n; i++) ok[i] = g1_in_subgroup(pts[i]);
}
static void g1_mul128_batch(G1* out, const G1* pts, const u64 (*r)[2],
                            size_t n) {
  for (size_t i = 0; i < n; i++) {
    u64 sc[2] = {r[i][0], r[i][1]};
    pt_mul(out[i], pts[i], sc, 2);
  }
}

#endif  // EC_FP8_COMPILED

// Dispatch for the eight-wide Miller loop: worth the SoA conversion once
// enough pairs amortize the vector squaring chain. Measured crossover on
// the build machine: scalar wins at 2-3 pairs (1.8ms vs ~1.9ms), the
// lanes win from ~4 up (15 pairs: 7.0ms scalar vs ~2.5ms); single
// verifies (2 pairs) stay scalar.
static bool multi_miller_loop_x8_try(Fp12& f, MillerPair* pairs, size_t m) {
#ifdef EC_FP8_COMPILED
  if (FP8_READY && m >= 4) {
    multi_miller_loop_x8_impl(f, pairs, m);
    return true;
  }
#endif
  (void)f;
  (void)pairs;
  (void)m;
  return false;
}

// ---------------------------------------------------------------------------
// Batched hash-to-G2 / G2 decompression: the same algorithms as their
// scalar twins above, with the Fp2 sqrt chains routed through the
// eight-wide IFMA engine (fp2_sqrt_x8) and the scalar inversions through
// Montgomery batch inversion. Outputs are bit-identical to the scalar
// routines — SSWU canonicalizes the root's sign via sgn0 and
// decompression via the lex-largest flag, so WHICH square root the
// engine returns cannot matter — and fp2_sqrt_x8 verifies each root
// per-lane with scalar recomputation as the net.
// ---------------------------------------------------------------------------

// SSWU over n independent u values (n <= 32): scalar prologue with one
// batched inversion, batched gx1 sqrt chains, then a batched gx2 retry
// for lanes whose gx1 was a non-square (mirrors map_to_curve_sswu)
static void map_to_curve_sswu_batch(Fp2* xs, Fp2* ys, const Fp2* us, int n) {
  Fp2 zu2[32], x1[32], gx1[32], tv[32], y1[32];
  bool tv_zero[32];
  for (int i = 0; i < n; i++) {
    Fp2 u2;
    fp2_sqr(u2, us[i]);
    fp2_mul(zu2[i], SSWU_Z, u2);
    fp2_sqr(tv[i], zu2[i]);
    fp2_add(tv[i], tv[i], zu2[i]);
    tv_zero[i] = fp2_is_zero(tv[i]);
    if (tv_zero[i]) tv[i] = FP2_ONE;  // placeholder; lane uses B_OVER_ZA
  }
  fp2_inv_batch(tv, n);
  for (int i = 0; i < n; i++) {
    Fp2 t, x3, ax;
    if (tv_zero[i]) {
      x1[i] = SSWU_B_OVER_ZA;
    } else {
      fp2_add(t, FP2_ONE, tv[i]);
      fp2_mul(x1[i], SSWU_NEG_B_OVER_A, t);
    }
    fp2_sqr(t, x1[i]);
    fp2_mul(x3, t, x1[i]);
    fp2_mul(ax, SSWU_A, x1[i]);
    fp2_add(gx1[i], x3, ax);
    fp2_add(gx1[i], gx1[i], SSWU_B);
  }
  u32 ok = 0;
  for (int base = 0; base < n; base += 8) {
    int c = n - base < 8 ? n - base : 8;
    const Fp2* ptrs[8];
    for (int k = 0; k < c; k++) ptrs[k] = &gx1[base + k];
    ok |= fp2_sqrt_x8(y1 + base, ptrs, c) << base;
  }
  int fidx[32], nf = 0;
  Fp2 gx2[32], y2o[32];
  for (int i = 0; i < n; i++) {
    if ((ok >> i) & 1) {
      xs[i] = x1[i];
      ys[i] = y1[i];
      continue;
    }
    Fp2 x2, t, x3, ax;
    fp2_mul(x2, zu2[i], x1[i]);
    xs[i] = x2;
    fp2_sqr(t, x2);
    fp2_mul(x3, t, x2);
    fp2_mul(ax, SSWU_A, x2);
    fp2_add(gx2[nf], x3, ax);
    fp2_add(gx2[nf], gx2[nf], SSWU_B);
    fidx[nf++] = i;
  }
  for (int base = 0; base < nf; base += 8) {
    int c = nf - base < 8 ? nf - base : 8;
    const Fp2* ptrs[8];
    for (int k = 0; k < c; k++) ptrs[k] = &gx2[base + k];
    fp2_sqrt_x8(y2o + base, ptrs, c);  // must succeed when gx1 is not square
  }
  for (int k = 0; k < nf; k++) ys[fidx[k]] = y2o[k];
  for (int i = 0; i < n; i++)
    if (fp2_sgn0(ys[i]) != fp2_sgn0(us[i])) fp2_neg(ys[i], ys[i]);
}

// hash-to-G2 over n messages: expand_message_xmd stays scalar (SHA-256
// bound), SSWU sqrts batch eight-wide, the isogeny denominators share
// one inversion per chunk, cofactor clearing stays scalar point math
static bool hash_to_g2_batch(G2* out, const u8* msgs, const u32* msg_lens,
                             size_t n, const u8* dst, size_t dst_len) {
  const int CH = 16;  // messages per chunk -> 32 SSWU jobs
  size_t off = 0;
  for (size_t base = 0; base < n; base += CH) {
    int c = (int)(n - base < (size_t)CH ? n - base : CH);
    Fp2 us[32], xs[32], ys[32];
    for (int k = 0; k < c; k++) {
      u8 uniform[256];
      if (!expand_message_xmd(uniform, 256, msgs + off, msg_lens[base + k],
                              dst, dst_len))
        return false;
      off += msg_lens[base + k];
      fp_from_64_bytes(us[2 * k].c0, uniform);
      fp_from_64_bytes(us[2 * k].c1, uniform + 64);
      fp_from_64_bytes(us[2 * k + 1].c0, uniform + 128);
      fp_from_64_bytes(us[2 * k + 1].c1, uniform + 192);
    }
    map_to_curve_sswu_batch(xs, ys, us, 2 * c);
    // isogeny with batched denominator inversion (2 per SSWU output)
    Fp2 xn[32], yn[32], den[64];
    bool inf[32];
    for (int j = 0; j < 2 * c; j++) {
      Fp2 xd, yd;
      horner_fp2(xn[j], ISO_XN, 4, xs[j]);
      horner_fp2(xd, ISO_XD, 3, xs[j]);
      horner_fp2(yn[j], ISO_YN, 4, xs[j]);
      horner_fp2(yd, ISO_YD, 4, xs[j]);
      inf[j] = fp2_is_zero(xd) || fp2_is_zero(yd);
      den[2 * j] = inf[j] ? FP2_ONE : xd;
      den[2 * j + 1] = inf[j] ? FP2_ONE : yd;
    }
    fp2_inv_batch(den, 2 * c * 2);
    G2 sums[16];
    for (int k = 0; k < c; k++) {
      G2 q[2];
      for (int h = 0; h < 2; h++) {
        int j = 2 * k + h;
        if (inf[j]) {
          q[h] = pt_infinity<Fp2Ops>();
          continue;
        }
        Fp2 xo, yo, t;
        fp2_mul(xo, xn[j], den[2 * j]);
        fp2_mul(t, yn[j], den[2 * j + 1]);
        fp2_mul(yo, ys[j], t);
        q[h] = pt_from_affine<Fp2Ops>(xo, yo);
      }
      pt_add(sums[k], q[0], q[1]);
    }
    g2_clear_cofactor_batch(out + base, sums, c);
  }
  return true;
}

static void g1_in_subgroup_batch(bool* ok, const G1* pts, size_t n);

// n compressed G1 points with the sqrt chains batched eight-wide and the
// subgroup criterion eight-wide; per-point rc mirrors g1_decompress
// exactly. Serves pubkey-cache bulk fills and aggregate_public_keys.
static void g1_decompress_batch(G1* out, int* rcs, const u8* pks, size_t n,
                                bool check_subgroup) {
  Fp* xs = new Fp[n];
  Fp* y2s = new Fp[n];
  u8* sign_flags = new u8[n];
  for (size_t i = 0; i < n; i++) {
    const u8* in = pks + 48 * i;
    u8 flags = in[0];
    sign_flags[i] = flags & FLAG_SIGN;
    if (!(flags & FLAG_COMPRESSED)) {
      rcs[i] = DEC_NOT_COMPRESSED;
      continue;
    }
    if (flags & FLAG_INFINITY) {
      rcs[i] = DEC_BAD_INFINITY;
      if (!(flags & ~(FLAG_COMPRESSED | FLAG_INFINITY))) {
        bool zero = true;
        for (int b = 1; b < 48; b++)
          if (in[b]) { zero = false; break; }
        if (zero) {
          out[i] = pt_infinity<FpOps>();
          rcs[i] = DEC_OK;
        }
      }
      continue;
    }
    u8 buf[48];
    memcpy(buf, in, 48);
    buf[0] = flags & 0x1F;
    if (!fp_from_bytes(xs[i], buf)) {
      rcs[i] = DEC_NOT_IN_FIELD;
      continue;
    }
    Fp t;
    fp_sqr(t, xs[i]);
    fp_mul(y2s[i], t, xs[i]);
    fp_add(y2s[i], y2s[i], G1_B);
    rcs[i] = -1;  // sqrt pending
  }
  {
    int pend[8], m = 0;
    const Fp* ptrs[8];
    Fp roots[8];
    for (size_t k = 0; k <= n; k++) {
      if (k < n && rcs[k] == -1) pend[m++] = (int)k;
      if ((m == 8 || k == n) && m > 0) {
        for (int j = 0; j < m; j++) ptrs[j] = &y2s[pend[j]];
        u32 ok = fp_sqrt_x8(roots, ptrs, m);
        for (int j = 0; j < m; j++) {
          size_t idx = pend[j];
          if (!((ok >> j) & 1)) {
            rcs[idx] = DEC_NOT_ON_CURVE;
            continue;
          }
          Fp y = roots[j];
          if (fp_is_lex_largest(y) != !!sign_flags[idx]) fp_neg(y, y);
          out[idx] = pt_from_affine<FpOps>(xs[idx], y);
          rcs[idx] = DEC_OK;
        }
        m = 0;
      }
    }
  }
  if (check_subgroup) {
    G1 good[8];
    bool sub_ok[8];
    size_t gidx[8];
    int g = 0;
    for (size_t k = 0; k <= n; k++) {
      if (k < n && rcs[k] == DEC_OK && !out[k].is_inf()) {
        good[g] = out[k];
        gidx[g++] = k;
      }
      if ((g == 8 || k == n) && g > 0) {
        g1_in_subgroup_batch(sub_ok, good, g);
        for (int j = 0; j < g; j++)
          if (!sub_ok[j]) rcs[gidx[j]] = DEC_NOT_IN_SUBGROUP;
        g = 0;
      }
    }
  }
  delete[] xs;
  delete[] y2s;
  delete[] sign_flags;
}

// n compressed G2 points with the sqrt chains batched; per-point rc
// mirrors g2_decompress exactly (same codes, same order of checks)
static void g2_decompress_batch(G2* out, int* rcs, const u8* sigs, size_t n,
                                bool check_subgroup) {
  Fp2* xs = new Fp2[n];
  Fp2* y2s = new Fp2[n];
  u8* sign_flags = new u8[n];
  for (size_t i = 0; i < n; i++) {
    const u8* in = sigs + 96 * i;
    u8 flags = in[0];
    sign_flags[i] = flags & FLAG_SIGN;
    rcs[i] = DEC_OK;
    if (!(flags & FLAG_COMPRESSED)) {
      rcs[i] = DEC_NOT_COMPRESSED;
      continue;
    }
    if (flags & FLAG_INFINITY) {
      rcs[i] = DEC_BAD_INFINITY;
      if (!(flags & ~(FLAG_COMPRESSED | FLAG_INFINITY))) {
        bool zero = true;
        for (int b = 1; b < 96; b++)
          if (in[b]) { zero = false; break; }
        if (zero) {
          out[i] = pt_infinity<Fp2Ops>();
          rcs[i] = DEC_OK;
          continue;
        }
      }
      continue;
    }
    u8 buf[48];
    memcpy(buf, in, 48);
    buf[0] = flags & 0x1F;
    if (!fp_from_bytes(xs[i].c1, buf) || !fp_from_bytes(xs[i].c0, in + 48)) {
      rcs[i] = DEC_NOT_IN_FIELD;
      continue;
    }
    Fp2 t;
    fp2_sqr(t, xs[i]);
    fp2_mul(y2s[i], t, xs[i]);
    fp2_add(y2s[i], y2s[i], G2_B);
    rcs[i] = -1;  // marks "sqrt pending"
  }
  int pend[8];
  const Fp2* ptrs[8];
  Fp2 roots[8];
  {
    int m = 0;
    for (size_t k = 0; k <= n; k++) {
      if (k < n && rcs[k] == -1) pend[m++] = (int)k;
      if ((m == 8 || k == n) && m > 0) {
        for (int j = 0; j < m; j++) ptrs[j] = &y2s[pend[j]];
        u32 ok = fp2_sqrt_x8(roots, ptrs, m);
        for (int j = 0; j < m; j++) {
          size_t idx = pend[j];
          if (!((ok >> j) & 1)) {
            rcs[idx] = DEC_NOT_ON_CURVE;
            continue;
          }
          Fp2 y = roots[j];
          if (fp2_is_lex_largest(y) != !!sign_flags[idx]) fp2_neg(y, y);
          out[idx] = pt_from_affine<Fp2Ops>(xs[idx], y);
          rcs[idx] = DEC_OK;
        }
        m = 0;
      }
    }
  }
  if (check_subgroup) {
    // eight-wide psi criterion over the successfully decoded finite points
    G2 good[8];
    bool sub_ok[8];
    size_t gidx[8];
    int g = 0;
    for (size_t k = 0; k <= n; k++) {
      if (k < n && rcs[k] == DEC_OK && !out[k].is_inf()) {
        good[g] = out[k];
        gidx[g++] = k;
      }
      if ((g == 8 || k == n) && g > 0) {
        g2_in_subgroup_batch(sub_ok, good, g);
        for (int j = 0; j < g; j++)
          if (!sub_ok[j]) rcs[gidx[j]] = DEC_NOT_IN_SUBGROUP;
        g = 0;
      }
    }
  }
  delete[] xs;
  delete[] y2s;
  delete[] sign_flags;
}

// ---------------------------------------------------------------------------
// Pippenger multi-scalar multiplication
// ---------------------------------------------------------------------------

static void scalar_from_be32(u64 out[4], const u8 in[32]) {
  for (int i = 0; i < 4; i++) {
    u64 w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | in[i * 8 + j];
    out[3 - i] = w;
  }
}

static inline int scalar_window(const u64* limbs, int nlimbs, int bit, int c) {
  // c-bit digit starting at `bit` (LSB order), c <= 16
  int limb = bit >> 6, off = bit & 63;
  if (limb >= nlimbs) return 0;
  u64 v = limbs[limb] >> off;
  if (off + c > 64 && limb + 1 < nlimbs) v |= limbs[limb + 1] << (64 - off);
  return (int)(v & (((u64)1 << c) - 1));
}

static inline int msm_window_bits(size_t n) {
  return n < 4 ? 2 : n < 32 ? 4 : n < 256 ? 6 : n < 4096 ? 8 : 10;
}

template <class Ops>
static void pt_msm(Point<Ops>& out, const Point<Ops>* pts, const u64* scalars,
                   size_t n, int scalar_bits) {
  if (n == 0) { out = pt_infinity<Ops>(); return; }
  int c = msm_window_bits(n);
  int nbuckets = (1 << c) - 1;
  Point<Ops>* buckets = new Point<Ops>[nbuckets];
  Point<Ops> result = pt_infinity<Ops>();
  int windows = (scalar_bits + c - 1) / c;
  const typename Ops::F one = Ops::one();
  for (int win = windows - 1; win >= 0; win--) {
    for (int i = 0; i < c; i++) pt_double(result, result);
    for (int b = 0; b < nbuckets; b++) buckets[b] = pt_infinity<Ops>();
    for (size_t k = 0; k < n; k++) {
      int d = scalar_window(scalars + 4 * k, 4, win * c, c);
      if (!d) continue;
      // mixed add for affine inputs (z = 1, the raw-bytes common case)
      if (Ops::eq(pts[k].z, one)) {
        pt_add_affine(buckets[d - 1], buckets[d - 1], pts[k].x, pts[k].y);
      } else {
        pt_add(buckets[d - 1], buckets[d - 1], pts[k]);
      }
    }
    Point<Ops> running = pt_infinity<Ops>(), acc = pt_infinity<Ops>();
    for (int b = nbuckets - 1; b >= 0; b--) {
      pt_add(running, running, buckets[b]);
      pt_add(acc, acc, running);
    }
    pt_add(result, result, acc);
  }
  delete[] buckets;
  out = result;
}

// Batch-affine Pippenger: buckets live in AFFINE coordinates and each
// round's bucket additions share ONE field inversion (Montgomery's
// trick), so an accumulation add costs ~6M instead of the Jacobian
// mixed add's 11M+5S. Collisions (two adds into the same bucket in one
// round) defer to the next round; once a round's batch gets too small
// Scratch for the signed-digit batch-affine bucket pass; sized once per
// MSM (nbuckets buckets, up to `cap` entries).
template <class Ops>
struct MsmScratch {
  typedef typename Ops::F F;
  int nbuckets;
  u32 *cnt, *off, *pos, *sz;
  char* jstate;
  Point<Ops>* jshadow;
  F *ix, *iy;          // item values, grouped by bucket
  u32 *sel_p, *sel_q, *sel_tgt;
  char* sel_dbl;
  F *denom, *prefix, *rx, *ry;
  MsmScratch(int nb, size_t cap) : nbuckets(nb) {
    cnt = new u32[nb + 1]; off = new u32[nb + 1];
    pos = new u32[nb]; sz = new u32[nb];
    jstate = new char[nb];
    jshadow = new Point<Ops>[nb];
    ix = new F[cap]; iy = new F[cap];
    sel_p = new u32[cap / 2 + 1]; sel_q = new u32[cap / 2 + 1];
    sel_tgt = new u32[cap / 2 + 1];
    sel_dbl = new char[cap / 2 + 1];
    denom = new F[cap / 2 + 1]; prefix = new F[cap / 2 + 2];
    rx = new F[cap / 2 + 1]; ry = new F[cap / 2 + 1];
  }
  ~MsmScratch() {
    delete[] cnt; delete[] off; delete[] pos; delete[] sz;
    delete[] jstate; delete[] jshadow;
    delete[] ix; delete[] iy;
    delete[] sel_p; delete[] sel_q; delete[] sel_tgt; delete[] sel_dbl;
    delete[] denom; delete[] prefix; delete[] rx; delete[] ry;
  }
};

// One signed-digit bucket pass over `ne` entries: entry t contributes
// point e_k[t] (negated when e_d[t] < 0) to bucket |e_d[t]|-1. Items
// group by bucket (counting sort), then a PAIRING TREE folds each
// bucket: every round pairs its items two by two — all pairs are
// independent affine additions sharing ONE inversion (Montgomery's
// trick) — so a bucket of depth m collapses in log2(m) rounds
// regardless of multiplicity (the fix for fixed-base passes where every
// bucket holds dozens of entries). Doubling and annihilation pairs are
// classified exactly; once a round is too small to amortize the shared
// inversion, the leftovers fold through Jacobian shadows. Returns
// acc = sum_b (b+1) * bucket_b.
template <class Ops>
static void msm_bucket_pass(Point<Ops>& acc_out, const typename Ops::F* xs,
                            const typename Ops::F* ys,
                            const typename Ops::F* nys, const u32* e_k,
                            const int16_t* e_d, size_t ne,
                            MsmScratch<Ops>& S) {
  typedef typename Ops::F F;
  const size_t BATCH_MIN = 16;
  const int nbuckets = S.nbuckets;
  // group items by bucket
  std::memset(S.cnt, 0, sizeof(u32) * (nbuckets + 1));
  for (size_t t = 0; t < ne; t++) {
    int d = e_d[t];
    S.cnt[(d < 0 ? -d : d) - 1 + 1]++;
  }
  S.off[0] = 0;
  for (int b = 0; b < nbuckets; b++) S.off[b + 1] = S.off[b] + S.cnt[b + 1];
  std::memcpy(S.pos, S.off, sizeof(u32) * nbuckets);
  for (size_t t = 0; t < ne; t++) {
    int d = e_d[t];
    char s = d < 0;
    int b = (s ? -d : d) - 1;
    u32 slot = S.pos[b]++;
    S.ix[slot] = xs[e_k[t]];
    S.iy[slot] = (s ? nys : ys)[e_k[t]];
  }
  for (int b = 0; b < nbuckets; b++) {
    S.sz[b] = S.off[b + 1] - S.off[b];
    S.jstate[b] = 0;
  }
  // pairing-tree rounds
  for (;;) {
    // phase 1 — selection only (no item mutation, so a too-small round
    // can abort cleanly): pairs, per-bucket survivor moves, new sizes
    size_t m = 0;
    for (int b = 0; b < nbuckets; b++) {
      u32 s = S.sz[b];
      if (s < 2) continue;
      u32 base = S.off[b];
      u32 w = 0;
      u32 i = 0;
      for (; i + 1 < s; i += 2) {
        u32 p = base + i, q = base + i + 1;
        if (Ops::eq(S.ix[p], S.ix[q])) {
          if (Ops::eq(S.iy[p], S.iy[q])) {
            if (Ops::is_zero(S.iy[p])) continue;         // 2-torsion: 2P = ∞
            S.sel_dbl[m] = 1;
            Ops::add(S.denom[m], S.iy[p], S.iy[p]);      // 2y
          } else {
            continue;                                    // P + (−P) = ∞
          }
        } else {
          S.sel_dbl[m] = 0;
          Ops::sub(S.denom[m], S.ix[q], S.ix[p]);        // x2 − x1
        }
        S.sel_p[m] = p; S.sel_q[m] = q; S.sel_tgt[m] = base + w;
        w++; m++;
      }
      // odd survivor's pending move rides in cnt (srv target = base + w)
      S.cnt[b] = (i < s) ? (w + 1) : w;  // new size if the round commits
      S.pos[b] = (i < s) ? 1 : 0;        // survivor flag
    }
    if (m < BATCH_MIN) {
      // Too few pairs to amortize the shared inversion — including the
      // m == 0 case where every pair ANNIHILATED (a bucket can still
      // hold >= 2 items then; treating its first item as the bucket
      // value would drop the cancellation). Fold every multi-item
      // bucket's UNTOUCHED items through a guarded Jacobian shadow and
      // stop; a round with no pairs and no multi-item buckets folds
      // nothing and just terminates.
      for (int b = 0; b < nbuckets; b++) {
        u32 s = S.sz[b];
        if (s < 2) continue;
        u32 base = S.off[b];
        S.jshadow[b] = pt_infinity<Ops>();
        S.jstate[b] = 1;
        for (u32 i = 0; i < s; i++)
          pt_add_affine(S.jshadow[b], S.jshadow[b], S.ix[base + i],
                        S.iy[base + i]);
        S.sz[b] = 0;
      }
      break;
    }
    // one shared inversion for the whole round
    S.prefix[0] = Ops::one();
    for (size_t t = 0; t < m; t++)
      Ops::mul(S.prefix[t + 1], S.prefix[t], S.denom[t]);
    F invall;
    Ops::inv(invall, S.prefix[m]);
    for (size_t t = m; t-- > 0;) {
      F dinv, lam, t1, x3, y3;
      Ops::mul(dinv, S.prefix[t], invall);
      Ops::mul(invall, invall, S.denom[t]);
      u32 p = S.sel_p[t], q = S.sel_q[t];
      if (S.sel_dbl[t]) {
        Ops::sqr(t1, S.ix[p]);
        F t2;
        Ops::add(t2, t1, t1);
        Ops::add(t1, t2, t1);                            // 3x²
        Ops::mul(lam, t1, dinv);
      } else {
        Ops::sub(t1, S.iy[q], S.iy[p]);                  // y2 − y1
        Ops::mul(lam, t1, dinv);
      }
      Ops::sqr(x3, lam);
      Ops::sub(x3, x3, S.ix[p]);
      Ops::sub(x3, x3, S.ix[q]);
      Ops::sub(t1, S.ix[p], x3);
      Ops::mul(y3, lam, t1);
      Ops::sub(y3, y3, S.iy[p]);
      S.rx[t] = x3;
      S.ry[t] = y3;
    }
    // commit: scatter results, apply survivor moves, update sizes
    // (targets never collide with unread sources: tgt <= p < q within a
    // bucket, and every source was read into rx/ry above)
    for (size_t t = 0; t < m; t++) {
      S.ix[S.sel_tgt[t]] = S.rx[t];
      S.iy[S.sel_tgt[t]] = S.ry[t];
    }
    for (int b = 0; b < nbuckets; b++) {
      u32 s = S.sz[b];
      if (s < 2) continue;
      u32 base = S.off[b];
      u32 w = S.cnt[b];
      if (S.pos[b]) {  // odd survivor: slot s-1 -> compacted tail slot
        S.ix[base + w - 1] = S.ix[base + s - 1];
        S.iy[base + w - 1] = S.iy[base + s - 1];
      }
      S.sz[b] = w;
    }
  }
  // bucket reduction
  Point<Ops> running = pt_infinity<Ops>(), acc = pt_infinity<Ops>();
  for (int b = nbuckets - 1; b >= 0; b--) {
    if (S.sz[b]) pt_add_affine(running, running, S.ix[S.off[b]], S.iy[S.off[b]]);
    if (S.jstate[b]) pt_add(running, running, S.jshadow[b]);
    pt_add(acc, acc, running);
  }
  acc_out = acc;
}

// signed window digits for one scalar: d in (-2^(c-1), 2^(c-1)], one
// spill window absorbing the final carry
static void msm_signed_digits(int16_t* out, const u64* scalar, int c,
                              int windows) {
  const int half = 1 << (c - 1);
  int carry = 0;
  for (int win = 0; win < windows; win++) {
    int v = scalar_window(scalar, 4, win * c, c) + carry;
    if (v > half) {
      out[win] = (int16_t)(v - (1 << c));
      carry = 1;
    } else {
      out[win] = (int16_t)v;
      carry = 0;
    }
  }
}

template <class Ops>
static void pt_msm_batch_affine(Point<Ops>& out, const typename Ops::F* xs,
                                const typename Ops::F* ys,
                                const u64* scalars, size_t n,
                                int scalar_bits) {
  typedef typename Ops::F F;
  if (n == 0) { out = pt_infinity<Ops>(); return; }
  int c = msm_window_bits(n);
  // SIGNED digits: negating an affine point is free (flip y), so half
  // the buckets cover the same window — the bucket reduction (the other
  // half of Pippenger's cost) halves with it.
  int windows = (scalar_bits + c - 1) / c + 1;
  int16_t* digs = new int16_t[n * (size_t)windows];
  for (size_t k = 0; k < n; k++)
    msm_signed_digits(digs + k * windows, scalars + 4 * k, c, windows);
  // negated y per point, picked by digit sign at zero per-use cost
  F* nys = new F[n];
  for (size_t k = 0; k < n; k++) Ops::neg(nys[k], ys[k]);
  u32* e_k = new u32[n];
  int16_t* e_d = new int16_t[n];
  MsmScratch<Ops> S(1 << (c - 1), n);
  Point<Ops> result = pt_infinity<Ops>();
  for (int win = windows - 1; win >= 0; win--) {
    for (int i = 0; i < c; i++) pt_double(result, result);
    size_t ne = 0;
    for (size_t k = 0; k < n; k++) {
      int16_t d = digs[k * windows + win];
      if (d) { e_k[ne] = (u32)k; e_d[ne] = d; ne++; }
    }
    Point<Ops> acc;
    msm_bucket_pass<Ops>(acc, xs, ys, nys, e_k, e_d, ne, S);
    pt_add(result, result, acc);
  }
  delete[] digs; delete[] nys; delete[] e_k; delete[] e_d;
  out = result;
}

// ---------------------------------------------------------------------------
// Fixed-base prepared MSM: when the base points are static (the KZG
// Lagrange setup — kzg.rs wraps c-kzg over the same fixed ceremony),
// precompute each point's window shifts P_k * 2^(c*win) once so every
// later MSM is a SINGLE signed-digit bucket pass: the per-window bucket
// reductions (half of Pippenger's cost) collapse into one, and the
// window count stops constraining the bucket width.
// ---------------------------------------------------------------------------

template <class Ops>
struct MsmPrepared {
  typedef typename Ops::F F;
  size_t n;
  int c, windows;
  F* xs;    // entry (k, win) = point k shifted by 2^(c*win), affine x
  F* ys;
  F* nys;
  char* inf;  // infinity entries contribute nothing and are skipped
  ~MsmPrepared() { delete[] xs; delete[] ys; delete[] nys; delete[] inf; }
};

static inline void msm_inv_batch(Fp* vals, int n) { fp_inv_batch(vals, n); }
static inline void msm_inv_batch(Fp2* vals, int n) { fp2_inv_batch(vals, n); }

template <class Ops>
static MsmPrepared<Ops>* msm_prepare(const Point<Ops>* pts, size_t n, int c) {
  typedef typename Ops::F F;
  const int windows = (256 + c - 1) / c + 1;
  const size_t total = n * (size_t)windows;
  MsmPrepared<Ops>* h = new MsmPrepared<Ops>;
  h->n = n;
  h->c = c;
  h->windows = windows;
  h->xs = new F[total];
  h->ys = new F[total];
  h->nys = new F[total];
  h->inf = new char[total];
  Point<Ops>* jac = new Point<Ops>[total];
  for (size_t k = 0; k < n; k++) {
    Point<Ops> p = pts[k];
    for (int win = 0; win < windows; win++) {
      jac[k * windows + win] = p;
      if (win + 1 < windows)
        for (int i = 0; i < c; i++) pt_double(p, p);
    }
  }
  // batch-normalize to affine: chunks of shared inversions
  const size_t CH = 64;
  F zs[CH];
  for (size_t base = 0; base < total; base += CH) {
    size_t m = total - base < CH ? total - base : CH;
    for (size_t t = 0; t < m; t++) {
      h->inf[base + t] = jac[base + t].is_inf();
      zs[t] = h->inf[base + t] ? Ops::one() : jac[base + t].z;
    }
    // F == Fp or Fp2: route through the matching batch inverter
    msm_inv_batch(zs, (int)m);
    for (size_t t = 0; t < m; t++) {
      if (h->inf[base + t]) {
        h->xs[base + t] = Ops::zero();
        h->ys[base + t] = Ops::zero();
        h->nys[base + t] = Ops::zero();
        continue;
      }
      F zi2, zi3;
      Ops::sqr(zi2, zs[t]);
      Ops::mul(zi3, zi2, zs[t]);
      Ops::mul(h->xs[base + t], jac[base + t].x, zi2);
      Ops::mul(h->ys[base + t], jac[base + t].y, zi3);
      Ops::neg(h->nys[base + t], h->ys[base + t]);
    }
  }
  delete[] jac;
  return h;
}

template <class Ops>
static void msm_prepared_run(Point<Ops>& out, const MsmPrepared<Ops>* h,
                             const u64* scalars) {
  const size_t n = h->n;
  const int c = h->c, windows = h->windows;
  int16_t* digs = new int16_t[(size_t)windows];
  u32* e_k = new u32[n * (size_t)windows];
  int16_t* e_d = new int16_t[n * (size_t)windows];
  size_t ne = 0;
  for (size_t k = 0; k < n; k++) {
    msm_signed_digits(digs, scalars + 4 * k, c, windows);
    for (int win = 0; win < windows; win++) {
      size_t idx = k * (size_t)windows + win;
      if (digs[win] && !h->inf[idx]) {
        e_k[ne] = (u32)idx;
        e_d[ne] = digs[win];
        ne++;
      }
    }
  }
  MsmScratch<Ops> S(1 << (c - 1), ne ? ne : 1);
  msm_bucket_pass<Ops>(out, h->xs, h->ys, h->nys, e_k, e_d, ne, S);
  delete[] digs;
  delete[] e_k;
  delete[] e_d;
}

// ---------------------------------------------------------------------------
// Fr: the scalar field (4x64 Montgomery) — barycentric blob-polynomial
// evaluation and quotient construction, the EIP-4844 math of kzg.py's
// _evaluate_polynomial_in_evaluation_form / _compute_kzg_proof_impl
// (the role c-kzg's C polynomial code plays for crypto/kzg.rs). The
// Python big-int implementation stays as the cross-checked fallback.
// ---------------------------------------------------------------------------

struct Fr { u64 l[4]; };

static u64 FR_NINV;   // -r^{-1} mod 2^64
static Fr FR_R2;      // 2^512 mod r (canonical limbs)
static Fr FR_ONE;     // Montgomery 1
static bool FR_READY = false;

static inline bool fr_is_zero(const Fr& a) {
  return !(a.l[0] | a.l[1] | a.l[2] | a.l[3]);
}
static inline bool fr_eq(const Fr& a, const Fr& b) {
  return a.l[0] == b.l[0] && a.l[1] == b.l[1] && a.l[2] == b.l[2] &&
         a.l[3] == b.l[3];
}
static inline int fr_cmp_raw(const u64* a, const u64* b) {
  for (int i = 3; i >= 0; i--) {
    if (a[i] < b[i]) return -1;
    if (a[i] > b[i]) return 1;
  }
  return 0;
}
static void fr_add(Fr& o, const Fr& a, const Fr& b) {
  u64 carry = 0;
  for (int i = 0; i < 4; i++) o.l[i] = adc(a.l[i], b.l[i], carry);
  if (carry || fr_cmp_raw(o.l, R_RAW) >= 0) {
    u64 borrow = 0;
    for (int i = 0; i < 4; i++) o.l[i] = sbb(o.l[i], R_RAW[i], borrow);
  }
}
static void fr_sub(Fr& o, const Fr& a, const Fr& b) {
  u64 borrow = 0;
  for (int i = 0; i < 4; i++) o.l[i] = sbb(a.l[i], b.l[i], borrow);
  if (borrow) {
    u64 carry = 0;
    for (int i = 0; i < 4; i++) o.l[i] = adc(o.l[i], R_RAW[i], carry);
  }
}
// CIOS Montgomery product, 4x64 (the scalar-field twin of fp_mul)
static void fr_mul(Fr& o, const Fr& a, const Fr& b) {
  u64 t[5] = {0, 0, 0, 0, 0};
  for (int i = 0; i < 4; i++) {
    u64 carry = 0, lo, hi;
    for (int j = 0; j < 4; j++) {
      madd2(a.l[j], b.l[i], t[j], carry, hi, lo);
      t[j] = lo;
      carry = hi;
    }
    u64 t4 = t[4] + carry;
    u64 m = t[0] * FR_NINV;
    madd1(m, R_RAW[0], t[0], hi, lo);
    carry = hi;
    for (int j = 1; j < 4; j++) {
      madd2(m, R_RAW[j], t[j], carry, hi, lo);
      t[j - 1] = lo;
      carry = hi;
    }
    u64 c2 = 0;
    t[3] = adc(t4, carry, c2);
    t[4] = c2;
  }
  for (int i = 0; i < 4; i++) o.l[i] = t[i];
  if (t[4] || fr_cmp_raw(o.l, R_RAW) >= 0) {
    u64 borrow = 0;
    for (int i = 0; i < 4; i++) o.l[i] = sbb(o.l[i], R_RAW[i], borrow);
  }
}
static void fr_to_mont(Fr& o, const Fr& std_form) { fr_mul(o, std_form, FR_R2); }
static void fr_from_mont(Fr& o, const Fr& mont) {
  Fr one_std = {{1, 0, 0, 0}};
  fr_mul(o, mont, one_std);
}
static void fr_pow(Fr& out, const Fr& base, const u64* exp) {
  Fr result = FR_ONE;
  bool started = false;
  for (int bit = 255; bit >= 0; bit--) {
    if (started) fr_mul(result, result, result);
    if ((exp[bit >> 6] >> (bit & 63)) & 1) {
      if (started) fr_mul(result, result, base);
      else { result = base; started = true; }
    }
  }
  out = started ? result : FR_ONE;
}
static void fr_inv(Fr& out, const Fr& a) {
  u64 exp[4];
  u64 borrow = 0;
  exp[0] = sbb(R_RAW[0], 2, borrow);
  for (int i = 1; i < 4; i++) exp[i] = sbb(R_RAW[i], 0, borrow);
  fr_pow(out, a, exp);  // a^(r-2)
}
static void fr_batch_inv(Fr* vals, size_t n) {
  if (n == 0) return;
  Fr* pre = new Fr[n + 1];
  pre[0] = FR_ONE;
  for (size_t i = 0; i < n; i++) fr_mul(pre[i + 1], pre[i], vals[i]);
  Fr inv;
  fr_inv(inv, pre[n]);
  for (size_t i = n; i-- > 0;) {
    Fr v;
    fr_mul(v, inv, pre[i]);
    fr_mul(inv, inv, vals[i]);
    vals[i] = v;
  }
  delete[] pre;
}
static bool fr_from_bytes(Fr& o, const u8 in[32]) {
  Fr s;
  for (int i = 0; i < 4; i++) {
    u64 w = 0;
    for (int j = 0; j < 8; j++) w = (w << 8) | in[i * 8 + j];
    s.l[3 - i] = w;
  }
  if (fr_cmp_raw(s.l, R_RAW) >= 0) return false;
  fr_to_mont(o, s);
  return true;
}
static void fr_to_bytes(u8 out[32], const Fr& mont) {
  Fr s;
  fr_from_mont(s, mont);
  for (int i = 0; i < 4; i++) {
    u64 w = s.l[3 - i];
    for (int j = 7; j >= 0; j--) { out[i * 8 + j] = (u8)w; w >>= 8; }
  }
}
static void fr_ensure_init() {
  if (FR_READY) return;
  u64 inv = 1;
  for (int i = 0; i < 6; i++) inv *= 2 - R_RAW[0] * inv;
  FR_NINV = (u64)0 - inv;
  Fr acc = {{1, 0, 0, 0}};
  for (int i = 0; i < 512; i++) fr_add(acc, acc, acc);
  FR_R2 = acc;
  Fr one_std = {{1, 0, 0, 0}};
  fr_mul(FR_ONE, one_std, FR_R2);
  FR_READY = true;
}

// Barycentric evaluation + (optionally) the quotient polynomial, shared
// scaffolding: p(z) = (z^n - 1)/n * sum_i e_i w_i / (z - w_i), with the
// in-domain short-circuit, and q(X) = (p(X) - y)/(X - z) in evaluation
// form (both branches of _compute_kzg_proof_impl).
static int fr_eval_quotient(const u8* evals32, const u8* roots32, size_t n,
                            const u8* z32, u8* y32, u8* q32 /* or null */) {
  fr_ensure_init();
  if (n == 0 || (n & (n - 1)) != 0) return -2;  // z^n below squares up
  Fr z;
  if (!fr_from_bytes(z, z32)) return -1;
  Fr* evals = new Fr[n];
  Fr* roots = new Fr[n];
  for (size_t i = 0; i < n; i++) {
    if (!fr_from_bytes(evals[i], evals32 + 32 * i) ||
        !fr_from_bytes(roots[i], roots32 + 32 * i)) {
      delete[] evals;
      delete[] roots;
      return -1;
    }
  }
  long m = -1;  // in-domain index
  for (size_t i = 0; i < n; i++)
    if (fr_eq(z, roots[i])) { m = (long)i; break; }
  Fr y;
  Fr* work = new Fr[n];
  if (m >= 0) {
    y = evals[m];
  } else {
    for (size_t i = 0; i < n; i++) fr_sub(work[i], z, roots[i]);
    fr_batch_inv(work, n);  // 1/(z - w_i)
    Fr total = {{0, 0, 0, 0}};
    for (size_t i = 0; i < n; i++) {
      Fr t;
      fr_mul(t, evals[i], roots[i]);
      fr_mul(t, t, work[i]);
      fr_add(total, total, t);
    }
    // zn1 = z^n - 1, n_inv = 1/n
    Fr zn = z;
    size_t nn = n;
    // n is a power of two for every preset; square up
    while (nn > 1) { fr_mul(zn, zn, zn); nn >>= 1; }
    Fr zn1;
    fr_sub(zn1, zn, FR_ONE);
    Fr n_fr = {{0, 0, 0, 0}}, n_std = {{(u64)n, 0, 0, 0}};
    fr_to_mont(n_fr, n_std);
    Fr n_inv;
    fr_inv(n_inv, n_fr);
    fr_mul(y, total, zn1);
    fr_mul(y, y, n_inv);
  }
  fr_to_bytes(y32, y);
  int rc = 0;
  if (q32) {
    if (m >= 0) {
      // z on the domain: the L'Hopital-style special column
      Fr* inv_wz = new Fr[n];
      Fr* inv_zzw = new Fr[n];
      for (size_t i = 0; i < n; i++) {
        if ((long)i == m) { inv_wz[i] = FR_ONE; inv_zzw[i] = FR_ONE; continue; }
        fr_sub(inv_wz[i], roots[i], z);
        Fr t;
        fr_sub(t, z, roots[i]);
        fr_mul(inv_zzw[i], z, t);
      }
      fr_batch_inv(inv_wz, n);
      fr_batch_inv(inv_zzw, n);
      Fr acc = {{0, 0, 0, 0}};
      for (size_t i = 0; i < n; i++) {
        if ((long)i == m) continue;
        Fr d, q;
        fr_sub(d, evals[i], y);
        fr_mul(q, d, inv_wz[i]);
        fr_to_bytes(q32 + 32 * i, q);
        Fr t;
        fr_mul(t, d, roots[i]);
        fr_mul(t, t, inv_zzw[i]);
        fr_add(acc, acc, t);
      }
      fr_to_bytes(q32 + 32 * (size_t)m, acc);
      delete[] inv_wz;
      delete[] inv_zzw;
    } else {
      // work[i] already holds 1/(z - w_i); 1/(w_i - z) = -that
      for (size_t i = 0; i < n; i++) {
        Fr d, neg, q;
        fr_sub(d, evals[i], y);
        Fr zero = {{0, 0, 0, 0}};
        fr_sub(neg, zero, work[i]);
        fr_mul(q, d, neg);
        fr_to_bytes(q32 + 32 * i, q);
      }
    }
  }
  delete[] evals;
  delete[] roots;
  delete[] work;
  return rc;
}

// ---------------------------------------------------------------------------
// raw affine IO (standard-form big-endian coordinates)
// g1 raw: x || y (96 bytes); g2 raw: x.c0 || x.c1 || y.c0 || y.c1 (192)
// ---------------------------------------------------------------------------

static void g1_to_raw(u8 out[96], const G1& p) {
  if (p.is_inf()) { memset(out, 0, 96); return; }
  Fp ax, ay;
  pt_to_affine<FpOps>(ax, ay, p);
  fp_to_bytes(out, ax);
  fp_to_bytes(out + 48, ay);
}

static bool g1_from_raw(G1& out, const u8 in[96], int is_inf) {
  if (is_inf) { out = pt_infinity<FpOps>(); return true; }
  Fp x, y;
  if (!fp_from_bytes(x, in) || !fp_from_bytes(y, in + 48)) return false;
  if (!pt_on_curve_affine<FpOps>(x, y, G1_B)) return false;
  out = pt_from_affine<FpOps>(x, y);
  return true;
}

#ifdef EC_FP8_COMPILED
// Parse eight raw affine G1 points straight into R52-Montgomery lanes
// (skipping the scalar-Montgomery detour g1_from_raw would pay), with
// the on-curve check run eight-wide. Out-of-field or off-curve lanes
// (incl. the all-zero "infinity" encoding, which is not on the curve)
// fail exactly like g1_from_raw.
EC_FP8_TARGET static bool g1x8_load_from_raw(G1x8& o, const u8* pks_raw) {
  u64 tx[8][8], ty[8][8];
  for (int k = 0; k < 8; k++) {
    const u8* in = pks_raw + 96 * k;
    u64 xs[6], ys[6];
    for (int i = 0; i < 6; i++) {
      u64 w = 0, w2 = 0;
      for (int j = 0; j < 8; j++) {
        w = (w << 8) | in[i * 8 + j];
        w2 = (w2 << 8) | in[48 + i * 8 + j];
      }
      xs[5 - i] = w;
      ys[5 - i] = w2;
    }
    if (fp_cmp_raw(xs, P_RAW.l) >= 0 || fp_cmp_raw(ys, P_RAW.l) >= 0)
      return false;
    limbs6_to_52(tx[k], xs);
    limbs6_to_52(ty[k], ys);
  }
  for (int j = 0; j < 8; j++) {
    o.x.l[j] = _mm512_setr_epi64(
        (long long)tx[0][j], (long long)tx[1][j], (long long)tx[2][j],
        (long long)tx[3][j], (long long)tx[4][j], (long long)tx[5][j],
        (long long)tx[6][j], (long long)tx[7][j]);
    o.y.l[j] = _mm512_setr_epi64(
        (long long)ty[0][j], (long long)ty[1][j], (long long)ty[2][j],
        (long long)ty[3][j], (long long)ty[4][j], (long long)ty[5][j],
        (long long)ty[6][j], (long long)ty[7][j]);
  }
  Fp8 r2;
  fp8_bcast(r2, R52SQ_52);
  fp8_montmul(o.x, o.x, r2);
  fp8_montmul(o.y, o.y, r2);
  static const u64 ONEP[8] = {1, 0, 0, 0, 0, 0, 0, 0};
  Fp8 onep;
  fp8_bcast(onep, ONEP);
  fp8_montmul(o.z, r2, onep);  // z = 1 in R52-Montgomery form
  Fp8 y2, x2, x3, b4;
  fp8_sqr(y2, o.y);
  fp8_sqr(x2, o.x);
  fp8_montmul(x3, x2, o.x);
  fp8_load(b4, &G1_B, 1);
  fp8_add(x3, x3, b4);
  return fp8_eq_mask(y2, x3) == 0xFF;
}

// Eight running partial pubkey sums + scalar combine — the
// fast_aggregate_verify aggregation loop (role of blst's pk aggregation
// in crypto/bls.rs:114,135) at SoA throughput. The rare add exception
// (a lane's partial sum equal to its incoming point) is patched with a
// scalar doubling-capable add, so the result always matches the serial
// pt_add chain; bad/infinity keys fail identically.
EC_FP8_TARGET static int g1_sum_raw_x8_impl(G1& out, const u8* pks_raw,
                                            size_t n) {
  G1x8 acc;
  if (!g1x8_load_from_raw(acc, pks_raw)) return 0;
  size_t i = 8;
  for (; i + 8 <= n; i += 8) {
    G1x8 inc;
    if (!g1x8_load_from_raw(inc, pks_raw + 96 * i)) return 0;
    const G1x8 saved = acc;
    __mmask8 exc = 0;
    g1x8_add(acc, acc, inc, exc);
    if (exc) {
      G1 sv[8], nw[8], pk;
      g1x8_store(sv, saved, 8);
      g1x8_store(nw, acc, 8);
      for (int g = 0; g < 8; g++)
        if ((exc >> g) & 1) {
          if (!g1_from_raw(pk, pks_raw + 96 * (i + g), 0) || pk.is_inf())
            return 0;
          pt_add(nw[g], sv[g], pk);
        }
      g1x8_load(acc, nw, 8);
    }
  }
  G1 fin[8];
  g1x8_store(fin, acc, 8);
  G1 total = pt_infinity<FpOps>();
  for (int g = 0; g < 8; g++) pt_add(total, total, fin[g]);
  for (; i < n; i++) {
    G1 pk;
    if (!g1_from_raw(pk, pks_raw + 96 * i, 0) || pk.is_inf()) return 0;
    pt_add(total, total, pk);
  }
  out = total;
  return 1;
}
#endif  // EC_FP8_COMPILED

// Sum n raw affine G1 points; false on any malformed/infinity key
// (mirrors the serial g1_from_raw + pt_add loop bit for bit)
static bool g1_sum_raw(G1& out, const u8* pks_raw, size_t n) {
#ifdef EC_FP8_COMPILED
  if (FP8_READY && n >= 32) return g1_sum_raw_x8_impl(out, pks_raw, n) != 0;
#endif
  G1 acc = pt_infinity<FpOps>();
  for (size_t i = 0; i < n; i++) {
    G1 pk;
    if (!g1_from_raw(pk, pks_raw + 96 * i, 0) || pk.is_inf()) return false;
    pt_add(acc, acc, pk);
  }
  out = acc;
  return true;
}

static void g2_to_raw(u8 out[192], const G2& p) {
  if (p.is_inf()) { memset(out, 0, 192); return; }
  Fp2 ax, ay;
  pt_to_affine<Fp2Ops>(ax, ay, p);
  fp_to_bytes(out, ax.c0);
  fp_to_bytes(out + 48, ax.c1);
  fp_to_bytes(out + 96, ay.c0);
  fp_to_bytes(out + 144, ay.c1);
}

static bool g2_from_raw(G2& out, const u8 in[192], int is_inf) {
  if (is_inf) { out = pt_infinity<Fp2Ops>(); return true; }
  Fp2 x, y;
  if (!fp_from_bytes(x.c0, in) || !fp_from_bytes(x.c1, in + 48) ||
      !fp_from_bytes(y.c0, in + 96) || !fp_from_bytes(y.c1, in + 144))
    return false;
  if (!pt_on_curve_affine<Fp2Ops>(x, y, G2_B)) return false;
  out = pt_from_affine<Fp2Ops>(x, y);
  return true;
}

// ---------------------------------------------------------------------------
// public C API
// error codes: 0 ok / verify-false, 1 verify-true; negative = parse errors
// (-2 not compressed, -3 bad infinity, -4 not in field, -5 not on curve,
//  -6 not in subgroup, -1 other)
// ---------------------------------------------------------------------------

extern "C" {

u64 ec_bls_version() { return 4; }

// 1 when the eight-wide IFMA field engine passed its init self-check and
// is serving the batched sqrt chains; 0 = scalar fallback in use
int ec_fp8_active() {
  ensure_init();
  return FP8_READY ? 1 : 0;
}

// Deep self-test of the IFMA engine against the scalar field: random
// mul/add/sub/sqrt cross-checks. 0 = ok (or engine inactive);
// a nonzero code identifies the first failing family.
int ec_fp8_selftest(u64 seed, int rounds) {
  ensure_init();
  if (!FP8_READY) return 0;
#ifdef EC_FP8_COMPILED
  int rc = fp8_selftest_deep(seed, rounds);
  if (rc) return rc;
  // end-to-end: batched hash-to-G2 == scalar hash-to-G2, message by
  // message (exercises SSWU batching, batched isogeny inversions, and
  // the eight-lane cofactor chain incl. partial final chunks)
  {
    const u8 dst[] = "EC_FP8_SELFTEST_DST_";
    u8 msgs[19 * 8];
    u32 lens[19];
    u64 s = seed ? seed : 0xa076bdf3u;
    for (int i = 0; i < 19 * 8; i++) {
      s ^= s << 13; s ^= s >> 7; s ^= s << 17;
      msgs[i] = (u8)s;
    }
    for (int i = 0; i < 19; i++) lens[i] = 8;
    G2 got[19], want;
    if (!hash_to_g2_batch(got, msgs, lens, 19, dst, sizeof(dst) - 1))
      return 7;
    for (int i = 0; i < 19; i++) {
      if (!hash_to_g2_point(want, msgs + 8 * i, 8, dst, sizeof(dst) - 1))
        return 7;
      if (!pt_eq_jacobian(got[i], want)) return 8;
    }
    // batched decompression (+ subgroup) == scalar decompression,
    // including corrupted encodings and the infinity encoding
    u8 enc[19 * 96];
    for (int i = 0; i < 19; i++) g2_compress(enc + 96 * i, got[i]);
    enc[96 * 3 + 17] ^= 0x40;               // corrupt one coordinate
    memset(enc + 96 * 5, 0, 96);            // infinity encoding
    enc[96 * 5] = 0xC0;
    enc[96 * 7] = (u8)(enc[96 * 7] ^ 0x20); // flip the sign flag (still valid)
    G2 dec[19];
    int rcs[19];
    g2_decompress_batch(dec, rcs, enc, 19, true);
    for (int i = 0; i < 19; i++) {
      G2 one;
      int want_rc = g2_decompress(one, enc + 96 * i, true);
      if (rcs[i] != want_rc) return 9;
      if (want_rc == DEC_OK && !pt_eq_jacobian(dec[i], one)) return 10;
    }
    // batched 128-bit G1 scalar mults == scalar pt_mul (odd count, so
    // the padded-lane path is exercised too)
    G1 pts[11], got1[11], want1;
    u64 rs[11][2];
    for (int i = 0; i < 11; i++) {
      u64 k[2] = {0, 0};
      s ^= s << 13; s ^= s >> 7; s ^= s << 17; k[0] = s | 1;
      s ^= s << 13; s ^= s >> 7; s ^= s << 17; k[1] = s;
      pt_mul(pts[i], G1_GEN, k, 2);
      s ^= s << 13; s ^= s >> 7; s ^= s << 17; rs[i][0] = s | 1;
      s ^= s << 13; s ^= s >> 7; s ^= s << 17; rs[i][1] = s;
    }
    g1_mul128_batch(got1, pts, rs, 11);
    for (int i = 0; i < 11; i++) {
      u64 sc[2] = {rs[i][0], rs[i][1]};
      pt_mul(want1, pts[i], sc, 2);
      if (!pt_eq_jacobian(got1[i], want1)) return 11;
    }
    // batched G1 decompression (+ subgroup) == scalar, incl. corruption,
    // the infinity encoding, and an off-subgroup point
    {
      u8 enc1[11 * 48];
      for (int i = 0; i < 11; i++) g1_compress(enc1 + 48 * i, pts[i]);
      enc1[48 * 2 + 9] ^= 0x10;
      memset(enc1 + 48 * 4, 0, 48);
      enc1[48 * 4] = 0xC0;  // infinity
      G1 dec[11];
      int rcs1[11];
      g1_decompress_batch(dec, rcs1, enc1, 11, true);
      for (int i = 0; i < 11; i++) {
        G1 one;
        int want_rc = g1_decompress(one, enc1 + 48 * i, true);
        if (rcs1[i] != want_rc) return 15;
        if (want_rc == DEC_OK && !pt_eq_jacobian(dec[i], one)) return 16;
      }
    }
    // eight-wide Miller loop == scalar Miller loop, bit for bit, on a
    // ragged pair count (19 pairs -> 3 slots, last slot 3 lanes active)
    MillerPair mp[19], mp2[19];
    for (int i = 0; i < 19; i++) {
      u64 k[2];
      s ^= s << 13; s ^= s >> 7; s ^= s << 17; k[0] = s | 1;
      s ^= s << 13; s ^= s >> 7; s ^= s << 17; k[1] = s >> 1;
      G1 gp;
      pt_mul(gp, G1_GEN, k, 2);
      s ^= s << 13; s ^= s >> 7; s ^= s << 17; k[0] = s | 1;
      s ^= s << 13; s ^= s >> 7; s ^= s << 17; k[1] = s >> 1;
      G2 gq;
      pt_mul(gq, G2_GEN, k, 2);
      pt_to_affine<FpOps>(mp[i].xp, mp[i].yp, gp);
      pt_to_affine<Fp2Ops>(mp[i].xq, mp[i].yq, gq);
      mp2[i] = mp[i];
    }
    Fp12 fx8, fsc;
    if (!multi_miller_loop_x8_try(fx8, mp, 19)) return 0;  // engine off: done
    multi_miller_loop(fsc, mp2, 19);
    if (!fp12_eq(fx8, fsc)) return 12;
    // eight-lane pubkey aggregation == serial chain, on a duplicate-heavy
    // ragged list (41 points from 5 distinct values forces repeated adds)
    u8 raws[41 * 96];
    for (int i = 0; i < 41; i++) {
      u64 k[2];
      k[0] = (u64)(i % 5) + 2;
      k[1] = 0;
      G1 gp;
      pt_mul(gp, G1_GEN, k, 2);
      g1_to_raw(raws + 96 * i, gp);
    }
    G1 batch_sum, serial_sum = pt_infinity<FpOps>();
    if (!g1_sum_raw(batch_sum, raws, 41)) return 13;
    for (int i = 0; i < 41; i++) {
      G1 pk;
      if (!g1_from_raw(pk, raws + 96 * i, 0)) return 13;
      pt_add(serial_sum, serial_sum, pk);
    }
    if (!pt_eq_jacobian(batch_sum, serial_sum)) return 14;
  }
  return 0;
#else
  return 0;
#endif
}

int ec_g1_decompress(const u8* in, u8* out_raw, int* is_inf, int check_subgroup) {
  ensure_init();
  G1 p;
  int rc = g1_decompress(p, in, check_subgroup != 0);
  if (rc != DEC_OK) return -rc;
  *is_inf = p.is_inf() ? 1 : 0;
  g1_to_raw(out_raw, p);
  return 0;
}

int ec_g2_decompress(const u8* in, u8* out_raw, int* is_inf, int check_subgroup) {
  ensure_init();
  G2 p;
  int rc = g2_decompress(p, in, check_subgroup != 0);
  if (rc != DEC_OK) return -rc;
  *is_inf = p.is_inf() ? 1 : 0;
  g2_to_raw(out_raw, p);
  return 0;
}

int ec_g1_compress_raw(const u8* raw, int is_inf, u8* out) {
  ensure_init();
  G1 p;
  if (!g1_from_raw(p, raw, is_inf)) return -5;
  g1_compress(out, p);
  return 0;
}

int ec_g2_compress_raw(const u8* raw, int is_inf, u8* out) {
  ensure_init();
  G2 p;
  if (!g2_from_raw(p, raw, is_inf)) return -5;
  g2_compress(out, p);
  return 0;
}

int ec_g1_generator_raw(u8* out) { ensure_init(); g1_to_raw(out, G1_GEN); return 0; }
int ec_g2_generator_raw(u8* out) { ensure_init(); g2_to_raw(out, G2_GEN); return 0; }

// scalar must be 32-byte BE, 0 < scalar < r enforced by caller
int ec_bls_sk_to_pk(const u8* sk, u8* out) {
  ensure_init();
  u64 s[4];
  scalar_from_be32(s, sk);
  G1 p;
  pt_mul(p, G1_GEN, s, 4);
  g1_compress(out, p);
  return 0;
}

int ec_bls_hash_to_g2(const u8* msg, size_t msg_len, const u8* dst,
                      size_t dst_len, u8* out96) {
  ensure_init();
  G2 h;
  if (!hash_to_g2_point(h, msg, msg_len, dst, dst_len)) return -1;
  g2_compress(out96, h);
  return 0;
}

int ec_bls_sign(const u8* sk, const u8* msg, size_t msg_len, const u8* dst,
                size_t dst_len, u8* out96) {
  ensure_init();
  u64 s[4];
  scalar_from_be32(s, sk);
  G2 h, sig;
  if (!hash_to_g2_point(h, msg, msg_len, dst, dst_len)) return -1;
  pt_mul(sig, h, s, 4);
  g2_compress(out96, sig);
  return 0;
}

int ec_bls_verify(const u8* pk48, const u8* msg, size_t msg_len, const u8* dst,
                  size_t dst_len, const u8* sig96, int assume_valid) {
  ensure_init();
  G1 pk;
  int rc = g1_decompress(pk, pk48, assume_valid == 0);
  if (rc != DEC_OK) return -rc;
  G2 sig;
  rc = g2_decompress(sig, sig96, assume_valid == 0);
  if (rc != DEC_OK) return -rc;
  if (pk.is_inf() || sig.is_inf()) return 0;
  G2 h;
  if (!hash_to_g2_point(h, msg, msg_len, dst, dst_len)) return -1;
  G1 neg_gen;
  pt_neg(neg_gen, G1_GEN);
  G1 ps[2] = {pk, neg_gen};
  G2 qs[2] = {h, sig};
  return pairing_product_is_one(ps, qs, 2) ? 1 : 0;
}

int ec_bls_fast_aggregate_verify(const u8* pks, size_t n, const u8* msg,
                                 size_t msg_len, const u8* dst, size_t dst_len,
                                 const u8* sig96, int assume_valid) {
  ensure_init();
  if (n == 0) return 0;
  G1 acc = pt_infinity<FpOps>();
  for (size_t i = 0; i < n; i++) {
    G1 pk;
    int rc = g1_decompress(pk, pks + 48 * i, assume_valid == 0);
    if (rc != DEC_OK) return -rc;
    if (pk.is_inf()) return 0;  // PublicKey semantics: identity is invalid
    pt_add(acc, acc, pk);
  }
  G2 sig;
  int rc = g2_decompress(sig, sig96, assume_valid == 0);
  if (rc != DEC_OK) return -rc;
  if (acc.is_inf() || sig.is_inf()) return 0;
  G2 h;
  if (!hash_to_g2_point(h, msg, msg_len, dst, dst_len)) return -1;
  G1 neg_gen;
  pt_neg(neg_gen, G1_GEN);
  G1 ps[2] = {acc, neg_gen};
  G2 qs[2] = {h, sig};
  return pairing_product_is_one(ps, qs, 2) ? 1 : 0;
}

// fast_aggregate_verify from PRE-DECOMPRESSED raw affine pubkeys (the
// PublicKey cache) — skips the per-key sqrt that dominates large
// aggregates; on-curve is re-checked, subgroup was checked at parse.
int ec_bls_fast_aggregate_verify_raw(const u8* pks_raw, size_t n,
                                     const u8* msg, size_t msg_len,
                                     const u8* dst, size_t dst_len,
                                     const u8* sig96, int assume_valid) {
  ensure_init();
  if (n == 0) return 0;
  G1 acc;
  if (!g1_sum_raw(acc, pks_raw, n)) return -5;
  G2 sig;
  int rc = g2_decompress(sig, sig96, assume_valid == 0);
  if (rc != DEC_OK) return -rc;
  if (acc.is_inf() || sig.is_inf()) return 0;
  G2 h;
  if (!hash_to_g2_point(h, msg, msg_len, dst, dst_len)) return -1;
  G1 neg_gen;
  pt_neg(neg_gen, G1_GEN);
  G1 ps[2] = {acc, neg_gen};
  G2 qs[2] = {h, sig};
  return pairing_product_is_one(ps, qs, 2) ? 1 : 0;
}

int ec_bls_aggregate_verify(const u8* pks, size_t n, const u8* msgs,
                            const u32* msg_lens, const u8* dst, size_t dst_len,
                            const u8* sig96, int assume_valid) {
  ensure_init();
  if (n == 0) return 0;
  G2 sig;
  int rc = g2_decompress(sig, sig96, assume_valid == 0);
  if (rc != DEC_OK) return -rc;
  if (sig.is_inf()) return 0;
  G1* ps = new G1[n + 1];
  G2* qs = new G2[n + 1];
  for (size_t i = 0; i < n; i++) {
    G1 pk;
    rc = g1_decompress(pk, pks + 48 * i, assume_valid == 0);
    if (rc != DEC_OK) { delete[] ps; delete[] qs; return -rc; }
    if (pk.is_inf()) { delete[] ps; delete[] qs; return 0; }
    ps[i] = pk;
  }
  // distinct-message hashes batch eight-wide on the IFMA engine
  if (!hash_to_g2_batch(qs, msgs, msg_lens, n, dst, dst_len)) {
    delete[] ps;
    delete[] qs;
    return -1;
  }
  pt_neg(ps[n], G1_GEN);
  qs[n] = sig;
  bool ok = pairing_product_is_one(ps, qs, n + 1);
  delete[] ps;
  delete[] qs;
  return ok ? 1 : 0;
}

int ec_bls_aggregate_sigs(const u8* sigs, size_t n, u8* out96) {
  ensure_init();
  if (n == 0) return -1;
#ifdef EC_FP8_COMPILED
  if (FP8_READY && n >= 32) {
    // batched decompression (eight-wide sqrt chains + subgroup checks),
    // then eight running partial sums; duplicate-signature collisions
    // (the doubling corner) patch scalar — identical to the serial chain
    G2* pts = new G2[n];
    int* rcs = new int[n];
    g2_decompress_batch(pts, rcs, sigs, n, true);
    for (size_t i = 0; i < n; i++)
      if (rcs[i] != DEC_OK) {
        int rc = rcs[i];
        delete[] pts;
        delete[] rcs;
        return -rc;
      }
    G2 acc2;
    g2_sum_pts_x8(acc2, pts, n);
    delete[] pts;
    delete[] rcs;
    g2_compress(out96, acc2);
    return 0;
  }
#endif
  G2 acc = pt_infinity<Fp2Ops>();
  for (size_t i = 0; i < n; i++) {
    G2 s;
    int rc = g2_decompress(s, sigs + 96 * i, true);
    if (rc != DEC_OK) return -rc;
    pt_add(acc, acc, s);
  }
  g2_compress(out96, acc);
  return 0;
}

int ec_bls_aggregate_pubkeys(const u8* pks, size_t n, u8* out48) {
  ensure_init();
  if (n == 0) return -1;
#ifdef EC_FP8_COMPILED
  if (FP8_READY && n >= 32) {
    // eight-wide decompression (sqrt + subgroup chains) and lane sums
    G1* pts = new G1[n];
    int* rcs = new int[n];
    g1_decompress_batch(pts, rcs, pks, n, true);
    for (size_t i = 0; i < n; i++) {
      int rc = rcs[i] != DEC_OK ? -rcs[i]
               : pts[i].is_inf() ? -3  // each key must be a real point
                                 : 0;
      if (rc) {
        delete[] pts;
        delete[] rcs;
        return rc;
      }
    }
    G1 acc2;
    g1_sum_pts_x8(acc2, pts, n);
    delete[] pts;
    delete[] rcs;
    g1_compress(out48, acc2);
    return 0;
  }
#endif
  G1 acc = pt_infinity<FpOps>();
  for (size_t i = 0; i < n; i++) {
    G1 p;
    int rc = g1_decompress(p, pks + 48 * i, true);
    if (rc != DEC_OK) return -rc;
    if (p.is_inf()) return -3;  // eth_aggregate_public_keys validates each key
    pt_add(acc, acc, p);
  }
  g1_compress(out48, acc);
  return 0;
}

// Canonicality scan: every 32-byte big-endian scalar must be < r.
// 0 ok, -1 the first non-canonical element's complaint.
int ec_fr_validate(const u8* evals32, size_t n) {
  for (size_t i = 0; i < n; i++) {
    const u8* in = evals32 + 32 * i;
    u64 s[4];
    for (int k = 0; k < 4; k++) {
      u64 w = 0;
      for (int j = 0; j < 8; j++) w = (w << 8) | in[k * 8 + j];
      s[3 - k] = w;
    }
    if (fr_cmp_raw(s, R_RAW) >= 0) return -1;
  }
  return 0;
}

// Barycentric evaluation of a blob polynomial (evaluation form over the
// brp domain) at z; y32 gets the canonical 32-byte result. rc: 0 ok,
// -1 non-canonical input, -2 unsupported domain size.
int ec_fr_eval_poly(const u8* evals32, const u8* roots32, size_t n,
                    const u8* z32, u8* y32) {
  return fr_eval_quotient(evals32, roots32, n, z32, y32, nullptr);
}

// Same, plus the quotient polynomial q(X) = (p(X) - y)/(X - z) in
// evaluation form (both the on-domain and off-domain branches).
int ec_fr_eval_and_quotient(const u8* evals32, const u8* roots32, size_t n,
                            const u8* z32, u8* y32, u8* q32) {
  return fr_eval_quotient(evals32, roots32, n, z32, y32, q32);
}

// Prepared fixed-base G1 MSM over static points (the KZG Lagrange
// setup): precompute window shifts once, then every MSM is a single
// signed-digit bucket pass. The handle owns native-side Montgomery
// arrays; the caller frees it with ec_g1_msm_prepared_free.
void* ec_g1_msm_prepare(const u8* points_raw, size_t n, int window_bits) {
  ensure_init();
  if (n == 0 || window_bits < 2 || window_bits > 15) return nullptr;
  G1* pts = new G1[n];
  for (size_t i = 0; i < n; i++) {
    if (!g1_from_raw(pts[i], points_raw + 96 * i, 0)) {
      delete[] pts;
      return nullptr;
    }
  }
  MsmPrepared<FpOps>* h = msm_prepare<FpOps>(pts, n, window_bits);
  delete[] pts;
  return h;
}

int ec_g1_msm_prepared_run(void* handle, const u8* scalars32, size_t n,
                           u8* out_raw, int* out_inf) {
  ensure_init();
  MsmPrepared<FpOps>* h = (MsmPrepared<FpOps>*)handle;
  if (!h || h->n != n) return -1;
  u64* sc = new u64[4 * n];
  for (size_t i = 0; i < n; i++) scalar_from_be32(sc + 4 * i, scalars32 + 32 * i);
  G1 r;
  msm_prepared_run<FpOps>(r, h, sc);
  delete[] sc;
  *out_inf = r.is_inf() ? 1 : 0;
  g1_to_raw(out_raw, r);
  return 0;
}

void ec_g1_msm_prepared_free(void* handle) {
  delete (MsmPrepared<FpOps>*)handle;
}

// Bulk G1 decompression: n compressed keys -> n (rc, raw96, is_inf)
// triples with the sqrt and subgroup chains batched eight-wide. The
// Python pubkey cache uses this to warm a whole committee in one call.
int ec_g1_decompress_batch(const u8* in48s, size_t n, u8* out_raws,
                           int* rcs_out, int* infs, int check_subgroup) {
  ensure_init();
  G1* pts = new G1[n];
  int* rcs = new int[n];
  g1_decompress_batch(pts, rcs, in48s, n, check_subgroup != 0);
  for (size_t i = 0; i < n; i++) {
    rcs_out[i] = rcs[i] == DEC_OK ? 0 : -rcs[i];
    if (rcs[i] == DEC_OK) {
      infs[i] = pts[i].is_inf() ? 1 : 0;
      g1_to_raw(out_raws + 96 * i, pts[i]);
    } else {
      infs[i] = 0;
      memset(out_raws + 96 * i, 0, 96);
    }
  }
  delete[] pts;
  delete[] rcs;
  return 0;
}

// Random-linear-combination batch verification: every set must satisfy
// fast_aggregate_verify. scalars16: per-set 16-byte BE nonzero blinders
// (caller supplies; set 0 may be 1). Returns 1 all-valid, 0 otherwise.
int ec_bls_batch_verify(size_t n_sets, const u32* pk_counts, const u8* pks,
                        const u8* msgs, const u32* msg_lens, const u8* sigs,
                        const u8* dst, size_t dst_len, const u8* scalars16) {
  ensure_init();
  if (n_sets == 0) return 1;
  G1* ps = new G1[n_sets + 1];
  G2* qs = new G2[n_sets + 1];
  G2 sig_acc = pt_infinity<Fp2Ops>();
  size_t pk_off = 0, msg_off = 0;
  bool ok = true;
  for (size_t i = 0; i < n_sets && ok; i++) {
    u32 cnt = pk_counts[i];
    if (cnt == 0) { ok = false; break; }
    G1 agg = pt_infinity<FpOps>();
    for (u32 j = 0; j < cnt; j++) {
      G1 pk;
      if (g1_decompress(pk, pks + 48 * (pk_off + j), true) != DEC_OK ||
          pk.is_inf()) {
        ok = false;
        break;
      }
      pt_add(agg, agg, pk);
    }
    pk_off += cnt;
    if (!ok) break;
    G2 sig;
    if (g2_decompress(sig, sigs + 96 * i, true) != DEC_OK || sig.is_inf() ||
        agg.is_inf()) {
      ok = false;
      break;
    }
    u64 r[4] = {0, 0, 0, 0};
    for (int b = 0; b < 8; b++) r[1] = (r[1] << 8) | scalars16[16 * i + b];
    for (int b = 8; b < 16; b++) r[0] = (r[0] << 8) | scalars16[16 * i + b];
    if ((r[0] | r[1]) == 0) { ok = false; break; }
    G1 rp;
    pt_mul(rp, agg, r, 2);
    G2 rs;
    pt_mul(rs, sig, r, 2);
    pt_add(sig_acc, sig_acc, rs);
    ps[i] = rp;
    if (!hash_to_g2_point(qs[i], msgs + msg_off, msg_lens[i], dst, dst_len)) {
      ok = false;
      break;
    }
    msg_off += msg_lens[i];
  }
  if (ok) {
    pt_neg(ps[n_sets], G1_GEN);
    qs[n_sets] = sig_acc;
    ok = pairing_product_is_one(ps, qs, n_sets + 1);
  }
  delete[] ps;
  delete[] qs;
  return ok ? 1 : 0;
}

// Batch verify with PRE-DECOMPRESSED pubkeys (96-byte raw affine, already
// validated at parse time by the caller — on-curve is re-checked, the
// subgroup check was paid once when the key was first seen). Compared to
// ec_bls_batch_verify this removes the per-set per-key sqrt, and the
// blinded signature aggregation sum(r_i * sig_i) runs as one Pippenger
// MSM instead of n separate scalar mults.
int ec_bls_batch_verify_raw(size_t n_sets, const u32* pk_counts,
                            const u8* pks_raw, const u8* msgs,
                            const u32* msg_lens, const u8* sigs,
                            const u8* dst, size_t dst_len,
                            const u8* scalars16) {
  ensure_init();
  if (n_sets == 0) return 1;
  G1* ps = new G1[n_sets + 1];
  G2* qs = new G2[n_sets + 1];
  G2* sig_pts = new G2[n_sets];
  int* rcs = new int[n_sets];
  u64* sig_scalars = new u64[4 * n_sets];
  size_t pk_off = 0;
  bool ok = true;
  // phase 1: per-set pubkey aggregation (scalar adds), then all blinder
  // products r_i * aggpk_i as eight-lane batched scalar mults
  G1* aggs = new G1[n_sets];
  u64 (*blinders)[2] = new u64[n_sets][2];
  for (size_t i = 0; i < n_sets && ok; i++) {
    u32 cnt = pk_counts[i];
    if (cnt == 0) { ok = false; break; }
    G1 agg;
    if (!g1_sum_raw(agg, pks_raw + 96 * pk_off, cnt)) { ok = false; break; }
    pk_off += cnt;
    if (agg.is_inf()) { ok = false; break; }
    u64 r[4] = {0, 0, 0, 0};
    for (int b = 0; b < 8; b++) r[1] = (r[1] << 8) | scalars16[16 * i + b];
    for (int b = 8; b < 16; b++) r[0] = (r[0] << 8) | scalars16[16 * i + b];
    if ((r[0] | r[1]) == 0) { ok = false; break; }
    aggs[i] = agg;
    blinders[i][0] = r[0];
    blinders[i][1] = r[1];
    sig_scalars[4 * i] = r[0]; sig_scalars[4 * i + 1] = r[1];
    sig_scalars[4 * i + 2] = 0; sig_scalars[4 * i + 3] = 0;
  }
  if (ok) g1_mul128_batch(ps, aggs, blinders, n_sets);
  delete[] aggs;
  delete[] blinders;
  // phase 2: signature decompression, sqrt chains batched eight-wide
  if (ok) {
    g2_decompress_batch(sig_pts, rcs, sigs, n_sets, true);
    for (size_t i = 0; i < n_sets; i++)
      if (rcs[i] != DEC_OK || sig_pts[i].is_inf()) { ok = false; break; }
  }
  // phase 3: hash-to-G2, SSWU sqrt chains batched eight-wide
  if (ok) ok = hash_to_g2_batch(qs, msgs, msg_lens, n_sets, dst, dst_len);
  // phase 4: blinded-signature MSM + shared multi-pairing. Decompressed
  // signatures are affine (z = 1, infinity already rejected), so the
  // signed-digit batch-affine Pippenger applies directly.
  if (ok) {
    G2 sig_acc;
    Fp2* sxs = new Fp2[n_sets];
    Fp2* sys = new Fp2[n_sets];
    for (size_t i = 0; i < n_sets; i++) {
      sxs[i] = sig_pts[i].x;
      sys[i] = sig_pts[i].y;
    }
    pt_msm_batch_affine<Fp2Ops>(sig_acc, sxs, sys, sig_scalars, n_sets, 128);
    delete[] sxs;
    delete[] sys;
    pt_neg(ps[n_sets], G1_GEN);
    qs[n_sets] = sig_acc;
    ok = pairing_product_is_one(ps, qs, n_sets + 1);
  }
  delete[] ps;
  delete[] qs;
  delete[] sig_pts;
  delete[] rcs;
  delete[] sig_scalars;
  return ok ? 1 : 0;
}

int ec_g1_msm(const u8* points_raw, const u8* scalars32, size_t n, u8* out_raw,
              int* out_inf) {
  ensure_init();
  Fp* xs = new Fp[n];
  Fp* ys = new Fp[n];
  u64* sc = new u64[4 * n];
  for (size_t i = 0; i < n; i++) {
    G1 p;
    if (!g1_from_raw(p, points_raw + 96 * i, 0)) {
      delete[] xs; delete[] ys; delete[] sc;
      return -5;
    }
    xs[i] = p.x; ys[i] = p.y;   // pt_from_affine: z = 1
    scalar_from_be32(sc + 4 * i, scalars32 + 32 * i);
  }
  G1 r;
  pt_msm_batch_affine<FpOps>(r, xs, ys, sc, n, 256);
  *out_inf = r.is_inf() ? 1 : 0;
  g1_to_raw(out_raw, r);
  delete[] xs; delete[] ys;
  delete[] sc;
  return 0;
}

int ec_g2_msm(const u8* points_raw, const u8* scalars32, size_t n, u8* out_raw,
              int* out_inf) {
  ensure_init();
  Fp2* xs = new Fp2[n];
  Fp2* ys = new Fp2[n];
  u64* sc = new u64[4 * n];
  for (size_t i = 0; i < n; i++) {
    G2 p;
    if (!g2_from_raw(p, points_raw + 192 * i, 0)) {
      delete[] xs; delete[] ys; delete[] sc;
      return -5;
    }
    xs[i] = p.x; ys[i] = p.y;
    scalar_from_be32(sc + 4 * i, scalars32 + 32 * i);
  }
  G2 r;
  pt_msm_batch_affine<Fp2Ops>(r, xs, ys, sc, n, 256);
  *out_inf = r.is_inf() ? 1 : 0;
  g2_to_raw(out_raw, r);
  delete[] xs; delete[] ys;
  delete[] sc;
  return 0;
}

int ec_g1_mul_raw(const u8* point_raw, int is_inf, const u8* scalar32,
                  u8* out_raw, int* out_inf) {
  ensure_init();
  G1 p;
  if (!g1_from_raw(p, point_raw, is_inf)) return -5;
  u64 s[4];
  scalar_from_be32(s, scalar32);
  G1 r;
  pt_mul(r, p, s, 4);
  *out_inf = r.is_inf() ? 1 : 0;
  g1_to_raw(out_raw, r);
  return 0;
}

int ec_g1_add_raw(const u8* a_raw, int a_inf, const u8* b_raw, int b_inf,
                  u8* out_raw, int* out_inf) {
  ensure_init();
  G1 a, b;
  if (!g1_from_raw(a, a_raw, a_inf) || !g1_from_raw(b, b_raw, b_inf)) return -5;
  G1 r;
  pt_add(r, a, b);
  *out_inf = r.is_inf() ? 1 : 0;
  g1_to_raw(out_raw, r);
  return 0;
}

int ec_g1_subgroup_check_raw(const u8* raw) {
  ensure_init();
  G1 p;
  if (!g1_from_raw(p, raw, 0)) return -5;
  return pt_in_subgroup(p) ? 1 : 0;
}

int ec_g2_subgroup_check_raw(const u8* raw) {
  ensure_init();
  G2 p;
  if (!g2_from_raw(p, raw, 0)) return -5;
  return pt_in_subgroup(p) ? 1 : 0;
}

int ec_pairing_product_is_one_raw(const u8* g1_raw, const u8* g1_inf,
                                  const u8* g2_raw, const u8* g2_inf,
                                  size_t n) {
  ensure_init();
  G1* ps = new G1[n];
  G2* qs = new G2[n];
  for (size_t i = 0; i < n; i++) {
    if (!g1_from_raw(ps[i], g1_raw + 96 * i, g1_inf[i]) ||
        !g2_from_raw(qs[i], g2_raw + 192 * i, g2_inf[i])) {
      delete[] ps; delete[] qs;
      return -5;
    }
  }
  bool ok = pairing_product_is_one(ps, qs, n);
  delete[] ps;
  delete[] qs;
  return ok ? 1 : 0;
}

// --- Fq12 handoff for the device batched pairing (ops/pairing.py) ---------
// Raw layout: 12 coefficients, 48-byte big-endian standard form each, in
// (c0.a0.c0, c0.a0.c1, c0.a1.c0, c0.a1.c1, c0.a2.c0, c0.a2.c1,
//  c1.a0.c0, ..., c1.a2.c1) order — matching ops/fq12.fp12_to_ints.

static void fp12_to_raw576(u8* out, const Fp12& f) {
  const Fp2* comps[6] = {&f.c0.a0, &f.c0.a1, &f.c0.a2,
                         &f.c1.a0, &f.c1.a1, &f.c1.a2};
  for (int i = 0; i < 6; i++) {
    fp_to_bytes(out + 96 * i, comps[i]->c0);
    fp_to_bytes(out + 96 * i + 48, comps[i]->c1);
  }
}

static bool fp12_from_raw576(Fp12& f, const u8* in) {
  Fp2* comps[6] = {&f.c0.a0, &f.c0.a1, &f.c0.a2,
                   &f.c1.a0, &f.c1.a1, &f.c1.a2};
  for (int i = 0; i < 6; i++) {
    if (!fp_from_bytes(comps[i]->c0, in + 96 * i) ||
        !fp_from_bytes(comps[i]->c1, in + 96 * i + 48))
      return false;
  }
  return true;
}

// single-pair Miller loop, raw in/out — the device kernel's parity anchor
int ec_miller_loop_raw(const u8* g1_raw, const u8* g2_raw, u8* out576) {
  ensure_init();
  G1 p;
  G2 q;
  if (!g1_from_raw(p, g1_raw, 0) || !g2_from_raw(q, g2_raw, 0)) return -5;
  if (p.is_inf() || q.is_inf()) { fp12_to_raw576(out576, FP12_ONE); return 0; }
  MillerPair mp;
  pt_to_affine<FpOps>(mp.xp, mp.yp, p);
  pt_to_affine<Fp2Ops>(mp.xq, mp.yq, q);
  Fp12 f;
  multi_miller_loop(f, &mp, 1);
  fp12_to_raw576(out576, f);
  return 0;
}

// final-exponentiation verdict on a raw Fq12 (the device hands its
// tree-reduced Miller product here; only the predicate crosses back)
int ec_fp12_final_exp_is_one(const u8* f576) {
  ensure_init();
  Fp12 f;
  if (!fp12_from_raw576(f, f576)) return -4;
  Fp12 fe;
  final_exp_for_verdict(fe, f);
  return fp12_is_one(fe) ? 1 : 0;
}

}  // extern "C"
