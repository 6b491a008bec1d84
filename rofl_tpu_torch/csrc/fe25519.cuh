// GF(2^255-19) arithmetic for one lane per CUDA thread.
//
// Device counterpart of rofl_tpu_torch/ops/fe.py and the replacement of the
// in-kernel field helpers of the TPU package (rofl_tpu/ops/kernels.py
// f_mul, f_sqr, f_norm, f_canon, f_sqrt_ratio_m1, ...) under the curve
// kernels still on 16-bit limbs: csrc/shared_scalar_mul.cu and
// csrc/scalar_mul_window.cu (the others run on fe25519_32.cuh).
//
// Representation: 16 limbs of 16 bits in 32-bit registers, weakly reduced in
// [0, 2^256), the same as the tensors outside the kernels, so loads and
// stores need no conversion. 2^256 = 38 (mod p) folds keep values in range.
// A product accumulates whole 32-bit partial products into 64-bit columns
// (one multiply-add per partial product); the plain version splits each
// product into 16-bit halves instead, so a weakly reduced result may differ
// from the plain version's by a multiple of p. Canonical values are equal.
//
// The header also compiles as plain C++, so the arithmetic can be checked on
// a host without a card.
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define ROFL_HD __host__ __device__ __forceinline__
#define ROFL_UNROLL _Pragma("unroll")
#define ROFL_NO_UNROLL _Pragma("unroll 1")
#else
#define ROFL_HD inline
#define ROFL_UNROLL
#define ROFL_NO_UNROLL
#endif

namespace rofl {

constexpr int NLIMB = 16;

struct fe {
  uint32_t v[NLIMB];
};

// 4p = 2^257 - 76, saturated limbwise so a + 4p - b never underflows.
ROFL_HD uint32_t four_p_limb(int k) { return k == 0 ? 0x1FFB4u : 0x1FFFEu; }
ROFL_HD uint32_t p_limb(int k) {
  return k == 0 ? 0xFFEDu : (k == 15 ? 0x7FFFu : 0xFFFFu);
}

ROFL_HD fe fe_zero() {
  fe r;
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) r.v[k] = 0;
  return r;
}

ROFL_HD fe fe_one() {
  fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

// Edwards 2d and sqrt(-1): spec/field.py D2 and SQRT_M1 as little-endian
// 16-bit limbs.
ROFL_HD fe fe_const_d2() {
  return fe{{0xf159, 0x26b2, 0x9b94, 0xebd6, 0xb156, 0x8283, 0x149a, 0x00e0,
             0xd130, 0xeef3, 0x80f2, 0x198e, 0xfce7, 0x56df, 0xd9dc, 0x2406}};
}
ROFL_HD fe fe_const_sqrt_m1() {
  return fe{{0xa0b0, 0x4a0e, 0x1b27, 0xc4ee, 0xe478, 0xad2f, 0x1806, 0x2f43,
             0xd7a7, 0x3dfb, 0x0099, 0x2b4d, 0xdf0b, 0x4fc1, 0x2480, 0x2b83}};
}

// One sequential carry pass over 32-bit limbs; returns the carry out of
// limb 15 (worth 2^256).
ROFL_HD uint32_t fe_carry_pass(uint32_t t[NLIMB]) {
  uint32_t c = 0;
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) {
    uint32_t x = t[k] + c;
    t[k] = x & 0xFFFFu;
    c = x >> 16;
  }
  return c;
}

// Limbs < 2^27 each -> fully carried value < 2^256: three passes with
// 2^256 = 38 folds (fe.py _normalize).
ROFL_HD fe fe_norm(uint32_t t[NLIMB]) {
  uint32_t c = fe_carry_pass(t);
  t[0] += 38u * c;
  c = fe_carry_pass(t);
  t[0] += 38u * c;
  fe_carry_pass(t);
  fe r;
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) r.v[k] = t[k];
  return r;
}

ROFL_HD fe fe_add(const fe &a, const fe &b) {
  uint32_t t[NLIMB];
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) t[k] = a.v[k] + b.v[k];
  return fe_norm(t);
}

ROFL_HD fe fe_sub(const fe &a, const fe &b) {
  uint32_t t[NLIMB];
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) t[k] = a.v[k] + four_p_limb(k) - b.v[k];
  return fe_norm(t);
}

ROFL_HD fe fe_neg(const fe &a) {
  uint32_t t[NLIMB];
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) t[k] = four_p_limb(k) - a.v[k];
  return fe_norm(t);
}

// Multiply by a small constant c < 2^11.
ROFL_HD fe fe_mul_small(const fe &a, uint32_t c) {
  uint32_t t[NLIMB];
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) t[k] = a.v[k] * c;
  return fe_norm(t);
}

// 31 columns of 64-bit sums (each < 2^37) -> fe. Columns 16..30 fold onto
// 0..14 with 2^256 = 38, so a folded column is < 2^43. The first carry pass
// runs in 64 bits and leaves a carry < 2^22 out of limb 15; after folding it
// limb 0 is < 2^27 and the rest are < 2^16, which two 32-bit passes finish.
ROFL_HD fe fe_reduce_columns(const uint64_t col[2 * NLIMB - 1]) {
  uint32_t t[NLIMB];
  uint64_t c = 0;
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) {
    uint64_t x = col[k] + c;
    if (k < NLIMB - 1) x += 38ull * col[k + NLIMB];
    t[k] = (uint32_t)x & 0xFFFFu;
    c = x >> 16;
  }
  t[0] += 38u * (uint32_t)c;
  uint32_t c2 = fe_carry_pass(t);
  t[0] += 38u * c2;
  fe_carry_pass(t);
  fe r;
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) r.v[k] = t[k];
  return r;
}

// Schoolbook product: 256 multiply-adds into 64-bit columns.
ROFL_HD fe fe_mul(const fe &a, const fe &b) {
  uint64_t col[2 * NLIMB - 1];
  ROFL_UNROLL
  for (int k = 0; k < 2 * NLIMB - 1; ++k) col[k] = 0;
  ROFL_UNROLL
  for (int i = 0; i < NLIMB; ++i) {
    ROFL_UNROLL
    for (int j = 0; j < NLIMB; ++j) {
      col[i + j] += (uint64_t)a.v[i] * (uint64_t)b.v[j];
    }
  }
  return fe_reduce_columns(col);
}

// Squaring: the 120 off-diagonal products are taken once against 2*a_i
// (< 2^17, so a product is < 2^33 and a column still < 2^37).
ROFL_HD fe fe_sqr(const fe &a) {
  uint64_t col[2 * NLIMB - 1];
  uint32_t a2[NLIMB];
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) a2[k] = a.v[k] << 1;
  ROFL_UNROLL
  for (int k = 0; k < 2 * NLIMB - 1; ++k) col[k] = 0;
  ROFL_UNROLL
  for (int i = 0; i < NLIMB; ++i) {
    col[2 * i] += (uint64_t)a.v[i] * (uint64_t)a.v[i];
    ROFL_UNROLL
    for (int j = i + 1; j < NLIMB; ++j) {
      col[i + j] += (uint64_t)a2[i] * (uint64_t)a.v[j];
    }
  }
  return fe_reduce_columns(col);
}

// n squarings in a rolled loop: one copy of the squaring body per call site.
ROFL_HD fe fe_sqr_n(fe a, int n) {
  ROFL_NO_UNROLL
  for (int i = 0; i < n; ++i) a = fe_sqr(a);
  return a;
}

// Canonical representative in [0, p): value < 2^256 < 3p, so two
// conditional subtracts (fe.py canonicalize).
ROFL_HD fe fe_canon(fe a) {
  ROFL_UNROLL
  for (int pass = 0; pass < 2; ++pass) {
    uint32_t diff[NLIMB];
    uint32_t borrow = 0;
    ROFL_UNROLL
    for (int k = 0; k < NLIMB; ++k) {
      uint32_t x = a.v[k] + 0x10000u - p_limb(k) - borrow;
      diff[k] = x & 0xFFFFu;
      borrow = 1u - (x >> 16);
    }
    bool ge = borrow == 0;
    ROFL_UNROLL
    for (int k = 0; k < NLIMB; ++k) a.v[k] = ge ? diff[k] : a.v[k];
  }
  return a;
}

ROFL_HD bool fe_eq(const fe &a, const fe &b) {
  fe ca = fe_canon(a), cb = fe_canon(b);
  uint32_t acc = 0;
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) acc |= ca.v[k] ^ cb.v[k];
  return acc == 0;
}

// dalek IS_NEGATIVE: the canonical encoding is odd.
ROFL_HD bool fe_is_negative(const fe &a) { return (fe_canon(a).v[0] & 1u) != 0; }

ROFL_HD fe fe_select(bool cond, const fe &a_true, const fe &a_false) {
  fe r;
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) r.v[k] = cond ? a_true.v[k] : a_false.v[k];
  return r;
}

// CT_ABS: negate iff negative.
ROFL_HD fe fe_cabs(const fe &a) { return fe_select(fe_is_negative(a), fe_neg(a), a); }

// (x^(2^250-1), x^11): shared prefix of the inversion and sqrt chains
// (ref10 addition chain, fe.py _pow22501).
ROFL_HD void fe_pow22501(const fe &x, fe &t12, fe &t3) {
  fe t0 = fe_sqr(x);
  fe t1 = fe_sqr_n(t0, 2);
  fe t2 = fe_mul(x, t1);
  t3 = fe_mul(t0, t2);
  fe t4 = fe_sqr(t3);
  fe t5 = fe_mul(t2, t4);
  fe t6 = fe_mul(fe_sqr_n(t5, 5), t5);
  fe t7 = fe_mul(fe_sqr_n(t6, 10), t6);
  fe t8 = fe_mul(fe_sqr_n(t7, 20), t7);
  fe t9 = fe_mul(fe_sqr_n(t8, 10), t6);
  fe t10 = fe_mul(fe_sqr_n(t9, 50), t9);
  fe t11 = fe_mul(fe_sqr_n(t10, 100), t10);
  t12 = fe_mul(fe_sqr_n(t11, 50), t9);
}

// a^(p-2); inv(0) == 0.
ROFL_HD fe fe_inv(const fe &a) {
  fe t12, t3;
  fe_pow22501(a, t12, t3);
  return fe_mul(fe_sqr_n(t12, 5), t3);
}

// a^((p-5)/8) = a^(2^252 - 3).
ROFL_HD fe fe_pow_p58(const fe &a) {
  fe t12, t3;
  fe_pow22501(a, t12, t3);
  return fe_mul(fe_sqr_n(t12, 2), a);
}

// FieldElement::sqrt_ratio_i (fe.py sqrt_ratio_m1): returns was_square and
// writes the non-negative root of u/v, or of i*u/v, to r.
ROFL_HD bool fe_sqrt_ratio_m1(const fe &u, const fe &v, fe &r) {
  fe v3 = fe_mul(fe_sqr(v), v);
  fe v7 = fe_mul(fe_sqr(v3), v);
  r = fe_mul(fe_mul(u, v3), fe_pow_p58(fe_mul(u, v7)));
  fe check = fe_mul(v, fe_sqr(r));
  fe u_neg = fe_neg(u);
  fe sqrt_m1 = fe_const_sqrt_m1();
  bool correct_sign = fe_eq(check, u);
  bool flipped_sign = fe_eq(check, u_neg);
  bool flipped_sign_i = fe_eq(check, fe_mul(u_neg, sqrt_m1));
  r = fe_select(flipped_sign || flipped_sign_i, fe_mul(r, sqrt_m1), r);
  r = fe_cabs(r);
  return correct_sign || flipped_sign;
}

}  // namespace rofl
