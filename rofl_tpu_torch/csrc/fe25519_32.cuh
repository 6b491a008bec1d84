// GF(2^255-19) and Ristretto255 point arithmetic on 8 limbs of 32 bits, one
// lane per CUDA thread: the arithmetic under every curve kernel of the port,
// csrc/point_add.cu, csrc/point_double.cu, csrc/compress.cu,
// csrc/decompress.cu, csrc/msm.cu, csrc/scalar_mul.cu,
// csrc/scalar_mul_window.cu and csrc/shared_scalar_mul.cu.
//
// A product is 64 partial products of 32-bit limbs, each one wide
// multiply-add into a 32-bit limb with a 32-bit carry (operand scanning),
// and a squaring 36; on 16 limbs of 16 bits the same product would take 256.
// Values are weakly reduced in [0, 2^256); 2^256 = 38 (mod p) folds the
// high half of a product and the carry of a sum back into range.
//
// Storage stays the port's: a coordinate is a (16, N) int32 array of 16-bit
// limbs, limb-major (limb k of lane n at base[k * n_lanes + n]). fe_load16
// packs two limbs a word on the way in and fe_store16 splits them on the way
// out, so no tensor, wrapper or plain version changes. Canonical values are
// the same as the plain versions'; weakly reduced ones may differ from them
// by a multiple of p.
//
// The header also compiles as plain C++ (csrc/host_check.cpp), so the host
// tests run the same functions.
#pragma once

#include <stdint.h>

#include "rofl_hd.cuh"

namespace rofl32 {

constexpr int NW = 8;  // 32-bit words of a field element

struct fe {
  uint32_t v[NW];
};

// Extended twisted-Edwards coordinates (X:Y:Z:T), a = -1.
struct ge {
  fe x, y, z, t;
};

constexpr int POINT_WORDS = 4 * NW;

ROFL_HD fe fe_zero() {
  fe r;
  ROFL_UNROLL
  for (int k = 0; k < NW; ++k) r.v[k] = 0;
  return r;
}

ROFL_HD fe fe_one() {
  fe r = fe_zero();
  r.v[0] = 1;
  return r;
}

// Edwards d and 2d (spec/field.py D, D2).
ROFL_HD fe fe_const_d() {
  return fe{{0x135978a3u, 0x75eb4dcau, 0x4141d8abu, 0x00700a4du, 0x7779e898u, 0x8cc74079u,
             0x2b6ffe73u, 0x52036ceeu}};
}
ROFL_HD fe fe_const_d2() {
  return fe{{0x26b2f159u, 0xebd69b94u, 0x8283b156u, 0x00e0149au, 0xeef3d130u, 0x198e80f2u,
             0x56dffce7u, 0x2406d9dcu}};
}

// a + b + carry; carry becomes the carry out (0 or 1).
ROFL_HD uint32_t add_carry(uint32_t a, uint32_t b, uint32_t &carry) {
  uint64_t s = (uint64_t)a + b + carry;
  carry = (uint32_t)(s >> 32);
  return (uint32_t)s;
}

// a - b - borrow; borrow becomes the borrow out (0 or 1).
ROFL_HD uint32_t sub_borrow(uint32_t a, uint32_t b, uint32_t &borrow) {
  uint64_t d = (uint64_t)a - b - borrow;
  borrow = (uint32_t)(d >> 63);
  return (uint32_t)d;
}

// r + 38 * c for r < 2^256 and c < 2^26: one chain, whose carry out leaves
// r below 38 * c, so the second fold touches word 0 alone.
ROFL_HD void fold_carry(uint32_t r[NW], uint32_t c) {
  uint32_t carry = 0;
  r[0] = add_carry(r[0], 38u * c, carry);
  ROFL_UNROLL
  for (int k = 1; k < NW; ++k) r[k] = add_carry(r[k], 0, carry);
  r[0] += 38u * carry;
}

ROFL_HD fe fe_add(const fe &a, const fe &b) {
  fe r;
  uint32_t carry = 0;
  ROFL_UNROLL
  for (int k = 0; k < NW; ++k) r.v[k] = add_carry(a.v[k], b.v[k], carry);
  fold_carry(r.v, carry);
  return r;
}

// a - b: a borrow out of the top word means 2^256 too much, that is 38 too
// much mod p; a second borrow can only come from a value below 38, after
// which word 0 is at least 2^32 - 38 and takes the last 38 without one.
ROFL_HD fe fe_sub(const fe &a, const fe &b) {
  fe r;
  uint32_t borrow = 0;
  ROFL_UNROLL
  for (int k = 0; k < NW; ++k) r.v[k] = sub_borrow(a.v[k], b.v[k], borrow);
  uint32_t borrow2 = 0;
  r.v[0] = sub_borrow(r.v[0], 38u * borrow, borrow2);
  ROFL_UNROLL
  for (int k = 1; k < NW; ++k) r.v[k] = sub_borrow(r.v[k], 0, borrow2);
  r.v[0] -= 38u * borrow2;
  return r;
}

ROFL_HD fe fe_neg(const fe &a) { return fe_sub(fe_zero(), a); }

// 512-bit t (16 words) -> t_lo + 38 t_hi < 2^256.
ROFL_HD fe fe_reduce_wide(const uint32_t t[2 * NW]) {
  fe r;
  uint32_t carry = 0;
  ROFL_UNROLL
  for (int k = 0; k < NW; ++k) {
    uint64_t s = (uint64_t)t[k + NW] * 38u + t[k] + carry;
    r.v[k] = (uint32_t)s;
    carry = (uint32_t)(s >> 32);
  }
  fold_carry(r.v, carry);  // carry <= 38
  return r;
}

// Schoolbook product, operand scanning: row i adds a_i * b into t with one
// wide multiply-add a partial product, (2^32 - 1)^2 + 2 (2^32 - 1) < 2^64.
ROFL_HD fe fe_mul(const fe &a, const fe &b) {
  uint32_t t[2 * NW];
  ROFL_UNROLL
  for (int k = 0; k < 2 * NW; ++k) t[k] = 0;
  ROFL_UNROLL
  for (int i = 0; i < NW; ++i) {
    uint32_t carry = 0;
    ROFL_UNROLL
    for (int j = 0; j < NW; ++j) {
      uint64_t s = (uint64_t)a.v[i] * b.v[j] + t[i + j] + carry;
      t[i + j] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    t[i + NW] = carry;
  }
  return fe_reduce_wide(t);
}

// Squaring: the 28 products a_i a_j, i < j, once, the sum doubled by a
// shift, then the 8 squares a_i^2 added in one chain.
ROFL_HD fe fe_sqr(const fe &a) {
  uint32_t t[2 * NW];
  ROFL_UNROLL
  for (int k = 0; k < 2 * NW; ++k) t[k] = 0;
  ROFL_UNROLL
  for (int i = 0; i < NW - 1; ++i) {
    uint32_t carry = 0;
    ROFL_UNROLL
    for (int j = i + 1; j < NW; ++j) {
      uint64_t s = (uint64_t)a.v[i] * a.v[j] + t[i + j] + carry;
      t[i + j] = (uint32_t)s;
      carry = (uint32_t)(s >> 32);
    }
    t[i + NW] = carry;
  }
  ROFL_UNROLL
  for (int k = 2 * NW - 1; k > 0; --k) t[k] = (t[k] << 1) | (t[k - 1] >> 31);
  t[0] <<= 1;
  uint32_t carry = 0;
  ROFL_UNROLL
  for (int i = 0; i < NW; ++i) {
    uint64_t sq = (uint64_t)a.v[i] * a.v[i];
    t[2 * i] = add_carry(t[2 * i], (uint32_t)sq, carry);
    t[2 * i + 1] = add_carry(t[2 * i + 1], (uint32_t)(sq >> 32), carry);
  }
  return fe_reduce_wide(t);
}

ROFL_HD fe fe_select(bool cond, const fe &a_true, const fe &a_false) {
  fe r;
  ROFL_UNROLL
  for (int k = 0; k < NW; ++k) r.v[k] = cond ? a_true.v[k] : a_false.v[k];
  return r;
}

// sqrt(-1) and 1/sqrt(a - d) (spec/field.py SQRT_M1, INVSQRT_A_MINUS_D).
ROFL_HD fe fe_const_sqrt_m1() {
  return fe{{0x4a0ea0b0u, 0xc4ee1b27u, 0xad2fe478u, 0x2f431806u, 0x3dfbd7a7u, 0x2b4d0099u,
             0x4fc1df0bu, 0x2b832480u}};
}
ROFL_HD fe fe_const_invsqrt_a_minus_d() {
  return fe{{0x805d40eau, 0x99c8fdaau, 0x5a4172beu, 0x9d2f1617u, 0xfe01d840u, 0x16c27b91u,
             0xcfaffca2u, 0x786c8905u}};
}

// Word w of p = 2^255 - 19.
ROFL_HD uint32_t p_word(int w) {
  return w == 0 ? 0xFFFFFFEDu : (w == NW - 1 ? 0x7FFFFFFFu : 0xFFFFFFFFu);
}

// The canonical representative in [0, p): a value below 2^256 < 3p takes
// two conditional subtracts of p.
ROFL_HD fe fe_canon(fe a) {
  ROFL_UNROLL
  for (int pass = 0; pass < 2; ++pass) {
    fe d;
    uint32_t borrow = 0;
    ROFL_UNROLL
    for (int k = 0; k < NW; ++k) d.v[k] = sub_borrow(a.v[k], p_word(k), borrow);
    a = fe_select(borrow == 0, d, a);
  }
  return a;
}

ROFL_HD bool fe_is_zero(const fe &a) {
  const fe c = fe_canon(a);
  uint32_t acc = 0;
  ROFL_UNROLL
  for (int k = 0; k < NW; ++k) acc |= c.v[k];
  return acc == 0;
}

// a = b (mod p): a - b is a multiple of p.
ROFL_HD bool fe_eq(const fe &a, const fe &b) { return fe_is_zero(fe_sub(a, b)); }

// dalek IS_NEGATIVE: the canonical encoding is odd.
ROFL_HD bool fe_is_negative(const fe &a) { return (fe_canon(a).v[0] & 1u) != 0; }

// CT_ABS: negate iff negative.
ROFL_HD fe fe_cabs(const fe &a) { return fe_select(fe_is_negative(a), fe_neg(a), a); }

// n squarings in a rolled loop: one copy of the squaring body a call site.
ROFL_HD fe fe_sqr_n(fe a, int n) {
  ROFL_NO_UNROLL
  for (int i = 0; i < n; ++i) a = fe_sqr(a);
  return a;
}

// x^((p-5)/8) = x^(2^252 - 3) by ref10's addition chain (ops/fe.py
// _pow22501, then two squarings and a product): 251 squarings, 11 products.
ROFL_HD fe fe_pow_p58(const fe &x) {
  const fe t0 = fe_sqr(x);
  const fe t2 = fe_mul(x, fe_sqr_n(t0, 2));
  const fe t5 = fe_mul(t2, fe_sqr(fe_mul(t0, t2)));
  const fe t6 = fe_mul(fe_sqr_n(t5, 5), t5);
  const fe t7 = fe_mul(fe_sqr_n(t6, 10), t6);
  const fe t8 = fe_mul(fe_sqr_n(t7, 20), t7);
  const fe t9 = fe_mul(fe_sqr_n(t8, 10), t6);
  const fe t10 = fe_mul(fe_sqr_n(t9, 50), t9);
  const fe t11 = fe_mul(fe_sqr_n(t10, 100), t10);
  const fe t12 = fe_mul(fe_sqr_n(t11, 50), t9);  // x^(2^250 - 1)
  return fe_mul(fe_sqr_n(t12, 2), x);
}

// FieldElement::invsqrt, sqrt_ratio_i(1, v) (ops/fe.py sqrt_ratio_m1 with
// u = 1, the only u that compress and decompress pass): returns was_square
// and writes the non-negative root of 1/v, or of i/v, to r. 16 products and
// 254 squarings: u = 1 saves the products u * v^3, u * v^7 and -u * i of
// the general form.
ROFL_HD bool fe_invsqrt(const fe &v, fe &r) {
  const fe v3 = fe_mul(fe_sqr(v), v);
  const fe v7 = fe_mul(fe_sqr(v3), v);
  r = fe_mul(v3, fe_pow_p58(v7));
  const fe check = fe_mul(v, fe_sqr(r));
  const fe sqrt_m1 = fe_const_sqrt_m1();
  const bool correct_sign = fe_eq(check, fe_one());
  const bool flipped_sign = fe_eq(check, fe_neg(fe_one()));
  const bool flipped_sign_i = fe_eq(check, fe_neg(sqrt_m1));
  r = fe_select(flipped_sign || flipped_sign_i, fe_mul(r, sqrt_m1), r);
  r = fe_cabs(r);
  return correct_sign || flipped_sign;
}

// The port's storage: limbs 2w and 2w + 1 (16 bits each) of a (16, N)
// int32 array are word w.
ROFL_HD fe fe_load16(const int32_t *base, int64_t n_lanes, int64_t lane) {
  fe r;
  ROFL_UNROLL
  for (int w = 0; w < NW; ++w) {
    r.v[w] = (uint32_t)base[(2 * w) * n_lanes + lane] |
             ((uint32_t)base[(2 * w + 1) * n_lanes + lane] << 16);
  }
  return r;
}

ROFL_HD void fe_store16(int32_t *base, int64_t n_lanes, int64_t lane, const fe &a) {
  ROFL_UNROLL
  for (int w = 0; w < NW; ++w) {
    base[(2 * w) * n_lanes + lane] = (int32_t)(a.v[w] & 0xFFFFu);
    base[(2 * w + 1) * n_lanes + lane] = (int32_t)(a.v[w] >> 16);
  }
}

// -- points ---------------------------------------------------------------

ROFL_HD ge ge_identity() {
  ge r;
  r.x = fe_zero();
  r.y = fe_one();
  r.z = fe_one();
  r.t = fe_zero();
  return r;
}

ROFL_HD ge ge_load16(const int32_t *px, const int32_t *py, const int32_t *pz,
                     const int32_t *pt, int64_t n_lanes, int64_t lane) {
  ge p;
  p.x = fe_load16(px, n_lanes, lane);
  p.y = fe_load16(py, n_lanes, lane);
  p.z = fe_load16(pz, n_lanes, lane);
  p.t = fe_load16(pt, n_lanes, lane);
  return p;
}

ROFL_HD void ge_store16(int32_t *px, int32_t *py, int32_t *pz, int32_t *pt, int64_t n_lanes,
                        int64_t lane, const ge &p) {
  fe_store16(px, n_lanes, lane, p.x);
  fe_store16(py, n_lanes, lane, p.y);
  fe_store16(pz, n_lanes, lane, p.z);
  fe_store16(pt, n_lanes, lane, p.t);
}

// Unified extended addition add-2008-hwcd-3, a = -1 (the TPU package's
// p_add): complete, so identity and doubling inputs need no branch. 9 products.
ROFL_HD ge ge_add(const ge &p, const ge &q) {
  fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  fe c = fe_mul(fe_mul(p.t, fe_const_d2()), q.t);
  fe zz = fe_mul(p.z, q.z);
  fe d = fe_add(zz, zz);
  fe e = fe_sub(b, a);
  fe f = fe_sub(d, c);
  fe g = fe_add(d, c);
  fe h = fe_add(b, a);
  ge r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}

// dbl-2008-hwcd, a = -1: 4 products and 4 squarings. It reads no T, so a
// doubling followed by another doubling may leave T out (with_t false: 3
// products), as the ladder's and the combine's runs of doublings do.
ROFL_HD ge ge_double(const ge &p, bool with_t = true) {
  fe a = fe_sqr(p.x);
  fe b = fe_sqr(p.y);
  fe zz = fe_sqr(p.z);
  fe c = fe_add(zz, zz);
  fe d = fe_neg(a);
  fe e = fe_sub(fe_sub(fe_sqr(fe_add(p.x, p.y)), a), b);
  fe g = fe_add(d, b);
  fe f = fe_sub(g, c);
  fe h = fe_sub(d, b);
  ge r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = with_t ? fe_mul(e, h) : fe_zero();
  return r;
}

ROFL_HD ge ge_select(bool cond, const ge &p_true, const ge &p_false) {
  ge r;
  r.x = fe_select(cond, p_true.x, p_false.x);
  r.y = fe_select(cond, p_true.y, p_false.y);
  r.z = fe_select(cond, p_true.z, p_false.z);
  r.t = fe_select(cond, p_true.t, p_false.t);
  return r;
}

// -P where neg is set, P elsewhere: (-X, Y, Z, -T), both computed.
ROFL_HD ge ge_cneg(bool neg, const ge &p) {
  ge r = p;
  r.x = fe_select(neg, fe_neg(p.x), p.x);
  r.t = fe_select(neg, fe_neg(p.t), p.t);
  return r;
}

// Ristretto encode (RFC 9496 4.3.2) -> the canonical s. The same formula as
// the TPU package's _compress_kernel and kernels.compress_ref; every input
// below 2^256 is taken, and the output does not depend on the representative.
ROFL_HD fe ristretto_compress(const ge &p) {
  const fe u1 = fe_mul(fe_add(p.z, p.y), fe_sub(p.z, p.y));
  const fe u2 = fe_mul(p.x, p.y);
  fe inv_sqrt;
  fe_invsqrt(fe_mul(u1, fe_sqr(u2)), inv_sqrt);
  const fe den1 = fe_mul(inv_sqrt, u1);
  const fe den2 = fe_mul(inv_sqrt, u2);
  const fe z_inv = fe_mul(fe_mul(den1, den2), p.t);
  const fe sqrt_m1 = fe_const_sqrt_m1();
  const bool rotate = fe_is_negative(fe_mul(p.t, z_inv));
  const fe x = fe_select(rotate, fe_mul(p.y, sqrt_m1), p.x);
  fe y = fe_select(rotate, fe_mul(p.x, sqrt_m1), p.y);
  const fe den_inv = fe_select(rotate, fe_mul(den1, fe_const_invsqrt_a_minus_d()), den2);
  y = fe_select(fe_is_negative(fe_mul(x, z_inv)), fe_neg(y), y);
  return fe_canon(fe_cabs(fe_mul(den_inv, fe_sub(p.z, y))));
}

// Ristretto decode (RFC 9496 4.3.1) of the field element s, the formula of
// the TPU package's _decompress_kernel and kernels.decompress_ref. Returns
// the validity: the ratio was square, t >= 0, y != 0 and s >= 0, each sign
// and zero test on the canonical value, so that any s below 2^256 gives the
// mask of s mod p. Whether the byte encoding is canonical (s < p) is the
// caller's check on the raw bytes. z is canonical 1; x, y and t are weakly
// reduced.
ROFL_HD bool ristretto_decompress(const fe &s, ge &out) {
  const fe one = fe_one();
  const fe ss = fe_sqr(s);
  const fe u1 = fe_sub(one, ss);
  const fe u2 = fe_add(one, ss);
  const fe u2_sqr = fe_sqr(u2);
  const fe v = fe_sub(fe_neg(fe_mul(fe_const_d(), fe_sqr(u1))), u2_sqr);
  fe inv_sqrt;
  const bool was_square = fe_invsqrt(fe_mul(v, u2_sqr), inv_sqrt);
  const fe den_x = fe_mul(inv_sqrt, u2);
  const fe den_y = fe_mul(fe_mul(inv_sqrt, den_x), v);
  out.x = fe_cabs(fe_mul(fe_add(s, s), den_x));
  out.y = fe_mul(u1, den_y);
  out.z = one;
  out.t = fe_mul(out.x, out.y);
  return was_square && !fe_is_negative(out.t) && !fe_is_zero(out.y) && !fe_is_negative(s);
}

// -- signed digits --------------------------------------------------------

// A scalar k < 2^256 as W = ceil(257 / C) signed base-2^C digits,
// k = sum_i d_i 2^(C i): d_i in [-2^(C-1), 2^(C-1)) for i < W - 1 and the
// top digit, which takes the last carry, in [0, 2^(C-1)]. Computed as
// k' = k + h (2^0 + 2^C + ... + 2^(C (W-2))) with h = 2^(C-1), then
// d_i = (C-bit chunk i of k') - h below the top and d_(W-1) = k' >> C (W-1):
// one addition and shifts, no branch on k.
template <int C>
struct digits {
  static constexpr int count = (257 + C - 1) / C;
  static constexpr int half = 1 << (C - 1);
};

// k as 8 words from the (16, k_lanes) storage, lane k_lane.
ROFL_HD void scalar_load16(const int32_t *k, int64_t k_lanes, int64_t k_lane, uint32_t out[NW]) {
  ROFL_UNROLL
  for (int w = 0; w < NW; ++w) {
    out[w] = (uint32_t)k[(2 * w) * k_lanes + k_lane] |
             ((uint32_t)k[(2 * w + 1) * k_lanes + k_lane] << 16);
  }
}

// Bit `bit` of h (2^0 + 2^C + ... + 2^(C (W-2))), the recoding's offset.
template <int C>
ROFL_HD uint32_t recode_offset_bit(int bit) {
  return (bit % C == C - 1 && bit / C < digits<C>::count - 1) ? 1u : 0u;
}

// k' = k + offset as 9 words (word 8 holds the bits from 256 up).
template <int C>
ROFL_HD void recode_offset(const uint32_t k[NW], uint32_t kp[NW + 1]) {
  uint32_t carry = 0;
  ROFL_UNROLL
  for (int w = 0; w < NW; ++w) {
    uint32_t off = 0;
    ROFL_UNROLL
    for (int b = 0; b < 32; ++b) off |= recode_offset_bit<C>(32 * w + b) << b;
    kp[w] = add_carry(k[w], off, carry);
  }
  uint32_t top = 0;
  ROFL_UNROLL
  for (int b = 0; b < 32; ++b) top |= recode_offset_bit<C>(256 + b) << b;
  kp[NW] = top + carry;
}

// All W digits of k, digit i written to out[i * stride]. The loop is
// unrolled, so every index is a constant.
template <int C>
ROFL_HD void recode_signed(const uint32_t k[NW], int8_t *out, int64_t stride) {
  uint32_t kp[NW + 1];
  recode_offset<C>(k, kp);
  constexpr int W = digits<C>::count;
  ROFL_UNROLL
  for (int i = 0; i < W; ++i) {
    const int b = C * i;
    const uint64_t two =
        (uint64_t)kp[b >> 5] | ((b >> 5) < NW ? (uint64_t)kp[(b >> 5) + 1] << 32 : 0);
    const uint64_t bits = two >> (b & 31);
    out[i * stride] = (int8_t)(i == W - 1 ? (int)bits  // the top digit: every bit left
                                          : (int)(bits & ((1u << C) - 1u)) - digits<C>::half);
  }
}

// -- tables and buckets in shared memory ----------------------------------

// Entries of THREADS threads' points laid out [entry][word][thread]
// (x0..x7, y0..y7, z0..z7, t0..t7), so a warp's accesses to one word of one
// entry fall in 32 different banks. The ladders' tables and the MSM's
// buckets 1..2^(C-1) are such arrays.
ROFL_HD void ge_entry_put(uint32_t *sm, int threads, int tid, int entry, const ge &p) {
  uint32_t *base = sm + (int64_t)entry * POINT_WORDS * threads + tid;
  ROFL_UNROLL
  for (int w = 0; w < NW; ++w) {
    base[w * threads] = p.x.v[w];
    base[(NW + w) * threads] = p.y.v[w];
    base[(2 * NW + w) * threads] = p.z.v[w];
    base[(3 * NW + w) * threads] = p.t.v[w];
  }
}

ROFL_HD ge ge_entry_get(const uint32_t *sm, int threads, int tid, int entry) {
  const uint32_t *base = sm + (int64_t)entry * POINT_WORDS * threads + tid;
  ge p;
  ROFL_UNROLL
  for (int w = 0; w < NW; ++w) {
    p.x.v[w] = base[w * threads];
    p.y.v[w] = base[(NW + w) * threads];
    p.z.v[w] = base[(2 * NW + w) * threads];
    p.t.v[w] = base[(3 * NW + w) * threads];
  }
  return p;
}

// Entry mag - 1, or the identity for mag 0. Every entry is read and
// selected (dalek's LookupTable::select): the digits are of secret scalars,
// so no address or branch depends on one.
template <int ENTRIES>
ROFL_HD ge ge_entry_select(const uint32_t *sm, int threads, int tid, int mag) {
  ge r = ge_identity();
  ROFL_UNROLL
  for (int e = 0; e < ENTRIES; ++e) {
    r = ge_select(mag == e + 1, ge_entry_get(sm, threads, tid, e), r);
  }
  return r;
}

// |d| and whether d < 0, by arithmetic.
ROFL_HD int digit_magnitude(int d) { return (d ^ (d >> 31)) - (d >> 31); }
ROFL_HD bool digit_negative(int d) { return (d >> 31) != 0; }

// -- the per-lane ladders (csrc/scalar_mul.cu, csrc/scalar_mul_window.cu) -

// The ladder's window C, 2 or 4 (C divides 32, so a word of k holds 32 / C
// whole digits): a table of P, 2P, ..., 2^(C-1) P, and the recoding's
// offset within one word of k, bit C - 1 of every C bits set (0xAAAAAAAA at
// C = 2, 0x88888888 at C = 4).
template <int C>
struct ladder_window {
  static_assert(C == 2 || C == 4, "the ladder runs at C = 2 or 4");
  static constexpr int entries = digits<C>::half;
  static constexpr uint32_t word_offset = 0xFFFFFFFFu / ((1u << C) - 1u) << (C - 1);
};

// Table of P, 2P, ..., 2^(C-1) P, entry e holding (e + 1) P: one doubling
// at C = 2; four doublings and three additions at C = 4.
template <int C>
ROFL_HD void ladder_table(uint32_t *sm, int threads, int tid, const ge &p) {
  if constexpr (C == 2) {
    ge_entry_put(sm, threads, tid, 0, p);
    ge_entry_put(sm, threads, tid, 1, ge_double(p));
  } else {
    const ge m2 = ge_double(p);
    const ge m3 = ge_add(m2, p);
    const ge m4 = ge_double(m2);
    const ge m6 = ge_double(m3);
    ge_entry_put(sm, threads, tid, 0, p);
    ge_entry_put(sm, threads, tid, 1, m2);
    ge_entry_put(sm, threads, tid, 2, m3);
    ge_entry_put(sm, threads, tid, 3, m4);
    ge_entry_put(sm, threads, tid, 4, ge_add(m4, p));
    ge_entry_put(sm, threads, tid, 5, m6);
    ge_entry_put(sm, threads, tid, 6, ge_add(m6, p));
    ge_entry_put(sm, threads, tid, 7, ge_double(m4));
  }
}

// k * P for one lane, k from the (16, k_lanes) storage (any 256-bit value),
// by signed C-bit windows: the table, then the ceil(257 / C) signed digits
// of k from the top: the top digit (0 or 1) selects the start, then C
// doublings (T only on the last) and one add of the selected multiple a
// digit (256 doublings and 256 / C adds in all). The digits are made a word
// at a time as the loop reaches it: k' = k + offset (recode_offset<C>, each
// word's carry in from below kept in a mask made first), digit = C-bit
// chunk of k' less 2^(C-1); the top digit is the carry out of k', 0 or 1.
// The words of k are read from global memory by a loop counter, never from
// a register array indexed by one.
template <int C>
ROFL_HD ge ladder_scalar_mul(const int32_t *k, int64_t k_lanes, int64_t k_lane, uint32_t *sm,
                             int threads, int tid, const ge &p) {
  constexpr int H = ladder_window<C>::entries;
  constexpr uint32_t OFFSET = ladder_window<C>::word_offset;
  ladder_table<C>(sm, threads, tid, p);
  uint32_t kw[NW], kp[NW + 1];
  scalar_load16(k, k_lanes, k_lane, kw);
  recode_offset<C>(kw, kp);
  uint32_t carry_in = 0;  // bit w: the carry into word w of k + offset
  ROFL_UNROLL
  for (int w = 1; w < NW; ++w) carry_in |= (kp[w] - kw[w] - OFFSET) << w;
  ge acc = ge_entry_select<H>(sm, threads, tid, (int)kp[NW]);
  ROFL_NO_UNROLL
  for (int w = NW - 1; w >= 0; --w) {
    const uint32_t lo = (uint32_t)k[(2 * w) * k_lanes + k_lane];
    const uint32_t hi = (uint32_t)k[(2 * w + 1) * k_lanes + k_lane];
    const uint32_t shifted = (lo | (hi << 16)) + OFFSET + ((carry_in >> w) & 1u);
    ROFL_NO_UNROLL
    for (int j = 32 / C - 1; j >= 0; --j) {
      ROFL_UNROLL
      for (int i = 0; i < C; ++i) acc = ge_double(acc, i == C - 1);
      const int digit = (int)((shifted >> (C * j)) & ((1u << C) - 1u)) - H;
      acc = ge_add(acc, ge_cneg(digit_negative(digit),
                                ge_entry_select<H>(sm, threads, tid, digit_magnitude(digit))));
    }
  }
  return acc;
}

// -- the shared-scalar ladder (csrc/shared_scalar_mul.cu) -----------------

// One public scalar k < 2^256 as its width-5 NAF, made on the host
// (rofl_tpu_torch/ops/kernels.py naf_digits) and passed to the kernel by
// value: k = sum d[i] 2^i over i < count, each d[i] 0 or odd in [-15, 15],
// no two nonzero digits within 5 places, d[count - 1] nonzero (count 0 for
// k = 0).
constexpr int NAF_WIDTH = 5;
constexpr int NAF_MAX_DIGITS = 257;
constexpr int NAF_ENTRIES = 1 << (NAF_WIDTH - 2);  // P, 3P, ..., 15P

struct naf_scalar {
  int32_t count;
  int8_t d[NAF_MAX_DIGITS];
};

// Table of the odd multiples P, 3P, ..., 15P, entry e holding (2e + 1) P:
// one doubling and seven additions.
ROFL_HD void naf_table(uint32_t *sm, int threads, int tid, const ge &p) {
  const ge p2 = ge_double(p);
  ge m = p;
  ge_entry_put(sm, threads, tid, 0, m);
  ROFL_NO_UNROLL
  for (int e = 1; e < NAF_ENTRIES; ++e) {
    m = ge_add(m, p2);
    ge_entry_put(sm, threads, tid, e, m);
  }
}

// d P for a nonzero digit d: entry |d| >> 1, negated where d < 0.
ROFL_HD ge naf_entry(const uint32_t *sm, int threads, int tid, int d) {
  return ge_cneg(digit_negative(d), ge_entry_get(sm, threads, tid, digit_magnitude(d) >> 1));
}

// k * P from the top digit down: the top digit's entry, then a doubling a
// digit and, on a nonzero digit, one addition of its entry. Every lane reads
// the same digit, so each branch is taken by a whole warp or by none of it,
// and the table is read at the digit's own entry: k is public, and the run
// time follows the weight of its NAF. A doubling that another doubling
// follows leaves T out. k = 0 gives the identity, k = 1 the entry P.
ROFL_HD ge naf_scalar_mul(const naf_scalar &k, uint32_t *sm, int threads, int tid, const ge &p) {
  naf_table(sm, threads, tid, p);
  if (k.count == 0) return ge_identity();
  ge acc = naf_entry(sm, threads, tid, k.d[k.count - 1]);
  ROFL_NO_UNROLL
  for (int i = k.count - 2; i >= 0; --i) {
    const int d = k.d[i];
    if (d == 0 && i > 0) {
      acc = ge_double(acc, false);
      continue;
    }
    acc = ge_double(acc, true);
    if (d != 0) acc = ge_add(acc, naf_entry(sm, threads, tid, d));
  }
  return acc;
}

// -- the MSM (csrc/msm.cu) ------------------------------------------------

// The MSM's window c: 3, so 4 buckets a thread and 86 windows. On an H100,
// c = 3 ran 16 x 65 536 terms faster than c = 4 and 5, whose buckets and
// unrolled scans need more registers and spill (rofl_tpu_torch/tune_kernels.py
// builds msm.cu with ROFL_MSM_C set to each and times them; PERF.md).
#ifndef ROFL_MSM_C
#define ROFL_MSM_C 3
#endif
constexpr int MSM_C = ROFL_MSM_C;

// Where a block of the MSM's bucket launch works: blocks are numbered
// (group, slice, window) with the window fastest, so the windows of one
// slice run side by side and read the same points. A group of `group`
// terms is cut into `slices` runs of ceil(group / slices) terms.
struct msm_block {
  int64_t group_index, first, last;  // terms [first, last) of the flat array
  int slice, window;
};

ROFL_HD msm_block msm_block_of(int64_t block, int windows, int slices, int64_t group) {
  msm_block b;
  b.window = (int)(block % windows);
  b.slice = (int)((block / windows) % slices);
  b.group_index = block / ((int64_t)windows * slices);
  const int64_t run = (group + slices - 1) / slices;
  const int64_t lo = b.slice * run;
  const int64_t hi = lo + run < group ? lo + run : group;
  b.first = b.group_index * group + (lo < group ? lo : group);
  b.last = b.group_index * group + hi;
  return b;
}

// One thread's terms of a block (first + tid, first + tid + threads, ...
// below last) into its private buckets 1..2^(C-1), entries 0..2^(C-1)-1 of
// its column of sm: for a term with digit d, bucket |d| += sign(d) P. Every
// bucket is read and selected, one complete addition is made, and every
// bucket is written back through a select, so neither an address nor a
// branch depends on d (d = 0 adds to no bucket). digits points at this
// window's row; digit_step is 1, or 0 for one scalar for every term.
template <int C>
ROFL_HD void msm_thread_terms(uint32_t *sm, int threads, int tid, const int8_t *digits_row,
                              int64_t digit_step, const int32_t *px, const int32_t *py,
                              const int32_t *pz, const int32_t *pt, int64_t n, int64_t first,
                              int64_t last) {
  constexpr int H = digits<C>::half;
  ROFL_UNROLL
  for (int e = 0; e < H; ++e) ge_entry_put(sm, threads, tid, e, ge_identity());
  ROFL_NO_UNROLL
  for (int64_t i = first + tid; i < last; i += threads) {
    const int digit = digits_row[i * digit_step];
    const int mag = digit_magnitude(digit);
    const ge p = ge_cneg(digit_negative(digit), ge_load16(px, py, pz, pt, n, i));
    const ge sum = ge_add(ge_entry_select<H>(sm, threads, tid, mag), p);
    ROFL_UNROLL
    for (int e = 0; e < H; ++e) {
      ge_entry_put(sm, threads, tid, e,
                   ge_select(mag == e + 1, sum, ge_entry_get(sm, threads, tid, e)));
    }
  }
}

// One level of the block's tree over its threads' buckets: bucket e of
// thread u += bucket e of thread u + stride, for u < stride, the
// stride * 2^(C-1) additions shared out over the threads. The levels run
// from threads / 2 down to 1, a barrier between them; then thread 0's
// column holds the block's buckets.
template <int C>
ROFL_HD void msm_tree_level(uint32_t *sm, int threads, int tid, int stride) {
  constexpr int H = digits<C>::half;
  ROFL_NO_UNROLL
  for (int item = tid; item < stride * H; item += threads) {
    const int u = item % stride;
    const int e = item / stride;
    ge_entry_put(sm, threads, u, e,
                 ge_add(ge_entry_get(sm, threads, u, e), ge_entry_get(sm, threads, u + stride, e)));
  }
}

// The window's partial sum_j j B_j over thread 0's buckets, as a running
// sum from the top bucket down: 2 (2^(C-1) - 1) additions.
template <int C>
ROFL_HD ge msm_running_sum(const uint32_t *sm, int threads) {
  constexpr int H = digits<C>::half;
  ge running = ge_entry_get(sm, threads, 0, H - 1);
  ge total = running;
  ROFL_NO_UNROLL
  for (int e = H - 2; e >= 0; --e) {
    running = ge_add(running, ge_entry_get(sm, threads, 0, e));
    total = ge_add(total, running);
  }
  return total;
}

// A block's partial, 32 words at partials[block * 32].
ROFL_HD void ge_put_words(uint32_t *dst, const ge &p) {
  ROFL_UNROLL
  for (int w = 0; w < NW; ++w) {
    dst[w] = p.x.v[w];
    dst[NW + w] = p.y.v[w];
    dst[2 * NW + w] = p.z.v[w];
    dst[3 * NW + w] = p.t.v[w];
  }
}

ROFL_HD ge ge_get_words(const uint32_t *src) {
  ge p;
  ROFL_UNROLL
  for (int w = 0; w < NW; ++w) {
    p.x.v[w] = src[w];
    p.y.v[w] = src[NW + w];
    p.z.v[w] = src[2 * NW + w];
    p.t.v[w] = src[3 * NW + w];
  }
  return p;
}

// Window `window` of group g: the sum of its slices' partials.
ROFL_HD ge msm_window_sum(const uint32_t *partials, int64_t g, int window, int windows,
                          int slices) {
  ge acc = ge_identity();
  ROFL_NO_UNROLL
  for (int s = 0; s < slices; ++s) {
    const int64_t block = (g * slices + s) * windows + window;
    acc = ge_add(acc, ge_get_words(partials + block * POINT_WORDS));
  }
  return acc;
}

// sum_w 2^(C w) S_w over the window sums (32 words each, window w at
// sums[w * 32]) by Horner from the top window: C doublings and one add a
// window.
template <int C>
ROFL_HD ge msm_horner(const uint32_t *sums) {
  constexpr int W = digits<C>::count;
  ge acc = ge_get_words(sums + (W - 1) * POINT_WORDS);
  ROFL_NO_UNROLL
  for (int w = W - 2; w >= 0; --w) {
    ROFL_NO_UNROLL
    for (int i = 0; i < C; ++i) acc = ge_double(acc, i == C - 1);
    acc = ge_add(acc, ge_get_words(sums + w * POINT_WORDS));
  }
  return acc;
}

}  // namespace rofl32
