// GF(2^255-19) and Ristretto255 point arithmetic on 8 limbs of 32 bits, one
// lane per CUDA thread: the arithmetic under csrc/msm.cu and
// csrc/scalar_mul.cu.
//
// csrc/fe25519.cuh keeps 16 limbs of 16 bits, so a product there is 256
// 32x32->64-bit multiply-adds into 64-bit columns. Here a product is 64
// partial products of 32-bit limbs, each one wide multiply-add into a
// 32-bit limb with a 32-bit carry (operand scanning), and a squaring 36.
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

#ifndef ROFL_HD
#if defined(__CUDACC__)
#define ROFL_HD __host__ __device__ __forceinline__
#define ROFL_UNROLL _Pragma("unroll")
#define ROFL_NO_UNROLL _Pragma("unroll 1")
#else
#define ROFL_HD inline
#define ROFL_UNROLL
#define ROFL_NO_UNROLL
#endif
#endif

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

// Edwards 2d (spec/field.py D2).
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

// Unified extended addition add-2008-hwcd-3, a = -1, as in ge25519.cuh:
// complete, so identity and doubling inputs need no branch. 9 products.
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
// entry fall in 32 different banks. The ladder's table of P..8P and the
// MSM's buckets 1..2^(C-1) are such arrays; entry e holds multiple or bucket
// e + 1.
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

// -- the per-lane ladder (csrc/scalar_mul.cu) -----------------------------

constexpr int LADDER_ENTRIES = 8;  // P..8P

// Table of P, 2P, ..., 8P: four doublings and three additions.
ROFL_HD void ladder_table(uint32_t *sm, int threads, int tid, const ge &p) {
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

// k * P for one lane, k from the (16, k_lanes) storage (any 256-bit value):
// the table, then the 65 signed radix-16 digits of k from the top: the top
// digit (0 or 1) selects the start, then 4 doublings and one add of the
// selected multiple a digit (256 doublings and 64 adds in all). The digits
// are made a word at a time as the loop reaches it: k' = k + 0x88...8
// (recode_offset<4>, each word's carry in from below kept in a mask made
// first), digit = nibble of k' - 8; the top digit is the carry out of k',
// 0 or 1. The words of k are read from global memory
// by a loop counter, never from a register array indexed by one.
ROFL_HD ge ladder_scalar_mul(const int32_t *k, int64_t k_lanes, int64_t k_lane, uint32_t *sm,
                             int threads, int tid, const ge &p) {
  ladder_table(sm, threads, tid, p);
  uint32_t kw[NW], kp[NW + 1];
  scalar_load16(k, k_lanes, k_lane, kw);
  recode_offset<4>(kw, kp);
  uint32_t carry_in = 0;  // bit w: the carry into word w of k + 0x88...8
  ROFL_UNROLL
  for (int w = 1; w < NW; ++w) carry_in |= (kp[w] - kw[w] - 0x88888888u) << w;
  ge acc = ge_entry_select<LADDER_ENTRIES>(sm, threads, tid, (int)kp[NW]);
  ROFL_NO_UNROLL
  for (int w = NW - 1; w >= 0; --w) {
    const uint32_t lo = (uint32_t)k[(2 * w) * k_lanes + k_lane];
    const uint32_t hi = (uint32_t)k[(2 * w + 1) * k_lanes + k_lane];
    const uint32_t shifted = (lo | (hi << 16)) + 0x88888888u + ((carry_in >> w) & 1u);
    ROFL_NO_UNROLL
    for (int nib = 7; nib >= 0; --nib) {
      acc = ge_double(acc, false);
      acc = ge_double(acc, false);
      acc = ge_double(acc, false);
      acc = ge_double(acc, true);
      const int digit = (int)((shifted >> (4 * nib)) & 15u) - 8;
      acc = ge_add(acc, ge_cneg(digit_negative(digit),
                                ge_entry_select<LADDER_ENTRIES>(sm, threads, tid,
                                                                digit_magnitude(digit))));
    }
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
