// Arithmetic mod l = 2^252 + 27742317777372353535851937790883648493 (the
// order of the ristretto group) for one lane per CUDA thread.
//
// Device counterpart of rofl_tpu_torch/ops/sc.py and the replacement of the
// in-kernel scalar helpers of the TPU package (rofl_tpu/ops/kernels.py
// _s_reduce_512 and the folds under it).
//
// Representation inside a kernel: little-endian 32-bit words with 64-bit
// intermediates. Outside the kernels a scalar is 16 limbs of 16 bits, so a
// store splits each word in two.
//
// Reduction: 2^252 = -DELTA (mod l), DELTA < 2^125. One fold replaces
//   v = low + 2^252 * hi   by   low + (K*l - hi*DELTA),
// where K*l is a constant multiple of l chosen larger than hi*DELTA can be,
// so the value stays non-negative. Three folds take 512 bits to below 2l.
//
// The header also compiles as plain C++, so the arithmetic can be checked on
// a host without a card.
#pragma once

#include <stdint.h>

#include "rofl_hd.cuh"

namespace rofl {

constexpr int SC_WORDS = 8;

// One fold. v has NV words; hi = v >> 252 is known to fit NH words, and
// hi * DELTA (NH + 4 words) is known to be at most kl, which has NK words.
// out = (v mod 2^252) + kl - hi * DELTA, which fits NK words.
template <int NV, int NH, int NK>
ROFL_HD void sc_fold(const uint32_t (&v)[NV], const uint32_t (&kl)[NK],
                     uint32_t (&out)[NK]) {
  static_assert(NH + 4 <= NK && NK >= SC_WORDS && NV >= SC_WORDS, "fold sizes");
  const uint32_t delta[4] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu};
  uint32_t hi[NH];
  ROFL_UNROLL
  for (int k = 0; k < NH; ++k) {
    uint32_t lo_part = (7 + k < NV) ? (v[7 + k] >> 28) : 0u;
    uint32_t hi_part = (8 + k < NV) ? (v[8 + k] << 4) : 0u;
    hi[k] = lo_part | hi_part;
  }
  uint32_t prod[NK];
  ROFL_UNROLL
  for (int k = 0; k < NK; ++k) prod[k] = 0;
  ROFL_UNROLL
  for (int i = 0; i < NH; ++i) {
    uint64_t carry = 0;
    ROFL_UNROLL
    for (int j = 0; j < 4; ++j) {
      uint64_t t = (uint64_t)hi[i] * (uint64_t)delta[j] + prod[i + j] + carry;
      prod[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    prod[i + 4] = (uint32_t)carry;
  }
  uint64_t borrow = 0, carry = 0;
  ROFL_UNROLL
  for (int k = 0; k < NK; ++k) {
    uint64_t d = (uint64_t)kl[k] - prod[k] - borrow;
    borrow = (d >> 32) & 1u;
    uint32_t low = k < SC_WORDS - 1 ? v[k] : (k == SC_WORDS - 1 ? (v[k] & 0x0FFFFFFFu) : 0u);
    uint64_t s = (uint64_t)(uint32_t)d + low + carry;
    out[k] = (uint32_t)s;
    carry = s >> 32;
  }
}

// Subtract l once where the value is at least l.
ROFL_HD void sc_cond_sub_l(uint32_t (&a)[SC_WORDS]) {
  const uint32_t l[SC_WORDS] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
                                0u, 0u, 0u, 0x10000000u};
  uint32_t diff[SC_WORDS];
  uint64_t borrow = 0;
  ROFL_UNROLL
  for (int k = 0; k < SC_WORDS; ++k) {
    uint64_t d = (uint64_t)a[k] - l[k] - borrow;
    diff[k] = (uint32_t)d;
    borrow = (d >> 32) & 1u;
  }
  bool ge = borrow == 0;
  ROFL_UNROLL
  for (int k = 0; k < SC_WORDS; ++k) a[k] = ge ? diff[k] : a[k];
}

// A value below 2^512 as 16 words -> the canonical scalar as 8 words
// (Scalar::from_bytes_mod_order_wide). Bounds of the three folds:
//   v  < 2^512: hi < 2^260 (9 words), hi*DELTA < 2^385 <= 2^149 * l, v1 < 2^402
//   v1 < 2^402: hi < 2^150 (5 words), hi*DELTA < 2^275 <= 2^36 * l,  v2 < 2^290
//   v2 < 2^290: hi < 2^38  (2 words), hi*DELTA < 2^163 <= l,         v3 < 2l
ROFL_HD void sc_reduce_512(const uint32_t (&v)[16], uint32_t (&out)[SC_WORDS]) {
  const uint32_t k1[13] = {0u, 0u, 0u, 0u, 0x7da00000u, 0x634b9ebau, 0x9acb024cu,
                           0x3bd45ef3u, 0x00029bdfu, 0u, 0u, 0u, 0x00020000u};
  const uint32_t k2[10] = {0u, 0xcf5d3ed0u, 0x812631a5u, 0x2f79cd65u, 0x4def9deau,
                           0x00000001u, 0u, 0u, 0u, 0x00000001u};
  const uint32_t k3[SC_WORDS] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
                                 0u, 0u, 0u, 0x10000000u};
  uint32_t v1[13], v2[10];
  sc_fold<16, 9, 13>(v, k1, v1);
  sc_fold<13, 5, 10>(v1, k2, v2);
  sc_fold<10, 2, SC_WORDS>(v2, k3, out);
  sc_cond_sub_l(out);
  sc_cond_sub_l(out);
}

// a * b mod l for any two 256-bit values: schoolbook product of 8 x 8 words
// (64 wide multiplies, each added into the running 16-word product with a
// 64-bit carry; (2^32-1)^2 + 2(2^32-1) = 2^64-1, so no step overflows), then
// the wide reduction. Replaces the TPU package's s_mul.
ROFL_HD void sc_mul(const uint32_t (&a)[SC_WORDS], const uint32_t (&b)[SC_WORDS],
                    uint32_t (&out)[SC_WORDS]) {
  uint32_t prod[2 * SC_WORDS];
  ROFL_UNROLL
  for (int k = 0; k < 2 * SC_WORDS; ++k) prod[k] = 0;
  ROFL_UNROLL
  for (int i = 0; i < SC_WORDS; ++i) {
    uint64_t carry = 0;
    ROFL_UNROLL
    for (int j = 0; j < SC_WORDS; ++j) {
      uint64_t t = (uint64_t)a[i] * (uint64_t)b[j] + prod[i + j] + carry;
      prod[i + j] = (uint32_t)t;
      carry = t >> 32;
    }
    prod[i + SC_WORDS] = (uint32_t)carry;
  }
  sc_reduce_512(prod, out);
}

// a + b mod l for canonical a, b: the sum is below 2l < 2^254, so one
// conditional subtract finishes it. Replaces the TPU package's s_add.
ROFL_HD void sc_add(const uint32_t (&a)[SC_WORDS], const uint32_t (&b)[SC_WORDS],
                    uint32_t (&out)[SC_WORDS]) {
  uint64_t carry = 0;
  ROFL_UNROLL
  for (int k = 0; k < SC_WORDS; ++k) {
    uint64_t s = (uint64_t)a[k] + b[k] + carry;
    out[k] = (uint32_t)s;
    carry = s >> 32;
  }
  sc_cond_sub_l(out);
}

// a - b mod l for canonical a, b: subtract with borrow, then add l back where
// it borrowed (the wrap modulo 2^256 cancels). The TPU package's s_sub adds
// l - b and subtracts l twice; the canonical result is the same.
ROFL_HD void sc_sub(const uint32_t (&a)[SC_WORDS], const uint32_t (&b)[SC_WORDS],
                    uint32_t (&out)[SC_WORDS]) {
  const uint32_t l[SC_WORDS] = {0x5cf5d3edu, 0x5812631au, 0xa2f79cd6u, 0x14def9deu,
                                0u, 0u, 0u, 0x10000000u};
  uint64_t borrow = 0;
  ROFL_UNROLL
  for (int k = 0; k < SC_WORDS; ++k) {
    uint64_t d = (uint64_t)a[k] - b[k] - borrow;
    out[k] = (uint32_t)d;
    borrow = (d >> 32) & 1u;
  }
  uint32_t mask = borrow ? 0xFFFFFFFFu : 0u;
  uint64_t carry = 0;
  ROFL_UNROLL
  for (int k = 0; k < SC_WORDS; ++k) {
    uint64_t s = (uint64_t)out[k] + (l[k] & mask) + carry;
    out[k] = (uint32_t)s;
    carry = s >> 32;
  }
}

// The 16 limbs of 16 bits of one lane of a (16, n) array -> 8 words. A
// broadcast operand is (16, 1): pass n_lanes = 1 and lane = 0.
ROFL_HD void sc_load(const int32_t *base, int64_t n_lanes, int64_t lane,
                     uint32_t (&a)[SC_WORDS]) {
  ROFL_UNROLL
  for (int k = 0; k < SC_WORDS; ++k) {
    a[k] = (uint32_t)base[(int64_t)(2 * k) * n_lanes + lane] |
           ((uint32_t)base[(int64_t)(2 * k + 1) * n_lanes + lane] << 16);
  }
}

// 64 little-endian byte columns of one lane -> 16 words.
ROFL_HD void sc_load_wide_bytes(const int32_t *bytes, int64_t n_lanes, int64_t lane,
                                uint32_t (&v)[16]) {
  ROFL_UNROLL
  for (int k = 0; k < 16; ++k) {
    uint32_t w = 0;
    ROFL_UNROLL
    for (int b = 0; b < 4; ++b) {
      w |= (uint32_t)bytes[(int64_t)(4 * k + b) * n_lanes + lane] << (8 * b);
    }
    v[k] = w;
  }
}

// 8 words -> the 16 limbs of 16 bits of one lane of a (16, n) array.
ROFL_HD void sc_store(int32_t *out, int64_t n_lanes, int64_t lane,
                      const uint32_t (&a)[SC_WORDS]) {
  ROFL_UNROLL
  for (int k = 0; k < SC_WORDS; ++k) {
    out[(int64_t)(2 * k) * n_lanes + lane] = (int32_t)(a[k] & 0xFFFFu);
    out[(int64_t)(2 * k + 1) * n_lanes + lane] = (int32_t)(a[k] >> 16);
  }
}

}  // namespace rofl
