// Ristretto255 point arithmetic for one lane per CUDA thread, on top of
// fe25519.cuh: extended twisted-Edwards coordinates (X:Y:Z:T), a = -1.
// Same formulas as the TPU package's p_add / p_double / _compress_kernel /
// _decompress_kernel / _scalar_mul_kernel (rofl_tpu/ops/kernels.py) and the plain versions in
// rofl_tpu_torch/ops/kernels.py.
#pragma once

#include "fe25519.cuh"

namespace rofl {

struct ge {
  fe x, y, z, t;
};

// A coordinate is a (16, N) array, limb-major: limb k of lane n sits at
// base[k * n_lanes + n], so a warp reads 32 neighbouring words per limb.
// A broadcast operand is (16, 1): pass n_lanes = 1 and lane = 0.
ROFL_HD fe fe_load(const int32_t *base, int64_t n_lanes, int64_t lane) {
  fe r;
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) r.v[k] = (uint32_t)base[k * n_lanes + lane];
  return r;
}

ROFL_HD void fe_store(int32_t *base, int64_t n_lanes, int64_t lane, const fe &a) {
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) base[k * n_lanes + lane] = (int32_t)a.v[k];
}

// Unified extended addition add-2008-hwcd-3, a = -1: complete, so identity
// and doubling inputs need no branch.
ROFL_HD ge ge_add(const ge &p, const ge &q) {
  fe a = fe_mul(fe_sub(p.y, p.x), fe_sub(q.y, q.x));
  fe b = fe_mul(fe_add(p.y, p.x), fe_add(q.y, q.x));
  fe c = fe_mul(fe_mul(p.t, fe_const_d2()), q.t);
  fe d = fe_mul_small(fe_mul(p.z, q.z), 2);
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

ROFL_HD ge ge_double(const ge &p) {
  fe a = fe_sqr(p.x);
  fe b = fe_sqr(p.y);
  fe c = fe_mul_small(fe_sqr(p.z), 2);
  fe d = fe_neg(a);
  fe e = fe_sub(fe_sub(fe_sqr(fe_add(p.x, p.y)), a), b);
  fe g = fe_add(d, b);
  fe f = fe_sub(g, c);
  fe h = fe_sub(d, b);
  ge r;
  r.x = fe_mul(e, f);
  r.y = fe_mul(g, h);
  r.z = fe_mul(f, g);
  r.t = fe_mul(e, h);
  return r;
}

ROFL_HD ge ge_identity() {
  ge r;
  r.x = fe_zero();
  r.y = fe_one();
  r.z = fe_one();
  r.t = fe_zero();
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

// One step of the double-and-add ladder, most significant bit first:
// acc = 2 acc, then acc + p where the bit is set. The add is always computed
// and the result selected, so neither control flow nor the sequence of
// operations depends on the (possibly secret) bit.
ROFL_HD ge ge_ladder_step(const ge &acc, const ge &p, bool bit) {
  ge doubled = ge_double(acc);
  return ge_select(bit, ge_add(doubled, p), doubled);
}

// Ristretto encode (RFC 9496 4.3.2) -> canonical limbs.
ROFL_HD fe ristretto_compress(const ge &p) {
  fe u1 = fe_mul(fe_add(p.z, p.y), fe_sub(p.z, p.y));
  fe u2 = fe_mul(p.x, p.y);
  fe inv_sqrt;
  fe_sqrt_ratio_m1(fe_one(), fe_mul(u1, fe_sqr(u2)), inv_sqrt);
  fe den1 = fe_mul(inv_sqrt, u1);
  fe den2 = fe_mul(inv_sqrt, u2);
  fe z_inv = fe_mul(fe_mul(den1, den2), p.t);
  fe sqrt_m1 = fe_const_sqrt_m1();
  fe ix0 = fe_mul(p.x, sqrt_m1);
  fe iy0 = fe_mul(p.y, sqrt_m1);
  fe enchanted = fe_mul(den1, fe_const_invsqrt_a_minus_d());
  bool rotate = fe_is_negative(fe_mul(p.t, z_inv));
  fe x = fe_select(rotate, iy0, p.x);
  fe y = fe_select(rotate, ix0, p.y);
  fe den_inv = fe_select(rotate, enchanted, den2);
  y = fe_select(fe_is_negative(fe_mul(x, z_inv)), fe_neg(y), y);
  fe s = fe_cabs(fe_mul(den_inv, fe_sub(p.z, y)));
  return fe_canon(s);
}

// Ristretto decode (RFC 9496 4.3.1) from field limbs s. Returns validity:
// the ratio was square, t >= 0, y != 0, s >= 0. Canonicality of the byte
// encoding (s < p) is the caller's check on the raw bytes. z is canonical 1.
ROFL_HD bool ristretto_decompress(const fe &s, ge &out) {
  fe ss = fe_sqr(s);
  fe one = fe_one();
  fe u1 = fe_sub(one, ss);
  fe u2 = fe_add(one, ss);
  fe u2_sqr = fe_sqr(u2);
  fe v = fe_sub(fe_neg(fe_mul(fe_const_d(), fe_sqr(u1))), u2_sqr);
  fe inv_sqrt;
  bool was_square = fe_sqrt_ratio_m1(one, fe_mul(v, u2_sqr), inv_sqrt);
  fe den_x = fe_mul(inv_sqrt, u2);
  fe den_y = fe_mul(fe_mul(inv_sqrt, den_x), v);
  out.x = fe_cabs(fe_mul(fe_mul_small(s, 2), den_x));
  out.y = fe_mul(u1, den_y);
  out.z = one;
  out.t = fe_mul(out.x, out.y);
  return was_square && !fe_is_negative(out.t) && !fe_is_zero(out.y) &&
         !fe_is_negative(s);
}

}  // namespace rofl
