// Ristretto255 point arithmetic for one lane per CUDA thread, on top of
// fe25519.cuh: extended twisted-Edwards coordinates (X:Y:Z:T), a = -1.
// Same formulas as the TPU package's p_add / p_double /
// _make_smul_window_kernel / _shared_mul_kernel (rofl_tpu/ops/kernels.py)
// and the plain versions in rofl_tpu_torch/ops/kernels.py, under
// csrc/shared_scalar_mul.cu and csrc/scalar_mul_window.cu. The other point
// kernels use the same formulas on 32-bit limbs (fe25519_32.cuh).
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

// A block's points in shared memory, limb-major over its THREADS threads:
// sp[word][thread] with words x0..x15, y0..y15, z0..z15, t0..t15, so a warp's
// reads of one word fall into 32 different banks. The ladder of
// csrc/shared_scalar_mul.cu keeps P there, which leaves registers for the
// accumulator and the formulas' temporaries.
template <int THREADS>
ROFL_HD void ge_store_columns(uint32_t (*sp)[THREADS], int tid, const ge &p) {
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) {
    sp[k][tid] = p.x.v[k];
    sp[NLIMB + k][tid] = p.y.v[k];
    sp[2 * NLIMB + k][tid] = p.z.v[k];
    sp[3 * NLIMB + k][tid] = p.t.v[k];
  }
}

template <int THREADS>
ROFL_HD ge ge_load_columns(const uint32_t (*sp)[THREADS], int tid) {
  ge p;
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) {
    p.x.v[k] = sp[k][tid];
    p.y.v[k] = sp[NLIMB + k][tid];
    p.z.v[k] = sp[2 * NLIMB + k][tid];
    p.t.v[k] = sp[3 * NLIMB + k][tid];
  }
  return p;
}

// One scalar for every lane (csrc/shared_scalar_mul.cu), passed by value:
// the 16 limbs of 16 bits, least significant first.
struct scalar16 {
  uint32_t v[NLIMB];
};

// One step of the shared-scalar ladder, most significant bit first:
// acc = 2 acc, then acc + p where the bit is set. The bit is the same for
// every lane, so the branch does not diverge; it skips the add on a zero bit
// and so runs in a time that depends on the scalar's Hamming weight.
ROFL_HD ge ge_shared_ladder_step(const ge &acc, const ge &p, bool bit) {
  ge doubled = ge_double(acc);
  return bit ? ge_add(doubled, p) : doubled;
}

// The table of the W-bit windowed ladder (csrc/scalar_mul_window.cu): a
// lane's 2^W multiples 0·P, 1·P, ..., (2^W - 1)·P in scratch memory of
// 2^W * 64 words a lane, laid out [entry][word][lane] (the words of each
// entry as the four (16, n) coordinates), so that a warp's accesses to one
// word of one entry are coalesced.
ROFL_HD void ge_table_store(int32_t *table, int64_t n, int64_t lane, int entry, const ge &p) {
  int32_t *base = table + (int64_t)entry * 4 * NLIMB * n;
  fe_store(base, n, lane, p.x);
  fe_store(base + NLIMB * n, n, lane, p.y);
  fe_store(base + 2 * NLIMB * n, n, lane, p.z);
  fe_store(base + 3 * NLIMB * n, n, lane, p.t);
}

ROFL_HD ge ge_table_load(const int32_t *table, int64_t n, int64_t lane, int entry) {
  const int32_t *base = table + (int64_t)entry * 4 * NLIMB * n;
  ge p;
  p.x = fe_load(base, n, lane);
  p.y = fe_load(base + NLIMB * n, n, lane);
  p.z = fe_load(base + 2 * NLIMB * n, n, lane);
  p.t = fe_load(base + 3 * NLIMB * n, n, lane);
  return p;
}

// The multiples as the TPU kernel builds them (_make_smul_window_kernel):
// M[0] = identity, M[1] = P, M[j] = 2 M[j/2] for even j, M[j-1] + P for odd j.
template <int W>
ROFL_HD void ge_window_precompute(int32_t *table, int64_t n, int64_t lane, const ge &p) {
  ge_table_store(table, n, lane, 0, ge_identity());
  ge_table_store(table, n, lane, 1, p);
  ROFL_NO_UNROLL
  for (int j = 2; j < (1 << W); ++j) {
    ge m = (j % 2 == 0)
               ? ge_double(ge_table_load(table, n, lane, j / 2))
               : ge_add(ge_table_load(table, n, lane, j - 1), ge_table_load(table, n, lane, 1));
    ge_table_store(table, n, lane, j, m);
  }
}

// M[digit], read as a select over every entry of the table: the digit is a
// window of a (possibly secret) scalar, so no address and no branch depends
// on it, as in the TPU kernel's select tree.
template <int W>
ROFL_HD ge ge_window_lookup(const int32_t *table, int64_t n, int64_t lane, uint32_t digit) {
  ge r = ge_table_load(table, n, lane, 0);
  ROFL_NO_UNROLL
  for (int j = 1; j < (1 << W); ++j) {
    r = ge_select(digit == (uint32_t)j, ge_table_load(table, n, lane, j), r);
  }
  return r;
}

// k * P for one lane by W-bit windows from the top: the multiples, then
// 256 / W windows of W doublings and one add of the looked-up multiple
// (always computed: M[0] is the identity). k is (16, k_lanes) limbs, this
// lane's scalar in column k_lane; W divides 16, so no window straddles two
// limbs.
template <int W>
ROFL_HD ge ge_scalar_mul_window(const int32_t *k, int64_t k_lanes, int64_t k_lane,
                                int32_t *table, int64_t n, int64_t lane, const ge &p) {
  ge_window_precompute<W>(table, n, lane, p);
  ge acc = ge_identity();
  ROFL_NO_UNROLL
  for (int wi = 256 / W - 1; wi >= 0; --wi) {
    const int b = wi * W;
    const uint32_t word = (uint32_t)k[(int64_t)(b >> 4) * k_lanes + k_lane];
    const uint32_t digit = (word >> (b & 15)) & ((1u << W) - 1u);
    ROFL_NO_UNROLL
    for (int i = 0; i < W; ++i) acc = ge_double(acc);
    acc = ge_add(acc, ge_window_lookup<W>(table, n, lane, digit));
  }
  return acc;
}

}  // namespace rofl
