// Host build of the device headers: the same field and point arithmetic the
// CUDA kernels run, compiled as plain C++ with a C interface, so that a test
// without a card can hold it against the spec. Build:
//   g++ -O1 -shared -fPIC -x c++ -o libhost_check.so host_check.cpp
// Arrays are (16, n) int32, limb-major, exactly as the kernels take them.
#include <cstddef>
#include <vector>

#include "fe25519_32.cuh"
#include "ge25519.cuh"
#include "sc25519.cuh"

using namespace rofl;

namespace {

ge load_point(const int32_t *x, const int32_t *y, const int32_t *z, const int32_t *t,
              int64_t n_lanes, int64_t lane) {
  ge p;
  p.x = fe_load(x, n_lanes, lane);
  p.y = fe_load(y, n_lanes, lane);
  p.z = fe_load(z, n_lanes, lane);
  p.t = fe_load(t, n_lanes, lane);
  return p;
}

void store_point(int32_t *x, int32_t *y, int32_t *z, int32_t *t, int64_t n_lanes,
                 int64_t lane, const ge &p) {
  fe_store(x, n_lanes, lane, p.x);
  fe_store(y, n_lanes, lane, p.y);
  fe_store(z, n_lanes, lane, p.z);
  fe_store(t, n_lanes, lane, p.t);
}

}  // namespace

extern "C" {

// op: 0 add, 1 sub, 2 mul, 3 sqr(a), 4 neg(a), 5 mul_small(a, 2), 6 canon(a),
// 7 inv(a), 8 pow_p58(a), 9 cabs(a), 10 sqrt_ratio_m1(a, b) with the
// was_square flag written to flag[lane].
void host_fe_op(int op, const int32_t *a, const int32_t *b, int32_t *out,
                int32_t *flag, int n) {
  for (int lane = 0; lane < n; ++lane) {
    fe x = fe_load(a, n, lane), y = fe_load(b, n, lane), r = fe_zero();
    int f = 0;
    switch (op) {
      case 0: r = fe_add(x, y); break;
      case 1: r = fe_sub(x, y); break;
      case 2: r = fe_mul(x, y); break;
      case 3: r = fe_sqr(x); break;
      case 4: r = fe_neg(x); break;
      case 5: r = fe_mul_small(x, 2); break;
      case 6: r = fe_canon(x); break;
      case 7: r = fe_inv(x); break;
      case 8: r = fe_pow_p58(x); break;
      case 9: r = fe_cabs(x); break;
      case 10: f = fe_sqrt_ratio_m1(x, y, r); break;
    }
    fe_store(out, n, lane, r);
    flag[lane] = f;
  }
}

void host_point_add(const int32_t *px, const int32_t *py, const int32_t *pz,
                    const int32_t *pt, int p_lanes, const int32_t *qx,
                    const int32_t *qy, const int32_t *qz, const int32_t *qt,
                    int q_lanes, int32_t *ox, int32_t *oy, int32_t *oz, int32_t *ot,
                    int n) {
  for (int lane = 0; lane < n; ++lane) {
    ge p = load_point(px, py, pz, pt, p_lanes, p_lanes == 1 ? 0 : lane);
    ge q = load_point(qx, qy, qz, qt, q_lanes, q_lanes == 1 ? 0 : lane);
    store_point(ox, oy, oz, ot, n, lane, ge_add(p, q));
  }
}

void host_point_double(const int32_t *px, const int32_t *py, const int32_t *pz,
                       const int32_t *pt, int32_t *ox, int32_t *oy, int32_t *oz,
                       int32_t *ot, int n) {
  for (int lane = 0; lane < n; ++lane) {
    store_point(ox, oy, oz, ot, n, lane, ge_double(load_point(px, py, pz, pt, n, lane)));
  }
}

void host_compress(const int32_t *px, const int32_t *py, const int32_t *pz,
                   const int32_t *pt, int32_t *out, int n) {
  for (int lane = 0; lane < n; ++lane) {
    fe_store(out, n, lane, ristretto_compress(load_point(px, py, pz, pt, n, lane)));
  }
}

void host_decompress(const int32_t *s, int32_t *ox, int32_t *oy, int32_t *oz,
                     int32_t *ot, uint8_t *valid, int n) {
  for (int lane = 0; lane < n; ++lane) {
    ge p;
    valid[lane] = ristretto_decompress(fe_load(s, n, lane), p) ? 1 : 0;
    store_point(ox, oy, oz, ot, n, lane, p);
  }
}

// bytes: (64, n) int32 byte columns; out: (16, n) int32 limbs.
void host_sc_reduce_wide(const int32_t *bytes, int32_t *out, int n) {
  for (int lane = 0; lane < n; ++lane) {
    uint32_t v[16], r[SC_WORDS];
    sc_load_wide_bytes(bytes, n, lane, v);
    sc_reduce_512(v, r);
    sc_store(out, n, lane, r);
  }
}

// op: 0 a * b, 1 a + b, 2 a - b (mod l). a_lanes and b_lanes are each n or 1
// (broadcast), as in the kernels.
void host_sc_op(int op, const int32_t *a, int a_lanes, const int32_t *b, int b_lanes,
                int32_t *out, int n) {
  for (int lane = 0; lane < n; ++lane) {
    uint32_t x[SC_WORDS], y[SC_WORDS], r[SC_WORDS];
    sc_load(a, a_lanes, a_lanes == 1 ? 0 : lane, x);
    sc_load(b, b_lanes, b_lanes == 1 ? 0 : lane, y);
    switch (op) {
      case 0: sc_mul(x, y, r); break;
      case 1: sc_add(x, y, r); break;
      default: sc_sub(x, y, r); break;
    }
    sc_store(out, n, lane, r);
  }
}

// csrc/scalar_mul.cu with `threads` threads a block (k_lanes n or 1): each
// thread's ladder_scalar_mul with its table in the block's shared-memory
// array, [entry][word][thread], as on the card.
void host_scalar_mul(const int32_t *k, int k_lanes, const int32_t *px, const int32_t *py,
                     const int32_t *pz, const int32_t *pt, int32_t *ox, int32_t *oy,
                     int32_t *oz, int32_t *ot, int n, int threads) {
  std::vector<uint32_t> sm((std::size_t)rofl32::LADDER_ENTRIES * rofl32::POINT_WORDS * threads);
  for (int lane = 0; lane < n; ++lane) {
    const int tid = lane % threads;
    rofl32::ge acc = rofl32::ladder_scalar_mul(k, k_lanes, k_lanes == 1 ? 0 : lane, sm.data(),
                                               threads, tid,
                                               rofl32::ge_load16(px, py, pz, pt, n, lane));
    rofl32::ge_store16(ox, oy, oz, ot, n, lane, acc);
  }
}

// The loop of csrc/shared_scalar_mul.cu: one scalar k (16 limbs) for every
// lane, 256 steps from bit 255 down, the add only on a set bit.
void host_shared_scalar_mul(const uint32_t *k, const int32_t *px, const int32_t *py,
                            const int32_t *pz, const int32_t *pt, int32_t *ox, int32_t *oy,
                            int32_t *oz, int32_t *ot, int n) {
  scalar16 ks;
  for (int i = 0; i < NLIMB; ++i) ks.v[i] = k[i];
  for (int lane = 0; lane < n; ++lane) {
    ge p = load_point(px, py, pz, pt, n, lane);
    ge acc = ge_identity();
    for (int limb = NLIMB - 1; limb >= 0; --limb) {
      for (int bit = 15; bit >= 0; --bit) {
        acc = ge_shared_ladder_step(acc, p, ((ks.v[limb] >> bit) & 1u) != 0);
      }
    }
    store_point(ox, oy, oz, ot, n, lane, acc);
  }
}

// The body of csrc/scalar_mul_window.cu for window 2 or 4 (anything else
// writes nothing and returns 1), with its scratch table of
// 2^window * 64 * n int32.
int host_scalar_mul_window(int window, const int32_t *k, int k_lanes, const int32_t *px,
                           const int32_t *py, const int32_t *pz, const int32_t *pt,
                           int32_t *table, int32_t *ox, int32_t *oy, int32_t *oz, int32_t *ot,
                           int n) {
  if (window != 2 && window != 4) return 1;
  for (int lane = 0; lane < n; ++lane) {
    ge p = load_point(px, py, pz, pt, n, lane);
    int64_t kl = k_lanes == 1 ? 0 : lane;
    ge acc = window == 2 ? ge_scalar_mul_window<2>(k, k_lanes, kl, table, n, lane, p)
                         : ge_scalar_mul_window<4>(k, k_lanes, kl, table, n, lane, p);
    store_point(ox, oy, oz, ot, n, lane, acc);
  }
  return 0;
}

// op on the 32-bit field of fe25519_32.cuh, operands and result in the
// (16, n) storage: 0 add, 1 sub, 2 mul, 3 sqr(a), 4 neg(a), 5 a as loaded
// and stored (the packing of two 16-bit limbs a word).
void host_fe32_op(int op, const int32_t *a, const int32_t *b, int32_t *out, int n) {
  namespace f = rofl32;
  for (int lane = 0; lane < n; ++lane) {
    f::fe x = f::fe_load16(a, n, lane), y = f::fe_load16(b, n, lane), r = x;
    switch (op) {
      case 0: r = f::fe_add(x, y); break;
      case 1: r = f::fe_sub(x, y); break;
      case 2: r = f::fe_mul(x, y); break;
      case 3: r = f::fe_sqr(x); break;
      case 4: r = f::fe_neg(x); break;
    }
    f::fe_store16(out, n, lane, r);
  }
}

// The recoding of csrc/msm.cu's first launch: the ceil(257 / MSM_C) signed
// digits of each of the n scalars of (16, n) k, digit i of scalar j at
// out[i * n + j].
void host_recode(const int32_t *k, int8_t *out, int n) {
  for (int lane = 0; lane < n; ++lane) {
    uint32_t kw[rofl32::NW];
    rofl32::scalar_load16(k, n, lane, kw);
    rofl32::recode_signed<rofl32::MSM_C>(kw, out + lane, n);
  }
}

// csrc/msm.cu's grid, the three launches with `threads` threads a block (a
// power of two) run block by block and, between the barriers, thread by
// thread: the n / group sums, (16, n / group) x4.
void host_msm(const int32_t *k, int k_lanes, const int32_t *px, const int32_t *py,
              const int32_t *pz, const int32_t *pt, int n, int group, int slices, int threads,
              int32_t *ox, int32_t *oy, int32_t *oz, int32_t *ot) {
  namespace f = rofl32;
  constexpr int C = f::MSM_C;
  constexpr int W = f::digits<C>::count;
  const int n_groups = n / group;
  std::vector<int8_t> digit_rows((std::size_t)W * k_lanes);
  for (int lane = 0; lane < k_lanes; ++lane) {
    uint32_t kw[f::NW];
    f::scalar_load16(k, k_lanes, lane, kw);
    f::recode_signed<C>(kw, digit_rows.data() + lane, k_lanes);
  }
  std::vector<uint32_t> partials((std::size_t)n_groups * slices * W * f::POINT_WORDS);
  std::vector<uint32_t> sm((std::size_t)f::digits<C>::half * f::POINT_WORDS * threads);
  for (int64_t block = 0; block < (int64_t)n_groups * slices * W; ++block) {
    const f::msm_block b = f::msm_block_of(block, W, slices, group);
    for (int tid = 0; tid < threads; ++tid) {
      f::msm_thread_terms<C>(sm.data(), threads, tid,
                             digit_rows.data() + (int64_t)b.window * k_lanes,
                             k_lanes == 1 ? 0 : 1, px, py, pz, pt, n, b.first, b.last);
    }
    for (int stride = threads / 2; stride > 0; stride >>= 1) {
      for (int tid = 0; tid < threads; ++tid) {
        f::msm_tree_level<C>(sm.data(), threads, tid, stride);
      }
    }
    f::ge_put_words(partials.data() + block * f::POINT_WORDS,
                    f::msm_running_sum<C>(sm.data(), threads));
  }
  std::vector<uint32_t> sums((std::size_t)W * f::POINT_WORDS);
  for (int g = 0; g < n_groups; ++g) {
    for (int w = 0; w < W; ++w) {
      f::ge_put_words(sums.data() + w * f::POINT_WORDS,
                      f::msm_window_sum(partials.data(), g, w, W, slices));
    }
    f::ge_store16(ox, oy, oz, ot, n_groups, g, f::msm_horner<C>(sums.data()));
  }
}

}  // extern "C"
