// Host build of the device headers: the same field and point arithmetic the
// CUDA kernels run, compiled as plain C++ with a C interface, so that a test
// without a card can hold it against the spec. Build:
//   g++ -O1 -shared -fPIC -x c++ -o libhost_check.so host_check.cpp
// Arrays are (16, n) int32, limb-major, exactly as the kernels take them.
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

// The ladder of csrc/scalar_mul.cu: 256 steps from bit 255 down to bit 0 of
// the scalar's 16 limbs. k_lanes is n or 1.
void host_scalar_mul(const int32_t *k, int k_lanes, const int32_t *px, const int32_t *py,
                     const int32_t *pz, const int32_t *pt, int32_t *ox, int32_t *oy,
                     int32_t *oz, int32_t *ot, int n) {
  for (int lane = 0; lane < n; ++lane) {
    ge p = load_point(px, py, pz, pt, n, lane);
    ge acc = ge_identity();
    for (int limb = NLIMB - 1; limb >= 0; --limb) {
      uint32_t word = (uint32_t)k[(int64_t)limb * k_lanes + (k_lanes == 1 ? 0 : lane)];
      for (int bit = 15; bit >= 0; --bit) {
        acc = ge_ladder_step(acc, p, ((word >> bit) & 1u) != 0);
      }
    }
    store_point(ox, oy, oz, ot, n, lane, acc);
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

// The grid of csrc/msm.cu with `threads` threads a block, run block by
// block and thread by thread: each thread's ge_msm_lanes, then the block's
// halving tree (threads a power of two). Writes the partial sums, (16,
// n_out) with n_out = (n / group) * ceil(group / (threads * per_thread)).
void host_msm(const int32_t *k, int k_lanes, const int32_t *px, const int32_t *py,
              const int32_t *pz, const int32_t *pt, int n, int group, int per_thread,
              int threads, int32_t *ox, int32_t *oy, int32_t *oz, int32_t *ot) {
  const int lanes_per_block = threads * per_thread;
  const int blocks_per_group = (group + lanes_per_block - 1) / lanes_per_block;
  const int n_out = (n / group) * blocks_per_group;
  ge red[1024];
  for (int block = 0; block < n_out; ++block) {
    for (int tid = 0; tid < threads; ++tid) {
      msm_lanes mine = msm_thread_lanes(block, tid, threads, group, per_thread, blocks_per_group);
      red[tid] = ge_msm_lanes(k, k_lanes, px, py, pz, pt, n, mine.first, threads, mine.count,
                              [](const ge &a, const ge &b) { return ge_add(a, b); },
                              [](const ge &a) { return ge_double(a); });
    }
    for (int stride = threads / 2; stride > 0; stride >>= 1) {
      for (int tid = 0; tid < stride; ++tid) red[tid] = ge_add(red[tid], red[tid + stride]);
    }
    store_point(ox, oy, oz, ot, n_out, block, red[0]);
  }
}

}  // extern "C"
