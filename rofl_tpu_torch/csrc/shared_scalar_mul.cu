// shared_scalar_mul: k * P_i for one scalar k shared by every lane, one lane
// per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _shared_mul_kernel /
// shared_scalar_mul (its own pallas_call). Work per lane: 256 doublings and
// one unified add for each set bit of k, popcount(k) of them (about 128 for
// a random scalar): some 280 000 32-bit multiply-adds counted at 128 a
// product, against 512 bytes moved; bound by the integer units on an H100.
//
// Design. The ladder runs from the most significant bit down
// (acc = 2 acc; acc = bit ? acc + P : acc), P read from shared memory as in
// csrc/scalar_mul.cu (16 KB a block of 64 threads). The scalar is one
// kernel argument, passed by value (struct scalar16), so every thread reads
// the same word and tests the same bit: the add is skipped on a zero bit
// with a branch that no warp diverges on, as the TPU kernel skips it through
// lax.cond. That costs what the TPU kernel costs, and it leaks what the TPU
// kernel leaks: the run time depends on the Hamming weight of k. Use it for
// public scalars (challenges); a secret scalar belongs in scalar_mul, which
// always adds and selects. The TPU kernel walks the bits from the bottom with
// a doubling addend; both orders give the same group element, in another
// projective representation. The identity as P needs no special case: the
// addition law is complete.
#include <cuda_runtime.h>

#include "ge25519.cuh"

using namespace rofl;

namespace {

constexpr int THREADS = 64;

__global__ void __launch_bounds__(THREADS)
shared_scalar_mul_kernel(scalar16 k, const int32_t *px, const int32_t *py, const int32_t *pz,
                         const int32_t *pt, int32_t *ox, int32_t *oy, int32_t *oz,
                         int32_t *ot, int n) {
  __shared__ uint32_t sp[4 * NLIMB][THREADS];
  int tid = threadIdx.x;
  int64_t lane = (int64_t)blockIdx.x * THREADS + tid;
  if (lane >= n) return;  // no block-wide barrier below: a thread reads only its own column
  ge p;
  p.x = fe_load(px, n, lane);
  p.y = fe_load(py, n, lane);
  p.z = fe_load(pz, n, lane);
  p.t = fe_load(pt, n, lane);
  ge_store_columns<THREADS>(sp, tid, p);
  ge acc = ge_identity();
  ROFL_NO_UNROLL
  for (int limb = NLIMB - 1; limb >= 0; --limb) {
    uint32_t word = k.v[limb];
    ROFL_NO_UNROLL
    for (int bit = 15; bit >= 0; --bit) {
      acc = ge_shared_ladder_step(acc, ge_load_columns<THREADS>(sp, tid), ((word >> bit) & 1u) != 0);
    }
  }
  fe_store(ox, n, lane, acc.x);
  fe_store(oy, n, lane, acc.y);
  fe_store(oz, n, lane, acc.z);
  fe_store(ot, n, lane, acc.t);
}

}  // namespace

// k: the scalar's 16 limbs in host memory, copied into the launch's
// arguments. Returns cudaGetLastError().
extern "C" int rofl_shared_scalar_mul(const uint32_t *k, const int32_t *px, const int32_t *py,
                                      const int32_t *pz, const int32_t *pt, int32_t *ox,
                                      int32_t *oy, int32_t *oz, int32_t *ot, int n,
                                      void *stream) {
  scalar16 ks;
  for (int i = 0; i < NLIMB; ++i) ks.v[i] = k[i];
  int blocks = (n + THREADS - 1) / THREADS;
  shared_scalar_mul_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      ks, px, py, pz, pt, ox, oy, oz, ot, n);
  return (int)cudaGetLastError();
}
