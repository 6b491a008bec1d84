// scalar_mul: k * P per lane for a variable base P, one lane per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _scalar_mul_kernel /
// scalar_mul (its default, one bit a step). Work per lane: 256 ladder steps,
// each one doubling and one unified add (4 products + 4 squarings, 9
// products), about 500 000 32-bit multiply-adds counted at 128 a product,
// against 576 bytes moved: bound by the integer units on an H100, by three
// orders of magnitude.
//
// Design. The ladder runs from the most significant bit down
// (acc = 2 acc; acc = bit ? acc + P : acc), so P is only read: the live
// state in registers is the accumulator alone (64 words) and the
// temporaries of one doubling or one add, not two points. P waits in shared
// memory, limb-major over the block's threads ([word][thread], so a warp's
// reads of one word fall into 32 different banks): 64 words x 64 threads x
// 4 B = 16 KB a block. The scalar is read one 16-bit limb at a time from
// global memory (a coalesced load every 16 steps), so no register array is
// indexed by the loop counter. The add is always computed and the result
// selected: no branch and no memory address depends on a bit of k, which is
// a secret in the provers (m'). The loops are rolled: one copy of the
// doubling and of the add in the code. The TPU kernel runs least significant
// bit first with a doubling addend; both orders give the same group element,
// in another projective representation.
//
// k may be a single broadcast lane ((16, 1)), read with stride 0. The
// identity as P or as accumulator needs no special case: the addition law is
// complete.
#include <cuda_runtime.h>

#include "ge25519.cuh"

using namespace rofl;

namespace {

constexpr int THREADS = 64;
constexpr int POINT_WORDS = 4 * NLIMB;

__device__ __forceinline__ ge load_shared_point(const uint32_t (*sp)[THREADS], int tid) {
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

__global__ void __launch_bounds__(THREADS)
scalar_mul_kernel(const int32_t *k, int k_lanes, const int32_t *px, const int32_t *py,
                  const int32_t *pz, const int32_t *pt, int32_t *ox, int32_t *oy,
                  int32_t *oz, int32_t *ot, int n) {
  __shared__ uint32_t sp[POINT_WORDS][THREADS];
  int tid = threadIdx.x;
  int64_t lane = (int64_t)blockIdx.x * THREADS + tid;
  if (lane >= n) return;  // no block-wide barrier below: a thread reads only its own column
  ROFL_UNROLL
  for (int w = 0; w < NLIMB; ++w) {
    sp[w][tid] = (uint32_t)px[(int64_t)w * n + lane];
    sp[NLIMB + w][tid] = (uint32_t)py[(int64_t)w * n + lane];
    sp[2 * NLIMB + w][tid] = (uint32_t)pz[(int64_t)w * n + lane];
    sp[3 * NLIMB + w][tid] = (uint32_t)pt[(int64_t)w * n + lane];
  }
  int64_t kl = k_lanes == 1 ? 0 : lane;
  ge acc = ge_identity();
  ROFL_NO_UNROLL
  for (int limb = NLIMB - 1; limb >= 0; --limb) {
    uint32_t word = (uint32_t)k[(int64_t)limb * k_lanes + kl];
    ROFL_NO_UNROLL
    for (int bit = 15; bit >= 0; --bit) {
      acc = ge_ladder_step(acc, load_shared_point(sp, tid), ((word >> bit) & 1u) != 0);
    }
  }
  fe_store(ox, n, lane, acc.x);
  fe_store(oy, n, lane, acc.y);
  fe_store(oz, n, lane, acc.z);
  fe_store(ot, n, lane, acc.t);
}

}  // namespace

// k_lanes is n or 1 (broadcast). Returns cudaGetLastError().
extern "C" int rofl_scalar_mul(const int32_t *k, int k_lanes, const int32_t *px,
                               const int32_t *py, const int32_t *pz, const int32_t *pt,
                               int32_t *ox, int32_t *oy, int32_t *oz, int32_t *ot, int n,
                               void *stream) {
  int blocks = (n + THREADS - 1) / THREADS;
  scalar_mul_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      k, k_lanes, px, py, pz, pt, ox, oy, oz, ot, n);
  return (int)cudaGetLastError();
}
