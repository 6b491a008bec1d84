// point_add: batched unified extended-Edwards addition, one lane per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _add_kernel / point_add.
// Work per lane: 768 bytes moved (8 coordinates of 64 bytes read, 4
// written) and 9 field products. On 8 limbs of 32 bits (fe25519_32.cuh) a
// product is 64 wide multiplies, each a low and a high 32-bit multiply-add:
// 9 x 128 multiply-adds, 2 304 operations a lane, 3.4 us of the H100's
// 33.5 TOP/s of int32 at N = 50 000 against 11.5 us for the bytes at
// 3.35 TB/s. So the memory bounds it. (On 16 limbs of 16 bits a product was
// 256 wide multiply-adds, 13.8 us at N = 50 000, above the byte bound
// before the column folds and carries were counted.)
//
// Design: every limb load and store is coalesced across the warp (the
// port's (16, N) limb-major layout, two 16-bit limbs packed into a word on
// the way in and split on the way out); everything in between stays in
// registers. __launch_bounds__ asks for 4 blocks of 128 threads an SM, at
// most 128 registers a thread, so the 391 blocks of N = 50 000 run in one
// wave of the 132 SMs. Either operand may be a single broadcast lane
// ((16, 1) coordinates, read with stride 1 at lane 0), which BSGS uses to
// add one -mG to every lane. Lane indices are 64-bit: the verifiers launch
// up to 200 000 lanes, and a limb's offset is limb * N + lane.
#include <cuda_runtime.h>

#include "fe25519_32.cuh"

using namespace rofl32;

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS_PER_SM = 4;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
point_add_kernel(const int32_t *__restrict__ px, const int32_t *__restrict__ py,
                 const int32_t *__restrict__ pz, const int32_t *__restrict__ pt, int p_lanes,
                 const int32_t *__restrict__ qx, const int32_t *__restrict__ qy,
                 const int32_t *__restrict__ qz, const int32_t *__restrict__ qt, int q_lanes,
                 int32_t *__restrict__ ox, int32_t *__restrict__ oy, int32_t *__restrict__ oz,
                 int32_t *__restrict__ ot, int n) {
  const int64_t lane = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  const ge p = ge_load16(px, py, pz, pt, p_lanes, p_lanes == 1 ? 0 : lane);
  const ge q = ge_load16(qx, qy, qz, qt, q_lanes, q_lanes == 1 ? 0 : lane);
  ge_store16(ox, oy, oz, ot, n, lane, ge_add(p, q));
}

}  // namespace

// p_lanes and q_lanes are each n or 1 (broadcast). Returns cudaGetLastError().
extern "C" int rofl_point_add(const int32_t *px, const int32_t *py, const int32_t *pz,
                              const int32_t *pt, int p_lanes, const int32_t *qx,
                              const int32_t *qy, const int32_t *qz, const int32_t *qt,
                              int q_lanes, int32_t *ox, int32_t *oy, int32_t *oz,
                              int32_t *ot, int n, void *stream) {
  if (n < 1 || (p_lanes != n && p_lanes != 1) || (q_lanes != n && q_lanes != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const int blocks = (n + THREADS - 1) / THREADS;
  point_add_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      px, py, pz, pt, p_lanes, qx, qy, qz, qt, q_lanes, ox, oy, oz, ot, n);
  return (int)cudaGetLastError();
}
