// scalar_mul: k * P per lane for a variable base P, one lane per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _scalar_mul_kernel /
// scalar_mul (its default, one bit a step). Bound on an H100: the integer
// units, by three orders of magnitude over the 576 bytes a lane moves; the
// cheapest schedule for a secret k is a signed 5-bit window, about 251 000
// 32-bit multiply-adds a lane, and this kernel's 4-bit one does 261 000.
//
// Design: a signed radix-16 ladder on 8 limbs of 32 bits (fe25519_32.cuh,
// ladder_scalar_mul, which compiles for the host too). Each lane recodes its
// k, any 256-bit value, into 64 signed digits in [-8, 8) and a top digit 0
// or 1 (k + 0x88...8, a nibble less 8), builds P, 2P, ..., 8P (four
// doublings, three additions) in shared memory, 1 KB a lane laid out
// [entry][word][thread], and runs from the top digit: 4 doublings, then one
// complete addition of the selected multiple. The selection reads all eight
// entries and selects, and negates by a select, as dalek's
// LookupTable::select does: the provers' scalars (m') are secret, so no
// branch and no memory address depends on a digit. 256 doublings and 64
// additions a lane (the top digit is a select), against the one-bit ladder's
// 256 of each; the first three doublings of each run leave T out. A block of
// THREADS = 64 threads holds 64 KB of table, so the table, not the
// registers, sets the blocks an SM holds: 3 in the H100's 228 KB. On an
// H100, 64 threads a block ran as fast as 32 and faster than 128
// (rofl_tpu_torch/tune_kernels.py builds this file with
// ROFL_LADDER_THREADS set to each and times them; PERF.md).
//
// k may be a single broadcast lane ((16, 1)), read with stride 0. The
// identity as P needs no special case: the addition law is complete.
#include <cuda_runtime.h>

#include "fe25519_32.cuh"

using namespace rofl32;

#ifndef ROFL_LADDER_THREADS
#define ROFL_LADDER_THREADS 64
#endif

namespace {

constexpr int THREADS = ROFL_LADDER_THREADS;
constexpr int SHARED_BYTES = LADDER_ENTRIES * POINT_WORDS * THREADS * (int)sizeof(uint32_t);

__global__ void __launch_bounds__(THREADS)
scalar_mul_kernel(const int32_t *k, int k_lanes, const int32_t *px, const int32_t *py,
                  const int32_t *pz, const int32_t *pt, int32_t *ox, int32_t *oy,
                  int32_t *oz, int32_t *ot, int n) {
  extern __shared__ uint32_t sm[];
  const int tid = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * THREADS + tid;
  if (lane >= n) return;  // no barrier below: a thread uses only its own column
  const ge acc = ladder_scalar_mul(k, k_lanes, k_lanes == 1 ? 0 : lane, sm, THREADS, tid,
                                   ge_load16(px, py, pz, pt, n, lane));
  ge_store16(ox, oy, oz, ot, n, lane, acc);
}

}  // namespace

// k_lanes is n or 1 (broadcast). Returns a CUDA error code, 0 when the
// launch was taken.
extern "C" int rofl_scalar_mul(const int32_t *k, int k_lanes, const int32_t *px,
                               const int32_t *py, const int32_t *pz, const int32_t *pt,
                               int32_t *ox, int32_t *oy, int32_t *oz, int32_t *ot, int n,
                               void *stream) {
  if (n < 1 || (k_lanes != n && k_lanes != 1)) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(scalar_mul_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SHARED_BYTES);
  if (err != cudaSuccess) return (int)err;
  scalar_mul_kernel<<<(n + THREADS - 1) / THREADS, THREADS, SHARED_BYTES, (cudaStream_t)stream>>>(
      k, k_lanes, px, py, pz, pt, ox, oy, oz, ot, n);
  return (int)cudaGetLastError();
}
