// point_double: batched extended-Edwards doubling, one lane per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _double_kernel /
// point_double. Work per lane: 512 bytes moved (4 coordinates read, 4
// written) and 4 products and 4 squarings. On 8 limbs of 32 bits
// (fe25519_32.cuh) a product is 64 wide multiplies and a squaring 36, each
// a low and a high 32-bit multiply-add: 800 multiply-adds, 1 600 operations
// a lane, 2.4 us of the H100's 33.5 TOP/s of int32 at N = 50 000 against
// 7.6 us for the bytes at 3.35 TB/s. So the memory bounds it.
//
// Design: as point_add.cu. Every limb load and store is coalesced across
// the warp (the port's (16, N) limb-major layout, two 16-bit limbs packed
// into a word on the way in and split on the way out); everything in
// between stays in registers; __launch_bounds__ asks for 4 blocks of 128
// threads an SM, at most 128 registers a thread. The input may be any
// representative below 2^256 (point_add's output feeds it); the output is
// weakly reduced and equals the plain version's mod p. Lane indices are
// 64-bit: a limb's offset is limb * N + lane.
#include <cuda_runtime.h>

#include "fe25519_32.cuh"

using namespace rofl32;

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS_PER_SM = 4;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
point_double_kernel(const int32_t *__restrict__ px, const int32_t *__restrict__ py,
                    const int32_t *__restrict__ pz, const int32_t *__restrict__ pt,
                    int32_t *__restrict__ ox, int32_t *__restrict__ oy,
                    int32_t *__restrict__ oz, int32_t *__restrict__ ot, int n) {
  const int64_t lane = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  ge_store16(ox, oy, oz, ot, n, lane, ge_double(ge_load16(px, py, pz, pt, n, lane), true));
}

}  // namespace

// Returns cudaGetLastError().
extern "C" int rofl_point_double(const int32_t *px, const int32_t *py,
                                 const int32_t *pz, const int32_t *pt, int32_t *ox,
                                 int32_t *oy, int32_t *oz, int32_t *ot, int n,
                                 void *stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  point_double_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(px, py, pz, pt, ox,
                                                                   oy, oz, ot, n);
  return (int)cudaGetLastError();
}
