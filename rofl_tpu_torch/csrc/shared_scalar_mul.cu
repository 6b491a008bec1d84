// shared_scalar_mul: k * P_i for one scalar k shared by every lane, one lane
// per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _shared_mul_kernel /
// shared_scalar_mul (its own pallas_call). Bound on an H100: the integer
// units, by two orders of magnitude over the 512 bytes a lane moves. Work
// per lane for a random k: a table of 8 odd multiples (one doubling, seven
// additions), then about 253 doublings and 43 additions, some 230 000 32-bit
// multiply-adds.
//
// Design. k is public (the TPU kernel branches on its bits through
// lax.cond), so the wrapper recodes it on the host into its width-5 NAF
// (kernels.naf_digits: at most 257 digits, each 0 or odd in [-15, 15], no
// two nonzero digits within 5 places) and passes the digits by value, one
// struct of 264 bytes in the launch's arguments. Each lane builds P, 3P,
// ..., 15P in shared memory (1 KB a lane, [entry][word][thread], 64 KB a
// block of 64 threads) and runs from the top digit: a doubling a digit, T
// left out where another doubling follows, and on a nonzero digit one
// complete addition of entry |d| >> 1, negated where d < 0
// (fe25519_32.cuh naf_scalar_mul, which compiles for the host too). Every
// thread reads the same digit, so the branch on a zero digit is taken by
// whole warps and the table is read at one entry, with no scan and no
// select. That leaks what the TPU kernel leaks: the run time follows the
// weight of k (here of its NAF). Use it for public scalars (challenges); a
// secret scalar belongs in scalar_mul, which always adds and selects. The
// TPU kernel walks the bits from the bottom with a doubling addend; both
// give the same group element, in another projective representation. The
// identity as P needs no special case: the addition law is complete.
#include <cuda_runtime.h>

#include "fe25519_32.cuh"

using namespace rofl32;

namespace {

constexpr int THREADS = 64;
constexpr int SHARED_BYTES = NAF_ENTRIES * POINT_WORDS * THREADS * (int)sizeof(uint32_t);

__global__ void __launch_bounds__(THREADS)
shared_scalar_mul_kernel(naf_scalar k, const int32_t *px, const int32_t *py, const int32_t *pz,
                         const int32_t *pt, int32_t *ox, int32_t *oy, int32_t *oz,
                         int32_t *ot, int n) {
  extern __shared__ uint32_t sm[];
  const int tid = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * THREADS + tid;
  if (lane >= n) return;  // no barrier below: a thread uses only its own column
  const ge acc = naf_scalar_mul(k, sm, THREADS, tid, ge_load16(px, py, pz, pt, n, lane));
  ge_store16(ox, oy, oz, ot, n, lane, acc);
}

}  // namespace

// digits: the `count` digits of k's width-5 NAF in host memory, digit i of
// 2^i first, copied into the launch's arguments. Returns a CUDA error code,
// 0 when the launch was taken.
extern "C" int rofl_shared_scalar_mul(const int8_t *digits, int count, const int32_t *px,
                                      const int32_t *py, const int32_t *pz, const int32_t *pt,
                                      int32_t *ox, int32_t *oy, int32_t *oz, int32_t *ot,
                                      int n, void *stream) {
  if (n < 1 || count < 0 || count > NAF_MAX_DIGITS) return (int)cudaErrorInvalidValue;
  naf_scalar k = {};
  k.count = count;
  for (int i = 0; i < count; ++i) k.d[i] = digits[i];
  cudaError_t err = cudaFuncSetAttribute(shared_scalar_mul_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         SHARED_BYTES);
  if (err != cudaSuccess) return (int)err;
  shared_scalar_mul_kernel<<<(n + THREADS - 1) / THREADS, THREADS, SHARED_BYTES,
                             (cudaStream_t)stream>>>(k, px, py, pz, pt, ox, oy, oz, ot, n);
  return (int)cudaGetLastError();
}
