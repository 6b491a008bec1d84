// compress: batched Ristretto255 encoding to canonical field limbs, one lane
// per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _compress_kernel /
// compress. Work per lane: one inverse square root (254 squarings and 16
// products, 251 and 11 of them in the exponent chain), then 10 products and
// a squaring more, and 3 products on the lanes whose encoding rotates (the
// kernel selects between both sides, so it does them on every lane):
// 255 squarings and 26 to 29 products against 320 bytes moved. On 8 limbs of
// 32 bits (fe25519_32.cuh) that is 255 x 36 + 26 x 64 = 10 844 to 11 036
// wide multiplies a lane, each a low and a high 32-bit multiply-add: 65 to
// 66 us of the H100's 33.5 TOP/s of int32 at N = 50 000 against 4.8 us for
// the bytes. So the integer units bound it, by a wide margin.
//
// Design: the chain is one dependent sequence a lane, so its latency shows
// unless many warps share an SM. The point and every intermediate stay in
// registers; the long squaring runs are rolled loops around one squaring
// body (fe_sqr_n), which keeps the code and the registers small, and
// __launch_bounds__ asks for 4 blocks of 128 threads an SM (at most 128
// registers a thread): 16 warps an SM to hide the multiply latency. The
// output is fe_canon's, so it is bit-equal to the plain version's for any
// representative of the point and any limbs below 2^256.
#include <cuda_runtime.h>

#include "fe25519_32.cuh"

using namespace rofl32;

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS_PER_SM = 4;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
compress_kernel(const int32_t *__restrict__ px, const int32_t *__restrict__ py,
                const int32_t *__restrict__ pz, const int32_t *__restrict__ pt,
                int32_t *__restrict__ out, int n) {
  const int64_t lane = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  fe_store16(out, n, lane, ristretto_compress(ge_load16(px, py, pz, pt, n, lane)));
}

}  // namespace

// Returns cudaGetLastError().
extern "C" int rofl_compress(const int32_t *px, const int32_t *py, const int32_t *pz,
                             const int32_t *pt, int32_t *out, int n, void *stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  compress_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(px, py, pz, pt, out, n);
  return (int)cudaGetLastError();
}
