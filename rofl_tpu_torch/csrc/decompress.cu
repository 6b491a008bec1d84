// decompress: batched Ristretto255 decoding with its validity mask, one lane
// per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _decompress_kernel /
// decompress. Work per lane: one inverse square root (254 squarings and 16
// products, 251 and 11 of them in the exponent chain), then 8 products and
// 3 squarings more: 257 squarings and 24 products against 321 bytes moved
// (one element read, four coordinates and one flag written). On 8 limbs of
// 32 bits (fe25519_32.cuh) that is 257 x 36 + 24 x 64 = 10 788 wide
// multiplies a lane, each a low and a high 32-bit multiply-add: 64 us of the
// H100's 33.5 TOP/s of int32 at N = 50 000 against 4.8 us for the bytes. So
// the integer units bound it, by a wide margin.
//
// Design: the same as compress.cu, whose inverse square root it shares
// (fe_invsqrt): the element and every intermediate stay in registers,
// the long squaring runs are rolled loops, and __launch_bounds__ asks for 4
// blocks of 128 threads an SM (at most 128 registers a thread). Every sign
// and zero test of the mask canonicalises first, so any s below 2^256 gives
// the mask of s mod p, as the plain version does; the raw bytes' check
// s < p is the caller's. z is stored as canonical 1; x, y and t are weakly
// reduced and equal the plain version's mod p. The mask is one byte a lane.
#include <cuda_runtime.h>

#include "fe25519_32.cuh"

using namespace rofl32;

namespace {

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS_PER_SM = 4;

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
decompress_kernel(const int32_t *__restrict__ s, int32_t *__restrict__ ox,
                  int32_t *__restrict__ oy, int32_t *__restrict__ oz,
                  int32_t *__restrict__ ot, uint8_t *__restrict__ valid, int n) {
  const int64_t lane = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  ge p;
  const bool ok = ristretto_decompress(fe_load16(s, n, lane), p);
  ge_store16(ox, oy, oz, ot, n, lane, p);
  valid[lane] = ok ? 1 : 0;
}

}  // namespace

// valid is one byte per lane (a torch.bool tensor). Returns cudaGetLastError().
extern "C" int rofl_decompress(const int32_t *s, int32_t *ox, int32_t *oy, int32_t *oz,
                               int32_t *ot, uint8_t *valid, int n, void *stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int blocks = (n + THREADS - 1) / THREADS;
  decompress_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(s, ox, oy, oz, ot, valid, n);
  return (int)cudaGetLastError();
}
