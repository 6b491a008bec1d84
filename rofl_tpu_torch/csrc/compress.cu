// compress: batched Ristretto255 encoding to canonical field limbs, one lane
// per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _compress_kernel /
// compress. Work per lane: one inverse square root (254 squarings and 11
// products in the exponent chain) plus about 20 more products, against 320
// bytes moved: bound by 32-bit integer multiply-adds on an H100, by a wide
// margin. Design: the chain is a dependent sequence per lane, so the point
// and every intermediate stay in registers and the long squaring runs are
// rolled loops around one squaring body (a squaring takes 136 multiplies
// instead of a product's 256).
#include <cuda_runtime.h>

#include "ge25519.cuh"

using namespace rofl;

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
compress_kernel(const int32_t *px, const int32_t *py, const int32_t *pz,
                const int32_t *pt, int32_t *out, int n) {
  int64_t lane = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  ge p;
  p.x = fe_load(px, n, lane);
  p.y = fe_load(py, n, lane);
  p.z = fe_load(pz, n, lane);
  p.t = fe_load(pt, n, lane);
  fe_store(out, n, lane, ristretto_compress(p));
}

}  // namespace

// Returns cudaGetLastError().
extern "C" int rofl_compress(const int32_t *px, const int32_t *py, const int32_t *pz,
                             const int32_t *pt, int32_t *out, int n, void *stream) {
  int blocks = (n + THREADS - 1) / THREADS;
  compress_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(px, py, pz, pt, out, n);
  return (int)cudaGetLastError();
}
