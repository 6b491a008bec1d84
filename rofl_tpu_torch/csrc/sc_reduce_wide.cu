// sc_reduce_wide: 64 little-endian bytes per lane -> the canonical scalar
// mod l (Scalar::from_bytes_mod_order_wide), one lane per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _sc_reduce_wide_kernel /
// sc_reduce_wide. Work per lane: three folds of 36 + 20 + 8 word products
// against 320 bytes moved (64 byte columns read as int32, 16 limbs
// written): bound by memory on an H100. Loads and stores are coalesced per
// row; intermediates stay in registers.
#include <cuda_runtime.h>

#include "sc25519.cuh"

using namespace rofl;

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
sc_reduce_wide_kernel(const int32_t *bytes, int32_t *out, int n) {
  int64_t lane = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  uint32_t v[16], r[SC_WORDS];
  sc_load_wide_bytes(bytes, n, lane, v);
  sc_reduce_512(v, r);
  sc_store(out, n, lane, r);
}

}  // namespace

// Returns cudaGetLastError().
extern "C" int rofl_sc_reduce_wide(const int32_t *bytes, int32_t *out, int n,
                                   void *stream) {
  int blocks = (n + THREADS - 1) / THREADS;
  sc_reduce_wide_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(bytes, out, n);
  return (int)cudaGetLastError();
}
