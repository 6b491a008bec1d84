// decompress: batched Ristretto255 decoding with its validity mask, one lane
// per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _decompress_kernel /
// decompress. Work per lane: one inverse square root (254 squarings and 11
// products) plus about 18 more products and squarings, against 321 bytes
// moved (one element read, four coordinates and one flag written): bound by
// 32-bit integer multiply-adds on an H100. Same register-resident design as
// compress. The mask is one byte per lane.
#include <cuda_runtime.h>

#include "ge25519.cuh"

using namespace rofl;

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
decompress_kernel(const int32_t *s, int32_t *ox, int32_t *oy, int32_t *oz, int32_t *ot,
                  uint8_t *valid, int n) {
  int64_t lane = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  ge p;
  bool ok = ristretto_decompress(fe_load(s, n, lane), p);
  fe_store(ox, n, lane, p.x);
  fe_store(oy, n, lane, p.y);
  fe_store(oz, n, lane, p.z);
  fe_store(ot, n, lane, p.t);
  valid[lane] = ok ? 1 : 0;
}

}  // namespace

// valid is one byte per lane (a torch.bool tensor). Returns cudaGetLastError().
extern "C" int rofl_decompress(const int32_t *s, int32_t *ox, int32_t *oy, int32_t *oz,
                               int32_t *ot, uint8_t *valid, int n, void *stream) {
  int blocks = (n + THREADS - 1) / THREADS;
  decompress_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(s, ox, oy, oz, ot,
                                                                 valid, n);
  return (int)cudaGetLastError();
}
