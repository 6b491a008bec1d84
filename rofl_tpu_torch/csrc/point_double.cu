// point_double: batched extended-Edwards doubling, one lane per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _double_kernel /
// point_double. Work per lane: 4 squarings and 4 products against 512 bytes
// moved (4 coordinates read, 4 written): bound by memory on an H100. Loads
// and stores are coalesced per limb; intermediates stay in registers.
#include <cuda_runtime.h>

#include "ge25519.cuh"

using namespace rofl;

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
point_double_kernel(const int32_t *px, const int32_t *py, const int32_t *pz,
                    const int32_t *pt, int32_t *ox, int32_t *oy, int32_t *oz,
                    int32_t *ot, int n) {
  int64_t lane = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  ge p;
  p.x = fe_load(px, n, lane);
  p.y = fe_load(py, n, lane);
  p.z = fe_load(pz, n, lane);
  p.t = fe_load(pt, n, lane);
  ge r = ge_double(p);
  fe_store(ox, n, lane, r.x);
  fe_store(oy, n, lane, r.y);
  fe_store(oz, n, lane, r.z);
  fe_store(ot, n, lane, r.t);
}

}  // namespace

// Returns cudaGetLastError().
extern "C" int rofl_point_double(const int32_t *px, const int32_t *py,
                                 const int32_t *pz, const int32_t *pt, int32_t *ox,
                                 int32_t *oy, int32_t *oz, int32_t *ot, int n,
                                 void *stream) {
  int blocks = (n + THREADS - 1) / THREADS;
  point_double_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(px, py, pz, pt, ox,
                                                                   oy, oz, ot, n);
  return (int)cudaGetLastError();
}
