// point_add: batched unified extended-Edwards addition, one lane per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _add_kernel / point_add.
// Work per lane: 9 field products (2,304 32-bit multiply-adds) against 768
// bytes moved (8 coordinates read, 4 written), so on an H100 the bound is
// the memory, not the arithmetic. Design: every limb load and store is
// coalesced across the warp (limb-major layout); everything in between
// stays in registers. Either operand may be a single broadcast lane
// ((16, 1) coordinates), which BSGS uses to add one -mG to every lane.
#include <cuda_runtime.h>

#include "ge25519.cuh"

using namespace rofl;

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
point_add_kernel(const int32_t *px, const int32_t *py, const int32_t *pz,
                 const int32_t *pt, int p_lanes, const int32_t *qx,
                 const int32_t *qy, const int32_t *qz, const int32_t *qt,
                 int q_lanes, int32_t *ox, int32_t *oy, int32_t *oz, int32_t *ot,
                 int n) {
  int64_t lane = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  int64_t pl = p_lanes == 1 ? 0 : lane;
  int64_t ql = q_lanes == 1 ? 0 : lane;
  ge p, q;
  p.x = fe_load(px, p_lanes, pl);
  p.y = fe_load(py, p_lanes, pl);
  p.z = fe_load(pz, p_lanes, pl);
  p.t = fe_load(pt, p_lanes, pl);
  q.x = fe_load(qx, q_lanes, ql);
  q.y = fe_load(qy, q_lanes, ql);
  q.z = fe_load(qz, q_lanes, ql);
  q.t = fe_load(qt, q_lanes, ql);
  ge r = ge_add(p, q);
  fe_store(ox, n, lane, r.x);
  fe_store(oy, n, lane, r.y);
  fe_store(oz, n, lane, r.z);
  fe_store(ot, n, lane, r.t);
}

}  // namespace

// p_lanes and q_lanes are each n or 1 (broadcast). Returns cudaGetLastError().
extern "C" int rofl_point_add(const int32_t *px, const int32_t *py, const int32_t *pz,
                              const int32_t *pt, int p_lanes, const int32_t *qx,
                              const int32_t *qy, const int32_t *qz, const int32_t *qt,
                              int q_lanes, int32_t *ox, int32_t *oy, int32_t *oz,
                              int32_t *ot, int n, void *stream) {
  int blocks = (n + THREADS - 1) / THREADS;
  point_add_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      px, py, pz, pt, p_lanes, qx, qy, qz, qt, q_lanes, ox, oy, oz, ot, n);
  return (int)cudaGetLastError();
}
