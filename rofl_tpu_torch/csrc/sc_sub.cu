// sc_sub: a - b mod l per lane for canonical a and b, one lane per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _sc_sub_kernel / sc_sub.
// A subtract with borrow, then l added back where it borrowed: a few
// dozen integer operations against 192 bytes moved (two scalars read, one
// written), so the bound on an H100 is the memory. Design: each limb row is
// read and written coalesced across the warp; either operand may be a single
// broadcast lane ((16, 1)), read with stride 0 (0 - a negates a vector).
#include <cuda_runtime.h>

#include "sc25519.cuh"

using namespace rofl;

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
sc_sub_kernel(const int32_t *a, int a_lanes, const int32_t *b, int b_lanes,
              int32_t *out, int n) {
  int64_t lane = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  uint32_t x[SC_WORDS], y[SC_WORDS], r[SC_WORDS];
  sc_load(a, a_lanes, a_lanes == 1 ? 0 : lane, x);
  sc_load(b, b_lanes, b_lanes == 1 ? 0 : lane, y);
  sc_sub(x, y, r);
  sc_store(out, n, lane, r);
}

}  // namespace

// a_lanes and b_lanes are each n or 1 (broadcast). Returns cudaGetLastError().
extern "C" int rofl_sc_sub(const int32_t *a, int a_lanes, const int32_t *b, int b_lanes,
                           int32_t *out, int n, void *stream) {
  int blocks = (n + THREADS - 1) / THREADS;
  sc_sub_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(a, a_lanes, b, b_lanes, out, n);
  return (int)cudaGetLastError();
}
