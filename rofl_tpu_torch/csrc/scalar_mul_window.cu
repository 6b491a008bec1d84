// scalar_mul_window: k_i * P_i per lane by W-bit windows, W = 2 or 4, one
// lane per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _make_smul_window_kernel,
// the variant of scalar_mul that ROFL_SMUL_W > 1 selects there. The same
// function as csrc/scalar_mul.cu; the default paths of both packages run
// scalar_mul (the TPU's one-bit ladder, the port's signed radix-16 one).
// Work per lane: 2^W - 2 point operations for the table of multiples, then
// 256 doublings and 256 / W adds (W = 4: 14 + 256 + 64 against the one-bit
// ladder's 256 + 256), bound by the integer units on an H100.
//
// Design. The 2^W multiples of a lane (4 KB at W = 4) fit neither in
// registers nor, at 64 threads a block, in shared memory (64 x 4 KB = 256 KB
// > 227 KB), so they live in a scratch table in device memory that the
// wrapper allocates, [entry][word][lane] (ge_table_store in ge25519.cuh:
// coalesced per word), 2^W * 256 bytes a lane. The multiples are built as
// the TPU kernel builds them (M[j] = 2 M[j/2] or M[j-1] + P), then the
// windows run from the top: W doublings, a lookup, one add. The lookup
// reads every entry and selects (ge_window_lookup): the scalars of the
// provers are secret, so no address and no branch depends on a digit, as in
// the TPU kernel's select tree; the add is always computed (M[0] is the
// identity). Each window reads the lane's whole table again (2^W * 256
// bytes) from L2 or device memory.
#include <cuda_runtime.h>

#include "ge25519.cuh"

using namespace rofl;

namespace {

constexpr int THREADS = 64;

template <int W>
__global__ void __launch_bounds__(THREADS)
scalar_mul_window_kernel(const int32_t *k, int k_lanes, const int32_t *px, const int32_t *py,
                         const int32_t *pz, const int32_t *pt, int32_t *table, int32_t *ox,
                         int32_t *oy, int32_t *oz, int32_t *ot, int n) {
  int64_t lane = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (lane >= n) return;
  ge p;
  p.x = fe_load(px, n, lane);
  p.y = fe_load(py, n, lane);
  p.z = fe_load(pz, n, lane);
  p.t = fe_load(pt, n, lane);
  ge acc = ge_scalar_mul_window<W>(k, k_lanes, k_lanes == 1 ? 0 : lane, table, n, lane, p);
  fe_store(ox, n, lane, acc.x);
  fe_store(oy, n, lane, acc.y);
  fe_store(oz, n, lane, acc.z);
  fe_store(ot, n, lane, acc.t);
}

template <int W>
void launch(const int32_t *k, int k_lanes, const int32_t *px, const int32_t *py,
            const int32_t *pz, const int32_t *pt, int32_t *table, int32_t *ox, int32_t *oy,
            int32_t *oz, int32_t *ot, int n, cudaStream_t stream) {
  int blocks = (n + THREADS - 1) / THREADS;
  scalar_mul_window_kernel<W><<<blocks, THREADS, 0, stream>>>(
      k, k_lanes, px, py, pz, pt, table, ox, oy, oz, ot, n);
}

}  // namespace

// window: 2 or 4 (anything else returns cudaErrorInvalidValue and launches
// nothing). k_lanes is n or 1 (broadcast). table: scratch of 2^window * 64 * n
// int32. Returns cudaGetLastError().
extern "C" int rofl_scalar_mul_window(int window, const int32_t *k, int k_lanes,
                                      const int32_t *px, const int32_t *py, const int32_t *pz,
                                      const int32_t *pt, int32_t *table, int32_t *ox,
                                      int32_t *oy, int32_t *oz, int32_t *ot, int n,
                                      void *stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (window == 2) {
    launch<2>(k, k_lanes, px, py, pz, pt, table, ox, oy, oz, ot, n, s);
  } else if (window == 4) {
    launch<4>(k, k_lanes, px, py, pz, pt, table, ox, oy, oz, ot, n, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
