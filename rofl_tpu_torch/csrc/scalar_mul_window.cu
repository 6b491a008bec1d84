// scalar_mul_window: k_i * P_i per lane by W-bit windows, W = 2 or 4, one
// lane per thread.
//
// Replaces the TPU kernel rofl_tpu/ops/kernels.py _make_smul_window_kernel,
// the variant of scalar_mul that ROFL_SMUL_W > 1 selects there. The same
// function as csrc/scalar_mul.cu; the default paths of both packages run
// scalar_mul (the TPU's one-bit ladder, the port's signed radix-16 one).
// Bound on an H100: the integer units, by three orders of magnitude over the
// 576 bytes a lane moves. Work per lane: 256 doublings and 256 / W
// additions, W = 2: 336 672 32-bit multiply-adds, W = 4: 260 608.
//
// Design: the signed W-bit ladder of fe25519_32.cuh, ladder_scalar_mul<W>,
// whose W = 4 instance is csrc/scalar_mul.cu's body. The TPU kernel keeps
// 2^W unsigned multiples a lane; signed digits in [-2^(W-1), 2^(W-1)) halve
// the table to P .. 2^(W-1) P, so it fits in shared memory at 64 threads a
// block: 2 entries (256 B a lane, 16 KB a block) at W = 2, 8 (1 KB a lane,
// 64 KB a block) at W = 4, laid out [entry][word][thread]. Each lane
// recodes its k (k + 0xAA...A or k + 0x88...8, a W-bit chunk less
// 2^(W-1); the top digit, 0 or 1, is the carry out) and runs from the top:
// W doublings, T only on the last, then one complete addition of the
// selected multiple. The selection reads every entry and selects, and
// negates by a select: the provers' scalars are secret, so no branch and no
// memory address depends on a digit, as in the TPU kernel's select tree.
// The kernel allocates nothing.
//
// k may be a single broadcast lane ((16, 1)), read with stride 0. The
// identity as P needs no special case: the addition law is complete.
#include <cuda_runtime.h>

#include "fe25519_32.cuh"

using namespace rofl32;

namespace {

constexpr int THREADS = 64;

template <int W>
constexpr int shared_bytes() {
  return ladder_window<W>::entries * POINT_WORDS * THREADS * (int)sizeof(uint32_t);
}

template <int W>
__global__ void __launch_bounds__(THREADS)
scalar_mul_window_kernel(const int32_t *k, int k_lanes, const int32_t *px, const int32_t *py,
                         const int32_t *pz, const int32_t *pt, int32_t *ox, int32_t *oy,
                         int32_t *oz, int32_t *ot, int n) {
  extern __shared__ uint32_t sm[];
  const int tid = threadIdx.x;
  const int64_t lane = (int64_t)blockIdx.x * THREADS + tid;
  if (lane >= n) return;  // no barrier below: a thread uses only its own column
  const ge acc = ladder_scalar_mul<W>(k, k_lanes, k_lanes == 1 ? 0 : lane, sm, THREADS, tid,
                                      ge_load16(px, py, pz, pt, n, lane));
  ge_store16(ox, oy, oz, ot, n, lane, acc);
}

template <int W>
int launch(const int32_t *k, int k_lanes, const int32_t *px, const int32_t *py,
           const int32_t *pz, const int32_t *pt, int32_t *ox, int32_t *oy, int32_t *oz,
           int32_t *ot, int n, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(scalar_mul_window_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         shared_bytes<W>());
  if (err != cudaSuccess) return (int)err;
  scalar_mul_window_kernel<W><<<(n + THREADS - 1) / THREADS, THREADS, shared_bytes<W>(),
                                stream>>>(k, k_lanes, px, py, pz, pt, ox, oy, oz, ot, n);
  return (int)cudaGetLastError();
}

}  // namespace

// window: 2 or 4 (anything else returns cudaErrorInvalidValue and launches
// nothing). k_lanes is n or 1 (broadcast). Returns a CUDA error code, 0 when
// the launch was taken.
extern "C" int rofl_scalar_mul_window(int window, const int32_t *k, int k_lanes,
                                      const int32_t *px, const int32_t *py, const int32_t *pz,
                                      const int32_t *pt, int32_t *ox, int32_t *oy, int32_t *oz,
                                      int32_t *ot, int n, void *stream) {
  if (n < 1 || (k_lanes != n && k_lanes != 1)) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (window == 2) return launch<2>(k, k_lanes, px, py, pz, pt, ox, oy, oz, ot, n, s);
  if (window == 4) return launch<4>(k, k_lanes, px, py, pz, pt, ox, oy, oz, ot, n, s);
  return (int)cudaErrorInvalidValue;
}
