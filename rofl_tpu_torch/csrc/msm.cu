// msm: per-group multi-scalar multiplication, sum_i k_i * P_i over each
// contiguous group of `group` lanes; the wrapper msm_flat launches it with
// one group.
//
// Replaces the TPU kernels rofl_tpu/ops/kernels.py _msm_bitplane_kernel /
// _make_msm_window_kernel (W = 2 by default), reached through msm_flat and
// msm_groups. The TPU kernel is a Horner walk over bit planes with 128-wide
// partial sums, because a TPU vector register cannot scatter; none of that
// layout is carried.
//
// Bound on an H100: the operations. A term moves 320 bytes (a 256-byte
// point, a 64-byte scalar); a bucketed Pippenger at its best window c does
// ceil(256 / c) * (g + 2^(c+1)) point additions per group of g terms, about
// 20 additions a term at g = 65 536, three orders of magnitude more time than
// the bytes take.
//
// Design: a signed-window Pippenger at window C = MSM_C (3, fe25519_32.cuh)
// that stays data-oblivious, because the provers' scalars are secret (no
// branch and no memory address depends on a digit). Field and point arithmetic on 8 limbs of 32 bits (fe25519_32.cuh,
// where the per-thread, per-block and combining bodies live and compile for
// the host too). Three launches on one stream:
//   1. recode: each scalar into W = ceil(257 / C) signed C-bit digits,
//      digit i of term j at digits[i * k_lanes + j] (int8), by arithmetic.
//   2. buckets: one block of THREADS threads for each (group, slice,
//      window), the window fastest, so the windows of a slice run side by
//      side and read its points from L2 after the first. Each thread keeps
//      private buckets 1..2^(C-1) in shared memory, [bucket][word][thread]
//      (2^(C-1) * 128 B a thread), and runs over its terms of the slice:
//      every bucket read and selected, P negated by a select, one complete
//      addition, every bucket written back through a select. The block then
//      adds its threads' buckets bucket by bucket in a shared-memory tree,
//      and thread 0 takes the running sum sum_j j B_j: the block's window
//      partial, 32 words of scratch.
//   3. combine: one block a group, one thread a window: the window's slices
//      summed, then thread 0 runs Horner over the windows from the top (C
//      doublings and one add a window) and writes the group's sum.
// A term costs W additions and 2 * 2^(C-1) bucket scans; the tree and the
// running sum are a few additions a bucket a block. The identity as a point,
// a zero digit, empty slices and groups of any size need no special case:
// the addition law is complete.
#include <cuda_runtime.h>

#include "fe25519_32.cuh"

using namespace rofl32;

namespace {

constexpr int C = MSM_C;
constexpr int W = digits<C>::count;
constexpr int THREADS = 64;
constexpr int RECODE_THREADS = 128;
constexpr int BUCKET_SHARED_BYTES =
    digits<C>::half * POINT_WORDS * THREADS * (int)sizeof(uint32_t);

__global__ void __launch_bounds__(RECODE_THREADS)
msm_recode_kernel(const int32_t *k, int k_lanes, int8_t *digits_out) {
  const int64_t lane = (int64_t)blockIdx.x * RECODE_THREADS + threadIdx.x;
  if (lane >= k_lanes) return;
  uint32_t kw[NW];
  scalar_load16(k, k_lanes, lane, kw);
  recode_signed<C>(kw, digits_out + lane, k_lanes);
}

__global__ void __launch_bounds__(THREADS)
msm_bucket_kernel(const int8_t *digits_in, int k_lanes, const int32_t *px, const int32_t *py,
                  const int32_t *pz, const int32_t *pt, int n, int group, int slices,
                  uint32_t *partials) {
  extern __shared__ uint32_t sm[];
  const int tid = threadIdx.x;
  const msm_block b = msm_block_of(blockIdx.x, W, slices, group);
  const int64_t digit_step = k_lanes == 1 ? 0 : 1;
  msm_thread_terms<C>(sm, THREADS, tid, digits_in + (int64_t)b.window * k_lanes, digit_step,
                      px, py, pz, pt, n, b.first, b.last);
  __syncthreads();
  ROFL_NO_UNROLL
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    msm_tree_level<C>(sm, THREADS, tid, stride);
    __syncthreads();
  }
  if (tid == 0) {
    ge_put_words(partials + (int64_t)blockIdx.x * POINT_WORDS, msm_running_sum<C>(sm, THREADS));
  }
}

__global__ void msm_combine_kernel(const uint32_t *partials, int slices, int32_t *ox,
                                   int32_t *oy, int32_t *oz, int32_t *ot, int n_out) {
  __shared__ uint32_t sums[W * POINT_WORDS];
  const int w = threadIdx.x;
  const int64_t g = blockIdx.x;
  ge_put_words(sums + w * POINT_WORDS, msm_window_sum(partials, g, w, W, slices));
  __syncthreads();
  if (w == 0) ge_store16(ox, oy, oz, ot, n_out, g, msm_horner<C>(sums));
}

cudaError_t allow_bucket_shared() {
  return cudaFuncSetAttribute(msm_bucket_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              BUCKET_SHARED_BYTES);
}

}  // namespace

// The bucket blocks that one SM holds at once (registers and shared memory),
// for the wrapper's choice of slices. Returns a CUDA error code.
extern "C" int rofl_msm_occupancy(int *blocks_per_sm) {
  cudaError_t err = allow_bucket_shared();
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, msm_bucket_kernel,
                                                            THREADS, BUCKET_SHARED_BYTES);
}

// Points (16, n) x4, scalars (16, k_lanes) with k_lanes n or 1 (broadcast),
// `group` dividing n, `slices` >= 1 blocks a group and window. Scratch from
// the caller: digits_buf of W * k_lanes int8 and partials of
// (n / group) * slices * W * 32 words, W = ceil(257 / C). Writes the
// n / group sums, (16, n / group) x4. Returns a CUDA error code, 0 when
// every launch was taken.
extern "C" int rofl_msm_groups(const int32_t *k, int k_lanes, const int32_t *px,
                               const int32_t *py, const int32_t *pz, const int32_t *pt, int n,
                               int group, int slices, int8_t *digits_buf, uint32_t *partials,
                               int32_t *ox, int32_t *oy, int32_t *oz, int32_t *ot,
                               void *stream) {
  if (n < 1 || group < 1 || n % group != 0 || slices < 1 || (k_lanes != n && k_lanes != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = allow_bucket_shared();
  if (err != cudaSuccess) return (int)err;
  const int n_groups = n / group;
  msm_recode_kernel<<<(k_lanes + RECODE_THREADS - 1) / RECODE_THREADS, RECODE_THREADS, 0, s>>>(
      k, k_lanes, digits_buf);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msm_bucket_kernel<<<n_groups * slices * W, THREADS, BUCKET_SHARED_BYTES, s>>>(
      digits_buf, k_lanes, px, py, pz, pt, n, group, slices, partials);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  msm_combine_kernel<<<n_groups, W, 0, s>>>(partials, slices, ox, oy, oz, ot, n_groups);
  return (int)cudaGetLastError();
}
