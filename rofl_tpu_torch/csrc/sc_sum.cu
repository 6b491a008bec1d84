// sc_sum: sums of scalars mod l over one axis, (outer, R, inner) -> (outer,
// inner), in the layout of csrc/point_sum.cu (rofl::sum_terms_of).
//
// Replaces the TPU kernels' reductions rofl_tpu/ops/kernels.py sc_sum and
// sc_sum_groups: halving chains of sc_add launches, each half copied out,
// padded to a power of two. Bound on an H100: one read of 64 bytes a
// scalar (0.96 us at 50 000 scalars at 3.35 TB/s); the arithmetic is a few
// word additions a term.
//
// Design: point_sum.cu's grid, threads and (at most two) launches, on exact
// arithmetic. A thread adds word k of each of its terms into an unsigned
// 64-bit column k (sc25519.cuh sc_sum_run); a lane's threads add their
// columns in shared memory ([word][thread], 8 KB); the carry pass and the
// wide reduction of sc25519.cuh (sc_reduce_columns) turn the columns into
// the canonical sum mod l. The columns of a split of the terms add up to
// the columns of the whole, so the result does not depend on how the terms
// were split or ordered: for canonical terms it is bit-equal to the chain
// of sc_add, and it is exact for any 256-bit terms. With several slices
// each writes its canonical partial sum to scratch, (16, slices * M) at
// s * M + j, and a second launch adds those over the layout (1, slices, M).
#include <cuda_runtime.h>

#include "sc25519.cuh"

using namespace rofl;

namespace {

constexpr int THREADS = 128;

__global__ void __launch_bounds__(THREADS)
sc_sum_kernel(const int32_t *__restrict__ a, int64_t outer, int64_t R, int64_t inner, int tpl,
              int32_t *__restrict__ out) {
  __shared__ uint64_t sm[SC_WORDS * THREADS];
  const int tid = threadIdx.x;
  const int v = tid & (tpl - 1);
  const int slices = gridDim.y;
  const int slice = blockIdx.y;
  const int64_t m = outer * inner;
  const int64_t lane = (int64_t)blockIdx.x * (THREADS / tpl) + tid / tpl;
  uint64_t col[SC_WORDS] = {0, 0, 0, 0, 0, 0, 0, 0};
  if (lane < m) {
    sc_sum_run(a, outer * R * inner, sum_terms_of(lane, R, inner, slices, slice, tpl, v), col);
  }
  ROFL_UNROLL
  for (int k = 0; k < SC_WORDS; ++k) sm[k * THREADS + tid] = col[k];
  __syncthreads();
  ROFL_NO_UNROLL
  for (int stride = tpl / 2; stride > 0; stride >>= 1) {
    sc_sum_fold(sm, THREADS, tid, v, stride);
    __syncthreads();
  }
  if (v == 0 && lane < m) {
    ROFL_UNROLL
    for (int k = 0; k < SC_WORDS; ++k) col[k] = sm[k * THREADS + tid];
    uint32_t r[SC_WORDS];
    sc_reduce_columns(col, r);
    sc_store(out, m * slices, slice * m + lane, r);
  }
}

bool threads_a_lane_ok(int tpl) { return tpl >= 1 && tpl <= THREADS && (tpl & (tpl - 1)) == 0; }

cudaError_t launch(const int32_t *a, int64_t outer, int64_t R, int64_t inner, int tpl,
                   int slices, int32_t *out, cudaStream_t s) {
  const int64_t lanes_a_block = THREADS / tpl;
  const dim3 grid((unsigned)((outer * inner + lanes_a_block - 1) / lanes_a_block),
                  (unsigned)slices);
  sc_sum_kernel<<<grid, THREADS, 0, s>>>(a, outer, R, inner, tpl, out);
  return cudaGetLastError();
}

}  // namespace

// Scalars (16, outer * R * inner) -> their sums mod l over R, (16, outer *
// inner), canonical. tpl, slices, tpl2 and the scratch as in
// rofl_point_sum. Returns a CUDA error code, 0 when every launch was taken.
extern "C" int rofl_sc_sum(const int32_t *a, int outer, int R, int inner, int tpl, int slices,
                           int tpl2, int32_t *scratch, int32_t *out, void *stream) {
  if (outer < 1 || R < 1 || inner < 1 || slices < 1 || slices > 65535 ||
      !threads_a_lane_ok(tpl) || !threads_a_lane_ok(tpl2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (slices == 1) return (int)launch(a, outer, R, inner, tpl, 1, out, s);
  cudaError_t err = launch(a, outer, R, inner, tpl, slices, scratch, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(scratch, 1, slices, (int64_t)outer * inner, tpl2, 1, out, s);
}
