// point_sum: sums of points over one axis, (outer, R, inner) -> (outer,
// inner): term r of output lane o * inner + i is input lane
// (o * R + r) * inner + i (rofl::sum_terms_of in rofl_hd.cuh).
//
// Replaces the TPU kernels' reductions rofl_tpu/ops/kernels.py tree_sum and
// tree_sum_groups: halving chains of point_add launches, each half copied
// out, padded to a power of two. Bound on an H100: one read of 256 bytes a
// point (3.8 us at 50 000 points at 3.35 TB/s) against R - 1 additions of
// 9 field products a lane (3.4 us of 33.5 TOP/s of int32). What a chain of
// halvings loses is neither: it is a launch, an allocation and two copies
// a level, and its last levels run a block or two on 132 SMs.
//
// Design: at most two launches of one kernel on the stream, each input
// lane read once, nothing padded or copied on the host. A lane's R terms
// are cut into `slices` runs (blockIdx.y), and `tpl` threads of a block
// take turns along a run, each adding its terms in registers with the
// header's complete ge_add (so the identity and equal points need no
// case); a block of THREADS threads serves THREADS / tpl lanes. The lane's
// threads then fold their points in shared memory ([word][thread], 16 KB)
// in log2(tpl) levels. With one slice thread v = 0 writes the lane's sum;
// with more it writes the slice's partial sum to scratch, (16, slices * M)
// limbs with slice s of lane j at s * M + j, which is the layout
// (1, slices, M): the second launch is the same kernel over the scratch
// with one slice. The wrapper chooses tpl and the slices (kernels.sum_plan):
// tpl = 1 where inner >= 32, so that a warp's loads are neighbours along
// the inner axis (the clients' commitment sums, the verifier's chunk
// sums); otherwise up to a block a lane, the slices sized to the card's
// waves (tree_sum over d, the provers' groups), and one thread for each of
// many small groups.
#include <cuda_runtime.h>

#include "fe25519_32.cuh"

using namespace rofl32;

namespace {

// The blocks an SM is asked to hold (__launch_bounds__), which caps the
// registers a thread at 65 536 / (128 * this); kernels.SUM_BLOCKS_PER_SM
// sizes the waves by it. At 4 the kernel spills at 128 registers; at 2 it
// takes 149 and spills nothing, and on an H100 it ran the provers' A sums
// 12 % faster and tree_sum of 50 000 points 2 % faster than at 4
// (rofl_tpu_torch/tune_kernels.py times 1, 2 and 4).
#ifndef ROFL_SUM_MIN_BLOCKS
#define ROFL_SUM_MIN_BLOCKS 2
#endif

constexpr int THREADS = 128;
constexpr int MIN_BLOCKS_PER_SM = ROFL_SUM_MIN_BLOCKS;  // kernels.SUM_BLOCKS_PER_SM

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS_PER_SM)
point_sum_kernel(const int32_t *__restrict__ px, const int32_t *__restrict__ py,
                 const int32_t *__restrict__ pz, const int32_t *__restrict__ pt, int64_t outer,
                 int64_t R, int64_t inner, int tpl, int32_t *__restrict__ ox,
                 int32_t *__restrict__ oy, int32_t *__restrict__ oz, int32_t *__restrict__ ot) {
  __shared__ uint32_t sm[POINT_WORDS * THREADS];
  const int tid = threadIdx.x;
  const int v = tid & (tpl - 1);
  const int slices = gridDim.y;
  const int slice = blockIdx.y;
  const int64_t m = outer * inner;
  const int64_t lane = (int64_t)blockIdx.x * (THREADS / tpl) + tid / tpl;
  rofl::sum_terms t = {0, 0, 0};
  if (lane < m) t = rofl::sum_terms_of(lane, R, inner, slices, slice, tpl, v);
  ge_entry_put(sm, THREADS, tid, 0, point_sum_run(px, py, pz, pt, outer * R * inner, t));
  __syncthreads();
  ROFL_NO_UNROLL
  for (int stride = tpl / 2; stride > 0; stride >>= 1) {
    point_sum_fold(sm, THREADS, tid, v, stride);
    __syncthreads();
  }
  if (v == 0 && lane < m) {
    ge_store16(ox, oy, oz, ot, m * slices, slice * m + lane, ge_entry_get(sm, THREADS, tid, 0));
  }
}

bool threads_a_lane_ok(int tpl) { return tpl >= 1 && tpl <= THREADS && (tpl & (tpl - 1)) == 0; }

cudaError_t launch(const int32_t *px, const int32_t *py, const int32_t *pz, const int32_t *pt,
                   int64_t outer, int64_t R, int64_t inner, int tpl, int slices, int32_t *ox,
                   int32_t *oy, int32_t *oz, int32_t *ot, cudaStream_t s) {
  const int64_t lanes_a_block = THREADS / tpl;
  const dim3 grid((unsigned)((outer * inner + lanes_a_block - 1) / lanes_a_block),
                  (unsigned)slices);
  point_sum_kernel<<<grid, THREADS, 0, s>>>(px, py, pz, pt, outer, R, inner, tpl, ox, oy, oz, ot);
  return cudaGetLastError();
}

}  // namespace

// Points (16, outer * R * inner) x4 -> their sums over R, (16, outer * inner)
// x4. tpl and tpl2 (threads a lane of the first and the second launch) are
// powers of two up to 128; with slices > 1 the scratch s* holds
// (16, slices * outer * inner) x4 and a second launch adds the slices.
// Returns a CUDA error code, 0 when every launch was taken.
extern "C" int rofl_point_sum(const int32_t *px, const int32_t *py, const int32_t *pz,
                              const int32_t *pt, int outer, int R, int inner, int tpl, int slices,
                              int tpl2, int32_t *sx, int32_t *sy, int32_t *sz, int32_t *st,
                              int32_t *ox, int32_t *oy, int32_t *oz, int32_t *ot, void *stream) {
  if (outer < 1 || R < 1 || inner < 1 || slices < 1 || slices > 65535 ||
      !threads_a_lane_ok(tpl) || !threads_a_lane_ok(tpl2)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t s = (cudaStream_t)stream;
  if (slices == 1) return (int)launch(px, py, pz, pt, outer, R, inner, tpl, 1, ox, oy, oz, ot, s);
  cudaError_t err = launch(px, py, pz, pt, outer, R, inner, tpl, slices, sx, sy, sz, st, s);
  if (err != cudaSuccess) return (int)err;
  return (int)launch(sx, sy, sz, st, 1, slices, (int64_t)outer * inner, tpl2, 1, ox, oy, oz, ot, s);
}
