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
// 20 additions (23 000 32-bit multiply-adds) a term at g = 65 536, which is
// three orders of magnitude more time than the bytes take.
//
// Design, a simple kernel that is right first (Straus with one-bit windows,
// the interleaved double-and-add; the per-thread part is ge_msm_lanes and
// msm_thread_lanes in ge25519.cuh, which also compile on the host): a block
// of THREADS threads takes a run of at most THREADS * per_thread lanes of
// one group; thread t owns the lanes
// t, t + THREADS, ... of the run (so a warp's loads of one limb are
// coalesced). Each thread walks the 256 bits of the scalars from the top:
// acc = 2 acc, then for each of its lanes acc = bit ? acc + P : acc. The
// doublings are shared by the thread's lanes: a term costs one addition a
// bit and 1/per_thread of a doubling, against the ladder's one of each. The
// add is always computed and the result selected, so no branch and no
// memory address depends on a bit of a scalar (the provers' scalars are
// secret). P and the scalar word are read from global memory at each step
// (they stay in L2); the live state is the accumulator and one formula's
// temporaries, as in scalar_mul.cu. At the end the block adds its THREADS
// accumulators in a shared-memory tree ([word][thread], so the reads of one
// word fall in distinct banks) and writes one partial sum. The wrapper adds
// a group's partials with a chain of point_add launches. The
// identity as a point, zero scalars and groups of any size need no special
// case: the addition law is complete, and a thread without lanes keeps the
// identity.
//
// A bucketed Pippenger (signed digits, buckets accumulated per window) is the
// later step that makes this fast.
#include <cuda_runtime.h>

#include "ge25519.cuh"

using namespace rofl;

namespace {

constexpr int THREADS = 64;
constexpr int POINT_WORDS = 4 * NLIMB;

// The point formulas as calls, not inlined: nvcc 12.9's cicc crashes
// (a segmentation fault) on this kernel with them inlined, at -O3 and at
// -O2, whatever the loop structure. As calls they compile to 249 registers
// without spills.
__device__ __noinline__ ge add_call(const ge &a, const ge &b) { return ge_add(a, b); }
__device__ __noinline__ ge double_call(const ge &a) { return ge_double(a); }

struct Add {
  __device__ ge operator()(const ge &a, const ge &b) const { return add_call(a, b); }
};
struct Double {
  __device__ ge operator()(const ge &a) const { return double_call(a); }
};

__device__ __forceinline__ void store_shared(uint32_t (*sp)[THREADS], int tid, const ge &p) {
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) {
    sp[k][tid] = p.x.v[k];
    sp[NLIMB + k][tid] = p.y.v[k];
    sp[2 * NLIMB + k][tid] = p.z.v[k];
    sp[3 * NLIMB + k][tid] = p.t.v[k];
  }
}

__device__ __forceinline__ ge load_shared(const uint32_t (*sp)[THREADS], int tid) {
  ge p;
  ROFL_UNROLL
  for (int k = 0; k < NLIMB; ++k) {
    p.x.v[k] = sp[k][tid];
    p.y.v[k] = sp[NLIMB + k][tid];
    p.z.v[k] = sp[2 * NLIMB + k][tid];
    p.t.v[k] = sp[3 * NLIMB + k][tid];
  }
  return p;
}

__global__ void __launch_bounds__(THREADS)
msm_kernel(const int32_t *k, int k_lanes, const int32_t *px, const int32_t *py,
           const int32_t *pz, const int32_t *pt, int n, int group, int per_thread,
           int blocks_per_group, int32_t *ox, int32_t *oy, int32_t *oz, int32_t *ot,
           int n_out) {
  __shared__ uint32_t red[POINT_WORDS][THREADS];
  const int tid = threadIdx.x;
  const msm_lanes mine =
      msm_thread_lanes(blockIdx.x, tid, THREADS, group, per_thread, blocks_per_group);
  const ge acc = ge_msm_lanes(k, k_lanes, px, py, pz, pt, n, mine.first, THREADS, mine.count,
                              Add(), Double());
  store_shared(red, tid, acc);
  __syncthreads();
  ROFL_NO_UNROLL
  for (int stride = THREADS / 2; stride > 0; stride >>= 1) {
    if (tid < stride) {
      store_shared(red, tid, add_call(load_shared(red, tid), load_shared(red, tid + stride)));
    }
    __syncthreads();
  }
  if (tid == 0) {
    const ge sum = load_shared(red, 0);
    fe_store(ox, n_out, blockIdx.x, sum.x);
    fe_store(oy, n_out, blockIdx.x, sum.y);
    fe_store(oz, n_out, blockIdx.x, sum.z);
    fe_store(ot, n_out, blockIdx.x, sum.t);
  }
}

}  // namespace

// Points (16, n) x4, scalars (16, k_lanes) with k_lanes n or 1 (broadcast),
// `group` dividing n. Writes one partial sum a block: (16, n_out) x4 with
// n_out = (n / group) * ceil(group / (64 * per_thread)), a group's partials
// contiguous. Return cudaGetLastError().
extern "C" int rofl_msm_groups(const int32_t *k, int k_lanes, const int32_t *px,
                               const int32_t *py, const int32_t *pz, const int32_t *pt, int n,
                               int group, int per_thread, int32_t *ox, int32_t *oy, int32_t *oz,
                               int32_t *ot, void *stream) {
  if (n < 1 || group < 1 || n % group != 0 || per_thread < 1) return (int)cudaErrorInvalidValue;
  const int lanes_per_block = THREADS * per_thread;
  const int blocks_per_group = (group + lanes_per_block - 1) / lanes_per_block;
  const int n_out = (n / group) * blocks_per_group;
  msm_kernel<<<n_out, THREADS, 0, (cudaStream_t)stream>>>(
      k, k_lanes, px, py, pz, pt, n, group, per_thread, blocks_per_group, ox, oy, oz, ot, n_out);
  return (int)cudaGetLastError();
}
