// The qualifiers and loop pragmas that let one header compile both for the
// card (nvcc) and as plain C++ (csrc/host_check.cpp, the host tests), shared
// by fe25519_32.cuh and sc25519.cuh, and the layout of the sums that both
// headers run (csrc/point_sum.cu, csrc/sc_sum.cu).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#define ROFL_HD __host__ __device__ __forceinline__
#define ROFL_UNROLL _Pragma("unroll")
#define ROFL_NO_UNROLL _Pragma("unroll 1")
#else
#define ROFL_HD inline
#define ROFL_UNROLL
#define ROFL_NO_UNROLL
#endif

namespace rofl {

// A sum runs over the middle axis of an (outer, R, inner) layout of a
// (16, outer * R * inner) array: term r of output lane j = o * inner + i is
// input lane (o * R + r) * inner + i (rofl_tpu_torch/ops/kernels.py
// reduction_layout). The R terms of a lane are cut into `slices` runs of
// ceil(R / slices), and the `tpl` threads of a lane take turns along a run:
// thread v takes terms lo + v, lo + v + tpl, ... below hi. With tpl = 1 a
// warp's threads are neighbouring output lanes, so where inner >= 32 their
// loads fall on neighbouring addresses; with tpl > 1 and inner = 1 they are
// neighbouring terms of one lane.
struct sum_terms {
  int64_t first, step, count;  // input lanes first, first + step, ...
};

ROFL_HD sum_terms sum_terms_of(int64_t lane, int64_t R, int64_t inner, int slices, int slice,
                               int tpl, int v) {
  const int64_t o = lane / inner;
  const int64_t i = lane - o * inner;
  const int64_t run = (R + slices - 1) / slices;
  const int64_t start = (int64_t)slice * run < R ? (int64_t)slice * run : R;
  const int64_t hi = start + run < R ? start + run : R;
  const int64_t lo = start + v;
  sum_terms t;
  t.count = lo < hi ? (hi - lo + tpl - 1) / tpl : 0;
  t.first = (o * R + lo) * inner + i;
  t.step = (int64_t)tpl * inner;
  return t;
}

}  // namespace rofl
