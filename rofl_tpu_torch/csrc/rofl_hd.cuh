// The qualifiers and loop pragmas that let one header compile both for the
// card (nvcc) and as plain C++ (csrc/host_check.cpp, the host tests), shared
// by fe25519_32.cuh and sc25519.cuh.
#pragma once

#if defined(__CUDACC__)
#define ROFL_HD __host__ __device__ __forceinline__
#define ROFL_UNROLL _Pragma("unroll")
#define ROFL_NO_UNROLL _Pragma("unroll 1")
#else
#define ROFL_HD inline
#define ROFL_UNROLL
#define ROFL_NO_UNROLL
#endif
