// A stand-in for cuda_runtime.h on the host: the CUDA qualifiers defined
// away and the rounding intrinsics as plain IEEE f32 arithmetic, so that a
// generated circuit step (ops/circuit_codegen.py: a program's host_source,
// the step and a one-thread loop over streams and samples) compiles with
// the host C++ compiler.  ops/_build.host_library puts it on the include
// path as cuda_runtime.h; the CPU tests build their harnesses with it too.
#pragma once
#include <math.h>
#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
struct standin_dim3 { unsigned x, y, z; };
static standin_dim3 threadIdx, blockIdx, blockDim;
static inline void __syncthreads() {}
#define __fadd_rn(a, b) ((a) + (b))
#define __fsub_rn(a, b) ((a) - (b))
#define __fmul_rn(a, b) ((a) * (b))
#define __fdiv_rn(a, b) ((a) / (b))
