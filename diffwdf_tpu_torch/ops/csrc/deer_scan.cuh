// S-state affine maps z -> J z + c and their scans, for the DEER kernels
// (ops/circuit_codegen.py generate_deer, and deer_cluster.cuh, which the
// clipper's cluster kernel runs at S = 1).
//
// A Newton sweep of DEER linearises the step map around the current
// trajectory, z_t = J_t z_{t-1} + c_t with J_t an S x S matrix, and solves
// that recurrence exactly by composing the affine maps: in-thread over the
// rows of a time block, then across the CTA for the block totals.
//
// Affine maps do not commute: deer_compose(a, b) applies a, then b.  Every
// product and sum is a round-to-nearest intrinsic, which nvcc never contracts
// into an FMA, summed over k = 0 .. S-1 and then the offset, the order of the
// JAX kernel's mat_compose (diffwdf_tpu/ops/deer_circuit.py:216-222), so a
// composition rounds as the plain PyTorch version's separate operations do.
// The scan composes the 1024 block totals in another order than the TPU's
// lane-then-sublane doublings, so results agree to rounding, not bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr unsigned kDeerFull = 0xffffffffu;

// z -> J z + c, J row-major
template <int S>
struct DeerAffine {
  float J[S * S];
  float c[S];
};

template <int S>
__device__ __forceinline__ DeerAffine<S> deer_identity() {
  DeerAffine<S> x;
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int j = 0; j < S; ++j) x.J[i * S + j] = i == j ? 1.f : 0.f;
    x.c[i] = 0.f;
  }
  return x;
}

// b AFTER a: z -> b.J (a.J z + a.c) + b.c
template <int S>
__device__ __forceinline__ DeerAffine<S> deer_compose(const DeerAffine<S>& a,
                                                      const DeerAffine<S>& b) {
  DeerAffine<S> r;
#pragma unroll
  for (int i = 0; i < S; ++i) {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      float acc = __fmul_rn(b.J[i * S], a.J[j]);
#pragma unroll
      for (int k = 1; k < S; ++k) acc = __fadd_rn(acc, __fmul_rn(b.J[i * S + k], a.J[k * S + j]));
      r.J[i * S + j] = acc;
    }
    float acc = __fmul_rn(b.J[i * S], a.c[0]);
#pragma unroll
    for (int k = 1; k < S; ++k) acc = __fadd_rn(acc, __fmul_rn(b.J[i * S + k], a.c[k]));
    r.c[i] = __fadd_rn(acc, b.c[i]);
  }
  return r;
}

// y = x.J z + x.c
template <int S>
__device__ __forceinline__ void deer_apply(const DeerAffine<S>& x, const float* z, float* y) {
#pragma unroll
  for (int i = 0; i < S; ++i) {
    float acc = __fmul_rn(x.J[i * S], z[0]);
#pragma unroll
    for (int k = 1; k < S; ++k) acc = __fadd_rn(acc, __fmul_rn(x.J[i * S + k], z[k]));
    y[i] = __fadd_rn(acc, x.c[i]);
  }
}

template <int S>
__device__ __forceinline__ DeerAffine<S> deer_shfl_up(const DeerAffine<S>& x, int d) {
  DeerAffine<S> y;
#pragma unroll
  for (int i = 0; i < S * S; ++i) y.J[i] = __shfl_up_sync(kDeerFull, x.J[i], d);
#pragma unroll
  for (int i = 0; i < S; ++i) y.c[i] = __shfl_up_sync(kDeerFull, x.c[i], d);
  return y;
}

// Inclusive scan over the 32 lanes of a warp: lane l gets x_l AFTER ... AFTER x_0.
template <int S>
__device__ __forceinline__ DeerAffine<S> deer_warp_scan(DeerAffine<S> x, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const DeerAffine<S> y = deer_shfl_up(x, d);
    if (lane >= d) x = deer_compose(y, x);
  }
  return x;
}

// Exclusive scan over the CTA (blockDim.x a multiple of 32, at most 1024):
// thread t gets x_{t-1} AFTER ... AFTER x_0, the identity for t = 0.  Warp
// shuffles inside each warp, then the warp totals in shared memory
// (s_tot[32]) scanned by warp 0.  Its barriers also order everything before
// the call against everything after it.
template <int S>
__device__ DeerAffine<S> deer_block_exclusive_scan(const DeerAffine<S>& x,
                                                   DeerAffine<S>* s_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const DeerAffine<S> inc = deer_warp_scan(x, lane);
  if (lane == 31) s_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    DeerAffine<S> t = lane < n_warps ? s_tot[lane] : deer_identity<S>();
    t = deer_warp_scan(t, lane);  // totals of warps 0 .. lane
    if (lane < n_warps) s_tot[lane] = t;
  }
  __syncthreads();
  DeerAffine<S> ex = deer_shfl_up(inc, 1);
  if (lane == 0) ex = deer_identity<S>();
  if (warp > 0) ex = deer_compose(s_tot[warp - 1], ex);  // the earlier warps first
  __syncthreads();  // s_tot may be rewritten
  return ex;
}

// max(a, b) that keeps a NaN (as torch's and jnp's max do; fmaxf drops it).
__device__ __forceinline__ float deer_nanmax(float a, float b) {
  return (a != a || a > b) ? a : b;
}

// Maximum of x over the CTA, NaN kept; every thread gets it (s_red[32]).
__device__ __forceinline__ float deer_block_max(float x, float* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) x = deer_nanmax(x, __shfl_xor_sync(kDeerFull, x, d));
  if (lane == 0) s_red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = lane < n_warps ? s_red[lane] : s_red[0];
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x = deer_nanmax(x, __shfl_xor_sync(kDeerFull, x, d));
    if (lane == 0) s_red[0] = x;
  }
  __syncthreads();
  x = s_red[0];
  __syncthreads();  // s_red may be reused
  return x;
}

}  // namespace
