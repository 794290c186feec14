// Device code of the real-line Wright omega and the sign it is used with,
// shared by the analytic diode-pair kernels.
//
// parallel_time_deer.cu (deer_clipper_cluster_kernel, the single-stream
// DEER solve; deer_clipper.cuh) evaluates the diode pair of Werner eqn 45
// with these two functions.
//
// omega_select and omega_pair (below) run the same math without the region
// branches, one solve and the pair: fused_clipper.cu's analytic_pair_kernel,
// the batched recursion, evaluates the pair with them (clipper_serve.cuh),
// and so does the forward step that ops/circuit_codegen.py generates for a
// diode-pair root (omega_pair on one thread, omega_lanes.cuh's
// omega_pair_lanes on a pair of lanes).  The adjoint and DEER steps it
// generates keep omega().
//
// Exact f32 throughout (expf, logf, IEEE division): no fast-math intrinsics.

#pragma once

#include <cuda_runtime.h>

namespace {

// sign(a), 0 at a == 0 (as jnp.sign and torch.sign give).
__device__ __forceinline__ float sign0(float a) {
  return static_cast<float>((a > 0.f) - (a < 0.f));
}

// One Newton step on e^u + u = x.  A zero residual (a converged step)
// divides as 0 and leaves u as it is; it is kept out of the division, whose
// range check sends it down the slow path.  The same bits as u - r / (eu + 1)
// for every u, up to the sign of a zero u, which expf does not see.
__device__ __forceinline__ float omega_newton_step(float x, float u) {
  const float eu = expf(u);
  const float r = eu + u - x;
  return r == 0.f ? u : u - r / (eu + 1.f);
}

// Real-line Wright omega: region-split guess for u = log(w), then Newton on
// e^u + u = x.  Same math as roots/omega.py, but only the selected region's
// guess is evaluated.
__device__ __forceinline__ float omega(float x, int iters) {
  float u;
  if (x <= -1.f) {
    u = x - expf(x);
  } else if (x >= 2.f) {
    const float lx = logf(x);
    u = logf(x - lx + lx / x);
  } else {
    const float t = x - 1.f;
    u = logf(1.f + 0.5f * t + 0.0625f * t * t);
  }
  for (int k = 0; k < iters; ++k) u = omega_newton_step(x, u);
  return expf(u);
}

// The region guess of u = log(omega(x)) without a branch: all three
// regions' guesses, each on its argument clamped into its region (so that no
// lane computes an inf or a NaN that the select then drops; in its own region
// each clamp leaves x as it is), and a select, as the JAX kernel's
// _omega_inline does.  omega()'s guesses, the middle one's polynomial
// written out with fmaf (the one place nvcc could contract them), so that
// every kernel that calls it rounds it alike.
__device__ __forceinline__ float omega_guess(float x) {
  const float xl = fminf(x, -1.f);
  const float u_lo = xl - expf(xl);
  const float xh = fmaxf(x, 2.f);
  const float lx = logf(xh);
  const float u_hi = logf(xh - lx + lx / xh);
  const float t = fminf(fmaxf(x, -1.f), 2.f) - 1.f;
  const float u_mid = logf(fmaf(__fmul_rn(0.0625f, t), t, fmaf(0.5f, t, 1.f)));
  return x <= -1.f ? u_lo : (x >= 2.f ? u_hi : u_mid);
}


// u after ITERS Newton steps, unrolled at compile time by the template (a
// #pragma unroll over the count left the loop rolled in the SASS); ITERS < 0:
// the run-time count iters, a loop.
template <int ITERS>
__device__ __forceinline__ float omega_newton(float x, float u, int iters) {
  if constexpr (ITERS < 0) {
    for (int k = 0; k < iters; ++k) u = omega_newton_step(x, u);
    return u;
  } else if constexpr (ITERS == 0) {
    return u;
  } else {
    return omega_newton<ITERS - 1>(x, omega_newton_step(x, u), iters);
  }
}

// omega(x) without a branch: the selected guess, the Newton steps unrolled,
// the exponential.  omega()'s math; the lanes of a warp never diverge on it.
template <int ITERS>
__device__ __forceinline__ float omega_select(float x, int iters = ITERS) {
  return expf(omega_newton<ITERS>(x, omega_guess(x), iters));
}

// The diode pair's two solves, w0 = omega(x0) and w1 = omega(x1), in one
// body on one thread.  The two chains are independent, but each IEEE
// division is a region of its own (FCHK, a branch to the slow path), and
// ptxas places the second solve's division region after the first's: on
// one thread the pair's divisions run one after the other.  The serving
// kernel and the generated forward split the pair over two lanes instead
// (omega_lanes.cuh omega_pair_lanes), each lane running one omega_select:
// the same bits, which the CPU tests hold it to.
template <int ITERS>
__device__ __forceinline__ void omega_pair(float x0, float x1, float& w0, float& w1,
                                           int iters = ITERS) {
  w0 = omega_select<ITERS>(x0, iters);
  w1 = omega_select<ITERS>(x1, iters);
}

// d omega / dx at w = omega(x): the implicit derivative of w + log w = x,
// w / (1 + w), written 1 / (1 + 1/w) so that it cannot overflow at the top
// of the f32 range (the custom jvp of the JAX package's wright_omega).  The
// generated adjoint kernels differentiate the diode pair with it.
__device__ __forceinline__ float omega_slope(float w) {
  return 1.f / (1.f + 1.f / w);
}

}  // namespace
