// Device code of the real-line Wright omega and the sign it is used with,
// shared by the analytic diode-pair kernels.
//
// fused_clipper.cu (analytic_kernel, the batched clipper recursion) and
// parallel_time_deer.cu (deer_clipper_kernel, the single-stream DEER solve)
// evaluate the diode pair of Werner eqn 45 with these two functions, so the
// sequential recursion and the parallel-in-time solve use one omega.
//
// Exact f32 throughout (expf, logf, IEEE division): no fast-math intrinsics.

#pragma once

#include <cuda_runtime.h>

namespace {

// sign(a), 0 at a == 0 (as jnp.sign and torch.sign give).
__device__ __forceinline__ float sign0(float a) {
  return static_cast<float>((a > 0.f) - (a < 0.f));
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
  for (int k = 0; k < iters; ++k) {
    const float eu = expf(u);
    u = u - (eu + u - x) / (eu + 1.f);
  }
  return expf(u);
}

// d omega / dx at w = omega(x): the implicit derivative of w + log w = x,
// w / (1 + w), written 1 / (1 + 1/w) so that it cannot overflow at the top
// of the f32 range (the custom jvp of the JAX package's wright_omega).  The
// generated adjoint kernels differentiate the diode pair with it.
__device__ __forceinline__ float omega_slope(float w) {
  return 1.f / (1.f + 1.f / w);
}

}  // namespace
