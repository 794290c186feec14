// Device code of the distilled piecewise-odd Chebyshev root, shared by the
// distilled clipper's kernels (cheb.cu; the lane form in cheb_lanes.cuh) and
// the generated circuit kernels (ops/circuit_codegen.py) that serve a
// PiecewiseChebRoot.
//
//   b = a - sign(a) h(|a|),  s = clip(|a|, 0, a_max),
//   h = sum_k c_jk T_k(t_j),  t_j = clip((2 s - (hi_j + lo_j)) / (hi_j - lo_j), -1, 1)
//
// on the segment j the JAX kernel's evaluate-all-then-where selects: the last
// one whose lower edge s reaches (a NaN a clips to s = 0 here, and gives a
// NaN b).  cheb_root evaluates only that segment, by the Clenshaw recurrence
// in the JAX order b1' = 2 t b1 - b2 + c_k, k = degree .. 1, then
// h = t b1 - b2 + c_0 (cheb_segment).
//
// Parameter layout (floats; built in double on the host, rounded to f32):
//   a_max, then per segment lo_j, hi_j + lo_j, hi_j - lo_j,
//   then per segment the coefficients c_j0 .. c_jD, zero-padded to a
//   compiled degree D at or above the root's largest (ops/fused_clipper.py
//   CHEB_DEGREES; cheb.cu instantiates each).
// Every lane runs the same D steps whatever its segment: the padding's zero
// coefficients keep b1 = b2 = 0 exactly until a segment's own degree, so the
// result is the selected segment's.  D is a compile-time constant, so the
// loop unrolls, never diverges, and its coefficient loads issue ahead of the
// recurrence.
//
// The slope m = db/da (cheb_root_tangent; with b, cheb_root_value_tangent)
// is forward mode of the same recurrence, as JAX's autodiff of
// PiecewiseChebRoot.reflect gives it (diffwdf_tpu/roots/distilled.py), the
// tangents carried along s in JAX's order (dt = dt/ds = 2 / (hi - lo)):
//   db0 = 2 dt b1 + t2 db1 - db2 each step,  dh/ds = dt b1 + t db1 - db2,
//   m = 1 - sign(a) dh/ds ds/da,  ds/da = sign(a)
// (the recurrence db0 = 2 b1 + t2 db1 - db2 of dh/dt, scaled by dt/ds), with
// sign's derivative 0 (so m = 1 at a = 0) and each clip's derivative JAX's:
// 1 inside, 0 outside, 0.5 on an edge (jnp.clip is a max and a min, whose
// derivatives split a tie; cheb_clip_slope).  The padding's zero
// coefficients keep db1 = db2 = 0 as they keep b1 = b2 = 0.  The value
// lines are cheb_segment's, so b is cheb_root's.  The generated adjoint
// (pass 1) and DEER steps of a circuit call these.
//
// No transcendentals; IEEE division.  __host__ __device__, so a generated
// circuit step that calls it also compiles for the host.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kMaxChebSegments = 8;

__host__ __device__ __forceinline__ float cheb_sign(float a) {
  return static_cast<float>((a > 0.f) - (a < 0.f));
}

__host__ __device__ __forceinline__ float cheb_clip(float x, float lo, float hi) {
  return fminf(fmaxf(x, lo), hi);
}

// h of one segment at s: t = clip((2 s - (hi + lo)) / (hi - lo), -1, 1),
// then the Clenshaw recurrence over the segment's coefficients c[0 .. D]
// (zero-padded to D).  cheb_root (one thread, the selected segment) and the
// lane form (cheb_lanes.cuh, one segment a lane) both run this, so both run
// the same expressions.
template <int D>
__host__ __device__ __forceinline__ float cheb_segment(float s, float hpl, float hml,
                                                       const float* c) {
  const float t = cheb_clip((2.f * s - hpl) / hml, -1.f, 1.f);
  const float t2 = 2.f * t;
  float b1 = 0.f, b2 = 0.f;
#pragma unroll
  for (int k = D; k >= 1; --k) {
    const float b0 = t2 * b1 - b2 + c[k];
    b2 = b1;
    b1 = b0;
  }
  return t * b1 - b2 + c[0];
}

// b of the root at a; p the parameters above, n_seg segments padded to D.
template <int D>
__host__ __device__ __forceinline__ float cheb_root(float a, const float* p, int n_seg) {
  const float s = cheb_clip(fabsf(a), 0.f, p[0]);
  const float* seg = p + 1;
  int j = 0;
  for (int k = 1; k < n_seg; ++k) {
    if (!(s < seg[3 * k])) j = k;
  }
  const float* c = p + 1 + 3 * n_seg + j * (D + 1);
  const float h = cheb_segment<D>(s, seg[3 * j + 1], seg[3 * j + 2], c);
  return a - cheb_sign(a) * h;
}

// d clip(x, lo, hi) / dx as JAX's max-then-min gives it: 1 strictly inside,
// 0.5 on an edge (a tie of the max or of the min), 0 outside.
__host__ __device__ __forceinline__ float cheb_clip_slope(float x, float lo, float hi) {
  return (x > lo && x < hi) ? 1.f : ((x == lo || x == hi) ? 0.5f : 0.f);
}

// h of one segment at s (cheb_segment's lines) and dh/ds: the Clenshaw
// recurrence's forward mode, its tangents carried along s.
template <int D>
__host__ __device__ __forceinline__ float cheb_segment_tangent(float s, float hpl, float hml,
                                                               const float* c, float& dh_ds) {
  const float u = (2.f * s - hpl) / hml;
  const float t = cheb_clip(u, -1.f, 1.f);
  const float t2 = 2.f * t;
  const float dt = (2.f / hml) * cheb_clip_slope(u, -1.f, 1.f);
  const float dt2 = 2.f * dt;
  float b1 = 0.f, b2 = 0.f, d1 = 0.f, d2 = 0.f;
#pragma unroll
  for (int k = D; k >= 1; --k) {
    const float b0 = t2 * b1 - b2 + c[k];
    const float d0 = dt2 * b1 + t2 * d1 - d2;
    b2 = b1;
    b1 = b0;
    d2 = d1;
    d1 = d0;
  }
  dh_ds = dt * b1 + t * d1 - d2;
  return t * b1 - b2 + c[0];
}

// b of the root at a (cheb_root's value) and m = db/da.
template <int D>
__host__ __device__ __forceinline__ float cheb_root_value_tangent(float a, const float* p,
                                                                  int n_seg, float& m) {
  const float x = fabsf(a);
  const float s = cheb_clip(x, 0.f, p[0]);
  const float* seg = p + 1;
  int j = 0;
  for (int k = 1; k < n_seg; ++k) {
    if (!(s < seg[3 * k])) j = k;
  }
  const float* c = p + 1 + 3 * n_seg + j * (D + 1);
  float dh_ds;
  const float h = cheb_segment_tangent<D>(s, seg[3 * j + 1], seg[3 * j + 2], c, dh_ds);
  const float sg = cheb_sign(a);
  const float ds_da = sg * cheb_clip_slope(x, 0.f, p[0]);
  m = 1.f - sg * (dh_ds * ds_da);
  return a - sg * h;
}

// m = db/da alone (the adjoint's pass 1): the value's last lines are dropped
// by the compiler.
template <int D>
__host__ __device__ __forceinline__ float cheb_root_tangent(float a, const float* p, int n_seg) {
  float m;
  cheb_root_value_tangent<D>(a, p, n_seg, m);
  return m;
}

// One step of the LPF clipper around the root (cheb.cu's kernels):
//   b_temp = -p1R (z - v),  a = z + b_temp,  z' = root(a) + b_temp,
//   out = (z' + z) / 2;
// z is the state, updated.  Returns the output.
template <class Root>
__host__ __device__ __forceinline__ float cheb_clipper_step(float v, float p1R, float& z,
                                                            Root root) {
  const float b_temp = -p1R * (z - v);
  const float a = z + b_temp;
  const float z_new = root(a) + b_temp;
  const float o = 0.5f * (z_new + z);
  z = z_new;
  return o;
}

}  // namespace
