// Per-sample functions of the clipper's serving kernels (fused_clipper.cu):
// the neural step with the whole NxH root on one thread and on a group of K
// lanes, and the analytic step with the two Wright-omega solves paired.  The
// CPU tests compile them on the host (a stand-in cuda_runtime.h defines the
// CUDA qualifiers away, and a group of lanes is K host threads).
//
// Neural step (z = capacitor state, p = p1R, y = MLP(a)): clipper_step of
// clipper_train.cuh, a = fma(-p, z - v, z), z' = fma(-p, z - v, -y),
// o = (z' + z) / 2, written with fmaf and operations that cannot fuse, so
// that the one-thread and the lane kernel round it alike; the lane form of
// the MLP (nxh_lanes.cuh) has nxh_forward's bits on every lane, so every lane
// of a group ends every step with the one-thread step's bits.
//
// Weight buffer (floats), built by ops/fused_clipper.py: w1a[H], c1[H]
// (the first-layer bias with log R folded in), w3[H], b3, then for each of
// the L hidden layers W[H][H] ([in][out]) and bias[H].  The lane kernel's
// copy in shared memory puts three zeros after b3 (serve_lane_weight), so
// that every block it reads as 16-byte words starts at a multiple of 4
// floats; the one-thread kernel reads the buffer as it is.
//
// Analytic step: the asymmetric diode pair of Werner eqn 45, its two omega
// solves branch-free with the Newton steps unrolled (omega_select of
// omega.cuh), on one thread or split over a pair of lanes.

#pragma once

#include <cuda_runtime.h>

#include "clipper_train.cuh"
#include "nxh_lanes.cuh"
#include "nxh_mlp.cuh"
#include "omega.cuh"
#include "omega_lanes.cuh"

namespace {

// where the hidden layers start: in the weight buffer, and in the lane
// kernel's copy
template <int H>
__host__ __device__ constexpr int serve_hidden() {
  return 3 * H + 1;
}
template <int H>
__host__ __device__ constexpr int serve_lane_hidden() {
  return 3 * H + 4;
}

template <int H>
__host__ __device__ constexpr int n_serve_weights(int L) {
  return serve_hidden<H>() + L * (H * H + H);
}
template <int H>
__host__ __device__ constexpr int n_serve_lane_weights(int L) {
  return serve_lane_hidden<H>() + L * (H * H + H);
}

// Float i (< n_serve_lane_weights) of the lane kernel's copy of the weights.
template <int H>
__host__ __device__ __forceinline__ float serve_lane_weight(const float* weights, int i) {
  return i < serve_hidden<H>() ? weights[i] : i < serve_lane_hidden<H>() ? 0.f : weights[i - 3];
}

// The one-thread kernel's step: the whole MLP on this thread, w the weight
// buffer as built.  Returns the output; z is the state.
template <int H>
__device__ __forceinline__ float serve_step(float v, float p, float& z, const float* w, int L) {
  float a;
  return clipper_step(v, p, z, a, [&](float x) {
    return nxh_forward<H>(x, w, w + H, w + serve_hidden<H>(), L, w + 2 * H, w[3 * H]);
  });
}

// The lane form's step on a group of K lanes: the tree on every lane, the
// MLP split (the whole c1 read from w); w the lane kernel's copy of the
// weights (serve_lane_weight).  Every lane of the group returns the
// one-thread step's bits and ends with its z.
template <int H, int K, int L, bool kRegs>
__device__ __forceinline__ float serve_step_lanes(float v, float p, float& z, const float* w,
                                                  int rank,
                                                  const NxhLaneWeights<H, K, L, kRegs>& lw) {
  float a;
  return clipper_step(v, p, z, a, [&](float x) {
    return nxh_forward_lanes<H, K, L, false>(x, w, w + H, w + serve_lane_hidden<H>(), w + 2 * H,
                                             w[3 * H], rank, lw);
  });
}

struct AnalyticConsts {
  float p1R;     // G_source / (G_source + G_cap)
  float log_up;  // log(R_up Is / (n_up Vt))
  float log_dn;  // log(R_up Is / (n_down Vt))
  float inv_up;  // 1 / (n_up Vt)
  float inv_dn;  // 1 / (n_down Vt)
  float two_vt;  // 2 Vt
  float n_up;
  float n_dn;
};

// One analytic clipper step of state z at input v: the diode pair with its
// two omega solves on the pair of lanes `rank` belongs to (K = 2,
// omega_pair_lanes: the kernel's; the tree on both lanes, which end with the
// same bits) or on one thread (K = 1, omega_pair: the reference the CPU
// tests hold the lanes to); ITERS Newton steps (ITERS < 0: the run-time
// count iters).  Returns the output.  The branch of the pair is a select on
// a >= 0.  Every multiply-add is written out as fmaf and every other
// product as __fmul_rn, which nvcc cannot contract, so that the two forms
// round the tree alike (left to nvcc, a kernel of each did not).
template <int ITERS, int K>
__device__ __forceinline__ float analytic_step(float v, float& z, const AnalyticConsts& c,
                                               int rank, int iters = ITERS) {
  static_assert(K == 1 || K == 2, "the pair's two solves take one or two lanes");
  const float d = z - v;
  const float b_temp = __fmul_rn(-c.p1R, d);
  const float a = fmaf(-c.p1R, d, z);
  const float lam = sign0(a);
  const bool pos = a >= 0.f;
  const float mu0 = pos ? c.n_dn : c.n_up;
  const float mu1 = pos ? c.n_up : c.n_dn;
  const float log0 = pos ? c.log_dn : c.log_up;
  const float log1 = pos ? c.log_up : c.log_dn;
  const float inv0 = pos ? c.inv_dn : c.inv_up;
  const float inv1 = pos ? c.inv_up : c.inv_dn;
  const float la = __fmul_rn(lam, a);
  const float x0 = fmaf(la, inv0, log0), x1 = fmaf(-la, inv1, log1);
  float w0, w1;
  if constexpr (K == 1) {
    omega_pair<ITERS>(x0, x1, w0, w1, iters);
  } else {
    omega_pair_lanes<ITERS>(x0, x1, w0, w1, rank, iters);
  }
  const float m = fmaf(mu0, w0, -__fmul_rn(mu1, w1));
  const float b_root = fmaf(-__fmul_rn(c.two_vt, lam), m, a);
  const float z_new = b_root + b_temp;
  const float o = __fmul_rn(0.5f, z_new + z);
  z = z_new;
  return o;
}

}  // namespace
