// Per-sample functions of the clipper's training kernels (clipper_train.cu):
// the forward step, which the lane kernel and the one-thread kernel share;
// the tangent, which pass 1 and the one-pass adjoint share; the reverse step
// of pass 2, with the one-pass kernel's roundings; the scratch layout.  The
// CPU tests compile them on the host (a stand-in cuda_runtime.h defines the
// CUDA qualifiers away).
//
// Forward step (s = capacitor state z, p = p1R of the row, y = MLP(a)):
//   b_temp = -p (z - v),  a = z + b_temp,  z' = -y + b_temp,  o = (z' + z) / 2.
// Reverse step (m = dMLP/da at a_t, lam = lam_{t+1} on entry, lam_t on return):
//   c = -(m (1 - p) + p),  G = lam + g/2,  g_vin = p (1 - m) G,
//   lam = c lam + (1 + c) g/2.
//
// Rounding.  Every multiply-add of the two steps is written out as fmaf,
// and every other operation is one that cannot fuse, so that nvcc and ptxas
// cannot contract them differently in two kernels.  Left to them, the
// one-thread forward's tree was fused into two FFMAs at H = 16 and left as a
// multiply and adds at H = 4 and 8 (ptxas's choice, per register pressure),
// which a second kernel could not be held to.  The forward tree is written
// as that kernel ran at H = 16: a = fma(-p, z - v, z), z' = fma(-p, z - v,
// -y), used by the one-thread and the lane kernel alike.  The reverse step is
// written as nvcc compiles the one-pass adjoint's plain expressions at every
// H (its SASS): u = fma(m, 1 - p, p) = -c, G = fma(g, 1/2, lam),
// lam = fma(g, (1 - u) / 2, -(u lam)); pass 2 runs it, the one-pass kernel
// keeps its plain expressions, and the card tests hold the two to the same
// bits.  The MLP and its tangent are nxh_mlp.cuh's (nxh_lanes.cuh's lane
// form has nxh_forward's bits).
//
// Weight buffer (floats), built by ops/fused_clipper.py train_weights:
//   w1a[H], w1r[H], b1[H], w3[H], b3, then for each of the L hidden layers
//   W[H][H] ([in][out]) and bias[H].  The lane kernel's copy in shared
//   memory puts three zeros after b3 (lane_weight), so that every block it
//   reads as 16-byte words starts at a multiple of 4 floats; the other
//   kernels read the buffer as it is (the one-thread kernels ran slower on
//   the padded copy).

#pragma once

#include <cuda_runtime.h>

#include "nxh_lanes.cuh"
#include "nxh_mlp.cuh"

namespace {

// where the hidden layers start: in the weight buffer, and in the lane
// kernel's copy
template <int H>
__host__ __device__ constexpr int train_hidden() {
  return 4 * H + 1;
}
template <int H>
__host__ __device__ constexpr int lane_hidden() {
  return 4 * H + 4;
}

template <int H>
__host__ __device__ constexpr int n_train_weights(int L) {
  return train_hidden<H>() + L * (H * H + H);
}
template <int H>
__host__ __device__ constexpr int n_lane_weights(int L) {
  return lane_hidden<H>() + L * (H * H + H);
}

// Float i (< n_lane_weights) of the lane kernel's copy of the weights.
template <int H>
__host__ __device__ __forceinline__ float lane_weight(const float* weights, int i) {
  return i < train_hidden<H>() ? weights[i] : i < lane_hidden<H>() ? 0.f : weights[i - 3];
}

// One forward step of stream state z at input v with the root y = root(a);
// writes the root's input a, returns the output o.
template <typename Root>
__device__ __forceinline__ float clipper_step(float v, float p, float& z, float& a, Root root) {
  const float d = z - v;
  a = fmaf(-p, d, z);
  const float z_new = fmaf(-p, d, -root(a));
  const float o = 0.5f * (z_new + z);
  z = z_new;
  return o;
}

// The one-thread kernel's step: the whole MLP on this thread.  c1: the
// stream's first-layer bias (nxh_first_bias).
template <int H, typename C1>
__device__ __forceinline__ float train_step(float v, float p, float& z, float& a, const float* w,
                                            const C1& c1, int L) {
  return clipper_step(v, p, z, a, [&](float x) {
    return nxh_forward<H>(x, w, c1, w + train_hidden<H>(), L, w + 3 * H, w[4 * H]);
  });
}

// The lane form's step on a group of K lanes (nxh_lanes.cuh): the tree on
// every lane, the MLP split; w: the lane kernel's copy of the weights
// (lane_weight); c1: the lane's N = H / K entries (nxh_first_bias_lanes).
// Every lane of the group returns the one-thread step's bits and ends with
// its z.
template <int H, int K, int L, bool kRegs>
__device__ __forceinline__ float train_step_lanes(float v, float p, float& z, float& a,
                                                  const float* w, const float* c1, int rank,
                                                  const NxhLaneWeights<H, K, L, kRegs>& lw) {
  return clipper_step(v, p, z, a, [&](float x) {
    return nxh_forward_lanes<H, K, L, true>(x, w, c1, w + lane_hidden<H>(), w + 3 * H,
                                            w[4 * H], rank, lw);
  });
}

// m = dMLP/da at a (pass 1 and the one-pass adjoint).
template <int H, typename C1>
__device__ __forceinline__ float adjoint_tangent(float a, const float* w, const C1& c1, int L) {
  return nxh_tangent<H>(a, w, c1, w + train_hidden<H>(), L, w + 3 * H);
}

// One reverse step at tangent m and output cotangent g: lam from lam_{t+1}
// to lam_t, G = G_t; returns g_vin_t.  The roundings of the one-pass
// kernel's step (above).
__device__ __forceinline__ float adjoint_update(float m, float g, float p, float& lam, float& G) {
  const float u = fmaf(m, 1.f - p, p);
  G = fmaf(g, 0.5f, lam);
  const float g_vin = p * (1.f - m) * G;
  lam = fmaf(g, (1.f - u) * 0.5f, -(u * lam));
  return g_vin;
}

// The adjoint's scratch: the pair (m, g) of sample (b, t) is float2 number
// [b / kAdjointGroup][t][b % kAdjointGroup], so that a group's steps are
// contiguous for pass 2 (one bulk copy a slab of steps, 64 bytes a step)
// and pass 1's block writes whole lines.  Streams past B up to the group's
// end hold zeros.
constexpr int kAdjointGroup = 8;

__host__ __device__ __forceinline__ size_t adjoint_scratch_index(int b, int t, int T) {
  return (static_cast<size_t>(b / kAdjointGroup) * T + t) * kAdjointGroup + b % kAdjointGroup;
}

}  // namespace
