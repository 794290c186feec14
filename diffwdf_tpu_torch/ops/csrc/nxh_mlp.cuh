// Device code of the "NxH" neural diode root, shared by the clipper kernels.
//
// The root is an all-tanh MLP with a linear head on the input [a, log R]:
//   h = tanh(w1a a + c1),  c1 = w1r log R + b1     (first layer, width H)
//   h = tanh(W^T h + b)                             (L hidden H->H layers)
//   y = w3 . h + b3                                 (head)
// and the root reflects b = -y.
//
// fused_clipper.cu (neural_kernel<H>, serving) folds log R into c1 on the
// host; clipper_train.cu (the training forward and its adjoint) builds c1 per
// stream with nxh_first_bias, so that the adjoint differentiates exactly the
// MLP the forward ran.  The H outputs of a layer are independent FMA chains,
// fully unrolled over H, so activations stay in registers; the hidden-layer
// loop over L is a runtime loop.  Weights are read from shared memory, where
// every lane of a warp reads the same address (a broadcast).
//
// Hidden weights are laid out per layer as W[H][H] ([in][out]) then bias[H].
// Exact f32 throughout (fmaf, tanhf): no fast-math intrinsics.

#pragma once

#include <cuda_runtime.h>

namespace {

// c1[j] = w1r[j] log_r + b1[j]: the first layer's bias with the log-R input
// folded in, for one stream.
template <int H>
__device__ __forceinline__ void nxh_first_bias(const float* w1r, const float* b1, float log_r,
                                               float (&c1)[H]) {
#pragma unroll
  for (int j = 0; j < H; ++j) c1[j] = fmaf(w1r[j], log_r, b1[j]);
}

// y = MLP(a).  C1 is a pointer into shared memory or a per-thread array.
template <int H, typename C1>
__device__ __forceinline__ float nxh_forward(float a, const float* w1a, const C1& c1,
                                             const float* hidden, int L, const float* w3,
                                             float b3) {
  float h[H];
#pragma unroll
  for (int j = 0; j < H; ++j) h[j] = tanhf(fmaf(a, w1a[j], c1[j]));
  for (int l = 0; l < L; ++l) {
    const float* W = hidden + l * (H * H + H);
    const float* bias = W + H * H;
    float g[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      float acc = bias[k];
#pragma unroll
      for (int i = 0; i < H; ++i) acc = fmaf(h[i], W[i * H + k], acc);
      g[k] = tanhf(acc);
    }
#pragma unroll
    for (int k = 0; k < H; ++k) h[k] = g[k];
  }
  float y = b3;
#pragma unroll
  for (int j = 0; j < H; ++j) y = fmaf(h[j], w3[j], y);
  return y;
}

// y = MLP(a) and m = dMLP/da in one pass: the forward with its tangent
// carried in closed form,
//   dh = (1 - h^2) w1a,  dg = (1 - g^2) (W^T dh),  m = w3 . dh
// (the jvp of tanh).  The activations h are computed exactly as in
// nxh_forward; the tangent doubles a hidden layer's FMAs and adds no tanhf.
// The DEER kernels take both (b for the step map, m for its Jacobian).
template <int H, typename C1>
__device__ __forceinline__ float nxh_forward_tangent(float a, const float* w1a, const C1& c1,
                                                     const float* hidden, int L, const float* w3,
                                                     float b3, float& m) {
  float h[H], dh[H];
#pragma unroll
  for (int j = 0; j < H; ++j) {
    h[j] = tanhf(fmaf(a, w1a[j], c1[j]));
    dh[j] = (1.f - h[j] * h[j]) * w1a[j];
  }
  for (int l = 0; l < L; ++l) {
    const float* W = hidden + l * (H * H + H);
    const float* bias = W + H * H;
    float g[H], dg[H];
#pragma unroll
    for (int k = 0; k < H; ++k) {
      float acc = bias[k];
      float dacc = 0.f;
#pragma unroll
      for (int i = 0; i < H; ++i) {
        acc = fmaf(h[i], W[i * H + k], acc);
        dacc = fmaf(dh[i], W[i * H + k], dacc);
      }
      g[k] = tanhf(acc);
      dg[k] = (1.f - g[k] * g[k]) * dacc;
    }
#pragma unroll
    for (int k = 0; k < H; ++k) {
      h[k] = g[k];
      dh[k] = dg[k];
    }
  }
  float y = b3, dy = 0.f;
#pragma unroll
  for (int j = 0; j < H; ++j) {
    y = fmaf(h[j], w3[j], y);
    dy = fmaf(dh[j], w3[j], dy);
  }
  m = dy;
  return y;
}

// m = dMLP/da at a alone (the adjoints): nxh_forward_tangent's tangent, its
// head's output unused and dropped by the compiler.
template <int H, typename C1>
__device__ __forceinline__ float nxh_tangent(float a, const float* w1a, const C1& c1,
                                             const float* hidden, int L, const float* w3) {
  float m;
  nxh_forward_tangent<H>(a, w1a, c1, hidden, L, w3, 0.f, m);
  return m;
}

// Copy n floats of weights into the block's shared memory.
__device__ __forceinline__ void stage_weights(float* sw, const float* weights, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) sw[i] = weights[i];
  __syncthreads();
}

}  // namespace
