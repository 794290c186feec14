// Per-sample functions of the clipper's training kernels (clipper_train.cu):
// the forward step, which the lane kernel and the one-thread kernel share;
// the tangent of pass 1; the reverse step of pass 2; the scratch layout; pass
// 3's forward and backward of one sample and the jobs of its sums.  The
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
// written as nvcc compiled the plain expressions at every H (their SASS):
// u = fma(m, 1 - p, p) = -c, G = fma(g, 1/2, lam),
// lam = fma(g, (1 - u) / 2, -(u lam)).  The MLP and its tangent are nxh_mlp.cuh's (nxh_lanes.cuh's lane
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

// m = dMLP/da at a (pass 1).
template <int H, typename C1>
__device__ __forceinline__ float adjoint_tangent(float a, const float* w, const C1& c1, int L) {
  return nxh_tangent<H>(a, w, c1, w + train_hidden<H>(), L, w + 3 * H);
}

// One reverse step at tangent m and output cotangent g: lam from lam_{t+1}
// to lam_t, G = G_t; returns g_vin_t.
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

// ---------------------------------------------------------------------------
// Pass 3: the MLP parameters' cotangents
// ---------------------------------------------------------------------------
//
// With dy = -G_t, the cotangent of y = MLP([a_t, log R]), one sample's
// forward and backward are
//   h_1 = tanh(w1a a + w1r log R + b1),  h_{l+1} = tanh(W_l^T h_l + b_l),
//   d_{L+1} = (1 - h_{L+1}^2) (dy w3),   d_l = (1 - h_l^2) (W_l d_{l+1}),
// d_l the cotangent of layer l's pre-activation (W_l is hidden layer l,
// l = 1 .. L, [in][out]).  The parameters' cotangents are sums over samples
// of outer products:
//   first layer  [a, log R, 1] (x) d_1      -> kernel0 rows 0, 1 and bias0,
//   hidden l     h_l (x) d_{l+1}            -> kernel_l; the sum of d_{l+1} -> bias_l,
//   head         h_{L+1} dy                 -> the head's kernel; the sum of dy -> its bias.
// param_sample runs one sample and hands its h and d vectors to `rows`
// (slot l - 1 holds h_l, slot L + l holds d_l); the kernel sums the outer
// products over a tile of samples in jobs of 4 x 4 entries (param_job),
// each with the sum of its right factor beside it (the biases).

// rows.put(slot, v) / rows.get(slot, v): one sample's H floats of a slot.
// w: the lane kernel's copy of the weights (lane_weight: the hidden layers
// start at a multiple of 4 floats, so a weight row is read in 16-byte
// words).  The forward's activations have nxh_forward's bits.
template <int H, typename Rows>
__device__ __forceinline__ void param_sample(float a, float log_r, float dy, const float* w,
                                             int L, Rows& rows) {
  float h[H];
#pragma unroll
  for (int j = 0; j < H; ++j) h[j] = tanhf(fmaf(a, w[j], fmaf(w[H + j], log_r, w[2 * H + j])));
  rows.put(0, h);
  for (int l = 0; l < L; ++l) {
    const float* W = w + lane_hidden<H>() + l * (H * H + H);
    float acc[H];
    nxh_load<H>(W + H * H, acc);
#pragma unroll
    for (int i = 0; i < H; ++i) {
      float row[H];
      nxh_load<H>(W + i * H, row);
#pragma unroll
      for (int k = 0; k < H; ++k) acc[k] = fmaf(h[i], row[k], acc[k]);
    }
#pragma unroll
    for (int k = 0; k < H; ++k) h[k] = tanhf(acc[k]);
    rows.put(l + 1, h);
  }
  float d[H];
  {
    float w3[H];
    nxh_load<H>(w + 3 * H, w3);
#pragma unroll
    for (int j = 0; j < H; ++j) d[j] = (1.f - h[j] * h[j]) * (dy * w3[j]);
  }
  rows.put(2 * L + 1, d);
  for (int l = L - 1; l >= 0; --l) {
    const float* W = w + lane_hidden<H>() + l * (H * H + H);
    rows.get(l, h);
    float below[H];
#pragma unroll
    for (int i = 0; i < H; ++i) {
      float row[H];
      nxh_load<H>(W + i * H, row);
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < H; ++k) s = fmaf(row[k], d[k], s);
      below[i] = (1.f - h[i] * h[i]) * s;
    }
#pragma unroll
    for (int i = 0; i < H; ++i) d[i] = below[i];
    rows.put(L + 1 + l, d);
  }
}

// The cotangents in mlp_leaves order, flat: kernel0 (2, H), bias0 (H), each
// hidden layer's kernel (H, H) and bias (H), the head's kernel (H, 1) and
// bias (1).
template <int H>
__host__ __device__ constexpr int n_param_leaves(int L) {
  return 3 * H + L * (H * H + H) + H + 1;
}

// Jobs of a tile's sums, Q = H / 4 blocks of 4 entries a side: the first
// layer's Q (left factor [a, log R, 1, 0], right d_1's block kb), each
// hidden layer's Q^2 (h_l's block ib, d_{l+1}'s block kb), the head's Q
// (h_{L+1}'s block ib, right [dy, 0, 0, 0]).  u, v: the factors' slots, -1
// for the per-sample vectors.
struct ParamJob {
  int u, v, ib, kb;
};

template <int H>
__host__ __device__ constexpr int n_param_jobs(int L) {
  return 2 * (H / 4) + L * (H / 4) * (H / 4);
}

template <int H>
__host__ __device__ __forceinline__ ParamJob param_job(int j, int L) {
  constexpr int Q = H / 4;
  if (j < Q) return {-1, L + 1, 0, j};
  j -= Q;
  if (j < L * Q * Q) return {j / (Q * Q), L + 2 + j / (Q * Q), j % (Q * Q) / Q, j % Q};
  return {L, -1, j - L * Q * Q, 0};
}

// r[4 ii + kk] += u[ii] v[kk]; r[16 + kk] += v[kk].
__device__ __forceinline__ void param_accumulate(const float4& u, const float4& v, float (&r)[20]) {
  const float us[4] = {u.x, u.y, u.z, u.w}, vs[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int ii = 0; ii < 4; ++ii) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) r[4 * ii + kk] = fmaf(us[ii], vs[kk], r[4 * ii + kk]);
  }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) r[16 + kk] += vs[kk];
}

// Where entry e of job j's sums r goes among the n_param_leaves, or -1 for
// none (the first layer's fourth row, the bias sums of any job but a hidden
// layer's or the head's first left block, the head's zero columns).
template <int H>
__host__ __device__ __forceinline__ int param_leaf(int j, int L, int e) {
  constexpr int Q = H / 4;
  if (j < Q) return e < 12 ? e / 4 * H + 4 * j + e % 4 : -1;
  j -= Q;
  if (j < L * Q * Q) {
    const int base = 3 * H + j / (Q * Q) * (H * H + H), ib = j % (Q * Q) / Q, kb = j % Q;
    if (e < 16) return base + (4 * ib + e / 4) * H + 4 * kb + e % 4;
    return ib == 0 ? base + H * H + 4 * kb + e - 16 : -1;
  }
  const int base = 3 * H + L * (H * H + H), ib = j - L * Q * Q;
  if (e < 16) return e % 4 == 0 ? base + 4 * ib + e / 4 : -1;
  return ib == 0 && e == 16 ? base + H : -1;
}

}  // namespace
