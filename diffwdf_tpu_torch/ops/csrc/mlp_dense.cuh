// Device code of a general MLP root, b = -MLP([a, log R]), for the generated
// circuit forward (ops/circuit_codegen.py, _DenseEmitter): any layer widths
// and any activation per layer of the JSON schema (roots/neural.py _ACTS:
// tanh, relu, sigmoid, softmax, linear), as a JSON model that mixes relu and
// tanh loads.  The NxH family (all-tanh hidden layers, a linear head) keeps
// nxh_mlp.cuh and its lane form; this is the one-thread form of every other
// MLP (mlp_dense_lanes.cuh splits it over a group of lanes, on these
// functions).
//
// One layer is y = act(x W + b), W [IN][OUT] row-major (the JSON's kernel),
// the dot product summed over IN in order by fmaf and the bias added after
// it, as `x @ kernel + bias` reads.  Widths are compile-time constants, so
// the loops unroll and a layer's activations stay in registers; the weights
// are read from shared memory, where every thread of a warp reads the same
// address (a broadcast).  Exact f32 (fmaf, tanhf, expf, IEEE division): no
// fast-math intrinsics.  __host__ __device__, so a generated step that calls
// it also compiles for the host.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

enum DenseAct { kDenseLinear = 0, kDenseTanh = 1, kDenseRelu = 2, kDenseSigmoid = 3,
                kDenseSoftmax = 4 };

// An element-wise activation (not softmax) of one output.
template <int ACT>
__host__ __device__ __forceinline__ float dense_act(float y) {
  if (ACT == kDenseTanh) return tanhf(y);
  if (ACT == kDenseRelu) return y > 0.f ? y : 0.f;
  if (ACT == kDenseSigmoid) return 1.f / (1.f + expf(-y));
  return y;
}

// softmax over a layer's OUT outputs, the largest taken out first.
template <int OUT>
__host__ __device__ __forceinline__ void dense_softmax(float (&y)[OUT]) {
  float top = y[0];
#pragma unroll
  for (int k = 1; k < OUT; ++k) top = fmaxf(top, y[k]);
  float sum = 0.f;
#pragma unroll
  for (int k = 0; k < OUT; ++k) {
    y[k] = expf(y[k] - top);
    sum += y[k];
  }
#pragma unroll
  for (int k = 0; k < OUT; ++k) y[k] = y[k] / sum;
}

// y = act(x W + b) of one layer.
template <int IN, int OUT, int ACT>
__host__ __device__ __forceinline__ void dense_layer(const float* W, const float* b,
                                                     const float (&x)[IN], float (&y)[OUT]) {
#pragma unroll
  for (int k = 0; k < OUT; ++k) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < IN; ++i) acc = fmaf(x[i], W[i * OUT + k], acc);
    y[k] = acc + b[k];
  }
  if (ACT == kDenseSoftmax) {
    dense_softmax<OUT>(y);
  } else {
#pragma unroll
    for (int k = 0; k < OUT; ++k) y[k] = dense_act<ACT>(y[k]);
  }
}

}  // namespace
