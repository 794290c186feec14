// A general MLP root (mlp_dense.cuh) shared by K lanes of one warp: the lane
// form of the generated forward (ops/circuit_codegen.py, _DenseEmitter),
// nxh_lanes.cuh's scheme for any widths and any activation of the JSON schema.
//
// The one-thread form runs every output of every layer on one thread: for a
// 2x8 root ~180 dependent FMAs a sample, and for a sigmoid 2x8 24 expf and 24
// IEEE divisions one after the other; at B = 1 31 lanes of the warp idle.
// Here a group of K lanes serves one stream (the tree on every lane, the same
// bits), and the MLP is split across the group:
//   - a hidden layer's outputs: lane `rank` owns N = OUT / K consecutive
//     outputs, j = rank N .. rank N + N - 1, and reads its N columns of W and
//     of b, in registers where a lane's weights fit (DenseLaneLayer, kRegs),
//     else from shared memory in 16- or 8-byte words (the root array keeps
//     every block at a multiple of 4 floats);
//   - a layer's input x_i comes from its owner by __shfl_sync inside the
//     group (the first layer's [a, log R] is on every lane), in dense_layer's
//     order i = 0 .. IN - 1, and each output keeps dense_layer's fmaf chain
//     over IN with the bias added after it: every output has the one-thread
//     bits, and each activation is dense_act, the one-thread function;
//   - a softmax layer gathers its OUT outputs on every lane and runs
//     dense_softmax there (the max, the sum and the divisions in the
//     one-thread order), each lane keeping its own;
//   - the head (the last layer) gathers its inputs on every lane and
//     computes all its outputs there in dense_layer's order, so every lane
//     ends the step with the same b.
// Every lane of the warp calls these functions together (the shuffles use
// the full mask with width K); a group's lanes are K consecutive lanes.

#pragma once

#include <cuda_runtime.h>

#include "mlp_dense.cuh"
#include "nxh_lanes.cuh"  // nxh_load

namespace {

// The weights of one layer that a lane reads every sample: its N = OUT / K
// columns of W [IN][OUT] and of b, or with kWhole (the head) all OUT; held
// in registers with kRegs, else nothing (read from shared memory).
template <int IN, int OUT, int K, bool kWhole, bool kRegs>
struct DenseLaneLayer {
  static_assert(kWhole || OUT % K == 0, "K must divide a split layer's width");
  static constexpr int N = kWhole ? OUT : OUT / K;
  float W[kRegs ? IN : 1][kRegs ? N : 1];
  float b[kRegs ? N : 1];

  __device__ __forceinline__ void load(const float* W_, const float* b_, int rank) {
    if constexpr (kRegs) {
      const int j0 = kWhole ? 0 : rank * N;
#pragma unroll
      for (int i = 0; i < IN; ++i) nxh_load<N>(W_ + i * OUT + j0, W[i]);
      nxh_load<N>(b_ + j0, b);
    }
  }
};

// One layer on the group: x the layer's input, whole on every lane
// (kSplitIn false: IN values) or split as the previous layer's outputs
// (kSplitIn: the lane's IN / K); y the lane's N outputs (all OUT with
// kWhole).  W, b: the layer's blocks of the root array in shared memory.
template <int IN, int OUT, int ACT, int K, bool kSplitIn, bool kWhole, bool kRegs>
__device__ __forceinline__ void dense_layer_lanes(const float* W, const float* b,
                                                  const float* x, float* y, int rank,
                                                  const DenseLaneLayer<IN, OUT, K, kWhole, kRegs>& lw) {
  static_assert(K <= 32 && (K & (K - 1)) == 0, "K must be a power of 2");
  static_assert(!kSplitIn || IN % K == 0, "K must divide a split input's width");
  constexpr int N = kWhole ? OUT : OUT / K;    // the outputs this lane computes
  constexpr int NI = kSplitIn ? IN / K : IN;  // the inputs this lane holds
  const int j0 = kWhole ? 0 : rank * N;
  float acc[N];
#pragma unroll
  for (int jj = 0; jj < N; ++jj) acc[jj] = 0.f;
#pragma unroll
  for (int i = 0; i < IN; ++i) {
    float xi;
    if constexpr (kSplitIn) {
      xi = __shfl_sync(0xffffffffu, x[i % NI], i / NI, K);
    } else {
      xi = x[i];
    }
    float wr[N];
    if constexpr (kRegs) {
#pragma unroll
      for (int jj = 0; jj < N; ++jj) wr[jj] = lw.W[i][jj];
    } else {
      nxh_load<N>(W + i * OUT + j0, wr);
    }
#pragma unroll
    for (int jj = 0; jj < N; ++jj) acc[jj] = fmaf(xi, wr[jj], acc[jj]);
  }
  float bias[N];
  if constexpr (kRegs) {
#pragma unroll
    for (int jj = 0; jj < N; ++jj) bias[jj] = lw.b[jj];
  } else {
    nxh_load<N>(b + j0, bias);
  }
#pragma unroll
  for (int jj = 0; jj < N; ++jj) y[jj] = acc[jj] + bias[jj];
  if constexpr (ACT == kDenseSoftmax) {
    float all[OUT];
#pragma unroll
    for (int k = 0; k < OUT; ++k) {
      all[k] = kWhole ? y[k] : __shfl_sync(0xffffffffu, y[k % N], k / N, K);
    }
    dense_softmax<OUT>(all);
#pragma unroll
    for (int k = 0; k < OUT; ++k) {
      if (kWhole) {
        y[k] = all[k];
      } else if (k / N == rank) {
        y[k % N] = all[k];  // compile-time indices: the lane's own outputs stay in registers
      }
    }
  } else {
#pragma unroll
    for (int jj = 0; jj < N; ++jj) y[jj] = dense_act<ACT>(y[jj]);
  }
}

}  // namespace
