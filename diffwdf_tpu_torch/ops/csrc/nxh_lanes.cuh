// The "NxH" neural diode root shared by K lanes of one warp.
//
// Used by the generated forward kernel (ops/circuit_codegen.py, B7) for NxH
// roots and by the clipper's serving and training forward kernels
// (fused_clipper.cu, B1; clipper_train.cu, B3).  One stream's chain of
// samples is the whole cost of the
// one-thread-per-stream kernel: ~1,200 operations a sample, 1,168 of them in
// the MLP (Tube Screamer 2x16), all on one thread.  Here a group of K lanes
// serves one stream: the scalar tree runs on every lane of the group (the
// same inputs, the same bits), and the MLP is split across the lanes:
//   - lane `rank` owns the N = H / K neurons j = rank N .. rank N + N - 1 of
//     every layer: a block of N consecutive weight columns, held in
//     registers where they fit (NxhLaneWeights), else read from shared
//     memory in 16-byte words (the K lanes of a group read consecutive
//     words, the other groups of the warp the same words);
//   - a layer's input h_i (i = 0 .. H-1) is fetched from its owner with
//     __shfl_sync inside the group, in nxh_forward's order, and each neuron
//     keeps nxh_forward's FMA chain over i: every activation has the bits of
//     the one-thread version;
//   - the head gathers all H activations on every lane and runs
//     nxh_forward's sequential FMA chain there, so y has the same bits on
//     every lane of the group, and the same bits as nxh_forward (a butterfly
//     sum would also agree across lanes, since IEEE addition commutes, but
//     would round the head differently from the plain version).
// Every lane therefore ends each step with bit-identical b and state, which
// the replicated tree needs: lanes that drifted apart would run different
// chains.
//
// Every lane of the warp calls these functions together (the shuffles use
// the full mask with width K); a group's lanes are K consecutive lanes.
// Exact f32 throughout (fmaf, tanhf), as nxh_mlp.cuh.

#pragma once

#include <cuda_runtime.h>

namespace {

// out[0 .. N-1] = p[0 .. N-1] in 16- or 8-byte words where N allows (p then
// 16- or 8-byte aligned: the root array keeps every block it reads at a
// multiple of 4 floats).
template <int N>
__device__ __forceinline__ void nxh_load(const float* p, float (&out)[N]) {
  if constexpr (N % 4 == 0) {
#pragma unroll
    for (int q = 0; q < N / 4; ++q) {
      const float4 x = reinterpret_cast<const float4*>(p)[q];
      out[4 * q] = x.x;
      out[4 * q + 1] = x.y;
      out[4 * q + 2] = x.z;
      out[4 * q + 3] = x.w;
    }
  } else if constexpr (N % 2 == 0) {
#pragma unroll
    for (int q = 0; q < N / 2; ++q) {
      const float2 x = reinterpret_cast<const float2*>(p)[q];
      out[2 * q] = x.x;
      out[2 * q + 1] = x.y;
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) out[i] = p[i];
  }
}

// c1[jj] = w1r[j] log_r + b1[j] for this lane's neurons j = rank N + jj:
// nxh_first_bias for the lane's own entries.
template <int H, int K>
__device__ __forceinline__ void nxh_first_bias_lanes(const float* w1r, const float* b1,
                                                     float log_r, int rank, float* c1) {
  constexpr int N = H / K;
#pragma unroll
  for (int jj = 0; jj < N; ++jj) c1[jj] = fmaf(w1r[rank * N + jj], log_r, b1[rank * N + jj]);
}

// The weights a lane reads every sample: its N columns of every hidden
// layer and the head's H weights.  With kRegs (where they take few
// registers: N H L + H <= 96) they are loaded once per stream into
// registers, which takes them off the shared-memory pipe that the shuffles
// also use; else they are read from shared memory each sample.
template <int H, int K, int L, bool kRegs>
struct NxhLaneWeights {
  static constexpr int N = H / K;
  float W[kRegs ? (L > 0 ? L : 1) : 1][kRegs ? H : 1][kRegs ? N : 1];
  float w3[kRegs ? H : 1];

  __device__ __forceinline__ void load(const float* hidden, const float* w3_, int rank) {
    if constexpr (kRegs) {
#pragma unroll
      for (int l = 0; l < L; ++l) {
#pragma unroll
        for (int i = 0; i < H; ++i) {
          nxh_load<N>(hidden + l * (H * H + H) + i * H + rank * N, W[l][i]);
        }
      }
      nxh_load<H>(w3_, w3);
    }
  }
};

// y = MLP(a) on a group of K lanes (see above), L hidden layers.  c1 holds
// the first layer's bias: all H entries (kLocalC1 false, shared memory) or
// the lane's N entries (kLocalC1 true, from nxh_first_bias_lanes).  lw: the
// lane's weights in registers, or none (then read from shared memory).
template <int H, int K, int L, bool kLocalC1, bool kRegs>
__device__ __forceinline__ float nxh_forward_lanes(float a, const float* w1a, const float* c1,
                                                   const float* hidden, const float* w3, float b3,
                                                   int rank,
                                                   const NxhLaneWeights<H, K, L, kRegs>& lw) {
  static_assert(H % K == 0 && K <= 32 && (K & (K - 1)) == 0, "K must divide H, a power of 2");
  constexpr int N = H / K;
  const int j0 = rank * N;
  float h[N], wa[N], cb[N];
  nxh_load<N>(w1a + j0, wa);
  if constexpr (kLocalC1) {
#pragma unroll
    for (int jj = 0; jj < N; ++jj) cb[jj] = c1[jj];
  } else {
    nxh_load<N>(c1 + j0, cb);
  }
#pragma unroll
  for (int jj = 0; jj < N; ++jj) h[jj] = tanhf(fmaf(a, wa[jj], cb[jj]));
#pragma unroll
  for (int l = 0; l < L; ++l) {
    const float* W = hidden + l * (H * H + H);
    float acc[N];
    nxh_load<N>(W + H * H + j0, acc);  // the bias
#pragma unroll
    for (int i = 0; i < H; ++i) {
      const float hi = __shfl_sync(0xffffffffu, h[i % N], i / N, K);
      float wr[N];
      if constexpr (kRegs) {
#pragma unroll
        for (int jj = 0; jj < N; ++jj) wr[jj] = lw.W[l][i][jj];
      } else {
        nxh_load<N>(W + i * H + j0, wr);
      }
#pragma unroll
      for (int jj = 0; jj < N; ++jj) acc[jj] = fmaf(hi, wr[jj], acc[jj]);
    }
#pragma unroll
    for (int jj = 0; jj < N; ++jj) h[jj] = tanhf(acc[jj]);
  }
  float head[H];
  if constexpr (kRegs) {
#pragma unroll
    for (int i = 0; i < H; ++i) head[i] = lw.w3[i];
  } else {
    nxh_load<H>(w3, head);
  }
  float y = b3;
#pragma unroll
  for (int i = 0; i < H; ++i) y = fmaf(__shfl_sync(0xffffffffu, h[i % N], i / N, K), head[i], y);
  return y;
}

}  // namespace
