// Per-sample functions of the clipper's training kernels (clipper_train.cu):
// the forward step, which the lane kernel and the one-thread kernel share;
// the tangent of pass 1; the reverse step of pass 2; the scratch layout; pass
// 3's forward and backward of one sample, its record, and how a warp's lanes
// share its sums (the plan, each lane's jobs, their sums).  The
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
// (slot l - 1 holds h_l, slot L + l holds d_l); the kernel keeps them in the
// sample's record (ParamRecord) beside [a, log R, 1, dy], and the lanes of
// the warp that ran the sample add its outer products to sums they hold in
// registers (param_job: each lane its fixed share of the cotangents).

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

// One sample's record: slot r (param_sample's) at floats r H .. r H + H - 1,
// r = 0 .. 2L + 1, then the word [a, log R, 1, dy].  Its length is an odd
// number of 16-byte words, so that 8 lanes writing their records' same word
// at once fall on 8 different bank groups.
template <int H>
__host__ __device__ constexpr int param_record_floats(int L) {
  return (2 * L + 2) * H + 4;
}

template <int H>
struct ParamRecord {
  float* rec;
  __device__ __forceinline__ void put(int slot, const float (&v)[H]) {
#pragma unroll
    for (int c = 0; c < H / 4; ++c) {
      reinterpret_cast<float4*>(rec + slot * H)[c] =
          float4{v[4 * c], v[4 * c + 1], v[4 * c + 2], v[4 * c + 3]};
    }
  }
  __device__ __forceinline__ void get(int slot, float (&v)[H]) const {
    nxh_load<H>(rec + slot * H, v);
  }
};

// How the lanes of a warp share the cotangents at (H, L).  The hidden
// layers' kernels split into blocks of M x N entries (M = 4 consecutive rows
// i of h_l against N consecutive entries k of d_{l+1}: kernel_l's (i, k)),
// each with the sum of its N entries of d_{l+1} beside it (bias_l, kept
// where the block's rows start at 0); the rest into units: a scalar against
// a 4-entry chunk, with the sum of the chunk beside it, the first layer's a
// and log R against d_1 (kernel0's two rows; the sum of d_1 is bias0), the
// head's dy against h_{L+1} (its kernel), and 1 against [a, log R, 1, dy]
// (the sum of dy: the head's bias), 3 Q + 1 units (Q = H / 4) on 4 Q lanes.
// A lane holds one block and one unit.  A block's S lanes (param_plan: the
// largest power of 2 that leaves S times the blocks within 32) and a unit's
// 32 / (4 Q) lanes share a tile's samples, each summing over its share of
// them, so that each lane holds the same number of sums (no zero rows) and
// loads as few words for them as its registers allow (shared memory's
// bandwidth bounds the kernel).  Lanes past the last block or unit repeat a
// sum that is not kept.  Where the blocks outnumber the lanes, G groups of
// them (blockIdx.y) each take 32, every group running the samples again
// (the units in group 0).
template <int H>
struct ParamBlock {
  static constexpr int M = 4, N = H < 8 ? H : 8;
};

struct ParamPlan {
  int S, G;  // lanes a block (and samples a share: 32 / S); groups
};

template <int H>
__host__ __device__ constexpr ParamPlan param_plan(int L) {
  const int blocks = L * (H / ParamBlock<H>::M) * (H / ParamBlock<H>::N);
  int S = 32;
  while (S > 1 && blocks * S > 32) S /= 2;
  return {S, (blocks + 31) / 32};
}

// Lanes sharing one unit at width H (a share is H samples of a tile).
__host__ __device__ constexpr int param_unit_shares(int H) { return 32 / H; }

// One job of a lane: its left factor at float x of a record (M floats for a
// block, 1 for a unit), its right factor at float y (N floats, 4 for a
// unit), and where its sums go among the n_param_leaves: product (i, k) at
// leaf + i H + k (only >= 0: product (0, only) alone, at leaf), the right
// factor's sum k at row + k; each -1 for nowhere.  Only the first lane of a
// job's shares keeps its sums: the others' are added to them.
struct ParamJob {
  int x, y, leaf, row, only;
};

// The block (q == 0) or the unit (q == 1) of `lane` in group g at (H, L).
template <int H>
__host__ __device__ __forceinline__ ParamJob param_job(int L, int g, int lane, int q) {
  constexpr int Q = H / 4, M = ParamBlock<H>::M, N = ParamBlock<H>::N;
  const int vec = (2 * L + 2) * H;  // [a, log R, 1, dy]
  if (q == 0) {
    const ParamPlan plan = param_plan<H>(L);
    const int per = 32 / plan.S, j = g * per + lane % per, per_layer = H / M * (H / N);
    const bool keeps = lane < per;
    if (j >= L * per_layer) return {0, 0, -1, -1, -1};
    const int l = j / per_layer, ib = j % per_layer / (H / N), kb = j % (H / N);
    const int base = 3 * H + l * (H * H + H);
    return {l * H + M * ib, (L + 2 + l) * H + N * kb, keeps ? base + M * ib * H + N * kb : -1,
            keeps && ib == 0 ? base + H * H + N * kb : -1, -1};
  }
  const int u = lane % (4 * Q), head = 3 * H + L * (H * H + H);
  const bool keeps = lane < 4 * Q;
  if (g > 0 || u > 3 * Q) return {vec + 2, vec, -1, -1, -1};
  if (u < 2 * Q) {
    const int r = u / Q, c = u % Q;  // a or log R against d_1's chunk c
    return {vec + r, (L + 1) * H + 4 * c, keeps ? r * H + 4 * c : -1,
            keeps && r == 0 ? 2 * H + 4 * c : -1, -1};
  }
  if (u < 3 * Q) {
    const int c = u - 2 * Q;  // dy against h_{L+1}'s chunk c
    return {vec + 3, L * H + 4 * c, keeps ? head + 4 * c : -1, -1, -1};
  }
  return {vec + 2, vec, keeps ? head + H : -1, -1, 3};  // 1 against [a, log R, 1, dy]
}

// A job's sums: M x N products, then the right factor's N sums: entries
// e = 0 .. kEntries - 1 of param_entry in that order.
template <int M, int N>
struct ParamSums {
  static constexpr int kEntries = M * N + N;
  float p[M][N], row[N];
};

using ParamUnitSums = ParamSums<1, 4>;

// A warp's slice of shared memory at (H, L), in floats: its 32 records, and
// room for a lane's sums, entry e of every lane at e 32 + lane, at the end.
template <int H>
__host__ __device__ constexpr int param_slice_floats(int L) {
  constexpr int kSums = ParamSums<ParamBlock<H>::M, ParamBlock<H>::N>::kEntries +
                        ParamUnitSums::kEntries;
  return 32 * (param_record_floats<H>(L) > kSums ? param_record_floats<H>(L) : kSums);
}

// Where entry e of job j's sums (M x N) goes among the leaves, or -1.
template <int H, int M, int N>
__host__ __device__ __forceinline__ int param_leaf(const ParamJob& j, int e) {
  if (e >= M * N) return j.row < 0 ? -1 : j.row + e - M * N;
  if (j.leaf < 0 || (j.only >= 0 && e != j.only)) return -1;
  return j.only >= 0 ? j.leaf : j.leaf + e / N * H + e % N;
}

template <int M, int N>
__host__ __device__ __forceinline__ float& param_entry(ParamSums<M, N>& r, int e) {
  return e < M * N ? r.p[e / N][e % N] : r.row[e - M * N];
}

// Adds to r the sums over the samples [s0, s1) of the records from rec on
// (`stride` floats apart), u the M floats at x and v the N at y of a record:
// u[i] v[k] and v[k], in sample order.
template <int M, int N>
__device__ __forceinline__ void param_accumulate(const float* rec, int stride, int s0, int s1,
                                                 int x, int y, ParamSums<M, N>& r) {
  float t[M][N] = {}, tr[N] = {};
#pragma unroll 2
  for (int s = s0; s < s1; ++s) {
    float u[M], v[N];
    nxh_load<M>(rec + s * stride + x, u);
    nxh_load<N>(rec + s * stride + y, v);
#pragma unroll
    for (int k = 0; k < N; ++k) {
#pragma unroll
      for (int i = 0; i < M; ++i) t[i][k] = fmaf(u[i], v[k], t[i][k]);
      tr[k] += v[k];
    }
  }
#pragma unroll
  for (int k = 0; k < N; ++k) {
#pragma unroll
    for (int i = 0; i < M; ++i) r.p[i][k] += t[i][k];
    r.row[k] += tr[k];
  }
}

}  // namespace
