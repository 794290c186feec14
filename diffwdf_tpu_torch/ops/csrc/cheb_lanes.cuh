// The distilled piecewise-Chebyshev root on a group of K lanes of one warp,
// one segment a lane (cheb.cu's cheb_lanes_kernel): the JAX kernel's
// evaluate-every-segment-then-select, with the segments spread over the
// group instead of evaluated one after the other.
//
// Lane j of a group holds segment j's two edge terms (hi + lo, hi - lo) and
// its D + 1 zero-padded coefficients in registers, and every segment's lower
// edge for the select; a lane past n_seg holds the last segment again.  A
// step on every lane of the group:
//   s = clip(|a|, 0, a_max); j* = the last k with !(s < lo_k), in
//   cheb_root's order; h_j = cheb_segment<D> of the lane's own segment;
//   h = h_j* from lane j* (one shuffle); b = a - sign(a) h.
// cheb_segment is cheb_root's own per-segment function, on the same f32
// values, so every lane's h is cheb_root<D>'s h, bit for bit, and every lane
// ends each step with the same b (the state is replicated, not exchanged).
// No shared-memory load and no loop over the segments is left on a sample's
// chain: a division, D dependent Clenshaw steps and a shuffle.
//
// Device code (the shuffle); the CPU tests build it on the host with a
// stand-in __shfl_sync (a group of lanes is K host threads).

#pragma once

#include <cuda_runtime.h>

#include "cheb.cuh"

namespace {

// A lane's registers: a_max, the lower edges of the group's segments (those
// past n_seg unread), and its own segment (min(rank, n_seg - 1)).
template <int D, int K>
struct ChebLane {
  static_assert(K >= 1 && K <= kMaxChebSegments && (K & (K - 1)) == 0,
                "a group of K = 1, 2, 4 or 8 lanes holds up to K segments");
  float a_max;
  float lo[K];
  float hpl, hml;
  float c[D + 1];
  int n_seg;

  // from the parameters p (cheb.cuh's layout) of a root of n_seg <= K segments
  __device__ __forceinline__ void load(const float* p, int n_seg_, int rank) {
    n_seg = n_seg_;
    a_max = p[0];
#pragma unroll
    for (int k = 0; k < K; ++k) lo[k] = k < n_seg ? p[1 + 3 * k] : 0.f;
    const int j = rank < n_seg ? rank : n_seg - 1;
    hpl = p[1 + 3 * j + 1];
    hml = p[1 + 3 * j + 2];
#pragma unroll
    for (int k = 0; k <= D; ++k) c[k] = p[1 + 3 * n_seg + j * (D + 1) + k];
  }
};

// b of the root at a on the group of K lanes `rank` belongs to (every lane of
// the warp calls it): cheb_root<D>'s b on every lane.
template <int D, int K>
__device__ __forceinline__ float cheb_root_lanes(float a, const ChebLane<D, K>& lane) {
  const float s = cheb_clip(fabsf(a), 0.f, lane.a_max);
  int j = 0;
#pragma unroll
  for (int k = 1; k < K; ++k) {
    if (k < lane.n_seg && !(s < lane.lo[k])) j = k;
  }
  const float h_own = cheb_segment<D>(s, lane.hpl, lane.hml, lane.c);
  const float h = __shfl_sync(0xffffffffu, h_own, j, K);
  return a - cheb_sign(a) * h;
}

}  // namespace
