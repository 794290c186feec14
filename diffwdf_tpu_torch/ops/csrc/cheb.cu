// Fused LPF diode clipper with a distilled piecewise-Chebyshev root, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of diffwdf_tpu/ops/fused_clipper.py:
//   cheb_lanes_kernel<D, K>  <- fused_clipper_cheb / _cheb_kernel + _cheb_eval
//
// Per sample and stream (the clipper Vs(R) || C, one capacitor state z):
//   b_temp = -p1R (z - v),  a = z + b_temp,  b = cheb_root(a),
//   z' = b + b_temp,        out = (z' + z) / 2.
//
// What bounds it.  Per sample 8 bytes of traffic against a chain of
// dependent operations: the clips, an IEEE division and D Clenshaw steps (an
// FMA and an add each; D = 24 for the default degrees 24/16/12).  No
// transcendentals, and the state is used only by the recursion, so the whole
// sample is one short chain and the card's parallelism has to come from the
// streams.  Run one thread a stream, B = 8,192 fills 64 of the 132 SMs with
// four warps each, and the chain also carries the segment select (a
// run-time loop over the edges) and the selected segment's coefficients,
// read at addresses that depend on the state.
//
// Design.  A group of K consecutive lanes serves one stream, one segment a
// lane (cheb_lanes.cuh): each lane holds its segment's edge terms and
// zero-padded coefficients in registers, loaded once before the time loop,
// evaluates its segment at every sample, and one shuffle hands the selected
// segment's h to the group.  Every lane runs the tree on the same values and
// ends each step with the same bits: the state is replicated.  K = 4 for up
// to four segments (the default distilled root has three), K = 8 for five to
// eight.  R = 128 / K streams share a block of 128 threads, so B = 8,192
// gives 1,024 warps (K = 4), two a scheduler on every SM, and one group's
// chain overlaps another's.  vin and out move through (R, 32) row tiles
// (tile.cuh) as whole 128-byte lines; lane 0 of a group writes.  A warp
// whose streams all lie past B skips the steps (the block's barriers still
// see it), so a B = 1 launch runs one group's chain.
//
// Bits.  The segment's h is cheb_segment<D> of cheb.cuh on the same f32
// values as cheb_root<D>, and the select is cheb_root's, so the lane kernel
// gives cheb_root<D>'s bits (tests/test_torch_cheb_lanes.py).
// One kernel per (D, K) of CHEB_DEGREES x {4, 8}; at every D the
// coefficients stay in registers (ptxas: no spill).
//
// Numerics: IEEE division, no fast-math.  Interface: plain C, loaded with
// ctypes; the launch goes on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

#include "cheb.cuh"
#include "cheb_lanes.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 128;

template <int D, int K>
__global__ void __launch_bounds__(kThreads, 1)
cheb_lanes_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
                  float* __restrict__ out, float* __restrict__ zf, int B, int T,
                  const float* __restrict__ root, int n_seg, float p1R) {
  constexpr int R = kThreads / K;  // streams per block
  __shared__ RowTile<R> tile;
  const int rank = threadIdx.x % K;  // the lane's segment and place in its group
  const int row = threadIdx.x / K;
  const int b0 = blockIdx.x * R;
  const int b = b0 + row;
  const bool warp_live = b0 + (threadIdx.x & ~31) / K < B;
  ChebLane<D, K> lane;
  lane.load(root, n_seg, rank);
  float z = b < B ? z0[b] : 0.f;
  for (int t0 = 0; t0 < T; t0 += kTileCols) {
    const int tc = min(kTileCols, T - t0);
    rows_load<R>(tile, vin, B, T, b0, t0, tc);
    if (warp_live) {
      for (int k = 0; k < tc; ++k) {
        const float o = cheb_clipper_step(tile[row][k], p1R, z,
                                          [&](float a) { return cheb_root_lanes<D, K>(a, lane); });
        __syncwarp();  // every lane of the group has read v_t
        if (rank == 0) tile[row][k] = o;
      }
    }
    rows_store<R>(tile, out, B, T, b0, t0, tc);
  }
  if (b < B && rank == 0) zf[b] = z;
}

template <int D>
cudaError_t launch_cheb_lanes(const float* vin, const float* z0, float* out, float* zf, int B,
                              int T, const float* root, int n_seg, float p1R,
                              cudaStream_t stream) {
  if (n_seg <= 4) {
    constexpr int R = kThreads / 4;
    cheb_lanes_kernel<D, 4><<<(B + R - 1) / R, kThreads, 0, stream>>>(vin, z0, out, zf, B, T,
                                                                      root, n_seg, p1R);
  } else {
    constexpr int R = kThreads / 8;
    cheb_lanes_kernel<D, 8><<<(B + R - 1) / R, kThreads, 0, stream>>>(vin, z0, out, zf, B, T,
                                                                      root, n_seg, p1R);
  }
  return cudaGetLastError();
}

// f(std::integral_constant<int, D>) for a degree of CHEB_DEGREES, after
// checking the parameter count; anything else is an invalid value.
template <typename F>
cudaError_t by_degree(int n_root, int n_seg, int degree, F f) {
  if (n_seg < 1 || n_seg > kMaxChebSegments || n_root != 1 + n_seg * (degree + 4)) {
    return cudaErrorInvalidValue;
  }
  switch (degree) {
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    case 24: return f(std::integral_constant<int, 24>{});
    case 32: return f(std::integral_constant<int, 32>{});
    case 48: return f(std::integral_constant<int, 48>{});
    case 64: return f(std::integral_constant<int, 64>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// B6: K = 4 lanes a stream for up to four segments, 8 for five to eight.
int fused_clipper_cheb_launch(const float* vin, const float* z0, float* out, float* zf, int B,
                              int T, const float* root, int n_root, int n_seg, int degree,
                              float p1R, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_degree(n_root, n_seg, degree, [&](auto d) {
    return launch_cheb_lanes<decltype(d)::value>(vin, z0, out, zf, B, T, root, n_seg, p1R, s);
  }));
}

}  // extern "C"
