// Fused LPF diode-clipper sample recursion for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of diffwdf_tpu/ops/fused_clipper.py:
//   analytic_pair_kernel<ITERS>  <- fused_clipper_analytic / _analytic_kernel + _omega_inline
//   neural_lanes_kernel<H, K, L> <- fused_clipper_neural / _neural_kernel
//
// Both run the same per-sample recursion of the clipper Vs(R) || C with a
// diode root on top (one capacitor state z per stream):
//   b_temp = -p1R (z - v),  a = z + b_temp,  b = root(a),
//   z' = b + b_temp,        out = (z' + z) / 2.
// The per-sample functions are clipper_serve.cuh's.
//
// What bounds them.  Per sample a stream reads 4 bytes and writes 4 bytes
// but runs a chain of ~1,200 operations (neural 2x16: 600 FMAs, 48 tanhf) or
// two Wright-omega solves (analytic: a region guess, 3 Newton steps of an
// expf and an IEEE division, an expf, each).  The recursion is strictly
// sequential in time, so one stream's chain of samples, not bytes, sets the
// time: the card's bandwidth would move a (8192, 2048) block in and out in
// ~40 us, and at B = 8192 one thread a stream gives each of 256 schedulers
// one warp.  The designs shorten the chain a sample waits on:
//   - Neural: a group of K lanes of a warp serves one stream (nxh_lanes.cuh):
//     the tree on every lane, the MLP's neurons split across the group, so a
//     sample's chain falls to ~H (L + 1) FMAs with their shuffles and L + 1
//     tanhf; R = 128 / K streams share a block.  K = 16 up to B = 2,048,
//     else 8 (ops/fused_clipper.py nxh_lanes).
//   - Analytic: the two omega solves are independent, and each runs
//     branch-free (the region guess a select, as the JAX kernel's) with its
//     Newton steps unrolled at compile time (omega_select, omega.cuh), so the
//     lanes of a warp, whose streams fall into different regions, never
//     diverge.  On one thread ptxas runs the two solves' division regions
//     one after the other, so a pair of lanes serves a stream: each lane
//     solves one, one shuffle swaps them, the tree runs on both; the chain
//     is one solve long.  A converged Newton step's zero residual
//     skips its division, whose range check sent it down the slow path.
// Both stage (B, T) through shared memory in (rows, 32) tiles (tile.cuh,
// nxh_lanes.cuh), so every global load and store is a whole 128-byte line
// and no sample waits on a global load.
//
// neural_kernel<H> (one thread a stream) serves every (H, L) the lane
// kernel is not built for.
//
// Numerics.  Exact f32 library calls only (expf, logf, tanhf, IEEE
// division): no fast-math intrinsics, whose error exceeds the parity budgets
// (analytic 5e-6, neural 2e-5 absolute).  sign(a) is 0 at a == 0, as
// jnp.sign and torch.sign give.  The neural lane kernel gives the one-thread
// kernel's bits on every lane.
//
// Interface.  Plain C, loaded with ctypes; every launch goes on the stream
// the caller passes and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

#include "clipper_serve.cuh"
#include "nxh_lanes.cuh"
#include "nxh_mlp.cuh"
#include "omega.cuh"
#include "tile.cuh"

namespace {

constexpr int kThreads = 128;

cudaError_t allow_smem(const void* kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}

// ---------------------------------------------------------------------------
// B2: the analytic diode pair
// ---------------------------------------------------------------------------

// A pair of lanes serves a stream (omega_pair_lanes: each lane solves one
// omega, the tree on both), R = 64 streams a block; vin in and out through
// (R, 32) row tiles, lane 0 of a pair writing.  ITERS Newton steps
// (ITERS < 0: the run-time `iters`).  A warp whose streams all lie past B
// skips the steps (the block's barriers still see it), so a B = 1 launch
// runs one warp's chain.
template <int ITERS>
__global__ void __launch_bounds__(kThreads)
analytic_pair_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
                     float* __restrict__ out, float* __restrict__ zf, int B, int T,
                     AnalyticConsts c, int iters) {
  constexpr int R = kThreads / 2;  // streams per block
  __shared__ RowTile<R> tile;
  const int rank = threadIdx.x % 2;
  const int row = threadIdx.x / 2;
  const int b0 = blockIdx.x * R;
  const int b = b0 + row;
  const bool warp_live = b0 + (threadIdx.x & ~31) / 2 < B;
  float z = b < B ? z0[b] : 0.f;
  for (int t0 = 0; t0 < T; t0 += kTileCols) {
    const int tc = min(kTileCols, T - t0);
    rows_load<R>(tile, vin, B, T, b0, t0, tc);
    if (warp_live) {
      for (int k = 0; k < tc; ++k) {
        const float o = analytic_step<ITERS, 2>(tile[row][k], z, c, rank, iters);
        __syncwarp();  // both lanes of the pair have read v_t
        if (rank == 0) tile[row][k] = o;
      }
    }
    rows_store<R>(tile, out, B, T, b0, t0, tc);
  }
  if (b < B && rank == 0) zf[b] = z;
}

template <int ITERS>
cudaError_t launch_analytic_pair(const float* vin, const float* z0, float* out, float* zf, int B,
                                 int T, const AnalyticConsts& c, int iters, cudaStream_t s) {
  constexpr int R = kThreads / 2;
  analytic_pair_kernel<ITERS><<<(B + R - 1) / R, kThreads, 0, s>>>(vin, z0, out, zf, B, T, c,
                                                                   iters);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// B1: the NxH neural root
// ---------------------------------------------------------------------------

// A group of K consecutive lanes serves one stream; a block of 128 threads
// holds R = 128 / K streams.  Every lane of a group runs the tree and ends
// each step with bit-identical state (nxh_lanes.cuh: every activation and
// the head have nxh_forward's bits on every lane), so the state is
// replicated, not exchanged.  v comes in and out goes back through (R, 32)
// row tiles that the block moves as whole lines; lane 0 of each group
// writes.  The weights sit in shared memory (serve_lane_weight's copy, the
// whole folded c1 among them); a lane holds its weight columns in registers
// where N H L + H <= 96 (NxhLaneWeights).  Rows past B run on zeros, so that
// every lane of a live warp shuffles; a warp with no row below B skips the
// steps.  Launch bounds (128, 1): no register cap, so no spill.
template <int H, int K, int L>
__global__ void __launch_bounds__(kThreads, 1)
neural_lanes_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
                    float* __restrict__ out, float* __restrict__ zf, int B, int T,
                    const float* __restrict__ weights, float p1R) {
  constexpr int R = kThreads / K;  // streams per block
  constexpr int kW = n_serve_lane_weights<H>(L);
  constexpr bool kRegs = (H / K) * H * L + H <= 96;
  extern __shared__ float4 lanes_smem[];  // 16-byte aligned: the lane form's word loads
  float* sw = reinterpret_cast<float*>(lanes_smem);
  for (int i = threadIdx.x; i < kW; i += blockDim.x) sw[i] = serve_lane_weight<H>(weights, i);
  __syncthreads();
  RowTile<R>& tile = *reinterpret_cast<RowTile<R>*>(sw + ((kW + 3) & ~3));
  const int rank = threadIdx.x % K;  // the lane's place in its stream's group
  const int row = threadIdx.x / K;
  const int b0 = blockIdx.x * R;
  const int b = b0 + row;
  const bool warp_live = b0 + (threadIdx.x & ~31) / K < B;
  NxhLaneWeights<H, K, L, kRegs> lw;
  lw.load(sw + serve_lane_hidden<H>(), sw + 2 * H, rank);
  float z = b < B ? z0[b] : 0.f;
  for (int t0 = 0; t0 < T; t0 += kTileCols) {
    const int tc = min(kTileCols, T - t0);
    rows_load<R>(tile, vin, B, T, b0, t0, tc);
    if (warp_live) {
      for (int k = 0; k < tc; ++k) {
        const float o = serve_step_lanes<H, K, L>(tile[row][k], p1R, z, sw, rank, lw);
        __syncwarp();  // every lane of the group has read v_t
        if (rank == 0) tile[row][k] = o;
      }
    }
    rows_store<R>(tile, out, B, T, b0, t0, tc);
  }
  if (b < B && rank == 0) zf[b] = z;
}

// The (H, L, K) the lane kernel is built for: the NxH families of the
// pretrained zoo and the card tests (2x4, 4x4; 2x8, 4x8; 1x16, 2x16), each
// at the K that ops/fused_clipper.py nxh_lanes can pick for its width (the
// training forward's set, csrc/clipper_train.cu).  Any other triple is an
// invalid value.
template <typename F>
cudaError_t by_family(int H, int L, int K, F f) {
#define SERVE_FAMILY(h, l, k) \
  if (H == h && L == l && K == k) return f(std::integral_constant<int, h>{}, \
                                           std::integral_constant<int, l>{}, \
                                           std::integral_constant<int, k>{});
  SERVE_FAMILY(4, 2, 4)
  SERVE_FAMILY(4, 4, 4)
  SERVE_FAMILY(8, 2, 8)
  SERVE_FAMILY(8, 4, 8)
  SERVE_FAMILY(16, 1, 8)
  SERVE_FAMILY(16, 1, 16)
  SERVE_FAMILY(16, 2, 8)
  SERVE_FAMILY(16, 2, 16)
#undef SERVE_FAMILY
  return cudaErrorInvalidValue;
}

// One thread a stream over all T, weights in shared memory (a broadcast),
// the (B, T) streams read and written in place (a 128-byte line holds 32
// steps of one stream and stays in L1 for them), L a run-time loop.  It
// serves the (H, L) the lane kernel is not built for.  Its step is
// serve_step, the lane form's tree.
template <int H>
__global__ void __launch_bounds__(kThreads)
neural_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
              float* __restrict__ out, float* __restrict__ zf, int B, int T,
              const float* __restrict__ weights, int L, float p1R) {
  extern __shared__ float sw[];
  stage_weights(sw, weights, n_serve_weights<H>(L));

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* v = vin + static_cast<size_t>(b) * T;
  float* o = out + static_cast<size_t>(b) * T;
  float z = z0[b];
  for (int t = 0; t < T; ++t) o[t] = serve_step<H>(v[t], p1R, z, sw, L);
  zf[b] = z;
}

template <int H>
cudaError_t launch_neural(const float* vin, const float* z0, float* out, float* zf,
                          int B, int T, const float* weights, int L, float p1R,
                          cudaStream_t stream) {
  const size_t smem = sizeof(float) * static_cast<size_t>(n_serve_weights<H>(L));
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(neural_kernel<H>), smem);
  if (e != cudaSuccess) return e;
  const int blocks = (B + kThreads - 1) / kThreads;
  neural_kernel<H><<<blocks, kThreads, smem, stream>>>(vin, z0, out, zf, B, T, weights, L, p1R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// B2: both omega solves branch-free and unrolled, a pair of lanes a stream;
// kernels built for iters 1, 2 and 3 (quality low, good, best), a run-time
// loop for any other count.
int fused_clipper_analytic_launch(const float* vin, const float* z0, float* out, float* zf,
                                  int B, int T, float p1R, float log_up, float log_dn,
                                  float inv_up, float inv_dn, float two_vt, float n_up,
                                  float n_dn, int iters, void* stream) {
  const AnalyticConsts c{p1R, log_up, log_dn, inv_up, inv_dn, two_vt, n_up, n_dn};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (iters) {
    case 1: return static_cast<int>(launch_analytic_pair<1>(vin, z0, out, zf, B, T, c, 1, s));
    case 2: return static_cast<int>(launch_analytic_pair<2>(vin, z0, out, zf, B, T, c, 2, s));
    case 3: return static_cast<int>(launch_analytic_pair<3>(vin, z0, out, zf, B, T, c, 3, s));
    default:
      return static_cast<int>(launch_analytic_pair<-1>(vin, z0, out, zf, B, T, c, iters, s));
  }
}

// B1 on K lanes a stream, for the (H, L, K) of by_family.
int fused_clipper_neural_launch(const float* vin, const float* z0, float* out, float* zf,
                                int B, int T, const float* weights, int H, int L, float p1R,
                                int K, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_family(H, L, K, [&](auto h, auto l, auto k) {
    constexpr int W = decltype(h)::value, NL = decltype(l)::value, NK = decltype(k)::value;
    constexpr int R = kThreads / NK;
    const size_t smem =
        sizeof(float) * ((n_serve_lane_weights<W>(NL) + 3) & ~3) + sizeof(RowTile<R>);
    const auto kernel = neural_lanes_kernel<W, NK, NL>;
    const cudaError_t e = allow_smem(reinterpret_cast<const void*>(kernel), smem);
    if (e != cudaSuccess) return e;
    kernel<<<(B + R - 1) / R, kThreads, smem, s>>>(vin, z0, out, zf, B, T, weights, p1R);
    return cudaGetLastError();
  }));
}

// B1 one thread a stream, for any L at H in {4, 8, 16}.
int fused_clipper_neural_onethread_launch(const float* vin, const float* z0, float* out,
                                          float* zf, int B, int T, const float* weights, int H,
                                          int L, float p1R, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (H) {
    case 4: return static_cast<int>(launch_neural<4>(vin, z0, out, zf, B, T, weights, L, p1R, s));
    case 8: return static_cast<int>(launch_neural<8>(vin, z0, out, zf, B, T, weights, L, p1R, s));
    case 16: return static_cast<int>(launch_neural<16>(vin, z0, out, zf, B, T, weights, L, p1R, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* diffwdf_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
