// The LPF diode clipper's step map for its single-stream DEER solve, and
// the cluster kernel on it (parallel_time_deer.cu, 16 CTAs).
//
// z_t = f(z_{t-1}, v_t): Vs(R) || C with the asymmetric diode pair of Werner
// eqn 45 on top, and its analytic Jacobian, which shares the two omega
// solves with f:
//   J = (1 - p1R) (1 - 2Vt (mu0 inv0 w0/(1+w0) + mu1 inv1 w1/(1+w1))) - p1R.
// Exact f32 library calls only (omega.cuh): the 1e-6 budget against the
// sequential recursion is tighter than the fast-math intrinsics give.

#pragma once

#include <cuda_runtime.h>

#include "deer_cluster.cuh"
#include "omega.cuh"

namespace {

struct DeerConsts {
  float p1R;     // G_source / (G_source + G_cap)
  float log_up;  // log(R_up Is / (n_up Vt))
  float log_dn;  // log(R_up Is / (n_down Vt))
  float inv_up;  // 1 / (n_up Vt)
  float inv_dn;  // 1 / (n_down Vt)
  float two_vt;  // 2 Vt
  float n_up;
  float n_dn;
};

struct ClipperStep {
  float f;  // z_t = f(z_{t-1}, v_t)
  float j;  // df/dz at z_{t-1} (only when kJac)
};

template <bool kJac>
__device__ __forceinline__ ClipperStep clipper_step(const DeerConsts& k, float z, float v,
                                                    int iters) {
  const float b_temp = -k.p1R * (z - v);
  const float a = z + b_temp;
  const float lam = sign0(a);
  const bool pos = a >= 0.f;
  const float mu0 = pos ? k.n_dn : k.n_up;
  const float mu1 = pos ? k.n_up : k.n_dn;
  const float log0 = pos ? k.log_dn : k.log_up;
  const float log1 = pos ? k.log_up : k.log_dn;
  const float inv0 = pos ? k.inv_dn : k.inv_up;
  const float inv1 = pos ? k.inv_up : k.inv_dn;
  const float la = lam * a;
  const float w0 = omega(log0 + la * inv0, iters);
  const float w1 = omega(log1 - la * inv1, iters);
  ClipperStep s;
  s.f = a - k.two_vt * lam * (mu0 * w0 - mu1 * w1) + b_temp;
  s.j = 0.f;
  if (kJac) {
    // d b_root/da = 1 - 2 (w0' + w1') with w' = w/(1+w) and mu inv = 1/Vt
    const float droot = 1.f - k.two_vt * (mu0 * inv0 * w0 / (1.f + w0) +
                                          mu1 * inv1 * w1 / (1.f + w1));
    s.j = (1.f - k.p1R) * droot - k.p1R;
  }
  return s;
}

// The clipper as deer_cluster.cuh's step (S = 1): the iterate is clamped to
// +-(max|v| + 1) (the capacitor state is bounded by the drive; the diodes
// only clamp), the output is (z_t + z_{t-1}) / 2.
struct ClipperDeer {
  DeerConsts k;
  int iters;

  __device__ __forceinline__ float bound(float vmax) const { return vmax + 1.f; }
  __device__ __forceinline__ void relax(float v, float* z) const {
    z[0] = clipper_step<false>(k, z[0], v, iters).f;
  }
  __device__ __forceinline__ void lin(float v, const float* z, float* f, float* J) const {
    const ClipperStep s = clipper_step<true>(k, z[0], v, iters);
    f[0] = s.f;
    J[0] = s.j;
  }
  __device__ __forceinline__ float emit(float v, const float* prev, float* f,
                                        const float* z) const {
    f[0] = clipper_step<false>(k, prev[0], v, iters).f;
    return 0.5f * (z[0] + prev[0]);
  }
};

}  // namespace

#ifdef __CUDACC__

namespace {

constexpr int kDeerClipperThreads = 512;  // threads of a CTA of the cluster kernel

// The solve on one cluster of C CTAs of 512 threads (deer_cluster.cuh): CTA
// k owns 1024 / C time blocks; the scratch is 5 T floats (the input, two
// trajectory buffers, the rows (J_t, c_t)).
template <int C>
__global__ void __launch_bounds__(kDeerClipperThreads, 1)
deer_clipper_cluster_kernel(DeerArgs a, DeerConsts k, int iters) {
  deer_cluster_solve<C, kDeerClipperThreads, 1>(ClipperDeer{k, iters}, a);
}

// Checks one solve's arguments; the DeerArgs of a launch (no sweep count
// out, no damping, no adaptive exit).
inline cudaError_t deer_clipper_args(const float* vin, const float* z0, float* out, float* zf,
                                     float* res, float* scratch, int L, int sweeps,
                                     int relax_passes, int iters, DeerArgs* a) {
  if (L < 1 || sweeps < 0 || relax_passes < 0 || iters < 0) return cudaErrorInvalidValue;
  *a = DeerArgs{vin, z0, out, zf, res, nullptr, scratch, L, sweeps, relax_passes, 1, 1.f, 0.f, 0};
  return cudaSuccess;
}

}  // namespace

#endif  // __CUDACC__
