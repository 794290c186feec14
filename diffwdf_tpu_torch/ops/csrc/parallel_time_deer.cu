// Single-stream parallel-in-time (DEER) solve of the LPF diode clipper for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of diffwdf_tpu/ops/parallel_time_deer.py:
//   deer_clipper_cluster_kernel<16> <- fused_deer_clipper / _deer_kernel
//
// The clipper's recursion z_t = f(z_{t-1}, v_t) (deer_clipper.cuh) is solved
// as Newton over the whole trajectory.  Linearised around the current guess,
//   z_t = J_t z_{t-1} + c_t,   J_t = df/dz,   c_t = f(z^_{t-1}) - J_t z^_{t-1},
// with the analytic Jacobian, which shares the two omega solves with f.  The
// affine recurrence is solved exactly by a blocked prefix composition over
// 1024 contiguous time blocks of L = T/1024 samples (the TPU's partition,
// sublane*128 + lane): relax_passes nonlinear block relaxations (a warm start
// into Newton's basin under hard overdrive), sweeps linearised solves with
// every iterate clamped to +-(max|v| + 1), and an emit pass: out = (z_t +
// z_{t-1})/2, the residual max|f(z_{t-1}) - z_t| (a convergence certificate)
// and z_final.
//
// deer_clipper_cluster_kernel<16> (deer_clipper.cuh): the solve on a
// cluster of 16 CTAs of 512 threads on neighbouring SMs (deer_cluster.cuh; a
// non-portable cluster size): CTA k owns 64 blocks, the step and apply passes
// run over samples in parallel, one thread per block runs a relaxation and
// composes its rows, the block totals are scanned in the CTA and then across
// the cluster through distributed shared memory.  The scratch is 5 T floats:
// the input, two trajectory buffers and the rows (J_t, c_t), in global memory
// (320 KB at T = 16384, resident in L2).
//
// Numerics.  Exact f32 library calls only (expf, logf, IEEE division): the
// 1e-6 budget against the sequential recursion is tighter than the fast-math
// intrinsics give.  The omega solve and sign(a) (0 at a == 0) are those of
// the analytic clipper kernel (omega.cuh).  The relaxations and the emit
// pass run each block's chain in time order (with sweeps = 0 the bits of a
// walk of the blocks one after another); the scan composes in another order
// than the plain version and than the TPU's lane-then-sublane doublings, so
// results agree with the plain version to rounding, not bit for bit.
//
// Interface.  Plain C, loaded with ctypes; each launch goes on the stream the
// caller passes and returns its CUDA error.

#include <cuda_runtime.h>

#include "deer_clipper.cuh"

namespace {

constexpr int kCluster = 16;  // CTAs of the cluster (ops/parallel_time_deer.py CLUSTER)

}  // namespace

extern "C" {

// One solve: vin (T,), z0, out (T,), zf, res; scratch 5 T floats; T = 1024 L.
// A refused launch returns CUDA's error; nothing falls back.
int deer_clipper_launch(const float* vin, const float* z0, float* out, float* zf, float* res,
                        float* scratch, int L, float p1R, float log_up, float log_dn,
                        float inv_up, float inv_dn, float two_vt, float n_up, float n_dn,
                        int sweeps, int relax_passes, int iters, void* stream) {
  DeerArgs a;
  const cudaError_t e =
      deer_clipper_args(vin, z0, out, zf, res, scratch, L, sweeps, relax_passes, iters, &a);
  if (e != cudaSuccess) return static_cast<int>(e);
  const DeerConsts k{p1R, log_up, log_dn, inv_up, inv_dn, two_vt, n_up, n_dn};
  return static_cast<int>(deer_cluster_launch<kCluster, &deer_clipper_cluster_kernel<kCluster>>(
      kDeerClipperThreads, 0, static_cast<cudaStream_t>(stream), a, k, iters));
}

// cudaOccupancyMaxActiveClusters of the kernel (negative: a CUDA error).
int deer_clipper_max_clusters() {
  return deer_cluster_max_active<kCluster, &deer_clipper_cluster_kernel<kCluster>>(
      kDeerClipperThreads, 0);
}

}  // extern "C"
