// Single-stream parallel-in-time (DEER) solve of the LPF diode clipper for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel of diffwdf_tpu/ops/parallel_time_deer.py:
//   deer_clipper_kernel <- fused_deer_clipper / _deer_kernel
//
// The clipper's recursion z_t = f(z_{t-1}, v_t) (Vs(R) || C with the
// asymmetric diode pair of eqn 45 on top) is solved as Newton over the whole
// trajectory.  Linearised around the current guess,
//   z_t = J_t z_{t-1} + c_t,   J_t = df/dz,   c_t = f(z^_{t-1}) - J_t z^_{t-1},
// with the analytic Jacobian, which shares the two omega solves with f:
//   J = (1 - p1R) (1 - 2Vt (mu0 inv0 w0/(1+w0) + mu1 inv1 w1/(1+w1))) - p1R.
// The affine recurrence is solved exactly by a blocked prefix composition.
//
// Design.  One CTA of 1024 threads; time is cut into 1024 contiguous blocks
// of L = T/1024 samples and thread b owns block b (the TPU's block
// sublane*128 + lane).  The kernel runs
//   - relax_passes nonlinear relaxations: every block re-runs its true
//     recursion from the previous iterate's block-start state (a warm start
//     into Newton's basin under hard overdrive);
//   - sweeps linearised solves: each thread composes its block's affine
//     prefixes over its L rows, the 1024 block totals are composed by an
//     exclusive scan (__shfl_up_sync inside each warp, the 32 warp totals in
//     shared memory scanned by one warp), the block starts are applied to the
//     local prefixes and every iterate is clamped to +-(max|v| + 1);
//   - an emit pass: out = (z_t + z_{t-1})/2, the residual
//     max|f(z_{t-1}) - z_t| (a convergence certificate) and z_final.
// The input, the trajectory guess and the two prefix arrays live in global
// scratch (4 T floats, allocated by the wrapper) in a (L, 1024) row-major
// layout, so row r is one coalesced access across the CTA; at T = 16384 that
// is 256 KB, resident in L2.  Any multiple of 1024 is taken.  __syncthreads()
// separates every read of the neighbouring block's last z from the pass that
// rewrites z (the TPU got that order from value semantics).  Affine maps do
// not commute: compose(a, b) applies a, then b.
//
// What bounds it.  The work is 11 passes over the samples (2 relaxations, 8
// sweeps, the emit pass) of ~80-100 dependent f32 operations each (two omega
// solves, each a region guess and Newton steps of expf and an IEEE division),
// plus 8 block scans: at T = 16384 ~1.8e7 operations and 128 KB in and out,
// under 0.3 us at the card's f32 peak or its memory rate.
// One CTA runs on one SM of 132, so the kernel is bound by the latency of
// each thread's chain of samples and by the instruction rate of one SM, not by
// bytes.  This first design keeps the whole solve in one launch (no host
// round trip between sweeps) and every pass coalesced; spreading the blocks
// over several SMs (a cluster, or a grid with a cross-CTA scan) is the lever
// for a later version.
//
// Numerics.  Exact f32 library calls only (expf, logf, IEEE division): the
// 1e-6 budget against the sequential recursion is tighter than the fast-math
// intrinsics give.  The omega solve and sign(a) (0 at a == 0) are those of
// the analytic clipper kernel (omega.cuh).  The scan composes in another
// order than the TPU's lane-then-sublane doublings, so results agree with the
// plain version to rounding, not bit for bit.
//
// Interface.  Plain C, loaded with ctypes; the launch goes on the stream the
// caller passes and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "omega.cuh"

namespace {

constexpr int kBlocks = 1024;  // time blocks per solve = threads of the one CTA
constexpr int kWarps = kBlocks / 32;
constexpr unsigned kFull = 0xffffffffu;

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

// z -> J z + c
struct Affine {
  float J, c;
};

// b AFTER a: z -> b.J (a.J z + a.c) + b.c
__device__ __forceinline__ Affine compose(Affine a, Affine b) {
  return {b.J * a.J, b.J * a.c + b.c};
}

struct Step {
  float f;  // z_t = f(z_{t-1}, v_t)
  float j;  // df/dz at z_{t-1} (only when kJac)
};

template <bool kJac>
__device__ __forceinline__ Step clipper_step(const DeerConsts& k, float z, float v, int iters) {
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
  Step s;
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

// Maximum of x over the CTA; every thread gets it.
__device__ float block_max(float x, float* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int d = 16; d > 0; d >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, d));
  if (lane == 0) s_red[warp] = x;
  __syncthreads();
  if (warp == 0) {
    x = s_red[lane];
    for (int d = 16; d > 0; d >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, d));
    if (lane == 0) s_red[0] = x;
  }
  __syncthreads();
  x = s_red[0];
  __syncthreads();  // s_red may be reused
  return x;
}

// Inclusive scan of x over the 32 lanes of a warp: lane l gets
// x_l AFTER ... AFTER x_0.
__device__ __forceinline__ Affine warp_scan(Affine x, int lane) {
  for (int d = 1; d < 32; d <<= 1) {
    const float J = __shfl_up_sync(kFull, x.J, d);
    const float c = __shfl_up_sync(kFull, x.c, d);
    if (lane >= d) x = compose(Affine{J, c}, x);
  }
  return x;
}

// Exclusive scan of the block totals over the CTA: thread b gets
// x_{b-1} AFTER ... AFTER x_0 (the identity for b = 0).
__device__ Affine block_exclusive_scan(Affine x, Affine* s_tot) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const Affine inc = warp_scan(x, lane);
  if (lane == 31) s_tot[warp] = inc;
  __syncthreads();
  if (warp == 0) s_tot[lane] = warp_scan(s_tot[lane], lane);  // totals of warps 0..lane
  __syncthreads();
  const float J = __shfl_up_sync(kFull, inc.J, 1);
  const float c = __shfl_up_sync(kFull, inc.c, 1);
  Affine ex = lane == 0 ? Affine{1.f, 0.f} : Affine{J, c};
  if (warp > 0) ex = compose(s_tot[warp - 1], ex);
  __syncthreads();  // s_tot may be rewritten
  return ex;
}

__global__ void __launch_bounds__(kBlocks)
deer_clipper_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
                    float* __restrict__ out, float* __restrict__ zf, float* __restrict__ res_out,
                    float* __restrict__ scratch, int L, DeerConsts k, int sweeps,
                    int relax_passes, int iters) {
  __shared__ float s_red[kWarps];
  __shared__ Affine s_tot[kWarps];
  const int b = threadIdx.x;
  const size_t T = static_cast<size_t>(L) * kBlocks;
  // (L, 1024) row-major: element (r, b) is sample b L + r
  float* v = scratch;
  float* z = scratch + T;       // trajectory guess
  float* jp = scratch + 2 * T;  // within-block prefix J
  float* cp = scratch + 3 * T;  // within-block prefix c
  const float s0 = z0[0];
  // the guess at the sample before this block's first: the previous block's
  // last, or the stream's initial state
  auto block_start = [&]() { return b == 0 ? s0 : z[static_cast<size_t>(L - 1) * kBlocks + b - 1]; };

  // stage the input, zero the guess; Newton safeguard: the capacitor state
  // is bounded by the drive (the diodes only clamp)
  float vmax = 0.f;
  for (int r = 0; r < L; ++r) {
    const float x = vin[static_cast<size_t>(b) * L + r];
    v[static_cast<size_t>(r) * kBlocks + b] = x;
    z[static_cast<size_t>(r) * kBlocks + b] = 0.f;
    vmax = fmaxf(vmax, fabsf(x));
  }
  const float z_bound = block_max(vmax, s_red) + 1.f;  // its barriers publish z

  for (int p = 0; p < relax_passes; ++p) {
    float prev = block_start();
    __syncthreads();  // every block start read before any z is rewritten
    for (int r = 0; r < L; ++r) {
      const size_t i = static_cast<size_t>(r) * kBlocks + b;
      prev = clipper_step<false>(k, prev, v[i], iters).f;
      z[i] = prev;
    }
    __syncthreads();  // the new iterate is visible to the neighbour
  }

  for (int s = 0; s < sweeps; ++s) {
    float prev = block_start();
    Affine acc{1.f, 0.f};
    for (int r = 0; r < L; ++r) {
      const size_t i = static_cast<size_t>(r) * kBlocks + b;
      const Step st = clipper_step<true>(k, prev, v[i], iters);
      acc = compose(acc, Affine{st.j, st.f - st.j * prev});
      jp[i] = acc.J;
      cp[i] = acc.c;
      prev = z[i];  // the linearisation point of row r + 1 is the guess z_r
    }
    // the scan's barriers also order every block start read before the fix-up
    const Affine e = block_exclusive_scan(acc, s_tot);
    const float z_start = e.J * s0 + e.c;
    for (int r = 0; r < L; ++r) {
      const size_t i = static_cast<size_t>(r) * kBlocks + b;
      z[i] = fminf(fmaxf(jp[i] * z_start + cp[i], -z_bound), z_bound);
    }
    __syncthreads();  // the new iterate is visible to the neighbour
  }

  float prev = block_start();
  float res = 0.f;
  for (int r = 0; r < L; ++r) {
    const size_t i = static_cast<size_t>(r) * kBlocks + b;
    const float zr = z[i];
    const float f = clipper_step<false>(k, prev, v[i], iters).f;
    res = fmaxf(res, fabsf(f - zr));
    out[static_cast<size_t>(b) * L + r] = 0.5f * (zr + prev);
    prev = zr;
  }
  res = block_max(res, s_red);
  if (b == kBlocks - 1) zf[0] = prev;
  if (b == 0) res_out[0] = res;
}

}  // namespace

extern "C" {

int deer_clipper_launch(const float* vin, const float* z0, float* out, float* zf, float* res,
                        float* scratch, int L, float p1R, float log_up, float log_dn,
                        float inv_up, float inv_dn, float two_vt, float n_up, float n_dn,
                        int sweeps, int relax_passes, int iters, void* stream) {
  if (L < 1 || sweeps < 0 || relax_passes < 0 || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeerConsts k{p1R, log_up, log_dn, inv_up, inv_dn, two_vt, n_up, n_dn};
  deer_clipper_kernel<<<1, kBlocks, 0, static_cast<cudaStream_t>(stream)>>>(
      vin, z0, out, zf, res, scratch, L, k, sweeps, relax_passes, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
