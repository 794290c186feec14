// The comparison forms of the LPF clipper's single-stream DEER kernel (B5),
// beside the served one of parallel_time_deer.cu (a cluster of 16 CTAs):
//   deer_clipper_cluster_kernel<8>  the same cluster kernel at 8 CTAs
//                                   (deer_clipper.cuh);
//   deer_clipper_kernel             the kernel before the cluster redesign.
// A library of its own, built on first use by ops/deer_forms.py for
// chip_smoke.py's before-and-after timings and the card tests; the served
// path never compiles it.
//
// deer_clipper_kernel: one CTA of 1024 threads on one SM, thread b owning
// block b through every pass; the 1024 block totals are composed by an
// exclusive scan (__shfl_up_sync inside each warp, the 32 warp totals in
// shared memory scanned by one warp); scratch 4 T floats.  Bound by the
// latency of each thread's chain of samples and by one SM's instruction
// rate, not by bytes: at T = 16384 the work is ~1.8e7 operations and 128 KB
// in and out, under 0.3 us at the card's f32 peak or its memory rate.  Its
// relaxations and emit pass run the cluster kernel's expressions: with
// sweeps = 0 the two give the same bits.
//
// Interface.  Plain C, loaded with ctypes; each launch goes on the stream the
// caller passes and returns its CUDA error.

#include <cuda_runtime.h>

#include "deer_clipper.cuh"

namespace {

constexpr int kBlocks = 1024;  // time blocks per solve = threads of the one CTA
constexpr int kWarps = kBlocks / 32;
constexpr unsigned kFull = 0xffffffffu;

// z -> J z + c
struct Affine {
  float J, c;
};

// b AFTER a: z -> b.J (a.J z + a.c) + b.c
__device__ __forceinline__ Affine compose(Affine a, Affine b) {
  return {b.J * a.J, b.J * a.c + b.c};
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
      const ClipperStep st = clipper_step<true>(k, prev, v[i], iters);
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

// One solve on a cluster of 8 CTAs; the arguments of deer_clipper_launch
// (parallel_time_deer.cu), scratch 5 T floats.
int deer_clipper_c8_launch(const float* vin, const float* z0, float* out, float* zf, float* res,
                           float* scratch, int L, float p1R, float log_up, float log_dn,
                           float inv_up, float inv_dn, float two_vt, float n_up, float n_dn,
                           int sweeps, int relax_passes, int iters, void* stream) {
  DeerArgs a;
  const cudaError_t e =
      deer_clipper_args(vin, z0, out, zf, res, scratch, L, sweeps, relax_passes, iters, &a);
  if (e != cudaSuccess) return static_cast<int>(e);
  const DeerConsts k{p1R, log_up, log_dn, inv_up, inv_dn, two_vt, n_up, n_dn};
  return static_cast<int>(deer_cluster_launch<8, &deer_clipper_cluster_kernel<8>>(
      kDeerClipperThreads, 0, static_cast<cudaStream_t>(stream), a, k, iters));
}

// cudaOccupancyMaxActiveClusters of the kernel at 8 CTAs (negative: a CUDA error).
int deer_clipper_c8_max_clusters() {
  return deer_cluster_max_active<8, &deer_clipper_cluster_kernel<8>>(kDeerClipperThreads, 0);
}

// One solve by the one-CTA kernel; the same arguments, scratch 4 T floats.
int deer_clipper_onecta_launch(const float* vin, const float* z0, float* out, float* zf,
                               float* res, float* scratch, int L, float p1R, float log_up,
                               float log_dn, float inv_up, float inv_dn, float two_vt,
                               float n_up, float n_dn, int sweeps, int relax_passes, int iters,
                               void* stream) {
  if (L < 1 || sweeps < 0 || relax_passes < 0 || iters < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const DeerConsts k{p1R, log_up, log_dn, inv_up, inv_dn, two_vt, n_up, n_dn};
  deer_clipper_kernel<<<1, kBlocks, 0, static_cast<cudaStream_t>(stream)>>>(
      vin, z0, out, zf, res, scratch, L, k, sweeps, relax_passes, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
