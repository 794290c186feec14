// Fused LPF diode-clipper sample recursion for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of diffwdf_tpu/ops/fused_clipper.py:
//   analytic_kernel  <- fused_clipper_analytic / _analytic_kernel + _omega_inline
//   neural_kernel<H> <- fused_clipper_neural / _neural_kernel
//
// Both run the same per-sample recursion of the clipper Vs(R) || C with a
// diode root on top (one capacitor state z per stream):
//   b_temp = -p1R (z - v),  a = z + b_temp,  b = root(a),
//   z' = b + b_temp,        out = (z' + z) / 2.
//
// Design.  The recursion is strictly sequential in time and independent
// across streams, so each thread owns one stream: z lives in a register and
// the thread walks all T samples itself.  This loop takes the place of the
// TPU grid's time-chunk axis, which carried z in VMEM scratch between grid
// steps; no block carries anything across blocks here.  The ragged edge of B
// is masked, so any B >= 1 works.
//
// What bounds it.  Per sample a stream reads 4 bytes and writes 4 bytes but
// does ~12 transcendental calls (analytic: two Wright-omega solves, each a
// region guess plus 3 Newton steps) or ~600 FMAs and 48 tanhf (neural 2x16).
// That is latency and FMA work, not bytes: the card's bandwidth would move a
// (8192, 2048) block in and out in ~40 us.  The design answers with per-thread
// instruction-level parallelism (the H outputs of a dense layer are
// independent FMA chains, fully unrolled over H so activations stay in
// registers) and with weights in shared memory, where every lane of a warp
// reads the same address (a broadcast, no bank conflict).
//
// Reads.  vin is (B, T) row-major, so the 32 lanes of a warp touch 32
// addresses T*4 bytes apart at each step.  This first version leans on L1:
// a 128-byte line holds 32 consecutive steps of one stream, so each line is
// fetched once per 32 steps (a block's 128 lines are 16 KB, well inside L1).
// Staging (threads x t-chunk) tiles through shared memory for coalesced
// loads and stores is the obvious later improvement.
//
// Numerics.  Exact f32 library calls only (expf, logf, tanhf): no fast-math
// intrinsics, whose error exceeds the parity budgets (analytic 5e-6, neural
// 2e-5 absolute).  sign(a) is 0 at a == 0, as jnp.sign and torch.sign give.
//
// Interface.  Plain C, loaded with ctypes; every launch goes on the stream
// the caller passes and returns cudaGetLastError().

#include <cuda_runtime.h>

#include "nxh_mlp.cuh"
#include "omega.cuh"

namespace {

constexpr int kThreads = 128;

struct AnalyticConsts {
  float p1R;     // G_source / (G_source + G_cap)
  float log_up;  // log(R_up Is / (n_up Vt))
  float log_dn;  // log(R_up Is / (n_down Vt))
  float inv_up;  // 1 / (n_up Vt)
  float inv_dn;  // 1 / (n_down Vt)
  float two_vt;  // 2 Vt
  float n_up;
  float n_dn;
};

__global__ void __launch_bounds__(kThreads)
analytic_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
                float* __restrict__ out, float* __restrict__ zf, int B, int T,
                AnalyticConsts c, int iters) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* v = vin + static_cast<size_t>(b) * T;
  float* o = out + static_cast<size_t>(b) * T;
  float z = z0[b];
  for (int t = 0; t < T; ++t) {
    const float b_temp = -c.p1R * (z - v[t]);
    const float a = z + b_temp;
    // asymmetric diode pair (eqn 45); the branch select uses a >= 0
    const float lam = sign0(a);
    const bool pos = a >= 0.f;
    const float mu0 = pos ? c.n_dn : c.n_up;
    const float mu1 = pos ? c.n_up : c.n_dn;
    const float log0 = pos ? c.log_dn : c.log_up;
    const float log1 = pos ? c.log_up : c.log_dn;
    const float inv0 = pos ? c.inv_dn : c.inv_up;
    const float inv1 = pos ? c.inv_up : c.inv_dn;
    const float la = lam * a;
    const float w0 = omega(log0 + la * inv0, iters);
    const float w1 = omega(log1 - la * inv1, iters);
    const float b_root = a - c.two_vt * lam * (mu0 * w0 - mu1 * w1);
    const float z_new = b_root + b_temp;
    o[t] = 0.5f * (z_new + z);
    z = z_new;
  }
  zf[b] = z;
}

// Weight buffer layout (floats), built by the Python wrapper:
//   w1a[H]  first-layer weights of the incident wave a
//   c1[H]   first-layer bias with the log(R) column folded in
//   w3[H]   linear head
//   b3      head bias
//   then for each of the L hidden layers: W[H][H] ([in][out]), bias[H]
// The MLP itself is nxh_forward of nxh_mlp.cuh, shared with the training
// kernels of clipper_train.cu.
template <int H>
__global__ void __launch_bounds__(kThreads)
neural_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
              float* __restrict__ out, float* __restrict__ zf, int B, int T,
              const float* __restrict__ weights, int L, float p1R) {
  extern __shared__ float sw[];
  stage_weights(sw, weights, 3 * H + 1 + L * (H * H + H));

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* w1a = sw;
  const float* c1 = sw + H;
  const float* w3 = sw + 2 * H;
  const float b3 = sw[3 * H];
  const float* hidden = sw + 3 * H + 1;

  const float* v = vin + static_cast<size_t>(b) * T;
  float* o = out + static_cast<size_t>(b) * T;
  float z = z0[b];
  for (int t = 0; t < T; ++t) {
    const float b_temp = -p1R * (z - v[t]);
    const float a = z + b_temp;
    const float z_new = -nxh_forward<H>(a, w1a, c1, hidden, L, w3, b3) + b_temp;
    o[t] = 0.5f * (z_new + z);
    z = z_new;
  }
  zf[b] = z;
}

template <int H>
cudaError_t launch_neural(const float* vin, const float* z0, float* out, float* zf,
                          int B, int T, const float* weights, int L, float p1R,
                          cudaStream_t stream) {
  const size_t smem = sizeof(float) * (3 * H + 1 + static_cast<size_t>(L) * (H * H + H));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        neural_kernel<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + kThreads - 1) / kThreads;
  neural_kernel<H><<<blocks, kThreads, smem, stream>>>(vin, z0, out, zf, B, T, weights, L, p1R);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int fused_clipper_analytic_launch(const float* vin, const float* z0, float* out, float* zf,
                                  int B, int T, float p1R, float log_up, float log_dn,
                                  float inv_up, float inv_dn, float two_vt, float n_up,
                                  float n_dn, int iters, void* stream) {
  const AnalyticConsts c{p1R, log_up, log_dn, inv_up, inv_dn, two_vt, n_up, n_dn};
  const int blocks = (B + kThreads - 1) / kThreads;
  analytic_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      vin, z0, out, zf, B, T, c, iters);
  return static_cast<int>(cudaGetLastError());
}

int fused_clipper_neural_launch(const float* vin, const float* z0, float* out, float* zf,
                                int B, int T, const float* weights, int H, int L, float p1R,
                                void* stream) {
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
