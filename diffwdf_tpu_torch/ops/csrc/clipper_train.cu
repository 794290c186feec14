// In-circuit training of the LPF diode clipper for Hopper (sm_90a): the
// training forward and its reverse-time adjoint.
//
// Replaces the Pallas TPU kernels
//   train_fwd_kernel<H> <- diffwdf_tpu/ops/fused_clipper.py,
//                          fused_clipper_neural_train_fwd / _neural_train_kernel
//   adjoint_kernel<H>   <- diffwdf_tpu/ops/clipper_train.py, _clipper_adjoint_pallas
//
// Forward recursion per stream (s = capacitor state, p = p1R of the row):
//   b_temp_t = -p (s_t - v_t),  a_t = s_t + b_temp_t,  y_t = MLP([a_t, log R]),
//   s_{t+1} = -y_t + b_temp_t,  o_t = (s_{t+1} + s_t) / 2.
// The source resistance R is per stream (the hoisted per-chunk pot of the
// training data), so p and log R come in as (B,) arrays, and the first
// layer's bias c1 = w1r log R + b1 is built per thread by nxh_first_bias.
// The forward also writes a_t, the residual the adjoint needs.
//
// Adjoint.  With m_t = dMLP/da at a_t, the state cotangent lam_t = dL/ds_t
// satisfies the linear reverse-time recurrence
//   lam_t = c_t lam_{t+1} + (1 + c_t) go_t / 2,   c_t = -(m_t (1 - p) + p),
// from lam_T = g_zf.  The kernel walks t = T-1 .. 0 with lam in a register,
// evaluates m_t inline with nxh_tangent (the closed-form jvp of the same MLP
// the forward ran, bit for bit the same activations) and writes
//   G_t = lam_{t+1} + go_t / 2        (total cotangent of s_{t+1}),
//   g_vin_t = p (1 - m_t) G_t,
// and g_z0 = lam_0.  The MLP parameters' cotangent (a batched VJP with
// dL/dy = -G over every (b, t)) is left to PyTorch, as the JAX package
// leaves it to XLA.
//
// Design.  As in fused_clipper.cu: both recursions are strictly sequential
// in time and independent across streams, so one thread owns one stream and
// walks all T samples with its state in registers; this loop replaces the
// TPU grid's time-chunk axis and its VMEM scratch carry.  The ragged edge of
// B is masked, so any B >= 1 works.  Weights sit in shared memory (a warp
// reads one address, a broadcast).
//
// What bounds it.  Per sample the forward reads 4 bytes and writes 8 (out,
// a); the adjoint reads 8 (a, go) and writes 8 (G, g_vin).  At the training
// shape (1337, 2048) that is ~11 MB per stream array, against ~600 FMAs and
// 48 tanhf per sample (2x16 forward; the adjoint's tangent doubles the
// hidden FMAs).  Each stream's chain of dependent samples (~2.4 us per
// sample for 2x16 on the serving kernel) bounds it, not bytes.  The training
// batch of 1337 rows fills 11 blocks of 128 threads on 132 SMs.
//
// Reads and writes.  The (B, T) arrays stay row-major, so the lanes of a warp
// touch addresses T*4 bytes apart at each step and lean on L1: a 128-byte
// line holds 32 consecutive steps of one stream and is fetched once per 32
// steps.  Reverse-time reads reuse each line for 32 steps just as forward
// reads do (walking it from its last word down).
//
// Numerics.  Exact f32 library calls only (tanhf, fmaf): no fast-math
// intrinsics.  The (B,) constants p and log R are computed by the wrapper in
// double precision and rounded to f32, the same values the plain PyTorch
// versions use.
//
// Interface.  Plain C, loaded with ctypes; every launch goes on the stream
// the caller passes and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <type_traits>

#include "nxh_mlp.cuh"

namespace {

constexpr int kThreads = 128;

// Weight buffer layout (floats), built by the Python wrapper:
//   w1a[H]  first-layer weights of the incident wave a
//   w1r[H]  first-layer weights of log R
//   b1[H]   first-layer bias
//   w3[H]   linear head
//   b3      head bias
//   then for each of the L hidden layers: W[H][H] ([in][out]), bias[H]
template <int H>
__host__ __device__ constexpr int n_train_weights(int L) {
  return 4 * H + 1 + L * (H * H + H);
}

template <int H>
__global__ void __launch_bounds__(kThreads)
train_fwd_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
                 const float* __restrict__ p1r, const float* __restrict__ log_r,
                 float* __restrict__ out, float* __restrict__ a_seq,
                 float* __restrict__ zf, int B, int T,
                 const float* __restrict__ weights, int L) {
  extern __shared__ float sw[];
  stage_weights(sw, weights, n_train_weights<H>(L));

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* w1a = sw;
  const float* w3 = sw + 3 * H;
  const float b3 = sw[4 * H];
  const float* hidden = sw + 4 * H + 1;
  float c1[H];
  nxh_first_bias<H>(sw + H, sw + 2 * H, log_r[b], c1);
  const float p = p1r[b];

  const size_t row = static_cast<size_t>(b) * T;
  const float* v = vin + row;
  float* o = out + row;
  float* as = a_seq + row;
  float z = z0[b];
  for (int t = 0; t < T; ++t) {
    const float b_temp = -p * (z - v[t]);
    const float a = z + b_temp;
    const float z_new = -nxh_forward<H>(a, w1a, c1, hidden, L, w3, b3) + b_temp;
    o[t] = 0.5f * (z_new + z);
    as[t] = a;
    z = z_new;
  }
  zf[b] = z;
}

template <int H>
__global__ void __launch_bounds__(kThreads)
adjoint_kernel(const float* __restrict__ a_seq, const float* __restrict__ g_out,
               const float* __restrict__ g_zf, const float* __restrict__ p1r,
               const float* __restrict__ log_r, float* __restrict__ g_vin,
               float* __restrict__ G, float* __restrict__ g_z0, int B, int T,
               const float* __restrict__ weights, int L) {
  extern __shared__ float sw[];
  stage_weights(sw, weights, n_train_weights<H>(L));

  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  const float* w1a = sw;
  const float* w3 = sw + 3 * H;
  const float* hidden = sw + 4 * H + 1;
  float c1[H];
  nxh_first_bias<H>(sw + H, sw + 2 * H, log_r[b], c1);
  const float p = p1r[b];

  const size_t row = static_cast<size_t>(b) * T;
  const float* as = a_seq + row;
  const float* go = g_out + row;
  float* gv = g_vin + row;
  float* gs = G + row;
  float lam = g_zf[b];  // lam_{t+1}, starting at lam_T
  for (int t = T - 1; t >= 0; --t) {
    const float m = nxh_tangent<H>(as[t], w1a, c1, hidden, L, w3);
    const float c = -(m * (1.f - p) + p);
    const float g = go[t];
    const float Gt = lam + 0.5f * g;
    gs[t] = Gt;
    gv[t] = p * (1.f - m) * Gt;
    lam = c * lam + 0.5f * (1.f + c) * g;
  }
  g_z0[b] = lam;
}

template <int H, typename Kernel, typename... Args>
cudaError_t launch(Kernel kernel, int B, int L, cudaStream_t stream, Args... args) {
  const size_t smem = sizeof(float) * static_cast<size_t>(n_train_weights<H>(L));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return e;
  }
  const int blocks = (B + kThreads - 1) / kThreads;
  kernel<<<blocks, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Calls f(std::integral_constant<int, H>) for the widths the kernels are
// compiled for; any other H is an invalid value.
template <typename F>
cudaError_t by_width(int H, F f) {
  switch (H) {
    case 4: return f(std::integral_constant<int, 4>{});
    case 8: return f(std::integral_constant<int, 8>{});
    case 16: return f(std::integral_constant<int, 16>{});
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

int clipper_train_fwd_launch(const float* vin, const float* z0, const float* p1r,
                             const float* log_r, float* out, float* a_seq, float* zf, int B,
                             int T, const float* weights, int H, int L, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_width(H, [&](auto h) {
    constexpr int W = decltype(h)::value;
    return launch<W>(train_fwd_kernel<W>, B, L, s, vin, z0, p1r, log_r, out, a_seq, zf, B, T,
                     weights, L);
  }));
}

int clipper_adjoint_launch(const float* a_seq, const float* g_out, const float* g_zf,
                           const float* p1r, const float* log_r, float* g_vin, float* G,
                           float* g_z0, int B, int T, const float* weights, int H, int L,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(by_width(H, [&](auto h) {
    constexpr int W = decltype(h)::value;
    return launch<W>(adjoint_kernel<W>, B, L, s, a_seq, g_out, g_zf, p1r, log_r, g_vin, G,
                     g_z0, B, T, weights, L);
  }));
}

}  // extern "C"
