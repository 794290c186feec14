// omega() against omega_select<ITERS> (csrc/omega.cuh) on the card, for the
// check that the generated forward step keeps its bits when its diode pair
// moves from two omega() calls to omega_pair (chip_smoke.py and the card
// tests, through ops/fused_circuit.omega_forms).  Not on any served path.
//
// One thread an x: w_omega = omega(x, ITERS), w_select = omega_select<ITERS>(x),
// ITERS a compile-time count, as the generated steps pass it.  Plain C
// interface; the launch goes on the caller's stream and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include "omega.cuh"

namespace {

template <int ITERS>
__global__ void omega_forms_kernel(const float* __restrict__ x, float* __restrict__ w_omega,
                                   float* __restrict__ w_select, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  w_omega[i] = omega(x[i], ITERS);
  w_select[i] = omega_select<ITERS>(x[i]);
}

template <int ITERS>
cudaError_t launch(const float* x, float* a, float* b, int n, cudaStream_t s) {
  omega_forms_kernel<ITERS><<<(n + 255) / 256, 256, 0, s>>>(x, a, b, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int omega_forms_launch(const float* x, float* w_omega, float* w_select, int n,
                                  int iters, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (iters) {
    case 1: return static_cast<int>(launch<1>(x, w_omega, w_select, n, s));
    case 2: return static_cast<int>(launch<2>(x, w_omega, w_select, n, s));
    case 3: return static_cast<int>(launch<3>(x, w_omega, w_select, n, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
