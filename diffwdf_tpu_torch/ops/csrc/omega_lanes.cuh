// The diode pair's two Wright-omega solves on a pair of lanes of one warp:
// each lane solves one (omega_select of omega.cuh) and one shuffle gives
// each the other's.  Used by the clipper's serving kernel (B2,
// clipper_serve.cuh analytic_step) and by the generated forward kernel of a
// circuit with a diode-pair root (ops/circuit_codegen.py, B7's lane form),
// which includes it without the clipper's NxH headers.  Device code; the CPU
// tests build it on the host with a stand-in __shfl_sync (a pair of lanes is
// two host threads).

#pragma once

#include <cuda_runtime.h>

#include "omega.cuh"

namespace {

// The diode pair's two solves on a pair of consecutive lanes (K = 2): lane
// `rank` (0 or 1) solves x_rank with omega_select, and one shuffle gives each
// lane the other's w, so both lanes end with omega_pair's (w0, w1), bit for
// bit.  Every lane of the warp calls it.
template <int ITERS>
__device__ __forceinline__ void omega_pair_lanes(float x0, float x1, float& w0, float& w1,
                                                 int rank, int iters = ITERS) {
  const float w = omega_select<ITERS>(rank ? x1 : x0, iters);
  const float other = __shfl_sync(0xffffffffu, w, rank ^ 1, 2);
  w0 = rank ? other : w;
  w1 = rank ? w : other;
}

}  // namespace
