"""The clipper's serving kernels' per-sample functions, compiled on the CPU.

``csrc/clipper_serve.cuh`` holds what the serving kernels of the LPF clipper
run per sample: the neural step with the whole NxH root on one thread
(``serve_step``, B1's one-thread kernel) and on a group of K lanes
(``serve_step_lanes`` on the lane kernel's copy of the weights,
``serve_lane_weight``: B1's lane kernel), and the analytic step with the
two Wright-omega solves branch-free and unrolled (``analytic_step`` around
``omega_pair`` of ``csrc/omega.cuh`` on one thread, or ``omega_pair_lanes``
on a pair of lanes: B2).  The host C++ compiler builds them here with the
stand-in ``cuda_runtime.h`` of ``tests/test_torch_codegen.py`` (a group of K
lanes is K host threads, ``__shfl_sync`` through a shared array), and a
ctypes harness walks them as the kernels do.  For every NxH family the lane
kernel is built for, the lane step at every K that divides H gives the
one-thread step's bits on every lane, and the one-thread step is within the
suite's 2e-5 of ``fused_clipper_neural_plain``; ``omega_pair`` at 1, 2 and 3
Newton steps (and 4, the run-time loop) is within 5e-6 relative of the
port's ``wright_omega`` and of the JAX kernel's ``_omega_inline`` over a
grid that crosses the region edges -1 and 2 and reaches both tails, and
its two-lane form gives its bits on both lanes; the analytic step walked
over a block is within the suite's 5e-6 of ``fused_clipper_analytic_plain``
and its two-lane form gives the one-thread step's bits.  The
host's ``expf``, ``logf`` and ``tanhf`` are not the card's, so the host
results are held to the plain versions by the budgets and to each other by
their bits, as the card tests hold the kernels.
"""

import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffwdf_tpu.ops.fused_clipper import _omega_inline
from diffwdf_tpu_torch.ops import _build
from diffwdf_tpu_torch.ops import fused_clipper as fc
from diffwdf_tpu_torch.roots.diode import diode_1n4148_1u1d, diode_1n4148_1u2d
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.roots.omega import wright_omega
from test_torch_codegen import CUDA_RUNTIME_STANDIN, LANE_GROUP_HARNESS, LANE_SHUFFLE_STANDIN

FS, R_SRC, CAP = 96000.0, 47.0e3, 2.2e-9
#: (n_layers, width) of the NxH families the lane kernel is built for
FAMILIES = [(1, 16), (2, 4), (2, 8), (2, 16), (4, 4), (4, 8)]

HARNESS = """
#include <vector>

#include "clipper_serve.cuh"

template <int H>
static void neural_one_thread(const float* vin, const float* z0, float* out, float* zf, int B,
                              int T, const float* w, int L, float p) {
  for (int b = 0; b < B; ++b) {
    float z = z0[b];
    for (long t = 0; t < T; ++t) out[b * T + t] = serve_step<H>(vin[b * T + t], p, z, w, L);
    zf[b] = z;
  }
}

// out (K, B, T), zf (K, B): lane by lane
template <int H, int K, int L>
static void neural_lanes(const float* vin, const float* z0, float* out, float* zf, int B, int T,
                         const float* w, float p) {
  constexpr bool kRegs = (H / K) * H * L + H <= 96;
  std::vector<float> copy(n_serve_lane_weights<H>(L));  // the lane kernel's shared-memory copy
  for (int i = 0; i < n_serve_lane_weights<H>(L); ++i) copy[i] = serve_lane_weight<H>(w, i);
  const float* sw = copy.data();
  for (int b = 0; b < B; ++b) {
    standin_run_group(K, [&](int rank) {
      NxhLaneWeights<H, K, L, kRegs> lw;
      lw.load(sw + serve_lane_hidden<H>(), sw + 2 * H, rank);
      float z = z0[b];
      for (long t = 0; t < T; ++t) {
        out[(static_cast<long>(rank) * B + b) * T + t] =
            serve_step_lanes<H, K, L>(vin[b * T + t], p, z, sw, rank, lw);
      }
      zf[rank * B + b] = z;
    });
  }
}

// K = 1: out (B, T), zf (B); K = 2: out (2, B, T), zf (2, B), lane by lane
template <int ITERS, int K>
static void analytic(const float* vin, const float* z0, float* out, float* zf, int B, int T,
                     const float* k, int iters) {
  const AnalyticConsts c{k[0], k[1], k[2], k[3], k[4], k[5], k[6], k[7]};
  for (int b = 0; b < B; ++b) {
    standin_run_group(K, [&](int rank) {
      float z = z0[b];
      for (long t = 0; t < T; ++t) {
        out[(static_cast<long>(rank) * B + b) * T + t] =
            analytic_step<ITERS, K>(vin[b * T + t], z, c, rank, iters);
      }
      zf[rank * B + b] = z;
    });
  }
}

// lanes 1: omega_pair on one thread; 2: omega_pair_lanes on two host
// threads, w0 and w1 (lanes, n) lane by lane
template <int ITERS>
static void pair(const float* x0, const float* x1, float* w0, float* w1, int n, int iters,
                 int lanes) {
  for (int i = 0; i < n; ++i) {
    if (lanes == 1) {
      omega_pair<ITERS>(x0[i], x1[i], w0[i], w1[i], iters);
    } else {
      standin_run_group(2, [&](int rank) {
        omega_pair_lanes<ITERS>(x0[i], x1[i], w0[rank * n + i], w1[rank * n + i], rank, iters);
      });
    }
  }
}

#define BY_ITERS(call) \\
  switch (iters) {     \\
    case 1: call(1); break;  \\
    case 2: call(2); break;  \\
    case 3: call(3); break;  \\
    default: call(-1); break; \\
  }

extern "C" {

void host_neural_one_thread(int H, const float* vin, const float* z0, float* out, float* zf,
                            int B, int T, const float* w, int L, float p) {
  switch (H) {
    case 4: neural_one_thread<4>(vin, z0, out, zf, B, T, w, L, p); break;
    case 8: neural_one_thread<8>(vin, z0, out, zf, B, T, w, L, p); break;
    case 16: neural_one_thread<16>(vin, z0, out, zf, B, T, w, L, p); break;
  }
}

void host_neural_lanes(int H, int L, int K, const float* vin, const float* z0, float* out,
                       float* zf, int B, int T, const float* w, float p) {
#define LANES(h, l, k) \\
  if (H == h && L == l && K == k) neural_lanes<h, k, l>(vin, z0, out, zf, B, T, w, p);
  LANES(4, 2, 4) LANES(4, 4, 4)
  LANES(8, 2, 4) LANES(8, 2, 8) LANES(8, 4, 4) LANES(8, 4, 8)
  LANES(16, 1, 4) LANES(16, 1, 8) LANES(16, 1, 16)
  LANES(16, 2, 4) LANES(16, 2, 8) LANES(16, 2, 16)
#undef LANES
}

void host_analytic(int iters, int lanes, const float* vin, const float* z0, float* out,
                   float* zf, int B, int T, const float* k) {
#define CALL(n) \\
  if (lanes == 1) analytic<n, 1>(vin, z0, out, zf, B, T, k, iters); \\
  else analytic<n, 2>(vin, z0, out, zf, B, T, k, iters)
  BY_ITERS(CALL)
#undef CALL
}

void host_omega_pair(int iters, int lanes, const float* x0, const float* x1, float* w0,
                     float* w1, int n) {
#define CALL(m) pair<m>(x0, x1, w0, w1, n, iters, lanes)
  BY_ITERS(CALL)
#undef CALL
}

}  // extern "C"
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    """The harness built once with the host compiler and the lane stand-in."""
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    inc = tmp_path_factory.mktemp("standin_serve")
    (inc / "cuda_runtime.h").write_text(CUDA_RUNTIME_STANDIN + LANE_SHUFFLE_STANDIN)
    src, so = inc / "serve_kernels.cpp", inc / "serve_kernels.so"
    src.write_text(LANE_GROUP_HARNESS + HARNESS)
    proc = subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-x", "c++",
                           f"-I{inc}", f"-I{_build.CSRC_DIR}", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    out = ctypes.CDLL(str(so))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    out.host_neural_one_thread.argtypes = [i] + [vp] * 4 + [i, i, vp, i, f]
    out.host_neural_lanes.argtypes = [i, i, i] + [vp] * 4 + [i, i, vp, f]
    out.host_analytic.argtypes = [i, i] + [vp] * 4 + [i, i, vp]
    out.host_omega_pair.argtypes = [i, i] + [vp] * 4 + [i]
    return out


def _ptrs(*xs):
    return [x.data_ptr() for x in xs]


def _streams(b, t, seed):
    rng = np.random.default_rng(seed)
    vin = torch.from_numpy((2.0 * rng.standard_normal((b, t))).astype(np.float32))
    z0 = torch.from_numpy(rng.uniform(-0.5, 0.5, b).astype(np.float32))
    return vin, z0


@pytest.mark.parametrize("n_layers,width", FAMILIES)
def test_host_neural_lane_step_matches_one_thread_step(lib, n_layers, width):
    """B1's lane step (serve_step_lanes: the clipper's tree on every lane,
    the root split over K host threads, the whole folded c1 in the weight
    copy) at every K that divides H: every lane ends every step with the
    one-thread step's bits for the output and the final state; the
    one-thread step is within 2e-5 of the plain version."""
    b, t = 3, 64
    mlp = NeuralDiodeRoot(name="dp", n_layers=n_layers, layer_size=width).init_params(
        "cpu", torch.Generator().manual_seed(width + n_layers))["dp"]
    H, L, p, w = fc.serve_weights(mlp, R_SRC, CAP, FS, torch.device("cpu"))
    vin, z0 = _streams(b, t, seed=width + n_layers)
    one = [torch.empty(b, t), torch.empty(b)]
    lib.host_neural_one_thread(H, *_ptrs(vin, z0, *one), b, t, w.data_ptr(), L, p)
    want = fc.fused_clipper_neural_plain(vin, z0, mlp, R_SRC, CAP, fs=FS)
    for got, ref in zip(one, want):
        assert bool(torch.isfinite(got).all())
        np.testing.assert_allclose(got.numpy(), ref.numpy(), atol=2e-5, rtol=0)
    ks = [k for k in fc.LANES if H % k == 0]
    assert set(fc.nxh_lane_counts(H)) <= set(ks)  # every K the kernel is built for
    for K in ks:
        out, zf = torch.empty(K, b, t), torch.empty(K, b)
        lib.host_neural_lanes(H, L, K, *_ptrs(vin, z0, out, zf), b, t, w.data_ptr(), p)
        for rank in range(K):
            assert torch.equal(out[rank], one[0]), (K, rank)
            assert torch.equal(zf[rank], one[1]), (K, rank)


def _omega_grid() -> np.ndarray:
    """A seeded grid of omega arguments: uniform over [-6, 6], both region
    edges -1 and 2 and their f32 neighbours, and both tails (down to -85,
    where omega is ~1e-37, and up to 1e4)."""
    rng = np.random.default_rng(9)
    edges = np.array([-1.0, 2.0], np.float32)
    near = np.concatenate([np.nextafter(edges, -np.inf), edges, np.nextafter(edges, np.inf),
                           edges - 1e-3, edges + 1e-3])
    tails = np.concatenate([-np.geomspace(6.0, 85.0, 48), np.geomspace(6.0, 1e4, 48)])
    return np.concatenate([rng.uniform(-6.0, 6.0, 400), near, tails]).astype(np.float32)


@pytest.mark.parametrize("iters", [1, 2, 3, 4])
def test_host_omega_pair_matches_wright_omega_and_jax(lib, iters):
    """omega_pair's two solves (branch-free guesses, Newton steps unrolled
    for 1, 2 and 3, a loop for 4) give, in either slot, omega within 5e-6
    relative of the port's wright_omega and of the JAX kernel's
    _omega_inline on the CPU; the pair split over two lanes
    (omega_pair_lanes) gives both lanes omega_pair's bits."""
    x = _omega_grid()
    x0, x1 = torch.from_numpy(x), torch.from_numpy(x[::-1].copy())
    w0, w1 = torch.empty_like(x0), torch.empty_like(x1)
    lib.host_omega_pair(iters, 1, *_ptrs(x0, x1, w0, w1), x.size)
    for got, arg in ((w0, x0), (w1, x1)):
        assert bool(torch.isfinite(got).all()) and bool((got > 0).all())
        refs = (wright_omega(arg, iters).numpy(),
                np.asarray(_omega_inline(jnp.asarray(arg.numpy()), iters)))
        for ref in refs:
            np.testing.assert_allclose(got.numpy(), ref, rtol=5e-6, atol=0)
    l0, l1 = torch.empty(2, x.size), torch.empty(2, x.size)
    lib.host_omega_pair(iters, 2, *_ptrs(x0, x1, l0, l1), x.size)
    for rank in range(2):
        assert torch.equal(l0[rank], w0) and torch.equal(l1[rank], w1), rank


@pytest.mark.parametrize("iters", [1, 2, 3, 4])
@pytest.mark.parametrize("diode", [diode_1n4148_1u1d, diode_1n4148_1u2d], ids=lambda d: d.name)
def test_host_analytic_step_matches_plain(lib, diode, iters):
    """B2's step (analytic_step: the diode pair, its solves on one thread)
    walked over a block is within 5e-6 of fused_clipper_analytic_plain,
    output and final state; with the pair split over two lanes both lanes
    give the one-thread step's bits."""
    b, t = 6, 256
    vin, z0 = _streams(b, t, seed=iters)
    args = (R_SRC, CAP, diode.Is, diode.Vt * diode.nabla, diode.N_up, diode.N_down)
    consts = torch.tensor(fc._analytic_constants(*args[:2], FS, *args[2:]), dtype=torch.float32)
    got = [torch.empty(b, t), torch.empty(b)]
    lib.host_analytic(iters, 1, *_ptrs(vin, z0, *got), b, t, consts.data_ptr())
    want = fc.fused_clipper_analytic_plain(vin, z0, *args, fs=FS, quality_iters=iters)
    for g, w in zip(got, want):
        assert bool(torch.isfinite(g).all())
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=5e-6, rtol=0)
    two = [torch.empty(2, b, t), torch.empty(2, b)]
    lib.host_analytic(iters, 2, *_ptrs(vin, z0, *two), b, t, consts.data_ptr())
    for rank in range(2):
        assert torch.equal(two[0][rank], got[0]) and torch.equal(two[1][rank], got[1]), rank


def test_serving_kernels_follow_the_lane_table():
    """B1's lane kernel is built for exactly the (H, L, K) of TRAIN_FAMILIES
    at nxh_lane_counts (csrc/fused_clipper.cu by_family), takes the shared
    lane rule there and one thread a stream elsewhere; B2 has a kernel for
    quality iterations 1, 2 and 3."""
    source = (_build.CSRC_DIR / "fused_clipper.cu").read_text()
    built = {tuple(map(int, m)) for m in re.findall(r"SERVE_FAMILY\((\d+), (\d+), (\d+)\)\n",
                                                     source)}
    assert built == {(h, n, k) for h, n in fc.TRAIN_FAMILIES for k in fc.nxh_lane_counts(h)}
    assert [fc.neural_lanes(16, 2, n) for n in (1, 2048, 2049, 8192)] == [16, 16, 8, 8]
    assert [fc.neural_lanes(16, 3, 1), fc.neural_lanes(4, 1, 1), fc.neural_lanes(8, 2, 1)] == [
        1, 1, 8]
    assert set(re.findall(r"launch_analytic_pair<(-?\d+)>\(", source)) == {"1", "2", "3", "-1"}
