"""B6's lane form (``csrc/cheb_lanes.cuh``), compiled on the CPU.

The distilled clipper's kernel gives each stream a group of K lanes, one
Chebyshev segment a lane: each lane holds its segment's edge terms and
coefficients (``ChebLane``), evaluates it with ``cheb_segment`` (the
per-segment function ``cheb_root`` runs too), and one shuffle hands the
selected segment's h to the group (``cheb_root_lanes``).  The host C++
compiler builds it here with the stand-ins of ``tests/test_torch_codegen.py``
(a stand-in ``cuda_runtime.h``; a group of K lanes is K host threads,
``__shfl_sync`` through a shared array).

- For every padded degree D of ``CHEB_DEGREES``, 1 to 8 segments of
  numpy-seeded coefficients and breaks, and each group size K in {4, 8} that
  holds them: every lane returns ``cheb_root<D>``'s bits, at inputs on both
  sides of every edge and exactly at it, at +-0, +-a_max and beyond, at
  +-inf and NaN (the same bits, NaN in the same places).
- The clipper walked over a seeded block with the distilled 1N4148 root of
  ``tests/test_torch_distilled.py``, lane by lane: every lane has the
  one-thread walk's bits (``cheb_root``), and both lie within 1e-5 of the
  JAX ``fused_clipper_cheb(interpret=True)`` (``tests/test_distilled.py``'s
  budget) and of ``fused_clipper_cheb_plain``.

The host's arithmetic is not the card's (it does not contract), so the host
results are held to each other by their bits and to the plain versions by
the budget; the card tests hold the kernels the same way.
"""

import ctypes
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
from diffwdf_tpu.ops.fused_clipper import fused_clipper_cheb as jax_fused_clipper_cheb
from diffwdf_tpu.roots import distilled as jdist
from diffwdf_tpu_torch.nn.convert import cheb_root_from_jax
from diffwdf_tpu_torch.ops import _build
from diffwdf_tpu_torch.ops import fused_clipper as fc
from diffwdf_tpu_torch.roots.distilled import PiecewiseChebRoot
from test_torch_codegen import CUDA_RUNTIME_STANDIN, LANE_GROUP_HARNESS, LANE_SHUFFLE_STANDIN

FS, R_SRC, CAP = 96000.0, 47.0e3, 2.2e-9
#: the group sizes the kernel is built for (csrc/cheb.cu)
LANE_SIZES = (4, 8)

HARNESS = """
#include "cheb.cuh"
#include "cheb_lanes.cuh"

// b of the root at each a: one (n) on one thread (cheb_root), lanes (K, n)
// lane by lane on a group of K (cheb_root_lanes)
template <int D, int K>
static void roots(const float* a, int n, const float* p, int n_seg, float* one, float* lanes) {
  for (int i = 0; i < n; ++i) one[i] = cheb_root<D>(a[i], p, n_seg);
  standin_run_group(K, [&](int rank) {
    ChebLane<D, K> lane;
    lane.load(p, n_seg, rank);
    for (int i = 0; i < n; ++i) lanes[rank * n + i] = cheb_root_lanes<D, K>(a[i], lane);
  });
}

// the clipper walked over (B, T) as the kernels walk it (cheb_clipper_step):
// K = 1 one thread a stream (cheb_root), out (B, T), zf (B); else a group of
// K lanes a stream, out (K, B, T), zf (K, B) lane by lane
template <int D, int K>
static void walk(const float* vin, const float* z0, float* out, float* zf, int B, int T,
                 const float* p, int n_seg, float p1R) {
  for (int b = 0; b < B; ++b) {
    if constexpr (K == 1) {
      float z = z0[b];
      for (long t = 0; t < T; ++t) {
        out[b * T + t] = cheb_clipper_step(vin[b * T + t], p1R, z,
                                           [&](float a) { return cheb_root<D>(a, p, n_seg); });
      }
      zf[b] = z;
    } else {
      standin_run_group(K, [&](int rank) {
        ChebLane<D, K> lane;
        lane.load(p, n_seg, rank);
        float z = z0[b];
        for (long t = 0; t < T; ++t) {
          out[(static_cast<long>(rank) * B + b) * T + t] = cheb_clipper_step(
              vin[b * T + t], p1R, z, [&](float a) { return cheb_root_lanes<D, K>(a, lane); });
        }
        zf[rank * B + b] = z;
      });
    }
  }
}

extern "C" {

void host_roots(int D, int K, const float* a, int n, const float* p, int n_seg, float* one,
                float* lanes) {
  switch (D * 100 + K) {CASES_ROOTS
  }
}

void host_walk(int D, int K, const float* vin, const float* z0, float* out, float* zf, int B,
               int T, const float* p, int n_seg, float p1R) {
  switch (D * 100 + K) {CASES_WALK
  }
}

}  // extern "C"
"""


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    inc = tmp_path_factory.mktemp("standin_cheb")
    (inc / "cuda_runtime.h").write_text(CUDA_RUNTIME_STANDIN + LANE_SHUFFLE_STANDIN)
    out = tmp_path_factory.mktemp("cheb_lanes_build")
    pairs = [(d, k) for d in fc.CHEB_DEGREES for k in (1,) + LANE_SIZES]
    cases_roots = "".join(f"\n    case {d * 100 + k}: roots<{d}, {k}>(a, n, p, n_seg, one, lanes); "
                          "break;" for d, k in pairs if k > 1)
    cases_walk = "".join(f"\n    case {d * 100 + k}: walk<{d}, {k}>(vin, z0, out, zf, B, T, p, "
                         "n_seg, p1R); break;" for d, k in pairs)
    source = LANE_GROUP_HARNESS + HARNESS.replace("CASES_ROOTS", cases_roots).replace(
        "CASES_WALK", cases_walk)
    src, so = out / "cheb_lanes.cpp", out / "cheb_lanes.so"
    src.write_text(source)
    proc = subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-x", "c++",
                           f"-I{inc}", f"-I{_build.CSRC_DIR}", "-o", str(so), str(src)],
                          capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    lib = ctypes.CDLL(str(so))
    vp, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.host_roots.argtypes = [i, i, vp, i, vp, i, vp, vp]
    lib.host_walk.argtypes = [i, i] + [vp] * 4 + [i, i, vp, i, f]
    return lib


def _root(rng, D: int, n_seg: int, a_max: float = 20.0) -> PiecewiseChebRoot:
    """A seeded root of n_seg segments padded to D: the first of degree D,
    the others of a degree between D / 2 and D, decaying coefficients."""
    breaks = tuple(np.sort(rng.choice(np.arange(1, 40), n_seg - 1, replace=False)) * a_max / 40)
    degrees = [D] + [int(rng.integers(max(D // 2, 1), D + 1)) for _ in range(n_seg - 1)]
    coeffs = tuple(rng.standard_normal(d + 1) * 0.7 ** np.arange(d + 1) for d in degrees)
    return PiecewiseChebRoot(a_max=a_max, breaks=breaks, coeffs=coeffs)


def _probe_inputs(params: np.ndarray, n_seg: int, rng) -> np.ndarray:
    """a on both sides of every segment edge and exactly at it (the f32
    edges of the parameters, both signs), +-0, +-a_max and beyond, +-inf,
    NaN, and a seeded spread."""
    a_max = params[0]
    edges = [params[1 + 3 * k] for k in range(1, n_seg)] + [a_max]
    pts = [np.float32(0.0), np.float32(-0.0), np.float32(np.inf), np.float32(-np.inf),
           np.float32(np.nan), np.float32(1.5 * a_max), np.float32(-1.5 * a_max)]
    for e in edges:
        e = np.float32(e)
        for x in (e, np.nextafter(e, np.float32(0)), np.nextafter(e, np.float32(np.inf))):
            pts += [x, -x]
    spread = (rng.uniform(-1.2, 1.2, 512) * a_max).astype(np.float32)
    return np.concatenate([np.array(pts, np.float32), spread])


@pytest.mark.parametrize("D", fc.CHEB_DEGREES)
def test_lane_root_gives_cheb_root_bits(lib, D):
    """Every lane of a group of K returns cheb_root<D>'s bits, for 1 to 8
    segments and each K in {4, 8} that holds them (the kernel takes the
    smaller: ``fused_clipper.cheb_lanes``)."""
    rng = np.random.default_rng(D)
    for n_seg in range(1, fc.MAX_CHEB_SEGMENTS + 1):
        root = _root(rng, D, n_seg)
        params, degree = fc.cheb_parameters(root)
        assert degree == D
        a = _probe_inputs(params, n_seg, rng)
        n = a.size
        p = np.ascontiguousarray(params)
        for K in (k for k in LANE_SIZES if k >= n_seg):
            one, lanes = np.empty(n, np.float32), np.empty((K, n), np.float32)
            lib.host_roots(D, K, a.ctypes.data, n, p.ctypes.data, n_seg, one.ctypes.data,
                           lanes.ctypes.data)
            assert np.isfinite(one[np.isfinite(a)]).all()
            assert np.isnan(one[np.isnan(a)]).all()
            for rank in range(K):
                assert np.array_equal(lanes[rank].view(np.uint32), one.view(np.uint32)), (
                    n_seg, K, rank, a[lanes[rank].view(np.uint32) != one.view(np.uint32)][:4])
        assert fc.cheb_lanes(n_seg) == (4 if n_seg <= 4 else 8)


@pytest.fixture(scope="module")
def distilled():
    """The distilled 1N4148 1U-1D root of tests/test_torch_distilled.py: the
    JAX root and its port."""
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    r_port = 1.0 / (1.0 / R_SRC + 2.0 * CAP * FS)
    jroot, _ = jdist.distill_root(root, root.init_params(), r_port)
    return jroot, cheb_root_from_jax(jroot)


def test_lane_walk_matches_one_thread_jax_and_plain(lib, distilled):
    """The clipper over a seeded (8, 256) block, state from a seeded z0:
    every lane of the lane walk has the one-thread walk's bits, and both lie
    within 1e-5 of JAX's fused_clipper_cheb (interpret mode) and of
    fused_clipper_cheb_plain (tests/test_distilled.py:88-89)."""
    jroot, troot = distilled
    b, t = 8, 256
    rng = np.random.default_rng(88)
    vin = (2.0 * rng.standard_normal((b, t))).astype(np.float32)
    vin[0, 40:60] *= 8.0  # past a_max: the clip
    z0 = rng.uniform(-0.5, 0.5, b).astype(np.float32)
    params, D = fc.cheb_parameters(troot)
    n_seg = len(troot.coeffs)
    K = fc.cheb_lanes(n_seg)
    p1R = fc._f32(fc._lpf_adaptor(R_SRC, CAP, FS)[0])
    one, one_z = np.empty((b, t), np.float32), np.empty(b, np.float32)
    lanes, lanes_z = np.empty((K, b, t), np.float32), np.empty((K, b), np.float32)
    for k, (out, zf) in ((1, (one, one_z)), (K, (lanes, lanes_z))):
        lib.host_walk(D, k, vin.ctypes.data, z0.ctypes.data, out.ctypes.data, zf.ctypes.data,
                      b, t, params.ctypes.data, n_seg, p1R)
    for rank in range(K):
        assert np.array_equal(lanes[rank], one) and np.array_equal(lanes_z[rank], one_z), rank
    plain, plain_z = fc.fused_clipper_cheb_plain(torch.from_numpy(vin), torch.from_numpy(z0),
                                                 troot, R_SRC, CAP, fs=FS)
    np.testing.assert_allclose(one, plain.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(one_z, plain_z.numpy(), atol=1e-5, rtol=0)
    # the JAX kernel takes B a multiple of 1024 streams: the block in its
    # first rows, zeros after
    jb = 1024
    jv, jz = np.zeros((jb, t), np.float32), np.zeros(jb, np.float32)
    jv[:b], jz[:b] = vin, z0
    got, got_z = jax_fused_clipper_cheb(jnp.asarray(jv), jnp.asarray(jz), jroot, R_SRC, CAP,
                                        fs=FS, time_chunk=128,
                                        interpret=jax.default_backend() != "tpu")
    np.testing.assert_allclose(one, np.asarray(got)[:b], atol=1e-5, rtol=0)
    np.testing.assert_allclose(one_z, np.asarray(got_z)[:b], atol=1e-5, rtol=0)
