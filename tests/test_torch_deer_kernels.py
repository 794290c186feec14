"""The single-stream DEER kernels' cluster passes, compiled on the CPU.

``csrc/deer_cluster.cuh`` holds what one CTA of the cluster kernels runs:
the LPF clipper's (``parallel_time_deer.cu``, B5) with the step of
``csrc/deer_clipper.cuh``, and the generated circuits' (B9) with the
``CircuitDeer`` step of ``circuit_codegen.generate_deer``.  The host C++
compiler builds them here with the stand-in ``cuda_runtime.h`` of
``tests/test_torch_codegen.py``, and a ctypes harness walks the CTAs one
after another in the kernel's order, each cluster barrier a pass boundary:
stage, relaxations, then per sweep the step pass, the in-block prefixes, the
CTA scan (``deer_warp_scan``'s order, which the harness is held to on 32 host
threads), the block starts across the cluster and the apply pass, then the
emit pass.  For the LPF clipper at (sweeps, omega iterations) (8, 3) and (4,
1) and for the Tube Screamer, the damped adaptive HPF clipper and the 2x16
neural clipper, at clusters of 8 and 16 CTAs:

- with no sweep, the walk gives the bits of a host walk of the relaxation
  and emit passes block after block on one thread (``onecta_walk``);
- otherwise it is within the JAX suite's budgets of the JAX kernel
  (``fused_deer_clipper`` / ``fused_deer_circuit`` / ``fused_deer_neural``
  in interpret mode, as tests/test_torch_stream.py and
  tests/test_torch_deer_circuit.py run them) and of the port's plain
  version: the clipper 1e-6 (approx at its 48 kHz point 5e-6), the Tube
  Screamer 1e-4, the HPF 3e-4, the neural clipper 5e-6; the adaptive HPF
  runs as many sweeps as JAX's kernel;
- an input that clips hard at the CTA boundaries stays within 2e-6 of the
  plain version and of the exact recursion (the clipper; the 2x16 clipper
  within 5e-6 of plain), and a NaN sample surfaces in the residual.

``omega()`` (``csrc/omega.cuh``), which now keeps a converged step's zero
residual out of the division, gives the bits of its earlier loop over a
grid that crosses the region edges -1 and 2, at 0-4 Newton steps.  The
host's ``expf`` and ``logf`` are not the card's, so the walks are held to
the references by the budgets and to each other by their bits, as the card
tests hold the kernels.
"""

import ctypes
import re
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
from diffwdf_tpu.models.diode_clipper import make_diode_clipper as jax_clipper
from diffwdf_tpu.models.diode_clipper import make_hpf_diode_clipper as jax_hpf
from diffwdf_tpu.models.diode_clipper import make_root_from_zoo as jax_zoo
from diffwdf_tpu.models.tube_screamer import make_tube_screamer as jax_ts
from diffwdf_tpu.ops.deer_circuit import fused_deer_circuit as jax_deer
from diffwdf_tpu.ops.deer_circuit import fused_deer_neural as jax_deer_neural
from diffwdf_tpu.ops.parallel_time_deer import fused_deer_clipper as jax_deer_clipper
from diffwdf_tpu_torch.models import diode_clipper as tdc
from diffwdf_tpu_torch.models import tube_screamer as tts
from diffwdf_tpu_torch.ops import _build
from diffwdf_tpu_torch.ops import circuit_codegen as cg
from diffwdf_tpu_torch.ops import deer_circuit as dc
from diffwdf_tpu_torch.ops import fused_circuit as fcirc
from diffwdf_tpu_torch.ops import fused_clipper as fc
from diffwdf_tpu_torch.ops import parallel_time_deer as pd
from diffwdf_tpu_torch.roots.diode import diode_1n4148_1u1d
from test_torch_codegen import CUDA_RUNTIME_STANDIN, LANE_GROUP_HARNESS, LANE_SHUFFLE_STANDIN

FS, R_SRC, CAP = 96000.0, 47.0e3, 2.2e-9
#: the served cluster, and 8 CTAs: the passes take the cluster size as a
#: template argument
CLUSTERS = (8, cg.DEER_CLUSTER)

# __shfl_up_sync and __shfl_xor_sync between the threads of a host lane group
# (deer_scan.cuh's warp scan and block max), as LANE_SHUFFLE_STANDIN's
# __shfl_sync
SHUFFLE_UP_XOR_STANDIN = """
static inline float standin_exchange(float v, int src) {
  standin_current->x[standin_rank] = v;
  pthread_barrier_wait(&standin_current->bar);
  const float got = standin_current->x[src];
  pthread_barrier_wait(&standin_current->bar);
  return got;
}
static inline float __shfl_up_sync(unsigned, float v, int d) {
  return standin_exchange(v, standin_rank >= d ? standin_rank - d : standin_rank);
}
static inline float __shfl_xor_sync(unsigned, float v, int m) {
  return standin_exchange(v, standin_rank ^ m);
}
"""

# The cluster kernel's order on the host: deer_cluster_solve of
# deer_cluster.cuh with the CTAs walked one after another and each barrier a
# pass boundary; the relaxations, the sweeps and the adaptive exit in
# deer_passes' order, which the kernel runs too.  The maxima combine in any
# order (a max is exact, a NaN stays); the scan of the block totals keeps
# deer_warp_scan's order.
HARNESS = """
#include <vector>

#include "deer_cluster.cuh"

// deer_warp_scan's order on a warp's 32 totals: at step d every lane l >= d
// composes lane l - d's value before the step (read as __shfl_up_sync gives it)
template <int S>
static void warp_scan_order(DeerAffine<S>* x) {
  for (int d = 1; d < 32; d <<= 1) {
    for (int l = 31; l >= d; --l) x[l] = deer_compose(x[l - d], x[l]);
  }
}

template <int C, int NT, int S, class Step>
static void cluster_walk(const Step& st, const float* vin, const float* z0, float* out,
                         float* zf, float* info, int L, int sweeps, int relax_passes,
                         int unroll, float damping, float tol, int track) {
  constexpr int NB = kDeerBlocks / C, NW = NB / 32;
  using Map = DeerAffine<S>;
  const size_t T = static_cast<size_t>(L) * kDeerBlocks;
  std::vector<float> scratch(deer_scratch_floats<S>(T));
  const DeerScratch<S> g{scratch.data(), scratch.data() + T, scratch.data() + (1 + 2 * S) * T, T,
                         L};
  const int n = NB * L;
  float vmax = 0.f;
  for (int k = 0; k < C; ++k) {
    for (int t = 0; t < NT; ++t) {
      for (int i = t; i < n; i += NT) vmax = deer_nanmax(vmax, deer_stage(g, k * NB, i, vin));
    }
  }
  const float bound = st.bound(vmax);
  auto relax = [&](int q) {
    for (int b = 0; b < kDeerBlocks; ++b) deer_relax(st, g, q, b, z0);
  };
  std::vector<Map> ex(kDeerBlocks), warp_tot(C * NW), cta_tot(C);
  std::vector<float> start(static_cast<size_t>(kDeerBlocks) * S);
  auto sweep = [&](int q, bool reduce) {
    for (int k = 0; k < C; ++k) {
      for (int t = 0; t < NT; ++t) {
        for (int i = t; i < n; i += NT) deer_linearise(st, g, q, i / NB, k * NB + i % NB, z0);
      }
    }
    for (int k = 0; k < C; ++k) {
      for (int w = 0; w < NW; ++w) {
        Map x[32];
        for (int l = 0; l < 32; ++l) x[l] = deer_prefix(g, k * NB + w * 32 + l);
        warp_scan_order(x);
        warp_tot[k * NW + w] = x[31];
        for (int l = 0; l < 32; ++l) ex[k * NB + w * 32 + l] = l ? x[l - 1] : deer_identity<S>();
      }
      for (int t = 0; t < NB; ++t) {
        ex[k * NB + t] = deer_scan_across_warps(ex[k * NB + t], t >> 5, &warp_tot[k * NW]);
      }
      cta_tot[k] = deer_cta_total(&warp_tot[k * NW], NW);
    }
    for (int k = 0; k < C; ++k) {  // after cluster barrier (1)
      for (int t = 0; t < NB; ++t) {
        deer_block_start(z0, k, [&](int m) { return &cta_tot[m]; }, ex[k * NB + t],
                         &start[static_cast<size_t>(k * NB + t) * S]);
      }
    }
    float dmax = 0.f;
    for (int k = 0; k < C; ++k) {
      for (int t = 0; t < NT; ++t) {
        for (int i = t; i < n; i += NT) {
          const int b = k * NB + i % NB;
          dmax = deer_nanmax(dmax, deer_update(g, q, i / NB, b, &start[static_cast<size_t>(b) * S],
                                               bound, damping, track != 0));
        }
      }
    }
    return reduce ? dmax : 0.f;  // after cluster barrier (2)
  };
  const DeerArgs a{vin, z0, out, zf, info, info + 1, scratch.data(), L, sweeps, relax_passes,
                   unroll, damping, tol, track};
  int q = 0;
  const int done = deer_passes(a, q, relax, sweep, [] {});
  float res = 0.f;
  for (int k = 0; k < C; ++k) {
    for (int t = 0; t < NT; ++t) {
      for (int i = t; i < n; i += NT) {
        res = deer_nanmax(res, deer_emit(st, g, q, i / NB, k * NB + i % NB, z0, out));
      }
    }
  }
  for (int i = 0; i < S; ++i) zf[i] = g.z(q, i)[g.at(L - 1, kDeerBlocks - 1)];
  info[0] = res;
  info[1] = static_cast<float>(done);
}

// The relaxation and emit passes block after block on one thread (as the
// one-CTA kernel before the cluster design ran them), on arrays of their
// own: the reference of a solve with no sweep.
template <int S, class Step>
static void onecta_walk(const Step& st, const float* vin, const float* z0, float* out, float* zf,
                        float* info, int L, int relax_passes) {
  const size_t T = static_cast<size_t>(L) * kDeerBlocks;
  std::vector<float> v(T), z(S * T, 0.f), old;
  for (int b = 0; b < kDeerBlocks; ++b) {
    for (int r = 0; r < L; ++r) v[static_cast<size_t>(r) * kDeerBlocks + b] = vin[b * L + r];
  }
  auto prev_of = [&](const std::vector<float>& zz, int r, int b, float* p) {
    for (int k = 0; k < S; ++k) {
      p[k] = r > 0 ? zz[k * T + static_cast<size_t>(r - 1) * kDeerBlocks + b]
             : b > 0 ? zz[k * T + static_cast<size_t>(L - 1) * kDeerBlocks + b - 1] : z0[k];
    }
  };
  for (int p = 0; p < relax_passes; ++p) {
    old = z;
    for (int b = 0; b < kDeerBlocks; ++b) {
      float s[S];
      prev_of(old, 0, b, s);
      for (int r = 0; r < L; ++r) {
        const size_t i = static_cast<size_t>(r) * kDeerBlocks + b;
        st.relax(v[i], s);
        for (int k = 0; k < S; ++k) z[k * T + i] = s[k];
      }
    }
  }
  float res = 0.f;
  for (int b = 0; b < kDeerBlocks; ++b) {
    for (int r = 0; r < L; ++r) {
      const size_t i = static_cast<size_t>(r) * kDeerBlocks + b;
      float prev[S], f[S], zi[S];
      prev_of(z, r, b, prev);
      for (int k = 0; k < S; ++k) zi[k] = z[k * T + i];
      out[b * L + r] = st.emit(v[i], prev, f, zi);
      for (int k = 0; k < S; ++k) res = deer_nanmax(res, fabsf(f[k] - zi[k]));
    }
  }
  for (int k = 0; k < S; ++k) zf[k] = z[k * T + T - 1];
  info[0] = res;
  info[1] = 0.f;
}

#define DEER_WALK(NT, S, st)                                                                  \\
  if (cluster == 0) {                                                                          \\
    onecta_walk<S>(st, vin, z0, out, zf, info, L, relax_passes);                               \\
  } else if (cluster == 8) {                                                                   \\
    cluster_walk<8, NT, S>(st, vin, z0, out, zf, info, L, sweeps, relax_passes, unroll,        \\
                           damping, tol, track);                                               \\
  } else {                                                                                     \\
    cluster_walk<16, NT, S>(st, vin, z0, out, zf, info, L, sweeps, relax_passes, unroll,       \\
                            damping, tol, track);                                              \\
  }
"""

#: the clipper's walk (cluster 0: the one-CTA walk), its kernel's 512 threads
CLIPPER_HARNESS = """
#include "deer_clipper.cuh"
""" + HARNESS + """
extern "C" void clipper_walk(int cluster, const float* vin, const float* z0, float* out,
                             float* zf, float* info, int L, const float* kc, int iters,
                             int sweeps, int relax_passes) {
  const ClipperDeer st{DeerConsts{kc[0], kc[1], kc[2], kc[3], kc[4], kc[5], kc[6], kc[7]}, iters};
  const int unroll = 1, track = 0;
  const float damping = 1.f, tol = 0.f;
  DEER_WALK(512, 1, st)
}
"""

#: a generated circuit's walk, its kernel's 256 threads
CIRCUIT_HARNESS = HARNESS + """
extern "C" void circuit_walk(int cluster, const float* vin, const float* z0, float* out,
                             float* zf, float* info, int L, const float* c, const float* w,
                             int sweeps, int relax_passes, int unroll, float damping, float tol,
                             int track) {
  CircuitDeer st;
  st.c = c;
  st.w = w;
  const float r_none[1] = {0.f};
  circuit_prologue(c, r_none, w, st.p);
  DEER_WALK(256, CIRCUIT_NS, st)
}
"""

# omega() against its loop before the zero-residual skip, and the warp scan
# on 32 host threads against the harness's order
OMEGA_SCAN_HARNESS = LANE_GROUP_HARNESS + """
#include "deer_cluster.cuh"
#include "omega.cuh"

static float omega_before(float x, int iters) {
  float u;
  if (x <= -1.f) {
    u = x - expf(x);
  } else if (x >= 2.f) {
    const float lx = logf(x);
    u = logf(x - lx + lx / x);
  } else {
    const float t = x - 1.f;
    u = logf(1.f + 0.5f * t + 0.0625f * t * t);
  }
  for (int k = 0; k < iters; ++k) {
    const float eu = expf(u);
    u = u - (eu + u - x) / (eu + 1.f);
  }
  return expf(u);
}

extern "C" void omega_both(const float* x, float* now, float* before, int n, int iters) {
  for (int i = 0; i < n; ++i) {
    now[i] = omega(x[i], iters);
    before[i] = omega_before(x[i], iters);
  }
}

// 32 maps (J then c, S^2 + S floats each): ex_lanes from deer_scan_in_warp on
// 32 host threads, ex_order from the harness's order; then the two totals
template <int S>
static void scan_both(const float* maps, float* ex_lanes, float* ex_order) {
  constexpr int E = S * S + S;
  DeerAffine<S> x[32], total;
  for (int l = 0; l < 32; ++l) {
    for (int m = 0; m < S * S; ++m) x[l].J[m] = maps[l * E + m];
    for (int a = 0; a < S; ++a) x[l].c[a] = maps[l * E + S * S + a];
  }
  standin_run_group(32, [&](int lane) {
    const DeerAffine<S> e = deer_scan_in_warp(x[lane], lane, &total);
    for (int m = 0; m < S * S; ++m) ex_lanes[lane * E + m] = e.J[m];
    for (int a = 0; a < S; ++a) ex_lanes[lane * E + S * S + a] = e.c[a];
  });
  for (int m = 0; m < S * S; ++m) ex_lanes[32 * E + m] = total.J[m];
  for (int a = 0; a < S; ++a) ex_lanes[32 * E + S * S + a] = total.c[a];
  for (int d = 1; d < 32; d <<= 1) {
    for (int l = 31; l >= d; --l) x[l] = deer_compose(x[l - d], x[l]);
  }
  for (int l = 0; l <= 32; ++l) {
    const DeerAffine<S> e = l == 32 ? x[31] : l ? x[l - 1] : deer_identity<S>();
    for (int m = 0; m < S * S; ++m) ex_order[l * E + m] = e.J[m];
    for (int a = 0; a < S; ++a) ex_order[l * E + S * S + a] = e.c[a];
  }
}

extern "C" void scan_both_s(int S, const float* maps, float* ex_lanes, float* ex_order) {
  if (S == 1) scan_both<1>(maps, ex_lanes, ex_order);
  else scan_both<3>(maps, ex_lanes, ex_order);
}
"""


@pytest.fixture(scope="module")
def host_build(tmp_path_factory):
    """Compile a harness with the host C++ compiler and the stand-ins."""
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    inc = tmp_path_factory.mktemp("standin_deer")
    (inc / "cuda_runtime.h").write_text(
        CUDA_RUNTIME_STANDIN + LANE_SHUFFLE_STANDIN + SHUFFLE_UP_XOR_STANDIN)
    out = tmp_path_factory.mktemp("deer_build")

    def build(name: str, source: str) -> ctypes.CDLL:
        src, so = out / f"{name}.cpp", out / f"{name}.so"
        src.write_text(source)
        proc = subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread",
                               "-ffp-contract=off", "-x", "c++", f"-I{inc}",
                               f"-I{_build.CSRC_DIR}", "-o", str(so), str(src)],
                              capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        return ctypes.CDLL(str(so))

    return build


def _ptr(x: torch.Tensor):
    return ctypes.c_void_p(x.data_ptr())


def _walk(fn, cluster, vin, s0, extra):
    """Run a walk: (out (T,), zf (S,), residual, sweeps run)."""
    out, zf, info = torch.empty_like(vin), torch.empty_like(s0), torch.zeros(2)
    fn(cluster, _ptr(vin), _ptr(s0), _ptr(out), _ptr(zf), _ptr(info), vin.shape[0] // 1024,
       *extra)
    return out, zf, float(info[0]), float(info[1])


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.numpy().view(np.uint32)


# ---------------------------------------------------------------------------
# omega() and the warp scan
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def omega_scan(host_build):
    lib = host_build("omega_scan", OMEGA_SCAN_HARNESS)
    lib.omega_both.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    lib.scan_both_s.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 3
    return lib


@pytest.mark.parametrize("iters", [0, 1, 2, 3, 4])
def test_omega_zero_residual_skip_keeps_bits(omega_scan, iters):
    """Exact f32: the same bits as the loop before the skip, over the region
    edges (-1, 2 and their float neighbours) and both tails."""
    edges = np.array([-1.0, 2.0], np.float32)
    near = np.concatenate([np.nextafter(edges, -np.inf), edges, np.nextafter(edges, np.inf)])
    x = np.concatenate([np.linspace(-40.0, 60.0, 40001, dtype=np.float32),
                        np.linspace(-1.5, 2.5, 4001, dtype=np.float32), near,
                        np.float32([-80.0, 1e4, 3e7])]).astype(np.float32)
    x = torch.from_numpy(x)
    now, before = torch.empty_like(x), torch.empty_like(x)
    omega_scan.omega_both(_ptr(x), _ptr(now), _ptr(before), x.numel(), iters)
    assert np.array_equal(_bits(now), _bits(before))
    assert bool(torch.isfinite(now).all())


@pytest.mark.parametrize("S", [1, 3])
def test_harness_scan_order_is_deer_warp_scan(omega_scan, S):
    """deer_scan_in_warp on 32 host threads (its shuffles through the
    stand-in) gives the bits of the harness's order, prefixes and total."""
    rng = np.random.default_rng(S)
    E = S * S + S
    maps = torch.from_numpy(rng.uniform(-1.2, 1.2, (32, E)).astype(np.float32))
    lanes, order = torch.zeros(33, E), torch.zeros(33, E)
    omega_scan.scan_both_s(S, _ptr(maps), _ptr(lanes), _ptr(order))
    assert np.array_equal(_bits(lanes), _bits(order))
    assert not torch.equal(order[1], order[2])


# ---------------------------------------------------------------------------
# B5: the LPF clipper
# ---------------------------------------------------------------------------

D = diode_1n4148_1u1d
#: name -> (sweeps, omega iterations, fs, source R, amplitude, numpy seed,
#: budget): the stream's two configurations (stream.py's toms and approx,
#: the latter at the JAX suite's 48 kHz point, tests/test_deer_circuit.py:200)
CLIPPER_CFG = {"toms": (8, 3, FS, R_SRC, 2.0, 3, 1e-6),
               "approx": (4, 1, 48000.0, tdc.cutoff_to_resistance(4000.0, CAP), 1.5, 13, 5e-6)}


def _clipper_args(fs, r_src):
    return (r_src, CAP, D.Is, D.Vt * D.nabla, float(D.N_up), float(D.N_down)), fs


@pytest.fixture(scope="module")
def clipper(host_build):
    lib = host_build("clipper_walk", CLIPPER_HARNESS)
    lib.clipper_walk.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                                 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 3)

    def run(cluster, vin, z0, sweeps, iters, fs, r_src, relax=2):
        args, _ = _clipper_args(fs, r_src)
        k = torch.tensor(fc._analytic_constants(r_src, CAP, fs, *args[2:]), dtype=torch.float32)
        return _walk(lib.clipper_walk, cluster, vin, torch.tensor([float(z0)]),
                     (_ptr(k), iters, sweeps, relax))

    return run


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("name", list(CLIPPER_CFG))
def test_clipper_no_sweep_has_the_one_cta_bits(clipper, name, cluster):
    sweeps, iters, fs, r_src, amp, seed, _ = CLIPPER_CFG[name]
    vin = torch.from_numpy((amp * np.random.default_rng(seed).standard_normal(2048))
                           .astype(np.float32))
    got = clipper(cluster, vin, 0.3, 0, iters, fs, r_src)
    want = clipper(0, vin, 0.3, 0, iters, fs, r_src)
    assert np.array_equal(_bits(got[0]), _bits(want[0]))
    assert np.array_equal(_bits(got[1]), _bits(want[1])) and got[2] == want[2] > 0.0


_JAX = {}


def _jax_clipper(name, vin, z0):
    """The JAX kernel (interpret mode) on one configuration, once."""
    if name not in _JAX:
        sweeps, iters, fs, r_src, *_ = CLIPPER_CFG[name]
        args, _ = _clipper_args(fs, r_src)
        _JAX[name] = jax_deer_clipper(jnp.asarray(vin.numpy()), *args, fs=fs, z0=z0,
                                      sweeps=sweeps, relax_passes=2, quality_iters=iters,
                                      interpret=True)
    return _JAX[name]


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("name", list(CLIPPER_CFG))
def test_clipper_walk_matches_jax_and_plain(clipper, name, cluster):
    """Kernel against the JAX kernel and the plain version at 1e-6 (the
    suite's), and against the exact recursion at the configuration's budget."""
    sweeps, iters, fs, r_src, amp, seed, budget = CLIPPER_CFG[name]
    vin = torch.from_numpy((amp * np.random.default_rng(seed).standard_normal(2048))
                           .astype(np.float32))
    out, zf, res, _ = clipper(cluster, vin, 0.3, sweeps, iters, fs, r_src)
    args, _ = _clipper_args(fs, r_src)
    kw = dict(fs=fs, z0=0.3, sweeps=sweeps, relax_passes=2, quality_iters=iters)
    p_out, p_zf, p_res = pd.fused_deer_clipper_plain(vin, *args, **kw)
    jo, jz, _ = _jax_clipper(name, vin, 0.3)
    e_out, e_zf = fc.fused_clipper_analytic_plain(vin[None], torch.tensor([0.3]), *args, fs=fs,
                                                  quality_iters=iters)
    assert float((out - p_out).abs().max()) <= 1e-6 and abs(float(zf[0] - p_zf)) <= 1e-6
    assert float(np.abs(out.numpy() - np.asarray(jo)).max()) <= 1e-6
    assert abs(float(zf[0]) - float(jz)) <= 1e-6
    assert float((out - e_out[0]).abs().max()) <= budget and abs(float(zf[0] - e_zf[0])) <= budget
    assert res <= max(1e-6, 2 * float(p_res))


def _boundary_spikes(T, seed):
    """2 N(0, 1) with +-10 on the two samples at each CTA boundary of both
    cluster sizes (k T / 16): hard clipping exactly where a CTA's first
    sample reads its neighbour's last."""
    x = 2.0 * np.random.default_rng(seed).standard_normal(T)
    for k in range(1, 16):
        x[k * T // 16 - 1], x[k * T // 16] = 10.0 * (-1) ** k, -10.0 * (-1) ** k
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_clipper_hard_clip_at_cta_boundaries(clipper, cluster):
    """The hard-overdrive configuration (4 relaxations, 8 sweeps) within
    2e-6 of the plain version and of the exact recursion."""
    vin = _boundary_spikes(4096, 11)
    out, zf, res, _ = clipper(cluster, vin, 0.0, 8, 3, FS, R_SRC, relax=4)
    args, _ = _clipper_args(FS, R_SRC)
    p_out, _, _ = pd.fused_deer_clipper_plain(vin, *args, fs=FS, relax_passes=4)
    e_out, _ = fc.fused_clipper_analytic_plain(vin[None], torch.zeros(1), *args, fs=FS)
    assert float((out - p_out).abs().max()) <= 2e-6
    assert float((out - e_out[0]).abs().max()) <= 2e-6 and res < 1e-5


def test_clipper_nan_sample_surfaces_in_residual(clipper):
    vin = torch.from_numpy((2.0 * np.random.default_rng(5).standard_normal(2048))
                           .astype(np.float32))
    vin[1000] = float("nan")
    _, _, res, _ = clipper(16, vin, 0.0, 8, 3, FS, R_SRC)
    args, _ = _clipper_args(FS, R_SRC)
    _, _, p_res = pd.fused_deer_clipper_plain(vin, *args, fs=FS)
    assert np.isnan(res) and bool(torch.isnan(p_res))


# ---------------------------------------------------------------------------
# B9: generated circuits
# ---------------------------------------------------------------------------


def _best():
    return dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d, quality="best")


def _circuit_case(name):
    """(port circuit, params, input node, neural?, solver keywords, fs, input
    (T = 2048), budget, the JAX circuit and params)."""
    if name == "ts":
        root, rp = tdc.make_root_from_zoo(0, device="cpu")
        ckt = tts.make_tube_screamer(root, FS, drive=0.5)
        x = (0.2 * np.sin(2 * np.pi * 1000.0 * np.arange(2048) / FS)
             + 0.1 * np.random.default_rng(4).standard_normal(2048))
        jroot = _best()
        jckt = jax_ts(jroot, FS, drive=0.5)
        return (ckt, {**ckt.init_params("cpu"), **rp}, "Vin", False, {}, FS, x, 1e-4, jckt,
                {**jckt.init_params(), **jroot.init_params()})
    if name == "hpf":  # the HPF processor's settings; seed 2 exits early (20 sweeps)
        root, rp = tdc.make_hpf_root_from_zoo(0, device="cpu")
        ckt = tdc.make_hpf_diode_clipper(root, FS)
        x = 0.5 * np.random.default_rng(2).standard_normal(2048)
        jroot = _best()
        jckt = jax_hpf(jroot, FS)
        kw = dict(sweeps=48, damping=0.5, adapt_tol=1e-5)
        return (ckt, {**ckt.init_params("cpu"), **rp}, "Vs", False, kw, FS, x, 3e-4, jckt,
                {**jckt.init_params(), **jroot.init_params()})
    root, rp = tdc.make_root_from_zoo(4, device="cpu")  # the pretrained 2x16, 48 kHz
    ckt = tdc.make_diode_clipper(root, 48000.0)
    x = 2.0 * np.random.default_rng(7).standard_normal(2048)
    jroot, frag = jax_zoo(4)
    jckt = jax_clipper(jroot, 48000.0)
    return (ckt, {**ckt.init_params("cpu"), **rp}, "Vs", True, {}, 48000.0, x, 5e-6, jckt,
            {**jckt.init_params(), **frag})


CIRCUITS = ("ts", "hpf", "clip_2x16")


@pytest.fixture(scope="module")
def circuits(host_build):
    """name -> (case, walk(cluster, vin, **solver keywords))."""
    built = {}

    def get(name):
        if name in built:
            return built[name]
        case = _circuit_case(name)
        ckt, params, node, neural = case[:4]
        mlp = params[ckt.root.name] if neural else None
        prep = fcirc.prepare(ckt, params, "cpu", input_node=node, neural_mlp=mlp)
        deer = cg.deer_program(ckt, prep.prog)
        assert "deer_cluster_kernel" in deer.source and "CircuitDeer" in deer.host_source
        lib = host_build(f"walk_{name}", deer.host_source + CIRCUIT_HARNESS)
        lib.circuit_walk.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int]
                                     + [ctypes.c_void_p] * 2 + [ctypes.c_int] * 3
                                     + [ctypes.c_float] * 2 + [ctypes.c_int])
        w = prep.warr if prep.warr is not None else prep.vec

        def walk(cluster, vin, sweeps=8, relax_passes=2, damping=1.0, adapt_tol=0.0):
            s0 = dc._state_vector(prep, ckt, None, vin)
            return _walk(lib.circuit_walk, cluster, vin, s0,
                         (_ptr(prep.vec), _ptr(w), sweeps, relax_passes, dc._unroll(sweeps),
                          damping, adapt_tol, int(adapt_tol > 0.0)))

        built[name] = (case, walk, prep)
        return built[name]

    return get


def _plain(case, vin):
    ckt, params, node, neural, kw = case[:5]
    fn = dc.fused_deer_neural_plain if neural else dc.fused_deer_circuit_plain
    return fn(ckt, params, vin, input_node=node, return_info=True, **kw)


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("name", CIRCUITS)
def test_circuit_no_sweep_has_the_one_cta_bits(circuits, name, cluster):
    case, walk, _ = circuits(name)
    vin = torch.from_numpy(case[6].astype(np.float32))
    got = walk(cluster, vin, sweeps=0)
    want = walk(0, vin, sweeps=0)
    assert np.array_equal(_bits(got[0]), _bits(want[0]))
    assert np.array_equal(_bits(got[1]), _bits(want[1])) and got[2] == want[2] > 0.0


_JAX_CIRCUIT = {}


@pytest.mark.parametrize("cluster", CLUSTERS)
@pytest.mark.parametrize("name", CIRCUITS)
def test_circuit_walk_matches_jax_and_plain(circuits, name, cluster):
    """Within the case's budget of the JAX kernel and of the plain version
    (output and final state), certified by its residual; the sweeps run
    equal JAX's and plain's (the HPF exits early at 20 of 48)."""
    case, walk, prep = circuits(name)
    ckt, _, node, neural, kw, _, x, budget, jckt, jparams = case
    vin = torch.from_numpy(x.astype(np.float32))
    out, zf, res, n = walk(cluster, vin, **kw)
    p_out, p_st, p_res, p_n = _plain(case, vin)
    if name not in _JAX_CIRCUIT:
        fn = jax_deer_neural if neural else jax_deer
        _JAX_CIRCUIT[name] = fn(jckt, jparams, jnp.asarray(x.astype(np.float32)), input_node=node,
                                return_info=True, interpret=True, **kw)
    jo, jst, _, jn = _JAX_CIRCUIT[name]
    p_zf = torch.stack([p_st[node_][f].reshape(()) for node_, f in prep.prog.state_order])
    j_zf = np.array([float(jst[node_][f]) for node_, f in prep.prog.state_order])
    assert n == float(p_n) == float(jn), (n, float(p_n), float(jn))
    assert float((out - p_out).abs().max()) <= budget
    assert float(np.abs(out.numpy() - np.asarray(jo)).max()) <= budget
    assert float((zf - p_zf).abs().max()) <= budget
    assert float(np.abs(zf.numpy() - j_zf).max()) <= budget
    assert res < 1e-3 and float(p_res) < 1e-3
    if name == "hpf":
        assert n == 20


@pytest.mark.parametrize("cluster", CLUSTERS)
def test_neural_clipper_hard_clip_at_cta_boundaries(circuits, cluster):
    """The 2x16 clipper with +-10 at every CTA boundary: within the neural
    budget (5e-6) of the plain version, both converged."""
    case, walk, _ = circuits("clip_2x16")
    vin = _boundary_spikes(4096, 12)
    out, _, res, _ = walk(cluster, vin)
    p_out, _, p_res, _ = _plain(case, vin)
    assert float((out - p_out).abs().max()) <= 5e-6
    assert res < 1e-5 and float(p_res) < 1e-5


def test_tube_screamer_nan_sample_surfaces_in_residual(circuits):
    case, walk, _ = circuits("ts")
    vin = torch.from_numpy(case[6].astype(np.float32))
    vin[1500] = float("nan")
    _, _, res, _ = walk(16, vin)
    _, _, p_res, _ = _plain(case, vin)
    assert np.isnan(res) and bool(torch.isnan(p_res))


# ---------------------------------------------------------------------------
# The served sources and the launch functions' signatures
# ---------------------------------------------------------------------------


def _exports(source: str) -> set:
    """The C functions a source exports (its extern "C" block, or each
    declared extern "C" on its own)."""
    found = set(re.findall(r'^extern "C" (?:int|const char\*) (\w+)\(', source, re.M))
    if 'extern "C" {' in source:
        block = source[source.index('extern "C" {'):]
        found |= set(re.findall(r"^(?:int|const char\*) (\w+)\(", block, re.M))
    return found


def _assert_signatures(source: str, names, table: dict) -> None:
    """Each of ``names`` has its ctypes signature in ``table``, with as many
    argument types as its C definition in ``source`` has parameters."""
    for name in names:
        params = re.search(rf"\b{name}\(([^)]*)\)\s*\{{", source).group(1)
        n = len([p for p in params.split(",") if p.strip() not in ("", "void")])
        assert name in table and len(table[name][0]) == n, (name, n)


@pytest.mark.parametrize("name", CIRCUITS)
def test_served_deer_source_builds_the_cluster_kernel_alone(circuits, name):
    """B9's served source instantiates the kernel at DEER_CLUSTER CTAs alone
    and exports its launch and cluster query, each with its ctypes
    signature.  Every name of ``_build``'s two signature tables is exported
    by a source that is built: the kernel library's, this circuit's
    generated forward, adjoint and DEER sources, or csrc/forms/omega_forms.cu."""
    case, _, prep = circuits(name)
    deer = cg.deer_program(case[0], prep.prog)
    served = _exports(deer.source)
    assert served == {"circuit_deer_launch", "circuit_deer_max_clusters", "circuit_error_string"}
    assert "deer_cluster_launch<16," in deer.source and "kernel<8>" not in deer.source
    assert "__global__ void __launch_bounds__(kThreads, 1)\ndeer_kernel(" not in deer.source
    assert deer.source.startswith(deer.step_source)
    _assert_signatures(deer.source, served, _build._GENERATED_SIGNATURES)
    built = [p.read_text() for p in _build._sources()] + [
        prep.prog.source, cg.adjoint_program(case[0], prep.prog).source, deer.source,
        (_build.CSRC_DIR / "forms" / "omega_forms.cu").read_text()]
    exported = set().union(*map(_exports, built))
    assert set(_build._SIGNATURES) | set(_build._GENERATED_SIGNATURES) <= exported, (
        (set(_build._SIGNATURES) | set(_build._GENERATED_SIGNATURES)) - exported)


def test_clipper_forms_source_is_left_out_of_the_kernel_library():
    """B5: csrc/parallel_time_deer.cu, a source of the kernel library,
    launches the 16-CTA kernel alone and exports only its launch and its
    cluster query, each with its ctypes signature; csrc/forms/ holds no DEER
    source, and the library builds nothing from it."""
    served = (_build.CSRC_DIR / "parallel_time_deer.cu").read_text()
    assert _exports(served) == {"deer_clipper_launch", "deer_clipper_max_clusters"}
    _assert_signatures(served, _exports(served), _build._SIGNATURES)
    assert "kCluster = 16" in served and "deer_clipper_kernel<<<" not in served
    assert [p.name for p in (_build.CSRC_DIR / "forms").glob("*.cu")] == ["omega_forms.cu"]
    assert not any(p.parent.name == "forms" for p in _build._sources())
    assert pd.scratch_floats(2048) == 5 * 2048
