"""B7's lane forms of the distilled root and of the general MLP root, on the CPU.

The generated forward of a circuit whose root is a ``PiecewiseChebRoot``
(``_ChebEmitter``: one Chebyshev segment a lane, ``csrc/cheb_lanes.cuh``) or
an MLP outside the NxH family (``_DenseEmitter``: each hidden layer's
outputs split over the lanes, ``csrc/mlp_dense_lanes.cuh``) carries a
lane-cooperative kernel.  A CPU cannot run it, so the lane step
(``CircuitProgram.lanes_source``) is built with the host compiler and run on
K host threads a stream, ``__shfl_sync`` between them through a stand-in
(as ``tests/test_torch_codegen.py`` runs the NxH and diode-pair lane forms).

- The programs' lanes: (1, K) with K = ``cheb_lanes(segments)`` for the
  distilled root, (1, K...) for an MLP where a K of LANES divides every
  hidden width, (1,) where none does or there is no hidden layer; the lane
  source passes ``_lanes_parts``' tree check, which still refuses an
  altered tree line.
- Every lane of every K of the sweep's build ends every step with the one-
  thread host step's bits (output, final state and trajectory), so every
  lane is a valid writer: the distilled LPF clipper (three and eight
  segments, a 20-V sine that crosses every break), the training clipper
  with a per-sample R, and MLP roots with relu, sigmoid, softmax and
  linear layers and a scalar, a per-row and a per-sample R.
- Those bits against the JAX package on the same numpy inputs: the
  distilled clipper within 1e-5 of JAX's scan (tests/test_distilled.py:
  88-89), the relu and sigmoid 2x8 JSON roots within 2e-5 of JAX's jitted
  scan (tests/test_fused_circuit.py:55).
"""

import ctypes
import shutil
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
from diffwdf_tpu.models.diode_clipper import make_diode_clipper as jax_clipper
from diffwdf_tpu.roots import distilled as jdist
from diffwdf_tpu.roots.neural import NeuralDiodeRoot as JaxNeuralDiodeRoot
from diffwdf_tpu_torch.models import diode_clipper as tdc
from diffwdf_tpu_torch.nn.convert import cheb_root_from_jax
from diffwdf_tpu_torch.nn.serialization import load_model_json, save_model_json
from diffwdf_tpu_torch.ops import _build
from diffwdf_tpu_torch.ops import circuit_codegen as cg
from diffwdf_tpu_torch.ops import fused_circuit as tfc
from diffwdf_tpu_torch.roots.diode import DiodePairRoot, diode_1n4148_1u1d
from diffwdf_tpu_torch.roots.distilled import distill_root
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot

FS = 96000.0
R_SRC, CAP = 47.0e3, 2.2e-9
R_PORT = 1.0 / (1.0 / R_SRC + 2.0 * CAP * FS)

# A group of K lanes on the host: one thread per lane, __shfl_sync through a
# shared array between two barriers (tests/test_torch_codegen.py's stand-in).
LANE_SHUFFLE_STANDIN = """
#include <pthread.h>
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(8) float2 { float x, y; };
struct standin_group { float x[32]; pthread_barrier_t bar; };
static thread_local standin_group* standin_current;
static thread_local int standin_rank;
static inline float __shfl_sync(unsigned, float v, int src, int width) {
  standin_current->x[standin_rank] = v;
  pthread_barrier_wait(&standin_current->bar);
  const float got = standin_current->x[(standin_rank / width) * width + src];
  pthread_barrier_wait(&standin_current->bar);
  return got;
}
"""

# Run fn(rank) on K threads that form one group of lanes.
LANE_GROUP_HARNESS = """
#include <cuda_runtime.h>
#include <thread>
#include <vector>
template <class F>
static void standin_run_group(int K, F fn) {
  standin_group group;
  pthread_barrier_init(&group.bar, nullptr, K);
  std::vector<std::thread> lanes;
  for (int rank = 0; rank < K; ++rank) {
    lanes.emplace_back([&group, &fn, rank] {
      standin_current = &group;
      standin_rank = rank;
      fn(rank);
    });
  }
  for (auto& lane : lanes) lane.join();
  pthread_barrier_destroy(&group.bar);
}
"""

# The generated lane step (circuit_step_lanes) on K host threads per stream:
# every lane keeps its own copy of the state, output and trajectory
LANE_STEP_HARNESS = """
template <int K>
static void lanes_run(const float* vin, const float* z0, float* out, float* zf, float* seq,
                      int B, int T, const float* c, const float* rows, const float* times,
                      const float* w) {{
  // out (K, B, T), zf (K, S, B), seq (K, S, B, T): lane by lane
  constexpr int S = CIRCUIT_NS;
  for (int b = 0; b < B; ++b) {{
    standin_run_group(K, [&](int rank) {{
      float r[CIRCUIT_NR + 1], p[64], z[S + 1];
      for (int j = 0; j < CIRCUIT_NR; ++j) r[j] = rows[j * B + b];
      circuit_prologue_lanes<K>(c, r, w, p, rank);
      CircuitLaneWeights<K> lw;
      {load}
      for (int k = 0; k < S; ++k) z[k] = z0[k * B + b];
      for (long t = 0; t < T; ++t) {{
        float q[CIRCUIT_NQ + 1];
        for (int j = 0; j < CIRCUIT_NQ; ++j) q[j] = times[(j * B + b) * T + t];
        for (int k = 0; k < S; ++k) seq[((static_cast<long>(rank) * S + k) * B + b) * T + t] = z[k];
        out[(static_cast<long>(rank) * B + b) * T + t] =
            circuit_step_lanes<K>(vin[b * T + t], z, c, r, q, w, p, rank, lw);
      }}
      for (int k = 0; k < S; ++k) zf[(rank * S + k) * B + b] = z[k];
    }});
  }}
}}

extern "C" void circuit_lanes_host_run(int K, const float* vin, const float* z0, float* out,
                                       float* zf, float* seq, int B, int T, const float* c,
                                       const float* rows, const float* times, const float* w) {{
  switch (K) {{{cases}
  }}
}}
"""


@pytest.fixture(scope="module")
def host_lanes_cxx(tmp_path_factory):
    """Build a source with the host compiler, the package's stand-in for
    cuda_runtime.h and the lane stand-in (``LANE_SHUFFLE_STANDIN``)."""
    cxx = shutil.which("c++") or shutil.which("g++") or shutil.which("clang++")
    if cxx is None:
        pytest.skip("no host C++ compiler")
    inc = tmp_path_factory.mktemp("standin_lanes")
    (inc / "cuda_runtime.h").write_text(_build.HOST_STANDIN.read_text() + LANE_SHUFFLE_STANDIN)
    out = tmp_path_factory.mktemp("host_lanes_build")

    def build(name: str, source: str) -> ctypes.CDLL:
        src, so = out / f"{name}.cpp", out / f"{name}.so"
        src.write_text(source)
        proc = subprocess.run([cxx, "-O2", "-std=c++17", "-shared", "-fPIC", "-pthread", "-x",
                               "c++", f"-I{inc}", f"-I{_build.CSRC_DIR}", "-o", str(so),
                               str(src)], capture_output=True, text=True)
        assert proc.returncode == 0, proc.stderr
        lib = ctypes.CDLL(str(so))
        vp, i = ctypes.c_void_p, ctypes.c_int
        lib.circuit_lanes_host_run.argtypes = [i] + [vp] * 5 + [i] * 2 + [vp] * 4
        return lib

    return build


def _ptr(x, fallback):
    return (x if x is not None and x.numel() else fallback).data_ptr()


def _one_thread(prep, vin, z0):
    """(out (B, T), z_final (S, B), trajectory (S, B, T)) of the program's
    one-thread step built for the host (``circuit_host_run``)."""
    lib = ctypes.CDLL(str(_build.build_host(prep.prog.host_source)))
    vp, i = ctypes.c_void_p, ctypes.c_int
    lib.circuit_host_run.argtypes = [vp] * 5 + [i] * 2 + [vp] * 4
    b, t = vin.shape
    out, zf = torch.empty_like(vin), torch.empty_like(z0)
    seq = torch.empty((z0.shape[0], b, t))
    lib.circuit_host_run(vin.data_ptr(), z0.data_ptr(), out.data_ptr(), zf.data_ptr(),
                         seq.data_ptr(), b, t, prep.vec.data_ptr(), _ptr(prep.rows, prep.vec),
                         _ptr(prep.times, prep.vec), _ptr(prep.warr, prep.vec))
    return out, zf, seq


def _lanes(host_lanes_cxx, name, prog, prep, vin, z0):
    """K -> (out (K, B, T), z_final (K, S, B), trajectory (K, S, B, T)) of
    ``prog``'s lane step on K host threads a stream, for every K of
    ``prog.lanes``: each lane's own copy."""
    cases = "".join(f"\n    case {k}:\n      lanes_run<{k}>(vin, z0, out, zf, seq, B, T, c, rows, "
                    f"times, w);\n      break;" for k in prog.lanes[1:])
    lib = host_lanes_cxx(name, prog.step_source + prog.lanes_source + LANE_GROUP_HARNESS
                         + LANE_STEP_HARNESS.format(cases=cases,
                                                    load=prog.emitter.lane_weights()[1]))
    b, t = vin.shape
    S = z0.shape[0]
    runs = {}
    for K in prog.lanes[1:]:
        out, zf, seq = torch.empty(K, b, t), torch.empty(K, S, b), torch.empty(K, S, b, t)
        lib.circuit_lanes_host_run(K, vin.data_ptr(), z0.data_ptr(), out.data_ptr(),
                                   zf.data_ptr(), seq.data_ptr(), b, t, prep.vec.data_ptr(),
                                   _ptr(prep.rows, prep.vec), _ptr(prep.times, prep.vec),
                                   _ptr(prep.warr, prep.vec))
        runs[K] = (out, zf, seq)
    return runs


@pytest.fixture(scope="module")
def jax_distilled():
    """JAX's distillation of the 1N4148 1U-1D pair at the LPF clipper's port
    R (three segments), and the port's root with its coefficients."""
    jroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d, quality="best")
    droot, err = jdist.distill_root(jroot, jroot.init_params(), R_PORT)
    assert err < 1e-4
    return droot, cheb_root_from_jax(droot)


def _eight_segments():
    """The pair distilled over eight segments (the lane form's K = 8)."""
    root = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)
    droot, _ = distill_root(root, root.init_params("cpu"), R_PORT,
                            breaks=(0.4, 0.8, 1.5, 2.5, 4.0, 8.0, 14.0),
                            degrees=(24, 24, 16, 16, 16, 12, 12, 12))
    return droot


#: general MLP roots: name -> (widths, activations)
MLPS = {
    "relu": ((2, 8, 8, 8, 1), ("tanh", "relu", "tanh", "")),  # chip_smoke's relu JSON root
    "sigmoid": ((2, 8, 8, 8, 1), ("sigmoid", "sigmoid", "sigmoid", "")),
    "softmax": ((2, 8, 16, 1), ("softmax", "softmax", "")),  # softmax over split layers
    "linear": ((2, 16, 16, 4), ("linear", "relu", "softmax")),  # K = 16; a softmax head of 4
    "wide": ((2, 12, 12, 1), ("tanh", "sigmoid", "")),  # only K = 4 divides 12
}


def _mlp(widths, seed):
    rng = np.random.default_rng(seed)
    return {"layers": [{"kernel": (rng.standard_normal((i, o)) / np.sqrt(i)).astype(np.float32),
                        "bias": (0.3 * rng.standard_normal(o)).astype(np.float32)}
                       for i, o in zip(widths[:-1], widths[1:])]}


def _mlp_root(name):
    widths, acts = MLPS[name]
    mlp = _mlp(widths, len(name))
    tmlp = {"layers": [{k: torch.from_numpy(v) for k, v in l.items()} for l in mlp["layers"]]}
    root, frag = NeuralDiodeRoot.from_mlp("dp", tmlp, acts)
    return root, frag, mlp


def _circuit(name, jax_distilled):
    """(circuit, params, row controls (or None), amplitude) of a case."""
    rng = np.random.default_rng(len(name) + 11)
    kind, _, r_kind = name.partition(":")
    if kind in ("distilled", "distilled8"):
        root = jax_distilled[1] if kind == "distilled" else _eight_segments()
    else:
        root, frag, _ = _mlp_root(kind)
    if r_kind == "time":  # the training clipper, a random-walk source R per sample
        ckt = tdc.make_training_clipper(root, FS)
        walk = np.cumsum(0.02 * rng.standard_normal((5, 64)), axis=1)
        rows = {"Vs": {"R": torch.from_numpy(np.exp(np.log(45e3) + walk).astype(np.float32))}}
    elif r_kind == "row":  # one source R a row
        ckt = tdc.make_training_clipper(root, FS)
        r = np.exp(rng.uniform(np.log(30e3), np.log(60e3), 5)).astype(np.float32)
        rows = {"Vs": {"R": torch.from_numpy(r)}}
    else:
        ckt, rows = tdc.make_diode_clipper(root, FS, r_source=R_SRC, cap=CAP), None
    params = ckt.init_params("cpu")
    if not kind.startswith("distilled"):
        params = {**params, **frag}
    return ckt, params, rows, 20.0 if kind.startswith("distilled") else 1.5


def _vin(seed, amp, b, t):
    rng = np.random.default_rng(seed)
    n = np.arange(t)
    x = amp * np.sin(2 * np.pi * 1000.0 * n / FS)[None, :] + 0.1 * rng.standard_normal((b, t))
    return torch.from_numpy(x.astype(np.float32))


@pytest.mark.parametrize("name,lanes,every", [
    ("distilled", (1, 4), (1, 4, 8)),
    ("distilled8", (1, 8), (1, 8)),
    ("relu", (1, 8), (1, 4, 8)),
    ("sigmoid", (1, 8), (1, 4, 8)),
    ("softmax", (1, 8), (1, 4, 8)),
    ("linear", (1, 8, 16), (1, 4, 8, 16)),
    ("wide", (1, 4), (1, 4)),
])
def test_programs_take_the_lane_forms(jax_distilled, name, lanes, every):
    """The distilled root's program has lanes (1, cheb_lanes(segments)), an
    MLP's the K that lanes_for can pick of those that divide every hidden
    width; the sweep's build every such K.  lanes_for picks the lane form
    at every B; the lane source calls the root's lane function under its
    own mark and keeps the one-thread step's."""
    ckt, params, _, _ = _circuit(name, jax_distilled)
    prog = tfc.prepare(ckt, params, "cpu", input_node="Vs").prog
    assert prog.lanes == lanes and cg.sweep_program(ckt, prog).lanes == every
    assert [tfc.lanes_for(prog, n) for n in (1, 1024, 2048, 2049, 8192)] == (
        [16, 16, 16, 8, 8] if lanes[-1] == 16 else [lanes[-1]] * 5)
    lane_fn = "cheb_root_lanes<" if name.startswith("distilled") else "dense_layer_lanes<"
    one_fn = "cheb_root<" if name.startswith("distilled") else "dense_layer<"
    assert lane_fn in prog.lanes_source and lane_fn not in prog.step_source
    assert one_fn in prog.step_source and "circuit_lanes_kernel" in prog.source
    for k in prog.lanes:
        assert prog.source.count(f"case {k}:") == 1, k


@pytest.mark.parametrize("widths", [(2, 12, 5, 7, 1), (2, 6, 6, 1), (2, 3, 1), (2, 1)])
def test_widths_no_k_divides_keep_the_one_thread_kernel(widths):
    """A general MLP root whose hidden widths no K of LANES divides all of
    (or with no hidden layer) keeps the one-thread kernel alone, lanes (1,),
    in its program and in the sweep's build."""
    mlp = _mlp(widths, 3)
    tmlp = {"layers": [{k: torch.from_numpy(v) for k, v in l.items()} for l in mlp["layers"]]}
    acts = ("tanh",) * (len(widths) - 2) + ("",)
    root, frag = NeuralDiodeRoot.from_mlp("dp", tmlp, acts)
    ckt = tdc.make_diode_clipper(root, FS)
    prog = tfc.prepare(ckt, {**ckt.init_params("cpu"), **frag}, "cpu", input_node="Vs").prog
    assert isinstance(prog.emitter, cg._DenseEmitter)
    assert prog.lanes == (1,) and cg.sweep_program(ckt, prog).lanes == (1,)
    assert prog.lanes_source == "" and "circuit_lanes_kernel" not in prog.source


@pytest.mark.parametrize("name", ["distilled", "relu:time"])
def test_lane_tree_check_refuses_an_altered_tree_line(jax_distilled, name):
    """``_lanes_parts`` holds every line of the new lane forms that is not
    the root's own to the one-thread step's: an altered tree line is
    refused, an altered root line is not."""
    ckt, params, rows, _ = _circuit(name, jax_distilled)
    prep = tfc.prepare(ckt, params, "cpu", input_node="Vs", row_controls=rows, shape=(5, 64))
    prog, emitter = prep.prog, prep.prog.emitter
    body = cg._trace_forward(ckt, prog.layout, "Vs", emitter)[0]
    sizes = (max(len(prog.state_order), 1), max(prog.n_coeffs, 1), max(prog.n_rows, 1),
             max(prog.n_times, 1), max(emitter.n_keep, 1))
    ks = emitter.lane_counts()
    assert ks and cg._lanes_parts(ckt, prog.layout, "Vs", emitter, body, ks, sizes, 128)
    lines = body.splitlines()
    tree = next(i for i, line in enumerate(lines)
                if "__f" in line and not emitter.own_line(line))
    own = next(i for i, line in enumerate(lines)
               if emitter.own_line(line) and not line.strip().startswith("//"))
    altered = lines[:tree] + [lines[tree].replace("__f", "__g", 1)] + lines[tree + 1:]
    with pytest.raises(AssertionError, match="tree differs"):
        cg._lanes_parts(ckt, prog.layout, "Vs", emitter, "\n".join(altered), ks, sizes, 128)
    root_only = lines[:own] + [lines[own] + "  // another root line"] + lines[own + 1:]
    assert cg._lanes_parts(ckt, prog.layout, "Vs", emitter, "\n".join(root_only), ks, sizes, 128)


@pytest.mark.parametrize("name", ["distilled", "distilled8", "distilled:time", "relu",
                                  "sigmoid", "softmax", "linear", "wide", "relu:row",
                                  "sigmoid:time"])
def test_host_lane_step_matches_one_thread_step(jax_distilled, host_lanes_cxx, name):
    """On K host threads a stream, at every K of the sweep's build, every
    lane ends every step with the one-thread host step's bits: output, final
    state and trajectory (so any lane may write)."""
    ckt, params, rows, amp = _circuit(name, jax_distilled)
    b, t = 5, 64
    vin = _vin(len(name), amp, b, t)
    state = {k: {f: torch.zeros(b) for f in d} for k, d in ckt.init_state("cpu").items()}
    prep = tfc.prepare(ckt, params, "cpu", input_node="Vs", row_controls=rows, shape=(b, t))
    assert prep.prog.emitter.r_kind == (name.partition(":")[2] or "scalar")
    prog = cg.sweep_program(ckt, prep.prog)
    z0 = tfc._state_stack(prog, state, vin)
    one = _one_thread(prep, vin, z0)
    want, _, want_seq = tfc.fused_circuit_process_plain(ckt, params, vin, state, input_node="Vs",
                                                        row_controls=rows, return_state_seq=True)
    budget = 1e-5 if name.startswith("distilled") else 2e-5
    np.testing.assert_allclose(one[0].numpy(), want.numpy(), atol=budget, rtol=0)
    np.testing.assert_allclose(one[2].numpy(), torch.stack(want_seq).numpy(), atol=budget, rtol=0)
    runs = _lanes(host_lanes_cxx, name.replace(":", "_"), prog, prep, vin, z0)
    assert sorted(runs) == list(prog.lanes[1:])
    for K, (out, zf, seq) in runs.items():
        for rank in range(K):
            assert torch.equal(out[rank], one[0]), (K, rank)
            assert torch.equal(zf[rank], one[1]), (K, rank)
            assert torch.equal(seq[rank], one[2]), (K, rank)


def _jax_scan(jckt, jparams, vin):
    b = vin.shape[0]
    jstate = {k: {f: jnp.zeros(b) for f in d} for k, d in jckt.init_state().items()}
    want, _ = jckt.process(jparams, jstate, {"Vs": {"v": jnp.asarray(vin.T)}})
    return np.asarray(want).T


@pytest.mark.parametrize("name", ["distilled", "relu", "sigmoid"])
def test_lane_forms_match_jax(jax_distilled, host_lanes_cxx, tmp_path, name):
    """The one-thread host step on the same numpy input as the JAX
    package's scan, and the lane form (the program's K) on its first rows:
    the distilled clipper within 1e-5, the relu and sigmoid 2x8 roots, saved
    and loaded as JSON model files, within 2e-5; every lane of the group
    has the one-thread step's bits."""
    b, t = 37, 256
    rng = np.random.default_rng(len(name) + 1)
    if name == "distilled":
        jroot, root = jax_distilled
        ckt, jckt = tdc.make_diode_clipper(root, FS, R_SRC, CAP), jax_clipper(jroot, FS, R_SRC,
                                                                              CAP)
        params, jparams = ckt.init_params("cpu"), jckt.init_params()
        vin = (2.5 * rng.standard_normal((b, t))).astype(np.float32)
        budget = 1e-5
    else:
        widths, acts = MLPS[name]
        mlp = _mlp(widths, len(name))
        tmlp = {"layers": [{k: torch.from_numpy(v) for k, v in l.items()}
                           for l in mlp["layers"]]}
        save_model_json(tmlp, acts, str(tmp_path / f"{name}.json"))
        tmlp, acts, _ = load_model_json(str(tmp_path / f"{name}.json"), device="cpu")
        root, frag = NeuralDiodeRoot.from_mlp("dp", tmlp, acts)
        jroot = JaxNeuralDiodeRoot(name="dp", n_layers=root.n_layers,
                                   layer_size=root.layer_size, activations=tuple(acts))
        ckt, jckt = tdc.make_diode_clipper(root, FS), jax_clipper(jroot, FS)
        params = {**ckt.init_params("cpu"), **frag}
        jparams = {**jckt.init_params(),
                   "dp": {"layers": [{k: jnp.asarray(v) for k, v in l.items()}
                                     for l in mlp["layers"]]}}
        vin = (1.5 * rng.standard_normal((b, t))).astype(np.float32)
        budget = 2e-5
    want = _jax_scan(jckt, jparams, vin)
    prep = tfc.prepare(ckt, params, "cpu", input_node="Vs")
    x = torch.from_numpy(vin)
    z0 = torch.zeros((len(prep.prog.state_order), b))
    one = _one_thread(prep, x, z0)
    np.testing.assert_allclose(one[0].numpy(), want, atol=budget, rtol=0)
    K, rows = tfc.lanes_for(prep.prog, b), 6  # the lane form on the first rows
    out = _lanes(host_lanes_cxx, f"jax_{name}", prep.prog, prep, x[:rows].contiguous(),
                 z0[:, :rows].contiguous())[K][0]
    np.testing.assert_allclose(out[0].numpy(), want[:rows], atol=budget, rtol=0)
    for rank in range(K):
        assert torch.equal(out[rank], one[0][:rows]), rank
