"""The port's native runtimes on the CPU against the JAX package.

``diffwdf_tpu_torch.native.lib`` is a copy of ``diffwdf_tpu/native/lib.py``
(the real-line omega oracle, the single-stream clipper engines, the CSV
loader), held to ``tests/test_native.py``'s budgets: omega 1e-12 relative
against scipy, the analytic clipper 3e-5 and the neural clipper 1e-5
against the JAX scan engine on the same seeded inputs.  The ``simulate``
command's native engine, a circuit's generated forward built for the host
(``ops._build.host_library``, ``ops.registry.host_run``), is held to
``tests/test_codegen.py``'s budgets against the JAX scan engine (analytic
1e-5, neural 1e-4) and against the JAX package's own native engine
(``native/codegen.py``, generated C from the jaxpr), with its state carried
across two calls; the host build is cached by its source and a failed
compile raises.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import diffwdf_tpu as jdwdf
from diffwdf_tpu.models.diode_clipper import make_diode_clipper as j_make_clipper
from diffwdf_tpu.models.tube_screamer import make_tube_screamer as j_make_ts
from diffwdf_tpu.roots.neural import NeuralDiodeRoot as JNeuralRoot
from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper
from diffwdf_tpu_torch.models.tube_screamer import make_tube_screamer
from diffwdf_tpu_torch.native import lib as native
from diffwdf_tpu_torch.nn.convert import params_from_jax
from diffwdf_tpu_torch.ops import _build
from diffwdf_tpu_torch.ops.circuit_codegen import state_order
from diffwdf_tpu_torch.ops.fused_circuit import prepare
from diffwdf_tpu_torch.ops.registry import host_run
from diffwdf_tpu_torch.roots.diode import DiodePairRoot, diode_1n4148_1u1d, diode_1n4148_1u2d
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot

FS = 48000.0


def _x(n=4096, amp=0.5, f=440.0):
    return (amp * np.sin(2 * np.pi * f * np.arange(n) / FS)).astype(np.float32)


def _engine(ckt, params, x, node, state=None):
    """The native engine of the simulate command: (out, final state (S, 1))."""
    prep = prepare(ckt, params, "cpu", input_node=node)
    if state is None:
        st = ckt.init_state("cpu")
        state = torch.stack([st[n][f].reshape(1) for n, f in state_order(ckt)])
    out, zf = host_run(prep.prog.host_source, torch.from_numpy(x)[None], state, prep.vec,
                       prep.rows, prep.times, prep.warr)
    return out[0].numpy(), zf


def _jax_scan(ckt, params, x, node):
    out, _ = ckt.process(params, ckt.init_state(), {node: {"v": jnp.asarray(x)}})
    return np.asarray(out)


def test_native_builds():
    assert native.available(), native.build_error()
    assert native.build_error() is None
    assert native._so_path().parent == _build.BUILD_DIR


def test_native_omega_vs_scipy_and_jax_native():
    from scipy.special import wrightomega

    from diffwdf_tpu.native import lib as jnative

    x = np.linspace(-200, 200, 40001)
    got = native.wrightomega(x)
    want = np.real(wrightomega(x))
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-300)
    assert np.max(rel) < 1e-12, float(np.max(rel))
    np.testing.assert_array_equal(got, jnative.wrightomega(x))  # the same source and flags


def test_native_clipper_vs_jax_engine():
    fs, r, c = 48000.0, 47e3, 2.2e-9
    diode = diode_1n4148_1u2d
    vt = diode.Vt * diode.nabla
    vin = (2.0 * np.random.default_rng(0).standard_normal(2048)).astype(np.float32)
    out_c, zf = native.clipper_process(vin, 0.0, r, c, fs, diode.Is, vt, diode.N_up,
                                       diode.N_down)

    root = jdwdf.DiodePairRoot(name="dp", diode=jdwdf.diode_1n4148_1u2d, quality="best")
    ckt = j_make_clipper(root, fs, r, c)
    params = {**ckt.init_params(), **root.init_params()}
    out_j, st = ckt.process(params, ckt.init_state(), {"Vs": {"v": jnp.asarray(vin)}})
    np.testing.assert_allclose(out_c, np.asarray(out_j), atol=3e-5)
    np.testing.assert_allclose(zf, float(st["C"]["z"]), atol=3e-5)


def test_native_neural_clipper_vs_jax():
    fs, r, c = 48000.0, 47e3, 2.2e-9
    jroot = JNeuralRoot(name="dp", n_layers=2, layer_size=8)
    frag = jroot.init_params(jax.random.PRNGKey(1))
    ckt = j_make_clipper(jroot, fs, r, c)
    params = {**ckt.init_params(), **frag}
    vin = (1.5 * np.random.default_rng(1).standard_normal(1024)).astype(np.float32)
    out_j, _ = ckt.process(params, ckt.init_state(), {"Vs": {"v": jnp.asarray(vin)}})

    mlp = params_from_jax(jax.tree_util.tree_map(np.asarray, frag["dp"]), "cpu")
    out_c, _ = native.clipper_process_neural(vin, 0.0, mlp, r, c, fs)
    np.testing.assert_allclose(out_c, np.asarray(out_j), atol=1e-5)


def test_native_csv_loader(tmp_path):
    from diffwdf_tpu_torch.data.dataimport import read_csv
    from diffwdf_tpu_torch.data.synthetic import write_reference_csv

    fs = 2000.0
    vin = np.random.default_rng(2).normal(size=500).astype(np.float32)
    vout = 0.5 * vin
    p = str(tmp_path / "10k_4.7nF.csv")
    write_reference_csv(p, vin, vout, fs)

    a, b, fs_read = native.load_csv(p)
    assert fs_read == fs
    np.testing.assert_allclose(a, vin, rtol=1e-5)
    np.testing.assert_allclose(b, vout, rtol=1e-5)
    rows, _ = read_csv(p, trim_pre_s=None, keep_s=None)
    np.testing.assert_allclose(a, rows[:, 0], rtol=1e-5)
    with pytest.raises(FileNotFoundError):
        native.load_csv(str(tmp_path / "missing.csv"))


def _cases(name):
    """(port circuit, port params, JAX circuit, JAX params, input node, input
    amplitude, budget vs the JAX scan) of a native-engine case."""
    if name == "neural":
        jroot = JNeuralRoot(name="dp", n_layers=2, layer_size=16)
        frag = jroot.init_params(jax.random.PRNGKey(1))
        jckt = j_make_clipper(jroot, FS)
        jparams = {**jckt.init_params(), **frag}
        mlp = params_from_jax(jax.tree_util.tree_map(np.asarray, frag["dp"]), "cpu")
        root, tfrag = NeuralDiodeRoot.from_mlp("dp", mlp, tuple(jroot.activations))
        ckt = make_diode_clipper(root, FS)
        return ckt, {**ckt.init_params("cpu"), **tfrag}, jckt, jparams, "Vs", 1.0, 1e-4
    jroot = jdwdf.DiodePairRoot(name="dp", diode=jdwdf.diode_1n4148_1u1d)
    root = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)
    if name == "clipper":
        jckt, ckt, node, amp = j_make_clipper(jroot, FS), make_diode_clipper(root, FS), "Vs", 1.5
    else:
        jckt, ckt = j_make_ts(jroot, FS, drive=0.8), make_tube_screamer(root, FS, drive=0.8)
        node, amp = "Vin", 0.2
    return (ckt, {**ckt.init_params("cpu"), **root.init_params("cpu")}, jckt,
            {**jckt.init_params(), **jroot.init_params()}, node, amp, 1e-5)


@pytest.mark.parametrize("name", ["clipper", "tube_screamer", "neural"])
def test_native_engine_matches_jax_scan(name):
    ckt, params, jckt, jparams, node, amp, budget = _cases(name)
    x = _x(amp=amp)
    y, _ = _engine(ckt, params, x, node)
    assert np.max(np.abs(y - _jax_scan(jckt, jparams, x, node))) < budget


def test_native_engine_matches_jax_native_codegen():
    """The port's native engine (the generated CUDA step, built for the host)
    against the JAX package's (C generated from the jaxpr), Tube Screamer."""
    from diffwdf_tpu.native.codegen import compile_circuit

    ckt, params, jckt, jparams, node, amp, budget = _cases("tube_screamer")
    x = _x(amp=amp)
    eng = compile_circuit(jckt, jparams)
    assert eng.n_states == len(state_order(ckt)) == 3
    want, _ = eng.process(x)
    y, _ = _engine(ckt, params, x, node)
    assert np.max(np.abs(y - want)) < budget


def test_native_engine_state_carries():
    ckt, params, _, _, node, amp, _ = _cases("tube_screamer")
    x = _x(amp=amp)
    full, _ = _engine(ckt, params, x, node)
    h1, st = _engine(ckt, params, x[:2048], node)
    h2, _ = _engine(ckt, params, x[2048:], node, st)
    np.testing.assert_allclose(np.concatenate([h1, h2]), full, atol=1e-6)


def test_host_build_is_cached_by_source_and_raises(monkeypatch, tmp_path):
    ckt, params, *_ = _cases("clipper")
    source = prepare(ckt, params, "cpu", input_node="Vs").prog.host_source
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_host_libs", {})
    before = _build.build_host.builds
    lib = _build.host_library(source)
    assert _build.build_host.builds == before + 1 and _build.host_path(source).exists()
    assert _build.host_library(source) is lib  # loaded once
    monkeypatch.setattr(_build, "_host_libs", {})
    _build.host_library(source)  # the library on disk: no compiler run
    assert _build.build_host.builds == before + 1
    with pytest.raises(RuntimeError, match="c\\+\\+ failed"):
        _build.host_library(source + "\nthis is not C++;\n")
    assert _build.build_host.builds == before + 2
