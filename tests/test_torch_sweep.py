"""diffwdf_tpu_torch parameter sweeps and model-zoo ensembles vs the JAX package.

``parallel.sweep`` on the CPU runs the generated circuit kernel's plain
version (B7 in ROADMAP; on a card the kernel itself, tests/test_torch_gpu.py).
The JAX side is ``diffwdf_tpu.parallel.sweep`` without a mesh (a ``vmap`` of
``Circuit.process``).  Budget: the JAX suite's kernel-vs-scan 2e-5
(tests/test_fused_circuit.py:55-118).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
from diffwdf_tpu.models.diode_clipper import make_diode_clipper as jax_clipper
from diffwdf_tpu.parallel import sweep as jsw
from diffwdf_tpu.roots.neural import mlp_arch, mlp_init
from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper
from diffwdf_tpu_torch.ops import fused_circuit as fcirc
from diffwdf_tpu_torch.parallel import sweep as tsw
from diffwdf_tpu_torch.roots.diode import DiodePairRoot, diode_1n4148_1u1d
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot

FS = 96000.0
N, T = 16, 128
BUDGET = 2e-5


def _vin(seed=0, t=T):
    n = np.arange(t)
    rng = np.random.default_rng(seed)
    return (2.0 * np.sin(2 * np.pi * 440.0 * n / FS) + 0.1 * rng.standard_normal(t)).astype(
        np.float32)


def _clippers():
    jroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    jck = jax_clipper(jroot, FS)
    tck = make_diode_clipper(DiodePairRoot(name="dp", diode=diode_1n4148_1u1d), FS)
    return (jck, {**jck.init_params(), **jroot.init_params()}), (tck, tck.init_params("cpu"))


def _both(overrides, vin):
    (jck, jp), (tck, tp) = _clippers()
    want = jsw.sweep_process(jck, jp, {k: jnp.asarray(v) for k, v in overrides.items()},
                             {"Vs": {"v": jnp.asarray(vin)}})
    got = tsw.sweep_process(tck, tp, overrides, {"Vs": {"v": vin}}, device="cpu")
    return np.asarray(want), got.numpy()


def test_sweep_source_resistance_matches_jax():
    """BASELINE configuration 4's sweep, one row per source R (an impedance
    control, so one launch of B7 on a card)."""
    r = np.linspace(1e3, 100e3, N).astype(np.float32)
    want, got = _both({"Vs.R": r}, _vin())
    assert got.shape == (N, T)
    np.testing.assert_allclose(got, want, atol=BUDGET)
    e = np.mean(got[:, 32:] ** 2, axis=1)
    assert e[0] > e[-1]  # more source R -> stronger lowpass -> less energy


@pytest.mark.parametrize("overrides", [
    {"C.C": np.array([1e-9, 2.2e-9, 4.7e-9, 2.2e-9] * 4, np.float32)},
    {"dp.Is": np.array([4e-9, 4e-8] * 8, np.float32),
     "Vs.R": np.linspace(1e3, 100e3, N).astype(np.float32)},
], ids=["capacitance", "diode_is_and_source_r"])
def test_sweep_of_coefficient_leaves_matches_jax(overrides):
    """A swept leaf outside the impedance controls: one launch per distinct
    value, the outputs back in row order."""
    want, got = _both(overrides, _vin(1))
    np.testing.assert_allclose(got, want, atol=BUDGET)
    assert np.abs(got[0] - got[1]).max() > 1e-4  # rows 0 and 1 differ in the swept leaf


def test_sweep_rejects_unknown_override():
    _, (tck, tp) = _clippers()
    with pytest.raises(ValueError):
        tsw.sweep_process(tck, tp, {"Vs.L": np.ones(4, np.float32)}, {"Vs": {"v": _vin()}},
                          device="cpu")


def test_sweep_counts_no_launch_on_the_cpu():
    _, (tck, tp) = _clippers()
    before = fcirc.fused_circuit_process.launches
    tsw.sweep_process(tck, tp, {"Vs.R": np.full(4, 47e3, np.float32)}, {"Vs": {"v": _vin()}},
                      device="cpu")
    assert fcirc.fused_circuit_process.launches == before


def test_ensemble_matches_jax():
    """Four stacked 1x4 roots (tests/test_parallel.py:385-400)."""
    sizes, acts = mlp_arch(1, 4)
    mlps = [mlp_init(jax.random.PRNGKey(i), sizes) for i in range(4)]
    vin = np.random.default_rng(0).normal(size=T).astype(np.float32)
    want = np.asarray(jsw.ensemble_process(lambda root: jax_clipper(root, FS),
                                           jsw.stack_mlp_params(mlps), acts,
                                           {"Vs": {"v": jnp.asarray(vin)}}))
    stack = tsw.stack_mlp_params([{"layers": [{k: torch.tensor(np.asarray(l[k])) for k in l}
                                              for l in m["layers"]]} for m in mlps])
    got = tsw.ensemble_process(lambda root: make_diode_clipper(root, FS), stack, acts,
                               {"Vs": {"v": vin}}, device="cpu").numpy()
    assert got.shape == (4, T)
    np.testing.assert_allclose(got, want, atol=BUDGET)
    assert np.abs(got[0] - got[1]).max() > 1e-6


def test_ensemble_refuses_a_root_outside_the_nxh_family():
    sizes, _ = mlp_arch(1, 4)
    mlps = [mlp_init(jax.random.PRNGKey(i), sizes) for i in range(2)]
    stack = tsw.stack_mlp_params([{"layers": [{k: torch.tensor(np.asarray(l[k])) for k in l}
                                              for l in m["layers"]]} for m in mlps])
    with pytest.raises(ValueError):
        tsw.ensemble_process(lambda root: make_diode_clipper(root, FS), stack,
                             ("relu", "relu", ""), {"Vs": {"v": _vin()}}, device="cpu")


def test_expand_and_stack_shapes():
    _, (tck, tp) = _clippers()
    r = torch.linspace(1e3, 1e5, 5)
    params, axes = tsw.expand_params(tp, {"Vs.R": r})
    assert params["Vs"]["R"].shape == (5,) and axes["Vs"]["R"] == 0
    assert params["C"]["C"].shape == () and axes["C"]["C"] is None
    with pytest.raises(ValueError):
        tsw.expand_params(tp, {"Vs.R": r, "C.C": torch.ones(4)})
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8)
    mlps = [root.init_params("cpu", torch.Generator().manual_seed(i))["dp"] for i in range(3)]
    stack = tsw.stack_mlp_params(mlps)
    assert [tuple(l["kernel"].shape) for l in stack["layers"]] == [
        (3, 2, 8), (3, 8, 8), (3, 8, 8), (3, 8, 1)]
    assert [tuple(l["bias"].shape) for l in stack["layers"]] == [(3, 8), (3, 8), (3, 8), (3, 1)]
    torch.testing.assert_close(stack["layers"][1]["kernel"][2], mlps[2]["layers"][1]["kernel"])
