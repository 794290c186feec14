"""diffwdf_tpu_torch fused clipper wrappers vs the JAX package.

On the CPU a wrapper runs its kernel's plain version (a loop over time,
vectorised over B).  Each plain version is held against the JAX Pallas
kernel (interpret mode, as tests/test_fused_kernel.py runs it) and against
JAX's scan engine (``Circuit.process`` vmapped over B) on the same seeded
inputs and weights, at the JAX suite's budgets: analytic atol 5e-6, neural
atol 2e-5.  The plain analytic version uses the kernel's precomputed
constants log(R_up Is / (n Vt)) where the scan computes log(R Is / Vt / mu);
the two round differently, inside the 5e-6 budget.

The CUDA kernels themselves run only on a card: tests/test_torch_gpu.py
compares each kernel with its plain version there.
"""

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
import diffwdf_tpu_torch as tw
from diffwdf_tpu.models.diode_clipper import make_diode_clipper as jax_make_diode_clipper
from diffwdf_tpu.ops import fused_clipper as jfc
from diffwdf_tpu.roots.omega import omega_quality_iters
from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper
from diffwdf_tpu_torch.nn.convert import params_from_jax
from diffwdf_tpu_torch.ops import fused_clipper as tfc

FS = 96000.0
R_SRC = 47.0e3
CAP = 2.2e-9
B, T = 1024, 256
PRETRAINED_2X16 = (Path(__file__).resolve().parents[1]
                   / "models/pretrained/1N4148 (1U-1D)_2x16_pretrained_model.json")


def _vin(seed, b=B, t=T, amp=2.0):
    return (amp * np.random.default_rng(seed).standard_normal((b, t))).astype(np.float32)


def _jax_scan(root, root_params, vin):
    ckt = jax_make_diode_clipper(root, FS, R_SRC, CAP)
    params = {**ckt.init_params(), **root_params}
    state = ckt.init_state()

    def one(v):
        out, st = ckt.process(params, state, {"Vs": {"v": v}})
        return out, st["C"]["z"]

    out, zf = jax.vmap(one)(jnp.asarray(vin))
    return np.asarray(out), np.asarray(zf)


def _analytic_args(diode):
    return (R_SRC, CAP, diode.Is, diode.Vt * diode.nabla, float(diode.N_up),
            float(diode.N_down))


@pytest.fixture(autouse=True)
def _fresh_counters():
    tfc.fused_clipper_analytic.launches = 0
    tfc.fused_clipper_neural.launches = 0


@pytest.mark.parametrize("diode", ["diode_1n4148_1u1d", "diode_1n4148_1u2d"])
def test_analytic_plain_matches_jax_kernel_and_scan(diode):
    d = getattr(dwdf, diode)
    vin = _vin(0)
    z0 = np.zeros((B,), np.float32)
    want, want_z = jfc.fused_clipper_analytic(
        jnp.asarray(vin), jnp.asarray(z0), *_analytic_args(d), fs=FS, interpret=True)
    root = dwdf.DiodePairRoot(name="dp", diode=d, quality="best")
    scan, scan_z = _jax_scan(root, root.init_params(), vin)
    got, got_z = tfc.fused_clipper_analytic(
        torch.from_numpy(vin), torch.from_numpy(z0), *_analytic_args(d), fs=FS)
    for ref, ref_z in ((np.asarray(want), np.asarray(want_z)), (scan, scan_z)):
        np.testing.assert_allclose(got.numpy(), ref, atol=5e-6, rtol=0)
        np.testing.assert_allclose(got_z.numpy(), ref_z, atol=5e-6, rtol=0)
    assert tfc.fused_clipper_analytic.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("quality", ["good", "low"])
def test_analytic_plain_quality_matches_jax_kernel(quality):
    iters = omega_quality_iters[quality]
    d = dwdf.diode_1n4148_1u1d
    vin = _vin(1, t=128)
    z0 = np.zeros((B,), np.float32)
    want, _ = jfc.fused_clipper_analytic(
        jnp.asarray(vin), jnp.asarray(z0), *_analytic_args(d), fs=FS,
        quality_iters=iters, interpret=True)
    got, _ = tfc.fused_clipper_analytic(
        torch.from_numpy(vin), torch.from_numpy(z0), *_analytic_args(d), fs=FS,
        quality_iters=iters)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=5e-6, rtol=0)


NEURAL_CASES = {
    "pretrained_2x16": lambda: dwdf.load_model_json(PRETRAINED_2X16)[:2],
    "random_4x8": lambda: (dwdf.NeuralDiodeRoot(name="dp", n_layers=4, layer_size=8)
                           .init_params(jax.random.PRNGKey(19))["dp"],
                           dwdf.mlp_arch(4, 8)[1]),
    "random_2x4": lambda: (dwdf.NeuralDiodeRoot(name="dp", n_layers=2, layer_size=4)
                           .init_params(jax.random.PRNGKey(7))["dp"],
                           dwdf.mlp_arch(2, 4)[1]),
}


@pytest.mark.parametrize("case", sorted(NEURAL_CASES))
def test_neural_plain_matches_jax_kernel_and_scan(case):
    mlp, acts = NEURAL_CASES[case]()
    vin = _vin(2)
    z0 = np.zeros((B,), np.float32)
    want, want_z = jfc.fused_clipper_neural(
        jnp.asarray(vin), jnp.asarray(z0), mlp, R_SRC, CAP, fs=FS, interpret=True)
    root, root_params = dwdf.NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    scan, scan_z = _jax_scan(root, root_params, vin)
    tmlp = params_from_jax(jax.tree_util.tree_map(np.asarray, mlp), "cpu")
    got, got_z = tfc.fused_clipper_neural(
        torch.from_numpy(vin), torch.from_numpy(z0), tmlp, R_SRC, CAP, fs=FS)
    for ref, ref_z in ((np.asarray(want), np.asarray(want_z)), (scan, scan_z)):
        np.testing.assert_allclose(got.numpy(), ref, atol=2e-5, rtol=0)
        np.testing.assert_allclose(got_z.numpy(), ref_z, atol=2e-5, rtol=0)
    assert tfc.fused_clipper_neural.launches == 0  # CPU tensors never launch


def _neural_params(device="cpu"):
    return tw.NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16).init_params(
        device, torch.Generator().manual_seed(3))["dp"]


def _run(kind, vin, z0, plain=False):
    """One of the two wrappers (or, with plain=True, its plain version) on
    the 1U-2D diode pair or a seeded 2x16 net on vin's device."""
    if kind == "analytic":
        fn = tfc.fused_clipper_analytic_plain if plain else tfc.fused_clipper_analytic
        return fn(vin, z0, *_analytic_args(tw.diode_1n4148_1u2d), fs=FS)
    fn = tfc.fused_clipper_neural_plain if plain else tfc.fused_clipper_neural
    return fn(vin, z0, _neural_params(vin.device), R_SRC, CAP, fs=FS)


@pytest.mark.parametrize("kind", ["analytic", "neural"])
def test_state_carry_two_halves_equal_one_block(kind):
    vin = torch.from_numpy(_vin(4, b=64))
    z0 = torch.zeros(64)
    full, zf = _run(kind, vin, z0)
    h1, z1 = _run(kind, vin[:, : T // 2], z0)
    h2, z2 = _run(kind, vin[:, T // 2:], z1)
    np.testing.assert_allclose(torch.cat([h1, h2], 1).numpy(), full.numpy(), atol=1e-6, rtol=0)
    np.testing.assert_allclose(z2.numpy(), zf.numpy(), atol=1e-6, rtol=0)


@pytest.mark.parametrize("kind", ["analytic", "neural"])
def test_plain_matches_port_circuit_at_ragged_batch(kind):
    """Any B works (no multiple-of-1024 rule): B = 3 against the port's own
    Circuit.process with a non-zero initial state."""
    vin = torch.from_numpy(_vin(5, b=3, t=96))
    z0 = torch.tensor([0.3, -0.2, 0.0])
    got, got_z = _run(kind, vin, z0)
    if kind == "analytic":
        root = tw.DiodePairRoot(name="dp", diode=tw.diode_1n4148_1u2d)
        rp = root.init_params("cpu")
    else:
        root = tw.NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
        rp = {"dp": _neural_params()}
    ckt = make_diode_clipper(root, FS, R_SRC, CAP)
    want, st = ckt.process({**ckt.init_params("cpu"), **rp}, {"C": {"z": z0}},
                           {"Vs": {"v": vin.T}})
    budget = 5e-6 if kind == "analytic" else 2e-5
    np.testing.assert_allclose(got.numpy(), want.T.numpy(), atol=budget, rtol=0)
    np.testing.assert_allclose(got_z.numpy(), st["C"]["z"].numpy(), atol=budget, rtol=0)


def test_wrappers_reject_what_the_kernels_do_not_take():
    vin, z0 = torch.zeros(4, 8), torch.zeros(4)
    with pytest.raises(ValueError):
        _run("analytic", torch.zeros(8), z0)
    with pytest.raises(ValueError):
        _run("neural", vin, torch.zeros(5))
    with pytest.raises(TypeError):
        _run("analytic", vin.double(), z0.double())
    bad_width = tw.NeuralDiodeRoot(name="dp", n_layers=2, layer_size=5).init_params("cpu")["dp"]
    no_hidden = {"layers": _neural_params()["layers"][:1] + _neural_params()["layers"][-1:]}
    for mlp in (bad_width, no_hidden):
        with pytest.raises(ValueError):
            tfc.fused_clipper_neural(vin, z0, mlp, R_SRC, CAP, fs=FS)
    assert tfc.fused_clipper_analytic.launches == tfc.fused_clipper_neural.launches == 0
