"""diffwdf_tpu_torch roots, JSON interchange and the parameter bridge vs JAX.

Budgets: Wright omega 5e-6 relative in f32 (values and implicit gradient);
diode-pair reflections 5e-6 absolute (the fused analytic kernel's budget);
the neural root loaded from the same JSON 2e-6 absolute (outputs up to ~2,
so ~16 f32 ulps: XLA and PyTorch sum the dense layers' dot products in
different orders and round tanh differently).
"""

import json
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
import diffwdf_tpu_torch as tw
from diffwdf_tpu.models.diode_clipper import make_diode_clipper
from diffwdf_tpu.roots import omega as jomega
from diffwdf_tpu_torch.nn.convert import params_from_jax
from diffwdf_tpu_torch.roots import omega as tomega

REPO = Path(__file__).resolve().parents[1]
PRETRAINED_2X16 = str(REPO / "models/pretrained/1N4148 (1U-1D)_2x16_pretrained_model.json")


def _omega_grid():
    rng = np.random.default_rng(0)
    x = np.concatenate([
        np.linspace(-60.0, 80.0, 4001),
        rng.uniform(-5.0, 5.0, 2000),
        [-1.0, 2.0, 0.0, 1.0, 1.0e6, 3.0e38],  # region seams and the top of f32
    ])
    return x.astype(np.float32)


@pytest.mark.parametrize("quality", sorted(tomega.omega_quality_iters))
def test_wright_omega_values_match_jax(quality):
    iters = tomega.omega_quality_iters[quality]
    assert iters == jomega.omega_quality_iters[quality]
    x = _omega_grid()
    want = np.asarray(jomega.wright_omega(jnp.asarray(x), iters))
    got = tw.wright_omega(torch.from_numpy(x), iters).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=0)
    want_u = np.asarray(jomega.wright_omega_u(jnp.asarray(x), iters))
    got_u = tomega.wright_omega_u(torch.from_numpy(x), iters).numpy()
    np.testing.assert_allclose(got_u, want_u, rtol=5e-6, atol=1e-6)


def test_wright_omega_gradient_matches_jax_grad():
    x = _omega_grid()
    want = np.asarray(jax.vmap(jax.grad(lambda v: jomega.wright_omega(v, 3)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_(True)
    tw.wright_omega(xt, 3).sum().backward()
    got = xt.grad.numpy()
    np.testing.assert_allclose(got, want, rtol=5e-6, atol=0)
    # the implicit derivative is finite and in [0, 1] everywhere, also at
    # the top of the f32 range where w / (1 + w) would overflow
    assert np.all(np.isfinite(got)) and got.min() >= 0.0 and got.max() <= 1.0


def test_wright_omega_f64_solves_its_equation():
    x = torch.linspace(-30.0, 50.0, 801, dtype=torch.float64)
    w = tw.wright_omega(x, 3)
    assert w.dtype == torch.float64
    np.testing.assert_allclose((w + torch.log(w)).numpy(), x.numpy(), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("diode", ["diode_1n4148_1u1d", "diode_1n4148_1u2d",
                                   "diode_1n4148_2u3d", "diode_oa1154_1u1d"])
def test_diode_pair_reflected_matches_jax(diode):
    jd, td = getattr(dwdf, diode), getattr(tw, diode)
    assert tuple(jd) == tuple(td)
    # |a| <= 3 V spans every incident wave the clipper sees at 2 V drive;
    # beyond it eqn 45's a - 2 Vt (mu0 w0 - mu1 w1) cancels more digits than
    # the two packages' exp/log rounding leaves under the budget
    a = np.concatenate([np.linspace(-3.0, 3.0, 2001), [0.0, -0.0]]).astype(np.float32)
    vt = td.Vt * td.nabla
    for R in (1.0, 2367.4, 2.2e3, 4.7e4):
        args = (R, td.Is, vt, float(td.N_up), float(td.N_down), 3)
        want = np.asarray(dwdf.diode_pair_reflected(jnp.asarray(a), *args))
        got = tw.diode_pair_reflected(torch.from_numpy(a), *args).numpy()
        np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
        if td.N_up == td.N_down:
            sym = (R, td.Is, vt, float(td.N_up), 3)
            want_s = np.asarray(dwdf.diode_pair_reflected_symmetric(jnp.asarray(a), *sym))
            got_s = tw.diode_pair_reflected_symmetric(torch.from_numpy(a), *sym).numpy()
            np.testing.assert_allclose(got_s, want_s, atol=5e-6, rtol=0)
    v = a[np.abs(a) <= 2.0]  # sinh(3 V / Vt) overflows f32 for the germanium diode
    np.testing.assert_allclose(
        tw.shockley_current(torch.from_numpy(v), td.Is, vt).numpy(),
        np.asarray(dwdf.shockley_current(jnp.asarray(v), jd.Is, vt)), rtol=5e-6)


@pytest.mark.parametrize("quality", ["best", "good", "low"])
def test_diode_pair_root_matches_jax(quality):
    jroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u2d, quality=quality)
    troot = tw.DiodePairRoot(name="dp", diode=tw.diode_1n4148_1u2d, quality=quality)
    assert troot.iters == jroot.iters
    jp = jroot.init_params()
    tp = troot.init_params("cpu")
    for f in jp["dp"]:
        np.testing.assert_array_equal(tp["dp"][f].numpy(), np.asarray(jp["dp"][f]))
    a = np.linspace(-4.0, 4.0, 501).astype(np.float32)
    want = np.asarray(jroot.reflect(jnp.asarray(a), jnp.float32(2367.4), jp, {}))
    got = troot.reflect(torch.from_numpy(a), torch.tensor(2367.4), tp, {}).numpy()
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)


def test_pretrained_neural_root_matches_jax():
    jmlp, jacts, jdin = dwdf.load_model_json(PRETRAINED_2X16)
    tmlp, tacts, tdin = tw.load_model_json(PRETRAINED_2X16, device="cpu")
    assert (tacts, tdin) == (jacts, jdin) == (("tanh", "tanh", "tanh", ""), 2)
    for jl, tl in zip(jmlp["layers"], tmlp["layers"]):
        np.testing.assert_array_equal(tl["kernel"].numpy(), np.asarray(jl["kernel"]))
        np.testing.assert_array_equal(tl["bias"].numpy(), np.asarray(jl["bias"]))
    jroot, jp = dwdf.NeuralDiodeRoot.from_mlp("dp", jmlp, jacts)
    troot, tp = tw.NeuralDiodeRoot.from_mlp("dp", tmlp, tacts)
    assert (troot.n_layers, troot.layer_size) == (jroot.n_layers, jroot.layer_size) == (2, 16)
    a = np.linspace(-3.0, 3.0, 1001).astype(np.float32)
    for R in (2367.4, 2.2e3):
        want = np.asarray(jroot.reflect(jnp.asarray(a), jnp.float32(R), jp, {}))
        got = troot.reflect(torch.from_numpy(a), torch.tensor(R), tp, {}).numpy()
        np.testing.assert_allclose(got, want, atol=2e-6, rtol=0)
    # the nn.Module view computes the same function on the same tensors
    mlp = tw.MLP(tmlp, tacts)
    x = torch.stack([torch.from_numpy(a), torch.full((a.size,), float(np.log(2367.4)))], -1)
    np.testing.assert_array_equal(mlp(x).detach().numpy(),
                                  tw.mlp_apply(tmlp, tacts, x).numpy())
    assert sum(p.numel() for p in mlp.parameters()) == 2 * 16 + 16 + 2 * (16 * 16 + 16) + 16 + 1


def test_save_model_json_round_trip_matches_jax(tmp_path):
    tmlp, tacts, _ = tw.load_model_json(PRETRAINED_2X16, device="cpu")
    jmlp, jacts, _ = dwdf.load_model_json(PRETRAINED_2X16)
    path = tmp_path / "m.json"
    saved = tw.save_model_json(tmlp, tacts, path)
    assert saved == dwdf.save_model_json(jmlp, jacts)
    assert json.loads(path.read_text()) == json.loads(json.dumps(saved))
    back, acts, _ = tw.load_model_json(path, device="cpu")
    assert acts == tacts
    for l0, l1 in zip(tmlp["layers"], back["layers"]):
        assert torch.equal(l0["kernel"], l1["kernel"]) and torch.equal(l0["bias"], l1["bias"])


def test_mlp_init_is_seeded_orthogonal():
    sizes, acts = tw.mlp_arch(2, 16)
    assert (sizes, acts) == dwdf.mlp_arch(2, 16)
    p0 = tw.mlp_init(torch.Generator().manual_seed(5), sizes, "cpu")
    p1 = tw.mlp_init(torch.Generator().manual_seed(5), sizes, "cpu")
    p2 = tw.mlp_init(torch.Generator().manual_seed(6), sizes, "cpu")
    for l0, l1, l2, (din, dout) in zip(p0["layers"], p1["layers"], p2["layers"],
                                       zip(sizes[:-1], sizes[1:])):
        k = l0["kernel"]
        assert k.shape == (din, dout) and torch.equal(k, l1["kernel"])
        assert not torch.equal(k, l2["kernel"])
        assert torch.count_nonzero(l0["bias"]) == 0
        gram = k.T @ k if din >= dout else k @ k.T
        np.testing.assert_allclose(gram.numpy(), np.eye(min(din, dout)), atol=1e-5)
    root = tw.NeuralDiodeRoot(name="dp", n_layers=4, layer_size=8)
    assert root.activations == dwdf.NeuralDiodeRoot(name="dp", n_layers=4, layer_size=8).activations
    assert [l["kernel"].shape[1] for l in root.init_params("cpu")["dp"]["layers"]] == [8] * 5 + [1]


def test_params_from_jax_round_trips():
    root = dwdf.NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    ckt = make_diode_clipper(root, 96000.0)
    tree = {**ckt.init_params(), **root.init_params(jax.random.PRNGKey(0))}
    assert sorted(tree) == ["C", "Vs", "dp"]
    leaves = jax.tree_util.tree_map(np.asarray, tree)
    got = params_from_jax(leaves, "cpu")
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(leaves)
    back = jax.tree_util.tree_map(lambda t: t.numpy(), got)
    for x, y in zip(jax.tree_util.tree_leaves(leaves), jax.tree_util.tree_leaves(back)):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)
    # leaves are copies: writing the port's tensors leaves the numpy tree alone
    got["dp"]["layers"][0]["bias"] += 1.0
    assert np.count_nonzero(leaves["dp"]["layers"][0]["bias"]) == 0


def test_port_imports_no_jax():
    code = ("import sys\n"
            "import diffwdf_tpu_torch\n"
            "import diffwdf_tpu_torch.ops.fused_clipper, diffwdf_tpu_torch.ops._build\n"
            "import diffwdf_tpu_torch.models.diode_clipper, diffwdf_tpu_torch.nn.convert\n"
            "import diffwdf_tpu_torch.ops.clipper_train\n"
            "import diffwdf_tpu_torch.data.dataimport, diffwdf_tpu_torch.data.synthetic\n"
            "import diffwdf_tpu_torch.training.losses, diffwdf_tpu_torch.training.metrics\n"
            "import diffwdf_tpu_torch.training.checkpoint\n"
            "import diffwdf_tpu_torch.training.circuit_train\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'diffwdf_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
