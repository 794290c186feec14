"""diffwdf_tpu_torch pretraining and JSON export vs the JAX package.

``training.pretrain`` on the CPU runs the same minibatch steps eagerly that a
card replays from CUDA graphs.  The JAX package's initial weights and
per-epoch orders go in through the port's two seams (``_init_params``,
``_epoch_order``), computed as ``diffwdf_tpu/training/pretrain.py`` computes
them, so both packages take the same steps.  Budgets: the loss / MSE / ESR
histories rtol 5e-4 (the JAX suite's training-history tolerance,
tests/test_clipper_train.py:186), the final weights atol 1e-5 (a few f32
roundings of Adam steps of lr 1e-3).  ``save_layers_json`` gives the same
JSON as the JAX exporter, byte for byte.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffwdf_tpu.nn import serialization as jser
from diffwdf_tpu.roots.diode import diode_1n4148_1u1d as jax_diode
from diffwdf_tpu.roots.neural import mlp_arch as jax_mlp_arch, mlp_init as jax_mlp_init
from diffwdf_tpu.training import pretrain as jpt
from diffwdf_tpu_torch.nn import serialization as tser
from diffwdf_tpu_torch.roots.diode import diode_1n4148_1u1d
from diffwdf_tpu_torch.roots.neural import mlp_apply
from diffwdf_tpu_torch.training import pretrain as tpt

SMALL = dict(n_layers=2, layer_size=8, epochs=5, n_r=8, n_a=128, learning_rate=1e-3)
HIST_RTOL = 5e-4
PARAM_ATOL = 1e-5


def _to_torch(mlp):
    return {"layers": [{k: torch.tensor(np.asarray(l[k])) for k in ("kernel", "bias")}
                       for l in mlp["layers"]]}


def _orders(key, cfg, n, n_batches):
    """The epochs' orders as pretrain.py:100,114,127 draws them from key."""
    ekeys = jax.random.split(jax.random.fold_in(key, 0), cfg.epochs)
    return [np.asarray(jax.random.permutation(k, n)[: n_batches * cfg.batch_size])
            .reshape(n_batches, cfg.batch_size) for k in ekeys]


def _feed(monkeypatch, inits, orders):
    """Make the port's seams hand out JAX's initial weights (one per seed,
    in seed order) and orders (per epoch, seeds in order)."""
    inits, orders = iter(inits), iter(orders)
    monkeypatch.setattr(tpt, "_init_params", lambda g, sizes, device: _to_torch(next(inits)))
    monkeypatch.setattr(tpt, "_epoch_order", lambda g, n, nb, b: torch.tensor(next(orders)))


def _check_hist(got, want):
    for k in ("loss", "mse", "esr"):
        np.testing.assert_allclose(got[k], np.asarray(want[k]), rtol=HIST_RTOL, err_msg=k)


def _check_params(got, want):
    for lt, lj in zip(got["layers"], want["layers"]):
        for k in ("kernel", "bias"):
            np.testing.assert_allclose(lt[k].numpy(), np.asarray(lj[k]), atol=PARAM_ATOL)


@pytest.mark.parametrize("schedule", ["const", "cosine"])
def test_pretrain_history_matches_jax(monkeypatch, schedule):
    jcfg = jpt.PretrainConfig(**SMALL, schedule=schedule)
    tcfg = tpt.PretrainConfig(**SMALL, schedule=schedule)
    jparams, jacts, jm = jpt.pretrain_diode(jax_diode, jcfg)

    sizes, _ = jax_mlp_arch(jcfg.n_layers, jcfg.layer_size)
    key, init_key = jax.random.split(jax.random.PRNGKey(jcfg.seed))  # pretrain.py:68-69
    n = jcfg.n_r * jcfg.n_a
    n_batches = n // jcfg.batch_size
    _feed(monkeypatch, [jax_mlp_init(init_key, sizes)], _orders(key, jcfg, n, n_batches))
    params, acts, m = tpt.pretrain_diode(diode_1n4148_1u1d, tcfg, device="cpu")

    assert acts == tuple(jacts)
    assert all(m[k].shape == (SMALL["epochs"],) for k in ("loss", "mse", "esr"))
    _check_hist(m, jm)
    _check_params(params, jparams)


def test_pretrain_multiseed_matches_jax(monkeypatch):
    seeds = (0, 3, 7)
    jcfg = jpt.PretrainConfig(**SMALL)
    tcfg = tpt.PretrainConfig(**SMALL)
    jparams, _, jm = jpt.pretrain_diode_multiseed(jax_diode, jcfg, seeds)

    sizes, _ = jax_mlp_arch(jcfg.n_layers, jcfg.layer_size)
    keys = jnp.stack([jax.random.PRNGKey(s) for s in seeds])  # pretrain.py:155-158
    init_keys, data_keys = jnp.moveaxis(
        jax.vmap(lambda k: jnp.stack(jax.random.split(k)))(keys), 1, 0)
    n = jcfg.n_r * jcfg.n_a
    n_batches = n // jcfg.batch_size
    per_seed = [_orders(data_keys[i], jcfg, n, n_batches) for i in range(len(seeds))]
    orders = [per_seed[s][e] for e in range(jcfg.epochs) for s in range(len(seeds))]
    _feed(monkeypatch, [jax_mlp_init(k, sizes) for k in init_keys], orders)
    params, _, m = tpt.pretrain_diode_multiseed(diode_1n4148_1u1d, tcfg, seeds, device="cpu")

    assert m["loss"].shape == (len(seeds), SMALL["epochs"])
    assert params["layers"][0]["kernel"].shape == (len(seeds), 2, SMALL["layer_size"])
    assert params["layers"][0]["bias"].shape == (len(seeds), SMALL["layer_size"])
    _check_hist(m, jm)
    _check_params(params, jparams)


def test_pretrain_multiseed_seed_rows_are_single_runs():
    """Seed s of a multiseed run is the single-seed run of seed s (the port
    draws every seed's weights and orders from its own generator)."""
    cfg = tpt.PretrainConfig(**{**SMALL, "epochs": 3})
    stacked, _, ms = tpt.pretrain_diode_multiseed(diode_1n4148_1u1d, cfg, (0, 5), device="cpu")
    for i, seed in enumerate((0, 5)):
        one, _, m1 = tpt.pretrain_diode(diode_1n4148_1u1d, tpt.PretrainConfig(
            **{**SMALL, "epochs": 3, "seed": seed}), device="cpu")
        np.testing.assert_allclose(ms["loss"][i], m1["loss"], rtol=HIST_RTOL)
        np.testing.assert_allclose(stacked["layers"][0]["kernel"][i].numpy(),
                                   one["layers"][0]["kernel"].numpy(), atol=PARAM_ATOL)


def test_pretrain_smoke():
    """Short pretraining run reduces loss and beats the trivial predictor
    (tests/test_training.py:99-108)."""
    cfg = tpt.PretrainConfig(n_layers=2, layer_size=8, epochs=30, n_r=8, n_a=128,
                             learning_rate=1e-3)
    params, acts, metrics = tpt.pretrain_diode(diode_1n4148_1u1d, cfg, device="cpu")
    losses = np.asarray(metrics["loss"])
    assert losses[-1] < losses[0] * 0.5
    final = tpt.evaluate_pretrained(params, acts, diode_1n4148_1u1d, cfg, device="cpu")
    assert np.isfinite(final["mse"]) and final["mse"] < 0.5


def test_full_pretrain_reports_every_seed(monkeypatch, capsys):
    """``chip_smoke.py --full-pretrain`` reports each seed's final grid MSE
    and ESR and names the best seed (one epoch, two seeds, on the CPU)."""
    import ast
    import re

    import chip_smoke

    monkeypatch.setattr(chip_smoke, "PRETRAIN_SEEDS", 2)
    chip_smoke.full_pretrain(torch.device("cpu"), "cpu", 3, 1)
    line = capsys.readouterr().out.strip().splitlines()[-1]
    assert line.startswith("phase full pretrain 2x16") and "seeds=[3, 4]" in line
    mse = ast.literal_eval(re.search(r" mse=(\[[^\]]*\])", line).group(1))
    esr = ast.literal_eval(re.search(r" esr=(\[[^\]]*\])", line).group(1))
    assert len(mse) == len(esr) == 2 and np.isfinite(mse + esr).all()
    assert f"best_seed={3 + int(np.argmin(mse))}" in line


def test_evaluate_pretrained_matches_jax():
    cfg = dict(n_r=8, n_a=128)
    sizes, acts = jax_mlp_arch(2, 8)
    mlp = jax_mlp_init(jax.random.PRNGKey(4), sizes)
    want = jpt.evaluate_pretrained(mlp, acts, jax_diode, jpt.PretrainConfig(**cfg))
    got = tpt.evaluate_pretrained(_to_torch(mlp), acts, diode_1n4148_1u1d,
                                  tpt.PretrainConfig(**cfg), device="cpu")
    for k in ("mse", "esr"):
        assert got[k] == pytest.approx(want[k], rel=1e-5)


@pytest.mark.parametrize("bad", [{"schedule": "linear"}, {"matmul_precision": "bf16"}])
def test_pretrain_rejects_unknown_settings(bad):
    cfg = tpt.PretrainConfig(**{**SMALL, "epochs": 1, **bad})
    with pytest.raises(ValueError):
        tpt.pretrain_diode(diode_1n4148_1u1d, cfg, device="cpu")


def test_pretrain_restores_tf32_setting():
    old = torch.backends.cuda.matmul.allow_tf32
    cfg = tpt.PretrainConfig(**{**SMALL, "epochs": 1, "matmul_precision": "high"})
    tpt.pretrain_diode(diode_1n4148_1u1d, cfg, device="cpu")
    assert torch.backends.cuda.matmul.allow_tf32 == old


def test_pretrained_model_round_trips_json(tmp_path):
    cfg = tpt.PretrainConfig(**{**SMALL, "epochs": 2})
    params, acts, _ = tpt.pretrain_diode(diode_1n4148_1u1d, cfg, device="cpu")
    path = tmp_path / "m.json"
    tser.save_model_json(params, acts, path)
    back, back_acts, d_in = tser.load_model_json(path, device="cpu")
    assert back_acts == tuple(acts) and d_in == 2
    x = torch.tensor(np.random.default_rng(0).standard_normal((64, 2)).astype(np.float32))
    torch.testing.assert_close(mlp_apply(back, back_acts, x), mlp_apply(params, acts, x),
                               rtol=0, atol=0)
    # the JAX loader reads the same file to the same weights
    jmlp, jacts, _ = jser.load_model_json(str(path))
    assert tuple(jacts) == tuple(acts)
    for lj, lt in zip(jmlp["layers"], back["layers"]):
        np.testing.assert_array_equal(np.asarray(lj["kernel"]), lt["kernel"].numpy())


LAYER_SPECS = {
    "dense": [{"type": "dense", "activation": "tanh", "shape": [None, 3],
               "weights": [np.arange(6.0).reshape(2, 3) / 7, np.array([0.1, -0.2, 0.3])]}],
    "conv1d": [{"type": "conv1d", "activation": "relu", "shape": [None, None, 4],
                "kernel_size": 3, "dilation": [2],
                "weights": [np.linspace(-1, 1, 24).reshape(3, 2, 4), np.zeros(4)]}],
    "unknown": [{"type": "InputLayer", "activation": "elu", "shape": [None, 2], "weights": []},
                {"type": "dense", "activation": "", "shape": [None, 1],
                 "weights": [np.ones((2, 1)) * 0.5, np.array([0.25])]}],
}


@pytest.mark.parametrize("kind", sorted(LAYER_SPECS))
def test_save_layers_json_matches_jax(tmp_path, kind):
    specs = LAYER_SPECS[kind]
    jpath, tpath = tmp_path / "j.json", tmp_path / "t.json"
    want = jser.save_layers_json(specs, str(jpath), in_shape=(None, 2))
    tspecs = [{**s, "weights": [torch.tensor(w, dtype=torch.float64) for w in s["weights"]]}
              for s in specs]
    got = tser.save_layers_json(tspecs, tpath, in_shape=(None, 2))
    assert json.dumps(got) == json.dumps(want)
    assert tpath.read_bytes() == jpath.read_bytes()
    assert tser.LAYER_TYPES == jser.LAYER_TYPES and tser.ACTIVATIONS == jser.ACTIVATIONS
