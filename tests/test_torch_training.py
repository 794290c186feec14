"""diffwdf_tpu_torch's training support modules vs the JAX package.

Losses, batching, the measurement-CSV importer, the synthetic data sets, the
checkpoint format and the metrics log, on the same seeded numpy inputs in
both packages.  Budgets: losses rtol 1e-6 (f32 sums in another order);
synthetic clipper measurements atol 5e-6 (the analytic kernel's budget: the
port runs the fused analytic kernel's plain version, the JAX package its
scan); batches, CSV data and checkpoints exactly.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
import diffwdf_tpu_torch as tw
from diffwdf_tpu.data import dataimport as jdi
from diffwdf_tpu.data import synthetic as jsyn
from diffwdf_tpu.models.diode_clipper import make_training_clipper as jax_training_clipper
from diffwdf_tpu.training import checkpoint as jck
from diffwdf_tpu.training import circuit_train as jct
from diffwdf_tpu.training import losses as jl
from diffwdf_tpu.training import metrics as jmet
from diffwdf_tpu_torch.data import dataimport as tdi
from diffwdf_tpu_torch.data import synthetic as tsyn
from diffwdf_tpu_torch.nn.convert import params_from_jax
from diffwdf_tpu_torch.ops import fused_clipper as tfc
from diffwdf_tpu_torch.training import checkpoint as tck
from diffwdf_tpu_torch.training import circuit_train as tct
from diffwdf_tpu_torch.training import losses as tl
from diffwdf_tpu_torch.training import metrics as tmet


def _pair(seed=0, shape=(6, 200)):
    rng = np.random.default_rng(seed)
    t = rng.standard_normal(shape).astype(np.float32)
    p = (t + 0.1 * rng.standard_normal(shape)).astype(np.float32)
    return t, p


LOSSES = {
    "mse": lambda m, t, p: m.mse(t, p),
    "esr": lambda m, t, p: m.esr(t, p),
    "esr_n_norm": lambda m, t, p: m.esr(t, p, n_norm=1000.0),
    "esr_emphasis": lambda m, t, p: m.esr(t, p, emphasis=lambda x: m.pre_emphasis(x, axis=1)),
    "esr_plain": lambda m, t, p: m.esr_plain(t, p),
    "esr_plain_emphasis": lambda m, t, p: m.esr_plain(t, p, emphasis=m.pre_emphasis),
    "avg_loss": lambda m, t, p: m.avg_loss(t, p),
    "bounds_loss": lambda m, t, p: m.bounds_loss(t, p),
    "mse_plus_esr": lambda m, t, p: m.mse_plus_esr(t, p),
    "mse_plus_esr_n_norm": lambda m, t, p: m.mse_plus_esr(t, p, n_norm=1000.0),
    "pre_emphasis_axis0": lambda m, t, p: m.pre_emphasis(t),
    "pre_emphasis_axis1": lambda m, t, p: m.pre_emphasis(p, coeff=0.5, axis=1),
    "global_loss_from_sums": lambda m, t, p: m.global_loss_from_sums(
        ((t - p) ** 2).sum(), (t ** 2).sum(), t.shape[0] * t.shape[1]),
    "dloss_dse": lambda m, t, p: m.dloss_dse(((t - p) ** 2).sum(), m.esr(t, p),
                                             t.shape[0] * t.shape[1]),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_losses_match_jax(name):
    t, p = _pair()
    want = LOSSES[name](jl, jnp.asarray(t), jnp.asarray(p))
    got = LOSSES[name](tl, torch.from_numpy(t), torch.from_numpy(p))
    want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
    # avg_loss is a difference of two means (~0.03 here): its rounding is a
    # few ulps of the means, not of the difference
    atol = 1e-7 if name == "avg_loss" else 0.0
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=atol)
    assert tl._EPS == jl._EPS == float(np.finfo(np.float32).eps)


def _streams(r_per_sample):
    rng = np.random.default_rng(1)
    n = len(r_per_sample)
    return {"x": rng.standard_normal(n).astype(np.float32),
            "r": np.asarray(r_per_sample, np.float32),
            "y": rng.standard_normal(n).astype(np.float32)}


BATCH_CASES = {
    # one R everywhere: hoisted to a per-chunk "r0"
    "constant_r": (_streams([45e3] * 70), {}),
    # a file boundary inside chunk 1: the per-sample "r" stream stays
    "mixed_r": (_streams([10e3] * 30 + [99e3] * 40), {}),
    # the same, for the fused engine: the straddling chunk goes, r0 stays
    "mixed_r_dropped": (_streams([10e3] * 30 + [99e3] * 40 + [25e3] * 20), {"drop_mixed_r": True}),
    "max_chunks": (_streams([10e3] * 30 + [99e3] * 40), {"max_chunks": 2, "drop_mixed_r": True}),
}


@pytest.mark.parametrize("case", sorted(BATCH_CASES))
def test_make_clipper_batches_matches_jax(case):
    data, kw = BATCH_CASES[case]
    want = jct.make_clipper_batches(data, 16, **kw)
    got = tct.make_clipper_batches(data, 16, **kw, device="cpu")
    assert sorted(got) == sorted(want)
    for k in want:
        assert isinstance(got[k], torch.Tensor) and got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    if case == "mixed_r_dropped":
        assert "r" not in got and got["r0"].tolist() == [10e3, 99e3, 99e3]  # 2 of 5 dropped


def _write_dataset(base, diode, r_kohms, n, write):
    """A diode_dataset-style tree of small seeded CSVs written by ``write``."""
    sub = tdi.data_path_for_diode(diode, base)
    sub.mkdir(parents=True)
    rng = np.random.default_rng(2)
    for rk in r_kohms:
        vin = rng.standard_normal(n).astype(np.float32)
        write(sub / f"{rk}k_4.7nF.csv", vin, np.tanh(vin).astype(np.float32), 48000.0)


@pytest.mark.parametrize("trim", [None, (0.001, 0.002)])
def test_reference_csv_round_trip_matches_jax_importer(tmp_path, trim):
    diode = tw.diode_1n4148_1u2d
    _write_dataset(tmp_path / "port", diode, (10.0, 45.2, 99.0), 300, tsyn.write_reference_csv)
    _write_dataset(tmp_path / "jax", diode, (10.0, 45.2, 99.0), 300, jsyn.write_reference_csv)
    kw = {"trim_pre_s": None} if trim is None else {"trim_pre_s": trim[0], "keep_s": trim[1]}
    sub = tdi.data_path_for_diode(diode, tmp_path / "port")
    for a, b in zip(sorted(sub.iterdir()),
                    sorted(jdi.data_path_for_diode(dwdf.diode_1n4148_1u2d, tmp_path / "jax").iterdir())):
        assert a.read_text() == b.read_text()
    want = jdi.load_diode_data(dwdf.diode_1n4148_1u2d, tmp_path / "port", **kw)
    got = tdi.load_diode_data(diode, tmp_path / "port", **kw)
    assert got[2] == want[2] == 48000.0
    for split_got, split_want in zip(got[:2], want[:2]):
        for k in ("x", "r", "y"):
            np.testing.assert_array_equal(split_got[k], split_want[k])
    n = len(got[1]["x"])  # 45.2k is the validation split, the others train
    assert len(got[0]["x"]) == 2 * n and n == (300 if trim is None else 96)
    assert tdi.r_from_filename(sub / "45.2k_4.7nF.csv") == 45200.0
    assert (tdi.TRIM_PRE_S, tdi.KEEP_S, tdi.VAL_R_LO_KOHM, tdi.VAL_R_HI_KOHM) == (
        jdi.TRIM_PRE_S, jdi.KEEP_S, jdi.VAL_R_LO_KOHM, jdi.VAL_R_HI_KOHM)
    batched = tdi.batch_sequences(got[0], 64)
    want_b = jdi.batch_sequences(want[0], 64)
    assert all(np.array_equal(batched[k], want_b[k]) for k in want_b)


@pytest.mark.parametrize("r_source", [10e3, 99e3])
def test_synth_clipper_measurement_matches_jax(r_source):
    d = tw.diode_1n4148_1u1d
    vin, vout = tsyn.synth_clipper_measurement(d, r_source, duration_s=0.02, seed=3,
                                               device="cpu")
    jvin, jvout = jsyn.synth_clipper_measurement(dwdf.diode_1n4148_1u1d, r_source,
                                                 duration_s=0.02, seed=3)
    assert vin.dtype == vout.dtype == np.float32 and vin.shape == vout.shape == (960,)
    np.testing.assert_array_equal(vin, jvin)
    np.testing.assert_allclose(vout, jvout, atol=5e-6, rtol=0)
    assert tfc.fused_clipper_analytic.launches == 0  # CPU: the plain version


def test_synth_hpf_measurement_matches_jax():
    d = tw.diode_1n4148_1u1d
    vin, vout = tsyn.synth_hpf_measurement(d, duration_s=0.005, seed=1, device="cpu")
    jvin, jvout = jsyn.synth_hpf_measurement(dwdf.diode_1n4148_1u1d, duration_s=0.005, seed=1)
    np.testing.assert_array_equal(vin, jvin)
    np.testing.assert_allclose(vout, jvout, atol=5e-6, rtol=0)


def test_pretraining_grid_matches_jax():
    d = tw.diode_1n4148_1u2d
    x, y = tsyn.pretraining_grid(d, n_r=5, n_a=101, device="cpu")
    jx, jy = jsyn.pretraining_grid(dwdf.diode_1n4148_1u2d, n_r=5, n_a=101)
    assert x.shape == (505, 2) and y.shape == (505,) and x.dtype == y.dtype == np.float32
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_allclose(y, jy, atol=5e-6, rtol=0)


def test_make_synthetic_dataset_dir_matches_jax(tmp_path):
    d = tw.diode_1n4148_1u1d
    kw = {"r_kohms": (10.0, 45.2), "duration_s": 0.01}
    paths = tsyn.make_synthetic_dataset_dir(tmp_path / "port", d, **kw, device="cpu")
    jpaths = jsyn.make_synthetic_dataset_dir(str(tmp_path / "jax"), dwdf.diode_1n4148_1u1d, **kw)
    rel = [str(p).split("port/", 1)[1] for p in paths]
    assert rel == [p.split("jax/", 1)[1] for p in jpaths] == [
        "1N4148/1up1down/10.0k_4.7nF.csv", "1N4148/1up1down/45.2k_4.7nF.csv"]
    got = tdi.load_diode_data(d, tmp_path / "port", trim_pre_s=None)
    want = jdi.load_diode_data(dwdf.diode_1n4148_1u1d, tmp_path / "jax", trim_pre_s=None)
    for split_got, split_want in zip(got[:2], want[:2]):
        np.testing.assert_array_equal(split_got["x"], split_want["x"])
        np.testing.assert_array_equal(split_got["r"], split_want["r"])
        np.testing.assert_allclose(split_got["y"], split_want["y"], atol=5e-6, rtol=0)


def _jax_params():
    root = dwdf.NeuralDiodeRoot(name="dp", n_layers=2, layer_size=4)
    ckt = jax_training_clipper(root, 48000.0)
    return jax.tree_util.tree_map(np.asarray, {**ckt.init_params(),
                                               **root.init_params(jax.random.PRNGKey(1))})


def test_checkpoint_round_trips_and_loads_in_jax(tmp_path):
    params = params_from_jax(_jax_params(), "cpu")
    leaves = [x for layer in params["dp"]["layers"] for x in layer.values()]
    for x in leaves:
        x.requires_grad_(True)
    opt = torch.optim.Adam(leaves, lr=1e-3, betas=(0.5, 0.999))
    sum((x ** 2).sum() for x in leaves).backward()
    opt.step()
    path = str(tmp_path / "step_3")
    tck.save_checkpoint(path, params, opt.state_dict(), step=3, extra={"note": "x"})
    tck.save_checkpoint(str(tmp_path / "step_12"), params, step=12)
    (tmp_path / "step_20").mkdir()  # an interrupted save: no meta.json
    assert tck.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_12")
    assert jck.latest_checkpoint(str(tmp_path)) == str(tmp_path / "step_12")

    template = params_from_jax(_jax_params(), "cpu")
    back, opt_state, step, extra = tck.restore_checkpoint(path, template, opt.state_dict())
    assert (step, extra) == (3, {"note": "x"})
    for a, b in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(params)):
        assert torch.equal(a, b.detach())
    resumed = torch.optim.Adam([x.detach().clone().requires_grad_(True) for x in leaves], lr=1.0)
    resumed.load_state_dict(opt_state)
    assert resumed.param_groups[0]["lr"] == 1e-3
    assert tuple(resumed.param_groups[0]["betas"]) == (0.5, 0.999)
    for i, s in opt.state_dict()["state"].items():
        for k, v in s.items():
            assert torch.equal(resumed.state_dict()["state"][i][k], v)
    assert tck.restore_checkpoint(str(tmp_path / "step_12"), template, opt.state_dict())[1] is None

    # params saved by the port load in the JAX package against a JAX template
    jparams, _, jstep, jextra = jck.restore_checkpoint(path, _jax_params())
    assert (jstep, jextra) == (3, {"note": "x"})
    for a, b in zip(jax.tree_util.tree_leaves(jparams), jax.tree_util.tree_leaves(back)):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    # and the other way: a JAX checkpoint's params load in the port
    jck.save_checkpoint(str(tmp_path / "jax_ckpt"), _jax_params(), step=5)
    from_jax, _, step, _ = tck.restore_checkpoint(str(tmp_path / "jax_ckpt"), template)
    assert step == 5
    for a, b in zip(jax.tree_util.tree_leaves(from_jax), jax.tree_util.tree_leaves(template)):
        assert torch.equal(a, b)


def test_checkpoint_overwrite_keeps_commit_marker_last(tmp_path):
    path = str(tmp_path / "step_1")
    params = {"w": torch.ones(3)}
    tck.save_checkpoint(path, params, step=1)
    tck.save_checkpoint(path, {"w": torch.full((3,), 2.0)}, step=2)
    back, _, step, _ = tck.restore_checkpoint(path, {"w": torch.zeros(3)})
    assert step == 2 and back["w"].tolist() == [2.0, 2.0, 2.0]
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_1"]


def test_metrics_logger_matches_jax(tmp_path):
    for mod, name in ((tmet, "port"), (jmet, "jax")):
        log = mod.MetricsLogger(str(tmp_path / name / "m.jsonl"))
        log.log(0, samples=4096, loss=1.5, esr=0.25)
        log.log(1, loss=torch.tensor(1.25), esr=0.125)
        log.close()
        hist = mod.load_jsonl(str(tmp_path / name / "m.jsonl"))
        assert hist["loss"] == [1.5, 1.25] and hist["step"] == [0.0, 1.0]
        assert log.history == {"loss": [1.5, 1.25], "esr": [0.25, 0.125]}
    recs = [json.loads(l) for l in (tmp_path / "port" / "m.jsonl").read_text().splitlines()]
    assert sorted(recs[0]) == ["esr", "loss", "samples_per_s", "step", "step_time_s"]
