"""diffwdf_tpu_torch's generic in-circuit training vs the JAX package.

``train_clipper(engine="fused_generic")``, ``joint_fit_clipper``,
``fit_components`` and ``synth_ts_measurement`` of
``diffwdf_tpu_torch.training.circuit_train`` / ``data.synthetic`` against the
JAX functions of the same names on the same numpy data, on the CPU (the
engine's plain versions; the generated kernels run on a card).  The JAX
engine runs its Pallas kernels in interpret mode.

Budgets: training loss history rtol 5e-4 (tests/test_parallel_bptt.py:578,
tests/test_clipper_train.py:186); the joint fit must move C toward its true
4.7 nF (tests/test_parallel_bptt.py:455-457); component fitting as
tests/test_training.py:45,84 asserts it, and its history within rtol 1e-3 of
JAX's (a 150-epoch Adam run at lr 25 Ohm carries the two frameworks'
rounding; the loss also within 1e-5 of its first value, absolute, where it
has fallen to ~1e-8 of it); the synthetic Tube Screamer measurement within
2e-5 of JAX's scan (the generic kernel's forward budget).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal as sig
import torch

import diffwdf_tpu as dwdf
from diffwdf_tpu.data.synthetic import synth_ts_measurement as jax_synth_ts
from diffwdf_tpu.models import diode_clipper as jdc
from diffwdf_tpu.roots.neural import NeuralDiodeRoot as JaxNeuralDiodeRoot
from diffwdf_tpu.training import circuit_train as jct
from diffwdf_tpu_torch.data.synthetic import synth_ts_measurement
from diffwdf_tpu_torch.models import diode_clipper as tdc
from diffwdf_tpu_torch.models import simple_circuits as tsc
from diffwdf_tpu_torch.nn.convert import params_from_jax
from diffwdf_tpu_torch.ops import fused_circuit as tfc
from diffwdf_tpu_torch.ops import parallel_bptt as pb
from diffwdf_tpu_torch.roots.diode import diode_1n4148_1u1d
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.training import circuit_train as tct

FS = 48000.0


def _t(x):
    return torch.from_numpy(np.array(x))


def _only_root(grads):
    zeros = jax.tree_util.tree_map(jnp.zeros_like, grads)
    zeros["dp"] = grads["dp"]
    return zeros


def _mixed_r():
    """tests/test_parallel_bptt.py:553-568: six chunks of 128, the source R
    jumping from 45k to 62k in the middle of a chunk (two files), so that
    chunk keeps its per-sample R stream."""
    rng = np.random.default_rng(37)
    t_chunk, n = 128, 6
    x = (0.8 * rng.standard_normal(n * t_chunk)).astype(np.float32)
    r = np.full(n * t_chunk, 45e3, np.float32)
    r[n * t_chunk // 2 + t_chunk // 2:] = 62e3
    data = {"x": x, "r": r, "y": np.tanh(x).astype(np.float32)}
    root = JaxNeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    ckt = jdc.make_training_clipper(root, FS)
    params = jax.tree_util.tree_map(np.asarray, {
        **ckt.init_params(), **root.init_params(jax.random.PRNGKey(2))})
    return data, t_chunk, root, ckt, params


@pytest.fixture(scope="module")
def jax_mixed_history():
    """JAX's fused_generic engine on the mixed-R chunks, training the root
    (training every leaf at lr 3e-3 steps C by 3e-3 F and gives NaN in
    both packages from the second epoch)."""
    data, t_chunk, _, ckt, params = _mixed_r()
    batches = jct.make_clipper_batches(data, t_chunk)
    assert "r" in batches  # mixed: the per-sample stream stays
    cfg = jct.CircuitTrainConfig(epochs=4, batch_size=t_chunk, learning_rate=3e-3,
                                 skip_samples=8, engine="fused_generic")
    _, hist = jct.train_clipper(ckt, jax.tree_util.tree_map(jnp.asarray, params), batches,
                                cfg=cfg, trainable_filter=_only_root)
    return hist["loss"]


@pytest.mark.parametrize("engine", ["fused_generic", "scan"])
def test_train_clipper_mixed_r_history_matches_jax(engine, jax_mixed_history):
    data, t_chunk, _, _, params = _mixed_r()
    batches = tct.make_clipper_batches(data, t_chunk, device="cpu")
    assert "r" in batches and tuple(batches["r"].shape) == (6, t_chunk)
    ckt = tdc.make_training_clipper(NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4), FS)
    cfg = tct.CircuitTrainConfig(epochs=4, batch_size=t_chunk, learning_rate=3e-3,
                                 skip_samples=8, engine=engine)
    pb.fused_backward.launches = tfc.fused_circuit_process.launches = 0
    _, hist = tct.train_clipper(ckt, params_from_jax(params, "cpu"), batches, cfg=cfg,
                                trainable_filter=lambda p: p["dp"])
    assert np.isfinite(jax_mixed_history).all()
    np.testing.assert_allclose(hist["loss"], jax_mixed_history, rtol=5e-4)
    assert hist["loss"][-1] < hist["loss"][0]
    assert pb.fused_backward.launches == tfc.fused_circuit_process.launches == 0


def _joint_fit_data():
    """tests/test_parallel_bptt.py:428-450: eight rows of 64 samples of the
    analytic training clipper, one pot R per row, targets from JAX's scan."""
    rng = np.random.default_rng(31)
    n_seq, t_seq = 8, 64
    aroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt_a = jdc.make_training_clipper(aroot, FS)
    pa = {**ckt_a.init_params(), **aroot.init_params()}
    x = (0.9 * rng.standard_normal((n_seq, t_seq))).astype(np.float32)
    r0 = np.exp(rng.uniform(np.log(36e3), np.log(73e3), n_seq)).astype(np.float32)
    state0 = ckt_a.init_state()
    y = jax.vmap(lambda v, r: ckt_a.process(pa, state0, {"Vs": {"v": v}},
                                            static_controls={"Vs": {"R": r}})[0])(x, r0)
    nroot = JaxNeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    params = jax.tree_util.tree_map(np.asarray, {
        **jdc.make_training_clipper(nroot, FS).init_params(), **nroot.init_params()})
    params["C"]["C"] = np.float32(6.5e-9)  # perturbed: the fit must pull it back
    return {"x": x, "y": np.asarray(y), "r0": r0}, params, t_seq


def test_joint_fit_moves_c_toward_truth_as_jax():
    batches, params, t_seq = _joint_fit_data()
    kw = dict(component_lrs={"C.C": 2e-10}, mlp_lr=3e-3)
    cfg = tct.CircuitTrainConfig(epochs=12, batch_size=t_seq, skip_samples=4,
                                 engine="fused_generic")
    ckt = tdc.make_training_clipper(NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4), FS)
    tparams = params_from_jax(params, "cpu")
    p2, hist = tct.joint_fit_clipper(ckt, tparams, {k: _t(v) for k, v in batches.items()},
                                     cfg=cfg, **kw)
    assert hist["loss"][-1] < hist["loss"][0]
    assert abs(float(p2["C"]["C"]) - 4.7e-9) < abs(6.5e-9 - 4.7e-9)
    assert len(hist["C.C"]) == 12 and hist["C.C"][-1] == float(p2["C"]["C"])
    # frozen leaves get no step; the caller's params are untouched
    assert torch.equal(p2["Vs"]["R"], tparams["Vs"]["R"])
    assert float(tparams["C"]["C"]) == np.float32(6.5e-9)
    # the JAX joint fit, on its scan engine (held to its fused_generic engine
    # by the JAX suite), on the same data
    jroot = JaxNeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
    jcfg = jct.CircuitTrainConfig(epochs=12, batch_size=t_seq, skip_samples=4, engine="scan")
    _, jhist = jct.joint_fit_clipper(
        jdc.make_training_clipper(jroot, FS), jax.tree_util.tree_map(jnp.asarray, params),
        {k: jnp.asarray(v) for k, v in batches.items()}, cfg=jcfg, **kw)
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=5e-4)
    np.testing.assert_allclose(hist["C.C"], jhist["C.C"], rtol=1e-5)
    with pytest.raises(ValueError, match="engine"):
        tct.joint_fit_clipper(ckt, tparams, {k: _t(v) for k, v in batches.items()},
                              cfg=tct.CircuitTrainConfig(engine="fused"), **kw)


def _divider_case(pkg):
    if pkg == "jax":
        R1, R2 = dwdf.Resistor("R1", 2.0e3, trainable=True), dwdf.Resistor("R2", 100.0,
                                                                          trainable=True)
        return dwdf.Circuit(tree=dwdf.Inverter("I1", dwdf.Series("S1", R1, R2)),
                            root=dwdf.IdealVoltageSourceRoot("Vs"), fs=FS, outputs=("R1",))
    return tsc.make_voltage_divider(FS)


def _fit_case(name):
    """(JAX circuit, port circuit, input, target, learning rates, epochs):
    tests/test_training.py:30-52 and :55-92."""
    if name == "divider":
        n = np.arange(256)
        vin = np.sin(2 * np.pi * 100 * n / FS).astype(np.float32)
        return (_divider_case("jax"), _divider_case("torch"), vin, 0.5 * vin,
                {"R1.R": 25.0, "R2.R": 25.0}, 150)
    R1, C1 = dwdf.Resistor("R1", 1000.0, trainable=True), dwdf.Capacitor("C1", 1.0e-6,
                                                                        trainable=True)
    jckt = dwdf.Circuit(tree=dwdf.Inverter("I1", dwdf.Series("S1", R1, C1)),
                        root=dwdf.IdealVoltageSourceRoot("Vs"), fs=FS, outputs=("C1",))
    t = np.arange(1280) / FS
    k = 1280 / FS / np.log(100.0)
    sweep = np.sin(2 * np.pi * 100.0 * k * (np.exp(t / k) - 1.0)).astype(np.float32)
    b, a = sig.bilinear([1.0], [1.0 / (2 * np.pi * 720.0), 1.0], fs=FS)
    target = sig.lfilter(b, a, sweep).astype(np.float32)
    return (jckt, tsc.make_rc_lowpass(FS), sweep, target, {"R1.R": 25.0, "C1.C": 10.0e-9}, 100)


@pytest.mark.parametrize("name", ["divider", "rc"])
def test_fit_components_matches_jax(name):
    jckt, tckt, vin, target, lrs, epochs = _fit_case(name)
    jp, jhist = jct.fit_components(jckt, jckt.init_params(), {"Vs": {"v": jnp.asarray(vin)}},
                                   jnp.asarray(target), lr_by_param=lrs, epochs=epochs)
    params = tckt.init_params("cpu")
    tp, hist = tct.fit_components(tckt, params, {"Vs": {"v": _t(vin)}}, _t(target),
                                  lr_by_param=lrs, epochs=epochs)
    assert hist["loss"][-1] < hist["loss"][0]
    # near the optimum the loss is ~1e-8 of its start: absolute there
    np.testing.assert_allclose(hist["loss"], jhist["loss"], rtol=1e-3,
                               atol=1e-5 * jhist["loss"][0])
    for key in lrs:
        node, field = key.split(".")
        np.testing.assert_allclose([h[node][field] for h in hist["params"]],
                                   [h[node][field] for h in jhist["params"]], rtol=1e-3)
    assert not params["R1"]["R"].requires_grad and float(params["R1"]["R"]) in (1000.0, 2000.0)
    if name == "divider":
        ratio = float(tp["R1"]["R"] / (tp["R1"]["R"] + tp["R2"]["R"]))
        assert abs(ratio - 0.5) < 0.02, ratio
        assert hist["loss"][-1] < hist["loss"][0] * 0.05
    else:
        f_learned = 1.0 / (2 * np.pi * float(tp["R1"]["R"]) * float(tp["C1"]["C"]))
        assert abs(f_learned - 720.0) / 720.0 < 0.25, f_learned


def test_synth_ts_measurement_matches_jax():
    """0.05 s of the synthetic Tube Screamer measurement: the same stimulus,
    and the generic kernel's plain version against JAX's scan."""
    d = dwdf.diode_1n4148_1u1d
    jv, jy = jax_synth_ts(d, 0.5, FS, duration_s=0.05, seed=7)
    tfc.fused_circuit_process.launches = 0
    v, y = synth_ts_measurement(diode_1n4148_1u1d, 0.5, FS, duration_s=0.05, seed=7,
                                device="cpu")
    assert tfc.fused_circuit_process.launches == 0
    np.testing.assert_array_equal(v, jv)
    assert v.dtype == y.dtype == np.float32 and y.shape == (2400,)
    np.testing.assert_allclose(y, jy, atol=2e-5, rtol=0)
    assert float(np.abs(y).max()) > 0.3  # the stage amplifies the 0.1 V input
