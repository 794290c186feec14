"""diffwdf_tpu_torch core (elements, adaptors, Circuit) vs the JAX package.

The same seeded numpy inputs and the same weights go through JAX's
``Circuit.process`` (``lax.scan``, vmapped over the batch) and the port's
(a Python loop over time, batch as a trailing dimension).  Budget: atol 1e-6
on outputs and final state, the two being the same f32 arithmetic in the same
order up to the transcendental library calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
import diffwdf_tpu_torch as tw
from diffwdf_tpu.models import diode_clipper as jdc
from diffwdf_tpu_torch.models import diode_clipper as tdc
from diffwdf_tpu_torch.nn.convert import params_from_jax

FS = 96000.0
B, T = 8, 96


def _divider(pkg):
    s1 = pkg.Series("S1", pkg.Resistor("R1", 2.0e3), pkg.Resistor("R2", 100.0))
    return pkg.Circuit(tree=pkg.Inverter("I1", s1), root=pkg.IdealVoltageSourceRoot("Vs"),
                       fs=48000.0, outputs=("R1",))


def _rc_lowpass(pkg):
    s1 = pkg.Series("S1", pkg.Resistor("R1", 1.0e3, trainable=True),
                    pkg.Capacitor("C1", 1.0e-6, trainable=True))
    return pkg.Circuit(tree=pkg.Inverter("I1", s1), root=pkg.IdealVoltageSourceRoot("Vs"),
                       fs=48000.0, outputs=("C1", "R1"))


def _rl_highpass(pkg):
    s1 = pkg.Series("S1", pkg.Inductor("L1", 0.1), pkg.Resistor("R1", 1.0e3))
    return pkg.Circuit(tree=pkg.Inverter("I1", s1), root=pkg.IdealVoltageSourceRoot("Vs"),
                       fs=48000.0, outputs=("R1",))


def _current_source_rc(pkg):
    p1 = pkg.Parallel("P1", pkg.ResistiveCurrentSource("Is", 1.0e3),
                      pkg.Capacitor("C1", 1.0e-7))
    return pkg.Circuit(tree=p1, root=pkg.OpenCircuitRoot(), fs=48000.0, outputs=("C1",))


def _clipper(pkg, make, diode="diode_1n4148_1u2d"):
    root = pkg.DiodePairRoot(name="dp", diode=getattr(pkg, diode), quality="best")
    return make(root, FS)


def _jax_neural_clipper(make):
    root = dwdf.NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    return make(root, FS), root.init_params(jax.random.PRNGKey(3))


# The two highpass topologies keep a pole near DC, which carries each f32
# rounding difference (XLA and PyTorch round transcendentals and fused
# expressions differently) forward instead of damping it.  They are driven
# at 0.5 V, where that drift stays inside the 1e-6 budget over T samples;
# at 2 V both packages sit ~1e-5 from the f64 oracle, which
# test_hpf_clipper_full_drive_matches_f64_oracle holds separately.
CIRCUITS = {
    # name: (JAX circuit factory, port circuit factory, driven field, amplitude)
    "divider": (lambda: _divider(dwdf), lambda: _divider(tw), ("Vs", "v"), 1.0),
    "rc_lowpass": (lambda: _rc_lowpass(dwdf), lambda: _rc_lowpass(tw), ("Vs", "v"), 1.0),
    "rl_highpass": (lambda: _rl_highpass(dwdf), lambda: _rl_highpass(tw), ("Vs", "v"), 0.5),
    "current_source_rc": (lambda: _current_source_rc(dwdf), lambda: _current_source_rc(tw),
                          ("Is", "i"), 1.0e-3),
    "lpf_clipper": (lambda: _clipper(dwdf, jdc.make_diode_clipper),
                    lambda: _clipper(tw, tdc.make_diode_clipper), ("Vs", "v"), 2.0),
    "hpf_clipper": (lambda: _clipper(dwdf, jdc.make_hpf_diode_clipper, "diode_1n4148_1u1d"),
                    lambda: _clipper(tw, tdc.make_hpf_diode_clipper, "diode_1n4148_1u1d"),
                    ("Vs", "v"), 0.5),
}


def _run_both(jckt, tckt, jparams, inputs_np, **kw):
    """inputs_np: {node: {field: (B, T) array}} -> both packages' (B, T, ...)
    outputs and final states, as numpy."""
    jstate = jckt.init_state()

    def one(inp):
        return jckt.process(jparams, jstate, inp, **kw)

    j_in = jax.tree_util.tree_map(jnp.asarray, inputs_np)
    j_out, j_state = jax.vmap(one)(j_in)

    tparams = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    t_in = {n: {f: torch.from_numpy(np.ascontiguousarray(x.T)) for f, x in fs.items()}
            for n, fs in inputs_np.items()}
    t_out, t_state = tckt.process(tparams, tckt.init_state("cpu"), t_in, **kw)
    t_out = np.moveaxis(t_out.numpy(), 0, 1)  # (T, B, ...) -> (B, T, ...)
    return np.asarray(j_out), j_state, t_out, t_state


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_process_matches_jax(name):
    jmake, tmake, (node, field), amp = CIRCUITS[name]
    jckt, tckt = jmake(), tmake()
    jparams = jckt.init_params()
    x = (amp * np.random.default_rng(0).standard_normal((B, T))).astype(np.float32)
    j_out, j_state, t_out, t_state = _run_both(jckt, tckt, jparams, {node: {field: x}})
    assert t_out.shape == j_out.shape
    np.testing.assert_allclose(t_out, j_out, atol=1e-6, rtol=0)
    assert sorted(t_state) == sorted(j_state)
    for k in j_state:
        for f in j_state[k]:
            np.testing.assert_allclose(t_state[k][f].numpy(), np.asarray(j_state[k][f]),
                                       atol=1e-6, rtol=0)


def test_neural_lpf_clipper_process_matches_jax():
    jckt, jroot_params = _jax_neural_clipper(jdc.make_diode_clipper)
    tckt = tdc.make_diode_clipper(tw.NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16), FS)
    jparams = {**jckt.init_params(), **jroot_params}
    x = (2.0 * np.random.default_rng(1).standard_normal((B, T))).astype(np.float32)
    j_out, _, t_out, t_state = _run_both(jckt, tckt, jparams, {"Vs": {"v": x}})
    np.testing.assert_allclose(t_out, j_out, atol=1e-6, rtol=0)


def test_pot_sweep_adapts_per_sample_like_jax():
    """A per-sample source R (the training pot) re-adapts every sample."""
    jckt = _clipper(dwdf, jdc.make_training_clipper)
    tckt = _clipper(tw, tdc.make_training_clipper)
    rng = np.random.default_rng(2)
    v = (1.5 * rng.standard_normal((B, T))).astype(np.float32)
    r = rng.uniform(5.0e3, 45.0e3, (B, T)).astype(np.float32)
    inputs = {"Vs": {"v": v, "R": r}}
    assert tckt.needs_per_sample_adapt(inputs) and jckt.needs_per_sample_adapt(inputs)
    j_out, _, t_out, _ = _run_both(jckt, tckt, jckt.init_params(), inputs)
    np.testing.assert_allclose(t_out, j_out, atol=1e-6, rtol=0)


def test_static_controls_match_jax():
    """Block-rate source R held for the call (the cutoff knob)."""
    jckt = _clipper(dwdf, jdc.make_diode_clipper)
    tckt = _clipper(tw, tdc.make_diode_clipper)
    r = tdc.cutoff_to_resistance(2000.0, 2.2e-9)
    assert r == jdc.cutoff_to_resistance(2000.0, 2.2e-9)
    x = (2.0 * np.random.default_rng(3).standard_normal((B, T))).astype(np.float32)
    jstate = jckt.init_state()
    j_out = jax.vmap(lambda v: jckt.process(
        jckt.init_params(), jstate, {"Vs": {"v": v}},
        static_controls={"Vs": {"R": jnp.float32(r)}})[0])(jnp.asarray(x))
    t_out, _ = tckt.process(tckt.init_params("cpu"), tckt.init_state("cpu"),
                            {"Vs": {"v": torch.from_numpy(x.T.copy())}},
                            static_controls={"Vs": {"R": torch.tensor(r, dtype=torch.float32)}})
    np.testing.assert_allclose(t_out.numpy().T, np.asarray(j_out), atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", sorted(CIRCUITS))
def test_init_params_state_and_constraints_match_jax(name):
    jmake, tmake, _, _ = CIRCUITS[name]
    jckt, tckt = jmake(), tmake()
    jp, tp = jckt.init_params(), tckt.init_params("cpu")
    assert sorted(jp) == sorted(tp)
    for k in jp:
        assert sorted(jp[k]) == sorted(tp[k])
        for f in jp[k]:
            assert tp[k][f].dtype == torch.float32
            np.testing.assert_array_equal(tp[k][f].numpy(), np.asarray(jp[k][f]))
    assert jckt.param_constraints() == tckt.param_constraints()
    js, ts = jckt.init_state(), tckt.init_state("cpu")
    assert sorted(js) == sorted(ts)
    # constrain clips out-of-range values exactly as JAX does
    wild = {k: {f: v * 1.0e9 for f, v in fs.items()} for k, fs in jp.items()}
    jc = jckt.constrain(wild)
    tc = tckt.constrain(params_from_jax(jax.tree_util.tree_map(np.asarray, wild), "cpu"))
    for k in jc:
        for f in jc[k]:
            np.testing.assert_allclose(tc[k][f].numpy(), np.asarray(jc[k][f]), rtol=1e-7)


def test_voltage_and_current_probes_match_jax():
    jckt, tckt = _rc_lowpass(dwdf), _rc_lowpass(tw)
    jp = jckt.init_params()
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jco, tco = jckt.adapt(jp), tckt.adapt(tp)
    v = np.float32(0.7)
    jstate, jw = jckt.step(jp, jco, jckt.init_state(), {"Vs": {"v": jnp.float32(v)}})
    tstate, tw_ = tckt.step(tp, tco, tckt.init_state("cpu"), {"Vs": {"v": torch.tensor(v)}})
    for n in ("C1", "R1"):
        np.testing.assert_allclose(tw.voltage(tw_, n).numpy(), np.asarray(dwdf.voltage(jw, n)),
                                   atol=1e-7)
        np.testing.assert_allclose(tw.current(tw_, tco, n).numpy(),
                                   np.asarray(dwdf.current(jw, jco, n)), rtol=1e-6)


def test_hpf_clipper_full_drive_matches_f64_oracle():
    """At 2 V the HPF clipper's f32 result drifts ~1e-5 from the f64 truth in
    both packages; the port's f32 run must stay as close to the truth (the
    port itself run in f64) as a bound JAX's own f32 run also meets."""
    jckt = _clipper(dwdf, jdc.make_hpf_diode_clipper, "diode_1n4148_1u1d")
    tckt = _clipper(tw, tdc.make_hpf_diode_clipper, "diode_1n4148_1u1d")
    x = (2.0 * np.random.default_rng(0).standard_normal((B, T))).astype(np.float32)
    j_out, _, t_out, _ = _run_both(jckt, tckt, jckt.init_params(), {"Vs": {"v": x}})
    p64 = {k: {f: v.double() for f, v in fs.items()} for k, fs in tckt.init_params("cpu").items()}
    s64 = {k: {f: v.double() for f, v in fs.items()} for k, fs in tckt.init_state("cpu").items()}
    truth, _ = tckt.process(p64, s64, {"Vs": {"v": torch.from_numpy(x.T.astype(np.float64))}})
    truth = truth.numpy().T
    for got in (j_out, t_out):
        np.testing.assert_allclose(got, truth, atol=5e-5, rtol=0)
