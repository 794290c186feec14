"""diffwdf_tpu_torch R-type adaptor and Tube Screamer vs the JAX package and
closed forms.

- The float64 host bake (``bake_static_scatter``, numpy) equals JAX's to
  1e-12, the f64 ``scattering_matrix`` and ``adapted_resistance`` too.
- The in-graph f32 torch derivation stays within the JAX suite's 2e-3 of
  the f64 bake (``tests/test_rtype.py:157-158``).
- The suite's closed-form checks (``tests/test_rtype.py:34-110``): series
  and parallel junctions against the textbook formulas, the Tube Screamer's
  adapted resistance and first scattering row against the reference's
  R-Solver closed form (``TubeScreamer.h:53-60``).
- The Tube Screamer itself: it clips, the drive pot moves its gain, and the
  in-graph derivation serves what the baked one does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffwdf_tpu.core import rtype as jrt
from diffwdf_tpu.models import tube_screamer as jts
from diffwdf_tpu_torch.core import rtype as trt
from diffwdf_tpu_torch.models import tube_screamer as tts
from diffwdf_tpu_torch.roots.diode import DiodePairRoot, diode_1n4148_1u1d

FS = 48000.0


def _ts_children(fs=FS):
    rb = 1.0 / (1.0 / (1.0 + 1.0 / (2.0 * 1.0e-6 * fs)) + 1.0 / 10.0e3)
    rc = 4.7e3 + 1.0 / (2.0 * 0.047e-6 * fs)
    return [rb, rc, 1.0e6]


def test_netlist_stamps_match_jax():
    for tnet, jnet in ((tts.tube_screamer_netlist(), jts.tube_screamer_netlist()),
                       (tts.tube_screamer_netlist(7.0, 1e4, 10.0),
                        jts.tube_screamer_netlist(7.0, 1e4, 10.0))):
        assert tnet.ports == jnet.ports and tnet.resistors == jnet.resistors
        for a, b in zip(trt._internal_mna(tnet), jrt._internal_mna(jnet)):
            np.testing.assert_array_equal(a, b)
    # the negated Ro of the reference's closed form
    assert (3, 4, -tts.OPAMP_ROUT) in tts.tube_screamer_netlist().resistors


@pytest.mark.parametrize("fs", [48000.0, 96000.0])
def test_bake_matches_jax(fs):
    net = tts.tube_screamer_netlist()
    child = _ts_children(fs)
    S, ra = trt.bake_static_scatter(net, child)
    jS, jra = jrt.bake_static_scatter(jts.tube_screamer_netlist(), child)
    assert S.dtype == torch.float32 and S.shape == (4, 4) and ra.shape == ()
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), atol=1e-12, rtol=0)
    np.testing.assert_allclose(float(ra), float(jra), atol=1e-12, rtol=0)
    # and the float64 derivation before the rounding
    ra64 = trt.adapted_resistance(net, np.asarray(child), xp=np)
    jra64 = jrt.adapted_resistance(net, np.asarray(child), xp=np)
    np.testing.assert_allclose(ra64, jra64, atol=1e-12, rtol=0)
    r_all = np.concatenate([[ra64], child])
    np.testing.assert_allclose(trt.scattering_matrix(net, r_all, xp=np),
                               jrt.scattering_matrix(net, r_all, xp=np), atol=1e-12, rtol=0)


def test_f32_derivation_close_to_f64():
    """The in-graph (f32 torch) derivation stays close to the f64 host bake
    at the Tube Screamer operating point (the JAX suite's 2e-3)."""
    net = tts.tube_screamer_netlist()
    rb, rc, rd = _ts_children()
    S64, ra64 = trt.bake_static_scatter(net, [rb, rc, rd])
    s_fn = trt.make_netlist_scatter_fn(net)
    S32, ra32 = s_fn([torch.tensor(r, dtype=torch.float32) for r in (rb, rc, rd)])
    assert S32.dtype == torch.float32
    np.testing.assert_allclose(float(ra32), float(ra64), rtol=2e-3)
    np.testing.assert_allclose(S32.numpy(), S64.numpy(), atol=2e-3)
    # in f64 the torch derivation is the numpy bake's
    S_d, ra_d = s_fn([torch.tensor(r, dtype=torch.float64) for r in (rb, rc, rd)])
    ra_np = trt.adapted_resistance(net, np.asarray([rb, rc, rd]), xp=np)
    np.testing.assert_allclose(float(ra_d), ra_np, rtol=1e-9)
    np.testing.assert_allclose(
        S_d.numpy(), trt.scattering_matrix(net, np.asarray([ra_np, rb, rc, rd]), xp=np),
        rtol=1e-7, atol=1e-9)


@pytest.mark.parametrize("xp", [np, torch], ids=["numpy", "torch"])
def test_series_junction_matches_classic_formula(xp):
    """Three ports in a series loop: b_i = a_i - 2 R_i / sum(R) * sum(a)."""
    net = trt.Netlist(n_nodes=2, resistors=(), vcvs=(), ports=((1, 0), (2, 1), (0, 2)))
    rng = np.random.default_rng(0)
    for _ in range(5):
        R = rng.uniform(10.0, 1e5, size=3)
        S = trt.scattering_matrix(net, R if xp is np else torch.from_numpy(R), xp=xp)
        want = np.eye(3) - 2.0 * np.outer(R, np.ones(3)) / np.sum(R)
        np.testing.assert_allclose(np.asarray(S), want, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize("xp", [np, torch], ids=["numpy", "torch"])
def test_parallel_junction_matches_classic_formula(xp):
    """Three ports across one node pair: b_i = 2 (sum g_j a_j)/sum(g) - a_i."""
    net = trt.Netlist(n_nodes=1, resistors=(), vcvs=(), ports=((1, 0), (1, 0), (1, 0)))
    rng = np.random.default_rng(1)
    for _ in range(5):
        R = rng.uniform(10.0, 1e5, size=3)
        g = 1.0 / R
        S = trt.scattering_matrix(net, R if xp is np else torch.from_numpy(R), xp=xp)
        want = 2.0 * np.outer(np.ones(3), g) / np.sum(g) - np.eye(3)
        np.testing.assert_allclose(np.asarray(S), want, rtol=1e-9, atol=1e-12)


def _ref_first_row_and_ra(Rb, Rc, Rd, Ag=tts.OPAMP_GAIN, Ri=tts.OPAMP_RIN, Ro=tts.OPAMP_ROUT):
    """Reference closed form: S[0, 1:4] and Ra (``TubeScreamer.h:53-60``)."""
    den = (Rb + Rc) * Rd + Rd * Ri - (Rb + Rc + Ri) * Ro
    s01 = (Ag * Rd * Ri - Rc * Rd + Rc * Ro) / den
    s02 = -((Ag + 1) * Rd * Ri + Rb * Rd - (Rb + Ri) * Ro) / den
    s03 = -Ro / (Rd - Ro)
    ra = ((Ag + 1) * Rc * Rd * Ri + Rb * Rc * Rd
          - (Rb * Rc + (Rb + Rc) * Rd + (Rc + Rd) * Ri) * Ro) / den
    return np.array([s01, s02, s03]), ra


def test_adapted_resistance_matches_reference_closed_form():
    rng = np.random.default_rng(0)
    net = tts.tube_screamer_netlist()
    for _ in range(10):
        Rb, Rc, Rd = rng.uniform(100.0, 1e6, size=3)
        _, ra_ref = _ref_first_row_and_ra(Rb, Rc, Rd)
        ra = trt.adapted_resistance(net, np.array([Rb, Rc, Rd]), xp=np)
        np.testing.assert_allclose(float(ra), ra_ref, rtol=1e-8)


def test_first_scatter_row_matches_reference_closed_form():
    rng = np.random.default_rng(1)
    net = tts.tube_screamer_netlist()
    for _ in range(10):
        Rb, Rc, Rd = rng.uniform(100.0, 1e6, size=3)
        row_ref, ra_ref = _ref_first_row_and_ra(Rb, Rc, Rd)
        S = trt.scattering_matrix(net, np.array([ra_ref, Rb, Rc, Rd]), xp=np)
        assert abs(S[0, 0]) < 1e-7  # adapted
        np.testing.assert_allclose(np.asarray(S[0, 1:]), row_ref, rtol=1e-7)


def test_rtype_needs_exactly_one_scatter_source():
    net = tts.tube_screamer_netlist()
    with pytest.raises(ValueError, match="exactly one"):
        trt.RTypeAdaptor("R", ports=(), s_fn=None, static_s=None)
    with pytest.raises(ValueError, match="exactly one"):
        trt.RTypeAdaptor("R", ports=(), s_fn=trt.make_netlist_scatter_fn(net),
                         static_s=trt.bake_static_scatter(net, _ts_children()))


def _ts_run(drive, vin, static_s=True, dtype=torch.float32):
    root = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)
    ckt = tts.make_tube_screamer(root, FS, drive=drive, static_s=static_s)
    params = {**ckt.init_params("cpu"), **root.init_params("cpu")}
    params = {k: {f: v.to(dtype) for f, v in d.items()} for k, d in params.items()}
    state = {k: {f: v.to(dtype) for f, v in d.items()} for k, d in ckt.init_state("cpu").items()}
    out, _ = ckt.process(params, state, {"Vin": {"v": torch.as_tensor(vin, dtype=dtype)}})
    return out.numpy()


def test_tube_screamer_runs_and_clips():
    """The op-amp stage drives the diodes: finite, clamped around a volt,
    and distorted relative to the linear gain."""
    n = np.arange(2048)
    vin = (0.5 * np.sin(2 * np.pi * 220.0 * n / FS)).astype(np.float32)
    out = _ts_run(1.0, vin)
    assert np.all(np.isfinite(out))
    peak = np.max(np.abs(out[200:]))
    assert 0.3 < peak < 3.0, peak
    lin = vin * (peak / 0.5)
    resid = np.mean((out[200:] - lin[200:]) ** 2) / np.mean(out[200:] ** 2)
    assert resid > 1e-3


def test_drive_pot_changes_gain():
    n = np.arange(1024)
    vin = (0.02 * np.sin(2 * np.pi * 440.0 * n / FS)).astype(np.float32)
    peaks = [float(np.max(np.abs(_ts_run(d, vin)[500:]))) for d in (0.0, 1.0)]
    assert peaks[1] > peaks[0] * 2.0, peaks
    assert tts.drive_to_r6(0.5) == tts.R6_OHMS + 0.5 * tts.POT1_OHMS


def test_in_graph_derivation_serves_the_baked_circuit():
    """static_s=False derives S in the adaptation pass; in f64 it serves the
    baked circuit's output (whose S is the f64 bake rounded to f32)."""
    n = np.arange(512)
    vin = (0.2 * np.sin(2 * np.pi * 1000.0 * n / FS)).astype(np.float32)
    baked = _ts_run(0.5, vin)
    derived = _ts_run(0.5, vin, static_s=False, dtype=torch.float64)
    np.testing.assert_allclose(derived, baked, atol=1e-4)


def test_tube_screamer_matches_jax_process():
    """The port's Tube Screamer (baked S) against the JAX package's scan."""
    import diffwdf_tpu as dwdf

    n = np.arange(512)
    vin = (0.2 * np.sin(2 * np.pi * 1000.0 * n / FS)
           + 0.05 * np.random.default_rng(4).standard_normal(512)).astype(np.float32)
    jroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    jckt = jts.make_tube_screamer(jroot, FS, drive=0.5)
    jout, _ = jckt.process({**jckt.init_params(), **jroot.init_params()}, jckt.init_state(),
                           {"Vin": {"v": jnp.asarray(vin)}})
    np.testing.assert_allclose(_ts_run(0.5, vin), np.asarray(jout), atol=2e-5)
