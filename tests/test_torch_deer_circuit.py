"""diffwdf_tpu_torch.ops.deer_circuit (the generic single-stream DEER solve)
against the JAX package, on the CPU.

On a CPU tensor ``fused_deer_circuit`` / ``fused_deer_neural`` run their
plain version: the same algorithm in torch ops.  Each case holds it against
the JAX Pallas kernel in interpret mode (as the JAX package's own tests run
it off the TPU) on the same numpy input, and both against the JAX sequential
scan (``Circuit.process``) at the JAX suite's budgets
(tests/test_deer_circuit.py): the Tube Screamer 1e-4, the LPF clipper 1e-6,
the damped HPF 3e-4 with the undamped error over 100x the damped one, the
drive pot 1e-4, the neural roots 5e-6 with a residual below 1e-5.  With
``adapt_tol`` the sweeps run equal the JAX kernel's, granularity included.
No CPU tensor reaches the kernel: both launch counters stay 0.  The kernel
itself is held against the plain version on a card by chip_smoke.py.
"""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
from diffwdf_tpu.models.diode_clipper import make_diode_clipper as jax_clipper
from diffwdf_tpu.models.diode_clipper import make_hpf_diode_clipper as jax_hpf
from diffwdf_tpu.models.diode_clipper import make_root_from_zoo as jax_zoo
from diffwdf_tpu.models.tube_screamer import drive_to_r6 as jax_drive_to_r6
from diffwdf_tpu.models.tube_screamer import make_tube_screamer as jax_ts
from diffwdf_tpu.ops.deer_circuit import fused_deer_circuit as jax_deer
from diffwdf_tpu.ops.deer_circuit import fused_deer_neural as jax_deer_neural
from diffwdf_tpu_torch.models import diode_clipper as tdc
from diffwdf_tpu_torch.models import tube_screamer as tts
from diffwdf_tpu_torch.ops import deer_circuit as dc
from diffwdf_tpu_torch.roots.distilled import distill_root
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.runtime.stream import StreamingProcessor

FS = 96000.0


def _signal(seed, n, amp):
    return (amp * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _best():
    return dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d, quality="best")


def _max(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))))


@pytest.fixture(autouse=True)
def _no_launches():
    dc.fused_deer_circuit.launches = dc.fused_deer_neural.launches = 0
    yield
    assert dc.fused_deer_circuit.launches == dc.fused_deer_neural.launches == 0


def _port_ts(drive, quality="best"):
    root, rp = tdc.make_root_from_zoo(0 if quality == "best" else 1, device="cpu")
    ckt = tts.make_tube_screamer(root, FS, drive=drive)
    return ckt, {**ckt.init_params("cpu"), **rp}


def _port_hpf(index=0, fs=FS):
    root, rp = tdc.make_hpf_root_from_zoo(index, device="cpu")
    ckt = tdc.make_hpf_diode_clipper(root, fs)
    return ckt, {**ckt.init_params("cpu"), **rp}


@pytest.fixture(scope="module")
def ts_jax():
    """The JAX Tube Screamer (best root, drive 0.5) and its parameters,
    shared: the JAX kernel compiles once per circuit object."""
    root = _best()
    ts = jax_ts(root, FS, drive=0.5)
    return ts, {**ts.init_params(), **root.init_params()}


def test_tube_screamer_three_state_matches_jax_and_scan(ts_jax):
    """The 4-port R-type op-amp stage, S = 3: output and final state within
    1e-4 of the JAX kernel and of the scan (tests/test_deer_circuit.py:23)."""
    ts, params = ts_jax
    vin = _signal(2, 2048, 0.5)
    ref, ref_st = ts.process(params, ts.init_state(), {"Vin": {"v": jnp.asarray(vin)}})
    jo, jst, _ = jax_deer(ts, params, jnp.asarray(vin), input_node="Vin", interpret=True)
    ckt, tp = _port_ts(0.5)
    out, st, res = dc.fused_deer_circuit(ckt, tp, torch.from_numpy(vin), input_node="Vin")
    assert out.shape == (2048,) and out.dtype == torch.float32 and res.shape == ()
    assert _max(out, jo) < 1e-4 and _max(out, ref) < 1e-4 and _max(jo, ref) < 1e-4
    for node in ("C2", "C3", "C4"):
        want = float(ref_st[node]["z"])
        assert abs(float(st[node]["z"]) - want) < 1e-4, node
        assert abs(float(st[node]["z"]) - float(jst[node]["z"])) < 1e-4, node
    assert float(res) < 1e-3


def test_flagged_block_diverges_as_in_jax(ts_jax):
    """A block that 8 sweeps do not converge (the Tube Screamer on
    0.5 N(0, 1), numpy seed 8): both packages end on the same trajectory,
    far from the scan, and both residuals exceed the processors' fallback
    tolerance, so that a served block is flagged in both and served again
    by the exact engine."""
    ts, params = ts_jax
    vin = _signal(8, 2048, 0.5)
    ref, _ = ts.process(params, ts.init_state(), {"Vin": {"v": jnp.asarray(vin)}})
    jo, jst, jres = jax_deer(ts, params, jnp.asarray(vin), input_node="Vin", interpret=True)
    ckt, tp = _port_ts(0.5)
    out, st, res = dc.fused_deer_circuit(ckt, tp, torch.from_numpy(vin), input_node="Vin")
    tol = inspect.signature(StreamingProcessor).parameters["fallback_tol"].default
    assert float(res) > 100 * tol and float(jres) > 100 * tol, (float(res), float(jres))
    assert abs(float(res) - float(jres)) < 0.01 * float(jres)
    assert _max(out, jo) < 1e-4 and _max(out, ref) > 1e-3 and _max(jo, ref) > 1e-3
    for node in ("C2", "C3", "C4"):
        assert abs(float(st[node]["z"]) - float(jst[node]["z"])) < 1e-4, node


def test_lpf_clipper_matches_jax_and_scan():
    """S = 1: the generic solve reproduces the sequential clipper at 1e-6
    (tests/test_deer_circuit.py:45), and the dedicated clipper DEER."""
    root = _best()
    ckt = jax_clipper(root, FS, 47e3, 2.2e-9)
    params = {**ckt.init_params(), **root.init_params()}
    vin = _signal(4, 1024, 2.0)
    ref, _ = ckt.process(params, ckt.init_state(), {"Vs": {"v": jnp.asarray(vin)}})
    jo, _, _ = jax_deer(ckt, params, jnp.asarray(vin), input_node="Vs", interpret=True)
    troot, rp = tdc.make_root_from_zoo(0, device="cpu")
    tck = tdc.make_diode_clipper(troot, FS, 47e3, 2.2e-9)
    out, st, res = dc.fused_deer_circuit(tck, {**tck.init_params("cpu"), **rp},
                                         torch.from_numpy(vin), input_node="Vs")
    assert _max(out, ref) < 1e-6 and _max(jo, ref) < 1e-6 and _max(out, jo) < 1e-6
    assert set(st) == {"C"} and float(res) < 1e-5


@pytest.fixture(scope="module")
def hpf_jax():
    """The JAX HPF clipper, its scan and its kernel's damped and undamped
    solves on seed 2, amplitude 2 (tests/test_deer_circuit.py:60)."""
    root = _best()
    hpf = jax_hpf(root, FS)
    params = {**hpf.init_params(), **root.init_params()}
    vin = _signal(2, 2048, 2.0)
    ref, _ = hpf.process(params, hpf.init_state(), {"Vs": {"v": jnp.asarray(vin)}})
    bad, _, _ = jax_deer(hpf, params, jnp.asarray(vin), input_node="Vs", sweeps=8,
                         interpret=True)
    good, _, _ = jax_deer(hpf, params, jnp.asarray(vin), input_node="Vs", sweeps=24,
                          damping=0.5, interpret=True)
    return hpf, params, vin, np.asarray(ref), np.asarray(bad), np.asarray(good)


def test_hpf_needs_damping(hpf_jax):
    """The HPF's series capacitor is a marginal mode: full Newton oscillates,
    24 damped sweeps land within 3e-4, over 100x closer, in both packages."""
    _, _, vin, ref, jbad, jgood = hpf_jax
    ckt, tp = _port_hpf()
    bad, _, _ = dc.fused_deer_circuit(ckt, tp, torch.from_numpy(vin), input_node="Vs", sweeps=8)
    good, _, _ = dc.fused_deer_circuit(ckt, tp, torch.from_numpy(vin), input_node="Vs",
                                       sweeps=24, damping=0.5)
    err_good, err_bad = _max(good, ref), _max(bad, ref)
    assert err_good < 3e-4 and _max(jgood, ref) < 3e-4, err_good
    assert err_good < err_bad / 100 and _max(jgood, ref) < _max(jbad, ref) / 100
    assert _max(good, jgood) < 3e-4


# (id, seed, amplitude, adapt_tol): a block that exits early, on a sharp
# drop of the update (seed 2, amplitude 0.5: 4e-5 after 16 sweeps, 2.5e-6
# after 20), and one whose update floors above the tolerance (amplitude 2:
# the cap, 48)
ADAPT_CASES = [("early_exit", 2, 0.5, 1e-5), ("cap", 2, 2.0, 1e-5)]


@pytest.mark.parametrize("case", ADAPT_CASES, ids=[c[0] for c in ADAPT_CASES])
def test_adaptive_hpf_sweeps_run_equal_jax(case, hpf_jax):
    """adapt_tol: the exit is tested after every u-th sweep (u = 4 for 48),
    so the sweeps run are a multiple of 4 and equal the JAX kernel's."""
    _, seed, amp, tol = case
    hpf, params, _, _, _, _ = hpf_jax
    vin = _signal(seed, 2048, amp)
    ref, _ = hpf.process(params, hpf.init_state(), {"Vs": {"v": jnp.asarray(vin)}})
    jo, _, _, jn = jax_deer(hpf, params, jnp.asarray(vin), input_node="Vs", sweeps=48,
                            damping=0.5, adapt_tol=tol, return_info=True, interpret=True)
    ckt, tp = _port_hpf()
    out, _, res, n = dc.fused_deer_circuit(ckt, tp, torch.from_numpy(vin), input_node="Vs",
                                           sweeps=48, damping=0.5, adapt_tol=tol,
                                           return_info=True)
    assert float(n) == float(jn) and float(n) % 4 == 0, (float(n), float(jn))
    assert (float(n) < 48) == (case[0] == "early_exit")
    assert _max(out, ref) < 3e-4 and _max(out, jo) < 3e-4


def test_adaptive_contractive_clipper_stops_early():
    """On the contractive LPF clipper the adaptive loop stops well before
    the cap (tests/test_deer_circuit.py:106-114), after as many sweeps as
    the JAX kernel."""
    root = _best()
    ckt = jax_clipper(root, FS)
    params = {**ckt.init_params(), **root.init_params()}
    vin = _signal(5, 2048, 2.0)
    ref, _ = ckt.process(params, ckt.init_state(), {"Vs": {"v": jnp.asarray(vin)}})
    _, _, _, jn = jax_deer(ckt, params, jnp.asarray(vin), input_node="Vs", sweeps=48,
                           adapt_tol=1e-6, return_info=True, interpret=True)
    troot, rp = tdc.make_root_from_zoo(0, device="cpu")
    tck = tdc.make_diode_clipper(troot, FS)
    out, _, _, n = dc.fused_deer_circuit(tck, {**tck.init_params("cpu"), **rp},
                                         torch.from_numpy(vin), input_node="Vs", sweeps=48,
                                         adapt_tol=1e-6, return_info=True)
    assert float(n) == float(jn) < 24
    assert _max(out, ref) < 1e-5


def test_static_controls_drive_pot():
    """The drive pot moves through static_controls, as in the JAX kernel
    (tests/test_deer_circuit.py:136): within 1e-4 of the scan at that drive."""
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ts = jax_ts(root, FS, drive=0.2)
    params = {**ts.init_params(), **root.init_params()}
    vin = _signal(6, 1024, 0.3)
    ctl = {"R6": {"R": jax_drive_to_r6(0.9)}}
    ref, _ = ts.process(params, ts.init_state(), {"Vin": {"v": jnp.asarray(vin)}},
                        static_controls=ctl)
    jo, _, _ = jax_deer(ts, params, jnp.asarray(vin), input_node="Vin", static_controls=ctl,
                        interpret=True)
    ckt, tp = _port_ts(0.2)
    tctl = {"R6": {"R": tts.drive_to_r6(0.9)}}
    out, _, _ = dc.fused_deer_circuit(ckt, tp, torch.from_numpy(vin), input_node="Vin",
                                      static_controls=tctl)
    assert _max(out, ref) < 1e-4 and _max(jo, ref) < 1e-4 and _max(out, jo) < 1e-4
    plain, _, _ = dc.fused_deer_circuit(ckt, tp, torch.from_numpy(vin), input_node="Vin")
    assert _max(plain, out) > 1e-3  # the pot moved the output


# (zoo index, seed, amplitude) at 48 kHz and T = 2048: the pretrained 2x16
# at the JAX suite's point (tests/test_deer_circuit.py:298), the 1U-2D
# multi-diode 2x16 and the 2x4 at its multi-diode point (:326)
NEURAL_CASES = [(4, 7, 2.0), (7, 9, 1.5), (2, 9, 1.5)]


@pytest.fixture(scope="module")
def jax_neural_clippers():
    """One JAX clipper per NxH width, shared by the cases of that width:
    the JAX kernel compiles once per circuit (its root weights are
    arguments)."""
    return {}


@pytest.mark.parametrize("case", NEURAL_CASES, ids=[f"zoo{c[0]}" for c in NEURAL_CASES])
def test_neural_root_matches_jax_and_scan(case, jax_neural_clippers):
    index, seed, amp = case
    fs = 48000.0
    jroot, frag = jax_zoo(index)
    key = (jroot.n_layers, jroot.layer_size)
    ckt = jax_neural_clippers.setdefault(key, jax_clipper(jroot, fs))
    params = {**ckt.init_params(), **frag}
    x = _signal(seed, 2048, amp)
    ref, ref_st = ckt.process(params, ckt.init_state(), {"Vs": {"v": jnp.asarray(x)}})
    jo, _, jres = jax_deer_neural(ckt, params, jnp.asarray(x), input_node="Vs",
                                  state0=ckt.init_state(), interpret=True)
    troot, tfrag = tdc.make_root_from_zoo(index, device="cpu")
    tck = tdc.make_diode_clipper(troot, fs)
    out, st, res = dc.fused_deer_neural(tck, {**tck.init_params("cpu"), **tfrag},
                                        torch.from_numpy(x), input_node="Vs")
    assert _max(out, ref) < 5e-6 and _max(jo, ref) < 5e-6 and _max(out, jo) < 5e-6
    assert float(res) < 1e-5 and float(jres) < 1e-5
    assert abs(float(st["C"]["z"]) - float(ref_st["C"]["z"])) < 5e-6


def test_rejects_what_the_kernel_does_not_take():
    """Relu layers and a root with no hidden H->H layer raise ValueError as
    in the JAX kernel, through fused_deer_neural and fused_deer_circuit
    alike; T must be a multiple of 1024; the distilled root is solved (its
    slope emitter gives the Jacobian), within 1e-6 of Circuit.process."""
    fs = 48000.0
    relu = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8,
                           activations=("tanh", "relu", "tanh", ""))
    ckt = tdc.make_diode_clipper(relu, fs)
    params = {**ckt.init_params("cpu"), **relu.init_params("cpu")}
    with pytest.raises(ValueError, match="tanh"):
        dc.fused_deer_neural(ckt, params, torch.zeros(1024), input_node="Vs")
    with pytest.raises(ValueError, match="tanh"):
        dc.fused_deer_circuit(ckt, params, torch.zeros(1024), input_node="Vs")
    shallow = NeuralDiodeRoot(name="dp", n_layers=0, layer_size=8)
    ckt0 = tdc.make_diode_clipper(shallow, fs)
    with pytest.raises(ValueError):
        dc.fused_deer_neural(ckt0, {**ckt0.init_params("cpu"), **shallow.init_params("cpu")},
                             torch.zeros(1024), input_node="Vs")
    ts, tp = _port_ts(0.5)
    with pytest.raises(ValueError, match="multiple of 1024"):
        dc.fused_deer_circuit(ts, tp, torch.zeros(1000), input_node="Vin")
    with pytest.raises(ValueError):
        dc.fused_deer_circuit(ts, tp, torch.zeros(2, 1024), input_node="Vin")
    root, rp = tdc.make_root_from_zoo(0, device="cpu")
    droot, _ = distill_root(root, rp, 1.0 / (1.0 / 47.0e3 + 2.0 * 2.2e-9 * FS))
    dck = tdc.make_diode_clipper(droot, FS)
    x = torch.from_numpy(_signal(6, 1024, 2.0))
    out, st, res = dc.fused_deer_circuit(dck, dck.init_params("cpu"), x, input_node="Vs")
    ref, ref_st = dck.process(dck.init_params("cpu"), dck.init_state("cpu"), {"Vs": {"v": x}})
    assert _max(out, ref) < 1e-6 and float(res) < 1e-5
    assert abs(float(st["C"]["z"]) - float(ref_st["C"]["z"])) < 1e-6


def test_chained_blocks_and_plain_entry():
    """The final state of one block seeds the next (the serving contract):
    two chained 2048-blocks stay within 1e-4 of one scan over both, each
    certified by its residual; the ``_plain`` entries are the CPU path
    itself."""
    root = _best()
    ts = jax_ts(root, FS, drive=0.5)
    params = {**ts.init_params(), **root.init_params()}
    x = _signal(2, 4096, 0.5)
    ref, _ = ts.process(params, ts.init_state(), {"Vin": {"v": jnp.asarray(x)}})
    ckt, tp = _port_ts(0.5)
    vin = torch.from_numpy(x)
    a, st, ra = dc.fused_deer_circuit(ckt, tp, vin[:2048], input_node="Vin")
    b, _, rb = dc.fused_deer_circuit(ckt, tp, vin[2048:], input_node="Vin", state0=st)
    assert _max(torch.cat([a, b]), ref) < 1e-4 and max(float(ra), float(rb)) < 1e-4
    p, _, _ = dc.fused_deer_circuit_plain(ckt, tp, vin[:2048], input_node="Vin")
    assert torch.equal(p, a)
