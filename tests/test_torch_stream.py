"""diffwdf_tpu_torch single-stream serving vs the JAX package.

Two parts, each held against the JAX package on the same numpy inputs:

- ``ops.parallel_time_deer``: on the CPU ``fused_deer_clipper`` runs its
  plain version, the DEER algorithm in torch ops.  It is held against the
  JAX Pallas kernel in interpret mode (as ``make_clipper_processor`` runs it
  off the TPU) at 1e-6, and both against the JAX scan at the JAX suite's
  budgets: 1e-6 for the best-quality root and the 3U-3D pair
  (tests/test_parallel_time_deer.py:44,73), 2e-6 for chained blocks and
  hard overdrive (:89, :60), 5e-6 for the 1-iteration "approx" root
  (tests/test_deer_circuit.py:200, at its 48 kHz, 1.5-amplitude operating
  point).
- ``runtime.stream``: the port's processor on ``device="cpu"`` against the
  JAX processor, block for block, with the gain ramp, the cutoff map, the
  carried state, the DC blocker, the residual-triggered fallback and the
  group hot-swap; budgets 5e-6 for the analytic members, 2e-5 for the
  neural one.  Plus ports of the clipper cases of tests/test_runtime.py.

On the CPU no tensor reaches a kernel: every launch counter stays 0.  The
CUDA kernel itself is compared with its plain version on a card
(tests/test_torch_gpu.py).
"""

import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
from diffwdf_tpu.models.diode_clipper import make_diode_clipper as jax_make_diode_clipper
from diffwdf_tpu.ops.parallel_time_deer import fused_deer_clipper as jax_deer
from diffwdf_tpu.runtime.stream import make_clipper_processor as jax_make_processor
from diffwdf_tpu_torch.models.diode_clipper import cutoff_to_resistance, make_diode_clipper
from diffwdf_tpu_torch.ops import fused_clipper as tfc
from diffwdf_tpu_torch.ops import parallel_time_deer as tdeer
from diffwdf_tpu_torch.roots.diode import DiodePairRoot, diode_1n4148_1u1d
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.runtime import stream as tstream

REPO = Path(__file__).resolve().parents[1]
FS = 96000.0
R_SRC, CAP = 47.0e3, 2.2e-9
QUALITY = {3: "best", 1: "low"}
#: the cutoff that maps to R = 180 Ohm, the resistor's lower bound
BAD_CUTOFF = 1.0 / (2.0 * np.pi * 180.0 * CAP)


def _signal(seed, n, amp=2.0):
    return (amp * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


def _make(engine, models, fs=FS):
    """The JAX processor and the port's, on the CPU, for the same set."""
    return (jax_make_processor(fs, models=models, engine=engine),
            tstream.make_clipper_processor(fs, models=models, engine=engine, device="cpu"))


def _jax_scan(diode, iters, vin, fs, r_src, z0=0.0):
    root = dwdf.DiodePairRoot(name="dp", diode=diode, quality=QUALITY[iters])
    ckt = jax_make_diode_clipper(root, fs, r_src, CAP)
    params = {**ckt.init_params(), **root.init_params()}
    out, st = ckt.process(params, {"C": {"z": jnp.float32(z0)}}, {"Vs": {"v": jnp.asarray(vin)}})
    return np.asarray(out), float(st["C"]["z"])


@pytest.fixture(autouse=True)
def _no_launches():
    """No CPU tensor may reach a kernel: every counter stays 0."""
    counters = (tdeer.fused_deer_clipper, tfc.fused_clipper_analytic, tfc.fused_clipper_neural)
    for c in counters:
        c.launches = 0
    yield
    assert [c.launches for c in counters] == [0, 0, 0]


# ---------------------------------------------------------------------------
# fused_deer_clipper's plain version vs the JAX kernel and scan
# ---------------------------------------------------------------------------

# (id, diode, T, sweeps, omega iters, relax passes, amplitude, seed, fs, R,
#  z0, budget against the scan or None)
DEER_CASES = [
    ("toms", diode_1n4148_1u1d, 2048, 8, 3, 2, 2.0, 3, FS, R_SRC, 0.0, 1e-6),
    ("toms_z0", diode_1n4148_1u1d, 2048, 8, 3, 2, 2.0, 4, FS, R_SRC, 0.3, 1e-6),
    ("approx", diode_1n4148_1u1d, 2048, 4, 1, 2, 1.5, 13, 48000.0,
     cutoff_to_resistance(4000.0, CAP), 0.3, 5e-6),
    ("3u3d", "diode_1n4148_3u3d", 2048, 8, 3, 2, 2.0, 5, FS, R_SRC, 0.0, 1e-6),
    # the approx configuration at 96 kHz and 47 kOhm: at L = 2 samples per
    # block 4 sweeps leave the JAX kernel ~1e-4 from the scan; the port
    # reproduces the reference algorithm, distance and all
    ("approx_96k", diode_1n4148_1u1d, 2048, 4, 1, 2, 2.0, 1, FS, R_SRC, 0.3, None),
]


@pytest.mark.parametrize("case", DEER_CASES, ids=[c[0] for c in DEER_CASES])
def test_deer_plain_matches_jax_kernel_and_scan(case):
    _, diode, T, sweeps, iters, relax, amp, seed, fs, r_src, z0, budget = case
    if isinstance(diode, str):
        diode = getattr(dwdf, diode)
    vin = _signal(seed, T, amp)
    args = (r_src, CAP, diode.Is, diode.Vt * diode.nabla, float(diode.N_up),
            float(diode.N_down))
    kw = dict(fs=fs, z0=z0, sweeps=sweeps, relax_passes=relax, quality_iters=iters)
    jo, jz, jr = jax_deer(jnp.asarray(vin), *args, interpret=True, **kw)
    to, tz, tr = tdeer.fused_deer_clipper(torch.from_numpy(vin), *args, **kw)
    assert to.shape == (T,) and tz.shape == () and tr.shape == ()
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-6, rtol=0)
    assert abs(float(tz) - float(jz)) <= 1e-6
    assert abs(float(tr) - float(jr)) <= max(1e-6, 0.05 * float(jr))
    ref, ref_z = _jax_scan(diode, iters, vin, fs, r_src, z0)
    t_err = float(np.max(np.abs(to.numpy() - ref)))
    j_err = float(np.max(np.abs(np.asarray(jo) - ref)))
    if budget is None:
        assert abs(t_err - j_err) <= 1e-6, (t_err, j_err)
    else:
        assert t_err < budget and j_err < budget, (t_err, j_err)
        assert abs(float(tz) - ref_z) < budget


def test_deer_hard_overdrive_converges():
    """Amplitude 10 with 4 relaxations (tests/test_parallel_time_deer.py:48-60):
    the clamp and the relaxation warm start keep Newton in its basin."""
    d = diode_1n4148_1u1d
    vin = _signal(1, 16384, 10.0)
    out, _, res = tdeer.fused_deer_clipper(
        torch.from_numpy(vin), R_SRC, CAP, d.Is, d.Vt * d.nabla, 1.0, 1.0, fs=FS,
        sweeps=8, relax_passes=4)
    ref, _ = _jax_scan(d, 3, vin, FS, R_SRC)
    assert float(np.max(np.abs(out.numpy() - ref))) < 2e-6
    assert float(res) < 1e-5


def test_deer_chained_blocks_equal_one_solve():
    """z_final of one call seeds z0 of the next: two chained 1024-blocks
    equal one 2048 solve, and the JAX kernel's chain (state given as a
    tensor stays a tensor)."""
    d = diode_1n4148_1u1d
    vin = _signal(7, 2048)
    args = (R_SRC, CAP, d.Is, d.Vt * d.nabla, 1.0, 1.0)
    full, _, _ = tdeer.fused_deer_clipper(torch.from_numpy(vin), *args, fs=FS)
    a, za, _ = tdeer.fused_deer_clipper(torch.from_numpy(vin[:1024]), *args, fs=FS)
    b, _, _ = tdeer.fused_deer_clipper(torch.from_numpy(vin[1024:]), *args, fs=FS, z0=za)
    chained = torch.cat([a, b]).numpy()
    np.testing.assert_allclose(chained, full.numpy(), atol=2e-6, rtol=0)
    ja, jza, _ = jax_deer(jnp.asarray(vin[:1024]), *args, fs=FS, interpret=True)
    jb, _, _ = jax_deer(jnp.asarray(vin[1024:]), *args, fs=FS, z0=float(jza), interpret=True)
    np.testing.assert_allclose(chained, np.concatenate([ja, jb]), atol=1e-6, rtol=0)


def test_deer_residual_certificate_flags_180_ohm():
    """At R = 180 Ohm every sample clips hard and |df/dz| -> 1: the solve
    does not converge, and the residual says so in both packages."""
    d = diode_1n4148_1u1d
    vin = _signal(21, 1024)
    args = (180.0, CAP, d.Is, d.Vt * d.nabla, 1.0, 1.0)
    out, _, res = tdeer.fused_deer_clipper(torch.from_numpy(vin), *args, fs=FS)
    _, _, jres = jax_deer(jnp.asarray(vin), *args, fs=FS, interpret=True)
    ref, _ = _jax_scan(d, 3, vin, FS, 180.0)
    err = float(np.max(np.abs(out.numpy() - ref)))
    assert float(res) > 1e-2 and float(jres) > 1e-2
    assert float(res) > err / 100  # the certificate tracks the failure


def test_deer_rejects_what_the_kernel_does_not_take():
    d = diode_1n4148_1u1d
    args = (R_SRC, CAP, d.Is, d.Vt * d.nabla, 1.0, 1.0)
    with pytest.raises(ValueError, match="multiple of 1024"):
        tdeer.fused_deer_clipper(torch.zeros(1000), *args, fs=FS)
    with pytest.raises(ValueError):
        tdeer.fused_deer_clipper(torch.zeros(2, 1024), *args, fs=FS)
    with pytest.raises(TypeError):
        tdeer.fused_deer_clipper(torch.zeros(1024, dtype=torch.float64), *args, fs=FS)


# ---------------------------------------------------------------------------
# the streaming processor vs the JAX processor
# ---------------------------------------------------------------------------

BLOCK_CASES = [("scan", "toms", 5e-6), ("scan", "approx", 5e-6),
               ("scan", "neural_2x16", 2e-5), ("deer", "toms", 5e-6), ("deer", "approx", 5e-6)]


@pytest.mark.parametrize("engine,member,budget", BLOCK_CASES,
                         ids=[f"{e}-{m}" for e, m, _ in BLOCK_CASES])
def test_processor_matches_jax_block_for_block(engine, member, budget):
    """Three 2048-blocks with a gain ramp, a cutoff change and the state and
    DC blocker carried: the port's processor serves what the JAX one does."""
    jp, tp = _make(engine, (member,))
    x = _signal(0, 3 * 2048, 1.5)
    for i in range(3):
        kw = dict(gain_db=3.0 * i, cutoff_hz=3000.0 + 1000.0 * i)
        blk = x[i * 2048:(i + 1) * 2048]
        a = jp.process_block(blk, "clipper", model=member, **kw)
        b = tp.process_block(blk, "clipper", model=member, **kw)
        assert b.dtype == np.float32 and b.shape == (2048,)
        np.testing.assert_allclose(b, a, atol=budget, rtol=0, err_msg=f"block {i}")
        assert abs(tp.last_residual[member] - jp.last_residual[member]) <= 1e-6
        assert tp.last_residual["clipper"] == tp.last_residual[member]
    assert tp.fallbacks == jp.fallbacks == {}
    assert set(tp.process_overrides) == set(jp.process_overrides)
    assert bool(tp.process_overrides) == (engine == "deer")


def test_residual_fallback_serves_the_exact_block():
    """At the cutoff that maps to 180 Ohm the DEER residual exceeds
    fallback_tol: the block is recomputed by the exact engine, counted, and
    the raw residual stays surfaced, as in the JAX processor."""
    assert abs(cutoff_to_resistance(BAD_CUTOFF, CAP) - 180.0) < 1e-6
    x = _signal(21, 1024)
    jp, tp = _make("deer", ("toms",))
    scan = tstream.make_clipper_processor(FS, models=("toms",), device="cpu")
    a = jp.process_block(x, "toms", cutoff_hz=BAD_CUTOFF)
    b = tp.process_block(x, "toms", cutoff_hz=BAD_CUTOFF)
    c = scan.process_block(x, "toms", cutoff_hz=BAD_CUTOFF)
    assert tp.fallbacks == jp.fallbacks == {"toms": 1}
    assert tp.last_residual["toms"] > tp.fallback_tol
    np.testing.assert_allclose(b, c, atol=1e-6, rtol=0)
    # the port's exact engine is the analytic kernel's recursion, the JAX
    # one the scan: the kernel-vs-scan budget (tests/test_fused_kernel.py:64)
    np.testing.assert_allclose(b, a, atol=5e-6, rtol=0)
    # fallback disabled: the flagged block is served as it is
    raw = tstream.make_clipper_processor(FS, models=("toms",), engine="deer", device="cpu")
    raw.fallback_tol = None
    d = raw.process_block(x, "toms", cutoff_hz=BAD_CUTOFF)
    assert raw.fallbacks == {} and np.max(np.abs(d - c)) > 1e-3


def test_deer_block_of_other_length_is_exact():
    """A 1000-sample block is no multiple of 1024: the exact engine serves
    it and the residual is 0.0."""
    jp, tp = _make("deer", ("toms", "approx"))
    scan = tstream.make_clipper_processor(FS, models=("toms", "approx"), device="cpu")
    x = _signal(5, 1000, 1.5)
    for m in ("toms", "approx"):
        b = tp.process_block(x, "clipper", model=m, gain_db=2.0)
        a = jp.process_block(x, "clipper", model=m, gain_db=2.0)
        c = scan.process_block(x, "clipper", model=m, gain_db=2.0)
        assert tp.last_residual[m] == 0.0 == jp.last_residual[m]
        np.testing.assert_allclose(b, a, atol=5e-6, rtol=0)
        np.testing.assert_allclose(b, c, atol=1e-6, rtol=0)


def test_group_hot_swap_matches_jax():
    """The model choice changes per block on one shared state: index, label
    and member name all select, and every block equals the JAX processor's."""
    models = ("toms", "approx", "neural_2x16")
    jp, tp = _make("scan", models)
    x = _signal(9, 4 * 512, 1.5)
    for i, choice in enumerate((0, "approx", "neural_2x16", "toms")):
        blk = x[i * 512:(i + 1) * 512]
        a = jp.process_block(blk, "clipper", model=choice, cutoff_hz=5000.0)
        b = tp.process_block(blk, "clipper", model=choice, cutoff_hz=5000.0)
        np.testing.assert_allclose(b, a, atol=2e-5, rtol=0, err_msg=str(choice))
    assert tp._state.keys() == {"clipper"}
    np.testing.assert_allclose(float(tp._state["clipper"]["C"]["z"]),
                               float(jp._state["clipper"]["C"]["z"]), atol=2e-5)


def test_deer_group_hot_swap_matches_jax():
    jp, tp = _make("deer", ("toms", "approx"))
    x = _signal(10, 4 * 1024, 1.0)
    for i, m in enumerate(("toms", "approx", "approx", "toms")):
        blk = x[i * 1024:(i + 1) * 1024]
        a = jp.process_block(blk, "clipper", model=m, gain_db=6.0)
        b = tp.process_block(blk, "clipper", model=m, gain_db=6.0)
        np.testing.assert_allclose(b, a, atol=5e-6, rtol=0, err_msg=f"block {i}")


@pytest.mark.parametrize("engine,models,sizes", [
    ("scan", ("toms", "approx", "neural_2x16"), (256,)),
    ("deer", ("toms",), (1024,)),
], ids=["scan", "deer"])
def test_warmup_keys_match_jax_and_leave_state(engine, models, sizes):
    """warmup runs every (member, block size, engine variant, control
    variant) once: the same keys and count as the JAX processor's, and the
    stream's state, DC state and gain are untouched."""
    jp, tp = _make(engine, models)
    x = _signal(3, sizes[0], 0.5)
    tp.process_block(x, "clipper", gain_db=2.0)
    before = (float(tp._state["clipper"]["C"]["z"]), [float(v) for v in tp._dc_state],
              tp._gain)
    info = tp.warmup(list(sizes))
    jinfo = jp.warmup(list(sizes))
    assert info["keys"] == jinfo["keys"] and info["n_compiled"] == jinfo["n_compiled"] > 0
    assert info["seconds"] > 0
    assert set(tp._fns) == {k[:3] for k in info["keys"]}
    after = (float(tp._state["clipper"]["C"]["z"]), [float(v) for v in tp._dc_state],
             tp._gain)
    assert after == before
    fresh = tstream.make_clipper_processor(FS, models=models, engine=engine, device="cpu")
    fresh.process_block(x, "clipper", gain_db=2.0)
    np.testing.assert_array_equal(tp.process_block(x, "clipper", gain_db=2.0),
                                  fresh.process_block(x, "clipper", gain_db=2.0))
    with pytest.raises(KeyError):
        tp.warmup([256], circuits=("nope",))


def test_deer_with_neural_member_raises():
    """Only an unknown engine raises now: the neural member under
    engine="deer" is served by the generic DEER solve (fused_deer_neural,
    8 sweeps), within 1e-5 of the scan engine over two carried blocks with
    a gain and a cutoff (tests/test_deer_circuit.py:382), with no fallback
    and a residual below 1e-4.  The default set builds under deer."""
    fs = 48000.0
    x = _signal(13, 4096, 1.5)
    deer = tstream.make_clipper_processor(fs, models=("neural_2x16",), engine="deer",
                                          device="cpu")
    scan = tstream.make_clipper_processor(fs, models=("neural_2x16",), device="cpu")
    jscan = jax_make_processor(fs, models=("neural_2x16",))
    for blk in (0, 1):
        xb = x[blk * 2048:(blk + 1) * 2048]
        kw = dict(gain_db=6.0, cutoff_hz=3000.0)
        b = deer.process_block(xb, "neural_2x16", **kw)
        np.testing.assert_allclose(b, scan.process_block(xb, "neural_2x16", **kw), atol=1e-5,
                                   rtol=0, err_msg=f"block {blk}")
        np.testing.assert_allclose(b, jscan.process_block(xb, "neural_2x16", **kw), atol=1e-5,
                                   rtol=0, err_msg=f"block {blk}")
    assert deer.fallbacks.get("neural_2x16", 0) == 0
    assert 0.0 <= deer.last_residual["neural_2x16"] < 1e-4
    full = tstream.make_clipper_processor(FS, engine="deer", device="cpu")
    assert set(full.process_overrides) == {"toms", "approx", "neural_2x16"}
    assert [m for m in full.circuits if full._kernel_sources(m, {})] == ["neural_2x16"]
    with pytest.raises(ValueError):
        tstream.make_clipper_processor(FS, engine="xla", device="cpu")


def test_exact_runner_covers_the_kernel_roots_only():
    """The exact engine is one launch of the batched kernel at B=1 for a
    diode pair and for an all-tanh NxH root, and of the generated forward
    (B7's general MLP root) for a root with relu layers, within 2e-5 of
    Circuit.process; a processor given no runner for a member serves it
    by Circuit.process."""
    fs = 48000.0
    diode = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d, quality="low")
    tanh = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8)
    relu = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8,
                           activations=("tanh", "relu", "tanh", ""))
    runners = {name: tstream._lpf_exact_runner(make_diode_clipper(root, fs))
               for name, root in (("diode", diode), ("tanh", tanh), ("relu", relu))}
    assert all(run is not None for run in runners.values())
    assert hasattr(runners["relu"], "sources")  # the generated forward's runner
    circuits = {n: (make_diode_clipper(r, fs), None) for n, r in (("tanh", tanh), ("relu", relu))}
    circuits = {n: (c, c.init_params("cpu")) for n, (c, _) in circuits.items()}
    proc = tstream.StreamingProcessor(
        circuits, fs, exact_runners={"tanh": tstream._lpf_exact_runner(circuits["tanh"][0])},
        device="cpu")
    x = _signal(2, 64, 1.0)
    ckt, params = circuits["relu"]
    want, _ = ckt.process(params, ckt.init_state("cpu"), {"Vs": {"v": torch.from_numpy(x)}})
    got = proc.process_block(x, "relu")
    assert np.all(np.isfinite(got)) and np.max(np.abs(want.numpy())) > 0
    # the tanh member through its runner equals Circuit.process
    ckt, params = circuits["tanh"]
    out, z = tstream._lpf_exact_runner(ckt)(params, ckt.init_state("cpu"),
                                            {"Vs": {"v": torch.from_numpy(x)}}, {})
    want, st = ckt.process(params, ckt.init_state("cpu"), {"Vs": {"v": torch.from_numpy(x)}})
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(float(z["C"]["z"]), float(st["C"]["z"]), atol=2e-5)
    # the relu member through its runner, with a static source R, too
    ckt, params = circuits["relu"]
    inputs, static = {"Vs": {"v": torch.from_numpy(x)}}, {"Vs": {"R": 30e3}}
    out, z = runners["relu"](params, ckt.init_state("cpu"), inputs, static)
    want, st = ckt.process(params, ckt.init_state("cpu"), inputs, static_controls=static)
    np.testing.assert_allclose(out.numpy(), want.numpy(), atol=2e-5, rtol=0)
    np.testing.assert_allclose(float(z["C"]["z"]), float(st["C"]["z"]), atol=2e-5, rtol=0)


def test_dc_blocker_scan_matches_the_recursion():
    """The log-depth doubling scan equals y[t] = x[t] - x[t-1] + rho y[t-1]
    run sample by sample in f64, at the longest block and the lowest rate,
    where rho^-t would overflow f32's digits."""
    T, fs = 16384, 48000.0
    rng = np.random.default_rng(4)
    out = torch.from_numpy(rng.standard_normal(T).astype(np.float32))
    x1, y1 = 0.3, -0.2
    rho = tstream._dc_blocker_coeff(fs)
    y, (nx1, ny1) = tstream._dc_blocker(out, (torch.tensor(x1), torch.tensor(y1)),
                                        *tstream._dc_blocker_tables(rho, T, "cpu"))
    want = np.empty(T)
    prev_x, prev_y = x1, y1
    for t, v in enumerate(out.double().numpy()):
        prev_y = v - prev_x + rho * prev_y
        prev_x = v
        want[t] = prev_y
    np.testing.assert_allclose(y.numpy(), want, atol=2e-5, rtol=0)
    assert float(nx1) == float(out[-1]) and float(ny1) == float(y[-1])


# ---------------------------------------------------------------------------
# ports of the clipper cases of tests/test_runtime.py
# ---------------------------------------------------------------------------

RT_FS = 48000.0


def _proc(models, **kw):
    return tstream.make_clipper_processor(RT_FS, models=models, device="cpu", **kw)


def test_block_streaming_is_gapless():
    n = np.arange(2048)
    x = (1.5 * np.sin(2 * np.pi * 220.0 * n / RT_FS)).astype(np.float32)
    proc = _proc(("toms",))
    blocked = np.concatenate([proc.process_block(x[i:i + 256], "toms")
                              for i in range(0, 2048, 256)])
    np.testing.assert_allclose(blocked, _proc(("toms",)).process_block(x, "toms"), atol=1e-5)


def test_mono_sum_and_fanout():
    x = np.random.default_rng(0).normal(size=(2, 512)).astype(np.float32)
    out = _proc(("approx",)).process_block(x, "approx")
    assert out.shape == (2, 512)
    np.testing.assert_allclose(out[0], out[1])
    np.testing.assert_allclose(out[0], _proc(("approx",)).process_block(x.mean(0), "approx"))


def test_gain_changes_distortion():
    n = np.arange(4096)
    x = (0.1 * np.sin(2 * np.pi * 440.0 * n / RT_FS)).astype(np.float32)
    lo = _proc(("toms",)).process_block(x, "toms", gain_db=0.0)
    hi = _proc(("toms",)).process_block(x, "toms", gain_db=18.0)
    assert np.max(np.abs(hi)) > np.max(np.abs(lo))


def test_dc_blocker_removes_offset():
    out = _proc(("toms",)).process_block(np.full(8192, 0.8, dtype=np.float32), "toms")
    assert abs(np.mean(out[-2048:])) < 1e-2


def test_model_dispatch_and_load_meter():
    proc = _proc(("toms", "approx", "neural_2x16"))
    x = np.random.default_rng(1).normal(size=512).astype(np.float32)
    outs = {m: proc.process_block(x, m) for m in ("toms", "approx", "neural_2x16")}
    assert all(np.all(np.isfinite(o)) for o in outs.values())
    assert proc.load > 0.0
    specs = proc.param_specs("toms")
    assert {s.name for s in specs} == {"gain", "cutoff", "model"}
    model = next(s for s in specs if s.name == "model")
    assert model.choices == ("toms", "approx", "neural_2x16")
    assert proc.surfaces() == ("clipper",)
    assert [s.to_dict()["name"] for s in tstream.clipper_param_specs()] == [
        "gain", "cutoff", "model"]
    for schema in (tstream.multi_diode_param_specs, tstream.tube_screamer_param_specs,
                   tstream.hpf_param_specs, tstream.default_clipper_params):
        assert any(s.kind == "choice" for s in schema())


def test_block_rate_cutoff_param():
    n = np.arange(4096)
    x = (0.05 * np.sin(2 * np.pi * 5000.0 * n / RT_FS)).astype(np.float32)
    proc = _proc(("toms",))
    lo = proc.process_block(x, "toms", cutoff_hz=500.0)
    proc.reset()
    hi = proc.process_block(x, "toms", cutoff_hz=18000.0)
    assert np.sqrt(np.mean(hi[2000:] ** 2)) > 3 * np.sqrt(np.mean(lo[2000:] ** 2))


def test_over_advertising_schema_is_rejected():
    circuits = {}
    for i, q in enumerate(("best", "low")):
        ckt = make_diode_clipper(DiodePairRoot(name="dp", diode=diode_1n4148_1u1d, quality=q),
                                 RT_FS)
        circuits[f"m{i}"] = (ckt, ckt.init_params("cpu"))
    bad = (tstream.ParamSpec("model", "choice", choices=("a", "b", "c"), api="circuit"),)
    with pytest.raises(ValueError, match="advertises"):
        tstream.StreamingProcessor(circuits, RT_FS, param_schemas={"g": bad},
                                   groups={"g": tuple(circuits)}, device="cpu")
    with pytest.raises(ValueError, match="not registered"):
        tstream.StreamingProcessor(circuits, RT_FS, param_schemas={"m0": bad}, device="cpu")


def test_model_routing_errors():
    with pytest.raises(FileNotFoundError):
        _proc(("neural_2x16",), mlp_json="nope.json")
    proc = _proc(("toms", "approx"))
    x = np.zeros(64, np.float32)
    with pytest.raises(KeyError, match="out of range"):
        proc.process_block(x, "clipper", model=-1)
    with pytest.raises(KeyError, match="unknown model"):
        proc.process_block(x, "clipper", model="nope")
    with pytest.raises(ValueError, match="not a model group"):
        proc.process_block(x, "toms", model=0)
    _, p1 = proc.circuits["approx"]
    proc.set_params("clipper", p1, model=0)
    assert proc.circuits["toms"][1] is p1


def test_port_stream_imports_no_jax():
    code = ("import sys\n"
            "import diffwdf_tpu_torch.runtime.stream, diffwdf_tpu_torch.ops.parallel_time_deer\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'diffwdf_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
