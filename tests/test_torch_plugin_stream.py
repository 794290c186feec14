"""diffwdf_tpu_torch.runtime.stream: the plugin's circuit set and the HPF
clipper served single-stream, against the JAX package, on the CPU.

The port's ``make_plugin_processor`` and ``make_hpf_processor`` on
``device="cpu"`` (every kernel wrapper runs its plain version) serve the
same numpy blocks as the JAX processors.  Budgets are the JAX suite's
(tests/test_deer_circuit.py:154-216): every plugin group, deer against scan,
2e-4; zoo 1 ("approx"), deer against scan, 5e-6; the HPF clipper under
deer, 5e-4.  The JAX deer processors run the Pallas kernels in interpret
mode, as the JAX suite does; where that costs a compile per member (the
neural HPF roots) the port's deer engine is held against the JAX scan
engine, the exact reference.  The groups, schemas and ``surfaces()`` equal
the JAX processors'.  No CPU tensor reaches a kernel: every launch counter
stays 0.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from diffwdf_tpu.runtime import stream as jstream
from diffwdf_tpu_torch.ops import deer_circuit as dc
from diffwdf_tpu_torch.ops import fused_circuit as fcirc
from diffwdf_tpu_torch.ops import fused_clipper as tfc
from diffwdf_tpu_torch.ops import parallel_time_deer as tdeer
from diffwdf_tpu_torch.runtime import stream as tstream

REPO = Path(__file__).resolve().parents[1]
FS = 48000.0


def _signal(seed, n, amp):
    return (amp * np.random.default_rng(seed).standard_normal(n)).astype(np.float32)


@pytest.fixture(autouse=True)
def _no_launches():
    counters = (dc.fused_deer_circuit, dc.fused_deer_neural, fcirc.fused_circuit_process,
                tdeer.fused_deer_clipper,
                tfc.fused_clipper_analytic, tfc.fused_clipper_neural)
    for c in counters:
        c.launches = 0
    yield
    assert [c.launches for c in counters] == [0] * len(counters)


@pytest.fixture(scope="module")
def plugins():
    """{engine: (JAX processor, port processor)} of the plugin's set."""
    return {e: (jstream.make_plugin_processor(FS, engine=e),
                tstream.make_plugin_processor(FS, engine=e, device="cpu"))
            for e in ("scan", "deer")}


# (group, block params): the clipper's default member runs the clipper's
# DEER kernel, the multi-diode group's (a 2x16) and the Tube Screamer's
# (the approx analytic root) the generic one
GROUP_CASES = [("clipper", {"cutoff_hz": 3000.0}),
               ("multi_diode_clipper", {"cutoff_hz": 3000.0}),
               ("tube_screamer", {"drive": 0.7})]


@pytest.mark.parametrize("group,knobs", GROUP_CASES, ids=[g for g, _ in GROUP_CASES])
def test_plugin_groups_deer_matches_scan_and_jax(plugins, group, knobs):
    """One block per group with a gain and a knob (tests/test_deer_circuit.py:154):
    the port's deer engine serves the port's scan engine's output within
    2e-4, and each engine the JAX processor's."""
    x = _signal(9, 2048, 0.8)
    out = {}
    for engine, (jp, tp) in plugins.items():
        a = jp.process_block(x, group, gain_db=3.0, **knobs)
        b = tp.process_block(x, group, gain_db=3.0, **knobs)
        assert b.dtype == np.float32 and b.shape == (2048,) and np.isfinite(b).all()
        np.testing.assert_allclose(b, a, atol=2e-4, rtol=0, err_msg=f"{engine} vs JAX")
        out[engine] = b
    np.testing.assert_allclose(out["deer"], out["scan"], atol=2e-4, rtol=0)
    deer = plugins["deer"][1]
    assert deer.fallbacks == {}
    assert 0.0 < deer.last_residual[group] < deer.fallback_tol


def test_plugin_zoo1_deer_matches_scan():
    """Zoo entry 1 (the 1-iteration omega root) keeps its quality under the
    deer engine (tests/test_deer_circuit.py:174): 5e-6, as in JAX."""
    x = _signal(17, 2048, 1.5)
    a = tstream.make_plugin_processor(FS, clipper_zoo=1, device="cpu").process_block(x, "clipper")
    b = tstream.make_plugin_processor(FS, clipper_zoo=1, engine="deer",
                                      device="cpu").process_block(x, "clipper")
    j = jstream.make_plugin_processor(FS, clipper_zoo=1, engine="deer").process_block(x, "clipper")
    np.testing.assert_allclose(b, a, atol=5e-6, rtol=0)
    np.testing.assert_allclose(b, j, atol=5e-6, rtol=0)


def test_plugin_hot_swap_and_odd_block(plugins):
    """Hot-swaps across the Tube Screamer's two members on one carried
    state, and a 1000-sample block (no multiple of 1024) that the exact
    engine serves with residual 0.0, from the same state as the scan
    engine and with its output."""
    jp, tp = plugins["scan"][0], tstream.make_plugin_processor(FS, engine="deer", device="cpu")
    scan = tstream.make_plugin_processor(FS, device="cpu")
    jscan = jstream.make_plugin_processor(FS)
    x = _signal(3, 3 * 1024, 0.5)
    for i, model in enumerate((0, 1, 0)):
        blk = x[i * 1024:(i + 1) * 1024]
        b = tp.process_block(blk, "tube_screamer", model=model, drive=0.3)
        a = scan.process_block(blk, "tube_screamer", model=model, drive=0.3)
        j = jscan.process_block(blk, "tube_screamer", model=model, drive=0.3)
        np.testing.assert_allclose(b, a, atol=2e-4, rtol=0, err_msg=f"block {i}")
        np.testing.assert_allclose(a, j, atol=2e-4, rtol=0, err_msg=f"block {i}")
    assert tp._state.keys() == jp._state.keys()
    odd = x[:1000]
    tp.reset()
    scan.reset()
    b = tp.process_block(odd, "tube_screamer", gain_db=2.0)
    a = scan.process_block(odd, "tube_screamer", gain_db=2.0)
    assert tp.last_residual["tube_screamer"] == 0.0
    np.testing.assert_allclose(b, a, atol=1e-6, rtol=0)


def test_hpf_processor_deer_matches_scan_and_jax():
    """The HPF clipper under deer (damped, adaptive, at most 48 sweeps):
    two carried 2048-blocks of the analytic member against the JAX deer
    processor and both scan engines, and the two neural members against
    the scan engines (tests/test_deer_circuit.py:203, :406), within 5e-4."""
    jdeer, jscan = jstream.make_hpf_processor(FS, engine="deer"), jstream.make_hpf_processor(FS)
    deer = tstream.make_hpf_processor(FS, engine="deer", device="cpu")
    scan = tstream.make_hpf_processor(FS, device="cpu")
    x = _signal(14, 4096, 1.0)
    for blk in (0, 1):
        xb = x[blk * 2048:(blk + 1) * 2048]
        b, a = deer.process_block(xb, "toms"), scan.process_block(xb, "toms")
        jb, ja = jdeer.process_block(xb, "toms"), jscan.process_block(xb, "toms")
        for want in (a, jb, ja):
            np.testing.assert_allclose(b, want, atol=5e-4, rtol=0, err_msg=f"block {blk}")
    x = _signal(17, 2048, 1.0)
    for name in ("extrapolated", "trained"):
        b = deer.process_block(x, name, cutoff_hz=3000.0)
        a = scan.process_block(x, name, cutoff_hz=3000.0)
        ja = jscan.process_block(x, name, cutoff_hz=3000.0)
        assert np.isfinite(b).all()
        np.testing.assert_allclose(b, a, atol=5e-4, rtol=0, err_msg=name)
        np.testing.assert_allclose(b, ja, atol=5e-4, rtol=0, err_msg=name)
    assert deer.fallbacks == {}
    assert set(deer.process_overrides) == set(jdeer.process_overrides) == set(deer.exact_runners)


def test_schemas_groups_and_surfaces_equal_jax():
    """Every factory registers the JAX processor's groups, schemas, param
    maps and surfaces, the default model choice included."""
    cases = [(jstream.make_plugin_processor(FS, clipper_zoo=z),
              tstream.make_plugin_processor(FS, clipper_zoo=z, device="cpu")) for z in (3, 9)]
    cases.append((jstream.make_hpf_processor(FS), tstream.make_hpf_processor(FS, device="cpu")))
    for jp, tp in cases:
        assert tp.surfaces() == jp.surfaces()
        assert tp.groups == jp.groups and list(tp.circuits) == list(jp.circuits)
        assert set(tp.param_maps) == set(jp.param_maps)
        assert {k: [s.to_dict() for s in v] for k, v in tp.param_schemas.items()} == \
               {k: [s.to_dict() for s in v] for k, v in jp.param_schemas.items()}
        for name in tp.surfaces():
            assert [s.to_dict() for s in tp.param_specs(name)] == \
                   [s.to_dict() for s in jp.param_specs(name)]
            assert tp._resolve(name, None) == jp._resolve(name, None)
    with pytest.raises(ValueError, match="zoo index"):
        tstream.make_plugin_processor(FS, clipper_zoo=12, device="cpu")
    for make in (tstream.make_plugin_processor, tstream.make_hpf_processor):
        with pytest.raises(ValueError, match="engine"):
            make(FS, engine="xla", device="cpu")


def test_kernel_sources_follow_the_structure():
    """warmup's sources: the generic DEER kernel for every member the
    generic engine serves, the generated exact kernel for the Tube
    Screamer's and the HPF's members; a knob change is the same source."""
    p = tstream.make_plugin_processor(FS, engine="deer", device="cpu")
    generic = [f"clipper/{i}" for i in range(2, 7)] + [f"multi_diode_clipper/{i}"
                                                       for i in range(5)]
    assert sorted(n for n in p.circuits if p._kernel_sources(n, {})) == \
        sorted(generic + ["tube_screamer/0", "tube_screamer/1"])
    for name in generic:
        (src,) = p._kernel_sources(name, {})
        assert "deer_cluster_kernel" in src and "nxh_forward_tangent" in src
    exact, deer = p._kernel_sources("tube_screamer/0", p.param_maps["tube_screamer"](0.1))
    assert "circuit_kernel" in exact and "deer_cluster_kernel" in deer and "omega_slope" in deer
    assert p._kernel_sources("tube_screamer/0", p.param_maps["tube_screamer"](0.9)) == \
        [exact, deer]
    hpf = tstream.make_hpf_processor(FS, device="cpu")
    assert all(len(hpf._kernel_sources(n, {})) == 1 for n in hpf.circuits)
    hpf_deer = tstream.make_hpf_processor(FS, engine="deer", device="cpu")
    assert all(len(hpf_deer._kernel_sources(n, {})) == 2 for n in hpf_deer.circuits)
    info = tstream.make_plugin_processor(FS, engine="deer", device="cpu").warmup(
        [1024], circuits=("tube_screamer",))
    # two members x (deer, exact fallback) x (no knob, the schema's default)
    assert info["n_compiled"] == 8


def test_port_deer_circuit_imports_no_jax():
    code = ("import sys\n"
            "import diffwdf_tpu_torch.runtime.stream, diffwdf_tpu_torch.ops.deer_circuit\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'diffwdf_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=REPO)
    assert proc.returncode == 0, proc.stderr
