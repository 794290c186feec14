"""The port's own spans and counters (``runtime/profiler.py``) on the CPU.

Off, a span touches nothing of ``torch.profiler``; on, each ``wdf.*``
record holds the kineto range of its name, on the profiler's clock, and
nests by parent and unit (a span on another thread joins the open unit);
the program and library caches show as unmoved counters; ``h2d`` counts a
copy of a host value and nothing else, and ``init_state`` makes its zeros
on the device with none; and the benchmark's readers of the
spans (``wdfbench/spans.py``) give every new metric of a cell of each kind
in a traced run of the small benchmark.
"""

import hashlib
import json
import math
import shutil
import sys
import threading
from pathlib import Path

import pytest
import torch

from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper
from diffwdf_tpu_torch.models.simple_circuits import make_rl_highpass
from diffwdf_tpu_torch.models.tube_screamer import make_tube_screamer
from diffwdf_tpu_torch.ops import fused_circuit
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.runtime import profiler
from wdfbench import harness, inputs
from wdfbench.systems import lpf_clipper, tube_screamer
from wdfbench.tests.conftest import small_root

REPO = Path(__file__).resolve().parents[1]
ACTS = ["tanh", "tanh", "tanh", ""]


def _cfg(name):
    return json.loads((REPO / "wdfbench" / "configs" / f"{name}.json").read_text())


def _ts_call():
    """One serving call of the Tube Screamer 2x16 (B7's plain version)."""
    mlp = {"layers": inputs.seeded_mlp([2, 16, 16, 16, 1], 11, "cpu")}
    call, zero_state, _ = tube_screamer.server(_cfg("ts_2x16"), mlp, "cpu")
    v = 0.2 * torch.randn(3, 12, generator=torch.Generator().manual_seed(0))
    return lambda: call(v, zero_state(3))


def _clipper_step():
    """One fused-engine training step of a small LPF clipper (B3, B4 and the
    parameter VJP in their plain versions)."""
    mlp = {"layers": inputs.seeded_mlp([2, 4, 4, 4, 1], 12, "cpu")}
    g = torch.Generator().manual_seed(1)
    x = torch.randn(4, 64, generator=g)
    batches = {"x": x, "y": 0.7 * torch.tanh(1.5 * x),
               "r0": torch.tensor([1e4, 2.5e4, 7.5e4, 9.9e4])}
    step, _, _ = lpf_clipper.trainer(_cfg("clipper_2x16"), mlp, batches)
    return step


@pytest.fixture
def fresh():
    profiler.clear_spans()
    yield
    profiler.clear_spans()


def test_off_spans_touch_no_profiler(fresh, monkeypatch):
    call, step = _ts_call(), _clipper_step()

    def refuse(*a, **k):
        raise AssertionError("a span opened a profiler range with no profiler recording")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    out, _ = call()
    metrics = step()
    assert torch.isfinite(out).all() and math.isfinite(float(metrics["loss"]))
    assert profiler.spans() == [] and profiler.dropped_spans() == 0


def _kineto_ranges(prof):
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("wdf.") and e.device_type() == torch.autograd.DeviceType.CPU:
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.end_ns()))
    return ranges


def test_records_hold_their_kineto_range(fresh):
    call, step = _ts_call(), _clipper_step()
    call()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        call()
        step()
    ranges = _kineto_ranges(prof)
    recs = profiler.spans()
    names = {r.name for r in recs}
    assert {"wdf.call", "wdf.prepare", "wdf.adapt", "wdf.codegen", "wdf.slots", "wdf.train_step",
            "wdf.loss", "wdf.backward", "wdf.bptt", "wdf.param_pass", "wdf.adam"} <= names
    assert set(ranges) == names
    for name in names:
        mine = sorted((r.start_ns, r.end_ns) for r in recs if r.name == name)
        theirs = sorted(ranges[name])
        assert len(mine) == len(theirs), name
        for (s, e), (ks, ke) in zip(mine, theirs):
            assert s <= ks and ke <= e, (name, ks - s, e - ke)
            assert e - ke < 1_000_000, (name, e - ke)


def test_parents_and_units_nest(fresh, monkeypatch):
    step = _clipper_step()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        step()
        step()
    recs = profiler.spans()
    by_id = {r.id: r for r in recs}
    roots = [r for r in recs if r.parent == -1]
    assert [r.name for r in roots] == ["wdf.train_step"] * 2
    assert roots[0].unit != roots[1].unit
    for r in recs:
        if r.parent != -1:
            assert by_id[r.parent].unit == r.unit
            assert by_id[r.parent].start_ns <= r.start_ns <= r.end_ns <= by_id[r.parent].end_ns

    def parent(name):
        return {by_id[r.parent].name for r in recs if r.name == name}

    assert parent("wdf.loss") == parent("wdf.backward") == parent("wdf.adam") == {
        "wdf.train_step"}
    assert parent("wdf.bptt") == {"wdf.backward"}
    assert parent("wdf.param_pass") == {"wdf.bptt"}

    # a span opened on another thread while a unit is open joins it, under
    # the innermost span that unit has open (as autograd's device thread does)
    profiler.clear_spans()
    monkeypatch.setattr(profiler, "_recording", lambda: True)
    seen = threading.Event()

    def other():
        with profiler.span("wdf.other"):
            pass
        seen.set()

    with profiler.span("wdf.outer"):
        with profiler.span("wdf.inner"):
            t = threading.Thread(target=other)
            t.start()
            t.join()
    with profiler.span("wdf.next"):
        pass
    assert seen.is_set()
    r = {x.name: x for x in profiler.spans()}
    assert r["wdf.other"].unit == r["wdf.inner"].unit == r["wdf.outer"].unit
    assert r["wdf.other"].parent == r["wdf.inner"].id and r["wdf.other"].thread != r[
        "wdf.inner"].thread
    assert r["wdf.next"].parent == -1 and r["wdf.next"].unit != r["wdf.outer"].unit


def test_second_prepare_hits_the_caches():
    mlp = {"layers": inputs.seeded_mlp([2, 8, 8, 8, 1], 13, "cpu")}
    root, _ = NeuralDiodeRoot.from_mlp("dp", mlp, ACTS)
    circuit = make_tube_screamer(root, 48000.0, drive=0.3)
    params = circuit.init_params("cpu")
    del params["dp"]
    c0 = profiler.counters()
    fused_circuit.prepare(circuit, params, "cpu", input_node="Vin", neural_mlp=mlp)
    c1 = profiler.counters()
    fused_circuit.prepare(circuit, params, "cpu", input_node="Vin", neural_mlp=mlp)
    c2 = profiler.counters()
    assert c1["programs_generated"] == c0["programs_generated"] + 1  # a new circuit
    for name in ("programs_generated", "libraries_loaded"):
        assert c2[name] == c1[name], name


def test_h2d_counts_host_copies_only(fresh):
    c0 = profiler.counters()
    x = profiler.h2d(torch.ones(3, dtype=torch.float64), "meta")
    y = profiler.h2d(2.5, torch.device("meta"))
    c1 = profiler.counters()
    assert x.device.type == y.device.type == "meta" and x.dtype == y.dtype == torch.float32
    assert c1["h2d_copies"] - c0["h2d_copies"] == 2
    assert c1["h2d_bytes"] - c0["h2d_bytes"] == 3 * 4 + 4
    z = torch.ones(3)
    assert profiler.h2d(z, "cpu").data_ptr() == z.data_ptr()  # no copy
    assert profiler.h2d(z, "cpu", None).data_ptr() == z.data_ptr()
    assert profiler.counters() == c1
    assert profiler.spans() == []  # no profiler: no span


def _circuit_for_state(name):
    """The Tube Screamer (three capacitors), the LPF clipper (one) or the RL
    high-pass (an inductor)."""
    if name == "rl_highpass":
        return make_rl_highpass(48000.0)
    mlp = {"layers": inputs.seeded_mlp([2, 4, 4, 4, 1], 14, "cpu")}
    root, _ = NeuralDiodeRoot.from_mlp("dp", mlp, ACTS)
    if name == "tube_screamer":
        return make_tube_screamer(root, 48000.0, drive=0.5)
    return make_diode_clipper(root, 48000.0)


@pytest.mark.parametrize("name", ["tube_screamer", "lpf_clipper", "rl_highpass"])
def test_init_state_makes_no_host_copy(name, fresh):
    """The zero states are made on the device: no copy of a host value (on a
    card, none that waits for the queue), and every state the f32 0-d zero
    that a host copy of 0.0 gave."""
    circuit = _circuit_for_state(name)
    c0 = profiler.counters()
    meta = circuit.init_state("meta")
    assert profiler.counters()["h2d_copies"] == c0["h2d_copies"]
    assert profiler.counters()["h2d_bytes"] == c0["h2d_bytes"]
    cpu = circuit.init_state("cpu")
    leaves = [(n, f) for n, fields in cpu.items() for f in fields]
    assert leaves and leaves == [(n, f) for n, fields in meta.items() for f in fields]
    for n, f in leaves:
        assert meta[n][f].device.type == "meta" and meta[n][f].dtype == torch.float32
        assert meta[n][f].shape == ()
        assert torch.equal(cpu[n][f], torch.tensor(0.0)), (n, f)
        assert cpu[n][f].dtype == torch.float32 and cpu[n][f].shape == ()
    assert cpu[leaves[0][0]][leaves[0][1]] is not circuit.init_state("cpu")[leaves[0][0]][
        leaves[0][1]]  # a fresh zero each call, none kept
    assert profiler.spans() == []


def test_threads_lose_no_count_nor_record(fresh, monkeypatch):
    """More threads than cores, switching often: every count and every
    record of every thread's spans arrives, each with its own id."""
    monkeypatch.setattr(profiler, "_recording", lambda: True)
    monkeypatch.setitem(profiler._counts, "libraries_loaded", 0)
    n_threads, n = 24, 300
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work():
            for _ in range(n):
                with profiler.span("wdf.stress"):
                    profiler.count("libraries_loaded")

        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(switch)
    assert profiler.counters()["libraries_loaded"] == n_threads * n
    recs = profiler.spans()
    assert len(recs) == n_threads * n and len({r.id for r in recs}) == len(recs)


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "wdfbench").rglob("*")) if p.is_file()}


@pytest.mark.parametrize("workload", ["clipper_2x16.serve_2k", "ts_2x16.train_8192"])
def test_traced_run_reports_the_span_metrics(workload, tmp_path, fresh):
    root = small_root(tmp_path / "root")
    before = _digest(root)
    bench = json.loads((root / "BENCHMARK.json").read_text())
    new = [m["name"] for m in bench["per_layer"]
           if workload in m["workloads"] and "wdfbench.spans" in
           (root / "wdfbench" / "metrics" / f"{m['name']}.py").read_text()]
    assert len(new) == {"clipper_2x16.serve_2k": 3, "ts_2x16.train_8192": 4}[workload]
    r = harness.run_cell(root, workload, 2**31 + 9, 0.1, True, "cpu", log=open("/dev/null", "w"))
    assert r["correct"], r["checks"]
    for name in new:
        assert math.isfinite(r["metrics"][name]["value"]), name
    after = _digest(root)
    assert all(after[p] == h for p, h in before.items())
    shutil.rmtree(root)


def test_b8_pass3_span_nests_in_param_pass(fresh, monkeypatch):
    """The Tube Screamer root's pass 3 (``parallel_bptt.root_param_vjp``):
    its launch's span ``wdf.launch.B8.pass3`` opens inside
    ``wdf.param_pass`` and ``B8.pass3`` counts one a call, ``B4.pass3`` (the
    clipper's) none.  On the CPU the launch is a stand-in that opens the
    span it is given around the plain VJP, as the kernel's wrapper does.
    Pass 3 runs only where a root leaf needs its cotangent."""
    from diffwdf_tpu_torch.ops import clipper_train as ct
    from diffwdf_tpu_torch.ops import parallel_bptt as pb

    mlp = {"layers": inputs.seeded_mlp([2, 4, 4, 4, 1], 14, "cpu")}
    root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, ACTS)
    circuit = make_tube_screamer(root, 48000.0, drive=0.5)
    params = {**circuit.init_params("cpu"), **frag}
    g = torch.Generator().manual_seed(2)
    B, T = 3, 16
    vin, g_out = torch.randn(B, T, generator=g), torch.randn(B, T, generator=g)
    z_prev = [torch.randn(B, T, generator=g) for _ in range(3)]
    lam_step = [torch.randn(B, T, generator=g) for _ in range(3)]
    streams = pb.RootStreams(torch.randn(B, T, generator=g), torch.randn(B, T, generator=g),
                             torch.full((B,), 8.0))
    names = []

    def launch(mlp, a, log_r, G, launch_span):
        names.append(launch_span)
        with profiler.span(launch_span):
            return ct.mlp_param_vjp_plain(mlp, ACTS, a, log_r, G)

    monkeypatch.setattr(ct, "launch_param_vjp", launch)
    assert "B8.pass3" in profiler.counters()
    c0 = profiler.counters()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with profiler.span("wdf.bptt"):
            grads = pb.parameter_cotangents(circuit, params, vin, z_prev, g_out, lam_step,
                                            input_node="Vin", root=streams)
    c1 = profiler.counters()
    assert names == ["wdf.launch.B8.pass3"]
    assert c1["B8.pass3"] - c0["B8.pass3"] == 1 and c1["B4.pass3"] == c0["B4.pass3"]
    recs = profiler.spans()
    by_id = {r.id: r for r in recs}
    (launch_rec,) = [r for r in recs if r.name == "wdf.launch.B8.pass3"]
    assert by_id[launch_rec.parent].name == "wdf.param_pass"
    want = ct.mlp_param_vjp_plain(mlp, ACTS, streams.a_seq, streams.log_r, streams.G)
    leaves, _ = pb._flatten(params)
    at = {id(x): k for k, x in enumerate(ct.mlp_leaves(mlp))}
    assert all(torch.equal(grads[i], want[at[id(x)]]) for i, x in enumerate(leaves) if id(x) in at)
    needs = [id(x) not in at for x in leaves]
    pb.parameter_cotangents(circuit, params, vin, z_prev, g_out, lam_step, input_node="Vin",
                            root=streams, needs=needs)
    assert profiler.counters()["B8.pass3"] == c1["B8.pass3"] and len(names) == 1
