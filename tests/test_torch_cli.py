"""The port's command line (``diffwdf_tpu_torch/cli.py``) against the JAX
package's (``diffwdf_tpu/cli.py``), on the CPU.

Counterpart of ``tests/test_cli.py`` (its three bench README tests stay
with the JAX package): each subcommand runs with the same arguments through
both packages (``--device cpu`` for the port, the JAX suite's CPU backend
for JAX) and the port's JSON line and output files are held to JAX's at the
JAX suite's budgets: the four ``simulate`` engines 5e-5 of each other and of
JAX's scan (``tests/test_cli.py:189-191``), artifacts 1e-5
(``tests/test_artifact.py:46``), the plugin processor's scan engine 1e-5
(2e-5 for a neural root), training histories rtol 5e-4 (pretraining from
JAX's initial weights and orders, fed in through the port's seams as
``tests/test_torch_pretrain.py`` does; circuit training from the same
pretrained root on the same data), component fits rtol 1e-3, the
transconductance error 1e-5 (1 + error).  Each JSON line of the port
carries ``"device"``; a bad choice, an unknown device and ``--device cuda``
with no card are refused.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from diffwdf_tpu.cli import main as jmain
from diffwdf_tpu_torch.cli import main as tmain

ZOO_2x4 = "models/pretrained/1N4148 (1U-1D)_2x4_pretrained_model.json"
ZOO_2x16 = "models/pretrained/1N4148 (1U-1D)_2x16_pretrained_model.json"
HIST_RTOL = 5e-4
ENGINES_ATOL = 5e-5


def port(*argv):
    tmain(["--device", "cpu", *argv])


def _rec(capsys) -> dict:
    lines = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")]
    return json.loads(lines[-1])


def _both(capsys, *argv):
    """(port record, JAX record) of one command line."""
    port(*argv)
    rec = _rec(capsys)
    jmain(list(argv))
    return rec, _rec(capsys)


def test_cli_pretrain_matches_jax(tmp_path, capsys, monkeypatch):
    from diffwdf_tpu.roots.neural import mlp_arch, mlp_init
    from diffwdf_tpu.training import pretrain as jpt
    from test_torch_pretrain import _feed, _orders

    args = ["pretrain", "--epochs", "5", "--width", "4", "--lr", "2e-3", "--schedule", "cosine",
            "--precision", "highest"]
    jmain(args + ["--out", str(tmp_path / "j.json")])
    out = capsys.readouterr().out
    assert "backend:" in out
    jrec = json.loads([l for l in out.splitlines() if l.startswith("{")][0])

    cfg = jpt.PretrainConfig(n_layers=2, layer_size=4, epochs=5)
    sizes, _ = mlp_arch(cfg.n_layers, cfg.layer_size)
    key, init_key = jax.random.split(jax.random.PRNGKey(cfg.seed))
    n = cfg.n_r * cfg.n_a
    _feed(monkeypatch, [mlp_init(init_key, sizes)], _orders(key, cfg, n, n // cfg.batch_size))
    port(*args, "--out", str(tmp_path / "t.json"))
    out = capsys.readouterr().out
    assert "device: cpu" in out
    rec = json.loads([l for l in out.splitlines() if l.startswith("{")][0])
    assert rec["arch"] == jrec["arch"] == "2x4" and rec["diode"] == jrec["diode"]
    assert rec["device"] == "cpu" and np.isfinite(rec["mse"])
    for k in ("mse", "esr"):
        np.testing.assert_allclose(rec[k], jrec[k], rtol=HIST_RTOL, err_msg=k)
    m, jm = json.load(open(tmp_path / "t.json")), json.load(open(tmp_path / "j.json"))
    assert m["in_shape"] == jm["in_shape"] == [None, 2]  # reference schema
    assert [l["activation"] for l in m["layers"]] == [l["activation"] for l in jm["layers"]]


def test_cli_params_reflection_matches_jax(capsys):
    rec, jrec = _both(capsys, "params", "--set", "plugin")
    assert rec.pop("device") == "cpu"
    assert rec == jrec
    assert set(rec["circuits"]) == {"clipper", "multi_diode_clipper", "tube_screamer"}
    port("params", "--set", "hpf", "--pretty")
    rec = json.loads(capsys.readouterr().out)
    jmain(["params", "--set", "hpf", "--pretty"])
    jrec = json.loads(capsys.readouterr().out)
    assert rec.pop("device") == "cpu" and rec == jrec and set(rec["circuits"]) == {"hpf"}


def test_cli_simulate_smoke_matches_jax(tmp_path, capsys):
    outs = {}
    for name, run in (("port", port), ("jax", lambda *a: jmain(list(a)))):
        f = tmp_path / f"{name}.npy"
        run("simulate", "--circuit", "tube_screamer", "--seconds", "0.05", "--drive", "0.8",
            "--out", str(f))
        outs[name] = np.load(f)
    assert outs["port"].shape == (2400,) and np.all(np.isfinite(outs["port"]))
    assert _rec(capsys)["samples"] == 2400
    np.testing.assert_allclose(outs["port"], outs["jax"], atol=ENGINES_ATOL)


def test_cli_simulate_wav_roundtrip(tmp_path, capsys):
    """WAV in, distorted mono WAV out at the file's rate, as the JAX command."""
    from scipy.io import wavfile

    from diffwdf_tpu_torch.data.audio import read_wav

    fs = 32000
    n = np.arange(int(0.05 * fs))
    sine = 0.9 * np.sin(2 * np.pi * 110.0 * n / fs)
    wav_in = tmp_path / "in.wav"
    wavfile.write(wav_in, fs, (np.stack([sine, sine], axis=1) * 32767).astype(np.int16))
    ys = {}
    for name in ("port", "jax"):
        wav_out = tmp_path / f"{name}.wav"
        argv = ["simulate", "--circuit", "clipper", "--fs", "48000", "--input", str(wav_in),
                "--out", str(wav_out)]
        port(*argv) if name == "port" else jmain(argv)
        rec = _rec(capsys)
        assert rec["samples"] == len(sine)
        fs_out, ys[name] = read_wav(str(wav_out))
        assert fs_out == fs  # the file's rate overrode --fs
    y = ys["port"]
    assert y.dtype == np.float32 and len(y) == len(sine)
    assert np.all(np.isfinite(y)) and 0 < np.max(np.abs(y)) < 1.5
    assert np.max(np.abs(y)) / np.sqrt(np.mean(y**2)) < np.sqrt(2.0)  # it clips
    np.testing.assert_allclose(y, ys["jax"], atol=ENGINES_ATOL)


@pytest.mark.parametrize("circuit", ["clipper", "tube_screamer"])
def test_cli_engines_agree(tmp_path, capsys, circuit):
    """scan / fused kernel / parallel-in-time / native give the same audio,
    and the same as the JAX package's scan engine."""
    outs = {}
    for eng in ("scan", "fused", "pint", "native"):
        f = tmp_path / f"{eng}.npy"
        port("simulate", "--circuit", circuit, "--seconds", "0.02", "--engine", eng,
             "--out", str(f))
        rec = _rec(capsys)
        assert rec["engine"] == eng and rec["device"] == "cpu"
        outs[eng] = np.load(f)
    f = tmp_path / "jax.npy"
    jmain(["simulate", "--circuit", circuit, "--seconds", "0.02", "--out", str(f)])
    for eng in ("fused", "pint", "native"):
        np.testing.assert_allclose(outs["scan"], outs[eng], atol=ENGINES_ATOL, err_msg=eng)
    np.testing.assert_allclose(outs["scan"], np.load(f), atol=ENGINES_ATOL)


def _wav(tmp_path, fs, seconds, amp, f0):
    from diffwdf_tpu_torch.data.audio import write_wav

    n = np.arange(int(seconds * fs))
    x = amp * np.sin(2 * np.pi * f0 * n / fs).astype(np.float32)
    path = tmp_path / "in.wav"
    write_wav(str(path), fs, x)
    return str(path), x


def _process_both(tmp_path, capsys, *argv):
    """Run ``process`` through both packages: (port record, port output,
    JAX record, JAX output)."""
    got = []
    for name in ("port", "jax"):
        out = str(tmp_path / f"{name}.npy")
        full = ["process", *argv, "--out", out]
        port(*full) if name == "port" else jmain(full)
        got += [_rec(capsys), np.load(out)]
    return got


def test_cli_process_warmup_flag(tmp_path, capsys):
    """--warmup builds the served circuit's block variants first, and the
    output equals a cold run's."""
    from diffwdf_tpu_torch.data.audio import read_wav

    wav_in, _ = _wav(tmp_path, 24000, 2048 / 24000, 0.5, 330.0)
    ys = {}
    for warm in (False, True):
        out = tmp_path / f"{warm}.wav"
        port("process", "--input", wav_in, "--circuit", "clipper", "--block", "1024",
             *(["--warmup"] if warm else []), "--out", str(out))
        rec = _rec(capsys)
        assert (rec["warmup_s"] > 0.0) == warm
        ys[warm] = read_wav(str(out))[1]
    np.testing.assert_array_equal(ys[False], ys[True])


def test_cli_process_plugin_parity(tmp_path, capsys):
    """Blocks through the plugin processor with the reference's knobs (gain
    dB, cutoff) and carried state, against the JAX command."""
    wav_in, x = _wav(tmp_path, 24000, 0.2, 0.8, 220.0)
    rec, y, jrec, jy = _process_both(tmp_path, capsys, "--input", wav_in, "--circuit", "clipper",
                                     "--gain-db", "12", "--cutoff", "2000", "--block", "1024")
    assert rec["samples"] == jrec["samples"] == len(x) and rec["fs"] == jrec["fs"] == 24000
    assert rec["blocks"] == jrec["blocks"] == -(-len(x) // 1024) and rec["load"] >= 0
    assert np.all(np.isfinite(y)) and 0 < np.max(np.abs(y)) < 1.5
    assert np.max(np.abs(y)) / np.sqrt(np.mean(y**2)) < np.sqrt(2.0)
    np.testing.assert_allclose(y, jy, atol=1e-5)


@pytest.mark.parametrize("model,atol", [(0, 1e-5), (4, 2e-5)])
def test_cli_process_zoo_model_choice(tmp_path, capsys, model, atol):
    """--model picks the clipper root from the 12-entry zoo; neural entries
    load the checked-in pretrained weights."""
    wav_in, _ = _wav(tmp_path, 24000, 0.1, 1.0, 220.0)
    rec, y, jrec, jy = _process_both(tmp_path, capsys, "--input", wav_in, "--circuit", "clipper",
                                     "--model", str(model))
    assert rec["circuit"] == jrec["circuit"] == "clipper" and np.all(np.isfinite(y))
    np.testing.assert_allclose(y, jy, atol=atol)


def test_cli_process_deer_engine(tmp_path, capsys):
    """--engine deer (B5's plain version on the CPU) against the scan engine,
    and the multi-diode choice (zoo 7)."""
    wav_in, _ = _wav(tmp_path, 24000, 2048 / 24000, 0.5, 330.0)
    ys = {}
    for eng in ("scan", "deer"):
        out = str(tmp_path / f"{eng}.npy")
        port("process", "--input", wav_in, "--block", "1024", "--engine", eng, "--out", out)
        assert _rec(capsys)["blocks"] == 2
        ys[eng] = np.load(out)
    np.testing.assert_allclose(ys["deer"], ys["scan"], atol=2e-4)
    out = str(tmp_path / "md.npy")
    port("process", "--input", wav_in, "--block", "1024", "--model", "7", "--out", out)
    assert _rec(capsys)["circuit"] == "multi_diode_clipper"
    assert np.all(np.isfinite(np.load(out)))


@pytest.mark.parametrize("argv", [
    ["pretrain", "--precision", "bogus"],
    ["simulate", "--engine", "xla"],
    ["--device", "tpu", "params"],
    ["export-artifact", "--model", "12"],
])
def test_cli_rejects_bad_choice(argv):
    with pytest.raises(SystemExit):
        tmain(argv)


def test_cli_refuses_cuda_without_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        tmain(["params"])


def test_cli_fit_components_matches_jax(capsys):
    rec, jrec = _both(capsys, "fit-components", "--circuit", "divider", "--epochs", "30")
    assert rec["device"] == "cpu"
    np.testing.assert_allclose(rec["loss"], jrec["loss"], rtol=1e-3)
    for name in ("R1", "R2"):
        np.testing.assert_allclose(rec["params"][name]["R"], jrec["params"][name]["R"],
                                   rtol=1e-3)


@pytest.fixture(scope="module")
def clipper_data(tmp_path_factory):
    """A small synthetic measurement set of the 1U-1D pair (the JAX
    package's generator, 3 s a file: 0.5 s left after the importer's trim)
    and the JAX command's scan-engine run on it: (data dir, JAX weights,
    JAX final loss)."""
    import diffwdf_tpu as jdwdf
    from diffwdf_tpu.data.synthetic import make_synthetic_dataset_dir

    base = tmp_path_factory.mktemp("data")
    make_synthetic_dataset_dir(str(base / "set"), jdwdf.diode_1n4148_1u1d, duration_s=3.0)
    out = str(base / "jax.json")
    jmain(["train-clipper", "--data-dir", str(base / "set"), "--pretrained", ZOO_2x4,
           "--epochs", "2", "--batch-size", "512", "--max-chunks", "4", "--out", out,
           "--log", str(base / "jax.jsonl")])
    return str(base / "set"), json.load(open(out)), str(base / "jax.jsonl")


@pytest.mark.parametrize("engine", ["scan", "fused", "fused_generic"])
def test_cli_train_clipper_matches_jax(tmp_path, capsys, clipper_data, engine):
    """Every engine from the same pretrained root on the same data against
    the JAX command's scan engine: the first epoch's logged loss (rtol
    5e-4) and the saved weights."""
    data, jweights, jlog = clipper_data
    out, log = str(tmp_path / "t.json"), str(tmp_path / "t.jsonl")
    port("train-clipper", "--data-dir", data, "--pretrained", ZOO_2x4, "--epochs", "2",
         "--batch-size", "512", "--max-chunks", "4", "--engine", engine, "--out", out,
         "--log", log)
    rec = _rec(capsys)
    assert rec["engine"] == engine and rec["train_chunks"] == 4 and rec["val_chunks"] == 4
    assert len(rec["loss"]) == 2 and np.all(np.isfinite(rec["loss"]))
    got, want = [json.loads(l) for l in open(log)], [json.loads(l) for l in open(jlog)]
    assert [r["step"] for r in got] == [r["step"] for r in want] == [0]
    for k in ("loss", "mse", "esr", "val_loss"):
        np.testing.assert_allclose(got[0][k], want[0][k], rtol=HIST_RTOL, err_msg=k)
    for lt, lj in zip(json.load(open(out))["layers"], jweights["layers"]):
        np.testing.assert_allclose(np.asarray(lt["weights"][0]), np.asarray(lj["weights"][0]),
                                   atol=1e-5)


def _jax_kernel_on_check_input(block):
    """The JAX package's generated kernel (``fused_circuit_process`` in
    interpret mode, as its suite runs it on the CPU) on the check input of
    ``export-artifact --check`` for the Tube Screamer, and the JAX scan."""
    import jax.numpy as jnp

    from diffwdf_tpu.models.tube_screamer import make_tube_screamer
    from diffwdf_tpu.ops.fused_circuit import fused_circuit_process
    from diffwdf_tpu.roots.diode import DiodePairRoot

    root = DiodePairRoot(name="dp")
    ckt = make_tube_screamer(root, 48000.0, drive=0.5)
    params = {**ckt.init_params(), **root.init_params()}
    x = (2.0 * np.sin(2 * np.pi * 220.0 * np.arange(4 * block) / 48000.0)).astype(np.float32)
    vin = jnp.asarray(np.broadcast_to(x, (1024, len(x))).copy())  # the kernel's tile
    st0 = jax.tree_util.tree_map(lambda z: jnp.zeros((1024,), jnp.float32), ckt.init_state())
    out, _ = fused_circuit_process(ckt, params, vin, st0, input_node="Vin", lanes=128,
                                   interpret=True)
    scan, _ = ckt.process(params, ckt.init_state(), {"Vin": {"v": jnp.asarray(x)}})
    return x, np.asarray(out[0]), np.asarray(scan)


@pytest.mark.parametrize("argv,amp", [(["--model", "4"], 0.8),
                                      (["--circuit", "tube_screamer"], 0.5)])
def test_cli_export_artifact_matches_jax(tmp_path, capsys, argv, amp):
    """``export-artifact --check`` then ``run-artifact``, against the JAX
    commands.  The check holds the artifact to ``Circuit.process`` on a 2-V
    sine: 1e-5 for the clipper (B1's op); the Tube Screamer's generated
    kernel (B7's op) amplifies f32 rounding there, and the JAX package's own
    kernel lies as far from its scan (2.3e-5), so there the check, and the
    artifact against the JAX kernel on the same input, are held to the
    engines' 5e-5 (tests/test_cli.py:189-191).  ``run-artifact`` serves the inputs of
    tests/test_artifact.py (0.8 V for the clipper, 0.5 V for the Tube
    Screamer)."""
    recs, ys = {}, {}
    inp = str(tmp_path / "x.npy")
    np.save(inp, (amp * np.sin(2 * np.pi * 330.0 * np.arange(600) / 48000.0))
            .astype(np.float32))
    for name, run, ext in (("port", port, "pt2"), ("jax", lambda *a: jmain(list(a)), "npz")):
        art = str(tmp_path / f"a.{ext}")
        run("export-artifact", *argv, "--block", "256", "--check", "--out", art)
        recs[name] = _rec(capsys)
        run("run-artifact", "--artifact", art, "--input", inp,
            "--out", str(tmp_path / f"{name}.npy"))
        ys[name] = np.load(tmp_path / f"{name}.npy")
    for k in ("block_len", "fs", "n_state"):
        assert recs["port"][k] == recs["jax"][k]
    assert recs["port"]["device"] == "cpu"
    np.testing.assert_allclose(ys["port"], ys["jax"], atol=1e-5)
    if "tube_screamer" not in argv:
        assert recs["port"]["check_max_abs_err"] < 1e-5
        return
    assert recs["port"]["kernel"] == "B7 circuit_forward"
    assert recs["port"]["check_max_abs_err"] < ENGINES_ATOL
    x, jkernel, jscan = _jax_kernel_on_check_input(256)
    from diffwdf_tpu_torch.runtime.artifact import load_artifact

    y = load_artifact(str(tmp_path / "a.pt2"), device="cpu").run(x)
    assert np.max(np.abs(y - jkernel)) < ENGINES_ATOL
    # the JAX kernel itself lies beyond 1e-5 of its scan on this input
    assert np.max(np.abs(jkernel - jscan)) > 1e-5


def test_cli_plot_matches_jax(tmp_path, capsys):
    pytest.importorskip("matplotlib")
    hist = tmp_path / "h.jsonl"
    hist.write_text("".join(json.dumps({"step": i, "loss": 1.0 / (i + 1), "mse": 0.5 / (i + 1)})
                            + "\n" for i in range(6)))
    rec, jrec = _both(capsys, "plot", "history", "--history", str(hist),
                      "--out", str(tmp_path / "h.png"))
    assert rec["epochs"] == jrec["epochs"] == 6 and os.path.getsize(tmp_path / "h.png") > 0
    rec, jrec = _both(capsys, "plot", "transconductance", "--model-json", ZOO_2x16,
                      "--out", str(tmp_path / "g.png"))
    assert rec["diode"] == jrec["diode"] and rec["device"] == "cpu"
    want = jrec["physics_rms_rel_err"]
    assert rec["physics_rms_rel_err"] == pytest.approx(want, rel=0, abs=1e-5 * (1 + want))


def test_cli_bench_small(capsys, monkeypatch):
    """The bench headline's line at a small shape on the CPU (its plain version)."""
    import diffwdf_tpu_torch.cli as cli

    monkeypatch.setattr(cli, "BENCH_B", 32)
    monkeypatch.setattr(cli, "BENCH_T", 64)
    monkeypatch.setattr(cli, "BENCH_REPS", 2)
    port("bench")
    rec = _rec(capsys)
    assert rec["metric"] == "diode_clipper_neural2x16_throughput_per_chip"
    assert rec["B"] == 32 and rec["T"] == 64 and rec["fs"] == 96000.0
    assert rec["value"] > 0 and np.isfinite(rec["ms"]) and rec["timer"] == "host_clock"
    assert rec["card"] is None and rec["device"] == "cpu"
