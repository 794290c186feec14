"""diffwdf_tpu_torch's analysis helpers and WAV I/O vs the JAX package, and
the port's independence of JAX.

``transconductance`` on the same weights gives JAX's (v, i) within 1e-6 of
each array's largest magnitude (the MLP's f32 sums round differently in the
two packages: up to 4 ulp of v).  ``transconductance_error`` compares a
diode current that grows as exp(v / (nabla Vt)) with the model's, so those
ulps of v (4.8e-7 at |v| <= 5) move the Shockley current by up to
4.8e-7 / 0.049 ~ 1e-5 of itself: the metric is held to JAX's within
1e-5 (1 + error).  The plots need matplotlib (skipped without
it) and write files; ``read_wav`` / ``write_wav`` round-trip and read what
the JAX package's writer wrote; ``load_history`` reads JSONL and pickles.
The last test greps the port and chip_smoke.py for any import of JAX or of
the JAX package.
"""

import json
import pickle
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from diffwdf_tpu import analysis as jan
from diffwdf_tpu.data import audio as jaudio
from diffwdf_tpu.nn.serialization import load_model_json as jax_load_model_json
from diffwdf_tpu.roots.diode import diode_1n4148_1u1d as jax_diode
from diffwdf_tpu.roots.neural import mlp_arch, mlp_init
from diffwdf_tpu_torch import analysis as tan
from diffwdf_tpu_torch.data import audio as taudio
from diffwdf_tpu_torch.nn.serialization import load_model_json
from diffwdf_tpu_torch.roots.diode import diode_1n4148_1u1d

REPO = Path(__file__).resolve().parents[1]
ZOO_2X16 = REPO / "models/pretrained/1N4148 (1U-1D)_2x16_pretrained_model.json"


def _random_mlp(seed=0):
    sizes, acts = mlp_arch(2, 16)
    mlp = mlp_init(jax.random.PRNGKey(seed), sizes)
    port = {"layers": [{k: torch.tensor(np.asarray(l[k])) for k in l} for l in mlp["layers"]]}
    return mlp, port, acts


def test_transconductance_matches_jax():
    mlp, port, acts = _random_mlp()
    want = jan.transconductance(mlp, acts)
    got = tan.transconductance(port, acts)
    assert sorted(got) == sorted(want)
    for r in want:
        for a, b in zip(got[r], want[r]):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6 * np.abs(b).max())


@pytest.mark.parametrize("r", [1000.0, 10e3, 47e3])
def test_transconductance_error_matches_jax(r):
    jmlp, jacts, _ = jax_load_model_json(str(ZOO_2X16))
    mlp, acts, _ = load_model_json(ZOO_2X16, device="cpu")
    want = jan.transconductance_error(jmlp, jacts, jax_diode, r=r)
    got = tan.transconductance_error(mlp, acts, diode_1n4148_1u1d, r=r)
    assert got == pytest.approx(want, rel=0, abs=1e-5 * (1 + want))
    if r >= 10e3:
        assert got < 1.0  # physically consistent at the clipper's serving impedance


def test_transconductance_error_of_a_random_net_is_large():
    jmlp, port, acts = _random_mlp()
    got = tan.transconductance_error(port, acts, diode_1n4148_1u1d)
    assert got > 0.1
    want = jan.transconductance_error(jmlp, acts, jax_diode)
    assert got == pytest.approx(want, rel=0, abs=1e-5 * (1 + want))


def test_plot_outputs(tmp_path):
    pytest.importorskip("matplotlib")
    hist = {"loss": list(np.geomspace(1, 1e-3, 50)),
            "val_loss": list(np.geomspace(2, 2e-3, 50))}
    p1, p2, p3 = (str(tmp_path / f) for f in ("hist.png", "trans.png", "tp.png"))
    tan.plot_history(hist, p1)
    _, port, acts = _random_mlp()
    tan.plot_transconductance(port, acts, diode_1n4148_1u1d, p2)
    t = np.sin(np.linspace(0, 20, 500))
    tan.plot_target_pred(t, t * 0.9, p3, "test")
    for p in (p1, p2, p3):
        assert Path(p).stat().st_size > 1000


def test_load_history_jsonl_and_pickle(tmp_path):
    hist = {"loss": [1.0, 0.5], "val_loss": [2.0, 1.0]}
    with open(tmp_path / "h.pkl", "wb") as f:
        pickle.dump(hist, f)
    assert tan.load_history(tmp_path / "h.pkl") == hist
    with open(tmp_path / "h.jsonl", "w") as f:
        for i in range(2):
            f.write(json.dumps({"epoch": i, "loss": hist["loss"][i],
                                "val_loss": hist["val_loss"][i]}) + "\n")
    h2 = tan.load_history(tmp_path / "h.jsonl")
    assert h2 == jan.load_history(tmp_path / "h.jsonl")
    assert h2["loss"] == hist["loss"] and "epoch" not in h2


@pytest.mark.parametrize("dtype", ["float32", "int16", "stereo"])
def test_wav_round_trip(tmp_path, dtype):
    from scipy.io import wavfile

    x = (0.5 * np.sin(np.linspace(0, 40, 4800))).astype(np.float32)
    path = str(tmp_path / "a.wav")
    if dtype == "float32":
        taudio.write_wav(path, 48000.0, x)
        want = x
    elif dtype == "int16":
        wavfile.write(path, 48000, (x * 32767).astype(np.int16))
        want = (x * 32767).astype(np.int16).astype(np.float32) / 32768.0
    else:
        wavfile.write(path, 48000, np.stack([x, -0.5 * x], axis=1))
        want = 0.25 * x
    fs, got = taudio.read_wav(path)
    jfs, jgot = jaudio.read_wav(path)
    assert fs == jfs == 48000.0 and got.dtype == np.float32
    np.testing.assert_array_equal(got, jgot)
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_port_imports_no_jax():
    """No module of the port and not chip_smoke.py imports JAX, optax or the
    JAX package (the *_REPLACES strings only name file:line locations)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|optax|diffwdf_tpu)(\.|\s|$)", re.M)
    files = sorted((REPO / "diffwdf_tpu_torch").rglob("*.py")) + [REPO / "chip_smoke.py"]
    hits = [f"{f.relative_to(REPO)}: {m.group(0).strip()}" for f in files
            for m in pat.finditer(f.read_text())]
    assert not hits, hits
    assert len(files) > 40
