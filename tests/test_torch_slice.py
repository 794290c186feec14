"""The port's first slice end to end: batched diode-clipper serving.

Zoo entries 4 (pretrained neural 2x16) and 0 (analytic, quality "best") are
built through ``make_root_from_zoo`` and ``make_diode_clipper`` in both
packages.  Four consecutive request blocks with the capacitor state carried
between them go through ``chip_smoke.block_server`` (on the CPU: the
kernels' plain versions) and through the JAX package's fused kernels
(interpret mode) and its scan over the whole signal.  Budgets: analytic
atol 5e-6, neural atol 2e-5.
"""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from diffwdf_tpu.models import diode_clipper as jdc
from diffwdf_tpu.ops import fused_clipper as jfc
from diffwdf_tpu_torch.models import diode_clipper as tdc
from diffwdf_tpu_torch.ops import fused_clipper as tfc

REPO = Path(__file__).resolve().parents[1]
FS = 96000.0
B, T, BLOCKS = 1024, 64, 4


def _jax_blocks(index, vin):
    """JAX: the zoo root's fused kernel over the blocks, state carried, and
    the scan over the whole signal."""
    root, rp = jdc.make_root_from_zoo(index)
    ckt = jdc.make_diode_clipper(root, FS)
    params = {**ckt.init_params(), **rp}
    r, c = params["Vs"]["R"], params["C"]["C"]
    z, outs = jnp.zeros((B,), jnp.float32), []
    for i in range(BLOCKS):
        blk = jnp.asarray(vin[:, i * T:(i + 1) * T])
        if index == 0:
            p = params["dp"]
            out, z = jfc.fused_clipper_analytic(
                blk, z, r, c, p["Is"], p["nabla"] * p["Vt"], p["N_up"], p["N_down"],
                fs=FS, quality_iters=root.iters, interpret=True)
        else:
            out, z = jfc.fused_clipper_neural(blk, z, params["dp"], r, c, fs=FS, interpret=True)
        outs.append(np.asarray(out))
    state = ckt.init_state()
    scan = np.stack([np.asarray(ckt.process(params, state, {"Vs": {"v": jnp.asarray(v)}})[0])
                     for v in vin[:8]])
    return np.concatenate(outs, axis=1), np.asarray(z), scan


@pytest.mark.parametrize("index,budget", [(4, 2e-5), (0, 5e-6)])
def test_served_blocks_match_jax(index, budget):
    vin = (2.0 * np.random.default_rng(index).standard_normal((B, BLOCKS * T))).astype(np.float32)
    want, want_z, scan = _jax_blocks(index, vin)

    root, rp = tdc.make_root_from_zoo(index, device="cpu")
    ckt = tdc.make_diode_clipper(root, FS)
    serve = chip_smoke.block_server(ckt, {**ckt.init_params("cpu"), **rp})
    tfc.fused_clipper_neural.launches = tfc.fused_clipper_analytic.launches = 0
    z, outs = torch.zeros(B), []
    for i in range(BLOCKS):
        out, z = serve(torch.from_numpy(vin[:, i * T:(i + 1) * T]), z)
        outs.append(out)
    got = torch.cat(outs, 1).numpy()
    assert got.shape == (B, BLOCKS * T) and np.all(np.isfinite(got))
    np.testing.assert_allclose(got, want, atol=budget, rtol=0)
    np.testing.assert_allclose(z.numpy(), want_z, atol=budget, rtol=0)
    np.testing.assert_allclose(got[:8], scan, atol=budget, rtol=0)
    # CPU tensors run the plain versions and never count a launch
    assert tfc.fused_clipper_neural.launches == tfc.fused_clipper_analytic.launches == 0


def test_zoo_matches_jax():
    assert tdc.ZOO == jdc.ZOO
    assert tdc.ZOO_MODEL_PATHS == jdc.ZOO_MODEL_PATHS
    assert tdc.pretrained_model_path(2, 8, "2U-3D") == jdc.pretrained_model_path(2, 8, "2U-3D")
    for index in range(len(tdc.ZOO)):
        troot, tp = tdc.make_root_from_zoo(index, device="cpu")
        jroot, jp = jdc.make_root_from_zoo(index)
        assert type(troot).__name__ == type(jroot).__name__
        if tdc.ZOO[index][0] == "analytic":
            assert (troot.quality, troot.diode) == (jroot.quality, tuple(jroot.diode))
            continue
        assert (troot.n_layers, troot.layer_size, troot.activations) == (
            jroot.n_layers, jroot.layer_size, jroot.activations)
        for tl, jl in zip(tp["dp"]["layers"], jp["dp"]["layers"]):
            np.testing.assert_array_equal(tl["kernel"].numpy(), np.asarray(jl["kernel"]))


def test_zoo_loads_from_any_working_directory(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    root, rp = tdc.make_neural_root_or_default("dp", 2, 16, device="cpu")
    want, _, _ = tdc.load_model_json(REPO / tdc.pretrained_model_path(2, 16), device="cpu")
    assert torch.equal(rp["dp"]["layers"][0]["kernel"], want["layers"][0]["kernel"])
    # a size with no checked-in weights falls back to a seeded random net
    root, rp = tdc.make_neural_root_or_default(
        "dp", 3, 4, device="cpu", generator=torch.Generator().manual_seed(1))
    assert [l["kernel"].shape[1] for l in rp["dp"]["layers"]] == [4] * 4 + [1]
    with pytest.raises(FileNotFoundError):
        tdc.make_root_from_zoo(4, json_path=str(tmp_path / "missing.json"), device="cpu")


def _smoke(cwd):
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": ""}  # no card, even where one exists
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_a_card():
    proc = _smoke(REPO)
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout and "is_available() is false" in proc.stderr


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _smoke(tmp_path)
    assert proc.returncode != 0 and '"ok"' not in proc.stdout
