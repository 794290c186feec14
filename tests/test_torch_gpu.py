"""The CUDA kernels of diffwdf_tpu_torch against their plain versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The file
imports nothing of JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Budgets are the JAX suite's kernel-vs-scan budgets: analytic atol 5e-6,
neural atol 2e-5.
"""

import numpy as np
import pytest
import torch

from diffwdf_tpu_torch.roots.diode import diode_1n4148_1u1d, diode_1n4148_1u2d
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.ops import fused_clipper as fc

FS = 96000.0
R_SRC = 47.0e3
CAP = 2.2e-9


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only on a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    fc.fused_clipper_analytic.launches = 0
    fc.fused_clipper_neural.launches = 0
    return torch.device("cuda")


def _inputs(device, b, t, seed=0):
    rng = np.random.default_rng(seed)
    vin = torch.from_numpy((2.0 * rng.standard_normal((b, t))).astype(np.float32)).to(device)
    z0 = torch.from_numpy(rng.uniform(-0.5, 0.5, b).astype(np.float32)).to(device)
    return vin, z0


def _close(got, want, budget):
    np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(), atol=budget, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("diode", [diode_1n4148_1u1d, diode_1n4148_1u2d], ids=lambda d: d.name)
@pytest.mark.parametrize("iters", [1, 3])
def test_analytic_kernel_matches_plain(cuda, diode, iters):
    vin, z0 = _inputs(cuda, 1000, 300)  # ragged B: not a multiple of the block size
    args = (R_SRC, CAP, diode.Is, diode.Vt * diode.nabla, diode.N_up, diode.N_down)
    got, got_z = fc.fused_clipper_analytic(vin, z0, *args, fs=FS, quality_iters=iters)
    want, want_z = fc.fused_clipper_analytic_plain(vin, z0, *args, fs=FS, quality_iters=iters)
    torch.cuda.synchronize()
    assert fc.fused_clipper_analytic.launches == 1
    _close(got, want, 5e-6)
    _close(got_z, want_z, 5e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("n_layers,width", [(1, 16), (2, 4), (2, 8), (2, 16), (4, 4), (4, 8)])
def test_neural_kernel_matches_plain(cuda, n_layers, width):
    root = NeuralDiodeRoot(name="dp", n_layers=n_layers, layer_size=width)
    mlp = root.init_params(cuda, torch.Generator().manual_seed(width))["dp"]
    vin, z0 = _inputs(cuda, 777, 257, seed=width)
    got, got_z = fc.fused_clipper_neural(vin, z0, mlp, R_SRC, CAP, fs=FS)
    want, want_z = fc.fused_clipper_neural_plain(vin, z0, mlp, R_SRC, CAP, fs=FS)
    torch.cuda.synchronize()
    assert fc.fused_clipper_neural.launches == 1
    _close(got, want, 2e-5)
    _close(got_z, want_z, 2e-5)


@pytest.mark.gpu
def test_kernels_carry_state_across_blocks(cuda):
    vin, z0 = _inputs(cuda, 300, 512, seed=3)
    mlp = NeuralDiodeRoot(name="dp").init_params(cuda)["dp"]
    d = diode_1n4148_1u1d
    runs = {
        "neural": lambda v, z: fc.fused_clipper_neural(v, z, mlp, R_SRC, CAP, fs=FS),
        "analytic": lambda v, z: fc.fused_clipper_analytic(
            v, z, R_SRC, CAP, d.Is, d.Vt * d.nabla, 1.0, 1.0, fs=FS),
    }
    for run in runs.values():
        full, zf = run(vin, z0)
        h1, z1 = run(vin[:, :256], z0)  # a non-contiguous slice is taken too
        h2, z2 = run(vin[:, 256:], z1)
        torch.cuda.synchronize()
        _close(torch.cat([h1, h2], 1), full, 1e-6)
        _close(z2, zf, 1e-6)
    assert fc.fused_clipper_neural.launches == fc.fused_clipper_analytic.launches == 3


@pytest.mark.gpu
def test_neural_kernel_rejects_weights_on_another_device(cuda):
    vin, z0 = _inputs(cuda, 8, 8)
    mlp = NeuralDiodeRoot(name="dp").init_params("cpu")["dp"]
    with pytest.raises(ValueError):
        fc.fused_clipper_neural(vin, z0, mlp, R_SRC, CAP, fs=FS)
    assert fc.fused_clipper_neural.launches == 0
