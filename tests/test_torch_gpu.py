"""The CUDA kernels of diffwdf_tpu_torch against their plain versions, on a card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The file
imports nothing of JAX, so it also runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py

Budgets are the JAX suite's kernel-vs-scan budgets: analytic atol 5e-6,
neural atol 2e-5 (the training forward too); the adjoint's streams and the
training op's gradients 2e-5 after dividing by their largest magnitude; the
distilled clipper 1e-5, the generated circuit kernels 2e-5 (with pot
streams and the state trajectory too), and two half blocks against one
block 1e-6; the generated adjoint relative 1e-4 with no pot and 3e-4 with
pots, and the generic training op's gradients against the scan engine
relative 5e-4 per leaf (tests/test_parallel_bptt.py); the lane-cooperative
forward of an NxH root 2e-5 against plain and the one-thread kernel's bits,
every lane of a group the same bits; the two-pass adjoint the adjoint's
budgets against plain (the generated ones and the clipper's, B3 and B4, for
every family; the CPU tests hold the passes to a one-pass step's bits on the
host); B4's pass 3 (the
clipper's MLP parameter cotangents) within 1e-4 of the largest magnitude
of each leaf of autograd of the plain MLP at every family and B x T in
{1, 7, 1,000} x {1, 129, 2,048} and on ragged walks (B = 1 at 45 and
100,003 samples, 3 x 333) at every family and at 3x16, 5x16, 3x8 and 33x4
(two groups of the plan for the last two), the same bits on two
calls, one count a call, the whole fused op's gradients within 2e-5
(scaled) of the same op on the CPU, an unsupported width or root raising;
the Tube Screamer 2x16's
parameter pass on B4's pass 3 (B8 writing the root's a and G) at 1,024 and
8,192 x 2,048 within 5e-4 per root leaf of the autograd pass over the same
lam (scaled, the median leaf the floor), the same bits on two steps, one
count of B8.pass3 a step; the Tube Screamer 2x16's fused_generic training
step (init_state to Adam) at 64 x 256 under
torch.cuda.set_sync_debug_mode("error"), no host value copied; a short
fused_generic run's loss history rtol 5e-4 of the same run through the
plain versions (tests/test_parallel_bptt.py:579); the generated DEER
kernel against its plain version and the exact recursion, Tube Screamer
1e-4, HPF clipper 3e-4, neural clipper 5e-6 (tests/test_deer_circuit.py);
the serving kernels' redesigned forms: B1's lane kernel the one-thread
kernel's bits (every family, every K, at B = 1, 777 and 4,096), a family
outside the lane set on the one-thread kernel (its counter), B2 with both
omega solves paired at iters 1, 2, 3 and the run-time loop (4), at B = 1
and a ragged B, within the analytic budget; the DEER kernels on a
thread-block cluster of 16 CTAs (B5 and B9, T = 1,024 x 1, 2, 16 and 64):
within their budgets of plain with the sweeps and with none, chained blocks (the suite's 2e-6 for chained DEER blocks), the 180-Ohm
block still flagged, the adaptive HPF at JAX's 20 sweeps, and a refused
launch raising with nothing run or counted in its place; the distilled
clipper on one Chebyshev segment a lane (B6) within 1e-5 of plain at every
padded degree, K = 4 and 8, B = 1, 1,000 and 8,192, NaN in the same places; the diode pair's lane form of B7 (its two
omega solves on a pair of lanes) the one-thread kernel's bits on the TS,
the HPF and the LPF clipper at B = 1, 3 and 8,192, with and without the
trajectory, and 2e-5 of plain; omega_select and omega() the same bits on
the card; a refused launch of either raising with nothing in its place;
the multi-device layer at world size 1 under NCCL (``parallel``: the DP
steps of both fused engines against the single-process step, time-block
serving against B7 over the whole signal) and one generated source built by
two processes of two threads at once; the distilled root in B9 (1e-6 of
plain and of B6, on a quiet and a loud input) and in B7's training form and
B8 (the adjoint's budgets, chunked the whole call's bits, with a scalar and
a per-row R), and B7's general MLP root (a
relu-mixed 2x8, and sigmoid, softmax and linear layers of unequal widths)
within 2e-5 of plain, at a ragged (B, T) and through the exact runner; B7's
lane forms of the distilled root (one Chebyshev segment a lane) and of the
general MLP root (relu, sigmoid and softmax roots, their hidden layers split
over the lanes) the one-thread kernel's bits at every K and writer, with and
without the trajectory, at B = 1, 37 and 1,024, and within the budgets of
plain (1e-5, 2e-5), a per-sample R included; a lanes value the program
lacks, or a writer outside the group, refused.
"""

import numpy as np
import pytest
import torch

from diffwdf_tpu_torch.models.diode_clipper import make_training_clipper
from diffwdf_tpu_torch.roots.diode import DiodePairRoot, diode_1n4148_1u1d, diode_1n4148_1u2d
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.ops import clipper_train as ct
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
    fc.fused_clipper_neural.one_thread_launches = 0
    fc.fused_clipper_neural_train_fwd.launches = 0
    ct.clipper_adjoint.launches = 0
    ct.mlp_param_vjp.launches = 0
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
    """Two half blocks with the state carried equal one block, for every
    form: B1's lane kernel (2x16) and one-thread kernel (a 3x16, outside the
    lane set), B2 at its built counts 1 and 3 and its run-time loop (4)."""
    vin, z0 = _inputs(cuda, 300, 512, seed=3)
    mlp = NeuralDiodeRoot(name="dp").init_params(cuda)["dp"]
    deep = NeuralDiodeRoot(name="dp", n_layers=3).init_params(cuda)["dp"]
    d = diode_1n4148_1u1d

    def analytic(iters):
        return lambda v, z: fc.fused_clipper_analytic(
            v, z, R_SRC, CAP, d.Is, d.Vt * d.nabla, 1.0, 1.0, fs=FS, quality_iters=iters)

    runs = {
        "neural": lambda v, z: fc.fused_clipper_neural(v, z, mlp, R_SRC, CAP, fs=FS),
        "neural one-thread": lambda v, z: fc.fused_clipper_neural(v, z, deep, R_SRC, CAP, fs=FS),
        "analytic": analytic(3),
        "analytic low": analytic(1),
        "analytic loop": analytic(4),
    }
    for run in runs.values():
        full, zf = run(vin, z0)
        h1, z1 = run(vin[:, :256], z0)  # a non-contiguous slice is taken too
        h2, z2 = run(vin[:, 256:], z1)
        torch.cuda.synchronize()
        _close(torch.cat([h1, h2], 1), full, 1e-6)
        _close(z2, zf, 1e-6)
    assert fc.fused_clipper_neural.launches == 6 and fc.fused_clipper_analytic.launches == 9
    assert fc.fused_clipper_neural.one_thread_launches == 3


@pytest.mark.gpu
@pytest.mark.parametrize("n_layers,width", [(1, 16), (2, 4), (2, 8), (2, 16), (4, 4), (4, 8)])
def test_neural_lanes_match_one_thread_kernel(cuda, n_layers, width):
    """B1's lane kernel gives the one-thread kernel's bits for out and
    z_final at every K built for the width, at B = 1, a ragged B (777) and
    B = 4,096 (where the wrapper takes K = 8 for H = 16); the wrapper runs
    the lane kernel, and both forms are within 2e-5 of plain."""
    mlp = NeuralDiodeRoot(name="dp", n_layers=n_layers, layer_size=width).init_params(
        cuda, torch.Generator().manual_seed(width + 20))["dp"]
    for b, t in ((1, 300), (777, 257), (4096, 67)):
        vin, z0 = _inputs(cuda, b, t, seed=width + b)
        args = (vin, z0, mlp, R_SRC, CAP)
        one = fc.launch_neural(*args, fs=FS, lanes=1)
        for K in fc.nxh_lane_counts(width):
            got = fc.launch_neural(*args, fs=FS, lanes=K)
            assert all(torch.equal(g, w) for g, w in zip(got, one)), (b, K)
        got = fc.fused_clipper_neural(*args, fs=FS)
        assert all(torch.equal(g, w) for g, w in zip(got, one)), b
        want = fc.fused_clipper_neural_plain(*args, fs=FS)
        for g, w in zip(one, want):
            _close(g, w, 2e-5)
    torch.cuda.synchronize()
    assert fc.fused_clipper_neural.launches == 3
    assert fc.fused_clipper_neural.one_thread_launches == 0
    assert [fc.neural_lanes(width, n_layers, b) for b in (1, 4096)] == (
        [16, 8] if width == 16 else [width] * 2)


@pytest.mark.gpu
def test_neural_family_outside_lane_set_runs_one_thread_kernel(cuda):
    """A 3x16 root, outside TRAIN_FAMILIES, is served by the one-thread
    kernel (seen through the counter), within 2e-5 of plain; the lane
    kernel refuses it."""
    mlp = NeuralDiodeRoot(name="dp", n_layers=3).init_params(
        cuda, torch.Generator().manual_seed(5))["dp"]
    vin, z0 = _inputs(cuda, 200, 129, seed=5)
    got = fc.fused_clipper_neural(vin, z0, mlp, R_SRC, CAP, fs=FS)
    want = fc.fused_clipper_neural_plain(vin, z0, mlp, R_SRC, CAP, fs=FS)
    torch.cuda.synchronize()
    assert fc.fused_clipper_neural.launches == fc.fused_clipper_neural.one_thread_launches == 1
    for g, w in zip(got, want):
        _close(g, w, 2e-5)
    with pytest.raises(ValueError, match="no lane kernel"):
        fc.launch_neural(vin, z0, mlp, R_SRC, CAP, fs=FS, lanes=16)


@pytest.mark.gpu
@pytest.mark.parametrize("diode", [diode_1n4148_1u1d, diode_1n4148_1u2d], ids=lambda d: d.name)
@pytest.mark.parametrize("iters", [1, 2, 3, 4])
@pytest.mark.parametrize("b", [1, 777])
def test_analytic_pair_kernel_matches_plain(cuda, diode, iters, b):
    """B2 with both omega solves branch-free and unrolled, one on each lane of
    a pair (built for iters 1, 2, 3; 4 runs the run-time loop), is within
    5e-6 of plain at B = 1 and a ragged B."""
    vin, z0 = _inputs(cuda, b, 300, seed=iters + b)
    args = (vin, z0, R_SRC, CAP, diode.Is, diode.Vt * diode.nabla, diode.N_up, diode.N_down)
    got = fc.fused_clipper_analytic(*args, fs=FS, quality_iters=iters)
    want = fc.fused_clipper_analytic_plain(*args, fs=FS, quality_iters=iters)
    torch.cuda.synchronize()
    assert fc.fused_clipper_analytic.launches == 1
    for g, w in zip(got, want):
        _close(g, w, 5e-6)


@pytest.mark.gpu
def test_neural_kernel_rejects_weights_on_another_device(cuda):
    vin, z0 = _inputs(cuda, 8, 8)
    mlp = NeuralDiodeRoot(name="dp").init_params("cpu")["dp"]
    with pytest.raises(ValueError):
        fc.fused_clipper_neural(vin, z0, mlp, R_SRC, CAP, fs=FS)
    assert fc.fused_clipper_neural.launches == 0


TRAIN_FS, TRAIN_CAP = 48000.0, 4.7e-9
FAMILIES = [(1, 16), (2, 4), (2, 8), (2, 16), (4, 4), (4, 8)]


def _train_inputs(device, n_layers, width, b, t, seed):
    root = NeuralDiodeRoot(name="dp", n_layers=n_layers, layer_size=width)
    mlp = root.init_params(device, torch.Generator().manual_seed(seed))["dp"]
    vin, z0 = _inputs(device, b, t, seed)
    r_rows = torch.from_numpy(np.geomspace(10e3, 99e3, b).astype(np.float32)).to(device)
    return root, mlp, vin, z0, r_rows


def _close_scaled(got, want, budget=2e-5):
    scale = max(float(want.abs().max()), 1e-8)
    _close(got / scale, want / scale, budget)


@pytest.mark.gpu
@pytest.mark.parametrize("n_layers,width", FAMILIES)
def test_train_fwd_kernel_matches_plain(cuda, n_layers, width):
    _, mlp, vin, z0, r_rows = _train_inputs(cuda, n_layers, width, 1000, 300, seed=width)
    got = fc.fused_clipper_neural_train_fwd(vin, z0, mlp, r_rows, TRAIN_CAP, fs=TRAIN_FS)
    want = fc.fused_clipper_neural_train_fwd_plain(vin, z0, mlp, r_rows, TRAIN_CAP, fs=TRAIN_FS)
    torch.cuda.synchronize()
    assert fc.fused_clipper_neural_train_fwd.launches == 1
    for g, w in zip(got, want):
        _close(g, w, 2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("n_layers,width", FAMILIES)
def test_adjoint_kernel_matches_plain(cuda, n_layers, width):
    _, mlp, vin, z0, r_rows = _train_inputs(cuda, n_layers, width, 1000, 300, seed=width + 1)
    _, _, a_seq = fc.fused_clipper_neural_train_fwd_plain(vin, z0, mlp, r_rows, TRAIN_CAP,
                                                         fs=TRAIN_FS)
    g_out, g_zf = _inputs(cuda, 1000, 300, seed=width + 2)
    got = ct.clipper_adjoint(a_seq, g_out, g_zf, r_rows, mlp, TRAIN_CAP, fs=TRAIN_FS)
    want = ct.clipper_adjoint_plain(a_seq, g_out, g_zf, r_rows, mlp, TRAIN_CAP, fs=TRAIN_FS)
    torch.cuda.synchronize()
    assert ct.clipper_adjoint.launches == 1
    for g, w in zip(got, want):
        _close_scaled(g, w)


@pytest.mark.gpu
@pytest.mark.parametrize("n_layers,width", FAMILIES)
def test_train_fwd_lanes_match_one_thread_kernel(cuda, n_layers, width):
    """B3's lane form gives the one-thread kernel's bits for out, z_final and
    a_seq at every K built for the width and with every lane of a group as
    the writer, at a ragged B (1000, T = 300) and at B = 2,100 (T = 67),
    where the wrapper takes K = 8 for H = 16."""
    for b, t in ((1000, 300), (2100, 67)):
        _, mlp, vin, z0, r_rows = _train_inputs(cuda, n_layers, width, b, t, seed=width + 5)
        args = (vin, z0, mlp, r_rows, TRAIN_CAP)
        want = fc.launch_train_fwd(*args, fs=TRAIN_FS, lanes=1)
        for K in fc.nxh_lane_counts(width):
            for writer in range(K):
                got = fc.launch_train_fwd(*args, fs=TRAIN_FS, lanes=K, writer=writer)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (b, K, writer)
        got = fc.fused_clipper_neural_train_fwd(*args, fs=TRAIN_FS)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    torch.cuda.synchronize()
    assert fc.fused_clipper_neural_train_fwd.launches == 2
    assert [fc.nxh_lanes(width, b) for b in (1000, 2100)] == (
        [16, 8] if width == 16 else [width] * 2)


@pytest.mark.gpu
@pytest.mark.parametrize("n_layers,width", FAMILIES)
def test_adjoint_two_passes_match_one_pass_kernel(cuda, n_layers, width):
    """B4's two passes (the wrapper) are within the adjoint's budget (2e-5,
    scaled) of plain for g_vin, G and g_z0, at a ragged B (1000, T = 300:
    16-byte stores of the output tiles) and at B = 2,100 (T = 67: a partial
    slab and tile).  tests/test_torch_clipper_kernels.py holds the passes to
    a one-pass walk's bits on the host."""
    for b, t in ((1000, 300), (2100, 67)):
        _, mlp, vin, z0, r_rows = _train_inputs(cuda, n_layers, width, b, t, seed=width + 6)
        _, _, a_seq = fc.launch_train_fwd(vin, z0, mlp, r_rows, TRAIN_CAP, fs=TRAIN_FS)
        g_out, g_zf = _inputs(cuda, b, t, seed=width + 7)
        args = (a_seq, g_out, g_zf, r_rows, mlp, TRAIN_CAP)
        got = ct.clipper_adjoint(*args, fs=TRAIN_FS)
        want = ct.clipper_adjoint_plain(*args, fs=TRAIN_FS)
        for g, w in zip(got, want):
            _close_scaled(g, w)
    torch.cuda.synchronize()
    assert ct.clipper_adjoint.launches == 2


def _param_inputs(device, n_layers, width, b, t, seed):
    """A random-init root and seeded (a, log R, G) of b x t samples, a in the
    range the training forward writes."""
    _, mlp, _, _, r_rows = _train_inputs(device, n_layers, width, b, t, seed)
    rng = np.random.default_rng(seed)
    a_seq = torch.from_numpy(rng.uniform(-3.0, 3.0, (b, t)).astype(np.float32)).to(device)
    G = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32)).to(device)
    _, log_r = fc.row_constants(r_rows, TRAIN_CAP, TRAIN_FS)
    return mlp, a_seq, log_r, G


@pytest.mark.gpu
@pytest.mark.parametrize("n_layers,width", FAMILIES)
def test_param_pass_matches_plain(cuda, n_layers, width):
    """B4's pass 3 against autograd of the plain MLP (mlp_param_vjp_plain on
    the card, full float32) at B in {1, 7, 1,000} x T in {1, 129, 2,048}: a
    ragged tile and a ragged walk of the persistent blocks.  Each leaf within
    1e-4 of its largest magnitude: float32 sums over up to 2 M samples, taken
    in another order than cuBLAS takes them.  Two calls give the same bits;
    each call counts once in B4.pass3."""
    from diffwdf_tpu_torch.runtime import profiler

    acts = ("tanh",) * (n_layers + 1) + ("",)
    calls = 0
    for b in (1, 7, 1000):
        for t in (1, 129, 2048):
            mlp, a_seq, log_r, G = _param_inputs(cuda, n_layers, width, b, t, seed=width + b + t)
            before = profiler.counters()["B4.pass3"]
            got = ct.mlp_param_vjp(mlp, acts, a_seq, log_r, G)
            again = ct.mlp_param_vjp(mlp, acts, a_seq, log_r, G)
            calls += 2
            assert profiler.counters()["B4.pass3"] - before == 2
            want = ct.mlp_param_vjp_plain(mlp, acts, a_seq, log_r, G)
            torch.cuda.synchronize()
            assert [g.shape for g in got] == [w.shape for w in want]
            for g, g2, w in zip(got, again, want):
                assert torch.equal(g, g2), (b, t)
                assert bool(torch.isfinite(g).all()), (b, t)
                _close_scaled(g, w, 1e-4)
    assert ct.mlp_param_vjp.launches == calls



@pytest.mark.gpu
@pytest.mark.parametrize("n_layers,width", FAMILIES + [(3, 16), (5, 16), (3, 8), (33, 4)])
@pytest.mark.parametrize("b,t", [(1, 45), (1, 100003), (3, 333)])
def test_param_pass_ragged_walks(cuda, n_layers, width, b, t):
    """B4's pass 3 where the warps' walk is ragged: N not a multiple of 32
    (B = 1 and fewer tiles than the grid's warps; one stream of 100,003
    samples, some warps a tile more than others; three rows of 333), at
    every family and at L outside them (3x16 and 3x8 in one group of the
    plan, 5x16 and 33x4 in two): each leaf within 1e-4 of its largest
    magnitude of autograd of the plain MLP in float64 (a sample missed or
    taken twice moves a leaf by a whole term), the same bits on two calls,
    one count of B4.pass3 a call.  G is shifted by 1 so that no leaf is a
    sum that cancels: the head bias is the sum of -G, and at 3 x 333 the
    unshifted G sums to 0.072 against 804 for its magnitudes, where float32
    rounding in any order (autograd's too) is up to 2% of the sum."""
    from diffwdf_tpu_torch.runtime import profiler

    acts = ("tanh",) * (n_layers + 1) + ("",)
    mlp, a_seq, log_r, G = _param_inputs(cuda, n_layers, width, b, t, seed=n_layers + b + t)
    G = G + 1.0
    before = profiler.counters()["B4.pass3"]
    got = ct.mlp_param_vjp(mlp, acts, a_seq, log_r, G)
    again = ct.mlp_param_vjp(mlp, acts, a_seq, log_r, G)
    assert profiler.counters()["B4.pass3"] - before == 2
    exact = {"layers": [{k: v.double() for k, v in layer.items()} for layer in mlp["layers"]]}
    want = ct.mlp_param_vjp_plain(exact, acts, a_seq.double(), log_r.double(), G.double())
    torch.cuda.synchronize()
    for g, g2, w in zip(got, again, want):
        assert torch.equal(g, g2)
        assert bool(torch.isfinite(g).all())
        _close_scaled(g.double(), w, 1e-4)

@pytest.mark.gpu
def test_fused_train_op_backward_matches_plain_op(cuda):
    """The whole make_fused_clipper_train op on the card (B3, B4's three
    passes) against the same op on the CPU (every plain version): loss
    rtol 1e-5, every gradient within 2e-5 of its largest magnitude."""
    root, mlp, vin, z0, r_rows = _train_inputs(cuda, 2, 16, 67, 300, seed=21)
    fused = ct.make_fused_clipper_train(root.activations, TRAIN_CAP, TRAIN_FS)
    y = torch.tanh(0.5 * vin)

    def grads(device):
        leaves = [x.detach().to(device).clone().requires_grad_(True)
                  for x in ct.mlp_leaves(mlp)]
        v = vin.detach().to(device).clone().requires_grad_(True)
        z = z0.detach().to(device).clone().requires_grad_(True)
        out, zf = fused(v, z, ct.mlp_tree(leaves), r_rows.to(device))
        loss = ((out[:, 32:] - y.to(device)[:, 32:]) ** 2).mean() + 0.1 * (zf ** 2).mean()
        loss.backward()
        return loss.item(), [v.grad, z.grad] + [x.grad for x in leaves]

    lc, gc = grads(cuda)
    lp, gp = grads(torch.device("cpu"))
    assert ct.clipper_adjoint.launches == ct.mlp_param_vjp.launches == 1
    np.testing.assert_allclose(lc, lp, rtol=1e-5)
    for g, w in zip(gc, gp):
        _close_scaled(g.cpu(), w)


@pytest.mark.gpu
def test_param_pass_raises_outside_its_family(cuda):
    """A width the kernel is not built for, or a root that is not all-tanh,
    raises: nothing runs or counts in its place."""
    mlp, a_seq, log_r, G = _param_inputs(cuda, 2, 16, 7, 33, seed=3)
    bad = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=12).init_params(cuda)["dp"]
    with pytest.raises(ValueError):
        ct.mlp_param_vjp(bad, ("tanh",) * 3 + ("",), a_seq, log_r, G)
    with pytest.raises(ValueError, match="all-tanh"):
        ct.mlp_param_vjp(mlp, ("tanh", "relu", "tanh", ""), a_seq, log_r, G)
    assert ct.mlp_param_vjp.launches == 0


@pytest.mark.gpu
def test_train_fwd_raises_for_a_family_without_a_kernel(cuda):
    _, mlp, vin, z0, r_rows = _train_inputs(cuda, 3, 16, 64, 32, seed=1)
    with pytest.raises(ValueError, match="no kernel"):
        fc.fused_clipper_neural_train_fwd(vin, z0, mlp, r_rows, TRAIN_CAP, fs=TRAIN_FS)
    assert fc.fused_clipper_neural_train_fwd.launches == 0


@pytest.mark.gpu
def test_fused_train_op_grads_match_scan_on_card(cuda):
    root, mlp, vin, z0, r_rows = _train_inputs(cuda, 2, 16, 256, 256, seed=11)
    ckt = make_training_clipper(root, TRAIN_FS, cap=TRAIN_CAP)
    fused = ct.make_fused_clipper_train(root.activations, TRAIN_CAP, TRAIN_FS)
    y = torch.tanh(0.5 * vin)

    def scan(v, z, m):
        out, st = ckt.process({**ckt.init_params(cuda), "dp": m}, {"C": {"z": z}},
                              {"Vs": {"v": v.T}}, static_controls={"Vs": {"R": r_rows}})
        return out.T, st["C"]["z"]

    def grads(run):
        leaves = [x.clone().requires_grad_(True) for x in ct.mlp_leaves(mlp)]
        v, z = vin.clone().requires_grad_(True), z0.clone().requires_grad_(True)
        out, zf = run(v, z, ct.mlp_tree(leaves))
        loss = ((out[:, 32:] - y[:, 32:]) ** 2).mean() + 0.1 * (zf ** 2).mean()
        loss.backward()
        return loss.item(), [v.grad, z.grad] + [x.grad for x in leaves]

    lf, gf = grads(lambda v, z, m: fused(v, z, m, r_rows))
    ls, gs = grads(scan)
    assert fc.fused_clipper_neural_train_fwd.launches == ct.clipper_adjoint.launches == 1
    assert ct.mlp_param_vjp.launches == 1
    np.testing.assert_allclose(lf, ls, rtol=1e-5)
    for g, w in zip(gf, gs):
        _close_scaled(g, w)


@pytest.mark.gpu
def test_train_kernels_count_one_launch_per_call(cuda):
    _, mlp, vin, z0, r_rows = _train_inputs(cuda, 2, 8, 130, 64, seed=4)
    for n in (1, 2, 3):
        _, _, a_seq = fc.fused_clipper_neural_train_fwd(vin, z0, mlp, r_rows, TRAIN_CAP,
                                                       fs=TRAIN_FS)
        ct.clipper_adjoint(a_seq, vin, z0, r_rows, mlp, TRAIN_CAP, fs=TRAIN_FS)
        assert fc.fused_clipper_neural_train_fwd.launches == ct.clipper_adjoint.launches == n
    torch.cuda.synchronize()
    # the plain versions, and a refused architecture, launch nothing
    fc.fused_clipper_neural_train_fwd_plain(vin, z0, mlp, r_rows, TRAIN_CAP, fs=TRAIN_FS)
    bad = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=5).init_params(cuda)["dp"]
    with pytest.raises(ValueError):
        fc.fused_clipper_neural_train_fwd(vin, z0, bad, r_rows, TRAIN_CAP, fs=TRAIN_FS)
    assert fc.fused_clipper_neural_train_fwd.launches == ct.clipper_adjoint.launches == 3
    assert fc.fused_clipper_neural.launches == fc.fused_clipper_analytic.launches == 0


# ---------------------------------------------------------------------------
# single-stream serving: the DEER kernel and the streaming processor
# ---------------------------------------------------------------------------


def _deer_args(r_src=R_SRC):
    d = diode_1n4148_1u1d
    return (r_src, CAP, d.Is, d.Vt * d.nabla, d.N_up, d.N_down)


@pytest.fixture
def deer_cuda(cuda):
    from diffwdf_tpu_torch.ops import parallel_time_deer as pd

    pd.fused_deer_clipper.launches = 0
    return cuda, pd


@pytest.mark.gpu
@pytest.mark.parametrize("T", [2048, 16384])
@pytest.mark.parametrize("sweeps,iters", [(8, 3), (4, 1)], ids=["toms", "approx"])
def test_deer_kernel_matches_plain(deer_cuda, T, sweeps, iters):
    dev, pd = deer_cuda
    vin = torch.from_numpy(np.random.default_rng(T + iters).standard_normal(T)
                           .astype(np.float32) * 2).to(dev)
    kw = dict(fs=FS, z0=0.2, sweeps=sweeps, quality_iters=iters)
    got = pd.fused_deer_clipper(vin, *_deer_args(), **kw)
    want = pd.fused_deer_clipper_plain(vin, *_deer_args(), **kw)
    torch.cuda.synchronize()
    assert pd.fused_deer_clipper.launches == 1
    assert got[0].shape == (T,) and got[1].shape == () and got[2].shape == ()
    _close(got[0], want[0], 1e-6)
    _close(got[1], want[1], 1e-6)
    np.testing.assert_allclose(float(got[2]), float(want[2]), atol=1e-6, rtol=0.05)


@pytest.mark.gpu
def test_deer_kernel_chains_blocks_and_flags_180_ohm(deer_cuda):
    dev, pd = deer_cuda
    vin = torch.from_numpy(np.random.default_rng(7).standard_normal(2048)
                           .astype(np.float32) * 2).to(dev)
    full, _, _ = pd.fused_deer_clipper(vin, *_deer_args(), fs=FS)
    a, za, _ = pd.fused_deer_clipper(vin[:1024], *_deer_args(), fs=FS)
    b, _, _ = pd.fused_deer_clipper(vin[1024:], *_deer_args(), fs=FS, z0=za)  # state stays on the card
    _, _, res = pd.fused_deer_clipper(vin, *_deer_args(180.0), fs=FS)
    torch.cuda.synchronize()
    _close(torch.cat([a, b]), full, 2e-6)
    assert float(res) > 1e-2
    with pytest.raises(ValueError):
        pd.fused_deer_clipper(vin[:1000], *_deer_args(), fs=FS)
    assert pd.fused_deer_clipper.launches == 4


def _deer_solve(pd, vin, sweeps=8, iters=3, r_src=R_SRC, z0=0.2, relax=2):
    """One launch of B5's served kernel (``pd.launch``, not counted)."""
    out, zf, res = (torch.empty_like(vin), torch.empty((), device=vin.device),
                    torch.empty((), device=vin.device))
    consts = pd._analytic_constants(r_src, CAP, FS, *_deer_args(r_src)[2:])
    s0 = torch.full((), z0, device=vin.device)
    pd.launch(vin, s0, out, zf, res, vin.shape[0] // 1024, consts, sweeps, relax, iters)
    return out, zf, res


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [1, 2, 16, 64])
def test_deer_cluster_kernel_matches_plain_and_one_cta_kernel(deer_cuda, blocks):
    """B5 on its cluster of 16 CTAs at T = 1024 blocks: 1e-6 of plain with 8
    sweeps and with none (the relaxations and the emit pass alone; the CPU
    tests hold that case to a one-thread walk's bits); one counted launch
    through the wrapper, with the launch's bits."""
    dev, pd = deer_cuda
    T = 1024 * blocks
    vin = torch.from_numpy(np.random.default_rng(blocks).standard_normal(T)
                           .astype(np.float32) * 2).to(dev)
    got = _deer_solve(pd, vin)
    want = pd.fused_deer_clipper_plain(vin, *_deer_args(), fs=FS, z0=0.2)
    bare = _deer_solve(pd, vin, sweeps=0)
    bare_want = pd.fused_deer_clipper_plain(vin, *_deer_args(), fs=FS, z0=0.2, sweeps=0)
    torch.cuda.synchronize()
    _close(got[0], want[0], 1e-6)
    _close(got[1], want[1], 1e-6)
    _close(bare[0], bare_want[0], 1e-6)
    _close(bare[1], bare_want[1], 1e-6)
    out, _, _ = pd.fused_deer_clipper(vin, *_deer_args(), fs=FS, z0=0.2)
    torch.cuda.synchronize()
    assert pd.fused_deer_clipper.launches == 1
    assert torch.equal(out, got[0])


@pytest.mark.gpu
def test_deer_cluster_kernel_chains_blocks_and_flags_180_ohm(deer_cuda):
    """Two chained blocks equal one solve within the suite's 2e-6
    (tests/test_parallel_time_deer.py:89); R = 180 Ohm is still flagged."""
    dev, pd = deer_cuda
    vin = torch.from_numpy(np.random.default_rng(17).standard_normal(4096)
                           .astype(np.float32) * 2).to(dev)
    full = _deer_solve(pd, vin)
    a = _deer_solve(pd, vin[:2048])
    b = _deer_solve(pd, vin[2048:], z0=float(a[1]))
    _, _, res = _deer_solve(pd, vin[:2048], r_src=180.0)
    torch.cuda.synchronize()
    _close(torch.cat([a[0], b[0]]), full[0], 2e-6)
    assert float(res) > 1e-2


@pytest.mark.gpu
def test_deer_refused_cluster_launch_raises(deer_cuda):
    """A launch the library refuses raises with CUDA's message (arguments
    it rejects); nothing runs in its place and nothing is counted."""
    dev, pd = deer_cuda
    vin = torch.zeros(2048, device=dev)
    out = torch.full_like(vin, 7.0)
    consts = pd._analytic_constants(R_SRC, CAP, FS, *_deer_args()[2:])
    args = (vin, torch.zeros((), device=dev), out, torch.empty((), device=dev),
            torch.empty((), device=dev))
    with pytest.raises(RuntimeError, match="CUDA error"):
        pd.launch(*args, 0, consts, 8, 2, 3)
    with pytest.raises(RuntimeError, match="CUDA error"):
        pd.launch(*args, 2, consts, -1, 2, 3)
    torch.cuda.synchronize()
    assert bool((out == 7.0).all()) and pd.fused_deer_clipper.launches == 0
    assert pd.max_active_clusters() >= 1


@pytest.mark.gpu
def test_exact_engine_at_one_stream_matches_plain(cuda):
    """B2 at B=1 (the exact engine of a served block) after the omega move
    to omega.cuh: the plain version's values, and row 0 of a batched call."""
    vin, z0 = _inputs(cuda, 64, 2048, seed=12)
    args = _deer_args()
    one, one_z = fc.fused_clipper_analytic(vin[:1], z0[:1], *args, fs=FS)
    many, _ = fc.fused_clipper_analytic(vin, z0, *args, fs=FS)
    want, want_z = fc.fused_clipper_analytic_plain(vin[:1], z0[:1], *args, fs=FS)
    torch.cuda.synchronize()
    assert torch.equal(one[0], many[0])
    _close(one, want, 5e-6)
    _close(one_z, want_z, 5e-6)


@pytest.mark.gpu
def test_stream_processor_on_card_deer_vs_scan(deer_cuda):
    """Both engines serve one stream on the card: deer equals scan block for
    block at 5e-6, and every served block is one kernel launch."""
    from diffwdf_tpu_torch.runtime.stream import make_clipper_processor

    dev, pd = deer_cuda
    deer = make_clipper_processor(FS, models=("toms", "approx"), engine="deer", device=dev)
    scan = make_clipper_processor(FS, engine="scan", device=dev)
    x = (1.5 * np.random.default_rng(8).standard_normal((2, 3 * 2048))).astype(np.float32)
    for i, model in enumerate(("toms", "approx", "toms")):
        blk = x[:, i * 2048:(i + 1) * 2048]
        kw = dict(model=model, gain_db=2.0 * i, cutoff_hz=3000.0 + 1000.0 * i)
        b = deer.process_block(blk, "clipper", **kw)
        assert (pd.fused_deer_clipper.launches, fc.fused_clipper_analytic.launches) == (i + 1, i)
        a = scan.process_block(blk, "clipper", **kw)
        assert (pd.fused_deer_clipper.launches, fc.fused_clipper_analytic.launches) == (i + 1, i + 1)
        assert b.shape == (2, 2048) and np.isfinite(b).all()
        np.testing.assert_allclose(b, a, atol=5e-6, rtol=0)
        assert deer.last_residual[model] < 1e-5
    scan.process_block(x[:, :2048], "clipper", model="neural_2x16")
    assert fc.fused_clipper_neural.launches == 1


# ---------------------------------------------------------------------------
# the distilled clipper (B6) and the generated circuit kernels (B7)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def distilled_root():
    from diffwdf_tpu_torch.roots.distilled import distill_root

    root = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)
    r_port = 1.0 / (1.0 / R_SRC + 2.0 * CAP * FS)
    return distill_root(root, root.init_params("cpu"), r_port)[0]


@pytest.fixture
def circuit_cuda(cuda):
    from diffwdf_tpu_torch.ops import fused_circuit as fcirc

    fc.fused_clipper_cheb.launches = 0
    fcirc.fused_circuit_process.launches = 0
    return cuda, fcirc


@pytest.mark.gpu
@pytest.mark.parametrize("amp", [2.0, 12.0])
def test_cheb_kernel_matches_plain(circuit_cuda, distilled_root, amp):
    dev, _ = circuit_cuda
    vin, z0 = _inputs(dev, 1000, 300, seed=int(amp))
    vin = vin * (amp / 2.0)
    got, got_z = fc.fused_clipper_cheb(vin, z0, distilled_root, R_SRC, CAP, fs=FS)
    want, want_z = fc.fused_clipper_cheb_plain(vin, z0, distilled_root, R_SRC, CAP, fs=FS)
    torch.cuda.synchronize()
    assert fc.fused_clipper_cheb.launches == 1
    _close(got, want, 1e-5)
    _close(got_z, want_z, 1e-5)
    h1, z1 = fc.fused_clipper_cheb(vin[:, :150], z0, distilled_root, R_SRC, CAP, fs=FS)
    h2, z2 = fc.fused_clipper_cheb(vin[:, 150:], z1, distilled_root, R_SRC, CAP, fs=FS)
    torch.cuda.synchronize()
    _close(torch.cat([h1, h2], 1), got, 1e-6)
    _close(z2, got_z, 1e-6)
    assert fc.fused_clipper_cheb.launches == 3


def _circuit_case(name, dev, distilled_root=None):
    """(circuit, params, input node, amplitude, neural mlp or None)."""
    from diffwdf_tpu_torch.models import diode_clipper as tdc
    from diffwdf_tpu_torch.models.simple_circuits import make_rc_lowpass, make_voltage_divider
    from diffwdf_tpu_torch.models.tube_screamer import make_tube_screamer

    if name in ("ts", "ts_2x16"):
        root, rp = tdc.make_root_from_zoo(4 if name == "ts_2x16" else 0, device=dev)
        ckt = make_tube_screamer(root, FS, drive=0.5)
        mlp = rp["dp"] if name == "ts_2x16" else None
        return ckt, {**ckt.init_params(dev), **rp}, "Vin", 0.2, mlp
    if name in ("hpf", "hpf_2x16"):
        root, rp = tdc.make_hpf_root_from_zoo(3 if name == "hpf_2x16" else 0, device=dev)
        ckt = tdc.make_hpf_diode_clipper(root, FS)
        return ckt, {**ckt.init_params(dev), **rp}, "Vs", 1.5, None
    if name in ("lpf", "lpf_distilled"):
        root = distilled_root if name == "lpf_distilled" else DiodePairRoot(
            name="dp", diode=diode_1n4148_1u1d)
        ckt = tdc.make_diode_clipper(root, FS)
        return ckt, {**ckt.init_params(dev), **root.init_params(dev)}, "Vs", 1.5, None
    ckt = {"rc": make_rc_lowpass, "divider": make_voltage_divider}[name](FS)
    return ckt, ckt.init_params(dev), "Vs", 1.0, None


def _circuit_inputs(ckt, dev, b, t, amp, seed):
    rng = np.random.default_rng(seed)
    n = np.arange(t)
    x = amp * np.sin(2 * np.pi * 1000.0 * n / FS)[None, :] + 0.1 * rng.standard_normal((b, t))
    state = {k: {f: torch.from_numpy(rng.uniform(-0.1, 0.1, b).astype(np.float32)).to(dev)
                 for f in d} for k, d in ckt.init_state("cpu").items()}
    return torch.from_numpy(x.astype(np.float32)).to(dev), state


def _run_circuit(fcirc, ckt, params, vin, state, node, mlp, plain=False):
    if mlp is not None:
        fn = (fcirc.fused_circuit_process_neural_plain if plain
              else fcirc.fused_circuit_process_neural)
        return fn(ckt, params, mlp, vin, state, input_node=node)
    fn = fcirc.fused_circuit_process_plain if plain else fcirc.fused_circuit_process
    return fn(ckt, params, vin, state, input_node=node)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ts", "ts_2x16", "hpf", "hpf_2x16", "lpf", "lpf_distilled",
                                  "rc", "divider"])
def test_circuit_kernel_matches_plain(circuit_cuda, distilled_root, name):
    dev, fcirc = circuit_cuda
    ckt, params, node, amp, mlp = _circuit_case(name, dev, distilled_root)
    vin, state = _circuit_inputs(ckt, dev, 1000, 300, amp, seed=len(name))  # ragged B and T
    got, got_state = _run_circuit(fcirc, ckt, params, vin, state, node, mlp)
    want, want_state = _run_circuit(fcirc, ckt, params, vin, state, node, mlp, plain=True)
    torch.cuda.synchronize()
    assert fcirc.fused_circuit_process.launches == 1
    _close(got, want, 2e-5)
    for k, d in want_state.items():
        for f, z in d.items():
            _close(got_state[k][f], z, 2e-5)


@pytest.mark.gpu
def test_circuit_kernel_lpf_matches_analytic_kernel(circuit_cuda):
    """B7 on the LPF clipper against B2 on the same streams."""
    dev, fcirc = circuit_cuda
    ckt, params, node, _, _ = _circuit_case("lpf", dev)
    vin, z0 = _inputs(dev, 1000, 300, seed=21)
    got, got_state = fcirc.fused_circuit_process(ckt, params, vin, {"C": {"z": z0}},
                                                 input_node=node)
    d = diode_1n4148_1u1d
    want, want_z = fc.fused_clipper_analytic(vin, z0, R_SRC, CAP, d.Is, d.Vt * d.nabla,
                                             1.0, 1.0, fs=FS)
    torch.cuda.synchronize()
    _close(got, want, 2e-5)
    _close(got_state["C"]["z"], want_z, 2e-5)


@pytest.mark.gpu
def test_circuit_kernel_carries_state_and_drive_does_not_rebuild(circuit_cuda):
    from diffwdf_tpu_torch.models.tube_screamer import make_tube_screamer
    from diffwdf_tpu_torch.ops import _build

    dev, fcirc = circuit_cuda
    ckt, params, node, amp, _ = _circuit_case("ts", dev)
    vin, state = _circuit_inputs(ckt, dev, 300, 512, amp, seed=5)
    full, full_state = fcirc.fused_circuit_process(ckt, params, vin, state)
    h1, st = fcirc.fused_circuit_process(ckt, params, vin[:, :256], state)
    h2, st2 = fcirc.fused_circuit_process(ckt, params, vin[:, 256:], st)
    torch.cuda.synchronize()
    _close(torch.cat([h1, h2], 1), full, 1e-6)
    for k in full_state:
        _close(st2[k]["z"], full_state[k]["z"], 1e-6)
    # the drive pot moves the gain (tests/test_rtype.py's check, at 96 kHz)
    builds = _build.build_generated.builds
    n = torch.arange(1024, device=dev, dtype=torch.float32)
    small = (0.02 * torch.sin(2 * np.pi * 440.0 * n / FS))[None, :].repeat(4, 1)
    peaks = []
    for drive in (0.0, 1.0):
        ts = make_tube_screamer(ckt.root, FS, drive=drive)
        zero = {k: {"z": torch.zeros(4, device=dev)} for k in full_state}
        out, _ = fcirc.fused_circuit_process(ts, {**ts.init_params(dev), "dp": params["dp"]},
                                             small, zero)
        peaks.append(float(out[:, 512:].abs().max()))
    torch.cuda.synchronize()
    assert _build.build_generated.builds == builds
    assert peaks[1] > 2.0 * peaks[0], peaks
    assert fcirc.fused_circuit_process.launches == 5


def _train_case(name, dev, b, t):
    """(circuit, params, input node, MLP for the ``_neural`` entry or None,
    row controls or None) of the generic training path's kernel cases."""
    from diffwdf_tpu_torch.models import diode_clipper as tdc
    from diffwdf_tpu_torch.models.tube_screamer import drive_to_r6, make_tube_screamer

    rng = np.random.default_rng(len(name))
    if name.startswith("ts_2x16"):
        root, rp = tdc.make_root_from_zoo(4, device=dev)  # the pretrained 2x16
        ckt = make_tube_screamer(root, 48000.0, drive=0.5)
        rows = None
        if name == "ts_2x16_row":  # the drive pot per row (bench.py:560-604)
            r6 = drive_to_r6(rng.uniform(0.0, 1.0, b)).astype(np.float32)
            rows = {"R6": {"R": torch.from_numpy(r6).to(dev)}}
        if name == "ts_2x16_sample":  # the drive pot per sample, a random walk
            walk = np.cumsum(0.01 * rng.standard_normal((b, t)), axis=1)
            r6 = drive_to_r6(np.clip(0.5 + walk, 0.0, 1.0)).astype(np.float32)
            rows = {"R6": {"R": torch.from_numpy(r6).to(dev)}}
        return ckt, {**ckt.init_params(dev), **rp}, "Vin", rp["dp"], rows
    if name == "hpf":
        root, rp = tdc.make_hpf_root_from_zoo(0, device=dev)
        ckt = tdc.make_hpf_diode_clipper(root, 48000.0)
        return ckt, {**ckt.init_params(dev), **rp}, "Vs", None, None
    # the training clipper, random-init 2x16, a random-walk R per sample
    # (bench.py:610-622)
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    ckt = make_training_clipper(root, 48000.0)
    r = np.exp(np.log(45e3) + np.cumsum(0.003 * rng.standard_normal((b, t)), axis=1))
    rows = {"Vs": {"R": torch.from_numpy(r.astype(np.float32)).to(dev)}}
    return ckt, {**ckt.init_params(dev), **root.init_params(dev)}, "Vs", None, rows


def _trajectory(fcirc, ckt, params, node, mlp, rows, vin, state, plain=False):
    kw = dict(input_node=node, row_controls=rows, return_state_seq=True)
    if mlp is not None:
        tree = {k: v for k, v in params.items() if k != "dp"}
        fn = (fcirc.fused_circuit_process_neural_plain if plain
              else fcirc.fused_circuit_process_neural)
        return fn(ckt, tree, mlp, vin, state, **kw)
    fn = fcirc.fused_circuit_process_plain if plain else fcirc.fused_circuit_process
    return fn(ckt, params, vin, state, **kw)


TRAIN_CASES = ["ts_2x16", "ts_2x16_row", "hpf", "clipper_sample"]


@pytest.mark.gpu
@pytest.mark.parametrize("name", TRAIN_CASES)
def test_circuit_kernel_trajectory_matches_plain(circuit_cuda, name):
    """B7 with pot streams and the state trajectory, ragged B and T."""
    dev, fcirc = circuit_cuda
    b, t = 300, 100
    ckt, params, node, mlp, rows = _train_case(name, dev, b, t)
    vin, state = _circuit_inputs(ckt, dev, b, t, 0.5, seed=len(name))
    got = _trajectory(fcirc, ckt, params, node, mlp, rows, vin, state)
    want = _trajectory(fcirc, ckt, params, node, mlp, rows, vin, state, plain=True)
    torch.cuda.synchronize()
    assert fcirc.fused_circuit_process.launches == 1
    _close(got[0], want[0], 2e-5)
    for k, d in want[1].items():
        for f, z in d.items():
            _close(got[1][k][f], z, 2e-5)
    assert len(got[2]) == len(want[2]) > 0
    for a, w in zip(got[2], want[2]):
        _close(a, w, 2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name", TRAIN_CASES)
def test_adjoint_circuit_kernel_matches_plain(circuit_cuda, name):
    """B8 against the autograd VJP of the plain step over the kernel's own
    trajectory; T = 100 ends in a partial tile, walked first."""
    from diffwdf_tpu_torch.ops import parallel_bptt as pb

    dev, fcirc = circuit_cuda
    b, t = 300, 100
    ckt, params, node, mlp, rows = _train_case(name, dev, b, t)
    vin, state = _circuit_inputs(ckt, dev, b, t, 0.5, seed=len(name) + 1)
    _, _, seq = _trajectory(fcirc, ckt, params, node, mlp, rows, vin, state)
    gen = torch.Generator(device=dev).manual_seed(3)
    g_out = torch.randn(b, t, generator=gen, device=dev)
    lam_T = [torch.randn(b, generator=gen, device=dev) for _ in seq]
    tree = {k: v for k, v in params.items() if k != "dp"} if mlp is not None else params
    kw = dict(input_node=node, row_controls=rows, neural_mlp=mlp)
    pb.fused_backward.launches = 0
    got = pb.fused_backward(ckt, tree, vin, g_out, seq, lam_T, **kw)
    want = pb.fused_backward_plain(ckt, tree, vin, g_out, seq, lam_T, **kw)
    torch.cuda.synchronize()
    assert pb.fused_backward.launches == 1
    budget = 3e-4 if rows else 1e-4  # tests/test_parallel_bptt.py:303,415,537

    def rel(x, y):
        return float((x - y).abs().max() / y.abs().max().clamp_min(1e-12))

    assert rel(got[1], want[1]) < budget
    for k in range(len(seq)):
        assert rel(got[0][k], want[0][k]) < budget, k
        assert rel(got[2][k], want[2][k]) < budget, k


@pytest.mark.gpu
def test_fused_generic_op_grads_match_scan_on_card(circuit_cuda):
    """The differentiable op (B7 + B8 + the parameter pass) against autograd
    through Circuit.process on the card: TS with a random-init 2x8 root."""
    from diffwdf_tpu_torch.models.tube_screamer import make_tube_screamer
    from diffwdf_tpu_torch.ops import parallel_bptt as pb

    dev, fcirc = circuit_cuda
    b, t = 256, 64
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8)
    ckt = make_tube_screamer(root, 48000.0)
    rng = np.random.default_rng(0)
    vin = torch.from_numpy((0.5 * rng.standard_normal((b, t))).astype(np.float32)).to(dev)
    y = torch.from_numpy(rng.standard_normal((b, t)).astype(np.float32)).to(dev)

    def grads(run):
        params = {**ckt.init_params(dev), **root.init_params(dev)}
        leaves, _ = pb._flatten(params)
        for x in leaves:
            x.requires_grad_(True)
        v = vin.clone().requires_grad_(True)
        ((run(params, v) - y) ** 2).mean().backward()
        return [x.grad for x in leaves] + [v.grad]

    f = pb.make_fused_circuit_train_generic(ckt, input_node="Vin")
    z0 = [torch.zeros(b, device=dev) for _ in range(3)]
    pb.fused_backward.launches = 0
    got = grads(lambda p, v: f(p, v, z0)[0])
    want = grads(lambda p, v: ckt.process(p, ckt.init_state(dev), {"Vin": {"v": v.T}})[0].T)
    torch.cuda.synchronize()
    assert fcirc.fused_circuit_process.launches == 1 and pb.fused_backward.launches == 1
    for g, w in zip(got, want):
        if g is None or w is None:  # a leaf the step does not read (the source's R)
            assert g is None and w is None
            continue
        assert float((g - w).abs().max() / w.abs().max().clamp_min(1e-12)) < 5e-4


def _root_step_grads(ckt, params, f, vin, y, z0):
    """The root's leaves' cotangents (mlp_leaves order) of one fused_generic
    step of the Tube Screamer with only the root trained, as the benchmark's
    training cell runs it: the skip-free MSE of out against y."""
    leaves = [x.detach().clone().requires_grad_(True) for x in ct.mlp_leaves(params["dp"])]
    p = {**{k: v for k, v in params.items() if k != "dp"}, "dp": ct.mlp_tree(leaves)}
    ((f(p, vin, z0)[0] - y) ** 2).mean().backward()
    return [x.grad for x in leaves]


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1024, 8192])
def test_ts_root_pass3_matches_autograd_pass(circuit_cuda, b, monkeypatch):
    """The Tube Screamer 2x16's parameter pass on the card (B8 writes the
    root's a and G, B4's pass 3 takes them) against the autograd pass over
    the same lam (an adjoint program without the root's streams), at
    b x 2,048: every root leaf within queue C's 5e-4 (scaled: over the
    larger of its largest magnitude and the median leaf's, since the head's
    bias sums G over every sample and cancels to ~1e-6 of its terms), the
    head's bias within 16 epsilon of sum |G| of the exact sum of -G over
    the G that B8 wrote, the same bits on a second step, one count of
    B8.pass3 a step and none of B4.pass3 (the clipper's)."""
    import weakref

    from diffwdf_tpu_torch.ops import circuit_codegen as cg
    from diffwdf_tpu_torch.ops import parallel_bptt as pb

    dev, _ = circuit_cuda
    t = 2048
    ckt, params, node, _, _ = _train_case("ts_2x16", dev, b, t)
    vin, _ = _circuit_inputs(ckt, dev, b, t, 0.2, seed=b)
    y = 0.6 * torch.tanh(4.0 * vin)
    z0 = [torch.zeros(b, device=dev) for _ in range(3)]
    f = pb.make_fused_circuit_train_generic(ckt, input_node=node)
    pass_of_op, roots = pb.parameter_cotangents, []

    def parameter_cotangents(*args, **kw):  # the root streams B8 handed over
        roots.append(kw["root"])
        return pass_of_op(*args, **kw)

    monkeypatch.setattr(pb, "parameter_cotangents", parameter_cotangents)
    b8, b4 = pb.root_param_vjp.launches, ct.mlp_param_vjp.launches
    got = _root_step_grads(ckt, params, f, vin, y, z0)
    again = _root_step_grads(ckt, params, f, vin, y, z0)
    torch.cuda.synchronize()
    assert pb.root_param_vjp.launches - b8 == 2 and ct.mlp_param_vjp.launches == b4
    assert all(torch.equal(g, a) for g, a in zip(got, again))
    G = roots[0].G.double()
    bias_gap = abs(float(got[-1]) + float(G.sum())) / (float(torch.finfo(torch.float32).eps)
                                                       * float(G.abs().sum()))
    assert bias_gap < 16, bias_gap
    # an adjoint program without the root's streams: autograd's pass
    monkeypatch.setattr(cg, "root_streams", lambda emitter: False)
    monkeypatch.setattr(cg, "_adjoints", weakref.WeakKeyDictionary())
    want = _root_step_grads(ckt, params, f, vin, y, z0)
    torch.cuda.synchronize()
    assert pb.root_param_vjp.launches - b8 == 2 and roots[-1] is None  # no pass 3
    floor = float(np.median([float(w.abs().max()) for w in want]))
    for g, w in zip(got, want):
        gap = float((g - w).abs().max()) / max(float(w.abs().max()), floor)
        assert gap < 5e-4, (tuple(w.shape), gap)


@pytest.mark.gpu
def test_ts_train_step_never_waits_for_the_card(circuit_cuda):
    """After two warm-up steps, three fused_generic training steps of the
    Tube Screamer 2x16 with its root trained (init_state, B7's training
    form, the loss, B8, the root's pass 3, Adam) at 64 x 256 under
    ``torch.cuda.set_sync_debug_mode("error")``: no call waits for the
    card, no host value is copied to it (``h2d_copies`` unmoved), and
    pass 3 runs once a step."""
    from diffwdf_tpu_torch.runtime import profiler
    from diffwdf_tpu_torch.training.circuit_train import CircuitTrainConfig, make_train_step

    dev, _ = circuit_cuda
    b, t = 64, 256
    ckt, params, node, _, _ = _train_case("ts_2x16", dev, b, t)
    vin, _ = _circuit_inputs(ckt, dev, b, t, 0.2, seed=23)
    batches = {"x": vin, "y": 0.6 * torch.tanh(4.0 * vin)}
    cfg = CircuitTrainConfig(batch_size=t, engine="fused_generic", skip_samples=16)
    make_optimizer, train_step, _ = make_train_step(ckt, cfg, lambda p: p["dp"])
    opt = make_optimizer(params)
    for _ in range(2):
        train_step(params, opt, batches)
    torch.cuda.synchronize()
    c0 = profiler.counters()
    mode = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = [train_step(params, opt, batches)["loss"] for _ in range(3)]
    finally:
        torch.cuda.set_sync_debug_mode(mode)
    c1 = profiler.counters()
    assert (c1["h2d_copies"], c1["h2d_bytes"]) == (c0["h2d_copies"], c0["h2d_bytes"])
    assert c1["B8.pass3"] - c0["B8.pass3"] == 3 and c1["B8"] - c0["B8"] == 3
    assert all(np.isfinite(float(x)) for x in losses)


# ---------------------------------------------------------------------------
# The redesigned B7 and B8: the lane-cooperative forward of an NxH root and
# the two-pass adjoint (pass 1 over every (b, t), pass 2 the recursion)
# ---------------------------------------------------------------------------

# every r_kind of the NxH root: the folded R (TS, no pot), per row (drive pot
# per row) and per sample (drive pot per sample; the training clipper's R)
LANE_CASES = ["ts_2x16", "ts_2x16_row", "ts_2x16_sample", "clipper_sample"]


@pytest.mark.gpu
@pytest.mark.parametrize("lanes", [4, 8, 16])
@pytest.mark.parametrize("name", LANE_CASES)
def test_lane_kernel_matches_plain_and_one_thread_kernel(circuit_cuda, name, lanes):
    """B7's lane form at K lanes per stream, with and without the state
    trajectory, ragged B = 300 (not a multiple of the 8, 16 or 32 streams of
    a block) and T = 100: within 2e-5 of the plain version, and the bits of
    the one-thread kernel (lanes = 1), which runs the same MLP order.  The
    sweep's build (every K that divides H) gives K = 4, which lanes_for
    never picks for H = 16."""
    from diffwdf_tpu_torch.ops import circuit_codegen as cg

    dev, fcirc = circuit_cuda
    b, t = 300, 100
    ckt, params, node, mlp, rows = _train_case(name, dev, b, t)
    vin, state = _circuit_inputs(ckt, dev, b, t, 0.5, seed=len(name) + lanes)
    want = _trajectory(fcirc, ckt, params, node, mlp, rows, vin, state, plain=True)
    tree = {k: v for k, v in params.items() if k != "dp"} if mlp is not None else params
    prep = fcirc.prepare(ckt, tree, dev, input_node=node, neural_mlp=mlp, row_controls=rows,
                         shape=(b, t))
    assert prep.prog.emitter.r_kind == {"ts_2x16": "scalar", "ts_2x16_row": "row"}.get(
        name, "time")
    assert prep.prog.lanes == (1, 8, 16)
    prep = prep._replace(prog=cg.sweep_program(ckt, prep.prog))
    assert prep.prog.lanes == (1, 4, 8, 16)
    z0 = fcirc._state_stack(prep.prog, state, vin)
    for with_seq in (False, True):
        got = fcirc.launch(prep, vin, z0, with_seq, lanes=lanes)
        one = fcirc.launch(prep, vin, z0, with_seq, lanes=1)
        torch.cuda.synchronize()
        _close(got[0], want[0], 2e-5)
        _close(got[1], torch.stack([want[1][n][f] for n, f in prep.prog.state_order]), 2e-5)
        assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1])
        if with_seq:
            for k, w in enumerate(want[2]):
                _close(got[2][k], w, 2e-5)
            assert torch.equal(got[2], one[2])
    assert fcirc.fused_circuit_process.launches == 4


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["ts_2x16", "ts_2x16_sample"])
def test_lane_kernel_lanes_of_a_group_agree(circuit_cuda, name):
    """Every lane of a group ends every step with the same bits: the output,
    final state and trajectory written by each lane of the group in turn
    (the kernel's writer) are bit-identical, at K = 4 and 16 (the sweep's
    build)."""
    from diffwdf_tpu_torch.ops import circuit_codegen as cg

    dev, fcirc = circuit_cuda
    b, t = 300, 100
    ckt, params, node, mlp, rows = _train_case(name, dev, b, t)
    vin, state = _circuit_inputs(ckt, dev, b, t, 0.5, seed=3)
    prep = fcirc.prepare(ckt, {k: v for k, v in params.items() if k != "dp"}, dev,
                         input_node=node, neural_mlp=mlp, row_controls=rows, shape=(b, t))
    prep = prep._replace(prog=cg.sweep_program(ckt, prep.prog))
    z0 = fcirc._state_stack(prep.prog, state, vin)
    for lanes in (4, 16):
        first = fcirc.launch(prep, vin, z0, True, lanes=lanes, writer=0)
        for writer in range(1, lanes):
            got = fcirc.launch(prep, vin, z0, True, lanes=lanes, writer=writer)
            for x, y in zip(got, first):
                assert torch.equal(x, y), (lanes, writer)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fcirc.launch(prep, vin, z0, True, lanes=4, writer=4)
    with pytest.raises(ValueError, match="lanes"):
        fcirc.launch(prep, vin, z0, True, lanes=32)


@pytest.mark.gpu
def test_wrapper_picks_lanes_by_batch(circuit_cuda):
    """fused_circuit_process on an NxH root goes through the lane kernel at
    the K that lanes_for gives the batch; an analytic root (the diode pair)
    takes its pair form, K = 2, at every batch."""
    dev, fcirc = circuit_cuda
    ckt, params, node, amp, mlp = _circuit_case("ts_2x16", dev)
    prog = fcirc.prepare(ckt, params, dev, input_node=node, neural_mlp=mlp).prog
    assert prog.lanes == (1, 8, 16)
    assert [fcirc.lanes_for(prog, b) for b in (1, 1024, 2048, 4096, 8192)] == [16, 16, 16, 8, 8]
    ckt_a, params_a, node_a, _, _ = _circuit_case("ts", dev)
    prog_a = fcirc.prepare(ckt_a, params_a, dev, input_node=node_a).prog
    assert prog_a.lanes == (1, 2)
    assert [fcirc.lanes_for(prog_a, b) for b in (1, 1024, 2048, 4096, 8192)] == [2] * 5
    vin, state = _circuit_inputs(ckt, dev, 5, 64, amp, seed=1)
    got, _ = _run_circuit(fcirc, ckt, params, vin, state, node, mlp)
    want, _ = _run_circuit(fcirc, ckt, params, vin, state, node, mlp, plain=True)
    torch.cuda.synchronize()
    _close(got, want, 2e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("name,b", [("ts_2x16", 1024), ("ts_2x16", 375), ("ts_2x16_row", 375)])
def test_two_pass_adjoint_matches_one_pass_kernel_and_plain(circuit_cuda, name, b, monkeypatch):
    """B8's two passes at the training shapes against the autograd VJP of
    the plain step (relative 1e-4, 3e-4 with pots); and cut into time chunks
    under a small scratch cap, the whole call's bits, the root's streams
    included.  tests/test_torch_codegen.py holds the passes to the one-pass
    step's bits on the host."""
    from diffwdf_tpu_torch.ops import circuit_codegen as cg
    from diffwdf_tpu_torch.ops import parallel_bptt as pb

    dev, fcirc = circuit_cuda
    t = 2048
    ckt, params, node, mlp, rows = _train_case(name, dev, b, t)
    vin, state = _circuit_inputs(ckt, dev, b, t, 0.5, seed=b)
    _, _, seq = _trajectory(fcirc, ckt, params, node, mlp, rows, vin, state)
    gen = torch.Generator(device=dev).manual_seed(5)
    g_out = torch.randn(b, t, generator=gen, device=dev) / (b * t)
    lam_T = [torch.randn(b, generator=gen, device=dev) / b for _ in seq]
    tree = {k: v for k, v in params.items() if k != "dp"}
    kw = dict(input_node=node, row_controls=rows, neural_mlp=mlp)
    pb.fused_backward.launches = 0
    got = pb.fused_backward(ckt, tree, vin, g_out, seq, lam_T, **kw)
    prep = fcirc.prepare(ckt, tree, dev, input_node=node, neural_mlp=mlp, row_controls=rows,
                         shape=(b, t))
    zseq, lam_t = torch.stack(seq).contiguous(), torch.stack(lam_T).contiguous()
    monkeypatch.setattr(cg.AdjointProgram, "SCRATCH_CAP_BYTES", 16 * 2 ** 20)
    assert cg.adjoint_program(ckt, prep.prog).chunk(b, t) < t
    streams = (torch.empty_like(vin), torch.empty_like(vin))
    chunked = pb.launch_adjoint(ckt, prep, vin, g_out, zseq, lam_t, streams)
    want = pb.fused_backward_plain(ckt, tree, vin, g_out, seq, lam_T, **kw)
    torch.cuda.synchronize()
    assert pb.fused_backward.launches == 2
    for x, z in zip((torch.stack(got[0]), got[1], torch.stack(got[2])), chunked):
        assert torch.equal(x, z), float((x - z).abs().max())
    assert all(torch.equal(x, y) for x, y in zip(got[3][:2], streams))
    budget = 3e-4 if rows else 1e-4

    def rel(x, y):
        return float((x - y).abs().max() / y.abs().max().clamp_min(1e-12))

    assert rel(got[1], want[1]) < budget
    for k in range(len(seq)):
        assert rel(got[0][k], want[0][k]) < budget, k
        assert rel(got[2][k], want[2][k]) < budget, k


@pytest.mark.gpu
def test_fused_generic_training_matches_plain_versions_on_card(circuit_cuda, monkeypatch):
    """A short fused_generic run of the Tube Screamer with the pretrained 2x16
    on the card: its loss history through the new kernels matches the same
    run through the plain versions of B7, B8 and the parameter pass within
    rtol 5e-4 (tests/test_parallel_bptt.py:579)."""
    from diffwdf_tpu_torch.models import diode_clipper as tdc
    from diffwdf_tpu_torch.models.tube_screamer import make_tube_screamer
    from diffwdf_tpu_torch.ops import parallel_bptt as pb
    from diffwdf_tpu_torch.training.circuit_train import CircuitTrainConfig, train_clipper

    dev, fcirc = circuit_cuda
    n, t = 16, 512
    rng = np.random.default_rng(4)
    x = (0.2 * np.sin(2 * np.pi * 1000.0 * np.arange(n * t) / 48000.0)
         + 0.05 * rng.standard_normal(n * t)).astype(np.float32).reshape(n, t)
    x = torch.from_numpy(x).to(dev)
    aroot = DiodePairRoot(name="dp", diode=diode_1n4148_1u2d)  # the "measured" pair
    truth = make_tube_screamer(aroot, 48000.0, drive=0.5)
    y, _ = fcirc.fused_circuit_process(
        truth, {**truth.init_params(dev), **aroot.init_params(dev)}, x,
        {k: {"z": torch.zeros(n, device=dev)} for k in truth.init_state("cpu")},
        input_node="Vin")
    root, rp = tdc.make_root_from_zoo(4, device=dev)
    ckt = make_tube_screamer(root, 48000.0, drive=0.5)
    params = {**ckt.init_params(dev), **rp}
    cfg = CircuitTrainConfig(epochs=3, batch_size=t, engine="fused_generic", log_every=0)
    batches = {"x": x, "y": y}
    pb.fused_backward.launches = fcirc.fused_circuit_process.launches = 0
    _, hist = train_clipper(ckt, params, batches, batches, cfg,
                            trainable_filter=lambda p: p["dp"])
    torch.cuda.synchronize()
    assert (fcirc.fused_circuit_process.launches, pb.fused_backward.launches) == (6, 3)
    kernel_backward, pass3 = pb.fused_backward, pb.root_param_vjp.launches
    monkeypatch.setattr(pb, "fused_circuit_process_neural",
                        fcirc.fused_circuit_process_neural_plain)
    # the plain B8, and no root streams: the parameter pass's autograd
    monkeypatch.setattr(pb, "fused_backward",
                        lambda *args, **kw: (*pb.fused_backward_plain(*args, **kw)[:3], None))
    _, plain = train_clipper(ckt, params, batches, batches, cfg,
                             trainable_filter=lambda p: p["dp"])
    # the plain run launched nothing more
    assert (fcirc.fused_circuit_process.launches, kernel_backward.launches) == (6, 3)
    assert pb.root_param_vjp.launches == pass3
    assert hist["loss"][-1] < hist["loss"][0]
    for k in ("loss", "val_loss"):
        np.testing.assert_allclose(hist[k], plain[k], rtol=5e-4)


# ---------------------------------------------------------------------------
# The generated DEER kernel (ops.deer_circuit): the JAX suite's budgets
# against the exact recursion (tests/test_deer_circuit.py), kernel against
# plain within the same budget
# ---------------------------------------------------------------------------

# (name, zoo index, budget): the Tube Screamer (analytic "best", 1e-4), the
# HPF clipper (analytic, damped adaptive, 3e-4), the LPF clipper's 2x8 root
# at 48 kHz (5e-6)
DEER_CASES = [("ts", 0, 1e-4), ("hpf", 0, 3e-4), ("clip_2x8", 3, 5e-6)]


def _deer_case(name, index, dev):
    from diffwdf_tpu_torch.models.diode_clipper import (
        make_diode_clipper, make_hpf_diode_clipper, make_hpf_root_from_zoo, make_root_from_zoo)
    from diffwdf_tpu_torch.models.tube_screamer import make_tube_screamer

    # seeded blocks on which the plain solve converges (at 8 sweeps the Tube
    # Screamer's residual stays above 1e-3 on some guitar-level noise, in
    # the JAX kernel too; chip_smoke.py's kernels phase uses these seeds)
    rng = np.random.default_rng({"ts": 101, "clip_2x8": 115}.get(name, 0))
    if name == "ts":
        root, rp = make_root_from_zoo(index, device=dev)
        ckt, node, kw = make_tube_screamer(root, FS), "Vin", {}
        x = (0.2 * np.sin(2 * np.pi * 1000.0 * np.arange(2048) / FS)
             + 0.1 * rng.standard_normal(2048))
    elif name == "hpf":
        root, rp = make_hpf_root_from_zoo(index, device=dev)
        ckt, node = make_hpf_diode_clipper(root, FS), "Vs"
        kw = dict(sweeps=48, damping=0.5, adapt_tol=1e-5)
        x = 0.5 * np.random.default_rng(202).standard_normal(2048)  # a clear adaptive exit
    else:
        root, rp = make_root_from_zoo(index, device=dev)
        ckt, node, kw = make_diode_clipper(root, 48000.0), "Vs", {}
        x = 2.0 * rng.standard_normal(2048)
    vin = torch.from_numpy(x.astype(np.float32)).to(dev)
    return ckt, {**ckt.init_params(dev), **rp}, node, kw, vin


@pytest.mark.gpu
@pytest.mark.parametrize("name,index,budget", DEER_CASES, ids=[c[0] for c in DEER_CASES])
def test_deer_circuit_kernel_matches_plain_and_exact(circuit_cuda, name, index, budget):
    from diffwdf_tpu_torch.ops import deer_circuit as dc

    dev, fcirc = circuit_cuda
    dc.fused_deer_circuit.launches = dc.fused_deer_neural.launches = 0
    ckt, params, node, kw, vin = _deer_case(name, index, dev)
    neural = isinstance(ckt.root, NeuralDiodeRoot)
    fn, plain = ((dc.fused_deer_neural, dc.fused_deer_neural_plain) if neural
                 else (dc.fused_deer_circuit, dc.fused_deer_circuit_plain))
    out, st, res, n = fn(ckt, params, vin, input_node=node, return_info=True, **kw)
    p_out, p_st, p_res, p_n = plain(ckt, params, vin, input_node=node, return_info=True, **kw)
    z0 = {k: {f: torch.zeros(1, device=dev) for f in d} for k, d in ckt.init_state("cpu").items()}
    e_out, _ = fcirc.fused_circuit_process(ckt, params, vin[None], z0, input_node=node)
    torch.cuda.synchronize()
    assert (dc.fused_deer_neural if neural else dc.fused_deer_circuit).launches == 1
    assert float(n) == float(p_n) and float(res) < 1e-3
    _close(out, p_out, budget)
    _close(out, e_out[0], budget)
    for k, d in p_st.items():
        for f, z in d.items():
            assert abs(float(st[k][f]) - float(z)) <= budget


@pytest.mark.gpu
def test_deer_circuit_kernel_rejects_and_keeps_cpu_plain(circuit_cuda):
    from diffwdf_tpu_torch.ops import deer_circuit as dc

    dev, _ = circuit_cuda
    ckt, params, node, kw, vin = _deer_case("ts", 0, dev)
    with pytest.raises(ValueError, match="multiple of 1024"):
        dc.fused_deer_circuit(ckt, params, vin[:1000], input_node=node)
    dc.fused_deer_circuit.launches = 0
    cpu = {k: ({f: x.cpu() for f, x in v.items()} if isinstance(v, dict) else v)
           for k, v in params.items()}
    out, _, _ = dc.fused_deer_circuit(ckt, cpu, vin.cpu(), input_node=node)
    assert out.device.type == "cpu" and dc.fused_deer_circuit.launches == 0


def _one_launch(dc, fcirc, ckt, params, node, mlp, vin, kw, s0=None, entry=None):
    """B9 through ``launcher``: (out, zf, residual, sweeps run)."""
    prep = fcirc.prepare(ckt, params, vin.device, input_node=node, neural_mlp=mlp)
    s0 = dc._state_vector(prep, ckt, None, vin) if s0 is None else s0
    args = (ckt, prep, vin, s0, vin.shape[0] // 1024, kw.get("sweeps", 8),
            kw.get("relax_passes", 2), kw.get("damping", 1.0), kw.get("adapt_tol", 0.0),
            entry or dc.fused_deer_circuit)
    return dc.launcher(*args)()


@pytest.mark.gpu
@pytest.mark.parametrize("blocks", [1, 2, 16, 64])
def test_deer_circuit_cluster_kernel_at_sizes(circuit_cuda, blocks):
    """B9 on its cluster of 16 CTAs, the Tube Screamer at T = 1024 blocks:
    within 1e-4 of plain with 8 sweeps (both converged) and with none (the
    relaxations and the emit pass alone; the CPU tests hold that case to a
    one-thread walk's bits)."""
    from diffwdf_tpu_torch.ops import deer_circuit as dc

    dev, fcirc = circuit_cuda
    ckt, params, node, kw, _ = _deer_case("ts", 0, dev)
    T = 1024 * blocks
    rng = np.random.default_rng(101)
    x = 0.2 * np.sin(2 * np.pi * 1000.0 * np.arange(T) / FS) + 0.1 * rng.standard_normal(T)
    vin = torch.from_numpy(x.astype(np.float32)).to(dev)
    dc.fused_deer_circuit.launches = 0
    out, zf, res, n = (t.clone() for t in _one_launch(dc, fcirc, ckt, params, node, None, vin,
                                                      kw))
    p_out, _, p_res = dc.fused_deer_circuit_plain(ckt, params, vin, input_node=node)
    bare = _one_launch(dc, fcirc, ckt, params, node, None, vin, {"sweeps": 0})
    p_bare, _, _ = dc.fused_deer_circuit_plain(ckt, params, vin, input_node=node, sweeps=0)
    torch.cuda.synchronize()
    assert dc.fused_deer_circuit.launches == 2 and float(n) == 8
    _close(bare[0], p_bare, 1e-4)
    if float(p_res) < 1e-3:
        assert float(res) < 1e-3
        _close(out, p_out, 1e-4)
    else:  # 8 sweeps leave a long block unconverged: flagged, as plain is
        assert float(res) > 1e-3


@pytest.mark.gpu
def test_deer_circuit_cluster_kernel_adaptive_count_and_chain(circuit_cuda):
    """The HPF's adaptive exit at JAX's 20 sweeps (numpy seed 2, 0.5 N(0, 1));
    two chained 2x8-clipper blocks equal one solve within the suite's 2e-6
    for chained DEER blocks (tests/test_parallel_time_deer.py:89): each is
    within the DEER solve's convergence error of the recursion, 1.1e-6
    apart on one sample of 4,096 on an H100."""
    from diffwdf_tpu_torch.ops import deer_circuit as dc

    dev, fcirc = circuit_cuda
    ckt, params, node, kw, _ = _deer_case("hpf", 0, dev)
    quiet = torch.from_numpy((0.5 * np.random.default_rng(2).standard_normal(2048))
                             .astype(np.float32)).to(dev)
    _, _, _, n = _one_launch(dc, fcirc, ckt, params, node, None, quiet, kw)
    assert float(n) == 20
    ckt, params, node, kw, vin = _deer_case("clip_2x8", 3, dev)
    mlp = params[ckt.root.name]
    x = torch.cat([vin, vin.flip(0)])
    full = [t.clone() for t in _one_launch(dc, fcirc, ckt, params, node, mlp, x, kw)]
    a = [t.clone() for t in _one_launch(dc, fcirc, ckt, params, node, mlp, x[:2048], kw)]
    b = _one_launch(dc, fcirc, ckt, params, node, mlp, x[2048:], kw, s0=a[1],
                    entry=dc.fused_deer_neural)
    torch.cuda.synchronize()
    _close(torch.cat([a[0], b[0]]), full[0], 2e-6)


@pytest.mark.gpu
def test_deer_circuit_refused_cluster_launch_raises(circuit_cuda):
    """A root array too large for shared memory is refused with CUDA's
    message: nothing runs in its place and nothing is counted."""
    from diffwdf_tpu_torch.ops import deer_circuit as dc

    dev, fcirc = circuit_cuda
    ckt, params, node, kw, vin = _deer_case("ts", 0, dev)
    prep = fcirc.prepare(ckt, params, dev, input_node=node)
    s0 = dc._state_vector(prep, ckt, None, vin)
    dc.fused_deer_circuit.launches = 0
    huge = prep._replace(warr=torch.zeros(70000, device=dev))
    args = (ckt, huge, vin, s0, 2, 8, 2, 1.0, 0.0, dc.fused_deer_circuit)
    with pytest.raises(RuntimeError, match="CUDA error"):
        dc.launcher(*args)()
    torch.cuda.synchronize()
    assert dc.fused_deer_circuit.launches == 0
    assert dc.max_active_clusters(ckt, prep) >= 1


# ---------------------------------------------------------------------------
# The redesigned B6 (one Chebyshev segment a lane) and B7's diode-pair form
# (its two omega solves on a pair of lanes)
# ---------------------------------------------------------------------------

#: (padded degree, breaks, degrees) of the distilled roots the B6 card tests
#: run: the 1N4148 pair at every padded degree (three segments, K = 4), and
#: at 24 with eight segments (K = 8)
CHEB_ROOTS = [(d, (0.8, 4.0), (d, min(d, 16), min(d, 12))) for d in fc.CHEB_DEGREES] + [
    (24, (0.4, 0.8, 1.5, 2.5, 4.0, 8.0, 14.0), (24, 24, 16, 16, 16, 12, 12, 12))]
CHEB_SHAPES = [(1, 2048), (1000, 333), (8192, 2048)]


@pytest.fixture(scope="module")
def cheb_roots():
    """(padded degree, number of segments) -> the 1N4148 1U-1D pair distilled
    at the clipper's port R with those segments (``CHEB_ROOTS``)."""
    from diffwdf_tpu_torch.roots.distilled import distill_root

    root = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)
    r_port = 1.0 / (1.0 / R_SRC + 2.0 * CAP * FS)
    return {(d, len(degrees)): distill_root(root, root.init_params("cpu"), r_port, breaks=breaks,
                                            degrees=degrees)[0]
            for d, breaks, degrees in CHEB_ROOTS}


@pytest.mark.gpu
@pytest.mark.parametrize("b,t", CHEB_SHAPES)
@pytest.mark.parametrize("degree,n_seg", [(d, len(g)) for d, _, g in CHEB_ROOTS])
def test_cheb_lane_kernel_matches_one_thread_kernel_and_plain(circuit_cuda, cheb_roots, degree,
                                                               n_seg, b, t):
    """B6's lane kernel (``cheb_lanes_kernel<D, K>``, K = 4 up to four
    segments, else 8) lies within 1e-5 of the plain version (the suite's
    distilled budget) at every padded degree; two blocks with carried state
    equal one run within 1e-6.  tests/test_torch_cheb_lanes.py holds the
    lane step to the one-thread ``cheb_root<D>``'s bits on the host."""
    dev, _ = circuit_cuda
    root = cheb_roots[(degree, n_seg)]
    assert fc.cheb_parameters(root)[1] == degree and fc.cheb_lanes(n_seg) == (4 if n_seg <= 4
                                                                             else 8)
    vin, z0 = _inputs(dev, b, t, seed=degree + n_seg + b)
    got, got_z = fc.fused_clipper_cheb(vin, z0, root, R_SRC, CAP, fs=FS)
    want, want_z = fc.fused_clipper_cheb_plain(vin, z0, root, R_SRC, CAP, fs=FS)
    torch.cuda.synchronize()
    assert fc.fused_clipper_cheb.launches == 1
    _close(got, want, 1e-5)
    _close(got_z, want_z, 1e-5)
    h = t // 3
    h1, z1 = fc.fused_clipper_cheb(vin[:, :h], z0, root, R_SRC, CAP, fs=FS)
    h2, z2 = fc.fused_clipper_cheb(vin[:, h:], z1, root, R_SRC, CAP, fs=FS)
    torch.cuda.synchronize()
    _close(torch.cat([h1, h2], 1), got, 1e-6)
    _close(z2, got_z, 1e-6)


@pytest.mark.gpu
def test_cheb_kernels_keep_nan_in_the_same_places(circuit_cuda, distilled_root):
    """A NaN, an infinite and an out-of-range input: the lane kernel has NaN
    and non-finite values in the same places as the plain version, and the
    streams of ordinary input within 1e-5 of it."""
    dev, _ = circuit_cuda
    vin, z0 = _inputs(dev, 64, 256, seed=4)
    vin[0, 10] = float("nan")
    vin[1, 20] = float("inf")
    vin[2, 30] = 1e30
    vin[3, 40] = -25.0
    got, got_z = fc.fused_clipper_cheb(vin, z0, distilled_root, R_SRC, CAP, fs=FS)
    want, want_z = fc.fused_clipper_cheb_plain(vin, z0, distilled_root, R_SRC, CAP, fs=FS)
    torch.cuda.synchronize()
    assert bool(got.isnan().any()) and torch.equal(got.isnan(), want.isnan())
    assert torch.equal(got.isfinite(), want.isfinite())
    assert torch.equal(got_z.isnan(), want_z.isnan())
    assert torch.equal(got_z.isfinite(), want_z.isfinite())
    _close(got[3:], want[3:], 1e-5)
    _close(got_z[3:], want_z[3:], 1e-5)


# the analytic roots served through B7: the Tube Screamer ("best" and the
# plugin's "low"), the HPF clipper ("toms"), the LPF clipper
PAIR_CASES = ["ts", "ts_low", "hpf", "lpf"]


def _pair_case(name, dev):
    from diffwdf_tpu_torch.models import diode_clipper as tdc
    from diffwdf_tpu_torch.models.tube_screamer import make_tube_screamer

    if name == "ts_low":
        root = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d, quality="low")
        ckt = make_tube_screamer(root, FS, drive=0.5)
        return ckt, {**ckt.init_params(dev), **root.init_params(dev)}, "Vin", 0.2
    if name == "lpf":
        root = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)
        ckt = tdc.make_diode_clipper(root, FS)
        return ckt, {**ckt.init_params(dev), **root.init_params(dev)}, "Vs", 1.5
    ckt, params, node, amp, _ = _circuit_case(name, dev)
    return ckt, params, node, amp


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 3, 8192])
@pytest.mark.parametrize("name", PAIR_CASES)
def test_pair_form_matches_one_thread_kernel(circuit_cuda, name, b):
    """B7's diode-pair lane form (K = 2, the wrapper's choice at every B)
    gives the one-thread kernel's bits, with and without the state
    trajectory, whichever lane of the pair writes; the wrapper's output is
    the lane form's."""
    dev, fcirc = circuit_cuda
    ckt, params, node, amp = _pair_case(name, dev)
    t = 2048
    vin, state = _circuit_inputs(ckt, dev, b, t, amp, seed=b + len(name))
    prep = fcirc.prepare(ckt, params, dev, input_node=node)
    assert prep.prog.lanes == (1, 2) and fcirc.lanes_for(prep.prog, b) == 2
    z0 = fcirc._state_stack(prep.prog, state, vin)
    fcirc.fused_circuit_process.pair_launches = 0
    for with_seq in (False, True):
        one = fcirc.launch(prep, vin, z0, with_seq, lanes=1)
        for writer in (0, 1):
            got = fcirc.launch(prep, vin, z0, with_seq, lanes=2, writer=writer)
            torch.cuda.synchronize()
            assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1]), (with_seq, writer)
            if with_seq:
                assert torch.equal(got[2], one[2])
    served, _ = fcirc.fused_circuit_process(ckt, params, vin, state, input_node=node)
    torch.cuda.synchronize()
    assert torch.equal(served, one[0])
    assert fcirc.fused_circuit_process.launches == 7
    assert fcirc.fused_circuit_process.pair_launches == 5


@pytest.mark.gpu
@pytest.mark.parametrize("name", PAIR_CASES)
def test_pair_form_matches_plain_and_carries_state(circuit_cuda, name):
    """The pair form within 2e-5 of the plain version at a ragged (1000,
    333); two blocks with carried state equal one run within 1e-6."""
    dev, fcirc = circuit_cuda
    ckt, params, node, amp = _pair_case(name, dev)
    vin, state = _circuit_inputs(ckt, dev, 1000, 333, amp, seed=len(name) + 7)
    got, got_state = fcirc.fused_circuit_process(ckt, params, vin, state, input_node=node)
    want, want_state = fcirc.fused_circuit_process_plain(ckt, params, vin, state, input_node=node)
    h1, st = fcirc.fused_circuit_process(ckt, params, vin[:, :111], state, input_node=node)
    h2, st2 = fcirc.fused_circuit_process(ckt, params, vin[:, 111:], st, input_node=node)
    torch.cuda.synchronize()
    assert fcirc.fused_circuit_process.pair_launches >= 3
    _close(got, want, 2e-5)
    _close(torch.cat([h1, h2], 1), got, 1e-6)
    for k, d in want_state.items():
        for f, z in d.items():
            _close(got_state[k][f], z, 2e-5)
            _close(st2[k][f], got_state[k][f], 1e-6)


@pytest.mark.gpu
@pytest.mark.parametrize("iters", [1, 2, 3])
def test_omega_select_matches_omega_on_card(circuit_cuda, iters):
    """omega_select<ITERS> (branch-free, the generated forward's) gives
    omega(x, ITERS)'s bits on the card over a grid that crosses the region
    edges -1 and 2 and reaches both tails, at the zoo's Newton counts: so
    the generated forward keeps the bits it had with omega()."""
    dev, fcirc = circuit_cuda
    x = torch.cat([torch.linspace(-120.0, 200.0, 1_000_001), torch.linspace(-1.5, 2.5, 1_000_001),
                   torch.tensor([-1.0, 2.0, -0.99999994, 1.9999999, 0.0, -1e30, 1e30])]).to(dev)
    w_omega, w_select = fcirc.omega_forms(x, iters)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(w_omega[:-2]).all())
    assert torch.equal(w_omega.view(torch.int32), w_select.view(torch.int32))


@pytest.mark.gpu
def test_new_lane_kernels_raise_and_fall_back_to_nothing(circuit_cuda, distilled_root,
                                                          monkeypatch):
    """A refused B6 or B7 launch raises, and neither the one-thread kernel
    nor the plain version runs in its place: the counters stay put."""
    dev, fcirc = circuit_cuda
    vin, z0 = _inputs(dev, 8, 64, seed=5)
    params, _ = fc.cheb_arguments(distilled_root, dev)
    # a degree no kernel is built for: the launch function refuses it
    monkeypatch.setattr(fc, "cheb_arguments", lambda root, device: (params, 12))
    with pytest.raises(RuntimeError, match="CUDA error"):
        fc.fused_clipper_cheb(vin, z0, distilled_root, R_SRC, CAP, fs=FS)
    ckt, params_c, node, amp = _pair_case("ts", dev)
    cvin, state = _circuit_inputs(ckt, dev, 8, 64, amp, seed=6)
    prep = fcirc.prepare(ckt, params_c, dev, input_node=node)
    z = fcirc._state_stack(prep.prog, state, cvin)
    with pytest.raises(RuntimeError, match="CUDA error"):
        fcirc.launch(prep, cvin, z, lanes=2, writer=2)
    with pytest.raises(ValueError, match="lanes"):
        fcirc.launch(prep, cvin, z, lanes=4)
    torch.cuda.synchronize()
    assert fc.fused_clipper_cheb.launches == 0 and fcirc.fused_circuit_process.launches == 0


# --- pretraining, sweeps, ensembles and the parallel-in-time oracle ---------


@pytest.mark.gpu
def test_pretrain_graph_epochs_equal_eager_epochs(cuda):
    """Epochs replayed from the captured CUDA graphs give the eager steps'
    bits: the histories and the weights, one seed and three."""
    from diffwdf_tpu_torch.training import pretrain as tp

    cfg = tp.PretrainConfig(n_layers=2, layer_size=8, epochs=3, n_r=8, n_a=128,
                            learning_rate=1e-3, schedule="cosine")
    for seeds in ((0,), (0, 1, 2)):
        graph, eager = (tp._Trainer(diode_1n4148_1u1d, cfg, seeds, cuda) for _ in range(2))
        m_graph, m_eager = graph.run(True), eager.run(False)
        p_graph, p_eager = graph.params(True), eager.params(True)
        for k in ("loss", "mse", "esr"):
            np.testing.assert_array_equal(m_graph[k], m_eager[k])
        for a, b in zip(p_graph["layers"], p_eager["layers"]):
            assert torch.equal(a["kernel"], b["kernel"]) and torch.equal(a["bias"], b["bias"])
    assert (m_graph["loss"][:, -1] < m_graph["loss"][:, 0]).all()


@pytest.mark.gpu
def test_sweep_is_one_launch_and_matches_plain(circuit_cuda):
    from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper
    from diffwdf_tpu_torch.parallel.sweep import sweep_process

    dev, fcirc = circuit_cuda
    ckt = make_diode_clipper(DiodePairRoot(name="dp", diode=diode_1n4148_1u1d), FS)
    params = ckt.init_params(dev)
    r = torch.from_numpy(np.geomspace(1e3, 1e5, 300).astype(np.float32)).to(dev)
    vin = _inputs(dev, 1, 256)[0][0]
    out = sweep_process(ckt, params, {"Vs.R": r}, {"Vs": {"v": vin}}, device=dev)
    torch.cuda.synchronize()
    assert fcirc.fused_circuit_process.launches == 1
    z0 = {"C": {"z": torch.zeros(300, device=dev)}}
    want, _ = fcirc.fused_circuit_process_plain(ckt, params, vin.expand(300, -1).contiguous(), z0,
                                                input_node="Vs", row_controls={"Vs": {"R": r}})
    _close(out, want, 2e-5)
    # a swept capacitance: one launch per distinct value
    caps = torch.tensor([1e-9, 2.2e-9, 1e-9, 4.7e-9], device=dev)
    sweep_process(ckt, params, {"C.C": caps, "Vs.R": r[:4]}, {"Vs": {"v": vin}}, device=dev)
    assert fcirc.fused_circuit_process.launches == 1 + 3


@pytest.mark.gpu
def test_ensemble_is_one_launch_per_expert(circuit_cuda):
    from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper
    from diffwdf_tpu_torch.parallel.sweep import ensemble_process, stack_mlp_params

    dev, fcirc = circuit_cuda
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    mlps = [root.init_params(dev, torch.Generator().manual_seed(i))["dp"] for i in range(5)]
    vin = _inputs(dev, 1, 300, seed=3)[0][0]
    factory = lambda r: make_diode_clipper(r, FS)  # noqa: E731
    out = ensemble_process(factory, stack_mlp_params(mlps), root.activations,
                           {"Vs": {"v": vin}}, device=dev)
    torch.cuda.synchronize()
    assert fcirc.fused_circuit_process.launches == 5
    ckt = factory(root)
    for i, mlp in enumerate(mlps):
        want, _ = fcirc.fused_circuit_process_neural_plain(
            ckt, ckt.init_params(dev), mlp, vin[None], {"C": {"z": torch.zeros(1, device=dev)}},
            input_node="Vs")
        _close(out[i], want[0], 2e-5)
    assert float((out[0] - out[1]).abs().max()) > 1e-4


@pytest.mark.gpu
def test_deer_clipper_kernel_matches_the_parallel_time_oracle(cuda):
    """B5 against the trajectory solve in plain torch ops on the card (the
    JAX suite's clipper budget 1e-4, tests/test_parallel_time.py:28)."""
    from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper
    from diffwdf_tpu_torch.ops import parallel_time_deer as pd
    from diffwdf_tpu_torch.ops.parallel_time import parallel_time_process

    d = diode_1n4148_1u1d
    vin = (2.0 * torch.sin(2 * np.pi * 330.0 * torch.arange(2048) / FS)).to(cuda)
    out, _, _ = pd.fused_deer_clipper(vin, R_SRC, CAP, d.Is, d.Vt * d.nabla, d.N_up, d.N_down,
                                      fs=FS)
    ckt = make_diode_clipper(DiodePairRoot(name="dp", diode=d), FS, r_source=R_SRC, cap=CAP)
    want, resid = parallel_time_process(ckt, ckt.init_params(cuda), {"Vs": {"v": vin}},
                                        n_iters=16, return_residual=True, device=cuda)
    assert float(resid) < 1e-5
    _close(out, want, 1e-4)


@pytest.mark.gpu
def test_profiler_times_with_cuda_events(cuda):
    from diffwdf_tpu_torch.runtime import profiler

    x = torch.ones((512, 512), device=cuda)
    r = profiler.Timer(warmup=1, iters=5).time(lambda a: a @ a, [(x,)])
    assert r["mean_ms"] > 0
    assert isinstance(profiler.device_memory_stats(), dict)


def _bits(got, want):
    assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 777])
def test_ops_equal_their_wrappers_bit_for_bit(cuda, b):
    """The artifact's custom ops (ops/registry.py) launch what the wrappers
    launch: B2, B1 (lane form and one-thread form) and B7 (the diode pair's
    lane form and an NxH root's), the same bits, counted in the wrappers'
    counters: one launch for the op and one for the wrapper."""
    from diffwdf_tpu_torch.models.tube_screamer import make_tube_screamer
    from diffwdf_tpu_torch.ops import fused_circuit as fcirc
    from diffwdf_tpu_torch.ops import registry

    def counts():
        return {"B2": fc.fused_clipper_analytic.launches, "B1": fc.fused_clipper_neural.launches,
                "B7": fcirc.fused_circuit_process.launches}

    vin, z0 = _inputs(cuda, b, 300, seed=b)
    before = counts()
    d = diode_1n4148_1u1d
    args = (R_SRC, CAP, d.Is, d.Vt * d.nabla, d.N_up, d.N_down)
    _bits(registry.clipper_analytic(vin, z0, *args, FS, 3),
          fc.fused_clipper_analytic(vin, z0, *args, fs=FS, quality_iters=3))
    for n_layers, width in ((2, 16), (3, 8)):  # a lane family and one-thread-only
        root = NeuralDiodeRoot(name="dp", n_layers=n_layers, layer_size=width)
        mlp = root.init_params(cuda, torch.Generator().manual_seed(width))["dp"]
        _bits(registry.clipper_neural(vin, z0, registry.mlp_layers(mlp), R_SRC, CAP, FS),
              fc.fused_clipper_neural(vin, z0, mlp, R_SRC, CAP, fs=FS))
    for root in (DiodePairRoot(name="dp"), NeuralDiodeRoot(name="dp", layer_size=16)):
        ckt = make_tube_screamer(root, FS, drive=0.5)
        params = {**ckt.init_params(cuda), **root.init_params(cuda)}
        st = {k: {f: torch.zeros(b, device=cuda) for f in dd}
              for k, dd in ckt.init_state(cuda).items()}
        want, wz = fcirc.fused_circuit_process(ckt, params, 0.3 * vin, st, input_node="Vin")
        prep = fcirc.prepare(ckt, params, cuda, input_node="Vin")
        got = registry.circuit_forward(prep.prog.source, prep.prog.host_source, 0.3 * vin,
                                       torch.zeros(3, b, device=cuda), prep.vec, prep.rows,
                                       prep.times, prep.warr, fcirc.lanes_for(prep.prog, b))
        _bits(got, (want, torch.stack([wz[n][f] for n, f in prep.prog.state_order])))
    torch.cuda.synchronize()
    assert {k: v - before[k] for k, v in counts().items()} == {"B2": 2, "B1": 4, "B7": 4}


def _artifact_case(name, device):
    from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper, make_root_from_zoo
    from diffwdf_tpu_torch.models.tube_screamer import make_tube_screamer

    if name == "ts":
        root = DiodePairRoot(name="dp")
        ckt = make_tube_screamer(root, 48000.0, drive=0.5)
        return ckt, {**ckt.init_params(device), **root.init_params(device)}, "Vin", 0.5
    root, frag = make_root_from_zoo({"analytic": 0, "neural": 4}[name], device=device)
    ckt = make_diode_clipper(root, 48000.0)
    return ckt, {**ckt.init_params(device), **frag}, "Vs", 2.0


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["analytic", "neural", "ts"])
def test_artifact_crosses_devices(cuda, tmp_path, name):
    """An artifact exported on the CPU serves on the card and one exported on
    the card serves on the CPU, each within 1e-5 of the scan engine
    (tests/test_artifact.py:46); exported on the card, its blocks are the
    stream's exact runner's, bit for bit."""
    from diffwdf_tpu_torch.runtime.artifact import load_artifact, save_artifact
    from diffwdf_tpu_torch.runtime.stream import _generic_exact_runner, _lpf_exact_runner

    x = (np.sin(2 * np.pi * 220.0 * np.arange(1000) / 48000.0)).astype(np.float32)
    for made, served in (("cpu", cuda), (cuda, "cpu"), (cuda, cuda)):
        ckt, params, node, amp = _artifact_case(name, made)
        path = str(tmp_path / f"{name}_{torch.device(made).type}.pt2")
        save_artifact(path, ckt, params, input_node=node, block_len=256, fs=48000.0)
        art = load_artifact(path, device=served)
        y = art.run(amp * x)
        ref, _ = ckt.process(params, ckt.init_state(made),
                             {node: {"v": torch.from_numpy(amp * x).to(made)}})
        assert np.max(np.abs(y - ref.cpu().numpy())) < 1e-5, (made, served)
    run = _lpf_exact_runner(ckt) if node == "Vs" else _generic_exact_runner(ckt, node)
    state, st = art.init_state, ckt.init_state(cuda)
    for i in range(0, 512, 256):
        v = torch.from_numpy(amp * x[i: i + 256]).to(cuda)
        got, state = art.process(state, v)
        want, st = run(params, st, {node: {"v": v}}, {})
        assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# The multi-device layer at world size 1 under NCCL (parallel/), and builds
# of one generated source by concurrent builders
# ---------------------------------------------------------------------------


def _dp_case(engine, device):
    """A DP case at a small shape: the clipper's fused step (a seeded 2x16,
    one source R per row) or the HPF clipper's fused_generic step (1x4)."""
    from diffwdf_tpu_torch.models.diode_clipper import make_hpf_diode_clipper
    from diffwdf_tpu_torch.training.circuit_train import CircuitTrainConfig

    rng = np.random.default_rng(17)
    rows, t = 64, 256
    x = rng.standard_normal((rows, t)).astype(np.float32)
    batches = {"x": x, "y": np.tanh(x)}
    if engine == "fused":
        root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
        ckt = make_training_clipper(root, 48000.0)
        batches["r0"] = np.exp(rng.uniform(np.log(36e3), np.log(73e3), rows)).astype(np.float32)
    else:
        root = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
        ckt = make_hpf_diode_clipper(root, 48000.0)
    params = {**ckt.init_params(device),
              **root.init_params(device, torch.Generator().manual_seed(5))}
    cfg = CircuitTrainConfig(batch_size=t, learning_rate=3e-3, skip_samples=8, engine=engine)
    return ckt, params, {k: torch.from_numpy(v) for k, v in batches.items()}, cfg


def _root(params):
    return params["dp"]


def _flat_root(params):
    return [x.detach().cpu().numpy().copy() for x in _leaves_sorted(params["dp"])]


def _leaves_sorted(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves_sorted(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves_sorted(v)]
    return [tree]


def _nccl_rank(rank, world):
    """One rank under NCCL: the DP step of both fused engines (reduced
    gradient, params after a step, launches) and time-block serving of the
    LPF clipper with its exact handoff."""
    from diffwdf_tpu_torch.ops import fused_circuit as fcirc
    from diffwdf_tpu_torch.ops import parallel_bptt as pb
    from diffwdf_tpu_torch.parallel.data_parallel import make_dp_train_step
    from diffwdf_tpu_torch.parallel.mesh import make_mesh
    from diffwdf_tpu_torch.parallel.time_block import (time_block_process,
                                                       time_block_process_exact)
    from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper

    mesh = make_mesh((1, 1))
    out = {}
    for engine in ("fused", "fused_generic"):
        ckt, params, batches, cfg = _dp_case(engine, "cuda")
        counters = (fc.fused_clipper_neural_train_fwd, ct.clipper_adjoint,
                    fcirc.fused_circuit_process, pb.fused_backward)
        for c in counters:
            c.launches = 0
        make_optimizer, dp_train, _, prepare = make_dp_train_step(ckt, cfg, mesh, _root)
        p, b = prepare(params, batches)
        loss, _, grads = dp_train.grads_fn(p, b)
        dp_train(p, make_optimizer(p), b)
        out[engine] = {"loss": float(loss), "grads": [g.cpu().numpy() for g in
                                                      _leaves_sorted(grads)],
                       "p1": _flat_root(p), "launches": [c.launches for c in counters]}
    ckt = make_diode_clipper(DiodePairRoot(name="dp", diode=diode_1n4148_1u1d), 48000.0)
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    tmesh = make_mesh((1, 1))
    fcirc.fused_circuit_process.launches = 0
    tb = time_block_process(ckt, ckt.init_params("cuda"), {"Vs": {"v": x}}, tmesh, warmup=256)
    exact = time_block_process_exact(ckt, ckt.init_params("cuda"), {"Vs": {"v": x}}, tmesh)
    out["tb"] = {"out": tb.cpu().numpy(), "exact": exact.cpu().numpy(),
                 "launches": fcirc.fused_circuit_process.launches}
    return out


@pytest.mark.gpu
def test_world_one_nccl_matches_the_single_process_step_and_b7(cuda):
    """World size 1 under NCCL (a FileStore): the DP step of the fused
    (B3, B4) and fused_generic (B7, B8) engines against the single-process
    make_train_step (loss rtol 1e-5, gradient 1e-4 relative, params after a
    step atol 5e-6, tests/test_parallel.py:128-213), and time-block serving
    and its exact handoff against B7 over the whole signal (the one block
    is the whole signal: the same bits)."""
    from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper
    from diffwdf_tpu_torch.ops import fused_circuit as fcirc
    from diffwdf_tpu_torch.parallel.distributed import spawn
    from diffwdf_tpu_torch.training.circuit_train import make_loss_fn, make_train_step

    (res,) = spawn(_nccl_rank, 1, backend="nccl", device="cuda", timeout_s=300)
    for engine in ("fused", "fused_generic"):
        got = res[engine]
        kernels = slice(0, 2) if engine == "fused" else slice(2, 4)  # B3, B4 or B7, B8
        assert all(n > 0 for n in got["launches"][kernels]), (engine, got["launches"])
        ckt, params, batches, cfg = _dp_case(engine, cuda)
        batches = {k: v.to(cuda) for k, v in batches.items()}
        leaves = _leaves_sorted(params["dp"])
        for x in leaves:
            x.requires_grad_(True)
        loss, _ = make_loss_fn(ckt, cfg)(params, batches)
        grads = torch.autograd.grad(loss, leaves)
        np.testing.assert_allclose(got["loss"], float(loss.detach()), rtol=1e-5)
        for g, w in zip(got["grads"], grads):
            w = w.cpu().numpy()
            assert np.abs(g - w).max() / np.abs(w).max() < 1e-4, engine
        make_optimizer, step, _ = make_train_step(ckt, cfg, _root)
        ckt, params, batches, cfg = _dp_case(engine, cuda)
        step(params, make_optimizer(params), {k: v.to(cuda) for k, v in batches.items()})
        for g, w in zip(got["p1"], _flat_root(params)):
            np.testing.assert_allclose(g, w, atol=5e-6, err_msg=engine)
    ckt = make_diode_clipper(DiodePairRoot(name="dp", diode=diode_1n4148_1u1d), 48000.0)
    x = np.random.default_rng(3).standard_normal(4096).astype(np.float32)
    want, _ = fcirc.fused_circuit_process(ckt, ckt.init_params(cuda),
                                          torch.from_numpy(x).to(cuda)[None],
                                          {"C": {"z": torch.zeros(1, device=cuda)}},
                                          input_node="Vs")
    want = want[0].cpu().numpy()
    assert res["tb"]["launches"] == 2
    np.testing.assert_allclose(res["tb"]["out"], want, atol=1e-5)
    np.testing.assert_array_equal(res["tb"]["exact"], want)


def _generated_build_rank(rank, world, build_dir, source):
    """Two threads of this rank build one generated CUDA source at once."""
    import concurrent.futures
    from pathlib import Path

    from diffwdf_tpu_torch.ops import _build

    _build.BUILD_DIR = Path(build_dir)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        paths = list(ex.map(lambda _: _build.build_generated([source])[0], range(2)))
    return [str(p) for p in paths]


@pytest.mark.gpu
def test_concurrent_builds_of_one_generated_source(cuda, tmp_path):
    """Two processes of two threads each build one generated forward source
    with nvcc into one directory at once: one library, no temporary file
    left, and it serves the circuit with the wrapper's bits."""
    from pathlib import Path

    from diffwdf_tpu_torch.models.simple_circuits import make_rc_lowpass
    from diffwdf_tpu_torch.ops import _build
    from diffwdf_tpu_torch.ops import fused_circuit as fcirc
    from diffwdf_tpu_torch.parallel.distributed import spawn

    ckt = make_rc_lowpass(48000.0, r=2200.0)
    params = ckt.init_params(cuda)
    prep = fcirc.prepare(ckt, params, cuda, input_node="Vs")
    build_dir = tmp_path / "build"
    ranks = spawn(_generated_build_rank, 2, str(build_dir), prep.prog.source, timeout_s=600)
    so = {p for r in ranks for p in r}
    assert len(so) == 1
    stem = Path(so.pop()).stem
    assert sorted(p.name for p in build_dir.iterdir()) == [f"{stem}.cu", f"{stem}.log",
                                                          f"{stem}.so"]
    x = torch.from_numpy(np.random.default_rng(4).standard_normal((3, 500))
                         .astype(np.float32)).to(cuda)
    z0 = torch.zeros(len(prep.prog.state_order), 3, device=cuda)
    want = fcirc.launch(prep, x, z0)[0]
    old = _build.BUILD_DIR
    try:
        _build.BUILD_DIR = build_dir
        _build._generated_libs.pop(prep.prog.source, None)
        builds = _build.build_generated.builds
        got = fcirc.launch(prep, x, z0)[0]
        assert _build.build_generated.builds == builds  # loaded, not built again
    finally:
        _build.BUILD_DIR = old
        _build._generated_libs.pop(prep.prog.source, None)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# the roots the generated kernels took last: the distilled root's slope in
# B8 and B9, a general MLP root in B7's forward
# ---------------------------------------------------------------------------


@pytest.mark.gpu
@pytest.mark.parametrize("amp", [0.5, 2.0], ids=["quiet", "loud"])
def test_deer_circuit_kernel_on_the_distilled_root(circuit_cuda, distilled_root, amp):
    """B9 on the distilled clipper (its Jacobian from cheb_root_value_tangent)
    within 1e-6 of its plain version and of B6's scan of the same root, the
    residual below 1e-5 (tests/test_deer_circuit.py:57), on a quiet input
    and on a loud one that crosses both breaks."""
    from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper
    from diffwdf_tpu_torch.ops import deer_circuit as dc

    dev, _ = circuit_cuda
    ckt = make_diode_clipper(distilled_root, FS, R_SRC, CAP)
    params = ckt.init_params(dev)
    rng = np.random.default_rng(int(10 * amp))
    vin = torch.from_numpy((amp * rng.standard_normal(2048)).astype(np.float32)).to(dev)
    dc.fused_deer_circuit.launches = 0
    out, st, res = dc.fused_deer_circuit(ckt, params, vin, input_node="Vs")
    p_out, p_st, p_res = dc.fused_deer_circuit_plain(ckt, params, vin, input_node="Vs")
    scan, z = fc.fused_clipper_cheb(vin[None], torch.zeros(1, device=dev), distilled_root,
                                    R_SRC, CAP, fs=FS)
    torch.cuda.synchronize()
    assert dc.fused_deer_circuit.launches == 1
    assert float(res) < 1e-5 and float(p_res) < 1e-5
    _close(out, p_out, 1e-6)
    _close(out, scan[0], 1e-6)
    assert abs(float(st["C"]["z"]) - float(z[0])) <= 1e-6


@pytest.mark.gpu
@pytest.mark.parametrize("rows", [False, True], ids=["scalar_r", "row_r"])
def test_adjoint_circuit_kernel_on_the_distilled_root(circuit_cuda, distilled_root, rows,
                                                      monkeypatch):
    """B7's training form and B8 (pass 1 on cheb_root_tangent) on the
    distilled clipper against their plain versions (the adjoint 1e-4
    relative, 3e-4 with a per-row R, tests/test_parallel_bptt.py:303,537);
    cut into time chunks, the two passes give the whole call's bits."""
    from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper
    from diffwdf_tpu_torch.ops import circuit_codegen as cg
    from diffwdf_tpu_torch.ops import parallel_bptt as pb

    dev, fcirc = circuit_cuda
    b, t = 300, 100
    ckt = make_diode_clipper(distilled_root, FS, R_SRC, CAP)
    params = ckt.init_params(dev)
    vin, state = _circuit_inputs(ckt, dev, b, t, 2.0, seed=29)
    rc = None
    if rows:
        r = np.exp(np.random.default_rng(3).uniform(np.log(30e3), np.log(60e3), b))
        rc = {"Vs": {"R": torch.from_numpy(r.astype(np.float32)).to(dev)}}
    kw = dict(input_node="Vs", row_controls=rc)
    out, _, seq = fcirc.fused_circuit_process(ckt, params, vin, state, return_state_seq=True,
                                              **kw)
    p_out, _, p_seq = fcirc.fused_circuit_process_plain(ckt, params, vin, state,
                                                        return_state_seq=True, **kw)
    _close(out, p_out, 2e-5)
    _close(seq[0], p_seq[0], 2e-5)
    gen = torch.Generator(device=dev).manual_seed(5)
    g_out = torch.randn(b, t, generator=gen, device=dev)
    lam_T = [torch.randn(b, generator=gen, device=dev)]
    pb.fused_backward.launches = 0
    got = pb.fused_backward(ckt, params, vin, g_out, seq, lam_T, **kw)
    want = pb.fused_backward_plain(ckt, params, vin, g_out, seq, lam_T, **kw)
    prep = fcirc.prepare(ckt, params, dev, shape=(b, t), **kw)
    adj = cg.adjoint_program(ckt, prep.prog)
    monkeypatch.setattr(cg.AdjointProgram, "SCRATCH_CAP_BYTES", 4 * adj.scratch_floats(b, 32))
    assert adj.chunk(b, t) == 32
    chunked = pb.fused_backward(ckt, params, vin, g_out, seq, lam_T, **kw)
    torch.cuda.synchronize()
    assert pb.fused_backward.launches == 2
    budget = 3e-4 if rows else 1e-4

    def rel(x, y):
        return float((x - y).abs().max() / y.abs().max().clamp_min(1e-12))

    assert rel(got[1], want[1]) < budget
    assert rel(got[0][0], want[0][0]) < budget and rel(got[2][0], want[2][0]) < budget
    assert torch.equal(chunked[1], got[1]) and torch.equal(chunked[0][0], got[0][0])
    assert torch.equal(chunked[2][0], got[2][0])


@pytest.mark.gpu
@pytest.mark.parametrize("acts,widths", [
    (("tanh", "relu", "tanh", ""), (2, 8, 8, 8, 1)),
    (("sigmoid", "softmax", "linear", ""), (2, 12, 5, 7, 1)),
], ids=["relu_mixed", "unequal"])
def test_circuit_kernel_general_mlp_root(circuit_cuda, acts, widths):
    """B7's general MLP root (mlp_dense.cuh, one thread a stream) within
    2e-5 of its plain version at a ragged (B, T), the LPF clipper, and
    through the stream's exact runner at B = 1."""
    from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper
    from diffwdf_tpu_torch.runtime.stream import _lpf_exact_runner

    dev, fcirc = circuit_cuda
    rng = np.random.default_rng(len(widths))
    mlp = {"layers": [{"kernel": torch.from_numpy((rng.standard_normal((i, o)) / np.sqrt(i))
                                                  .astype(np.float32)).to(dev),
                       "bias": torch.from_numpy((0.3 * rng.standard_normal(o))
                                                .astype(np.float32)).to(dev)}
                      for i, o in zip(widths[:-1], widths[1:])]}
    root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    ckt = make_diode_clipper(root, FS)
    params = {**ckt.init_params(dev), **frag}
    vin, state = _circuit_inputs(ckt, dev, 1000, 300, 1.5, seed=3)
    got, got_state = fcirc.fused_circuit_process(ckt, params, vin, state, input_node="Vs")
    want, want_state = fcirc.fused_circuit_process_plain(ckt, params, vin, state,
                                                         input_node="Vs")
    run = _lpf_exact_runner(ckt)
    one, _ = run(params, ckt.init_state(dev), {"Vs": {"v": vin[0]}}, {})
    ref, _ = ckt.process(params, ckt.init_state(dev), {"Vs": {"v": vin[0]}})
    torch.cuda.synchronize()
    assert fcirc.fused_circuit_process.launches == 2
    _close(got, want, 2e-5)
    _close(got_state["C"]["z"], want_state["C"]["z"], 2e-5)
    _close(one, ref, 2e-5)


# ---------------------------------------------------------------------------
# B7's lane forms of the distilled root (one Chebyshev segment a lane) and
# of the general MLP root (its hidden layers split over the lanes)
# ---------------------------------------------------------------------------

#: the general MLP roots of the lane-form card tests: (activations, widths)
ROOT_LANE_MLPS = {
    "relu": (("tanh", "relu", "tanh", ""), (2, 8, 8, 8, 1)),
    "sigmoid": (("sigmoid", "sigmoid", "sigmoid", ""), (2, 8, 8, 8, 1)),
    "softmax": (("softmax", "relu", "softmax"), (2, 16, 16, 4)),  # K = 16; shared-memory weights
}


def _root_lane_case(name, dev, distilled_root):
    """(circuit, params, amplitude) of a lane-form case: the distilled LPF
    clipper, or the LPF clipper with a seeded general MLP root."""
    from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper

    if name == "distilled":
        ckt = make_diode_clipper(distilled_root, FS, R_SRC, CAP)
        return ckt, ckt.init_params(dev), 6.0
    acts, widths = ROOT_LANE_MLPS[name]
    rng = np.random.default_rng(len(name))
    mlp = {"layers": [{"kernel": torch.from_numpy((rng.standard_normal((i, o)) / np.sqrt(i))
                                                  .astype(np.float32)).to(dev),
                       "bias": torch.from_numpy((0.3 * rng.standard_normal(o))
                                                .astype(np.float32)).to(dev)}
                      for i, o in zip(widths[:-1], widths[1:])]}
    root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, acts)
    ckt = make_diode_clipper(root, FS)
    return ckt, {**ckt.init_params(dev), **frag}, 1.5


@pytest.mark.gpu
@pytest.mark.parametrize("b", [1, 37, 1024])
@pytest.mark.parametrize("name", ["distilled", "relu", "sigmoid", "softmax"])
def test_root_lane_forms_match_one_thread_kernel_and_plain(circuit_cuda, distilled_root, name,
                                                           b):
    """Every K of the sweep's build gives the one-thread kernel's bits, with
    and without the trajectory, whichever lane of the group writes; the
    wrapper takes the program's lane form (lanes_for) and lies within the
    budget of plain: the distilled root 1e-5, the general MLP 2e-5."""
    from diffwdf_tpu_torch.ops import circuit_codegen as cg

    dev, fcirc = circuit_cuda
    ckt, params, amp = _root_lane_case(name, dev, distilled_root)
    t = 512
    vin, state = _circuit_inputs(ckt, dev, b, t, amp, seed=b + len(name))
    prep = fcirc.prepare(ckt, params, dev, input_node="Vs")
    k = fcirc.lanes_for(prep.prog, b)
    assert k > 1 and k in prep.prog.lanes
    sweep = prep._replace(prog=cg.sweep_program(ckt, prep.prog))
    z0 = fcirc._state_stack(prep.prog, state, vin)
    for with_seq in (False, True):
        one = fcirc.launch(prep, vin, z0, with_seq, lanes=1)
        for lanes in sweep.prog.lanes[1:]:
            for writer in range(lanes):
                got = fcirc.launch(sweep, vin, z0, with_seq, lanes=lanes, writer=writer)
                torch.cuda.synchronize()
                assert torch.equal(got[0], one[0]) and torch.equal(got[1], one[1]), (
                    with_seq, lanes, writer)
                if with_seq:
                    assert torch.equal(got[2], one[2]), (lanes, writer)
    fcirc.fused_circuit_process.lane_launches = 0
    got, got_state, seq = fcirc.fused_circuit_process(ckt, params, vin, state, input_node="Vs",
                                                      return_state_seq=True)
    want, want_state, want_seq = fcirc.fused_circuit_process_plain(
        ckt, params, vin, state, input_node="Vs", return_state_seq=True)
    torch.cuda.synchronize()
    assert fcirc.fused_circuit_process.lane_launches == 1
    assert torch.equal(got, one[0]) and torch.equal(seq[0], one[2][0])
    budget = 1e-5 if name == "distilled" else 2e-5
    _close(got, want, budget)
    _close(got_state["C"]["z"], want_state["C"]["z"], budget)
    _close(seq[0], want_seq[0], budget)


@pytest.mark.gpu
def test_distilled_training_form_lanes_with_a_per_sample_r(circuit_cuda, distilled_root):
    """The training clipper with a per-sample source R (time slots) on the
    distilled root: the lane form's trajectory is the one-thread kernel's,
    and within 1e-5 of plain."""
    dev, fcirc = circuit_cuda
    ckt = make_training_clipper(distilled_root, FS)
    params = ckt.init_params(dev)
    b, t = 37, 300
    vin, state = _circuit_inputs(ckt, dev, b, t, 6.0, seed=41)
    walk = np.cumsum(0.02 * np.random.default_rng(5).standard_normal((b, t)), axis=1)
    rows = {"Vs": {"R": torch.from_numpy(np.exp(np.log(45e3) + walk).astype(np.float32))
                   .to(dev)}}
    kw = dict(input_node="Vs", row_controls=rows, return_state_seq=True)
    prep = fcirc.prepare(ckt, params, dev, input_node="Vs", row_controls=rows, shape=(b, t))
    assert prep.prog.lanes == (1, 4) and prep.prog.emitter.r_kind == "time"
    z0 = fcirc._state_stack(prep.prog, state, vin)
    one = fcirc.launch(prep, vin, z0, True, lanes=1)
    got, _, seq = fcirc.fused_circuit_process(ckt, params, vin, state, **kw)
    want, _, want_seq = fcirc.fused_circuit_process_plain(ckt, params, vin, state, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got, one[0]) and torch.equal(seq[0], one[2][0])
    _close(got, want, 1e-5)
    _close(seq[0], want_seq[0], 1e-5)


@pytest.mark.gpu
def test_root_lane_forms_refuse_lanes_they_lack(circuit_cuda, distilled_root):
    """A lanes value the program lacks raises before any launch, and a
    writer outside the group is refused by the kernel's launch function:
    nothing runs or counts in their place."""
    dev, fcirc = circuit_cuda
    for name in ("distilled", "relu"):
        ckt, params, amp = _root_lane_case(name, dev, distilled_root)
        vin, state = _circuit_inputs(ckt, dev, 8, 64, amp, seed=9)
        prep = fcirc.prepare(ckt, params, dev, input_node="Vs")
        z = fcirc._state_stack(prep.prog, state, vin)
        lacking = 8 if name == "distilled" else 4
        assert lacking not in prep.prog.lanes
        with pytest.raises(ValueError, match="lanes"):
            fcirc.launch(prep, vin, z, lanes=lacking)
        k = prep.prog.lanes[-1]
        with pytest.raises(RuntimeError, match="CUDA error"):
            fcirc.launch(prep, vin, z, lanes=k, writer=k)
    torch.cuda.synchronize()
    assert fcirc.fused_circuit_process.launches == 0
