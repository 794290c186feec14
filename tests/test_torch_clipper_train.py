"""diffwdf_tpu_torch's differentiable fused clipper vs the JAX package.

On the CPU the training forward (``fused_clipper_neural_train_fwd``) and the
adjoint (``clipper_adjoint``) run their plain versions, so the autograd op of
``make_fused_clipper_train`` is held here on its arithmetic; the CUDA kernels
are held against these plain versions on a card (tests/test_torch_gpu.py).
The JAX side runs its Pallas kernels in interpret mode at B = 1024, the JAX
tile, as tests/test_clipper_train.py runs them on the CPU.

Budgets are the JAX suite's (tests/test_clipper_train.py): forward atol
2e-5 on out, z_final and a_seq; loss rtol 1e-5 and gradients atol 2e-5
after dividing each by the largest |gradient| of its leaf; training loss
history rtol 5e-4.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
import diffwdf_tpu_torch as tw
from diffwdf_tpu.models.diode_clipper import make_training_clipper as jax_training_clipper
from diffwdf_tpu.ops.clipper_train import make_fused_clipper_train as jax_fused_train
from diffwdf_tpu.ops.fused_clipper import fused_clipper_neural_train_fwd as jax_train_fwd
from diffwdf_tpu.training import circuit_train as jct
from diffwdf_tpu.training.losses import esr as jesr, mse as jmse
from diffwdf_tpu_torch.models.diode_clipper import make_training_clipper
from diffwdf_tpu_torch.models.tube_screamer import drive_to_r6, make_tube_screamer
from diffwdf_tpu_torch.nn.convert import params_from_jax
from diffwdf_tpu_torch.ops import clipper_train as tct
from diffwdf_tpu_torch.ops import fused_clipper as tfc
from diffwdf_tpu_torch.training import circuit_train as tcirc
from diffwdf_tpu_torch.training.losses import esr, mse

FS = 48000.0
CAP = 4.7e-9
B, T = 1024, 128
SKIP = 32
FAMILIES = [(2, 16), (4, 8)]


@pytest.fixture(autouse=True)
def _fresh_counters():
    tfc.fused_clipper_neural_train_fwd.launches = 0
    tct.clipper_adjoint.launches = 0
    tfc.fused_clipper_neural.launches = 0
    tfc.fused_clipper_analytic.launches = 0


def _setup(n_layers, width, seed=3):
    """A seeded JAX NxH net and inputs (numpy), as tests/test_clipper_train.py
    builds them: per-row pot R spanning 10k..99k."""
    root = dwdf.NeuralDiodeRoot(name="dp", n_layers=n_layers, layer_size=width)
    mlp = jax.tree_util.tree_map(np.asarray, root.init_params(jax.random.PRNGKey(seed))["dp"])
    rng = np.random.default_rng(seed)
    vin = (2.0 * rng.standard_normal((B, T))).astype(np.float32)
    z0 = (0.1 * rng.standard_normal(B)).astype(np.float32)
    r_rows = np.geomspace(10e3, 99e3, B).astype(np.float32)
    return root.activations, mlp, vin, z0, r_rows


def _t(x):
    return torch.from_numpy(np.asarray(x))


def _port_scan(mlp, vin, z0, r_rows):
    """The port's scan engine: Circuit.process with the rows as a trailing
    batch axis and each row's R as a static control."""
    n_layers = len(mlp["layers"]) - 2
    root = tw.NeuralDiodeRoot(name="dp", n_layers=n_layers, layer_size=mlp["layers"][0]["kernel"].shape[1])
    ckt = make_training_clipper(root, FS, cap=CAP)
    params = {**ckt.init_params("cpu"), "dp": mlp}
    out, st = ckt.process(params, {"C": {"z": z0}}, {"Vs": {"v": vin.T}},
                          static_controls={"Vs": {"R": r_rows}})
    return out.T, st["C"]["z"]


def _torch_loss(run, y, mlp, vin, z0):
    out, zf = run(vin, z0, mlp)
    o, t = out[:, SKIP:], y[:, SKIP:]
    return mse(t, o) + esr(t, o) + 0.1 * torch.mean(zf ** 2)


def _torch_grads(run, mlp_np, vin, z0, y):
    """Loss and gradients (vin, z0, then each MLP leaf) of the
    tests/test_clipper_train.py loss through ``run``."""
    mlp = params_from_jax(mlp_np, "cpu")
    leaves = tct.mlp_leaves(mlp)
    for x in leaves:
        x.requires_grad_(True)
    v, z = _t(vin).requires_grad_(True), _t(z0).requires_grad_(True)
    loss = _torch_loss(run, _t(y), mlp, v, z)
    loss.backward()
    return loss.item(), [v.grad.numpy(), z.grad.numpy()] + [x.grad.numpy() for x in leaves]


def _assert_grads_close(got, want):
    for i, (a, b) in enumerate(zip(got, want)):
        scale = max(float(np.abs(b).max()), 1e-8)
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-5, rtol=0, err_msg=f"leaf {i}")


@pytest.mark.parametrize("n_layers,width", FAMILIES)
def test_train_fwd_plain_matches_jax_kernel(n_layers, width):
    _, mlp, vin, z0, r_rows = _setup(n_layers, width)
    want = jax_train_fwd(jnp.asarray(vin), jnp.asarray(z0), mlp, jnp.asarray(r_rows), CAP,
                         fs=FS, interpret=True)
    got = tfc.fused_clipper_neural_train_fwd(_t(vin), _t(z0), params_from_jax(mlp, "cpu"),
                                             _t(r_rows), CAP, fs=FS)
    for g, w, name in zip(got, want, ("out", "z_final", "a_seq")):
        assert tuple(g.shape) == tuple(w.shape), name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=2e-5, rtol=0, err_msg=name)
    # a_0 = (1 - p) z0 + p v0, p the row's parallel-adaptor coefficient
    g = 1.0 / r_rows.astype(np.float64) + 2.0 * CAP * FS
    p = (1.0 / r_rows) / g
    np.testing.assert_allclose(got[2][:, 0].numpy(), (1.0 - p) * z0 + p * vin[:, 0], atol=1e-6)
    assert tfc.fused_clipper_neural_train_fwd.launches == 0  # CPU tensors never launch


@pytest.mark.parametrize("n_layers,width", FAMILIES)
def test_fused_grads_match_jax_fused_op(n_layers, width):
    acts, mlp, vin, z0, r_rows = _setup(n_layers, width)
    y = np.tanh(0.5 * vin)
    jf = jax_fused_train(acts, CAP, FS, interpret=True)
    r_j = jnp.asarray(r_rows)

    def jloss(mlp_, vin_, z0_):
        out, zf = jf(vin_, z0_, mlp_, r_j)
        o, t = out[:, SKIP:], jnp.asarray(y)[:, SKIP:]
        return jmse(t, o) + jesr(t, o) + 0.1 * jnp.mean(zf ** 2)

    lj, (gm, gv, gz) = jax.value_and_grad(jloss, argnums=(0, 1, 2))(
        jax.tree_util.tree_map(jnp.asarray, mlp), jnp.asarray(vin), jnp.asarray(z0))
    want = [np.asarray(gv), np.asarray(gz)] + [
        np.asarray(l[k]) for l in gm["layers"] for k in ("kernel", "bias")]

    fused = tct.make_fused_clipper_train(acts, CAP, FS)
    lt, got = _torch_grads(lambda v, z, m: fused(v, z, m, _t(r_rows)), mlp, vin, z0, y)
    np.testing.assert_allclose(lt, float(lj), rtol=1e-5)
    _assert_grads_close(got, want)
    assert tfc.fused_clipper_neural_train_fwd.launches == tct.clipper_adjoint.launches == 0


@pytest.mark.parametrize("n_layers,width", FAMILIES)
def test_fused_grads_match_port_scan_engine(n_layers, width):
    acts, mlp, vin, z0, r_rows = _setup(n_layers, width, seed=7)
    y = np.tanh(0.5 * vin)
    fused = tct.make_fused_clipper_train(acts, CAP, FS)
    lf, gf = _torch_grads(lambda v, z, m: fused(v, z, m, _t(r_rows)), mlp, vin, z0, y)
    ls, gs = _torch_grads(lambda v, z, m: _port_scan(m, v, z, _t(r_rows)), mlp, vin, z0, y)
    np.testing.assert_allclose(lf, ls, rtol=1e-5)
    _assert_grads_close(gf, gs)


def test_adjoint_unused_outputs_count_as_zero():
    """A loss of out alone (g_zf never materialised) and one of z_final alone
    (g_out never materialised) give the gradients of the explicit zero
    cotangents."""
    acts, mlp, vin, z0, r_rows = _setup(1, 8, seed=5)
    vin, z0 = vin[:64, :48], z0[:64]
    r = _t(r_rows[:64])
    fused = tct.make_fused_clipper_train(acts, CAP, FS)
    tmlp = params_from_jax(mlp, "cpu")
    out, zf, a_seq = tfc.fused_clipper_neural_train_fwd(_t(vin), _t(z0), tmlp, r, CAP, fs=FS)
    for pick, g_out, g_zf in (
        (lambda o, z: o.sum(), torch.ones_like(out), torch.zeros_like(zf)),
        (lambda o, z: z.sum(), torch.zeros_like(out), torch.ones_like(zf)),
    ):
        v = _t(vin).requires_grad_(True)
        pick(*fused(v, _t(z0), tmlp, r)).backward()
        want, _, _ = tct.clipper_adjoint(a_seq, g_out, g_zf, r, tmlp, CAP, fs=FS)
        np.testing.assert_allclose(v.grad.numpy(), want.numpy(), atol=1e-7, rtol=0)


def _history_setup():
    """The config of tests/test_clipper_train.py's engine comparison: 1x8 root,
    8 kHz, three rows of 128 samples with hoisted R."""
    root = dwdf.NeuralDiodeRoot(name="dp", n_layers=1, layer_size=8)
    params = jax.tree_util.tree_map(np.asarray, {
        **jax_training_clipper(root, 8000.0, cap=CAP).init_params(),
        **root.init_params(jax.random.PRNGKey(4))})
    rng = np.random.default_rng(7)
    batches = {
        "x": rng.standard_normal((3, 128)).astype(np.float32),
        "y": np.tanh(rng.standard_normal((3, 128))).astype(np.float32),
        "r0": np.float32([10e3, 45e3, 99e3]),
    }
    return root, params, batches


@pytest.fixture(scope="module")
def jax_fused_history():
    root, params, batches = _history_setup()
    cfg = jct.CircuitTrainConfig(epochs=6, batch_size=128, learning_rate=3e-3,
                                 skip_samples=16, engine="fused")

    def only_root(grads):
        zeros = jax.tree_util.tree_map(jnp.zeros_like, grads)
        zeros["dp"] = grads["dp"]
        return zeros

    ckt = jax_training_clipper(root, 8000.0, cap=CAP)
    _, hist = jct.train_clipper(ckt, jax.tree_util.tree_map(jnp.asarray, params),
                                {k: jnp.asarray(v) for k, v in batches.items()}, cfg=cfg,
                                trainable_filter=only_root)
    return hist


@pytest.mark.parametrize("engine", ["fused", "scan"])
def test_train_clipper_history_matches_jax(engine, jax_fused_history):
    _, params, batches = _history_setup()
    root = tw.NeuralDiodeRoot(name="dp", n_layers=1, layer_size=8)
    ckt = make_training_clipper(root, 8000.0, cap=CAP)
    tparams = params_from_jax(params, "cpu")
    cfg = tcirc.CircuitTrainConfig(epochs=6, batch_size=128, learning_rate=3e-3,
                                   skip_samples=16, engine=engine)
    seen = []
    trained, hist = tcirc.train_clipper(
        ckt, tparams, {k: _t(v) for k, v in batches.items()}, cfg=cfg,
        trainable_filter=lambda p: p["dp"], on_epoch=lambda e, p, h: seen.append(e))
    np.testing.assert_allclose(hist["loss"], jax_fused_history["loss"], rtol=5e-4)
    assert hist["loss"][-1] < hist["loss"][0]
    assert seen == [0, 5] and hist["val_loss"] == []
    # only the root trained; the caller's params are untouched
    assert torch.equal(trained["Vs"]["R"], tparams["Vs"]["R"])
    assert torch.equal(trained["C"]["C"], tparams["C"]["C"])
    assert not torch.equal(trained["dp"]["layers"][0]["kernel"],
                           tparams["dp"]["layers"][0]["kernel"])
    assert not tparams["dp"]["layers"][0]["kernel"].requires_grad


def test_train_clipper_validation_and_adam_match_jax():
    """History keys with validation, and one Adam step of the port (torch.optim
    .Adam over the root's leaves) against optax.adam on the same gradients."""
    root_j, params, batches = _history_setup()
    root = tw.NeuralDiodeRoot(name="dp", n_layers=1, layer_size=8)
    ckt = make_training_clipper(root, 8000.0, cap=CAP)
    cfg = tcirc.CircuitTrainConfig(epochs=2, batch_size=128, learning_rate=3e-3,
                                   skip_samples=16, engine="scan")
    tb = {k: _t(v) for k, v in batches.items()}
    trained, hist = tcirc.train_clipper(ckt, params_from_jax(params, "cpu"), tb, tb, cfg=cfg,
                                        trainable_filter=lambda p: p["dp"])
    assert sorted(hist) == ["esr", "loss", "mse", "val_esr", "val_loss", "val_mse"]
    assert all(len(v) == 2 for v in hist.values())
    # validation runs after the step on the same batches: the next epoch's loss
    np.testing.assert_allclose(hist["val_loss"][0], hist["loss"][1], rtol=1e-6)

    jckt = jax_training_clipper(root_j, 8000.0, cap=CAP)
    jcfg = jct.CircuitTrainConfig(epochs=2, batch_size=128, learning_rate=3e-3,
                                  skip_samples=16, engine="scan")

    def only_root(grads):
        zeros = jax.tree_util.tree_map(jnp.zeros_like, grads)
        zeros["dp"] = grads["dp"]
        return zeros

    jb = {k: jnp.asarray(v) for k, v in batches.items()}
    jtrained, jhist = jct.train_clipper(jckt, jax.tree_util.tree_map(jnp.asarray, params), jb,
                                        jb, cfg=jcfg, trainable_filter=only_root)
    for k in hist:
        np.testing.assert_allclose(hist[k], jhist[k], rtol=5e-4, err_msg=k)
    # each Adam step moves a weight by up to lr; the frameworks' gradients
    # differ in rounding, which Adam's division by each gradient's own RMS
    # carries into the step: budget 1e-3 of lr
    for tl, jl in zip(trained["dp"]["layers"], jtrained["dp"]["layers"]):
        for key in ("kernel", "bias"):
            np.testing.assert_allclose(tl[key].numpy(), np.asarray(jl[key]),
                                       atol=1e-3 * cfg.learning_rate, rtol=0)


def test_engine_selection_and_fused_requirements():
    root = tw.NeuralDiodeRoot(name="dp", n_layers=1, layer_size=8)
    ckt = make_training_clipper(root, 8000.0, cap=CAP)
    params = {**ckt.init_params("cpu"), **root.init_params("cpu")}
    # the generic engine runs (its own tests: tests/test_torch_generic_training.py)
    generic = tcirc.make_forward_fn(ckt, tcirc.CircuitTrainConfig(engine="fused_generic"))
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 16)).astype(np.float32))
    np.testing.assert_allclose(
        generic(params, {"x": x}).numpy(),
        tcirc.make_forward_fn(ckt, tcirc.CircuitTrainConfig(engine="scan"))(
            params, {"x": x}).numpy(), atol=2e-5, rtol=0)
    with pytest.raises(ValueError):
        tcirc.make_forward_fn(ckt, tcirc.CircuitTrainConfig(engine="xla"))
    forward = tcirc.make_forward_fn(ckt, tcirc.CircuitTrainConfig(engine="fused"))
    x = torch.zeros(2, 16)
    with pytest.raises(ValueError, match="r0"):
        forward(params, {"x": x, "r": torch.full((2, 16), 1e4)})
    # no pot data: every row runs at the circuit's own source resistance
    scan = tcirc.make_forward_fn(ckt, tcirc.CircuitTrainConfig(engine="scan"))
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((2, 16)).astype(np.float32))
    np.testing.assert_allclose(forward(params, {"x": x}).numpy(),
                               scan(params, {"x": x}).numpy(), atol=2e-5, rtol=0)
    with pytest.raises(ValueError, match="NxH"):
        tct.make_fused_clipper_train(("relu", "tanh", ""), CAP, FS)


@pytest.mark.parametrize("engine,pot,error", [
    ("scan", {"pot_field": "C"}, NotImplementedError),
    ("fused", {"pot_field": "C"}, NotImplementedError),
    ("fused", {"pot_node": "C"}, ValueError),
    ("fused_generic", {"pot_node": "R6"}, None),
])
def test_pot_options_an_engine_cannot_drive_raise(engine, pot, error):
    """A pot option the engine would ignore is refused, not run as the
    default; fused_generic drives any node and field, as in JAX."""
    root = tw.NeuralDiodeRoot(name="dp", n_layers=1, layer_size=8)
    ckt = make_training_clipper(root, 8000.0, cap=CAP)
    if error is None:
        tcirc.make_forward_fn(ckt, tcirc.CircuitTrainConfig(engine=engine, **pot))
        ts = make_tube_screamer(root, 8000.0)
        forward = tcirc.make_forward_fn(ts, tcirc.CircuitTrainConfig(engine=engine, **pot))
        params = {**ts.init_params("cpu"), **root.init_params("cpu")}
        x = torch.zeros(2, 8)
        # R6 per row: each row's output as the circuit built at that drive
        r6 = torch.tensor([drive_to_r6(0.1), drive_to_r6(0.9)])
        out = forward(params, {"x": x + 0.1, "r0": r6})
        for row, drive in enumerate((0.1, 0.9)):
            ts_d = make_tube_screamer(root, 8000.0, drive=drive)
            want = tcirc.make_forward_fn(ts_d, tcirc.CircuitTrainConfig(engine="scan"))(
                {**ts_d.init_params("cpu"), **root.init_params("cpu")}, {"x": x[:1] + 0.1})
            np.testing.assert_allclose(out[row].detach().numpy(), want[0].numpy(), atol=2e-5)
    else:
        with pytest.raises(error):
            tcirc.make_forward_fn(ckt, tcirc.CircuitTrainConfig(engine=engine, **pot))
    tcirc.make_forward_fn(ckt, tcirc.CircuitTrainConfig(engine=engine, pot_node="Vs"))


def test_cpu_runs_launch_no_kernel():
    """Every path above ran on CPU tensors: the plain versions, no launch."""
    acts, mlp, vin, z0, r_rows = _setup(2, 4, seed=2)
    fused = tct.make_fused_clipper_train(acts, CAP, FS)
    tmlp = params_from_jax(mlp, "cpu")
    for x in tct.mlp_leaves(tmlp):
        x.requires_grad_(True)
    out, zf = fused(_t(vin[:16, :32]), _t(z0[:16]), tmlp, _t(r_rows[:16]))
    (out.sum() + zf.sum()).backward()
    assert all(x.grad is not None for x in tct.mlp_leaves(tmlp))
    counters = (tfc.fused_clipper_neural_train_fwd, tct.clipper_adjoint,
                tfc.fused_clipper_neural, tfc.fused_clipper_analytic)
    assert [c.launches for c in counters] == [0, 0, 0, 0]
