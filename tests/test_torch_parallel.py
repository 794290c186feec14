"""diffwdf_tpu_torch's multi-device layer (``parallel``) against the JAX package's.

The port's functions run in gloo processes at world sizes 2 and 4
(``parallel.distributed.spawn``: a FileStore, one thread a rank); each case
is held against the JAX function on a mesh of the same size, built from the
first D of the 8 virtual CPU devices (tests/conftest.py), on the same numpy
inputs and weights (carried across by ``nn.convert.params_from_jax``).  The
rank functions are module level and import torch and the port alone; JAX is
imported inside the reference helpers, which run in this process while the
ranks run.  On the CPU the kernels' plain versions run.

Budgets (tests/test_parallel.py): the time-block overlap against JAX's 2e-5
(the generic forward's budget), against the serial run 1e-5 (a sine at W for
1e-6) and 1e-4 (noise at W = 128, the pot-swept R); exact against serial
1e-6.  DP: loss rtol 1e-5, the reduced gradient 1e-4 of each leaf's largest
magnitude, params after a step atol 5e-6, replicas the same bits.  Time-block
training: loss rtol 1e-5, gradient 1e-3 relative.  Sharded sweeps and
ensembles 1e-6 of unsharded.
"""

import concurrent.futures
import ctypes
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from diffwdf_tpu_torch.models.diode_clipper import (make_diode_clipper, make_hpf_diode_clipper,
                                                    make_training_clipper)
from diffwdf_tpu_torch.nn.convert import params_from_jax
from diffwdf_tpu_torch.parallel.distributed import initialize, spawn
from diffwdf_tpu_torch.parallel.mesh import make_mesh
from diffwdf_tpu_torch.roots.diode import DiodePairRoot, diode_1n4148_1u1d
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.training.circuit_train import CircuitTrainConfig

FS = 48000.0
SPAWN_S = 120.0  # a spawned run's limit: it never hangs the suite
DP_LOSS_RTOL, DP_GRAD_REL, DP_PARAM_ATOL = 1e-5, 1e-4, 5e-6
TB_JAX = 2e-5


def _flat(tree, prefix=""):
    """{path: numpy leaf} of a params tree (dicts in key order, lists)."""
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}/{key}").items()}
    if isinstance(tree, (list, tuple)):
        return {k: v for i, x in enumerate(tree) for k, v in _flat(x, f"{prefix}/{i}").items()}
    x = tree.detach().cpu().numpy() if isinstance(tree, torch.Tensor) else np.asarray(tree)
    return {prefix: np.array(x, dtype=np.float32)}


def _rel(got: dict, want: dict) -> float:
    assert set(got) == set(want), (sorted(got), sorted(want))
    return max(float(np.max(np.abs(got[k] - want[k]))) / (float(np.max(np.abs(want[k]))) + 1e-12)
               for k in want)


def _spawn_beside(reference, fn, world, *args):
    """spawn(fn, world, *args) in a thread while ``reference()`` (the JAX
    side) runs here: (the ranks' results, the reference's)."""
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        ranks = ex.submit(spawn, fn, world, *args, timeout_s=SPAWN_S)
        want = reference()
        return ranks.result(), want


def _lpf():
    ckt = make_diode_clipper(DiodePairRoot(name="dp", diode=diode_1n4148_1u1d), FS)
    return ckt, ckt.init_params("cpu")


def _jax_lpf():
    import diffwdf_tpu as dwdf
    from diffwdf_tpu.models.diode_clipper import make_diode_clipper as jclipper

    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    ckt = jclipper(root, FS)
    return ckt, {**ckt.init_params(), **root.init_params()}


def _jax_mesh(devices8, shape):
    from diffwdf_tpu.parallel.mesh import make_mesh as jmesh

    return jmesh(shape, ("data", "time"), devices=devices8[:int(np.prod(shape))])


# ---------------------------------------------------------------------------
# time_block_process / _exact
# ---------------------------------------------------------------------------


def _tb_rank(rank, world, inputs, warmups, exact):
    from diffwdf_tpu_torch.parallel.time_block import (time_block_process,
                                                       time_block_process_exact)

    ckt, params = _lpf()
    mesh = make_mesh((1, world), device="cpu")
    out = {w: time_block_process(ckt, params, inputs, mesh, warmup=w, device="cpu").numpy()
           for w in warmups}
    if exact:
        out["exact"] = time_block_process_exact(ckt, params, inputs, mesh, device="cpu").numpy()
    return out


def _tb_case(case):
    """(world, inputs, warm-up lengths, serial budget at the last, exact)."""
    from diffwdf_tpu_torch.parallel.time_block import warmup_for_tolerance

    if case == "sine":
        n = np.arange(4 * 512)
        vin = (2.0 * np.sin(2 * np.pi * 330.0 * n / FS)).astype(np.float32)
        return 4, {"Vs": {"v": vin}}, (warmup_for_tolerance(787.0, FS, 1e-6),), 1e-5, False
    if case == "random":
        vin = (2.0 * np.random.default_rng(1).standard_normal(4 * 256)).astype(np.float32)
        return 4, {"Vs": {"v": vin}}, (8, 32, 128), 1e-4, True
    n = np.arange(2 * 512)
    vin = (2.0 * np.sin(2 * np.pi * 330.0 * n / FS)).astype(np.float32)
    r = np.linspace(30e3, 60e3, n.size).astype(np.float32)
    return 2, {"Vs": {"v": vin, "R": r}}, (256,), 1e-4, False


def _serial(inputs):
    """The port's plain B7 over the whole signal from zero state."""
    from diffwdf_tpu_torch.ops.fused_circuit import fused_circuit_process

    ckt, params = _lpf()
    fields = inputs["Vs"]
    rows = {"Vs": {"R": torch.from_numpy(fields["R"])[None]}} if "R" in fields else None
    out, _ = fused_circuit_process(ckt, params, torch.from_numpy(fields["v"])[None],
                                   {"C": {"z": torch.zeros(1)}}, input_node="Vs",
                                   row_controls=rows)
    return out[0].numpy()


@pytest.mark.parametrize("case", ["sine", "random", "pot"])
def test_time_block_process_matches_jax(devices8, case):
    """The overlap-save decode of the 330-Hz sine (W from the 1e-6 budget),
    noise at three warm-ups (the error falls with W; the exact handoff) and
    a pot-swept source R (an impedance field keeps its values in the first
    rank's prefix, else NaN fills block 0)."""
    world, inputs, warmups, budget, exact = _tb_case(case)

    def jax_side():
        import jax.numpy as jnp
        from diffwdf_tpu.parallel.time_block import time_block_process as jtb

        jck, jp = _jax_lpf()
        mesh = _jax_mesh(devices8, (1, world))
        jin = {"Vs": {f: jnp.asarray(v) for f, v in inputs["Vs"].items()}}
        return {w: np.asarray(jtb(jck, jp, jin, mesh, warmup=w)) for w in warmups}

    ranks, want = _spawn_beside(jax_side, _tb_rank, world, inputs, warmups, exact)
    serial = _serial(inputs)
    for other in ranks[1:]:  # every rank holds the same gathered output
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(other[k], v)
    got = ranks[0]
    errs = []
    for w in warmups:
        assert got[w].shape == serial.shape and np.all(np.isfinite(got[w]))
        np.testing.assert_allclose(got[w], want[w], atol=TB_JAX, err_msg=f"W={w} vs JAX")
        errs.append(float(np.max(np.abs(got[w] - serial))))
    assert errs[-1] < budget, errs
    if len(errs) > 1:
        assert errs[-1] < errs[0], errs  # the warm-up error falls with W
    if exact:
        np.testing.assert_allclose(got["exact"], serial, atol=1e-6)


def test_warmup_for_tolerance_equals_jax():
    from diffwdf_tpu.parallel.time_block import warmup_for_tolerance as jw
    from diffwdf_tpu_torch.parallel.time_block import warmup_for_tolerance

    for fc in (20.0, 100.0, 752.0, 787.0, 4000.0, 20000.0):
        for fs in (8000.0, 44100.0, 48000.0, 96000.0):
            for tol in (1e-3, 1e-6, 1e-9):
                assert warmup_for_tolerance(fc, fs, tol) == jw(fc, fs, tol), (fc, fs, tol)


# ---------------------------------------------------------------------------
# data parallel
# ---------------------------------------------------------------------------


def _dp_circuit(engine):
    if engine == "scan":
        root = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4)
        return make_training_clipper(root, 8000.0)
    if engine == "fused":
        return make_training_clipper(NeuralDiodeRoot(name="dp", n_layers=1, layer_size=8), FS)
    return make_hpf_diode_clipper(NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4), FS)


def _dp_cfg(engine):
    if engine == "scan":
        return dict(epochs=2, batch_size=128, max_chunks=8)
    return dict(epochs=2, batch_size=48, learning_rate=3e-3, skip_samples=8, engine=engine)


def _dp_rank(rank, world, engine, params_np, batches_np):
    from diffwdf_tpu_torch.parallel.data_parallel import make_dp_train_step

    ckt = _dp_circuit(engine)
    mesh = make_mesh((world, 1), device="cpu")
    make_optimizer, dp_train, dp_eval, prepare = make_dp_train_step(
        ckt, CircuitTrainConfig(**_dp_cfg(engine)), mesh, device="cpu")
    batches = {k: torch.from_numpy(v.copy()) for k, v in batches_np.items()}
    p, b = prepare(params_from_jax(params_np, "cpu"), batches)
    loss, _, grads = dp_train.grads_fn(p, b)
    ev = float(dp_eval(p, b)["loss"])
    opt = make_optimizer(p)
    m1 = dp_train(p, opt, b)
    p1 = _flat(p)
    dp_train(p, opt, b)
    return {"loss": float(loss), "step_loss": float(m1["loss"]), "grads": _flat(grads),
            "p1": p1, "p2": _flat(p), "eval": ev,
            "rows": int(b["x"].shape[0])}


def _dp_data(engine):
    """(JAX circuit, JAX params, numpy batches, JAX config)."""
    import jax
    import jax.numpy as jnp

    import diffwdf_tpu as dwdf
    from diffwdf_tpu.models.diode_clipper import (make_hpf_diode_clipper as jhpf,
                                                  make_training_clipper as jtrain)
    from diffwdf_tpu.roots.neural import NeuralDiodeRoot as JRoot
    from diffwdf_tpu.training.circuit_train import CircuitTrainConfig as JCfg
    from diffwdf_tpu.training.circuit_train import make_clipper_batches

    if engine == "scan":
        from diffwdf_tpu.data.synthetic import synth_clipper_measurement

        vin, vout = synth_clipper_measurement(dwdf.diode_1n4148_1u1d, 45e3, fs=8000.0,
                                              duration_s=0.5)
        data = {"x": vin, "r": np.full_like(vin, 45e3), "y": vout}
        root = JRoot(name="dp", n_layers=1, layer_size=4)
        ckt = jtrain(root, 8000.0)
        params = {**ckt.init_params(), **root.init_params(jax.random.PRNGKey(0))}
        cfg = JCfg(**_dp_cfg(engine))
        batches = make_clipper_batches(data, cfg.batch_size, cfg.max_chunks)
    else:
        rng = np.random.default_rng(23)
        n_seq, T = 16, 48
        r0 = np.exp(rng.uniform(np.log(36e3), np.log(73e3), n_seq)).astype(np.float32)
        if engine == "fused":
            root = JRoot(name="dp", n_layers=1, layer_size=8)
            ckt = jtrain(root, FS)
        else:
            root = JRoot(name="dp", n_layers=1, layer_size=4)
            ckt = jhpf(root, FS)
        xs = rng.standard_normal((n_seq, T)).astype(np.float32)
        params = {**ckt.init_params(), **root.init_params(jax.random.PRNGKey(1))}
        batches = {"x": jnp.asarray(xs),
                   "y": jnp.asarray(np.tanh(rng.standard_normal((n_seq, T))).astype(np.float32)),
                   "r0": jnp.asarray(r0)}
        cfg = JCfg(**_dp_cfg(engine))
    as_np = jax.tree_util.tree_map(np.asarray, params)
    return ckt, params, as_np, {k: np.asarray(v) for k, v in batches.items()}, cfg


@pytest.mark.parametrize("engine", ["scan", "fused", "fused_generic"])
def test_dp_train_step_matches_jax_and_single_process(devices8, engine):
    """Four gloo ranks, one block of rows each: the reduced gradient equals
    the single-process gradient (not 4x it: Adam is scale-invariant, so the
    params alone would not show a double count) and JAX's make_dp_train_step
    on a (4, 1) mesh, the loss matches both, the params after one Adam step
    match the port's single-process make_train_step (JAX's own test holds
    its DP step to its single-device step so), and every rank holds the
    same bits after two steps.  Against JAX's step the params are held on
    the elements whose gradient stands well above Adam's eps (|g| > 1e-6 of
    the largest): Adam's first step is lr g / (|g| + 1e-8), so a gradient
    element of ~1e-8 (the HPF root's) turns the two packages' 8e-6 relative
    difference into ~1e-4 of lr."""
    import jax

    from diffwdf_tpu.parallel.data_parallel import make_dp_train_step as jdp
    from diffwdf_tpu.training.circuit_train import make_loss_fn as jloss
    from diffwdf_tpu_torch.training.circuit_train import make_loss_fn, make_train_step

    jck, jparams, params_np, batches_np, jcfg = _dp_data(engine)

    def jax_side():
        opt, dp_step, _, prepare = jdp(jck, jcfg, _jax_mesh(devices8, (4, 1)))
        s = opt.init(jparams)
        p, s, b = prepare(jparams, s, {k: jax.numpy.asarray(v) for k, v in batches_np.items()})
        if hasattr(dp_step, "grads_fn"):
            _, _, g = dp_step.grads_fn(p, b)
        else:
            (_, _), g = jax.value_and_grad(jloss(jck, jcfg), has_aux=True)(jparams, b)
        p1, _, m = dp_step(p, s, b)
        return (float(m["loss"]), _flat(jax.tree_util.tree_map(np.asarray, g)),
                _flat(jax.tree_util.tree_map(np.asarray, p1)))

    ranks, (j_loss, j_grads, j_p1) = _spawn_beside(jax_side, _dp_rank, 4, engine, params_np,
                                                   batches_np)
    # the port's single-process step on all rows
    ckt, cfg = _dp_circuit(engine), CircuitTrainConfig(**_dp_cfg(engine))
    batches = {k: torch.from_numpy(v.copy()) for k, v in batches_np.items()}
    params = params_from_jax(params_np, "cpu")
    for x in _leaves(params):
        x.requires_grad_(True)
    loss1, _ = make_loss_fn(ckt, cfg)(params, batches)
    g1 = torch.autograd.grad(loss1, _leaves(params), allow_unused=True)
    single_grads = {k: g for k, g in zip(_flat(params), (_np(g) for g in g1))}
    make_optimizer, step, _ = make_train_step(ckt, cfg)
    params = params_from_jax(params_np, "cpu")
    step(params, make_optimizer(params), batches)
    single_p1 = _flat(params)

    got = ranks[0]
    assert [r["rows"] for r in ranks] == [len(batches_np["x"]) // 4] * 4
    for r in ranks:  # replicas: the same bits on every rank (a NaN's too)
        for k in got["p2"]:
            assert r["p1"][k].tobytes() == got["p1"][k].tobytes(), k
            assert r["p2"][k].tobytes() == got["p2"][k].tobytes(), k
        assert r["loss"] == got["loss"]
    np.testing.assert_allclose(got["loss"], float(loss1.detach()), rtol=DP_LOSS_RTOL)
    np.testing.assert_allclose(got["step_loss"], j_loss, rtol=DP_LOSS_RTOL)
    assert _rel(got["grads"], single_grads) < DP_GRAD_REL
    assert _rel(got["grads"], j_grads) < DP_GRAD_REL
    for k, v in single_p1.items():
        np.testing.assert_allclose(got["p1"][k], v, atol=DP_PARAM_ATOL, err_msg=k)
    g_max = max(float(np.abs(g).max()) for g in j_grads.values())
    assert set(j_p1) == set(got["p1"])
    for k, v in j_p1.items():
        big = np.abs(j_grads[k]) > 1e-6 * g_max
        np.testing.assert_allclose(got["p1"][k][big], v[big], atol=DP_PARAM_ATOL, err_msg=k)
    np.testing.assert_allclose(got["eval"], got["loss"], rtol=1e-6)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _np(g):
    return np.zeros(1, np.float32) if g is None else g.numpy()


# ---------------------------------------------------------------------------
# time-block training
# ---------------------------------------------------------------------------

TBT_CASES = {"1d": ((1, 4), False), "1d_emphasis": ((1, 4), True), "2axis": ((2, 2), False)}


def _tbt_rank(rank, world, case, params_np, x, y, warmup):
    from diffwdf_tpu_torch.parallel.time_block import make_time_block_train_step

    shape, emphasis = TBT_CASES[case]
    ckt = make_training_clipper(NeuralDiodeRoot(name="dp", n_layers=1, layer_size=4), FS)
    cfg = CircuitTrainConfig(learning_rate=3e-3 if case != "2axis" else 1e-3,
                             skip_samples=50, use_pre_emphasis=emphasis)
    mesh = make_mesh(shape, device="cpu")
    _, step, _ = make_time_block_train_step(ckt, cfg, mesh, warmup=warmup, device="cpu")
    params = params_from_jax(params_np, "cpu")
    loss, _, grads = step.grads_fn(params, x, y)
    out = {"loss": float(loss), "grads": _flat(grads)}
    if case == "1d":  # the root alone trains (the reference's in-circuit policy)
        make_optimizer, root_step, eval_step = make_time_block_train_step(
            ckt, cfg, mesh, warmup=warmup, trainable_filter=lambda p: p["dp"], device="cpu")
        opt = make_optimizer(params)
        out["before"] = float(eval_step(params, x, y)["loss"])
        for _ in range(2):
            root_step(params, opt, x, y)
        out["after"] = float(eval_step(params, x, y)["loss"])
    return out


@pytest.mark.parametrize("case", list(TBT_CASES))
def test_time_block_train_step_matches_jax(devices8, case):
    """Overlap-save BPTT on the training clipper (1x4 root): one sequence's
    blocks over a (1, 4) mesh, with and without the continuous
    pre-emphasis, and [4, T] rows over a (2, 2) mesh; the loss and the
    reduced gradient against JAX's make_time_block_train_step on the same
    mesh, and the loss falls after steps of the root."""
    import jax
    import jax.numpy as jnp

    from diffwdf_tpu.models.diode_clipper import make_training_clipper as jtrain
    from diffwdf_tpu.parallel.time_block import make_time_block_train_step as jtbt
    from diffwdf_tpu.parallel.time_block import warmup_for_tolerance
    from diffwdf_tpu.roots.neural import NeuralDiodeRoot as JRoot
    from diffwdf_tpu.training.circuit_train import CircuitTrainConfig as JCfg

    shape, emphasis = TBT_CASES[case]
    root = JRoot(name="dp", n_layers=1, layer_size=4)
    jck = jtrain(root, FS)
    jparams = {**jck.init_params(), **root.init_params(jax.random.PRNGKey(2))}
    rng = np.random.default_rng(31)
    if case == "2axis":
        x = (0.8 * rng.standard_normal((4, 2 * 1024))).astype(np.float32)
    else:
        x = (0.8 * rng.standard_normal(4 * 512)).astype(np.float32)
    y = np.tanh(0.8 * x).astype(np.float32)
    warmup = warmup_for_tolerance(1.0 / (2 * np.pi * 45e3 * 4.7e-9), FS, 1e-6)
    params_np = jax.tree_util.tree_map(np.asarray, jparams)

    def jax_side():
        cfg = JCfg(learning_rate=3e-3 if case != "2axis" else 1e-3, skip_samples=50,
                   use_pre_emphasis=emphasis)
        _, step, _ = jtbt(jck, cfg, _jax_mesh(devices8, shape), warmup=warmup)
        loss, _, g = step.grads_fn(jparams, jnp.asarray(x), jnp.asarray(y))
        return float(loss), _flat(jax.tree_util.tree_map(np.asarray, g))

    ranks, (j_loss, j_grads) = _spawn_beside(jax_side, _tbt_rank, 4, case, params_np, x, y,
                                             warmup)
    for r in ranks:
        np.testing.assert_allclose(r["loss"], j_loss, rtol=1e-5)
        assert _rel(r["grads"], j_grads) < 1e-3
    if case == "1d":
        assert ranks[0]["after"] < ranks[0]["before"], ranks[0]


def _tbt_distilled_rank(rank, world, cheb, params_np, x, y, warmup):
    from diffwdf_tpu_torch.parallel.time_block import make_time_block_train_step
    from diffwdf_tpu_torch.roots.distilled import PiecewiseChebRoot

    a_max, breaks, coeffs = cheb
    ckt = make_training_clipper(PiecewiseChebRoot(name="dp", a_max=a_max, breaks=breaks,
                                                  coeffs=coeffs), FS)
    cfg = CircuitTrainConfig(learning_rate=1e-3, skip_samples=50)
    mesh = make_mesh((1, world), device="cpu")
    _, step, _ = make_time_block_train_step(ckt, cfg, mesh, warmup=warmup, device="cpu")
    loss, _, grads = step.grads_fn(params_from_jax(params_np, "cpu"), x, y)
    return {"loss": float(loss), "grads": _flat(grads)}


def test_time_block_train_step_refuses_the_distilled_root(devices8):
    """The distilled root, which the step refused while no kernel had its
    tangent: JAX's distillation of the 1N4148 pair at the training
    clipper's port R in the training clipper, one sequence's blocks over
    two gloo ranks; the loss and the reduced gradient of the circuit's
    leaves (C, the source R; the root has none) against JAX's
    make_time_block_train_step on a (1, 2) mesh."""
    import jax
    import jax.numpy as jnp

    import diffwdf_tpu as dwdf
    from diffwdf_tpu.models.diode_clipper import make_training_clipper as jtrain
    from diffwdf_tpu.parallel.time_block import make_time_block_train_step as jtbt
    from diffwdf_tpu.parallel.time_block import warmup_for_tolerance
    from diffwdf_tpu.roots.distilled import distill_root
    from diffwdf_tpu.training.circuit_train import CircuitTrainConfig as JCfg

    r_port = 1.0 / (1.0 / 45e3 + 2.0 * 4.7e-9 * FS)
    diode = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d, quality="best")
    droot, _ = distill_root(diode, diode.init_params(), r_port)
    jck = jtrain(droot, FS)
    jparams = jck.init_params()
    rng = np.random.default_rng(43)
    x = (1.5 * rng.standard_normal(2 * 1024)).astype(np.float32)
    y = np.tanh(0.8 * x).astype(np.float32)
    warmup = warmup_for_tolerance(1.0 / (2 * np.pi * 45e3 * 4.7e-9), FS, 1e-6)
    cheb = (float(droot.a_max), tuple(float(b) for b in droot.breaks),
            tuple(np.asarray(c, np.float64) for c in droot.coeffs))

    def jax_side():
        _, step, _ = jtbt(jck, JCfg(learning_rate=1e-3, skip_samples=50),
                          _jax_mesh(devices8, (1, 2)), warmup=warmup)
        loss, _, g = step.grads_fn(jparams, jnp.asarray(x), jnp.asarray(y))
        return float(loss), _flat(jax.tree_util.tree_map(np.asarray, g))

    ranks, (j_loss, j_grads) = _spawn_beside(
        jax_side, _tbt_distilled_rank, 2, cheb, jax.tree_util.tree_map(np.asarray, jparams), x,
        y, warmup)
    assert set(j_grads) == {"/C/C", "/Vs/R"}
    for r in ranks:
        np.testing.assert_allclose(r["loss"], j_loss, rtol=1e-5)
        assert _rel(r["grads"], j_grads) < 1e-3


# ---------------------------------------------------------------------------
# the sweep's mesh
# ---------------------------------------------------------------------------


def _sweep_rank(rank, world, r_values, vin, stack_np, acts):
    from diffwdf_tpu_torch.parallel.sweep import ensemble_process, sweep_process

    ckt, params = _lpf()
    mesh = make_mesh((world, 1), device="cpu")
    inputs = {"Vs": {"v": vin}}
    ov = {"Vs.R": r_values}
    stack = params_from_jax(stack_np, "cpu")

    def factory(root):
        return make_diode_clipper(root, FS)

    return {"sweep": sweep_process(ckt, params, ov, inputs, mesh, device="cpu").numpy(),
            "sweep_one": sweep_process(ckt, params, ov, inputs, device="cpu").numpy(),
            "ens": ensemble_process(factory, stack, acts, inputs, mesh, device="cpu").numpy(),
            "ens_one": ensemble_process(factory, stack, acts, inputs, device="cpu").numpy()}


def test_sharded_sweep_and_ensemble_match_unsharded(devices8):
    """sweep_process and ensemble_process with a mesh: each of two ranks
    runs its block of the instances (experts), every rank gets the global
    (N, T), equal to the unsharded run and to JAX's sharded one."""
    import jax
    import jax.numpy as jnp

    from diffwdf_tpu.parallel import sweep as jsw
    from diffwdf_tpu.roots.neural import mlp_arch, mlp_init

    N, T = 16, 128
    r_values = np.linspace(1e3, 100e3, N).astype(np.float32)
    n = np.arange(T)
    vin = (2.0 * np.sin(2 * np.pi * 440.0 * n / FS)).astype(np.float32)
    sizes, acts = mlp_arch(1, 4)
    stack = jsw.stack_mlp_params([mlp_init(jax.random.PRNGKey(i), sizes) for i in range(4)])
    stack_np = jax.tree_util.tree_map(np.asarray, stack)

    def jax_side():
        from diffwdf_tpu.models.diode_clipper import make_diode_clipper as jclipper

        jck, jp = _jax_lpf()
        mesh = _jax_mesh(devices8, (2, 1))
        sweep = jsw.sweep_process(jck, jp, {"Vs.R": jnp.asarray(r_values)},
                                  {"Vs": {"v": jnp.asarray(vin)}}, mesh=mesh)
        ens = jsw.ensemble_process(lambda root: jclipper(root, FS), stack, acts,
                                   {"Vs": {"v": jnp.asarray(vin)}}, mesh=mesh)
        return np.asarray(sweep), np.asarray(ens)

    ranks, (j_sweep, j_ens) = _spawn_beside(jax_side, _sweep_rank, 2, r_values, vin, stack_np,
                                            tuple(acts))
    for r in ranks:
        assert r["sweep"].shape == (N, T) and r["ens"].shape == (4, T)
        np.testing.assert_allclose(r["sweep"], r["sweep_one"], atol=1e-6)
        np.testing.assert_allclose(r["ens"], r["ens_one"], atol=1e-6)
        np.testing.assert_allclose(r["sweep"], j_sweep, atol=2e-5)
        np.testing.assert_allclose(r["ens"], j_ens, atol=2e-5)


# ---------------------------------------------------------------------------
# distributed: measure_scaling, run_scaling_suite, initialize, spawn
# ---------------------------------------------------------------------------

#: the suite's curves at tiny shapes: {curve: (function, shape)}
TINY = {"dp_training": ("dp_training_scaling", dict(chunks_per_device=1, batch_size=32)),
        "dp_control": ("dp_concurrent_control", dict(chunks_per_device=1, batch_size=32)),
        "time_block": ("time_block_scaling", dict(t_per_device=128, warmup=32)),
        "time_block_control": ("time_block_concurrent_control",
                               dict(t_per_device=128, warmup=32)),
        "time_block_training": ("time_block_training_scaling",
                                dict(t_per_device=128, warmup=16))}


def _scaling_rank(rank, world):
    import functools

    from diffwdf_tpu_torch.parallel import scaling_bench
    from diffwdf_tpu_torch.parallel.distributed import measure_scaling

    for fn, shape in TINY.values():  # the suite looks its curves up when it runs
        setattr(scaling_bench, fn, functools.partial(getattr(scaling_bench, fn), **shape))

    ckt, params = _lpf()

    def make_step(mesh):
        from diffwdf_tpu_torch.parallel.mesh import shard_batches

        vin = torch.from_numpy(np.random.default_rng(0).normal(size=(2 * mesh.size(), 64))
                               .astype(np.float32))
        batch = shard_batches({"x": vin}, mesh, device="cpu")
        return lambda: ckt.process(params, ckt.init_state("cpu"), {"Vs": {"v": batch["x"].T}})

    return (measure_scaling(make_step, (1, 2, 4), iters=2, items_per_call=128, device="cpu"),
            scaling_bench.run_scaling_suite((1, 2), iters=1, device="cpu"))


def test_scaling_harness_keys_match_jax(devices8):
    """measure_scaling skips a mesh larger than the world and returns JAX's
    keys; run_scaling_suite at tiny shapes returns the five curves with
    JAX's keys and finite efficiencies, and its environment."""
    import jax

    from diffwdf_tpu.parallel.distributed import measure_scaling as jms

    jres = jms(lambda mesh: (lambda: jax.numpy.ones(3)), (1, 2), iters=1, items_per_call=4)
    ranks = spawn(_scaling_rank, 2, timeout_s=SPAWN_S)
    res, suite = ranks[0]
    assert set(res) == {1, 2}  # no mesh of 4 on two ranks
    for rec in res.values():
        assert set(rec) == set(jres[1]) and rec["mean_s"] > 0 and np.isfinite(rec["efficiency"])
    assert set(suite) == {"env", "note", "dp_training", "dp_control", "time_block",
                          "time_block_control", "time_block_training"}
    assert suite["note"] is None
    assert suite["env"]["backend"] == "cpu" and suite["env"]["n_devices"] == 2
    rate = {"dp_training": "items_per_s", "dp_control": "items_per_s"}
    for name in TINY:
        assert set(suite[name]) == {1, 2}, name
        for rec in suite[name].values():
            assert set(rec) == {"mean_s", rate.get(name, "samples_per_s"), "efficiency"}, name
            assert rec["mean_s"] > 0 and np.isfinite(rec["efficiency"]), name
    assert ranks[1][1]["dp_training"] == suite["dp_training"]  # the slowest rank's, on both


def test_collectives_stay_outside_autograd():
    """No module of the multi-device layer reaches DDP or the autograd-aware
    collectives of torch.distributed.nn (whose backward all-reduces again:
    a D-fold gradient), and every collective of parallel.mesh runs under
    no_grad."""
    import ast
    import inspect

    from diffwdf_tpu_torch.parallel import mesh

    def names(tree):  # the dotted names the code uses and imports (not its text)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                yield from (a.name for a in node.names)
            elif isinstance(node, ast.ImportFrom):
                yield from (f"{node.module}.{a.name}" for a in node.names)
            elif isinstance(node, ast.Attribute):
                yield ast.unparse(node)
            elif isinstance(node, ast.Name):
                yield node.id

    root = Path(mesh.__file__).parent
    for path in sorted(root.glob("*.py")):
        for name in names(ast.parse(path.read_text())):
            assert "DistributedDataParallel" not in name and "distributed.nn" not in name, \
                (path.name, name)
    for fn in (mesh.broadcast_, mesh.all_reduce_, mesh.all_gather, mesh.send_next,
               mesh.recv_prev):
        assert "@torch.no_grad()" in inspect.getsource(fn), fn.__name__


def test_initialize_is_a_no_op_for_one_process(monkeypatch):
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize(num_processes=1, device="cpu") is False
    assert initialize(device="cpu") is False
    assert not torch.distributed.is_initialized()


def _failing_rank(rank, world):
    if rank == 1:
        raise ValueError("rank 1 fails on purpose")
    torch.distributed.barrier()  # rank 0 would wait here for ever


def _sleeping_rank(rank, world):
    time.sleep(600)


def test_spawn_fails_on_a_failed_rank_within_its_limit():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="fails on purpose"):
        spawn(_failing_rank, 2, timeout_s=60.0)
    assert time.monotonic() - t0 < 30.0
    t0 = time.monotonic()
    with pytest.raises(TimeoutError):
        spawn(_sleeping_rank, 2, timeout_s=6.0)
    assert time.monotonic() - t0 < 20.0


# ---------------------------------------------------------------------------
# concurrent builds of one source (ops/_build.py)
# ---------------------------------------------------------------------------


def _host_source():
    from diffwdf_tpu_torch.models.simple_circuits import make_rc_lowpass
    from diffwdf_tpu_torch.ops.fused_circuit import prepare

    ckt = make_rc_lowpass(FS)
    return prepare(ckt, ckt.init_params("cpu"), "cpu", input_node="Vs").prog.host_source


def _build_rank(rank, world, build_dir, source):
    from diffwdf_tpu_torch.ops import _build

    _build.BUILD_DIR = Path(build_dir)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        paths = list(ex.map(lambda _: _build.build_host(source), range(2)))
    return [str(p) for p in paths]


def test_concurrent_host_builds_of_one_source(tmp_path):
    """Two processes, two threads each, build one generated host source at
    once into one directory: each gets the library, no temporary file is
    left, and the library loads and runs."""
    from diffwdf_tpu_torch.ops import _build

    source = _host_source()
    build_dir = tmp_path / "build"
    ranks = spawn(_build_rank, 2, str(build_dir), source, timeout_s=SPAWN_S)
    so = {p for r in ranks for p in r}
    assert len(so) == 1
    names = sorted(p.name for p in build_dir.iterdir())
    stem = Path(so.pop()).stem
    assert names == [f"{stem}.cpp", f"{stem}.so"], names
    assert _build.host_path(source).name == f"{stem}.so"
    assert ctypes.CDLL(str(build_dir / f"{stem}.so")).circuit_host_run is not None
