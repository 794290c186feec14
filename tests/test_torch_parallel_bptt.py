"""diffwdf_tpu_torch's generic differentiable fused engine vs the JAX package.

On the CPU the engine's forward (``fused_circuit_process(...,
return_state_seq=True)``) and adjoint (``fused_backward``) run their plain
versions, so the autograd op of ``make_fused_circuit_train_generic`` is held
here on its arithmetic; the generated CUDA kernels are held against these
plain versions on a card (tests/test_torch_gpu.py) and their steps are
compiled for the host in tests/test_torch_codegen.py.  The JAX side runs
``make_fused_circuit_train_generic(interpret=True)`` at B = 1024 (its tile)
and T = 32, or jax.grad through ``circuit.process`` (the scan oracle).

Budgets are the JAX suite's (tests/test_parallel_bptt.py): forward, final
state and trajectory 5e-5 absolute (:63, :190; the random-init Tube
Screamer's capacitor states reach ~14 V); gradients relative to each leaf's largest
|gradient|: 5e-4 per leaf with no pot, the first MLP kernel, g_vin and g_z0
1e-4 (:74-81), 1e-3 per leaf with pots (:203, :372).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
from diffwdf_tpu.models import diode_clipper as jdc
from diffwdf_tpu.models import tube_screamer as jts
from diffwdf_tpu.ops import fused_circuit as jfc
from diffwdf_tpu.ops.parallel_bptt import make_fused_circuit_train_generic as jax_engine
from diffwdf_tpu.roots.neural import NeuralDiodeRoot as JaxNeuralDiodeRoot
from diffwdf_tpu_torch.models import diode_clipper as tdc
from diffwdf_tpu_torch.models import tube_screamer as tts
from diffwdf_tpu_torch.nn.convert import params_from_jax
from diffwdf_tpu_torch.ops import fused_circuit as tfc
from diffwdf_tpu_torch.ops import parallel_bptt as pb
from diffwdf_tpu_torch.ops.circuit_codegen import state_order
from diffwdf_tpu_torch.roots.diode import DiodePairRoot, diode_1n4148_1u1d
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot

FS = 48000.0
B, T = 1024, 32


@pytest.fixture(autouse=True)
def _fresh_counters():
    tfc.fused_circuit_process.launches = 0
    pb.fused_backward.launches = 0
    yield
    assert tfc.fused_circuit_process.launches == pb.fused_backward.launches == 0  # CPU: plain


def _case(name, b=B, t=T):
    """(JAX circuit, port circuit, JAX params, input node, state count, pot
    field or None, pot values (numpy) or None, vin, y)."""
    rng = np.random.default_rng(len(name))
    if name.startswith("ts"):
        jroot = JaxNeuralDiodeRoot(name="dp", n_layers=2, layer_size=8)
        jckt = jts.make_tube_screamer(jroot, FS)
        tckt = tts.make_tube_screamer(NeuralDiodeRoot(name="dp", n_layers=2, layer_size=8), FS)
        params = {**jckt.init_params(), **jroot.init_params(jax.random.PRNGKey(3))}
        node, S, amp = "Vin", 3, 0.5
        field, pot = None, None
        if name == "ts_2x8_row":  # the drive pot per row, R6 in [51k, 551k]
            field, pot = ("R6", "R"), jts.drive_to_r6(rng.uniform(0.0, 1.0, b))
    elif name == "hpf":
        jroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d, quality="best")
        jckt = jdc.make_hpf_diode_clipper(jroot, FS)
        tckt = tdc.make_hpf_diode_clipper(
            DiodePairRoot(name="dp", diode=diode_1n4148_1u1d, quality="best"), FS)
        params = {**jckt.init_params(), **jroot.init_params()}
        node, S, amp, field, pot = "Vs", 1, 1.0, None, None
    else:  # the training clipper with a random-walk source R per sample
        jroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
        jckt = jdc.make_training_clipper(jroot, FS)
        tckt = tdc.make_training_clipper(DiodePairRoot(name="dp", diode=diode_1n4148_1u1d), FS)
        params = {**jckt.init_params(), **jroot.init_params()}
        node, S, amp, field = "Vs", 1, 1.0, ("Vs", "R")
        pot = np.exp(np.log(45e3) + np.cumsum(0.02 * rng.standard_normal((b, t)), axis=1))
    vin = (amp * rng.standard_normal((b, t))).astype(np.float32)
    y = rng.standard_normal((b, t)).astype(np.float32)
    pot = None if pot is None else pot.astype(np.float32)
    return (jckt, tckt, jax.tree_util.tree_map(np.asarray, params), node, S, field, pot, vin, y)


def _leaf_names(tree, prefix=""):
    if isinstance(tree, dict):
        return [n for k in sorted(tree) for n in _leaf_names(tree[k], f"{prefix}{k}.")]
    if isinstance(tree, (list, tuple)):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}{i}.")]
    return [prefix[:-1]]


def _loss_jax(f, field, pot, y):
    def loss(p, v, z):
        out, zf = f(p, v, z, (jnp.asarray(pot),)) if field else f(p, v, z)
        return jnp.sum((out - y) ** 2) + sum(jnp.sum(3.0 * zz) for zz in zf)

    return loss


def _port_grads(f, params_np, vin, S, field, pot, y):
    """(loss, out, zf, {leaf name: grad}, g_vin, g_z0) of the port engine
    under the tests/test_parallel_bptt.py loss."""
    params = params_from_jax(params_np, "cpu")
    leaves, _ = pb._flatten(params)
    for x in leaves:
        x.requires_grad_(True)
    v = torch.from_numpy(vin).requires_grad_(True)
    z = [torch.zeros(vin.shape[0], requires_grad=True) for _ in range(S)]
    out, zf = f(params, v, z, (torch.from_numpy(pot),)) if field else f(params, v, z)
    loss = ((out - torch.from_numpy(y)) ** 2).sum() + sum((3.0 * zz).sum() for zz in zf)
    loss.backward()
    grads = {n: (x.grad if x.grad is not None else torch.zeros_like(x))
             for n, x in zip(_leaf_names(params), leaves)}
    return (loss.item(), out.detach(), [zz.detach() for zz in zf], grads, v.grad,
            [zz.grad for zz in z])


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def _assert_grads(got, want, leaf_budget, tight=1e-4):
    errs = {n: _rel(got[n].numpy(), want[n]) for n in want}
    assert all(e < leaf_budget for e in errs.values()), errs
    if "dp.layers.0.kernel" in errs:
        assert errs["dp.layers.0.kernel"] < tight, errs


@pytest.mark.parametrize("name", ["ts_2x8", "ts_2x8_row", "clipper_sample"])
def test_engine_matches_jax_engine(name):
    """Out, final state, trajectory, every parameter cotangent, g_vin and
    g_z0 against JAX's engine (Pallas forward and adjoint in interpret
    mode) at B = 1024."""
    jckt, tckt, params, node, S, field, pot, vin, y = _case(name)
    kw = {"row_fields": (field,)} if field else {}
    jf = jax_engine(jckt, input_node=node, interpret=True, **kw)
    z0 = [jnp.zeros(B) for _ in range(S)]
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jout, jzf = jf(jp, jnp.asarray(vin), z0, (jnp.asarray(pot),)) if field else jf(
        jp, jnp.asarray(vin), z0)
    gp, gv, gz = jax.grad(_loss_jax(jf, field, pot, y), argnums=(0, 1, 2))(
        jp, jnp.asarray(vin), z0)
    want = dict(zip(_leaf_names(params), map(np.asarray, jax.tree_util.tree_leaves(gp))))

    tf = pb.make_fused_circuit_train_generic(tckt, input_node=node, **kw)
    _, out, zf, got, g_vin, g_z0 = _port_grads(tf, params, vin, S, field, pot, y)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), atol=5e-5, rtol=0)
    for a, b in zip(zf, jzf):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=0)
    _assert_grads(got, want, 1e-3 if field else 5e-4)
    assert _rel(g_vin.numpy(), gv) < 1e-4
    assert all(_rel(a.numpy(), b) < 1e-4 for a, b in zip(g_z0, gz))

    # the trajectory the adjoint runs on, against JAX's forward kernel
    rc = {field[0]: {field[1]: pot}} if field else None
    state0 = {n: {f: np.zeros(B, np.float32) for f in d} for n, d in jckt.init_state().items()}
    jmlp = params.get("dp") if "layers" in params["dp"] else None
    if jmlp is not None:
        tree = {k: v for k, v in params.items() if k != "dp"}
        _, _, jseq = jfc.fused_circuit_process_neural(
            jckt, tree, jmlp, jnp.asarray(vin), state0, input_node=node, row_controls=rc,
            interpret=True, return_state_seq=True)
    else:
        _, _, jseq = jfc.fused_circuit_process(jckt, params, jnp.asarray(vin), state0,
                                               input_node=node, row_controls=rc,
                                               interpret=True, return_state_seq=True)
    tparams = params_from_jax(params, "cpu")
    trc = {field[0]: {field[1]: torch.from_numpy(pot)}} if field else None
    _, _, seq = tfc.fused_circuit_process(
        tckt, tparams, torch.from_numpy(vin),
        {n: {f: torch.zeros(B) for f in d} for n, d in tckt.init_state("cpu").items()},
        input_node=node, row_controls=trc, return_state_seq=True)
    assert len(seq) == len(jseq) == S
    for a, b in zip(seq, jseq):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=5e-5, rtol=0)


def test_hpf_analytic_matches_jax_scan():
    """HPF clipper with the analytic root (cotangents reach the diode physics
    through the implicit omega derivative) against jax.grad through JAX's
    ``circuit.process``."""
    b, t = 16, 48
    jckt, tckt, params, node, S, _, _, vin, y = _case("hpf", b, t)
    state0 = jckt.init_state()

    def jloss(p):
        out = jax.vmap(lambda vv: jckt.process(p, state0, {node: {"v": vv}})[0])(vin)
        return jnp.sum((out - y) ** 2)

    want = dict(zip(_leaf_names(params),
                    map(np.asarray, jax.tree_util.tree_leaves(jax.grad(jloss)(
                        jax.tree_util.tree_map(jnp.asarray, params))))))
    f = pb.make_fused_circuit_train_generic(tckt, input_node=node)
    tparams = params_from_jax(params, "cpu")
    leaves, _ = pb._flatten(tparams)
    for x in leaves:
        x.requires_grad_(True)
    out, _ = f(tparams, torch.from_numpy(vin), [torch.zeros(b)])
    ((out - torch.from_numpy(y)) ** 2).sum().backward()
    got = {n: x.grad for n, x in zip(_leaf_names(tparams), leaves)}
    _assert_grads(got, want, 1e-3)
    assert float(got["dp.Is"].abs()) > 0.0  # the physics gradients are real


@pytest.mark.parametrize("name", ["ts_2x8", "ts_2x8_row"])
def test_plain_backward_matches_port_scan(name):
    """``fused_backward_plain`` (through the engine) against autograd through
    the port's own ``Circuit.process`` with the rows as a trailing batch
    axis and each row's R6 as a static control."""
    b, t = 16, 48
    _, tckt, params, node, S, field, pot, vin, y = _case(name, b, t)
    f = pb.make_fused_circuit_train_generic(tckt, input_node=node,
                                            row_fields=(field,) if field else ())
    lf, _, _, got, g_vin, g_z0 = _port_grads(f, params, vin, S, field, pot, y)

    tparams = params_from_jax(params, "cpu")
    leaves, _ = pb._flatten(tparams)
    for x in leaves:
        x.requires_grad_(True)
    v = torch.from_numpy(vin).requires_grad_(True)
    z = {n: {fl: torch.zeros(b, requires_grad=True) for fl in d}
         for n, d in tckt.init_state("cpu").items()}
    static = {field[0]: {field[1]: torch.from_numpy(pot)}} if field else None
    out, zf = tckt.process(tparams, z, {node: {"v": v.T}}, static_controls=static)
    loss = ((out.T - torch.from_numpy(y)) ** 2).sum() + sum(
        (3.0 * zf[n][fl]).sum() for n, d in zf.items() for fl in d)
    loss.backward()
    np.testing.assert_allclose(lf, loss.item(), rtol=1e-5)
    want = {n: x.grad.numpy() if x.grad is not None else np.zeros(tuple(x.shape))
            for n, x in zip(_leaf_names(tparams), leaves)}
    _assert_grads(got, want, 1e-3 if field else 5e-4)
    assert _rel(g_vin.numpy(), v.grad.numpy()) < 1e-4
    z_grads = [z[n][fl].grad.numpy() for n, fl in state_order(tckt)]
    assert all(_rel(a.numpy(), w) < 1e-4 for a, w in zip(g_z0, z_grads))


def test_unused_outputs_and_row_values_get_zero_cotangents():
    """A loss of out alone (the final state's cotangents never made) equals
    the adjoint with explicit zeros; the pot values get zero cotangents; a
    call without gradients keeps no trajectory."""
    _, tckt, params, node, S, field, pot, vin, y = _case("ts_2x8_row", 8, 24)
    f = pb.make_fused_circuit_train_generic(tckt, input_node=node, row_fields=(field,))
    tparams = params_from_jax(params, "cpu")
    v = torch.from_numpy(vin).requires_grad_(True)
    r = torch.from_numpy(pot).requires_grad_(True)
    z0 = [torch.zeros(8) for _ in range(S)]
    out, _ = f(tparams, v, z0, (r,))
    out.sum().backward()
    assert torch.equal(r.grad, torch.zeros_like(r))
    state0 = {n: {fl: torch.zeros(8)} for n, fl in state_order(tckt)}
    _, _, seq = tfc.fused_circuit_process_neural(
        tckt, {k: x for k, x in tparams.items() if k != "dp"}, tparams["dp"],
        torch.from_numpy(vin), state0, input_node=node, row_controls={"R6": {"R": r.detach()}},
        return_state_seq=True)
    _, g_vin, _, _ = pb.fused_backward(
        tckt, {k: x for k, x in tparams.items() if k != "dp"}, torch.from_numpy(vin),
        torch.ones(8, 24), seq, [torch.zeros(8) for _ in range(S)], input_node=node,
        row_controls={"R6": {"R": r.detach()}}, neural_mlp=tparams["dp"])
    np.testing.assert_allclose(v.grad.numpy(), g_vin.numpy(), atol=1e-7, rtol=0)
    with torch.no_grad():
        out2, zf2 = f(tparams, v, z0, (r,))
    assert torch.equal(out2, out.detach()) and len(zf2) == S
    with pytest.raises(ValueError, match="row_vals"):
        f(tparams, v, z0, ())


def test_port_engine_modules_import_no_jax():
    import subprocess
    import sys
    from pathlib import Path

    code = ("import sys\n"
            "import diffwdf_tpu_torch.ops.parallel_bptt, diffwdf_tpu_torch.training.circuit_train\n"
            "import diffwdf_tpu_torch.data.synthetic\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'diffwdf_tpu'))\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=120, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr
