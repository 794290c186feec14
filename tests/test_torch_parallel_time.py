"""diffwdf_tpu_torch's parallel-in-time oracle vs the JAX package.

The cases of tests/test_parallel_time.py, each run through the port's
``ops.parallel_time`` and the JAX package's on the same seeded input, each
held to that file's tolerance against the sequential recursion of its own
package and against the JAX function: the clipper 1e-4 with a residual
below 1e-5, a linear circuit after one sweep 1e-5, the Tube Screamer 5e-4
(residual below 1e-4), a neural root 1e-4, implicit gradients rtol 2e-3 /
atol 1e-7 (against the port's BPTT through ``Circuit.process`` and against
JAX's implicit gradients), and the batched solver's knobs on the HPF
clipper (residuals below 1e-3, outputs 3e-4).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
import diffwdf_tpu_torch as tw
from diffwdf_tpu.models import diode_clipper as jdc
from diffwdf_tpu.models import tube_screamer as jts
from diffwdf_tpu.ops import parallel_time as jpt
from diffwdf_tpu.roots.neural import NeuralDiodeRoot as JaxNeuralDiodeRoot
from diffwdf_tpu_torch.models import diode_clipper as tdc
from diffwdf_tpu_torch.models import tube_screamer as tts
from diffwdf_tpu_torch.nn.convert import params_from_jax
from diffwdf_tpu_torch.ops import parallel_time as tpt
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot

FS = 48000.0


def _diode_pair(pkg, **kw):
    return pkg.DiodePairRoot(name="dp", diode=pkg.diode_1n4148_1u1d, **kw)


def _clipper(make_j, make_t, **kw):
    jroot, troot = _diode_pair(dwdf, **kw), _diode_pair(tw, **kw)
    jck, tck = make_j(jroot, FS), make_t(troot, FS)
    return (jck, {**jck.init_params(), **jroot.init_params()}), (tck, tck.init_params("cpu"))


def _scan(ckt, params, node, v):
    out, _ = ckt.process(params, ckt.init_state("cpu"), {node: {"v": torch.as_tensor(v)}})
    return out.detach().numpy()


def test_matches_scan_on_clipper():
    (jck, jp), (tck, tp) = _clipper(jdc.make_diode_clipper, tdc.make_diode_clipper)
    vin = (2.0 * np.sin(2 * np.pi * 330 * np.arange(1024) / FS)).astype(np.float32)
    got, resid = tpt.parallel_time_process(tck, tp, {"Vs": {"v": vin}}, n_iters=16,
                                           return_residual=True, device="cpu")
    jgot = jpt.parallel_time_process(jck, jp, {"Vs": {"v": jnp.asarray(vin)}}, n_iters=16)
    assert float(resid) < 1e-5, float(resid)
    np.testing.assert_allclose(got.numpy(), _scan(tck, tp, "Vs", vin), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-4)


def test_matches_scan_on_linear_circuit_one_iter():
    """For a linear circuit one Newton sweep is exact."""
    def build(pkg):
        C1 = pkg.Capacitor("C1", 1.0e-6)
        tree = pkg.Inverter("I1", pkg.Series("S1", pkg.Resistor("R1", 1000.0), C1))
        return pkg.Circuit(tree=tree, root=pkg.IdealVoltageSourceRoot("Vs"), fs=FS,
                           outputs=("C1",))

    jck, tck = build(dwdf), build(tw)
    tp = tck.init_params("cpu")
    vin = np.random.default_rng(0).normal(size=512).astype(np.float32)
    got = tpt.parallel_time_process(tck, tp, {"Vs": {"v": vin}}, n_iters=1, device="cpu")
    jgot = jpt.parallel_time_process(jck, jck.init_params(), {"Vs": {"v": jnp.asarray(vin)}},
                                     n_iters=1)
    np.testing.assert_allclose(got.numpy(), _scan(tck, tp, "Vs", vin), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-5)


def test_matches_scan_on_tube_screamer_multistate():
    """Multi-capacitor state (S=3): the full Jacobian composition path."""
    jroot, troot = _diode_pair(dwdf), _diode_pair(tw)
    jck, tck = jts.make_tube_screamer(jroot, FS, drive=0.8), tts.make_tube_screamer(troot, FS,
                                                                                     drive=0.8)
    jp, tp = {**jck.init_params(), **jroot.init_params()}, tck.init_params("cpu")
    vin = (0.2 * np.sin(2 * np.pi * 220 * np.arange(512) / FS)).astype(np.float32)
    got, resid = tpt.parallel_time_process(tck, tp, {"Vin": {"v": vin}}, n_iters=20,
                                           return_residual=True, device="cpu")
    jgot = jpt.parallel_time_process(jck, jp, {"Vin": {"v": jnp.asarray(vin)}}, n_iters=20)
    assert float(resid) < 1e-4, float(resid)
    np.testing.assert_allclose(got.numpy(), _scan(tck, tp, "Vin", vin), atol=5e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=5e-4)


def test_neural_root_supported():
    jroot = JaxNeuralDiodeRoot(name="dp", n_layers=1, layer_size=8)
    jck = jdc.make_diode_clipper(jroot, FS)
    jp = {**jck.init_params(), **jroot.init_params(jax.random.PRNGKey(0))}
    tck = tdc.make_diode_clipper(NeuralDiodeRoot(name="dp", n_layers=1, layer_size=8), FS)
    tp = params_from_jax(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    vin = (1.5 * np.random.default_rng(1).standard_normal(256)).astype(np.float32)
    got = tpt.parallel_time_process(tck, tp, {"Vs": {"v": vin}}, n_iters=16, device="cpu")
    jgot = jpt.parallel_time_process(jck, jp, {"Vs": {"v": jnp.asarray(vin)}}, n_iters=16)
    np.testing.assert_allclose(got.numpy(), _scan(tck, tp, "Vs", vin), atol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(jgot), atol=1e-4)


def test_implicit_gradients_match_bptt_and_jax():
    """Implicit-adjoint gradients at the converged trajectory == BPTT through
    the sequential recursion, and == JAX's implicit gradients (values and
    gradients with respect to params and the input)."""
    (jck, jp), (tck, tp) = _clipper(jdc.make_diode_clipper, tdc.make_diode_clipper)
    vin = (1.5 * np.random.default_rng(5).standard_normal(256)).astype(np.float32)
    target = torch.tanh(torch.tensor(vin))
    leaves = [("Vs", "R"), ("C", "C"), ("dp", "Is"), ("dp", "nabla")]

    def grads(run):
        p = {n: {f: x.clone().requires_grad_(True) for f, x in d.items()} for n, d in tp.items()}
        v = torch.tensor(vin, requires_grad=True)
        loss = torch.mean((run(p, v) - target) ** 2)
        g = torch.autograd.grad(loss, [p[n][f] for n, f in leaves] + [v])
        return float(loss.detach()), [x.numpy() for x in g]

    l1, g1 = grads(lambda p, v: tck.process(p, tck.init_state("cpu"), {"Vs": {"v": v}})[0])
    l2, g2 = grads(lambda p, v: tpt.parallel_time_process_implicit(
        tck, p, {"Vs": {"v": v}}, n_iters=20, device="cpu"))

    def jloss(p, v):
        out = jpt.parallel_time_process_implicit(jck, p, {"Vs": {"v": v}}, n_iters=20)
        return jnp.mean((out - jnp.tanh(jnp.asarray(vin))) ** 2)

    l3, (gp3, gv3) = jax.value_and_grad(jloss, argnums=(0, 1))(jp, jnp.asarray(vin))
    g3 = [np.asarray(gp3[n][f]) for n, f in leaves] + [np.asarray(gv3)]
    assert l2 == pytest.approx(l1, rel=1e-5) and l2 == pytest.approx(float(l3), rel=1e-5)
    for a, b, c in zip(g2, g1, g3):
        np.testing.assert_allclose(a, b, rtol=2e-3, atol=1e-7)
        np.testing.assert_allclose(a, c, rtol=2e-3, atol=1e-7)


def test_batched_forwards_solver_knobs():
    """parallel_time_batched forwards damping, return_residual and state0:
    the batched HPF solve needs the damped Newton of the single stream, and
    the per-stream residual certificate is reachable."""
    (jck, jp), (tck, tp) = _clipper(jdc.make_hpf_diode_clipper, tdc.make_hpf_diode_clipper,
                                    quality="best")
    vin = (2.0 * np.random.default_rng(3).standard_normal((4, 512))).astype(np.float32)
    ref = np.stack([_scan(tck, tp, "Vs", vin[b]) for b in range(4)])
    got, resid = tpt.parallel_time_batched(tck, tp, {"Vs": {"v": vin}}, n_iters=30,
                                           damping=0.5, return_residual=True, device="cpu")
    jgot, jres = jpt.parallel_time_batched(jck, jp, {"Vs": {"v": jnp.asarray(vin)}}, n_iters=30,
                                           damping=0.5, return_residual=True)
    assert resid.shape == (4,) and float(resid.max()) < 1e-3
    assert float(np.abs(got.numpy() - ref).max()) < 3e-4
    assert float(np.abs(got.numpy() - np.asarray(jgot)).max()) < 3e-4
    # a nonzero state0 seeds every stream
    z0 = {n: {f: torch.full((), 0.3) for f in d} for n, d in tck.init_state("cpu").items()}
    shifted = tpt.parallel_time_batched(tck, tp, {"Vs": {"v": vin}}, n_iters=30, damping=0.5,
                                        state0=z0, device="cpu")
    want = np.stack([tck.process(tp, z0, {"Vs": {"v": torch.tensor(vin[b])}})[0].numpy()
                     for b in range(4)])
    assert float(np.abs(shifted.numpy() - want).max()) < 3e-4


def test_single_stream_entry_refuses_a_batch():
    (_, _), (tck, tp) = _clipper(jdc.make_diode_clipper, tdc.make_diode_clipper)
    with pytest.raises(ValueError):
        tpt.parallel_time_process(tck, tp, {"Vs": {"v": np.zeros((2, 8), np.float32)}},
                                  device="cpu")
