"""The distilled root's slope in the generated adjoint (B8) and DEER (B9)
steps, and the paths it opens, against the JAX package on the CPU.

The root is JAX's distillation of the 1N4148 1U-1D pair (quality "best") at
the LPF clipper's port R (96 kHz, 47 kOhm, 2.2 nF), crossed to the port with
``nn.convert.cheb_root_from_jax`` so that both packages hold the same
coefficients.

- The slope m = db/da of ``csrc/cheb.cuh``, as the generated DEER step and
  the adjoint's pass 1 compute it (host builds of the generated sources of
  a circuit whose root sees the capacitor's state, so a = z exactly: the
  DEER step's J and pass 1's first entry are m), against ``jax.jvp`` of
  ``PiecewiseChebRoot.reflect`` over a sweep and the tie grid (0, the
  breaks, a_max and the float just above each, and beyond a_max): within
  5e-6 relative everywhere, the same value at the ties.  ``torch.func.jvp``
  of ``cheb_eval`` (what the plain adjoint and DEER differentiate) agrees
  with both on the whole grid, ties included: its clips are a maximum and a
  minimum, whose slopes split a tie as JAX's clip does.  So do the plain
  DEER step's Jacobian (forward mode through ``fused_circuit.plain_step``)
  and the plain adjoint's one step back (``fused_backward_plain``).
- The plain DEER solve on the distilled clipper against JAX's
  ``fused_deer_circuit(interpret=True)`` and the JAX scan, on a quiet input
  and a loud one (N(0, 2^2), which crosses both breaks): 1e-6, residuals
  below 1e-5 (tests/test_deer_circuit.py:57).
- The fused_generic engine on the distilled clipper against JAX's
  ``make_fused_circuit_train_generic(interpret=True)`` at B = 1024, T = 32:
  forward 5e-5, each leaf's gradient 5e-4 of its largest, g_vin and g_z0
  1e-4 (tests/test_parallel_bptt.py:63,74-81); and ``train_clipper`` with
  both port engines against JAX's fused_generic history, C trained from 20%
  off, rtol 5e-4 (:578).

The CPU runs the plain versions; the kernels run on a card
(tests/test_torch_gpu.py, chip_smoke.py).
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.autograd.forward_ad as fwAD

import diffwdf_tpu as dwdf
from diffwdf_tpu.models import diode_clipper as jdc
from diffwdf_tpu.ops.deer_circuit import fused_deer_circuit as jax_deer
from diffwdf_tpu.ops.parallel_bptt import make_fused_circuit_train_generic as jax_engine
from diffwdf_tpu.roots import distilled as jdist
from diffwdf_tpu.training import circuit_train as jct
from diffwdf_tpu_torch.core.circuit import Circuit
from diffwdf_tpu_torch.core.elements import Capacitor
from diffwdf_tpu_torch.models import diode_clipper as tdc
from diffwdf_tpu_torch.nn.convert import cheb_root_from_jax, params_from_jax
from diffwdf_tpu_torch.ops import _build
from diffwdf_tpu_torch.ops import circuit_codegen as cg
from diffwdf_tpu_torch.ops import deer_circuit as dc
from diffwdf_tpu_torch.ops import fused_circuit as tfc
from diffwdf_tpu_torch.ops import parallel_bptt as pb
from diffwdf_tpu_torch.roots.distilled import cheb_eval
from diffwdf_tpu_torch.training import circuit_train as tct

FS = 96000.0
R_SRC, CAP = 47.0e3, 2.2e-9
R_PORT = 1.0 / (1.0 / R_SRC + 2.0 * CAP * FS)


@pytest.fixture(scope="module")
def roots():
    """(JAX distilled root, the port's with its coefficients)."""
    jroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d, quality="best")
    droot, err = jdist.distill_root(jroot, jroot.init_params(), R_PORT)
    assert err < 1e-4
    return droot, cheb_root_from_jax(droot)


@pytest.fixture(autouse=True)
def _no_launches():
    counters = (dc.fused_deer_circuit, tfc.fused_circuit_process, pb.fused_backward)
    for c in counters:
        c.launches = 0
    yield
    assert all(c.launches == 0 for c in counters)  # CPU tensors: plain versions


def _host(source):
    lib = ctypes.CDLL(str(_build.build_host(source)))
    vp, i = ctypes.c_void_p, ctypes.c_int
    if hasattr(lib, "circuit_deer_host_run"):
        lib.circuit_deer_host_run.argtypes = [vp] * 5 + [i] + [vp] * 2
    if hasattr(lib, "circuit_jacobian_host_run"):
        lib.circuit_jacobian_host_run.argtypes = [vp] * 5 + [i] * 4 + [vp] * 4
    return lib


def _tie_grid(droot):
    """(points, the grid's length): the grid (0, the breaks and a_max with
    the normal floats on either side of each, and beyond a_max), its
    negation, then a sweep."""
    f32 = np.float32
    grid = []
    for e in [f32(0.0)] + [f32(b) for b in droot.breaks] + [f32(droot.a_max)]:
        grid += [e] + [x for x in (np.nextafter(e, f32(np.inf)), np.nextafter(e, f32(-np.inf)))
                       if abs(x) >= np.finfo(f32).tiny]  # XLA's CPU flushes subnormals
    grid = np.array(grid + [1.25 * droot.a_max], f32)
    sweep = np.linspace(-25.0, 25.0, 4001).astype(f32)
    return np.concatenate([grid, -grid, sweep]).astype(f32), len(grid)


def test_generated_slope_matches_jax_on_the_tie_grid(roots):
    droot, troot = roots
    a, n_grid = _tie_grid(droot)
    n = a.size
    b_jax, m_jax = jax.jvp(lambda x: droot.reflect(x, R_PORT, {}, {}), (jnp.asarray(a),),
                           (jnp.ones(n, jnp.float32),))
    b_jax, m_jax = np.asarray(b_jax), np.asarray(m_jax)
    _, m_torch = torch.func.jvp(
        lambda x: cheb_eval(x, troot.a_max, troot.breaks, troot.coeffs),
        (torch.from_numpy(a),), (torch.ones(n),))
    m_torch = m_torch.numpy()

    # a circuit whose root sees the capacitor's state: a = z, z' = b(a)
    ckt = Circuit(tree=Capacitor("C", C=CAP), root=troot, fs=FS, outputs=("C",))
    prep = tfc.prepare(ckt, ckt.init_params("cpu"), "cpu", input_node="Vs")
    deer, adj = cg.deer_program(ckt, prep.prog), cg.adjoint_program(ckt, prep.prog)
    assert "cheb_root_value_tangent<24>" in deer.host_source
    assert "cheb_root_tangent<24>" in adj.host_source
    z = torch.from_numpy(a).reshape(1, n).contiguous()
    f, J, out = torch.empty(1, n), torch.empty(1, n), torch.empty(n)
    _host(deer.host_source).circuit_deer_host_run(
        z.data_ptr(), torch.zeros(n).data_ptr(), f.data_ptr(), J.data_ptr(), out.data_ptr(), n,
        prep.vec.data_ptr(), prep.warr.data_ptr())
    zero = torch.zeros(n, 1)
    jac = torch.full((adj.scratch_floats(n, 1),), float("nan"))
    _host(adj.host_source).circuit_jacobian_host_run(
        zero.data_ptr(), zero.data_ptr(), z.reshape(1, n, 1).data_ptr(), jac.data_ptr(), None, n, 1,
        0, 1, prep.vec.data_ptr(), prep.vec.data_ptr(), prep.vec.data_ptr(),
        prep.warr.data_ptr())
    m_pass1 = jac.reshape(-1, cg.AdjointProgram.padded(adj.n_entries))[:n, 0].numpy()

    np.testing.assert_allclose(f[0].numpy(), b_jax, atol=1e-6, rtol=0)
    for m in (J[0].numpy(), m_pass1):
        np.testing.assert_allclose(m, m_jax, rtol=5e-6, atol=0)
    # the plain slope splits a tie as JAX's clip does (a quarter at |a| =
    # a_max, where both clips are on an edge): at a_max, at the second break
    # (t = -1 there) and at the float above the first (its t rounds to -1;
    # at the break itself it lies below -1)
    f32 = np.float32
    edges = [f32(droot.a_max), f32(droot.breaks[1]), np.nextafter(f32(droot.breaks[0]), f32(1))]
    tie = np.isin(np.abs(a), edges)
    assert tie[:2 * n_grid].sum() == 6 and tie.sum() > 6  # the sweep holds 4.0 and 20.0
    np.testing.assert_allclose(m_torch, m_jax, rtol=5e-6, atol=0)
    assert (m_jax[np.abs(a) > droot.a_max] == 1.0).all()  # clipped: b = a - h(a_max)
    assert (m_jax[a == 0.0] == 1.0).all()  # sign(0) = 0


def test_plain_deer_and_adjoint_slopes_match_jax_at_the_ties(roots):
    """The plain DEER step's Jacobian (forward mode through the plain step,
    as ``deer_circuit._plain`` takes it) and the plain adjoint's one step
    back from lam = 1 (``fused_backward_plain``) of the circuit a = z, z' =
    b(a), on the tie grid: JAX's slope within 5e-6 relative, ties
    included."""
    droot, troot = roots
    a, _ = _tie_grid(droot)
    n = a.size
    _, m_jax = jax.jvp(lambda x: droot.reflect(x, R_PORT, {}, {}), (jnp.asarray(a),),
                       (jnp.ones(n, jnp.float32),))
    m_jax = np.asarray(m_jax)
    ckt = Circuit(tree=Capacitor("C", C=CAP), root=troot, fs=FS, outputs=("C",))
    params = ckt.init_params("cpu")
    prep = tfc.prepare(ckt, params, "cpu", input_node="Vs")
    z = torch.from_numpy(a)
    with fwAD.dual_level():
        new, _ = tfc.plain_step(ckt, prep)([fwAD.make_dual(z, torch.ones(n))], torch.zeros(n), 0)
        m_deer = fwAD.unpack_dual(new[0]).tangent.numpy()
    zero = torch.zeros(n, 1)
    _, _, lam, _ = pb.fused_backward_plain(ckt, params, zero, zero, [z.reshape(n, 1)],
                                           [torch.ones(n)], input_node="Vs")
    for m in (m_deer, lam[0].numpy()):
        np.testing.assert_allclose(m, m_jax, rtol=5e-6, atol=0)


def _clippers(roots):
    droot, troot = roots
    jck = jdc.make_diode_clipper(droot, FS, R_SRC, CAP)
    tck = tdc.make_diode_clipper(troot, FS, R_SRC, CAP)
    return jck, tck


def _max(x, y):
    return float(np.max(np.abs(np.asarray(x, np.float64) - np.asarray(y, np.float64))))


@pytest.mark.parametrize("amp", [0.5, 2.0], ids=["quiet", "loud"])
def test_plain_deer_matches_jax_kernel_and_scan(roots, amp):
    jck, tck = _clippers(roots)
    vin = (amp * np.random.default_rng(int(10 * amp)).standard_normal(1024)).astype(np.float32)
    if amp > 1.0:  # the loud input crosses both breaks of |a|
        assert np.abs(vin).max() > roots[0].breaks[1]
    jp = jck.init_params()
    ref, ref_st = jck.process(jp, jck.init_state(), {"Vs": {"v": jnp.asarray(vin)}})
    jo, _, jres = jax_deer(jck, jp, jnp.asarray(vin), input_node="Vs", interpret=True)
    out, st, res = dc.fused_deer_circuit(tck, tck.init_params("cpu"), torch.from_numpy(vin),
                                         input_node="Vs")
    assert _max(out, jo) < 1e-6 and _max(out, ref) < 1e-6 and _max(jo, ref) < 1e-6
    assert float(res) < 1e-5 and float(jres) < 1e-5
    assert abs(float(st["C"]["z"]) - float(ref_st["C"]["z"])) < 1e-6


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / (np.abs(want).max() + 1e-12))


def test_fused_generic_grads_match_jax_engine(roots):
    """Every leaf (C.C, Vs.R; the distilled root has none), g_vin and g_z0
    of the fused_generic engine against JAX's, with both adjoints on the
    distilled root's slope."""
    b, t = 1024, 32
    jck, tck = _clippers(roots)
    rng = np.random.default_rng(23)
    vin = (1.5 * rng.standard_normal((b, t))).astype(np.float32)
    y = rng.standard_normal((b, t)).astype(np.float32)
    params = jax.tree_util.tree_map(np.asarray, jck.init_params())

    def jloss(p, v, z):
        out, zf = jf(p, v, z)
        return jnp.sum((out - y) ** 2) + jnp.sum(3.0 * zf[0])

    jf = jax_engine(jck, input_node="Vs", interpret=True)
    jp = jax.tree_util.tree_map(jnp.asarray, params)
    jout, _ = jf(jp, jnp.asarray(vin), [jnp.zeros(b)])
    gp, gv, gz = jax.grad(jloss, argnums=(0, 1, 2))(jp, jnp.asarray(vin), [jnp.zeros(b)])

    tf = pb.make_fused_circuit_train_generic(tck, input_node="Vs")
    tp = params_from_jax(params, "cpu")
    leaves = [tp["C"]["C"], tp["Vs"]["R"]]
    for x in leaves:
        x.requires_grad_(True)
    v = torch.from_numpy(vin).requires_grad_(True)
    z0 = torch.zeros(b, requires_grad=True)
    out, zf = tf(tp, v, [z0])
    (((out - torch.from_numpy(y)) ** 2).sum() + (3.0 * zf[0]).sum()).backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=5e-5, rtol=0)
    assert _rel(leaves[0].grad.numpy(), gp["C"]["C"]) < 5e-4
    assert _rel(leaves[1].grad.numpy(), gp["Vs"]["R"]) < 5e-4
    assert _rel(v.grad.numpy(), gv) < 1e-4 and _rel(z0.grad.numpy(), gz[0]) < 1e-4


def _train_data(roots):
    """Eight chunks of 128 samples of the analytic clipper (JAX's scan) at
    the true C; the distilled clipper starts from C 20% above it."""
    rng = np.random.default_rng(41)
    x = (1.2 * rng.standard_normal(8 * 128)).astype(np.float32)
    aroot = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d, quality="best")
    ack = jdc.make_diode_clipper(aroot, FS, R_SRC, CAP)
    y, _ = ack.process({**ack.init_params(), **aroot.init_params()}, ack.init_state(),
                       {"Vs": {"v": jnp.asarray(x)}})
    jck, _ = _clippers(roots)
    params = jax.tree_util.tree_map(np.asarray, jck.init_params())
    params["C"]["C"] = np.float32(1.2 * CAP)
    return {"x": x, "y": np.asarray(y)}, params


@pytest.fixture(scope="module")
def jax_train_history(roots):
    data, params = _train_data(roots)
    jck, _ = _clippers(roots)
    cfg = jct.CircuitTrainConfig(epochs=4, batch_size=8, learning_rate=1e-10, skip_samples=8,
                                 engine="fused_generic")
    only_c = lambda g: {k: jax.tree_util.tree_map(  # noqa: E731
        (lambda x: x) if k == "C" else jnp.zeros_like, v) for k, v in g.items()}
    p, hist = jct.train_clipper(jck, jax.tree_util.tree_map(jnp.asarray, params),
                                jct.make_clipper_batches(data, 128), cfg=cfg,
                                trainable_filter=only_c)
    return hist["loss"], float(p["C"]["C"])


@pytest.mark.parametrize("engine", ["fused_generic", "scan"])
def test_train_clipper_on_the_distilled_root_matches_jax(roots, jax_train_history, engine):
    """train_clipper trains the distilled circuit's own leaf (C; the root
    has no parameters) on either engine, JAX's fused_generic history."""
    data, params = _train_data(roots)
    _, tck = _clippers(roots)
    cfg = tct.CircuitTrainConfig(epochs=4, batch_size=8, learning_rate=1e-10, skip_samples=8,
                                 engine=engine)
    p, hist = tct.train_clipper(tck, params_from_jax(params, "cpu"),
                                tct.make_clipper_batches(data, 128, device="cpu"), cfg=cfg,
                                trainable_filter=lambda q: q["C"])
    want, c_jax = jax_train_history
    assert np.isfinite(want).all() and want[-1] < want[0]
    np.testing.assert_allclose(hist["loss"], want, rtol=5e-4)
    np.testing.assert_allclose(float(p["C"]["C"]), c_jax, rtol=1e-5)
    assert abs(float(p["C"]["C"]) - CAP) < abs(1.2 * CAP - CAP)
