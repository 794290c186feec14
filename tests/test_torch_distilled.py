"""diffwdf_tpu_torch distilled root and its clipper kernel vs the JAX package.

The piecewise-odd Chebyshev root (``roots/distilled.py``) and
``fused_clipper_cheb``'s plain version are held against the JAX package on
the same seeded numpy inputs; a JAX distilled root crosses with
``nn.convert.cheb_root_from_jax``.  Budgets: the root's reflect within 1e-6
of JAX's (both f32 Clenshaw with the same coefficients), the port's fit error
below 1e-4 (``tests/test_distilled.py:26``), the plain clipper against JAX
``fused_clipper_cheb(interpret=True)`` 1e-5 (``:88``), the distilled clipper
against the analytic one ESR below 1e-7 (``:46``).  The CUDA kernel runs
only on a card (tests/test_torch_gpu.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import diffwdf_tpu as dwdf
from diffwdf_tpu.ops.fused_clipper import fused_clipper_cheb as jax_fused_clipper_cheb
from diffwdf_tpu.roots import distilled as jdist
from diffwdf_tpu.roots.neural import NeuralDiodeRoot as JaxNeuralDiodeRoot
from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper
from diffwdf_tpu_torch.nn.convert import cheb_root_from_jax, params_from_jax
from diffwdf_tpu_torch.ops import fused_clipper as tfc
from diffwdf_tpu_torch.roots import distilled as tdist
from diffwdf_tpu_torch.roots.diode import DiodePairRoot, diode_1n4148_1u1d
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot

FS = 96000.0
R_SRC, CAP = 47.0e3, 2.2e-9


def _port_R():
    r_c = 1.0 / (2.0 * CAP * FS)
    return 1.0 / (1.0 / R_SRC + 1.0 / r_c)


@pytest.fixture(scope="module")
def jax_droot():
    root = dwdf.DiodePairRoot(name="dp", diode=dwdf.diode_1n4148_1u1d)
    droot, err = jdist.distill_root(root, root.init_params(), _port_R())
    return droot, err


def _vin(seed, b, t, amp=2.0):
    return (amp * np.random.default_rng(seed).standard_normal((b, t))).astype(np.float32)


def test_chebyshev_fit_and_clenshaw_match_jax():
    fn = lambda x: np.tanh(3.0 * x) + 0.1 * x ** 3  # noqa: E731
    for lo, hi, deg in ((0.0, 0.8, 24), (0.8, 4.0, 16), (-2.0, 3.0, 9)):
        c_t = tdist.chebyshev_fit(fn, lo, hi, deg)
        np.testing.assert_array_equal(c_t, jdist.chebyshev_fit(fn, lo, hi, deg))
        t = np.linspace(-1.0, 1.0, 513).astype(np.float32)
        got = tdist.clenshaw(c_t, torch.from_numpy(t)).numpy()
        want = np.asarray(jdist.clenshaw(c_t, jnp.asarray(t)))
        np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_reflect_matches_jax(jax_droot):
    droot, _ = jax_droot
    troot = cheb_root_from_jax(droot)
    assert troot.breaks == droot.breaks and troot.a_max == droot.a_max
    a = np.concatenate([np.linspace(-25.0, 25.0, 4001), [0.0, -0.0, 0.8, 4.0, 20.0]])
    a = a.astype(np.float32)
    got = troot.reflect(torch.from_numpy(a), None, {}, {}).numpy()
    want = np.asarray(droot.reflect(jnp.asarray(a), jnp.float32(_port_R()), {}, {}))
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=0)


def test_distill_analytic_root_error_and_coefficients(jax_droot):
    jroot, jerr = jax_droot
    root = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)
    droot, err = tdist.distill_root(root, root.init_params("cpu"), _port_R(), a_max=20.0)
    assert err < 1e-4, err  # over the whole +-20 V wave range
    assert droot.breaks == tdist.DEFAULT_BREAKS == jdist.DEFAULT_BREAKS
    assert tuple(len(c) - 1 for c in droot.coeffs) == tdist.DEFAULT_DEGREES == jdist.DEFAULT_DEGREES
    # both fit the f32 evaluation of the same root: the coefficients agree to
    # the f32 rounding of the samples they interpolate
    for c_t, c_j in zip(droot.coeffs, jroot.coeffs):
        np.testing.assert_allclose(c_t, np.asarray(c_j), atol=1e-6, rtol=0)
    assert abs(err - jerr) < 1e-5


def test_distill_neural_root_matches_its_odd_part():
    """tests/test_distilled.py's neural case, on the JAX root's weights."""
    jroot = JaxNeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    jparams = jroot.init_params(jax.random.PRNGKey(0))
    params = params_from_jax(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    droot, err = tdist.distill_root(root, params, _port_R())
    a = torch.linspace(-15, 15, 301)
    r = torch.tensor(_port_R(), dtype=torch.float32)
    b_true = root.reflect(a, r, params, {})
    b_odd = 0.5 * (b_true - root.reflect(-a, r, params, {}))
    b_fit = droot.reflect(a, r, {}, {})
    np.testing.assert_allclose(b_fit.detach().numpy(), b_odd.detach().numpy(),
                               atol=max(5 * err, 1e-4))


def test_cheb_parameters_layout(jax_droot):
    troot = cheb_root_from_jax(jax_droot[0])
    params, degree = tfc.cheb_parameters(troot)
    assert degree == 24 and params.dtype == np.float32
    assert len(params) == 1 + 3 * (3 + 25)  # each segment padded to degree 24
    np.testing.assert_array_equal(params[:10], np.float32(
        [20.0, 0.0, 0.8, 0.8, 0.8, 4.8, 3.2, 4.0, 24.0, 16.0]))
    np.testing.assert_array_equal(params[10:35], np.float32(troot.coeffs[0]))
    np.testing.assert_array_equal(params[35:52], np.float32(troot.coeffs[1]))
    assert not params[52:60].any()
    np.testing.assert_array_equal(params[60:73], np.float32(troot.coeffs[2]))
    assert not params[73:].any()
    bad = tdist.PiecewiseChebRoot(breaks=tuple(range(1, 9)), coeffs=(np.zeros(3),) * 9)
    with pytest.raises(ValueError, match="segments"):
        tfc.cheb_parameters(bad)
    # a lower top degree pads to the next compiled one (exact: zero terms)
    small = tdist.PiecewiseChebRoot(breaks=(1.0,), coeffs=(np.ones(10), np.ones(4)))
    params, degree = tfc.cheb_parameters(small)
    assert degree == 16 and len(params) == 1 + 2 * (3 + 17)
    with pytest.raises(ValueError, match="degree 70"):
        tfc.cheb_parameters(tdist.PiecewiseChebRoot(breaks=(), coeffs=(np.ones(71),)))


@pytest.mark.parametrize("amp", [2.0, 12.0])
def test_plain_matches_jax_kernel(jax_droot, amp):
    droot, _ = jax_droot
    troot = cheb_root_from_jax(droot)
    B, T = 1024, 256
    vin = _vin(1, B, T, amp)
    z0 = np.random.default_rng(2).uniform(-0.5, 0.5, B).astype(np.float32)
    want, want_z = jax_fused_clipper_cheb(jnp.asarray(vin), jnp.asarray(z0), droot, R_SRC, CAP,
                                          fs=FS, time_chunk=128, interpret=True)
    got, got_z = tfc.fused_clipper_cheb_plain(torch.from_numpy(vin), torch.from_numpy(z0),
                                              troot, R_SRC, CAP, fs=FS)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got_z.numpy(), np.asarray(want_z), atol=1e-5, rtol=0)


def test_wrapper_runs_plain_on_cpu(jax_droot):
    troot = cheb_root_from_jax(jax_droot[0])
    vin = torch.from_numpy(_vin(3, 64, 100))
    z0 = torch.zeros(64)
    tfc.fused_clipper_cheb.launches = 0
    got = tfc.fused_clipper_cheb(vin, z0, troot, R_SRC, CAP, fs=FS)
    want = tfc.fused_clipper_cheb_plain(vin, z0, troot, R_SRC, CAP, fs=FS)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert tfc.fused_clipper_cheb.launches == 0
    with pytest.raises(ValueError, match=r"\(B, T\)"):
        tfc.fused_clipper_cheb(vin[0], z0, troot, R_SRC, CAP, fs=FS)


def test_distilled_clipper_matches_analytic():
    """The distilled root in the circuit against the analytic root it was
    distilled from: ESR below 1e-7 over 2,048 samples of N(0, 2^2)."""
    root = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)
    rp = root.init_params("cpu")
    droot, _ = tdist.distill_root(root, rp, _port_R())
    vin = torch.from_numpy(_vin(0, 1, 2048)[0])
    outs = []
    for r, p in ((root, rp), (droot, {})):
        ckt = make_diode_clipper(r, FS, R_SRC, CAP)
        out, _ = ckt.process({**ckt.init_params("cpu"), **p}, ckt.init_state("cpu"),
                             {"Vs": {"v": vin}})
        outs.append(out.numpy())
    ya, yd = outs
    esr = np.sum((ya - yd) ** 2) / np.sum(ya ** 2)
    assert esr < 1e-7, esr
    # and the distilled clipper's wrapper equals its own circuit run
    got, _ = tfc.fused_clipper_cheb(vin[None], torch.zeros(1), droot, R_SRC, CAP, fs=FS)
    np.testing.assert_allclose(got[0].numpy(), yd, atol=1e-5, rtol=0)
