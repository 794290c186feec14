"""Distilled (polynomial-compiled) root nonlinearities (PyTorch).

For a fixed port impedance (the serving configuration of the clipper: R is
set once per parameter change) the root is a one-dimensional map b = f(a).
The hot loop can then evaluate a short polynomial instead of Wright-omega
solves or MLP layers: no transcendentals, only multiply-adds.

f has complex singularities at the diode knee (|Im a| ~ nabla Vt, around
|a| ~ 0.4 V for the 1N4148 clipper), so one Chebyshev expansion over an
audio-scale wave range converges slowly.  The compiled form is a
**piecewise odd Chebyshev** model

    f(a) = a - sign(a) h(|a|),      h fitted per segment on [0, a_max]

with segment breaks bracketing the knee.  Three segments of degree
(24, 16, 12) reach ~1e-5 absolute error over +-20 V; ``distill_root``
measures and returns the true max error.

The fit runs in float64 numpy; the root being distilled is evaluated in f32
torch on the CPU.  The kernel that serves a distilled root is
``ops.fused_clipper.fused_clipper_cheb``.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Sequence, Tuple

import numpy as np
import torch

from ..core.circuit import Root
from ..core.elements import Device


def chebyshev_fit(fn: Callable, lo: float, hi: float, degree: int) -> np.ndarray:
    """Fit fn on [lo, hi] by Chebyshev interpolation at degree+1 nodes.

    fn: vectorized float64 numpy function.  Returns coefficients c[0..degree]
    for sum_k c_k T_k(t), t the affine map of x onto [-1, 1].
    """
    k = np.arange(degree + 1)
    t = np.cos(np.pi * (k + 0.5) / (degree + 1))  # Chebyshev-Gauss nodes
    x = 0.5 * (hi + lo) + 0.5 * (hi - lo) * t
    y = np.asarray(fn(x), dtype=np.float64)
    T = np.cos(np.pi * np.outer(k + 0.5, k) / (degree + 1)).T  # T[j,i]=T_j(t_i)
    c = (2.0 / (degree + 1)) * (T @ y)
    c[0] *= 0.5
    return c


def clenshaw(c, t):
    """Evaluate sum_k c_k T_k(t) by the Clenshaw recurrence; c is a sequence
    of Python-float coefficients, t a tensor."""
    c = [float(v) for v in np.asarray(c)]
    b1 = torch.zeros_like(t)
    b2 = torch.zeros_like(t)
    t2 = 2.0 * t
    for ck in c[:0:-1]:
        b1, b2 = t2 * b1 - b2 + ck, b1
    return t * b1 - b2 + c[0]


DEFAULT_BREAKS = (0.8, 4.0)
DEFAULT_DEGREES = (24, 16, 12)


def _clip(x: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    # the bounds are filled on x's device (new_full), never copied from the host
    return torch.minimum(torch.maximum(x, x.new_full((), lo)), x.new_full((), hi))


def cheb_eval(a, a_max: float, breaks: Sequence[float], coeffs: Sequence) -> torch.Tensor:
    """b = a - sign(a) h(|a|) of a piecewise-odd Chebyshev root: every
    segment is evaluated, then the last one whose lower edge |a| reaches is
    selected.  The clips are maximum then minimum, which split the slope
    at an exact edge half and half, as JAX's clip and cheb.cuh's
    cheb_clip_slope do (torch.clamp passes all of it)."""
    s = _clip(torch.abs(a), 0.0, a_max)
    edges = (0.0,) + tuple(breaks) + (a_max,)
    h = None
    for j, c in enumerate(coeffs):
        lo, hi = edges[j], edges[j + 1]
        t = _clip((2.0 * s - (hi + lo)) / (hi - lo), -1.0, 1.0)
        hj = clenshaw(c, t)
        h = hj if h is None else torch.where(s < lo, h, hj)
    return a - torch.sign(a) * h


@dataclasses.dataclass(eq=False)
class PiecewiseChebRoot(Root):
    """Root evaluating a piecewise-odd Chebyshev compilation of b = f(a).

    The coefficients are static (a deployment artifact, not trainable
    parameters).  Valid only at the port impedance it was distilled for.
    """

    name: str = "dp"
    a_max: float = 20.0
    breaks: Tuple[float, ...] = DEFAULT_BREAKS
    coeffs: Tuple = ()  # per-segment float64 numpy arrays for h(|a|)

    def init_params(self, device: Device = None):
        return {}

    def reflect(self, a, R, params, controls):
        return cheb_eval(a, float(self.a_max), tuple(self.breaks), self.coeffs)


def _to_cpu(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: _to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_cpu(v) for v in tree)
    return tree.detach().cpu() if isinstance(tree, torch.Tensor) else tree


def distill_root(
    root: Root,
    params,
    R: float,
    a_max: float = 20.0,
    breaks: Sequence[float] = DEFAULT_BREAKS,
    degrees: Sequence[int] = DEFAULT_DEGREES,
    n_check: int = 8001,
) -> Tuple[PiecewiseChebRoot, float]:
    """Compile ``root`` at port impedance R into a PiecewiseChebRoot.

    Assumes odd symmetry (symmetric diode pairs and the neural roots are
    near-odd; the measured error reflects any asymmetry).  The root is
    evaluated in f32 on the CPU.  Returns (distilled_root, max_abs_error over
    [-a_max, a_max]), the error of the distilled root evaluated in f32.
    """
    params = _to_cpu(params)
    r32 = torch.tensor(float(R), dtype=torch.float32)

    def f64(x):
        with torch.no_grad():
            out = root.reflect(torch.as_tensor(np.asarray(x), dtype=torch.float32), r32, params, {})
        return out.numpy().astype(np.float64)

    def h64(s):
        # odd-symmetrized residual: h(s) = s - (f(s) - f(-s))/2
        return s - 0.5 * (f64(s) - f64(-s))

    edges = (0.0,) + tuple(breaks) + (float(a_max),)
    coeffs = tuple(chebyshev_fit(h64, edges[j], edges[j + 1], deg)
                   for j, deg in enumerate(degrees))
    droot = PiecewiseChebRoot(
        name=root.name,
        a_max=float(a_max),
        breaks=tuple(float(b) for b in breaks),
        coeffs=coeffs,
    )
    xs = np.linspace(-a_max, a_max, n_check)
    got = droot.reflect(torch.as_tensor(xs, dtype=torch.float32), r32, {}, {}).numpy()
    err = float(np.max(np.abs(got.astype(np.float64) - f64(xs))))
    return droot, err
