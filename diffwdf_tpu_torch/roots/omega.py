"""Real-line Wright omega function (PyTorch).

The diode-pair roots only need omega on the real axis, where it is smooth and
positive, so we solve  w + log(w) = x  directly on the real line:

- region-split initial guess (series at -inf, series about w=1, log-series at
  +inf);
- Newton iterations on u = log(w)  (solve e^u + u = x), which is globally
  convergent (e^u + u is convex increasing) and needs no branch-cut handling;
- gradients via the closed-form implicit derivative  dw/dx = w / (1 + w)
  (a ``torch.autograd.Function``), NOT by differentiating through the
  iterations.

Works in float32 and float64 (CPU oracle tests).  The complex-plane
evaluator of the JAX package is off every audio path and is not ported.
"""

from __future__ import annotations

import torch

__all__ = ["wright_omega", "wright_omega_u", "omega_quality_iters"]

#: iteration counts for the quality knob (Best / Good / Low).
omega_quality_iters = {"best": 3, "good": 2, "low": 1}


def _initial_log_guess(x):
    """Initial guess for u = log(w), region-split.

    x <= -1 : w ~ e^x (1 - e^x)          => u ~ x + log1p(-e^x) ~ x - e^x
    |x| < 2 : w ~ 1 + (x-1)/2 + (x-1)^2/16   (series about the point w=1, x=1)
    x >= 2  : w ~ x - log(x) + log(x)/x      => u = log(w)
    """
    u_neg = x - torch.exp(x)
    t = x - 1.0
    u_mid = torch.log(1.0 + 0.5 * t + 0.0625 * t * t)
    xs = torch.clamp_min(x, 2.0)  # guard log for the unselected elements
    lx = torch.log(xs)
    u_pos = torch.log(xs - lx + lx / xs)
    return torch.where(x <= -1.0, u_neg, torch.where(x >= 2.0, u_pos, u_mid))


def _newton_u(x, u, iters):
    """Newton on f(u) = e^u + u - x;  f'(u) = e^u + 1 >= 1 (never singular)."""
    for _ in range(iters):
        eu = torch.exp(u)
        u = u - (eu + u - x) / (eu + 1.0)
    return u


class _WrightOmega(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, iters):
        w = torch.exp(_newton_u(x, _initial_log_guess(x), iters))
        ctx.save_for_backward(w)
        return w

    @staticmethod
    def backward(ctx, grad):
        (w,) = ctx.saved_tensors
        # implicit differentiation of w + log w = x:  dw/dx = w / (1 + w),
        # written as 1 / (1 + 1/w) so it cannot overflow at the top of the
        # f32 range (w ~ 3e38 makes 1 + w infinite) and limits to 0 as w -> 0
        return grad / (1.0 + 1.0 / w), None


def wright_omega(x, iters: int = 3):
    """omega(x): the real solution w > 0 of w + log(w) = x.

    ``iters`` is the Newton iteration count (quality knob; 3 reaches f32
    machine precision everywhere on the real line).
    """
    return _WrightOmega.apply(torch.as_tensor(x), iters)


def wright_omega_u(x, iters: int = 3):
    """log(omega(x)) — for downstream math that wants the log domain."""
    x = torch.as_tensor(x)
    return _newton_u(x, _initial_log_guess(x), iters)
