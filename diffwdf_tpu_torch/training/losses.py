"""Loss functions, matching the reference's definitions exactly.

The reference uses two slightly different ESR normalizations (deliberately
kept distinct here so accuracy numbers are comparable):

- pretraining ESR (``diode_pretraining.py:136-143``): divides by a *constant*
  N (the per-R grid size, 1000) before the sqrt;
- circuit-training ESR (``clipper_pot.py:148-156``): divides by the total
  element count of the target batch.

Plus: MSE, pre-emphasis filter (one-zero, coeff 0.85, ``clipper_pot.py:141``),
and the auxiliary avg/bounds losses (``clipper_pot.py:162-173``).
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

_EPS = float(np.finfo(np.float32).eps)


def mse(target, pred):
    return torch.mean(torch.square(target - pred))


def esr(target, pred, n_norm: Optional[float] = None, emphasis: Optional[Callable] = None):
    """Error-to-signal ratio, sqrt((sum(e^2)/sum(t^2)) / N).

    n_norm=None uses the element count (circuit-training variant); pass a
    constant (e.g. 1000) for the pretraining variant.
    """
    if emphasis is not None:
        target = emphasis(target)
        pred = emphasis(pred)
    err = torch.sum(torch.square(target - pred))
    energy = torch.sum(torch.square(target))
    n = target.numel() if n_norm is None else n_norm
    return torch.sqrt(err / (energy + _EPS) / n)


def esr_plain(target, pred, emphasis: Optional[Callable] = None):
    """Un-normalized ESR: sum(e^2)/sum(t^2) — the standard definition, used
    for reporting and cross-implementation comparisons."""
    if emphasis is not None:
        target = emphasis(target)
        pred = emphasis(pred)
    return torch.sum(torch.square(target - pred)) / (torch.sum(torch.square(target)) + _EPS)


def pre_emphasis(x, coeff: float = 0.85, axis: int = 0):
    """One-zero pre-emphasis y[n] = x[n] - coeff * x[n-1] (y[0] = x[0])."""
    n = x.shape[axis]
    rest = x.narrow(axis, 1, n - 1) - coeff * x.narrow(axis, 0, n - 1)
    return torch.cat([x.narrow(axis, 0, 1), rest], dim=axis)


def avg_loss(target, pred):
    return torch.abs(torch.mean(target) - torch.mean(pred))


def bounds_loss(target, pred):
    return torch.abs(torch.min(target) - torch.min(pred)) + torch.abs(
        torch.max(target) - torch.max(pred)
    )


def global_loss_from_sums(se, te, n, eps: float = _EPS):
    """The circuit-training loss assembled from SUMS: mse = se/n,
    esr = sqrt(se/(te+eps)/n) — algebraically identical to
    ``mse(t, o) + esr(t, o)`` with se = sum((t-o)^2), te = sum(t^2),
    n = element count.  Sharded training steps reduce per-shard sums and
    assemble here so the sharded loss equals the single-device one (the ESR
    energy normalization does not decompose as a mean of per-shard ESRs).
    Returns (mse, esr)."""
    m = se / n
    e = torch.sqrt(se / (te + eps) / n)
    return m, e


def dloss_dse(se, e, n, eps: float = _EPS):
    """d(mse+esr)/d(se) of :func:`global_loss_from_sums` — the exact
    chain-rule factor a sharded step applies to the reduced gradient of the
    LOCAL se (te is target-only, n constant, so se is the only
    parameter-dependent sum): 1/n + e/(2 se)."""
    return 1.0 / n + e / (2.0 * torch.clamp(torch.as_tensor(se), min=eps))


def mse_plus_esr(target, pred, n_norm: Optional[float] = None):
    """The combined training loss both reference workloads use
    (``diode_pretraining.py:151-153``, ``clipper_pot.py:177``)."""
    return mse(target, pred) + esr(target, pred, n_norm=n_norm)
