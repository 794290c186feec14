"""Parameter bridge from the JAX package's pytrees to this package's dicts.

A JAX parameter pytree such as
``{"Vs": {"R": ...}, "C": {"C": ...}, "dp": {"layers": [{"kernel", "bias"}]}}``
has the same nesting as the dicts this package uses, so conversion is a walk
over dicts and lists that turns every leaf into a tensor.  The leaves are
taken as numpy arrays (``np.asarray`` of a JAX array, or plain numpy), so this
module imports nothing of JAX; it is how the parity tests run both packages
on the same weights.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from ..core.elements import Device
from ..roots.distilled import PiecewiseChebRoot


def params_from_jax(tree: Any, device: Device) -> Any:
    """Copy a (nested dict / list / tuple) parameter tree onto ``device``,
    keeping each leaf's dtype and shape."""
    if isinstance(tree, dict):
        return {k: params_from_jax(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_jax(v, device) for v in tree)
    return torch.as_tensor(np.array(tree), device=device)


def cheb_root_from_jax(jax_root):
    """The port's PiecewiseChebRoot with the name, range, breaks and
    coefficients of a JAX package's distilled root (read as numpy)."""
    return PiecewiseChebRoot(
        name=jax_root.name,
        a_max=float(jax_root.a_max),
        breaks=tuple(float(b) for b in jax_root.breaks),
        coeffs=tuple(np.array(c, dtype=np.float64) for c in jax_root.coeffs),
    )
