"""Neural diode root: a small MLP standing in for the diode-pair nonlinearity.

Input [incident wave a, log(port R)], dense/tanh stack, linear head.

Sign convention: the network is trained to predict the *negated* reflected
wave, so ``NeuralDiodeRoot.reflect`` returns ``b = -MLP([a, log R])`` and is a
drop-in replacement for ``DiodePairRoot``.

The parameters of an MLP are a plain dict
``{"layers": [{"kernel": [in, out], "bias": [out]}, ...]}`` — the layout of
the JAX package and of the reference JSON schema — which the pure functions
(``mlp_apply``, the root's ``reflect``, the fused kernels) take directly.
``MLP`` is the ``nn.Module`` that owns such a dict's tensors as parameters,
for optimizers and ``state_dict``.  Activation names are static structure,
never entries of the params dict.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..core.circuit import Root
from ..core.elements import Device

_ACTS = {
    "tanh": torch.tanh,
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "softmax": lambda x: torch.softmax(x, dim=-1),
    "": lambda x: x,
    "linear": lambda x: x,
}

#: params dict for an MLP: {"layers": [{"kernel": [in,out], "bias": [out]}]}
MLPParams = Dict[str, List[Dict[str, Any]]]


def mlp_init(generator: torch.Generator, sizes: Sequence[int], device: Device,
             dtype=torch.float32) -> MLPParams:
    """Orthogonal-kernel / zero-bias init.  The kernels are drawn on the
    generator's device and then moved to ``device``."""
    layers = []
    for din, dout in zip(sizes[:-1], sizes[1:]):
        kernel = torch.empty((din, dout), dtype=dtype, device=generator.device)
        nn.init.orthogonal_(kernel, generator=generator)
        layers.append(
            {
                "kernel": kernel.to(device),
                "bias": torch.zeros((dout,), dtype=dtype, device=device),
            }
        )
    return {"layers": layers}


def mlp_apply(params: MLPParams, activations: Sequence[str], x):
    """Apply a dense stack. x: [..., d_in] -> [..., d_out]."""
    for layer, act in zip(params["layers"], activations):
        x = x @ layer["kernel"] + layer["bias"]
        x = _ACTS[act](x)
    return x


def mlp_arch(n_layers: int, layer_size: int, d_in: int = 2, d_out: int = 1):
    """The "NxH" architecture family: an input dense(2->H) + N hidden
    dense(H->H), ALL tanh, then a linear head.  So "2x16" has three tanh
    layers of width 16.  Returns (sizes, activations)."""
    sizes = [d_in] + [layer_size] * (n_layers + 1) + [d_out]
    activations = tuple(["tanh"] * (n_layers + 1) + [""])
    return sizes, activations


class MLP(nn.Module):
    """Dense stack as an ``nn.Module``; ``params()`` is the dict view that
    the pure functions take, sharing this module's parameter tensors."""

    def __init__(self, params: MLPParams, activations: Sequence[str]):
        super().__init__()
        self.kernels = nn.ParameterList([l["kernel"] for l in params["layers"]])
        self.biases = nn.ParameterList([l["bias"] for l in params["layers"]])
        self.activations = tuple(activations)

    def params(self) -> MLPParams:
        return {"layers": [{"kernel": k, "bias": b}
                           for k, b in zip(self.kernels, self.biases)]}

    def forward(self, x):
        return mlp_apply(self.params(), self.activations, x)


@dataclasses.dataclass(eq=False)
class NeuralDiodeRoot(Root):
    """MLP-backed WDF root: b = -MLP([a, log R]).

    ``activations`` defaults to the reference family (all-tanh hidden, linear
    head) but can be overridden, e.g. when loading a JSON model that mixes
    relu/tanh.
    """

    name: str = "nn_root"
    n_layers: int = 2
    layer_size: int = 16
    activations: Tuple[str, ...] = ()

    def __post_init__(self):
        if not self.activations:
            _, self.activations = mlp_arch(self.n_layers, self.layer_size)

    def init_params(self, device: Device,
                    generator: Optional[torch.Generator] = None) -> Dict[str, MLPParams]:
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        sizes, _ = mlp_arch(self.n_layers, self.layer_size)
        return {self.name: mlp_init(generator, sizes, device)}

    def reflect(self, a, R, params, controls):
        log_r = torch.log(torch.as_tensor(R, dtype=a.dtype, device=a.device))
        x = torch.stack(torch.broadcast_tensors(a, log_r), dim=-1)
        out = mlp_apply(params[self.name], self.activations, x)[..., 0]
        return -out

    @classmethod
    def from_mlp(cls, name: str, mlp_params: MLPParams, activations: Sequence[str]):
        """Build a root around existing MLP params (e.g. loaded from the JSON
        model zoo); returns (root, params-fragment)."""
        n_hidden = len(mlp_params["layers"]) - 2  # "NxH" naming, see mlp_arch
        width = mlp_params["layers"][0]["kernel"].shape[1]
        root = cls(
            name=name,
            n_layers=n_hidden,
            layer_size=int(width),
            activations=tuple(activations),
        )
        return root, {name: mlp_params}
