"""JSON weight interchange in the reference model-zoo schema.

    {"in_shape": [null, 2],
     "layers": [{"type": "dense", "shape": [null, H],
                 "activation": "tanh"|"relu"|"", "weights": [kernel, bias]},
                ...]}

kernel is nested [in][out]; bias is [out].  Keras-exported files may carry a
leading non-dense entry (the InputLayer, tagged "unknown" with empty weights),
which is skipped on load.  The same files load into the JAX package, so both
packages serve the same checked-in weights.
"""

from __future__ import annotations

import json
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.elements import Device
from ..roots.neural import MLPParams


def load_model_json(path_or_dict, *, device: Device) -> Tuple[MLPParams, Tuple[str, ...], int]:
    """Load a reference-schema model file onto ``device``.

    Returns (mlp_params, activations, d_in).
    """
    if isinstance(path_or_dict, dict):
        d = path_or_dict
    else:
        with open(path_or_dict, "r") as f:
            d = json.load(f)

    # legacy exporter variants: in_shape may be a bare int or nested one
    # level deeper ([[None, 2]])
    d_in = d["in_shape"]
    while isinstance(d_in, (list, tuple)):
        d_in = d_in[-1]
    layers: List[Dict[str, Any]] = []
    activations: List[str] = []
    for l in d["layers"]:
        if l.get("type") != "dense":
            continue  # InputLayer/unknown entries (keras exports)
        kernel = np.asarray(l["weights"][0], dtype=np.float32)
        bias = np.asarray(l["weights"][1], dtype=np.float32)
        if kernel.ndim == 3:  # some exports carry a leading singleton dim
            kernel = kernel[0]
        if bias.ndim == 2:
            bias = bias[0]
        layers.append({"kernel": torch.as_tensor(kernel, device=device),
                       "bias": torch.as_tensor(bias, device=device)})
        activations.append(l.get("activation", "") or "")
    return {"layers": layers}, tuple(activations), int(d_in)


def save_model_json(
    mlp_params: MLPParams,
    activations: Sequence[str],
    path=None,
    d_in: int = 2,
) -> Dict[str, Any]:
    """Serialize to the reference schema.  Writes to ``path`` if given;
    returns the dict either way."""
    layers = []
    for layer, act in zip(mlp_params["layers"], activations):
        kernel = layer["kernel"].detach().cpu().double().numpy()
        bias = layer["bias"].detach().cpu().double().numpy()
        layers.append(
            {
                "type": "dense",
                "shape": [None, int(bias.shape[-1])],
                "activation": act if act in ("tanh", "relu", "sigmoid", "softmax") else "",
                "weights": [kernel.tolist(), bias.tolist()],
            }
        )
    out = {"in_shape": [None, int(d_in)], "layers": layers}
    if path is not None:
        with open(path, "w") as f:
            json.dump(out, f, indent=4)
    return out


#: layer-kind tags of the reference exporter: the schema also carries
#: recurrent and conv layers, though the WDF zoo is all dense.
LAYER_TYPES = ("dense", "gru", "lstm", "conv1d", "time-distributed-dense")
ACTIVATIONS = ("tanh", "relu", "sigmoid", "softmax")


def _f64_list(w):
    """A weight (tensor or array-like) as nested float64 lists."""
    if isinstance(w, torch.Tensor):
        w = w.detach().cpu().double().numpy()
    return np.asarray(w, np.float64).tolist()


def save_layers_json(
    layer_specs: Sequence[Dict[str, Any]],
    path=None,
    in_shape: Sequence = (None, 2),
) -> Dict[str, Any]:
    """Generic exporter for the reference schema, covering the full tag set:
    each spec is ``{"type", "activation", "shape", "weights",
    ["kernel_size", "dilation"]}`` with weights as tensors or arrays.
    Unknown types are tagged "unknown" (the loader skips them)."""
    layers = []
    for spec in layer_specs:
        kind = spec.get("type", "unknown")
        entry = {
            "type": kind if kind in LAYER_TYPES else "unknown",
            "activation": (
                spec.get("activation", "")
                if spec.get("activation", "") in ACTIVATIONS
                else ""
            ),
            "shape": list(spec.get("shape", [])),
            "weights": [_f64_list(w) for w in spec.get("weights", [])],
        }
        if entry["type"] == "conv1d":
            entry["kernel_size"] = [int(k) for k in np.atleast_1d(spec["kernel_size"])]
            entry["dilation"] = [int(d) for d in np.atleast_1d(spec.get("dilation", 1))]
        layers.append(entry)
    out = {"in_shape": list(in_shape), "layers": layers}
    if path is not None:
        with open(path, "w") as f:
            json.dump(out, f, indent=4)
    return out
