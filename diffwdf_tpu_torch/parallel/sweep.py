"""Batched circuit-instance sweeps and model-zoo ensembles.

"Run many circuits" on one card through the generated circuit kernel (B7,
``ops.fused_circuit``): a parameter sweep of N instances (BASELINE.json
configuration 4: 1024 diode-clipper instances for hyperparameter and
component searches) is N rows of one launch, and a model-zoo ensemble (one
diode model per "expert") is one launch of the NxH lane form per expert.

A swept field that B7 takes as an impedance control (a node's
``impedance_controls``, e.g. the clipper's source resistance ``"Vs.R"``)
goes in as an (N,) ``row_controls`` tensor, so a sweep over it alone is one
launch.  Any other swept leaf (a capacitance, a diode parameter) sits in the
kernel's coefficient slots: the rows are grouped by its distinct values and
each group is one launch, the outputs put back in row order.  Every launch
counts in ``fused_circuit_process.launches``.  On CPU tensors the kernels'
plain versions run.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core.circuit import Circuit, _collect_impedance_controls
from ..core.elements import Device
from ..ops.fused_circuit import (_merge_controls, fused_circuit_process,
                                 fused_circuit_process_neural)
from ..roots.neural import MLPParams, NeuralDiodeRoot
from .mesh import all_gather, block_bounds


def expand_params(base_params, overrides: Dict[str, Any]):
    """Broadcast base params to N instances, overriding selected leaves.

    overrides: {"Node.field": tensor[N]}.  Returns (params, axes): the
    overridden leaves carry a leading N axis (axis 0 in ``axes``), the
    others are the base leaves (None)."""
    n = None
    for key, v in overrides.items():
        if n is None:
            n = v.shape[0]
        if v.shape[0] != n:
            raise ValueError(f"override {key} has {v.shape[0]} instances, expected {n}")
    out, axes = {}, {}
    for node, fields in base_params.items():
        out[node], axes[node] = {}, {}
        for f, leaf in fields.items():
            key = f"{node}.{f}"
            if key in overrides:
                out[node][f] = torch.as_tensor(overrides[key])
                axes[node][f] = 0
            else:
                out[node][f] = leaf
                axes[node][f] = None
    return out, axes


def stack_mlp_params(mlp_list) -> MLPParams:
    """Stack a list of same-architecture MLP params into one dict with a
    leading ensemble axis on every leaf."""
    return {"layers": [{k: torch.stack([m["layers"][i][k] for m in mlp_list])
                        for k in ("kernel", "bias")}
                       for i in range(len(mlp_list[0]["layers"]))]}


def _impedance_fields(circuit: Circuit) -> Dict[str, Tuple[str, ...]]:
    """{node: the fields that change its port impedance}."""
    out: Dict[str, Tuple[str, ...]] = {}
    _collect_impedance_controls(circuit.tree, out)
    return out


def _signal(circuit: Circuit, inputs, n: int, device: Device):
    """(input node, vin (n, T), per-sample row controls) from inputs
    {node: {field: [T]}}: one node's "v" is the signal, an impedance field
    a per-sample control; anything else raises."""
    imp = _impedance_fields(circuit)
    node_in, vin, rows = None, None, {}
    for node, fields in inputs.items():
        for field, x in fields.items():
            x = torch.as_tensor(x, dtype=torch.float32, device=device)
            if x.dim() != 1:
                raise ValueError(f"input {node}.{field} must be (T,), got {tuple(x.shape)}")
            if field == "v" and node_in is None:
                node_in, vin = node, x
            elif field in imp.get(node, ()):
                rows.setdefault(node, {})[field] = x[None].expand(n, -1).contiguous()
            else:
                raise ValueError(f"input {node}.{field}: one signal 'v' and impedance "
                                 "controls only")
    if node_in is None:
        raise ValueError("inputs carry no signal field 'v'")
    return node_in, vin[None].expand(n, -1).contiguous(), rows


def _state0(circuit: Circuit, n: int, device: Device):
    return {node: {f: torch.as_tensor(z, dtype=torch.float32, device=device)
                   .expand(n).contiguous() for f, z in fields.items()}
            for node, fields in circuit.init_state(device).items()}


def _to(tree, device: Device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to(v, device) for v in tree)
    return torch.as_tensor(tree, device=device)


def sweep_process(circuit: Circuit, base_params, overrides: Dict[str, Any], inputs,
                  mesh: Optional[DeviceMesh] = None, data_axis: str = "data", *,
                  device: Device = "cuda") -> torch.Tensor:
    """Run the circuit once per instance of the sweep, sharing the input.

    overrides: {"Node.field": [N]}; inputs: {node: {field: [T]}} with one
    signal field "v".  Returns outputs (N, T) on ``device``: one B7 launch
    when every swept field is an impedance control, else one per distinct
    value of the other swept leaves.  With a mesh, each rank of
    ``data_axis`` runs its block of the instances (N divisible by the axis
    size) and every rank returns the gathered (N, T)."""
    if mesh is not None:
        n = next(iter(overrides.values())).shape[0]
        lo, hi = block_bounds(n, mesh, data_axis)
        local = {k: v[lo:hi] for k, v in overrides.items()}
        return all_gather(sweep_process(circuit, base_params, local, inputs, device=device),
                          mesh, data_axis)
    base = _to(base_params, device)
    overrides = {k: torch.as_tensor(v, dtype=torch.float32, device=device)
                 for k, v in overrides.items()}
    if not overrides:
        raise ValueError("sweep_process needs at least one override")
    for key in overrides:
        node, _, field = key.partition(".")
        if field not in base.get(node, {}):
            raise ValueError(f"override {key}: no such parameter")
    _, axes = expand_params(base, overrides)
    n = next(iter(overrides.values())).shape[0]
    imp = _impedance_fields(circuit)
    row_ov: Dict[str, Dict[str, torch.Tensor]] = {}
    coeff_ov: List[Tuple[str, str]] = []
    for node, fields in axes.items():
        for f, ax in fields.items():
            if ax is None:
                continue
            if f in imp.get(node, ()):
                row_ov.setdefault(node, {})[f] = overrides[f"{node}.{f}"]
            else:
                coeff_ov.append((node, f))
    node_in, vin, in_rows = _signal(circuit, inputs, n, device)

    def run(params, rows: torch.Tensor, per_row: bool):
        b = rows.numel() if per_row else 1
        controls = {node: {f: x[rows] if per_row else x[rows[:1]] for f, x in fields.items()}
                    for node, fields in _merge_controls(row_ov, in_rows).items()}
        out, _ = fused_circuit_process(circuit, params, vin[:b], _state0(circuit, b, device),
                                       input_node=node_in, row_controls=controls or None)
        return out

    every = torch.arange(n, device=device)
    if not coeff_ov:
        return run(base, every, True)
    # one launch per distinct value of the leaves held in coefficient slots
    keys = [tuple(tuple(overrides[f"{node}.{f}"][i].reshape(-1).tolist())
                  for node, f in coeff_ov) for i in range(n)]
    groups: Dict[tuple, List[int]] = {}
    for i, k in enumerate(keys):
        groups.setdefault(k, []).append(i)
    out = torch.empty_like(vin)
    for idx in groups.values():
        rows = torch.as_tensor(idx, device=device)
        params = {node: dict(fields) for node, fields in base.items()}
        for node, f in coeff_ov:
            params[node][f] = overrides[f"{node}.{f}"][idx[0]]
        y = run(params, rows, bool(row_ov or in_rows))
        out[rows] = y.expand(len(idx), -1)
    return out


def ensemble_process(circuit_factory: Callable, mlp_params_stack: MLPParams, activations,
                     inputs, mesh: Optional[DeviceMesh] = None, *,
                     device: Device = "cuda") -> torch.Tensor:
    """Model-zoo ensemble: run the same circuit under N stacked MLP roots.

    mlp_params_stack: MLP params with a leading N axis on every leaf (a
    stack of model-zoo entries of one architecture); circuit_factory builds
    the circuit given a ``NeuralDiodeRoot``.  Each expert is one launch of
    ``fused_circuit_process_neural`` (B7's NxH lane form) on one stream; an
    architecture outside its all-tanh NxH family raises ``ValueError``.
    Returns outputs (N, T).  With a mesh, each rank of its "data" axis runs
    its block of the experts and every rank returns the gathered (N, T)."""
    if mesh is not None:
        lo, hi = block_bounds(mlp_params_stack["layers"][0]["kernel"].shape[0], mesh, "data")
        local = {"layers": [{k: l[k][lo:hi] for k in ("kernel", "bias")}
                            for l in mlp_params_stack["layers"]]}
        return all_gather(ensemble_process(circuit_factory, local, activations, inputs,
                                           device=device), mesh, "data")
    layers = mlp_params_stack["layers"]
    root = NeuralDiodeRoot(name="dp", n_layers=len(layers) - 2,
                           layer_size=int(layers[0]["kernel"].shape[-1]),
                           activations=tuple(activations))
    circuit = circuit_factory(root)
    params = circuit.init_params(device)
    node_in, vin, in_rows = _signal(circuit, inputs, 1, device)
    outs = []
    for i in range(layers[0]["kernel"].shape[0]):
        mlp = {"layers": [{k: torch.as_tensor(l[k][i], device=device) for k in ("kernel", "bias")}
                          for l in layers]}
        out, _ = fused_circuit_process_neural(circuit, params, mlp, vin,
                                              _state0(circuit, 1, device), input_node=node_in,
                                              row_controls=in_rows or None)
        outs.append(out[0])
    return torch.stack(outs)
