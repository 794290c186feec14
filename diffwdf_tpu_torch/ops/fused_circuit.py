"""Generic fused circuit: any adapted WDF `Circuit` served by one generated
CUDA kernel, and its plain PyTorch version.

``ops.circuit_codegen`` traces the circuit's sample step into C and wraps it
in a kernel that gives each stream one thread, the state and coefficients in
registers (B7 in ROADMAP); ``ops._build`` compiles one library per generated
source and keeps it, keyed by a hash of the source, so a new component value
or drive setting is a new argument, never a new build.  This serves the Tube
Screamer (4-port R-type stage, three states), the HPF clipper and the simple
circuits, with analytic, NxH neural, distilled or ideal-source roots.

A wrapper given CPU tensors runs its plain version: the adaptation pass
hoisted out of the loop, then the circuit's step (the tree's own
``reflected`` / ``incident``, the root's plain twin) one sample at a time
over the batch, on the same f32 coefficient vector the kernel gets.  Given
CUDA tensors it launches the generated kernel or raises.  Kernel launches
are counted in ``fused_circuit_process.launches`` (the ``_neural`` entry
launches through it).

Impedance-affecting controls are block-rate (``static_controls``).  Per-row
and per-sample pot streams (``row_controls``) and the pre-step state
trajectory (``return_state_seq``) belong to the generic training path and
raise ``NotImplementedError`` (ROADMAP B8).
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from . import _build
from .circuit_codegen import CircuitProgram, program, step

Controls = Optional[Dict[str, Dict[str, Any]]]


def _check_deferred(row_controls, return_state_seq) -> None:
    if row_controls:
        raise NotImplementedError(
            "fused_circuit_process: per-row and per-sample pot streams (row_controls) come "
            "with the generic training kernel, ROADMAP B8")
    if return_state_seq:
        raise NotImplementedError(
            "fused_circuit_process: the state trajectory (return_state_seq) comes with the "
            "generic training kernel, ROADMAP B8")


def _check_io(vin: torch.Tensor) -> None:
    if vin.dim() != 2 or vin.dtype != torch.float32:
        raise ValueError(f"vin must be (B, T) float32, got {tuple(vin.shape)} {vin.dtype}")
    if vin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vin.device}")


def prepare(circuit, params, device, *, input_node: str = "Vin",
            static_controls: Controls = None, neural_mlp=None):
    """(program, coefficient vector, root array or None) of one call on
    ``device``: the adaptation pass runs once, on the params' device.
    ``neural_mlp`` serves the circuit with that NxH MLP as its root."""
    static = static_controls or {}
    coeffs = circuit.adapt(params, static)
    prog = program(circuit, coeffs, params, static, input_node, neural_mlp)
    vec = prog.coefficients(circuit, coeffs, params, static, device)
    warr = prog.emitter.array(coeffs[circuit.tree.name]["R"], params, device)
    return prog, vec, warr


def _state_stack(prog: CircuitProgram, state0, vin) -> torch.Tensor:
    """The state leaves in the program's order as one (S, B) f32 array."""
    B = vin.shape[0]
    leaves = []
    for node, field in prog.state_order:
        z = state0[node][field]
        if z.shape != (B,) or z.dtype != torch.float32 or z.device != vin.device:
            raise ValueError(f"state {node}.{field} must be ({B},) float32 on {vin.device}, "
                             f"got {tuple(z.shape)} {z.dtype} on {z.device}")
        leaves.append(z)
    if not leaves:
        return torch.zeros((0, B), device=vin.device)
    return torch.stack(leaves).contiguous()


def _state_dict(prog: CircuitProgram, leaves) -> Dict[str, Dict[str, Any]]:
    out: Dict[str, Dict[str, Any]] = {}
    for (node, field), z in zip(prog.state_order, leaves):
        out.setdefault(node, {})[field] = z
    return out


def _run_plain(circuit, params, vin, state0, input_node, static_controls, neural_mlp):
    prog, vec, warr = prepare(circuit, params, vin.device, input_node=input_node,
                              static_controls=static_controls, neural_mlp=neural_mlp)
    coeffs_k, params_k, static_k, slots = prog.unflatten(vec)
    r_up = coeffs_k[circuit.tree.name]["R"]

    def root_fn(a, r, controls):
        return prog.emitter.plain(a, r_up, slots, warr, controls, params_k)

    z = list(_state_stack(prog, state0, vin))
    out = torch.empty_like(vin)
    for t in range(vin.shape[1]):
        controls = {k: dict(v) for k, v in static_k.items()}
        controls.setdefault(input_node, {})["v"] = vin[:, t]
        new_state, y = step(circuit, coeffs_k, _state_dict(prog, z), controls, root_fn)
        out[:, t] = y
        z = [new_state[node][field] for node, field in prog.state_order]
    return out, _state_dict(prog, z)


def launch(prog: CircuitProgram, vec, warr, vin, z0):
    """Launch the generated kernel of ``prog`` on prepared arguments (see
    :func:`prepare`): vin (B, T) and z0 (S, B) f32 on one card.  Returns
    (out (B, T), z_final (S, B)).  Counts in ``fused_circuit_process.launches``."""
    lib = _build.generated_library(prog.source)
    B, T = vin.shape
    with torch.cuda.device(vin.device):
        vin = vin.contiguous()
        out, zf = torch.empty_like(vin), torch.empty_like(z0)
        w = warr if warr is not None else vec  # a valid pointer; n_warr = 0
        err = lib.circuit_launch(
            vin.data_ptr(), z0.data_ptr(), out.data_ptr(), zf.data_ptr(), B, T,
            vec.data_ptr(), w.data_ptr(), 0 if warr is None else warr.numel(),
            torch.cuda.current_stream(vin.device).cuda_stream)
    _build.check(err, "fused_circuit_process launch", lib.circuit_error_string)
    fused_circuit_process.launches += 1
    return out, zf


def _run(circuit, params, vin, state0, input_node, static_controls, neural_mlp):
    """The plain version for CPU tensors, the generated kernel for CUDA ones."""
    if vin.device.type == "cpu":
        return _run_plain(circuit, params, vin, state0, input_node, static_controls, neural_mlp)
    prog, vec, warr = prepare(circuit, params, vin.device, input_node=input_node,
                              static_controls=static_controls, neural_mlp=neural_mlp)
    z0 = _state_stack(prog, state0, vin)
    if vin.shape[0] == 0:
        return torch.empty_like(vin), _state_dict(prog, list(z0))
    out, zf = launch(prog, vec, warr, vin, z0)
    return out, _state_dict(prog, list(zf))


def fused_circuit_process_plain(circuit, params, vin, state0, *, input_node: str = "Vin",
                                static_controls: Controls = None, row_controls: Controls = None,
                                return_state_seq: bool = False):
    """Plain PyTorch version of the generated kernel: hoisted adaptation,
    then the circuit's step one sample at a time over the batch, on the
    kernel's f32 coefficient values.  Returns (out (B, T), final state)."""
    _check_deferred(row_controls, return_state_seq)
    _check_io(vin)
    return _run_plain(circuit, params, vin, state0, input_node, static_controls, None)


def fused_circuit_process(circuit, params, vin, state0, *, input_node: str = "Vin",
                          static_controls: Controls = None, row_controls: Controls = None,
                          return_state_seq: bool = False):
    """Run ``circuit`` over ``vin`` (B, T) f32 in one generated kernel.

    state0: the circuit's state dict with each leaf of shape (B,).  Returns
    (out (B, T), final state dict).  Matches ``circuit.process`` with hoisted
    adaptation; impedance-affecting values go in ``params`` or
    ``static_controls``.
    """
    _check_deferred(row_controls, return_state_seq)
    _check_io(vin)
    return _run(circuit, params, vin, state0, input_node, static_controls, None)


fused_circuit_process.launches = 0


def fused_circuit_process_neural_plain(circuit, params, mlp_params, vin, state0, *,
                                       input_node: str = "Vin", static_controls: Controls = None,
                                       row_controls: Controls = None,
                                       return_state_seq: bool = False):
    """Plain PyTorch version of :func:`fused_circuit_process_neural`."""
    _check_deferred(row_controls, return_state_seq)
    _check_io(vin)
    return _run_plain(circuit, params, vin, state0, input_node, static_controls, mlp_params)


def fused_circuit_process_neural(circuit, params, mlp_params, vin, state0, *,
                                 input_node: str = "Vin", static_controls: Controls = None,
                                 row_controls: Controls = None, return_state_seq: bool = False):
    """Fused execution of ``circuit`` with an NxH neural diode root,
    b = -MLP([a, log R]) with the MLP ``mlp_params`` (all-tanh hidden layers,
    linear head; anything else raises ``ValueError``), e.g. the Tube
    Screamer's 2x16 model choice.  The weights travel as the kernel's root
    array, with log R folded into the first bias; the circuit's own root
    params are not read."""
    _check_deferred(row_controls, return_state_seq)
    _check_io(vin)
    return _run(circuit, params, vin, state0, input_node, static_controls, mlp_params)
