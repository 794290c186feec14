"""Generic fused circuit: any adapted WDF `Circuit` run by one generated
CUDA kernel, and its plain PyTorch version.

``ops.circuit_codegen`` traces the circuit's sample step into C and wraps it
in a kernel that gives each stream one thread, the state and coefficients in
registers (B7 in ROADMAP), or a group of K lanes that runs the tree on every
lane and splits the root's work across the group: an NxH neural root's MLP
or a general MLP's hidden layers (their outputs over the lanes), the diode
pair's two omega solves on a pair of lanes, or the distilled root's
Chebyshev segments, one a lane (:func:`lanes_for` picks K from the batch);
``ops._build`` compiles one
library per generated source and keeps it, keyed by a hash of the source,
so a new component value or drive setting is a new argument, never a new
build.  This serves and trains the Tube Screamer (4-port R-type stage,
three states), the HPF clipper, the clippers and the simple circuits, with
analytic, NxH neural, distilled or ideal-source roots.

A wrapper given CPU tensors runs its plain version: the adaptation pass
hoisted out of the loop, then the circuit's step (the tree's own
``reflected`` / ``incident``, the root's plain twin) one sample at a time
over the batch, on the same f32 slot values the kernel gets.  Given CUDA
tensors it launches the generated kernel or raises.  Kernel launches are
counted in ``fused_circuit_process.launches`` (the ``_neural`` entry
launches through it); those of a lane form (K > 1) also in
``fused_circuit_process.lane_launches``, and of the diode pair's (K = 2) in
``fused_circuit_process.pair_launches``.  Spans (``runtime.profiler``, while a
profiler records): ``wdf.call`` around each call of a wrapper, ``wdf.prepare``
around :func:`prepare` with ``wdf.adapt``, ``wdf.codegen`` (the program's
lookup, and its generation on a miss) and ``wdf.slots`` (the slot values and
the root array, each copy of a host value in a ``wdf.h2d``) inside, and
``wdf.launch.B7`` around the kernel's launch.

Impedance-affecting controls are block-rate (``static_controls``), per row
or per sample (``row_controls``, {node: {field: (B,) | (B, T)}}: the
measured pot of the training data, one R per chunk or one per sample).
The adaptation runs batched outside the kernel; the coefficients a pot
reaches become per-row registers or per-sample streams staged like the
input.  ``return_state_seq`` also returns the pre-step state trajectory
z_{t-1}, the residual of the generic training adjoint (``ops.parallel_bptt``).
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import torch

from ..runtime.profiler import span
from . import _build
from .circuit_codegen import LANE_TARGETS, CircuitProgram, program, step

Controls = Optional[Dict[str, Dict[str, Any]]]


class Prepared(NamedTuple):
    """The launch arguments of one call (see :func:`prepare`)."""

    prog: CircuitProgram
    vec: torch.Tensor              # coefficient slots (NC,)
    warr: Optional[torch.Tensor]   # root array, or None
    rows: torch.Tensor             # row slots (NR, B), empty for none
    times: torch.Tensor            # time slots (NQ, B, T), empty for none
    r_up: Any = None               # the root's port impedance as adapted


def _merge_controls(static_controls, row_controls):
    """Deep-merge {node: {field: val}} dicts (row values win)."""
    out = {k: dict(v) for k, v in (static_controls or {}).items()}
    for node, fields in (row_controls or {}).items():
        out.setdefault(node, {})
        out[node].update(fields)
    return out


def _check_io(vin: torch.Tensor, row_controls: Controls = None) -> None:
    if vin.dim() != 2 or vin.dtype != torch.float32:
        raise ValueError(f"vin must be (B, T) float32, got {tuple(vin.shape)} {vin.dtype}")
    if vin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vin.device}")
    B, T = vin.shape
    for node, fields in (row_controls or {}).items():
        for field, x in fields.items():
            if (not isinstance(x, torch.Tensor) or tuple(x.shape) not in ((B,), (B, T))
                    or not x.is_floating_point() or x.device != vin.device):
                raise ValueError(
                    f"row control {node}.{field} must be a ({B},) or ({B}, {T}) float tensor "
                    f"on {vin.device}, got {getattr(x, 'shape', type(x).__name__)}")


def prepare(circuit, params, device, *, input_node: str = "Vin",
            static_controls: Controls = None, row_controls: Controls = None,
            neural_mlp=None, shape=None) -> Prepared:
    """The program and launch arguments of one call on ``device``: the
    adaptation pass runs once, on the params' device.  ``row_controls``
    need the call's (B, T) as ``shape``.  ``neural_mlp`` runs the circuit
    with that NxH MLP as its root."""
    static = static_controls or {}
    batch, time = 0, 0
    if row_controls:
        if shape is None:
            raise ValueError("prepare: row_controls need the call's shape (B, T)")
        batch, time = shape
    with span("wdf.prepare"):
        with span("wdf.adapt"):
            coeffs = circuit.adapt(params, _merge_controls(static, row_controls))
        with span("wdf.codegen"):
            prog = program(circuit, coeffs, params, static, input_node, neural_mlp, batch, time)
        with span("wdf.slots"):
            vec, rows, times = prog.arguments(circuit, coeffs, params, static, device)
            r_up = coeffs[circuit.tree.name]["R"]
            warr = prog.emitter.array(r_up, params, device)
    return Prepared(prog, vec, warr, rows, times, r_up)


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


def plain_step(circuit, prep: Prepared):
    """The kernel's step in PyTorch ops on the prepared slot values:
    ``run(z, v, t, tap=None) -> (new z, out)`` with z a list of S (B,)
    tensors in the program's state order and t the sample index (for the
    per-sample slots).  Differentiable in z and v (``ops.parallel_bptt``'s
    plain adjoint pulls its VJP).  ``tap(a, b) -> b``, where given, sees the
    root's incident and reflected waves and returns the reflected wave the
    step goes on with."""
    prog = prep.prog
    fixed = None if prep.times.numel() else prog.unflatten(prep.vec, prep.rows, prep.times)

    def run(z, v, t, tap=None):
        coeffs_k, params_k, static_k, slots = (
            fixed if fixed is not None else prog.unflatten(prep.vec, prep.rows, prep.times, t))
        r_up = coeffs_k[circuit.tree.name]["R"]

        def root_fn(a, r, controls):
            b = prog.emitter.plain(a, r_up, slots, prep.warr, controls, params_k)
            return b if tap is None else tap(a, b)

        controls = {k: dict(x) for k, x in static_k.items()}
        controls.setdefault(prog.input_node, {})["v"] = v
        new_state, y = step(circuit, coeffs_k, _state_dict(prog, z), controls, root_fn)
        return [new_state[node][field] for node, field in prog.state_order], y

    return run


def _run_plain(circuit, params, vin, state0, input_node, static_controls, row_controls,
               neural_mlp, want_seq):
    prep = prepare(circuit, params, vin.device, input_node=input_node,
                   static_controls=static_controls, row_controls=row_controls,
                   neural_mlp=neural_mlp, shape=tuple(vin.shape))
    run = plain_step(circuit, prep)
    z = list(_state_stack(prep.prog, state0, vin))
    out = torch.empty_like(vin)
    seq = [torch.empty_like(vin) for _ in z] if want_seq else None
    for t in range(vin.shape[1]):
        for k in range(len(seq or ())):
            seq[k][:, t] = z[k]
        z, y = run(z, vin[:, t], t)
        out[:, t] = y
    return out, _state_dict(prep.prog, z), seq


def lanes_for(prog: CircuitProgram, B: int) -> int:
    """The lanes per stream ``launch`` uses for B streams: the largest of
    the program's group sizes (``CircuitProgram.lanes``, 1 the one-thread
    kernel) at most the batch's target in ``fused_clipper.LANE_TARGETS``.
    For an NxH root (and a general MLP's), few streams leave most of the
    card idle, so each gets many lanes, and many streams fill it, where the
    tree that every lane repeats and the shuffles would make a large group
    issue-bound.  The diode pair's program has lanes (1, 2) and the
    distilled root's (1, 4) (8 for five to eight segments), so they take
    that K at every B, B = 1 included."""
    target = next(k for bound, k in LANE_TARGETS if bound is None or B <= bound)
    return max(k for k in prog.lanes if k <= target)


def launch(prep: Prepared, vin, z0, with_seq: bool = False, lanes: Optional[int] = None,
           writer: int = 0):
    """Launch the generated kernel on prepared arguments (see
    :func:`prepare`): vin (B, T) and z0 (S, B) f32 on one card; ``lanes``
    the lanes per stream, one of ``prep.prog.lanes`` (default
    :func:`lanes_for`; 1 is the one-thread kernel); ``writer`` the lane of
    a group that writes the results (the tests run each).  Returns (out
    (B, T), z_final (S, B), the trajectory (S, B, T) or None).  Counts in
    ``fused_circuit_process.launches``."""
    lanes = lanes_for(prep.prog, vin.shape[0]) if lanes is None else lanes
    if lanes not in prep.prog.lanes:
        raise ValueError(f"fused_circuit: lanes={lanes}, this kernel takes {prep.prog.lanes}")
    return launch_source(prep.prog.source, vin, z0, prep.vec, prep.rows, prep.times,
                         prep.warr, with_seq, lanes, writer)


def launch_source(source: str, vin, z0, vec, rows, times, warr, with_seq: bool = False,
                  lanes: int = 1, writer: int = 0):
    """Launch the generated kernel of ``source`` (a program's ``source``) on
    its launch arguments, with no program object: vin (B, T), z0 (S, B), the
    slots ``vec``, ``rows``, ``times`` and the root array ``warr`` (or None)
    f32 on one card; ``lanes`` one of the program's ``lanes`` (the kernel
    refuses any other).  Returns as :func:`launch`.  Counts in
    ``fused_circuit_process.launches`` (the artifact's op, ``ops.registry``,
    launches through it too)."""
    lib = _build.generated_library(source)
    B, T = vin.shape
    dummy = vec  # a valid pointer where an argument is empty
    with torch.cuda.device(vin.device):
        vin = vin.contiguous()
        out, zf = torch.empty_like(vin), torch.empty_like(z0)
        seq = torch.empty((z0.shape[0], B, T), device=vin.device) if with_seq else None
        w = warr if warr is not None else dummy
        with span("wdf.launch.B7"):
            err = lib.circuit_launch(
                vin.data_ptr(), z0.data_ptr(), out.data_ptr(), zf.data_ptr(),
                seq.data_ptr() if seq is not None and seq.numel() else None, B, T,
                vec.data_ptr(), (rows if rows.numel() else dummy).data_ptr(),
                (times if times.numel() else dummy).data_ptr(), w.data_ptr(),
                0 if warr is None else warr.numel(), lanes, writer,
                torch.cuda.current_stream(vin.device).cuda_stream)
    _build.check(err, "fused_circuit_process launch", lib.circuit_error_string)
    fused_circuit_process.launches += 1
    if lanes > 1:
        fused_circuit_process.lane_launches += 1
    if lanes == 2:
        fused_circuit_process.pair_launches += 1
    return out, zf, seq


def omega_forms(x: torch.Tensor, iters: int):
    """(omega(x, iters), omega_select<iters>(x)) of ``csrc/omega.cuh`` on
    the card, iters 1, 2 or 3: the check that the generated forward step,
    which solves the diode pair with omega_select, gives the bits it gave
    with omega() (``csrc/forms/omega_forms.cu``; chip_smoke.py and the card
    tests).  x: f32 on a card.  Counts nothing."""
    lib = _build.generated_library((_build.CSRC_DIR / "forms" / "omega_forms.cu").read_text())
    x = x.contiguous()
    w_omega, w_select = torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        err = lib.omega_forms_launch(x.data_ptr(), w_omega.data_ptr(), w_select.data_ptr(),
                                     x.numel(), iters,
                                     torch.cuda.current_stream(x.device).cuda_stream)
    _build.check(err, "omega_forms launch")
    return w_omega, w_select


@span("wdf.call")
def _run(circuit, params, vin, state0, input_node, static_controls, row_controls, neural_mlp,
         want_seq):
    """The plain version for CPU tensors, the generated kernel for CUDA ones."""
    _check_io(vin, row_controls)
    if vin.device.type == "cpu":
        out, state, seq = _run_plain(circuit, params, vin, state0, input_node, static_controls,
                                     row_controls, neural_mlp, want_seq)
    else:
        prep = prepare(circuit, params, vin.device, input_node=input_node,
                       static_controls=static_controls, row_controls=row_controls,
                       neural_mlp=neural_mlp, shape=tuple(vin.shape))
        z0 = _state_stack(prep.prog, state0, vin)
        if vin.shape[0] == 0:
            out, zf = torch.empty_like(vin), z0
            seq = torch.empty((z0.shape[0],) + tuple(vin.shape), device=vin.device)
        else:
            out, zf, seq = launch(prep, vin, z0, want_seq)
        state, seq = _state_dict(prep.prog, list(zf)), list(seq) if want_seq else None
    return (out, state, seq) if want_seq else (out, state)


def fused_circuit_process_plain(circuit, params, vin, state0, *, input_node: str = "Vin",
                                static_controls: Controls = None, row_controls: Controls = None,
                                return_state_seq: bool = False):
    """Plain PyTorch version of the generated kernel: hoisted adaptation,
    then the circuit's step one sample at a time over the batch, on the
    kernel's f32 slot values.  Returns as :func:`fused_circuit_process`."""
    _check_io(vin, row_controls)
    out, state, seq = _run_plain(circuit, params, vin, state0, input_node, static_controls,
                                 row_controls, None, return_state_seq)
    return (out, state, seq) if return_state_seq else (out, state)


def fused_circuit_process(circuit, params, vin, state0, *, input_node: str = "Vin",
                          static_controls: Controls = None, row_controls: Controls = None,
                          return_state_seq: bool = False):
    """Run ``circuit`` over ``vin`` (B, T) f32 in one generated kernel.

    state0: the circuit's state dict with each leaf of shape (B,).  Returns
    (out (B, T), final state dict), and with ``return_state_seq`` also the
    pre-step state trajectory: S (B, T) tensors, z_{t-1} of every step t, in
    the sorted (node, field) order of the state.  Matches
    ``circuit.process`` with hoisted adaptation; impedance-affecting values
    go in ``params``, ``static_controls`` or, per row or per sample,
    ``row_controls`` ((B,) or (B, T) tensors on vin's device).
    """
    return _run(circuit, params, vin, state0, input_node, static_controls, row_controls, None,
                return_state_seq)


fused_circuit_process.launches = 0
fused_circuit_process.lane_launches = 0
fused_circuit_process.pair_launches = 0


def fused_circuit_process_neural_plain(circuit, params, mlp_params, vin, state0, *,
                                       input_node: str = "Vin", static_controls: Controls = None,
                                       row_controls: Controls = None,
                                       return_state_seq: bool = False):
    """Plain PyTorch version of :func:`fused_circuit_process_neural`."""
    _check_io(vin, row_controls)
    out, state, seq = _run_plain(circuit, params, vin, state0, input_node, static_controls,
                                 row_controls, mlp_params, return_state_seq)
    return (out, state, seq) if return_state_seq else (out, state)


def fused_circuit_process_neural(circuit, params, mlp_params, vin, state0, *,
                                 input_node: str = "Vin", static_controls: Controls = None,
                                 row_controls: Controls = None, return_state_seq: bool = False):
    """Fused execution of ``circuit`` with an NxH neural diode root,
    b = -MLP([a, log R]) with the MLP ``mlp_params`` (all-tanh hidden layers,
    linear head; anything else raises ``ValueError``), e.g. the Tube
    Screamer's 2x16 model choice.  The weights travel as the kernel's root
    array, with log R folded into the first bias (built per stream or per
    step when a pot reaches R); the circuit's own root params are not read.
    Arguments and results as :func:`fused_circuit_process`."""
    return _run(circuit, params, vin, state0, input_node, static_controls, row_controls,
                mlp_params, return_state_seq)
