"""Time-block sharding: long-signal WDF processing and training across ranks.

The WDF sample recursion is strictly sequential, but its state (one
capacitor ``z`` per reactive element) forgets exponentially: the reference
resets state at 2048-sample chunk boundaries and skips the first 50 samples
in the loss (``clipper_pot.py:110,232``).  That makes a parallel decode
(BASELINE.json configuration 5):

- **overlap-save (parallel)**: the signal splits into D contiguous blocks,
  one a rank of the mesh "time" axis.  Each rank prepends the last W
  samples before its block, runs W + T/D samples from zero state and drops
  the W warm-up outputs.  The error decays like the circuit's state memory,
  exp(-W 2 pi fc / fs) for an RC corner at fc, so W comes from an error
  budget (:func:`warmup_for_tolerance`).
- **exact (sequential handoff)**: rank d starts from rank d-1's final state,
  received with ``recv`` after D - 1 rounds in rank order; exact, no
  speedup; it measures the overlap mode's error.

Every rank holds the global input, as the callers of the JAX package's
``shard_map`` functions pass it, so the W samples before a block are a
slice of it, not a transfer from the neighbour (JAX's ``ppermute``).  The
final state of the exact mode is the one transfer that carries data no rank
has.  The outputs are gathered (``all_gather``) into the global [T] on
every rank.

A rank's block runs through the generated circuit kernel (B7,
``ops.fused_circuit``) at B = 1, as the streaming scan engine serves a
circuit; training runs the generic differentiable engine
(``ops.parallel_bptt``: B7's training form and B8).  CPU tensors run their
plain versions.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core.circuit import Circuit, _collect_impedance_controls
from ..core.elements import Device
from ..ops.circuit_codegen import state_order
from ..ops.fused_circuit import fused_circuit_process
from ..ops.parallel_bptt import make_fused_circuit_train_generic
from ..training.losses import pre_emphasis
from .data_parallel import sums_train_step
from .mesh import (all_gather, axis_index, axis_size, block_bounds, has_axis, rank_device,
                   recv_prev, send_next)
from .sweep import _signal, _to


def warmup_for_tolerance(fc_hz: float, fs: float, tol: float = 1e-6) -> int:
    """Samples of warm-up needed for the state error to decay below ``tol``
    for a circuit whose slowest pole sits at fc_hz."""
    rate = 2.0 * math.pi * fc_hz / fs  # per-sample decay exponent
    return max(1, int(math.ceil(-math.log(tol) / rate)))


def _global_inputs(inputs, dev) -> Dict[str, Dict[str, torch.Tensor]]:
    out = {node: {f: torch.as_tensor(x, dtype=torch.float32).to(dev) for f, x in fields.items()}
           for node, fields in inputs.items()}
    lengths = {x.shape[0] for fields in out.values() for x in fields.values()}
    if len(lengths) != 1:
        raise ValueError(f"inputs disagree on the time axis length: {sorted(lengths)}")
    return out


def _block_length(T: int, D: int, warmup: int = 1) -> int:
    if T % D:
        raise ValueError(f"{T} samples do not split evenly over the {D} ranks of the time axis")
    if not 1 <= warmup <= T // D:
        raise ValueError(f"warmup={warmup} must lie in [1, {T // D}], the block length")
    return T // D


def _run_block(circuit: Circuit, params, inputs, state):
    """One rank's block through B7 at B = 1 from ``state`` ({node: {field:
    0-d}}): (out [T], final state)."""
    node, vin, rows = _signal(circuit, inputs, 1, _device_of(inputs))
    z0 = {k: {f: z.reshape(1).to(torch.float32) for f, z in d.items()} for k, d in state.items()}
    out, zf = fused_circuit_process(circuit, params, vin, z0, input_node=node,
                                    row_controls=rows or None)
    return out[0], {k: {f: z[0] for f, z in d.items()} for k, d in zf.items()}


def _device_of(inputs) -> torch.device:
    return next(x for fields in inputs.values() for x in fields.values()).device


def time_block_process(circuit: Circuit, params, inputs, mesh: DeviceMesh, *,
                       warmup: int = 256, axis: str = "time",
                       device: Device = "cuda") -> torch.Tensor:
    """Overlap-save parallel processing of a long signal.

    inputs: the global {node: {field: [T]}} (one signal field "v", and
    impedance controls such as a pot "R"), T divisible by the axis size,
    the same on every rank.  Returns the global outputs [T] on every rank.
    The first rank's warm-up prefix is silence (zero drive), the reference's
    cold-start-and-skip convention, for signal fields only: an impedance
    control keeps its (wrapped tail) values, else the per-sample adaptation
    would divide by zero (G = 1/R) and NaN fill the first block."""
    dev = rank_device(device)
    x = _global_inputs(inputs, dev)
    T = next(v.shape[0] for f in x.values() for v in f.values())
    L = _block_length(T, axis_size(mesh, axis), warmup)
    r = axis_index(mesh, axis)
    imp: Dict[str, tuple] = {}
    _collect_impedance_controls(circuit.tree, imp)
    idx = torch.arange(r * L - warmup, (r + 1) * L, device=dev) % T
    ext = {}
    for node, fields in x.items():
        ext[node] = {}
        for f, v in fields.items():
            v = v[idx]
            if r == 0 and f not in imp.get(node, ()):
                v[:warmup] = 0.0
            ext[node][f] = v
    out, _ = _run_block(circuit, _to(params, dev), ext, circuit.init_state(dev))
    return all_gather(out[warmup:], mesh, axis)


def time_block_process_exact(circuit: Circuit, params, inputs, mesh: DeviceMesh, *,
                             axis: str = "time", device: Device = "cuda") -> torch.Tensor:
    """Exact sequential-handoff processing (validation reference): rank d
    receives rank d-1's final state, runs its block once from it and sends
    its own final state on: D - 1 transfers in rank order.  Exact, no
    speedup.  Takes and returns as :func:`time_block_process`."""
    dev = rank_device(device)
    x = _global_inputs(inputs, dev)
    T = next(v.shape[0] for f in x.values() for v in f.values())
    D = axis_size(mesh, axis)
    L = _block_length(T, D)
    r = axis_index(mesh, axis)
    order = state_order(circuit)
    state = circuit.init_state(dev)
    if r > 0:
        flat = recv_prev(torch.zeros(len(order), device=dev), mesh, axis)
        state = {}
        for (node, field), z in zip(order, flat):
            state.setdefault(node, {})[field] = z
    blk = {node: {f: v[r * L:(r + 1) * L] for f, v in fields.items()}
           for node, fields in x.items()}
    out, zf = _run_block(circuit, _to(params, dev), blk, state)
    if r < D - 1:
        send_next(torch.stack([zf[node][field] for node, field in order]), mesh, axis)
    return all_gather(out, mesh, axis)


def make_time_block_train_step(circuit: Circuit, cfg, mesh: DeviceMesh, *, warmup: int = 256,
                               axis: str = "time", batch_axis: str = "data",
                               input_node: str = "", trainable_filter=None,
                               device: Device = "cuda"):
    """Overlap-save BPTT: train on long sequences with their chunks split
    over the mesh ``axis``.

    Each rank prepends the ``warmup`` samples before its block, runs the
    generic differentiable engine from zero state, and the warm-up outputs
    are left out of the loss; the first rank of the time axis also skips
    ``cfg.skip_samples``, as the single-process loss does.  With
    ``cfg.use_pre_emphasis`` the one-zero filter runs continuously across
    block boundaries: a block's first sample is emphasised against the true
    previous output (the warm-up region's last) and the true previous
    target, and the seed sample dropped, so only the first rank's first
    sample keeps the single-process raw convention.  The global MSE + ESR is
    assembled from sums all-reduced over the time axis (and the data axis
    for [n_seq, T] inputs, whose count n is summed over both), and the
    gradient of the local se, all-reduced after ``backward()`` and scaled by
    dL/dse, equals the full-length BPTT gradient up to the overlap
    truncation, which decays like exp(-warmup 2 pi fc / fs).

    Returns (make_optimizer, train_step, eval_step) in the convention of
    ``training.circuit_train.make_train_step``:
    ``train_step(params, opt, x, y) -> metrics`` and ``eval_step(params, x,
    y)`` take the global [T] (rows replicated) or [n_seq, T] (rows split
    over ``batch_axis``, each row's samples over ``axis``) on every rank;
    ``train_step.grads_fn(params, x, y) -> (loss, aux, grads)`` gives the
    reduced gradient."""
    node = input_node or ("Vin" if "Vin" in circuit.init_params("cpu") else "Vs")
    forward = make_fused_circuit_train_generic(circuit, input_node=node)
    order = state_order(circuit)
    dev = rank_device(device)
    D = axis_size(mesh, axis)

    def local_sums(params, x, y):
        x = torch.as_tensor(x, dtype=torch.float32).to(dev)
        y = torch.as_tensor(y, dtype=torch.float32).to(dev)
        if x.dim() == 2:
            if not has_axis(mesh, batch_axis):
                raise ValueError(f"2-D inputs need the {batch_axis!r} mesh axis for the row "
                                 f"split; mesh axes: {mesh.mesh_dim_names}")
            lo, hi = block_bounds(x.shape[0], mesh, batch_axis)
            x, y, axes = x[lo:hi], y[lo:hi], (axis, batch_axis)
        else:
            x, y, axes = x[None], y[None], (axis,)
        B, T = x.shape
        L = _block_length(T, D, warmup)
        r = axis_index(mesh, axis)
        gate = 0.0 if r == 0 else 1.0  # cold-start silence on the first rank
        prev = torch.arange(r * L - warmup, r * L, device=dev) % T
        ext = torch.cat([gate * x[:, prev], x[:, r * L:(r + 1) * L]], dim=1)
        state = circuit.init_state(dev)
        z0 = [torch.as_tensor(state[n][f], dtype=torch.float32).expand(B).contiguous()
              for n, f in order]
        out, _ = forward(params, ext, z0)
        t = y[:, r * L:(r + 1) * L]
        if cfg.use_pre_emphasis:
            o = pre_emphasis(out[:, warmup - 1:], axis=1)[:, 1:]
            prev_y = gate * y[:, [(r * L - 1) % T]]
            t = pre_emphasis(torch.cat([prev_y, t], dim=1), axis=1)[:, 1:]
        else:
            o = out[:, warmup:]
        skip = min(cfg.skip_samples, L) if r == 0 else 0
        keep = (torch.arange(L, device=dev) >= skip).float()
        se = torch.sum(keep * torch.square(o - t))
        te = torch.sum(keep * torch.square(t))
        return se, te, float((L - skip) * B), axes

    return sums_train_step(local_sums, cfg, mesh, trainable_filter)
