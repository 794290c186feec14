"""Generic differentiable fused engine: generated CUDA forward and adjoint.

``ops.clipper_train`` hand-derives the LPF clipper's scalar adjoint; this
module does the same for ANY adapted WDF `Circuit` the generator takes
(multi-state trees, R-type adaptors, analytic or neural roots), so the Tube
Screamer and HPF training workloads and the joint physics+neural fit leave
the sequential autograd of the scan engine.

Writing one step as (z_t, o_t) = F(z_{t-1}, v_t, theta):

- **Forward**: the generated forward kernel (``ops.fused_circuit``, B7) runs
  the recursion and also writes the pre-step state trajectory z_{t-1}, the
  only residual the backward needs.
- **Adjoint** (B8, :func:`fused_backward`): the state cotangent
  lam_t = dL/dz_t obeys the reverse recursion

      lam_{t-1} = J_t^T lam_t + A_t^T obar_t,        lam_T = zbar_f,

  with J_t = dF_z/dz and A_t = dF_o/dz at the stored trajectory.  The
  generated adjoint (``circuit_codegen.generate_adjoint``) runs it as two
  kernels: J_t and A_t obar_t depend on the trajectory alone, so pass 1
  evaluates the S + 1 tangents of the traced step (S states, then v) for
  every (b, t) sample in parallel into a scratch; pass 2 gives each stream
  a thread that walks t = T-1 ... 0 contracting them with lam_t, in the
  order and rounding of the one-pass step.  It writes lam_t for every step
  (before the update), g_vin and g_z0 = lam_0.
- **Parameters**: one autograd pass of the scalar

      g(theta) = sum_{b,t} <F(z_{t-1}, v_t, theta), (lam_t, obar_t)>

  through ``circuit.adapt`` and the batched step over the whole (B, T)
  trajectory (``_batched_step``), so component values (R, C), diode physics
  and the neural root all receive exact cotangents.  It stays PyTorch ops,
  but for an NxH root whose port impedance is one value or one per row
  (``circuit_codegen.root_streams``): there the step is linear in the
  root's reflected wave b = -MLP([a, log R_up]), so B8 also hands over the
  root's incident wave a_t (pass 1) and G_t = (dF/db)^T (lam_t, obar_t)
  (pass 2, the "b column" contracted with lam_t), and the root's leaves
  are one batched VJP of the MLP with dL/dy = -G: on the card B4's pass 3
  (``clipper_train.launch_param_vjp``, :func:`root_param_vjp`).  Only the
  other leaves that need a gradient then go through autograd.

Impedance-affecting drives may be batch-constant (``static_controls``), per
row or per sample (``row_fields``: the measured pot of the training data);
their values get zero cotangents.  Restrictions, as in the JAX package: one
output probe, and no pot inside an R-type adaptor.  A per-sample R_up keeps
the root's leaves in the autograd pass.

A CPU tensor runs the plain versions: B7's, and :func:`fused_backward_plain`,
a reverse loop over t that pulls the VJP of one plain step by autograd at
z_{t-1}: an oracle independent of the kernel's forward-mode pulls.  Calls
of B8 are counted in ``fused_backward.launches``: one call is two kernel
launches (pass 1 and pass 2) per time chunk, one chunk up to the scratch cap;
those of the root's pass 3 in ``root_param_vjp.launches`` (``B8.pass3``).
Spans (``runtime.profiler``, while a profiler records): ``wdf.bptt`` around the
op's backward, with B8's ``wdf.prepare`` (``fused_circuit.prepare``),
``wdf.launch.B8.pass1`` and ``wdf.launch.B8.pass2`` (each time chunk's two
launches) and ``wdf.param_pass`` (:func:`parameter_cotangents`, with
``wdf.launch.B8.pass3`` around the root's pass 3) inside.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..roots.neural import NeuralDiodeRoot
from ..runtime.profiler import h2d, span
from . import _build
from . import clipper_train as ct
from .circuit_codegen import adjoint_program, root_streams, state_order
from .fused_circuit import (
    Controls,
    _check_io,
    _merge_controls,
    fused_circuit_process,
    fused_circuit_process_neural,
    plain_step,
    prepare,
)

def _batched_step(circuit, coeffs, params, static_controls, input_node):
    """The circuit step as a pure tensor function: (state leaves list, v) ->
    (new state leaves list, out), broadcasting over any leading shape (the
    scatter algebra and the roots are elementwise or batched torch ops).
    State leaves in the sorted (node, field) order."""
    order = state_order(circuit)

    def step(st_vec, v):
        st: Dict[str, Dict[str, Any]] = {}
        for (node, field), z in zip(order, st_vec):
            st.setdefault(node, {})[field] = z
        controls = {k: dict(vv) for k, vv in (static_controls or {}).items()}
        controls.setdefault(input_node, {})["v"] = v
        waves: Dict[str, Any] = {}
        a_root = circuit.tree.reflected(coeffs, st, controls, waves)
        r_up = coeffs[circuit.tree.name]["R"]
        b_root = circuit.root.reflect(a_root, r_up, params, controls)
        new_entries = circuit.tree.incident(coeffs, st, controls, waves, b_root)
        new_state = {**st, **new_entries}
        waves[circuit.root.name] = (a_root, b_root)
        return [new_state[node][field] for node, field in order], circuit.probe(waves)

    return step


def _check_backward(vin, g_out, z_prev, lam_T, S: int, row_controls) -> None:
    _check_io(vin, row_controls)
    B = vin.shape[0]
    if g_out.shape != vin.shape or len(z_prev) != S or len(lam_T) != S:
        raise ValueError(f"fused_backward: g_out {tuple(vin.shape)}, {S} trajectories and {S} "
                         f"final cotangents, got {tuple(g_out.shape)}, {len(z_prev)}, "
                         f"{len(lam_T)}")
    for x in [g_out, *z_prev, *lam_T]:
        if x.dtype != torch.float32 or x.device != vin.device:
            raise ValueError(f"fused_backward: every stream must be float32 on {vin.device}")
    if any(z.shape != vin.shape for z in z_prev) or any(l.shape != (B,) for l in lam_T):
        raise ValueError(f"fused_backward: trajectories {tuple(vin.shape)}, cotangents ({B},)")


class RootStreams(NamedTuple):
    """What B8 hands the root's parameter pass: the root's incident wave a
    and the cotangent G of its reflected wave b = -MLP([a, log R_up]) (so
    -G is that of the MLP's output), (B, T) each, and log R_up per row (B,)."""

    a_seq: torch.Tensor
    G: torch.Tensor
    log_r: torch.Tensor


def fused_backward_plain(circuit, params, vin, g_out, z_prev, lam_T, *, input_node: str = "Vs",
                         static_controls: Controls = None, row_controls: Controls = None,
                         neural_mlp=None):
    """Plain PyTorch version of :func:`fused_backward`: for t = T-1 ... 0,
    ``torch.autograd.grad`` of one plain step (the kernel's slot values and
    root twin, ``fused_circuit.plain_step``) at (z_{t-1}, v_t) with the
    cotangents (lam_t, obar_t).  Returns as :func:`fused_backward`: where
    the program has the root's streams, a_t as the step's root sees it and
    G_t as the gradient of a zero added to the root's reflected wave."""
    prep = prepare(circuit, params, vin.device, input_node=input_node,
                   static_controls=static_controls, row_controls=row_controls,
                   neural_mlp=neural_mlp, shape=tuple(vin.shape))
    S = len(prep.prog.state_order)
    _check_backward(vin, g_out, z_prev, lam_T, S, row_controls)
    run = plain_step(circuit, prep)
    B, T = vin.shape
    lam = [l.detach() for l in lam_T]
    lam_step = [torch.empty_like(vin) for _ in range(S)]
    g_vin = torch.empty_like(vin)
    root = (RootStreams(torch.empty_like(vin), torch.empty_like(vin), _log_r(prep, B))
            if root_streams(prep.prog.emitter) else None)
    for t in range(T - 1, -1, -1):
        for k in range(S):
            lam_step[k][:, t] = lam[k]
        probe = []  # the zero added to the root's reflected wave, whose gradient is G_t

        def tap(a, b):
            root.a_seq[:, t] = a.detach()
            probe.append(torch.zeros_like(b, requires_grad=True))
            return b + probe[0]

        with torch.enable_grad():
            z = [z_prev[k][:, t].detach().requires_grad_(True) for k in range(S)]
            v = vin[:, t].detach().requires_grad_(True)
            new, out = run(z, v, t, tap if root is not None else None)
            pairs = [(y, c) for y, c in zip(new + [out], lam + [g_out[:, t]]) if y.requires_grad]
            grads = (torch.autograd.grad([y for y, _ in pairs], z + [v] + probe,
                                         [c for _, c in pairs], allow_unused=True)
                     if pairs else (None,) * (S + 1 + len(probe)))
        zero = torch.zeros(B, dtype=vin.dtype, device=vin.device)
        lam = [g if g is not None else zero for g in grads[:S]]
        g_vin[:, t] = grads[S] if grads[S] is not None else zero
        if root is not None:
            root.G[:, t] = grads[S + 1] if grads[S + 1] is not None else zero
    return lam_step, g_vin, lam, root


def fused_backward(circuit, params, vin, g_out, z_prev, lam_T, *, input_node: str = "Vs",
                   static_controls: Controls = None, row_controls: Controls = None,
                   neural_mlp=None):
    """The generic adjoint of the circuit recurrence in one generated kernel.

    vin, g_out (the output's cotangent): (B, T) f32; z_prev: the pre-step
    state trajectory, S (B, T) tensors in the sorted (node, field) state
    order (``fused_circuit_process(..., return_state_seq=True)``); lam_T:
    the final state's cotangents, S (B,) tensors.  params, the controls and
    ``neural_mlp`` as the forward was given them.  Returns (lam_step: S
    (B, T) tensors, lam_step[k][:, t] = lam_t, the cotangent of the state
    step t wrote; g_vin (B, T); g_z0: S (B,) tensors; root: the root's
    :class:`RootStreams` where the program has them
    (``circuit_codegen.root_streams``) and B, T > 0 on the card, else
    None).  CPU tensors run :func:`fused_backward_plain`, and hand over no
    root streams: their root's leaves stay with autograd's pass.  CUDA
    tensors launch the kernel or raise.
    """
    if vin.device.type == "cpu":
        return (*fused_backward_plain(circuit, params, vin, g_out, z_prev, lam_T,
                                      input_node=input_node, static_controls=static_controls,
                                      row_controls=row_controls, neural_mlp=neural_mlp)[:3],
                None)
    prep = prepare(circuit, params, vin.device, input_node=input_node,
                   static_controls=static_controls, row_controls=row_controls,
                   neural_mlp=neural_mlp, shape=tuple(vin.shape))
    S = len(prep.prog.state_order)
    _check_backward(vin, g_out, z_prev, lam_T, S, row_controls)
    B, T = vin.shape
    zseq = (torch.stack(list(z_prev)) if S else vin.new_empty((0, B, T))).contiguous()
    lam_t = (torch.stack(list(lam_T)) if S else vin.new_empty((0, B))).contiguous()
    root = None
    if B == 0 or T == 0:
        lam_seq, g_vin, g_z0 = torch.empty_like(zseq), torch.empty_like(vin), lam_t.clone()
    else:
        if adjoint_program(circuit, prep.prog).root_streams:
            root = RootStreams(torch.empty_like(vin), torch.empty_like(vin), _log_r(prep, B))
        lam_seq, g_vin, g_z0 = launch_adjoint(circuit, prep, vin, g_out, zseq, lam_t,
                                              streams=None if root is None else root[:2])
    return list(lam_seq), g_vin, list(g_z0), root


def _log_r(prep, B: int) -> torch.Tensor:
    """log R_up per row (B,) of a program whose R_up is one value or one per
    row: taken in double and rounded, as the kernels' root takes it."""
    log_r = torch.log(torch.as_tensor(prep.r_up).detach().double()).float().reshape(-1)
    return h2d(log_r.expand(B) if log_r.numel() == 1 else log_r, prep.vec.device).contiguous()


def launch_adjoint(circuit, prep, vin, g_out, zseq, lam_t, streams=None):
    """Launch the generated adjoint of ``prep``'s program (see
    ``fused_circuit.prepare``) on one card: vin and g_out (B, T), zseq
    (S, B, T) and lam_t (S, B) f32, B and T > 0.  Returns (lam_seq (S, B, T),
    g_vin (B, T), g_z0 (S, B)).  ``streams``: for a program that writes the
    root's streams, two (B, T) f32 tensors that pass 1 fills with the
    root's incident wave a and pass 2 with G; else None.

    One call is two kernels per time chunk: pass 1
    (``circuit_jacobian_launch``, every (b, t) sample in parallel) writes the
    adjoint's entries into a scratch of ``n_entries`` floats a sample that
    this wrapper allocates, laid out for groups of ``AdjointProgram.GROUP``
    streams, pass 2 (``circuit_recursion_launch``) walks it back in time, a
    group a block.
    Time runs in chunks from the last to the first when the
    scratch of (B, T) would pass ``AdjointProgram.SCRATCH_CAP_BYTES``.  It
    counts one in ``fused_backward.launches`` per call."""
    adj = adjoint_program(circuit, prep.prog)
    lib = _build.generated_library(adj.source)
    B, T = vin.shape
    S = zseq.shape[0]
    dummy = prep.vec  # a valid pointer where an argument is empty
    tc = adj.chunk(B, T)
    if (streams is not None) != adj.root_streams:
        raise ValueError(f"launch_adjoint: this circuit's adjoint writes "
                         f"{'the' if adj.root_streams else 'no'} root streams")
    a_ptr, g_ptr = (None, None) if streams is None else (x.data_ptr() for x in streams)
    with torch.cuda.device(vin.device):
        stream = torch.cuda.current_stream(vin.device).cuda_stream
        vin, g_out = vin.contiguous(), g_out.contiguous()
        lam_seq, g_vin = torch.empty_like(zseq), torch.empty_like(vin)
        g_z0 = torch.empty_like(lam_t)
        jac = torch.empty(adj.scratch_floats(B, tc), device=vin.device)
        w = prep.warr if prep.warr is not None else dummy
        rows = prep.rows if prep.rows.numel() else dummy
        times = prep.times if prep.times.numel() else dummy
        z_ptr = (zseq if S else dummy).data_ptr()
        lam_in = lam_t if S else dummy
        for t0 in range(((T - 1) // tc) * tc, -1, -tc):
            n = min(tc, T - t0)
            with span("wdf.launch.B8.pass1"):
                err = lib.circuit_jacobian_launch(
                    vin.data_ptr(), g_out.data_ptr(), z_ptr, jac.data_ptr(), a_ptr, B, T, t0, n,
                    prep.vec.data_ptr(), rows.data_ptr(), times.data_ptr(), w.data_ptr(),
                    0 if prep.warr is None else prep.warr.numel(), stream)
            _build.check(err, "fused_backward launch (pass 1)", lib.circuit_error_string)
            with span("wdf.launch.B8.pass2"):
                err = lib.circuit_recursion_launch(
                    jac.data_ptr(), lam_in.data_ptr(), (g_z0 if S else dummy).data_ptr(),
                    (lam_seq if S else dummy).data_ptr(), g_vin.data_ptr(), g_ptr, B, T, t0, n,
                    stream)
            _build.check(err, "fused_backward launch (pass 2)", lib.circuit_error_string)
            lam_in = g_z0 if S else dummy
    fused_backward.launches += 1
    return lam_seq, g_vin, g_z0


fused_backward.launches = 0


def root_param_vjp(mlp, activations, a_seq, log_r, G) -> List[torch.Tensor]:
    """The cotangents of an NxH root's MLP parameters from the root streams
    B8 wrote on the card (:class:`RootStreams`): the VJP of
    y = MLP([a, log R_up]) over every (b, t) with dL/dy = -G, in
    ``clipper_train.mlp_leaves`` order, by B4's pass 3
    (``clipper_train.launch_param_vjp``: fixed-order sums, the same bits on
    every call) in a ``wdf.launch.B8.pass3`` span, counted in
    ``root_param_vjp.launches``."""
    return ct.param_vjp_on_card(root_param_vjp, "wdf.launch.B8.pass3", mlp, activations, a_seq,
                                log_r, G)


root_param_vjp.launches = 0


@span("wdf.param_pass")
def parameter_cotangents(circuit, params, vin, z_prev, g_out, lam_step, *,
                         input_node: str = "Vs", static_controls: Controls = None,
                         row_controls: Controls = None, root: Optional[RootStreams] = None,
                         needs: Optional[List[bool]] = None) -> List[Optional[torch.Tensor]]:
    """The cotangents of every leaf of ``params`` (in ``_flatten`` order,
    None for a leaf the step does not read): autograd of
    sum_{b,t} <F(z_{t-1}, v_t, theta), (lam_t, obar_t)> through the
    adaptation and the batched step over the whole (B, T) trajectory, with
    lam_step and g_out from the adjoint.  Per-row pot values enter as (B, 1)
    so their coefficients broadcast over time.

    Only the leaves that ``needs`` (a flag a leaf; None: every leaf) marks
    are computed, every other held as a constant (its cotangent None).
    With ``root``, the streams B8 wrote on the card for the circuit's NxH
    root, the root's marked leaves come from :func:`root_param_vjp`
    instead, and autograd runs only for the other marked leaves, if any."""
    leaves, rebuild = _flatten(params)
    grads: List[Optional[torch.Tensor]] = [None] * len(leaves)
    wanted = [i for i in range(len(leaves)) if needs is None or needs[i]]
    if root is not None:
        mlp = params[circuit.root.name]
        at = {id(x): k for k, x in enumerate(ct.mlp_leaves(mlp))}
        if any(id(leaves[i]) in at for i in wanted):
            g_root = root_param_vjp(mlp, circuit.root.activations, root.a_seq, root.log_r,
                                    root.G)
            for i in wanted:
                if id(leaves[i]) in at:
                    grads[i] = g_root[at[id(leaves[i])]]
        wanted = [i for i in wanted if id(leaves[i]) not in at]
    if wanted:
        for i, g in zip(wanted, _autograd_cotangents(circuit, vin, z_prev, g_out, lam_step,
                                                     leaves, rebuild, wanted, input_node,
                                                     static_controls, row_controls)):
            grads[i] = g
    return grads


def _autograd_cotangents(circuit, vin, z_prev, g_out, lam_step, leaves, rebuild, wanted,
                         input_node, static_controls, row_controls):
    """Autograd of the scalar of :func:`parameter_cotangents` for the leaves
    at the indices ``wanted``; every other leaf is held as a constant."""
    wanted = set(wanted)
    with torch.enable_grad():
        p_leaves = [x.detach().requires_grad_(i in wanted) for i, x in enumerate(leaves)]
        p = rebuild(p_leaves)
        rc = {node: {field: (x[:, None] if x.dim() == 1 else x) for field, x in d.items()}
              for node, d in (row_controls or {}).items()}
        coeffs = circuit.adapt(p, _merge_controls(static_controls, rc))
        z_new, o = _batched_step(circuit, coeffs, p, static_controls, input_node)(
            list(z_prev), vin)
        acc = (o * g_out).sum()
        for zk, lk in zip(z_new, lam_step):
            acc = acc + (zk * lk).sum()
        if not acc.requires_grad:  # no wanted leaf reaches the step
            return [None] * len(wanted)
        return list(torch.autograd.grad(acc, [x for i, x in enumerate(p_leaves) if i in wanted],
                                         allow_unused=True))


def _flatten(tree) -> Tuple[List[torch.Tensor], Callable]:
    """(leaves, rebuild) of a params tree of dicts (keys in sorted order) and
    lists; ``rebuild(new_leaves)`` gives the same tree around new leaves."""
    leaves: List[torch.Tensor] = []

    def spec(x):
        if isinstance(x, dict):
            return ("dict", [(k, spec(x[k])) for k in sorted(x)])
        if isinstance(x, (list, tuple)):
            return ("list", [spec(v) for v in x])
        leaves.append(x)
        return None

    structure = spec(tree)

    def build(it, s):
        if s is None:
            return next(it)
        kind, items = s
        if kind == "dict":
            return {k: build(it, v) for k, v in items}
        return [build(it, v) for v in items]

    return leaves, lambda new: build(iter(new), structure)


def make_fused_circuit_train_generic(
    circuit,
    *,
    input_node: str = "Vs",
    static_controls: Controls = None,
    row_fields: tuple = (),
):
    """Build the differentiable fused engine for ``circuit``.

    Returns ``f(params, vin, z0_leaves) -> (out, zf_leaves)``, or with
    ``row_fields`` ``f(params, vin, z0_leaves, row_vals)``: ``vin`` (B, T)
    f32 (any B), ``z0_leaves`` a list of S (B,) tensors in the sorted
    (node, field) state order.  Gradients flow to every leaf of ``params``
    (tree components, diode physics, MLP weights), to ``vin`` and to
    ``z0_leaves``.  Semantics match ``circuit.process`` with hoisted
    adaptation.

    row_fields: (node, field) pairs naming per-row or per-sample impedance
    controls, the reference's measured-pot training semantics
    (``clipper_pot.py:113-124``): one tensor each in ``row_vals``, (B,) for
    one value per row, (B, T) for one per sample; they get zero cotangents.
    """
    if len(circuit.outputs) != 1:
        raise ValueError("parallel-BPTT engine assumes one scalar output probe")
    neural = isinstance(circuit.root, NeuralDiodeRoot)
    root_name = circuit.root.name
    order = state_order(circuit)
    S = len(order)

    def row_controls(row_vals):
        rc: Dict[str, Dict[str, Any]] = {}
        for (node, field), val in zip(row_fields, row_vals):
            rc.setdefault(node, {})[field] = val
        return rc

    def forward_kernel(params, vin, z0_leaves, row_vals, want_seq):
        state0: Dict[str, Dict[str, Any]] = {}
        for (node, field), z in zip(order, z0_leaves):
            state0.setdefault(node, {})[field] = z
        kw = dict(input_node=input_node, static_controls=static_controls,
                  row_controls=row_controls(row_vals) or None, return_state_seq=want_seq)
        if neural:
            tree_params = {k: v for k, v in params.items() if k != root_name}
            res = fused_circuit_process_neural(circuit, tree_params, params[root_name], vin,
                                               state0, **kw)
        else:
            res = fused_circuit_process(circuit, params, vin, state0, **kw)
        zf = [res[1][node][field] for node, field in order]
        return res[0], zf, (res[2] if want_seq else None)

    class _FusedGeneric(torch.autograd.Function):
        @staticmethod
        def forward(ctx, rebuild, want_seq, vin, n_row, *rest):
            z0, row_vals, leaves = rest[:S], rest[S:S + n_row], rest[S + n_row:]
            params = rebuild(list(leaves))
            out, zf, seqs = forward_kernel(params, vin, z0, row_vals, want_seq)
            if want_seq:
                ctx.save_for_backward(vin, *seqs, *row_vals, *leaves)
                ctx.rebuild, ctx.n_row = rebuild, n_row
            return (out, *zf)

        @staticmethod
        @span("wdf.bptt")
        def backward(ctx, g_out, *g_zf):
            vin, *rest = ctx.saved_tensors
            n_row = ctx.n_row
            seqs, row_vals, leaves = rest[:S], rest[S:S + n_row], rest[S + n_row:]
            params = ctx.rebuild(list(leaves))
            B = vin.shape[0]
            g_out = torch.zeros_like(vin) if g_out is None else g_out.contiguous()
            lam_T = [torch.zeros(B, dtype=vin.dtype, device=vin.device) if g is None
                     else g.contiguous() for g in g_zf]
            if neural:
                k_params = {k: v for k, v in params.items() if k != root_name}
                mlp = params[root_name]
            else:
                k_params, mlp = params, None
            lam_step, g_vin, g_z0, root = fused_backward(
                circuit, k_params, vin, g_out, list(seqs), lam_T, input_node=input_node,
                static_controls=static_controls, row_controls=row_controls(row_vals) or None,
                neural_mlp=mlp)
            g_params = parameter_cotangents(
                circuit, params, vin, seqs, g_out, lam_step, input_node=input_node,
                static_controls=static_controls, row_controls=row_controls(row_vals), root=root,
                needs=list(ctx.needs_input_grad[4 + S + n_row:]))
            return (None, None, g_vin, None, *g_z0, *(torch.zeros_like(r) for r in row_vals),
                    *g_params)

    def apply(params, vin, z0_leaves, row_vals):
        if len(z0_leaves) != S:
            raise ValueError(f"expected {S} initial state leaves {order}, got {len(z0_leaves)}")
        leaves, rebuild = _flatten(params)
        # the trajectory is kept only where a backward can follow
        want_seq = torch.is_grad_enabled() and any(
            isinstance(x, torch.Tensor) and x.requires_grad for x in [vin, *z0_leaves, *leaves])
        outs = _FusedGeneric.apply(rebuild, want_seq, vin, len(row_vals), *z0_leaves, *row_vals,
                                   *leaves)
        return outs[0], list(outs[1:])

    if row_fields:

        def f(params, vin, z0_leaves, row_vals):
            if len(row_vals) != len(row_fields):
                raise ValueError(f"expected {len(row_fields)} row_vals for {row_fields}")
            return apply(params, vin, z0_leaves, tuple(row_vals))

    else:

        def f(params, vin, z0_leaves):
            return apply(params, vin, z0_leaves, ())

    return f
