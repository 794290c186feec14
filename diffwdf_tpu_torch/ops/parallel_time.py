"""Parallel-in-time WDF solving (Newton / DEER over the trajectory), in
plain PyTorch ops: the oracle the DEER kernels (B5, B9) are held against.

The per-sample recursion z_t = f(z_{t-1}, u_t) is solved as one nonlinear
system over the whole trajectory: each sweep linearises f around the current
guess and solves the affine recurrence

    z_t = J_t z_{t-1} + c_t,   J_t = df/dz(z^_{t-1}, u_t),
                               c_t = f(z^_{t-1}, u_t) - J_t z^_{t-1}

exactly with a log-depth doubling scan over time.  The step is the circuit's
own ``Circuit.step``, evaluated at all T points (and every stream) as one
batch, since the tree broadcasts over leading axes; J_t comes from S
forward-mode passes (``torch.autograd.forward_ad``; the omega root carries
its implicit jvp).  The state is flattened in the sorted (node, field)
order.  This module carries no kernel, and shares no code with the kernels'
own plain versions, which is what makes it a second opinion on them.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import torch
import torch.autograd.forward_ad as fwAD
from torch.utils._pytree import tree_flatten, tree_unflatten

from ..core.circuit import Circuit
from ..core.elements import Device


def _prefix(J: torch.Tensor, c: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inclusive prefix compositions of the affine maps z -> J_t z + c_t
    along the time axis (J: (B, T, S, S), c: (B, T, S)), by Hillis-Steele
    doubling: P_t = A_t o ... o A_1."""
    B, T, S = c.shape
    eye = torch.eye(S, dtype=J.dtype, device=J.device).expand(B, 1, S, S)
    d = 1
    while d < T:
        Jp = torch.cat([eye.expand(B, d, S, S), J[:, :-d]], dim=1)
        cp = torch.cat([torch.zeros_like(c[:, :d]), c[:, :-d]], dim=1)
        c = (J @ cp[..., None])[..., 0] + c
        J = J @ Jp
        d *= 2
    return J, c


class _Problem:
    """A circuit's flattened step over a batch of streams: state (B, T, S)
    in sorted (node, field) order, controls {node: {field: (B, T)}}."""

    def __init__(self, circuit: Circuit, state0, device: Device):
        self.circuit = circuit
        self.order: List[Tuple[str, str]] = sorted(
            (node, f) for node, fields in state0.items() for f in fields)
        self.s0 = torch.stack([torch.as_tensor(state0[n][f], dtype=torch.float32, device=device)
                               .reshape(()) for n, f in self.order])

    def step(self, prev: torch.Tensor, controls, params, coeffs=None):
        """(F (B, T, S), probe output (B, T)) of one step at every point."""
        ckt = self.circuit
        if coeffs is None:
            coeffs = ckt.adapt(params, {})
        state = {}
        for k, (node, f) in enumerate(self.order):
            state.setdefault(node, {})[f] = prev[..., k]
        new, waves = ckt.step(params, coeffs, state, controls)
        F = torch.stack([torch.broadcast_to(torch.as_tensor(new[n][f]), prev.shape[:-1])
                         for n, f in self.order], dim=-1)
        return F, ckt.probe(waves)

    def f_and_jac(self, prev, controls, params, coeffs=None):
        """F and J[..., i, k] = dF_i/dz_k by S forward-mode passes."""
        S = prev.shape[-1]
        F, cols = None, []
        with fwAD.dual_level():
            for k in range(S):
                tangent = torch.zeros_like(prev)
                tangent[..., k] = 1.0
                out, _ = self.step(fwAD.make_dual(prev, tangent), controls, params, coeffs)
                primal, tan = fwAD.unpack_dual(out)
                if F is None:
                    F = primal.clone()
                cols.append(torch.zeros_like(primal) if tan is None else tan.clone())
        return F, torch.stack(cols, dim=-1)

    def prev(self, traj: torch.Tensor) -> torch.Tensor:
        """z_0 .. z_{T-1} of a trajectory z_1 .. z_T."""
        s0 = self.s0.expand(traj.shape[0], 1, -1)
        return torch.cat([s0, traj[:, :-1]], dim=1)

    def solve(self, controls, params, n_iters: int, damping: float, coeffs=None):
        """The trajectory (B, T, S) after n_iters Newton sweeps from zero."""
        B, T = next(iter(tree_flatten(controls)[0])).shape
        traj = torch.zeros((B, T, self.s0.shape[0]), dtype=self.s0.dtype, device=self.s0.device)
        for _ in range(n_iters):
            prev = self.prev(traj)
            F, J = self.f_and_jac(prev, controls, params, coeffs)
            c = F - (J @ prev[..., None])[..., 0]
            Jc, cc = _prefix(J, c)
            new = (Jc @ self.s0[:, None])[..., 0] + cc
            if damping != 1.0:
                # damped Newton: circuits with a marginal slow state mode
                # (the HPF clipper's series cap, |df/dz| -> 1) oscillate
                # undamped; damping=0.5 with 2-3x n_iters converges there
                new = traj + damping * (new - traj)
            traj = new
        return traj


def _on(tree, device: Device):
    """Every leaf of a nested dict as an f32 tensor on ``device`` (a tensor
    already there is kept, with its autograd history)."""
    leaves, spec = tree_flatten(tree)
    return tree_unflatten([torch.as_tensor(x, device=device) if isinstance(x, torch.Tensor)
                           else torch.as_tensor(x, dtype=torch.float32, device=device)
                           for x in leaves], spec)


def _batched(inputs) -> bool:
    dims = {torch.as_tensor(x).dim() for x in tree_flatten(inputs)[0]}
    if len(dims) != 1:
        raise ValueError(f"inputs mix leaf ranks {sorted(dims)}")
    return dims.pop() == 2


def _solve(circuit, params, inputs, n_iters, state0, damping, return_residual, device):
    """Outputs (B, T) and residuals (B,) of the batched inputs (B, T)."""
    inputs, params = _on(inputs, device), _on(params, device)
    prob = _Problem(circuit, state0 if state0 is not None else circuit.init_state(device), device)
    coeffs = circuit.adapt(params, {})
    traj = prob.solve(inputs, params, n_iters, damping, coeffs)
    prev = prob.prev(traj)
    F, outs = prob.step(prev, inputs, params, coeffs)
    resid = (F - traj).abs().amax(dim=(1, 2)) if return_residual else None
    return outs, resid


def parallel_time_process(circuit: Circuit, params, inputs: Dict[str, Dict[str, Any]], *,
                          n_iters: int = 12, state0=None, damping: float = 1.0,
                          return_residual: bool = False, device: Device = "cuda"):
    """Solve the full sample recursion by Newton-over-trajectory on ``device``.

    inputs: {node: {field: [T]}} (one stream; :func:`parallel_time_batched`
    for a batch).  Returns outputs [T] (and the final trajectory residual
    max|f(z_{t-1}) - z_t| if requested).  Matches ``circuit.process`` up to
    solver tolerance."""
    if _batched(inputs):
        raise ValueError("parallel_time_process takes one stream: inputs of shape (T,)")
    batched = {n: {f: torch.as_tensor(x)[None] for f, x in fields.items()}
               for n, fields in inputs.items()}
    outs, resid = _solve(circuit, params, batched, n_iters, state0, damping, return_residual,
                         device)
    return (outs[0], resid[0]) if return_residual else outs[0]


class _ImplicitSolve(torch.autograd.Function):
    """The converged trajectory as a function of the (params, inputs)
    leaves, with the implicit adjoint: at G_t = z_t - f(z_{t-1}, u_t, theta)
    = 0 the cotangents solve lam_t = gbar_t + J_{t+1}^T lam_{t+1} (a reversed
    affine recurrence, the same doubling scan on the reversed time axis),
    and the parameter and input cotangents are one VJP of
    sum_t lam_t . f(z*_{t-1}, u_t, theta) with the trajectory held fixed.

    The trajectory is solved before ``apply`` and passed in: forward-mode AD
    is off inside a Function's forward, so the Newton sweeps cannot run
    there."""

    @staticmethod
    def forward(ctx, prob: _Problem, spec, traj: torch.Tensor, *leaves):
        ctx.prob, ctx.spec = prob, spec
        ctx.save_for_backward(traj, *leaves)
        return traj.clone()

    @staticmethod
    def backward(ctx, gbar):
        traj, *leaves = ctx.saved_tensors
        prob = ctx.prob
        prev = prob.prev(traj)
        params, inputs = tree_unflatten([l.detach() for l in leaves], ctx.spec)
        with torch.no_grad():
            _, J = prob.f_and_jac(prev, inputs, params)
            Jt = J.transpose(-1, -2)
            A = torch.cat([Jt[:, 1:], torch.zeros_like(Jt[:, :1])], dim=1).flip(1)
            _, lam = _prefix(A, gbar.flip(1))
            lam = lam.flip(1)
        wanted = [i for i, l in enumerate(leaves) if ctx.needs_input_grad[3 + i]]
        grads: List[Any] = [None] * len(leaves)
        if wanted:
            with torch.enable_grad():
                lv = [l.detach().requires_grad_(i in wanted) for i, l in enumerate(leaves)]
                params, inputs = tree_unflatten(lv, ctx.spec)
                F, _ = prob.step(prev, inputs, params)
                got = torch.autograd.grad((F * lam).sum(), [lv[i] for i in wanted],
                                          allow_unused=True)
            for i, g in zip(wanted, got):
                grads[i] = g
        return (None, None, None, *grads)


def parallel_time_process_implicit(circuit: Circuit, params, inputs: Dict[str, Dict[str, Any]],
                                   *, n_iters: int = 12, state0=None, damping: float = 1.0,
                                   device: Device = "cuda"):
    """Like :func:`parallel_time_process`, but gradients use implicit
    differentiation at the converged trajectory: one adjoint pass through
    the linearised system instead of differentiating through the Newton
    sweeps.  Returns outputs [T]."""
    if _batched(inputs):
        raise ValueError("parallel_time_process_implicit takes one stream: inputs of shape (T,)")
    params = _on(params, device)
    inputs = {n: {f: x[None] for f, x in fields.items()}
              for n, fields in _on(inputs, device).items()}
    prob = _Problem(circuit, state0 if state0 is not None else circuit.init_state(device), device)
    leaves, spec = tree_flatten((params, inputs))
    with torch.no_grad():
        p0, u0 = tree_unflatten([l.detach() for l in leaves], spec)
        traj = prob.solve(u0, p0, n_iters, damping)
    traj = _ImplicitSolve.apply(prob, spec, traj, *leaves)
    _, outs = prob.step(prob.prev(traj), inputs, params)
    return outs[0]


def parallel_time_batched(circuit: Circuit, params, inputs_batched: Dict[str, Dict[str, Any]], *,
                          n_iters: int = 12, state0=None, damping: float = 1.0,
                          return_residual: bool = False, device: Device = "cuda"):
    """:func:`parallel_time_process` over a leading batch axis of the inputs
    ({node: {field: [B, T]}}), every stream solved in the same sweeps.
    ``state0`` (unbatched) seeds every stream; ``return_residual`` gives
    (outputs [B, T], residuals [B]), a per-stream convergence certificate."""
    if not _batched(inputs_batched):
        raise ValueError("parallel_time_batched takes inputs of shape (B, T)")
    outs, resid = _solve(circuit, params, inputs_batched, n_iters, state0, damping,
                         return_residual, device)
    return (outs, resid) if return_residual else outs
