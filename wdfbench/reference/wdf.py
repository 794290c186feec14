"""The plain reference's runner: a circuit's wave step with a neural root,
run over (rows, samples) in PyTorch ops, and its training step.

A circuit module (``lpf_clipper``, ``tube_screamer``) gives the adapted
coefficients and the wave step.  Given its coefficients, the step is linear
in the states z, the input v and the root's reflected wave b, and the wave
the root sees is linear in (z, v): ``linear_maps`` probes the step with unit
vectors in float64 and keeps the two maps, so a sample costs two small
products around the root's MLP, b = -MLP([a, log R_up]).

The runner computes in the dtype it is given (float64 for the reference);
with ``tf32=True`` every matrix product rounds its operands to TF32 (10
mantissa bits, round to nearest, ties away) and accumulates in float32, in
the forward pass and in the backward pass: the lower precision the control
computes in.

It imports nothing of the system under test, and takes from it nothing but
outputs to judge.
"""

from __future__ import annotations

import json
import math
from typing import List, Tuple

import numpy as np
import torch

F32_EPS = float(np.finfo(np.float32).eps)
_ACTS = {"tanh": torch.tanh, "": lambda x: x, "linear": lambda x: x}


def load_mlp_json(path) -> Tuple[List[Tuple[np.ndarray, np.ndarray]], Tuple[str, ...]]:
    """(layers [(kernel [in, out], bias [out])], activations) of a model file
    in the reference model-zoo schema, float64."""
    with open(path) as f:
        d = json.load(f)
    layers, acts = [], []
    for layer in d["layers"]:
        if layer.get("type") != "dense":
            continue
        kernel = np.asarray(layer["weights"][0], np.float64)
        bias = np.asarray(layer["weights"][1], np.float64)
        layers.append((kernel[0] if kernel.ndim == 3 else kernel,
                       bias[0] if bias.ndim == 2 else bias))
        acts.append(layer.get("activation", "") or "")
    return layers, tuple(acts)


def linear_maps(step, coef: dict, n_states: int, rows: int = 0):
    """(ca, M) of ``step`` at coefficients ``coef``: a = [z, v] @ ca, and
    [z', out] = [z, v, b] @ M.  With per-row coefficients (``rows`` > 0)
    ca is (rows, S + 1) and M (rows, S + 2, S + 1); else (S + 1,) and
    (S + 2, S + 1).  float64."""
    S = n_states
    shape = (rows,) if rows else ()

    def unit(i, n):
        return [np.full(shape, float(i == k)) for k in range(n)]

    ca = []
    for i in range(S + 1):
        u, seen = unit(i, S + 1), {}

        def record(a, seen=seen):
            seen["a"] = a
            return np.zeros(shape)
        step(coef, u[:S], u[S], record)
        ca.append(np.broadcast_to(seen["a"], shape))
    M = []
    for i in range(S + 2):
        u = unit(i, S + 2)
        z_new, out = step(coef, u[:S], u[S], lambda a, b=u[S + 1]: b)
        M.append(np.stack([np.broadcast_to(x, shape) for x in list(z_new) + [out]], -1))
    ca, M = np.stack(ca, -1), np.stack(M, -2)
    return ca, M


def _tf32(x: torch.Tensor) -> torch.Tensor:
    """x (float32) rounded to TF32: the low 13 mantissa bits rounded away,
    ties away from zero."""
    i = x.contiguous().view(torch.int32)
    return ((i + 0x1000) & -0x2000).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _tf32(a) @ _tf32(b)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _tf32(g)
        ga = g @ _tf32(b).transpose(-1, -2) if b.dim() > 1 else g[..., None] * _tf32(b)
        if b.dim() > 1:
            gb = _tf32(a).transpose(-1, -2) @ g
        else:
            gb = (_tf32(a) * g[..., None]).sum(0)
        return ga, gb


def matmul(a: torch.Tensor, b: torch.Tensor, tf32: bool) -> torch.Tensor:
    return _TF32MatMul.apply(a, b) if tf32 else a @ b


def affine(h: torch.Tensor, k: torch.Tensor, b: torch.Tensor, tf32: bool,
           sign: float = 1.0) -> torch.Tensor:
    """sign (h @ k + b), with TF32 products where ``tf32``."""
    if tf32:
        return sign * (_TF32MatMul.apply(h, k) + b)
    return torch.addmm(b, h, k, beta=sign, alpha=sign)


class Model:
    """A circuit's linear maps, the root's port resistance and its MLP, as
    tensors in one dtype on one device, ready to run over (rows, samples)."""

    def __init__(self, ca, M, r_up, layers, acts, *, dtype, device, tf32: bool = False):
        t = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)  # noqa: E731
        self.ca, self.M = t(ca), t(M)
        self.per_row = self.ca.dim() == 2
        self.log_r = t(np.log(np.asarray(r_up, np.float64)))
        self.layers = [(t(k), t(b)) for k, b in layers]
        self.acts, self.tf32 = tuple(acts), tf32
        self.n_states = self.M.shape[-1] - 1

    def weights(self) -> List[torch.Tensor]:
        return [x for layer in self.layers for x in layer]

    def root(self, a: torch.Tensor, log_r: torch.Tensor) -> torch.Tensor:
        """b = -MLP([a, log R_up]) over a batch a (rows,), as (rows, 1)."""
        if self.acts[-1] not in ("", "linear"):
            raise ValueError("the root's head must be linear")
        h = torch.stack([a, log_r.expand_as(a)], -1)
        for (k, b), act in zip(self.layers[:-1], self.acts[:-1]):
            h = _ACTS[act](affine(h, k, b, self.tf32))
        return affine(h, *self.layers[-1], self.tf32, sign=-1.0)

    def run(self, v: torch.Tensor, z0: torch.Tensor):
        """(out (R, T), z_final (R, S)) from states z0 (R, S) over inputs
        v (R, T)."""
        ca, M, log_r = self.ca, self.M, self.log_r
        z, outs = z0, []
        for t in range(v.shape[1]):
            x = torch.cat([z, v[:, t:t + 1]], 1)
            a = (x * ca).sum(1) if self.per_row else matmul(x, ca, self.tf32)
            xb = torch.cat([x, self.root(a, log_r)], 1)
            y = (torch.bmm(xb[:, None, :], M)[:, 0] if self.per_row
                 else matmul(xb, M, self.tf32))
            z = y[:, :-1]
            outs.append(y[:, -1])
        return torch.stack(outs, 1), z


def loss_of_sums(se, te, n: int):
    """mse + esr of the circuit-training loss from the sums se = sum((t - o)^2)
    and te = sum(t^2) over n samples: se / n + sqrt(se / (te + eps) / n)."""
    return se / n + torch.sqrt(se / (te + F32_EPS) / n)


def train_steps(model: Model, v, y, *, steps: int, skip: int, lr: float, betas, eps: float):
    """Follow ``steps`` full-batch Adam steps of the circuit-training loss on
    inputs v and targets y (rows, T) from the model's weights.  Returns
    (losses before each step, the gradient of each trainable leaf at the
    first step, the change of each leaf after the steps)."""
    leaves = model.weights()
    start = [x.detach().clone() for x in leaves]
    m = [torch.zeros_like(x) for x in leaves]
    s = [torch.zeros_like(x) for x in leaves]
    tgt = y[:, skip:]
    te = (tgt.to(torch.float64) ** 2).sum()
    n = tgt.numel()
    z0 = torch.zeros(v.shape[0], model.n_states, dtype=v.dtype, device=v.device)
    losses, first_grad = [], None
    for k in range(1, steps + 1):
        for x in leaves:
            x.requires_grad_(True)
            x.grad = None
        out, _ = model.run(v, z0)
        se = ((tgt - out[:, skip:]) ** 2).sum()
        se.backward()
        se = se.detach().to(torch.float64)
        loss = loss_of_sums(se, te, n)
        scale = 1.0 / n + 0.5 / torch.sqrt(se * (te + F32_EPS) * n)
        grads = [(x.grad * scale).detach() for x in leaves]
        losses.append(float(loss))
        if first_grad is None:
            first_grad = [g.clone() for g in grads]
        with torch.no_grad():
            for x, g, mk, sk in zip(leaves, grads, m, s):
                mk.mul_(betas[0]).add_((1 - betas[0]) * g)
                sk.mul_(betas[1]).add_((1 - betas[1]) * g * g)
                denom = (sk / (1 - betas[1] ** k)).sqrt() + eps
                x.sub_(lr * (mk / (1 - betas[0] ** k)) / denom)
    for x in leaves:
        x.requires_grad_(False)
    return losses, first_grad, [(x.detach() - x0) for x, x0 in zip(leaves, start)]


def norm(x: torch.Tensor) -> float:
    return math.sqrt(float((x.detach().to(torch.float64) ** 2).sum()))
