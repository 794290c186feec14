"""Data-parallel training over the mesh "data" axis.

Each rank holds a replica of the params and its contiguous block of the
[n_seq, T] sequence batch.  One scheme serves every engine ("scan",
"fused": the clipper's training kernels B3 and B4, "fused_generic": B7's
training form and B8), each rank running the engine's forward on its own
rows:

- the local masked sums se_l = sum((o - t)^2), te_l = sum(t^2) and the
  count n_l come from ``make_forward_fn`` on the local rows (skip and
  pre-emphasis as the single-process loss applies them);
- ``se_l.backward()`` gives the local gradient of se;
- one all-reduce (SUM) takes [se, te, n], one takes the flat gradient
  buffer;
- the global loss L = se/n + sqrt(se/(te + eps)/n) is assembled from the
  sums, and the gradient scaled by dL/dse = 1/n + e/(2 se) (te is
  target-only and n constant, so se is the only parameter-dependent term:
  exact, not an approximation); then the optimizer steps.

Every collective sits outside autograd.  An all-reduce recorded in the graph
(``torch.distributed.nn``) all-reduces again in its backward, a D-fold
double count (the JAX package measured exactly 8x on its 8-device mesh);
DDP averages gradients, and the ESR term is no mean of per-rank losses.
Replicas start from the first rank's params (``replicate_params``) and
receive the same reduced gradient, so they stay bit-identical.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
from torch.distributed.device_mesh import DeviceMesh

from ..core.circuit import Circuit
from ..core.elements import Device
from ..training.circuit_train import (CircuitTrainConfig, _leaves, _map, make_adam,
                                      make_forward_fn)
from ..training.losses import dloss_dse, global_loss_from_sums, pre_emphasis
from .mesh import all_reduce_, replicate_params, shard_batches


def reduce_grads_(leaves, coef: torch.Tensor, mesh: DeviceMesh, axes) -> None:
    """Each leaf's ``.grad`` summed over ``axes`` of the mesh in one flat
    buffer (a leaf with no gradient counts zeros), then scaled by ``coef``,
    in place."""
    grads = [x.grad if x.grad is not None else torch.zeros_like(x) for x in leaves]
    flat = torch.cat([g.reshape(-1) for g in grads])
    all_reduce_(flat, mesh, axes)
    flat.mul_(coef)
    offset = 0
    for x in leaves:
        x.grad = flat[offset:offset + x.numel()].view_as(x).clone()
        offset += x.numel()


def assemble_loss(se_l, te_l, n_l, mesh: DeviceMesh, axes):
    """The global (loss, {"mse", "esr"}, dL/dse) from local sums, with one
    all-reduce of [se, te, n] over ``axes``."""
    # n from the host by a fill, not a copy: a copy would wait for the step so far
    sums = torch.stack([se_l.detach().reshape(()), te_l.detach().reshape(()),
                        se_l.new_full((), float(n_l))])
    all_reduce_(sums, mesh, axes)
    se, te, n = sums[0], sums[1], sums[2]
    m, e = global_loss_from_sums(se, te, n)
    return m + e, {"mse": m, "esr": e}, dloss_dse(se, e, n)


def sums_train_step(local_sums: Callable, cfg: CircuitTrainConfig, mesh: DeviceMesh,
                    trainable_filter: Optional[Callable] = None):
    """The optimizer, step and evaluation around ``local_sums(params, *data)
    -> (se_l, te_l, n_l, axes)``, the local masked sums and the mesh axes
    they are summed over.  Returns (make_optimizer, train_step, eval_step):
    ``train_step(params, opt, *data) -> metrics`` (the trainable leaves
    updated in place; ``train_step.grads_fn(params, *data) -> (loss, aux,
    grads)`` the reduced gradient, a tree like ``trainable_filter(params)``,
    without stepping) and ``eval_step(params, *data) -> metrics``, with no
    gradient.  Metrics are 0-d tensors {"loss", "mse", "esr"} of the global
    loss."""

    def trainable(params):
        return params if trainable_filter is None else trainable_filter(params)

    def make_optimizer(params):
        return make_adam(params, cfg, trainable_filter)

    def backward(params, data, leaves):
        """The reduced gradient of the global loss into each leaf's .grad;
        returns (loss, aux)."""
        for x in leaves:
            x.grad = None
        se_l, te_l, n_l, axes = local_sums(params, *data)
        se_l.backward()
        loss, aux, coef = assemble_loss(se_l, te_l, n_l, mesh, axes)
        reduce_grads_(leaves, coef, mesh, axes)
        return loss, aux

    def train_step(params, opt, *data):
        loss, aux = backward(params, data, [x for g in opt.param_groups for x in g["params"]])
        opt.step()
        return {"loss": loss, **aux}

    def grads_fn(params, *data):
        tree = trainable(params)
        leaves = _leaves(tree)
        for x in leaves:
            x.requires_grad_(True)
        loss, aux = backward(params, data, leaves)
        grads = iter([x.grad for x in leaves])
        for x in leaves:
            x.grad = None
        return loss, aux, _map(lambda _: next(grads), tree)

    train_step.grads_fn = grads_fn

    @torch.no_grad()
    def eval_step(params, *data):
        se_l, te_l, n_l, axes = local_sums(params, *data)
        loss, aux, _ = assemble_loss(se_l, te_l, n_l, mesh, axes)
        return {"loss": loss, **aux}

    return make_optimizer, train_step, eval_step


def make_dp_train_step(circuit: Circuit, cfg: CircuitTrainConfig, mesh: DeviceMesh,
                       trainable_filter: Optional[Callable] = None, *,
                       device: Device = "cuda"):
    """Data-parallel version of ``training.circuit_train.make_train_step``.
    Returns (make_optimizer, dp_train, dp_eval, prepare):

    - ``prepare(params, batches) -> (params, batches)``: the first rank's
      params on every rank's device, and this rank's block of the batch rows
      (``shard_batches``);
    - ``make_optimizer(params)``: ``training.circuit_train.make_adam`` over
      the leaves of ``trainable_filter(params)`` (default: every leaf), as
      ``make_train_step``'s;
    - ``dp_train(params, opt, batches) -> metrics``: one step on the local
      block, the trainable leaves updated in place (the same bits on every
      rank); ``dp_train.grads_fn(params, batches) -> (loss, aux, grads)``
      gives the reduced gradient without stepping;
    - ``dp_eval(params, batches) -> metrics`` without gradients.

    Metrics are 0-d tensors {"loss", "mse", "esr"} of the global loss."""
    forward = make_forward_fn(circuit, cfg)

    def local_sums(params, batches):
        outs = forward(params, batches)
        o = outs[:, cfg.skip_samples:]
        t = batches["y"][:, cfg.skip_samples:]
        if cfg.use_pre_emphasis:
            o, t = pre_emphasis(o, axis=1), pre_emphasis(t, axis=1)
        return (torch.sum(torch.square(o - t)), torch.sum(torch.square(t)), float(t.numel()),
                ("data",))

    make_optimizer, dp_train, dp_eval = sums_train_step(local_sums, cfg, mesh, trainable_filter)

    def prepare(params, batches):
        return (replicate_params(params, mesh, device=device),
                shard_batches(batches, mesh, device=device))

    return make_optimizer, dp_train, dp_eval, prepare


def train_clipper_dp(circuit: Circuit, params, train_batches, mesh: DeviceMesh,
                     val_batches=None, cfg: CircuitTrainConfig = CircuitTrainConfig(),
                     trainable_filter: Optional[Callable] = None, *, device: Device = "cuda"):
    """Data-parallel twin of ``training.circuit_train.train_clipper``: the
    global batches on every rank, each rank training on its block.  Returns
    (params, history) with its history keys (loss/mse/esr and val_), the
    same on every rank; the given params are not modified."""
    make_optimizer, dp_train, dp_eval, prepare = make_dp_train_step(
        circuit, cfg, mesh, trainable_filter, device=device)
    params, train_batches = prepare(params, train_batches)
    opt = make_optimizer(params)
    if val_batches is not None:
        val_batches = shard_batches(val_batches, mesh, device=device)
    history = {k: [] for k in ("loss", "mse", "esr", "val_loss", "val_mse", "val_esr")}
    for _ in range(cfg.epochs):
        m = dp_train(params, opt, train_batches)
        for k in ("loss", "mse", "esr"):
            history[k].append(float(m[k]))
        if val_batches is not None:
            vm = dp_eval(params, val_batches)
            for k in ("loss", "mse", "esr"):
                history["val_" + k].append(float(vm[k]))
    return _map(lambda x: x.detach(), params), history
