"""Circuit-in-the-loop training: gradients through the WDF sample recursion.

The flagship workload (reference ``clipper_pot.py``): a neural diode root is
fine-tuned *inside* the clipper circuit on measured (or synthesized) data,
with the source voltage AND source resistance driven per sample (the pot).

Reference parity: sequence chunks of 2048 samples treated as a batch
(``clipper_pot.py:58-80``), loss = MSE + ESR over samples [50:] (state
warm-up skip, ``:232``), Adam lr 1e-4 beta1 0.5 (``:180``), optional
pre-emphasis.  Three engines:

- ``"scan"``: autograd through ``Circuit.process`` (a Python loop over
  time, the chunks as a trailing batch axis) — any circuit, per-chunk or
  per-sample pot data; the sequential BPTT oracle;
- ``"fused"``: the differentiable fused clipper (``ops.clipper_train``),
  whose forward and adjoint are CUDA kernels on a card — the LPF clipper
  with an all-tanh NxH root and one hoisted R per chunk;
- ``"fused_generic"``: the generic differentiable fused engine
  (``ops.parallel_bptt``), whose forward and adjoint are CUDA kernels
  generated per circuit — any circuit and root the generator takes (the
  Tube Screamer, the HPF and LPF clippers), cotangents for every parameter,
  per-row ("r0") or per-sample ("r") pot data on ``pot_node.pot_field``.

The optimizer is ``torch.optim.Adam`` over the parameter leaves that
``trainable_filter`` selects; every other leaf stays fixed, exactly as a
zeroed gradient leaves a leaf unchanged under ``optax.adam``.

Also here: the joint physics+neural fit (``joint_fit_clipper``) and the
simple-circuit component fitting of the reference's sanity workloads
(``fit_components``, ``voltage_divider.py`` / ``lpf.py``), with one Adam
parameter group per fitted component standing in for the JAX package's
``optax.multi_transform``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..core.circuit import Circuit
from ..core.elements import Device
from ..runtime.profiler import span
from .losses import esr, mse, pre_emphasis


@dataclasses.dataclass
class CircuitTrainConfig:
    epochs: int = 501
    batch_size: int = 2048  # samples per sequence chunk
    learning_rate: float = 1e-4
    beta1: float = 0.5
    skip_samples: int = 50
    use_pre_emphasis: bool = False
    log_every: int = 5
    max_chunks: Optional[int] = None  # cap sequences per split (for tests)
    engine: str = "scan"  # "scan" (general BPTT) | "fused" (CUDA forward +
    # adjoint, ops.clipper_train; LPF clipper + neural root + hoisted
    # per-chunk R only) | "fused_generic" (generated CUDA forward + adjoint,
    # ops.parallel_bptt: any circuit and root, every parameter's cotangent,
    # per-row or per-sample pot data)
    pot_node: str = ""  # node the "r"/"r0" streams drive ("" = "Vs"; "R6"
    # for a Tube Screamer drive-pot sweep)
    pot_field: str = "R"  # the field they drive (fused_generic: any)


def make_clipper_batches(data: Dict[str, np.ndarray], batch_size: int, max_chunks=None,
                         drop_mixed_r: bool = False, *, device: Device):
    """{"x","r","y"} streams -> [n_seq, T] tensors on ``device`` (reference
    ``batch_data``).

    R-hoisting: the pot resistance is piecewise-constant per measurement file
    (``dataimport.py:109`` parses one R per CSV), so almost every chunk has a
    single R value.  When that holds for ALL chunks, the "r" stream collapses
    to a per-chunk scalar "r0" [n_seq] and impedance adaptation runs ONCE per
    chunk outside the time loop instead of per sample inside it — identical
    math, far less per-step work.  Chunks with a genuinely time-varying R
    keep the per-sample "r" stream — unless ``drop_mixed_r`` (the
    fused-engine path): chunks straddling a file boundary (mixed R) are then
    discarded (at most one per file) so every surviving chunk hoists.
    """
    n = len(data["x"]) // batch_size
    if max_chunks is not None:
        n = min(n, max_chunks)
    out = {k: np.asarray(v)[: n * batch_size].reshape(n, batch_size) for k, v in data.items()}
    if "r" in out and n > 0:
        r_np = out["r"]
        const = np.all(r_np == r_np[:, :1], axis=1)
        if const.all():
            out["r0"] = r_np[:, 0]
            del out["r"]
        elif drop_mixed_r:
            keep = np.nonzero(const)[0]
            out = {k: v[keep] for k, v in out.items()}
            out["r0"] = r_np[keep, 0]
            del out["r"]
    return {k: torch.as_tensor(np.ascontiguousarray(v), device=device) for k, v in out.items()}


def clipper_forward(circuit: Circuit, params, batches, pot_node: str = "Vs"):
    """Run the training clipper over a [n_seq, T] batch of (v[, R]) drives.

    State resets at chunk boundaries (reference behavior: ``Vs.reset();
    C.reset()`` per forward, ``clipper_pot.py:110-111``).  With an "r"
    stream the source resistance is driven per sample and the tree
    re-adapts inside the loop (the reference pot, ``clipper_pot.py:114-117``);
    with a hoisted "r0" (n_seq,) it adapts once, per chunk; without either
    (e.g. the fixed-R HPF topology) adaptation happens once.  The drive node
    is "Vin" where the circuit has one, else "Vs"; the r/r0 streams target
    ``pot_node``.  Returns outputs [n_seq, T].
    """
    device = batches["x"].device
    node = "Vin" if "Vin" in circuit.init_params("cpu") else "Vs"
    inputs = {node: {"v": batches["x"].T}}  # rows as a trailing batch axis
    static = None
    if "r" in batches:
        inputs.setdefault(pot_node, {})["R"] = batches["r"].T
    elif "r0" in batches:
        static = {pot_node: {"R": batches["r0"]}}
    out, _ = circuit.process(params, circuit.init_state(device), inputs,
                             static_controls=static, adapt_per_sample="r" in batches)
    return out.T


def _make_fused_forward(circuit: Circuit):
    """Forward via the differentiable fused clipper (ops.clipper_train).

    Requirements: LPF clipper topology (Parallel(Vs, C)), an all-tanh NxH
    neural root, and per-chunk-constant R ("r0" batches — the measured-data
    regime).  The capacitor value is held fixed (it is frozen in this
    workload, as in the reference's circuit training); every chunk starts
    from z0 = 0.
    """
    from ..ops.clipper_train import make_fused_clipper_train

    root = circuit.root
    acts = tuple(getattr(root, "activations", ()))
    init_p = circuit.init_params("cpu")
    if "C" not in init_p or "Vs" not in init_p:
        raise ValueError("fused engine needs the LPF clipper topology (Vs || C)")
    default_r = float(init_p["Vs"]["R"])
    fused = make_fused_clipper_train(acts, float(init_p["C"]["C"]), circuit.fs)

    def forward(params, batches):
        if "r" in batches:
            raise ValueError(
                "the clipper-specialized fused engine requires per-chunk-constant R "
                "(hoisted 'r0'); batch with drop_mixed_r=True or use engine='scan'")
        v = batches["x"]
        B = v.shape[0]
        r0 = batches.get("r0")
        if r0 is None:
            r0 = torch.full((B,), default_r, dtype=torch.float32, device=v.device)
        out, _ = fused(v, torch.zeros(B, dtype=torch.float32, device=v.device),
                       params[root.name], r0)
        return out

    return forward


def _make_fused_generic_forward(circuit: Circuit, cfg: CircuitTrainConfig):
    """Forward via the generic differentiable fused engine
    (ops.parallel_bptt): any circuit topology and root family the generator
    takes, exact cotangents for every param.  Pot data, hoisted per row
    ("r0", (B,): the reference's measured-data regime, one R per CSV chunk)
    or per sample ("r", (B, T)), streams through both kernels as per-row or
    per-sample coefficients of ``cfg.pot_node``'s ``cfg.pot_field`` (default
    "Vs".R).  Every chunk starts from the circuit's initial state.  Any
    number of rows: the kernels take any B."""
    from ..ops.circuit_codegen import state_order
    from ..ops.parallel_bptt import make_fused_circuit_train_generic

    input_node = "Vin" if "Vin" in circuit.init_params("cpu") else "Vs"
    f_plain = make_fused_circuit_train_generic(circuit, input_node=input_node)
    f_row = make_fused_circuit_train_generic(
        circuit, input_node=input_node, row_fields=((cfg.pot_node or "Vs", cfg.pot_field),))
    order = state_order(circuit)

    def forward(params, batches):
        v = batches["x"]
        B = v.shape[0]
        state = circuit.init_state(v.device)
        z0 = [state[node][field].to(torch.float32).expand(B).contiguous()
              for node, field in order]
        r = batches.get("r", batches.get("r0"))
        if r is not None:
            out, _ = f_row(params, v, z0, (r.to(torch.float32),))
        else:
            out, _ = f_plain(params, v, z0)
        return out

    return forward


def make_forward_fn(circuit: Circuit, cfg: CircuitTrainConfig):
    """The engine-selected training forward: (params, batches) -> outs.
    The scan and fused engines drive the field R of ``cfg.pot_node`` (the
    fused one only that of the source "Vs"); fused_generic drives any
    field."""
    if cfg.engine not in ("scan", "fused", "fused_generic"):
        raise ValueError(f"unknown engine {cfg.engine!r}: 'scan', 'fused' or 'fused_generic'")
    if cfg.engine == "fused_generic":
        return _make_fused_generic_forward(circuit, cfg)
    if cfg.pot_field != "R":
        raise NotImplementedError(
            f"pot_field={cfg.pot_field!r}: only engine='fused_generic' drives a field "
            "other than R")
    if cfg.engine == "fused":
        if (cfg.pot_node or "Vs") != "Vs":
            raise ValueError(f"engine='fused' drives the source 'Vs', not pot_node="
                             f"{cfg.pot_node!r}; use engine='scan'")
        return _make_fused_forward(circuit)
    return lambda params, batches: clipper_forward(circuit, params, batches,
                                                   pot_node=cfg.pot_node or "Vs")


def make_loss_fn(circuit: Circuit, cfg: CircuitTrainConfig):
    """Build the training loss (params, batches) -> (loss, {"mse","esr"})."""
    emphasis = (lambda t: pre_emphasis(t, axis=1)) if cfg.use_pre_emphasis else None
    forward = make_forward_fn(circuit, cfg)

    def loss_fn(params, batches):
        outs = forward(params, batches)
        o = outs[:, cfg.skip_samples:]
        t = batches["y"][:, cfg.skip_samples:]
        if emphasis is not None:
            o, t = emphasis(o), emphasis(t)
        m = mse(t, o)
        e = esr(t, o)
        return m + e, {"mse": m, "esr": e}

    return loss_fn


def _leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def make_adam(params, cfg: CircuitTrainConfig, trainable_filter: Optional[Callable] = None):
    """``torch.optim.Adam(lr, betas=(beta1, 0.999), eps=1e-8)`` over the
    leaves of ``trainable_filter(params)`` (default: every leaf), which it
    marks as requiring grad: the optimizer of every circuit training step."""
    trainable = _leaves(params if trainable_filter is None else trainable_filter(params))
    for x in trainable:
        x.requires_grad_(True)
    return torch.optim.Adam(trainable, lr=cfg.learning_rate, betas=(cfg.beta1, 0.999), eps=1e-8)


def make_train_step(
    circuit: Circuit,
    cfg: CircuitTrainConfig,
    trainable_filter: Optional[Callable] = None,
):
    """Build the training step.  Returns (make_optimizer, train_step,
    eval_step):

    - ``make_optimizer(params)``: :func:`make_adam` over the leaves of
      ``trainable_filter(params)`` (a subtree, e.g. ``lambda p: p["dp"]``;
      default: every leaf);
    - ``train_step(params, opt, batches) -> metrics``: one gradient step,
      updating the trainable leaves in place;
    - ``eval_step(params, batches) -> metrics``, without gradients.

    Metrics are 0-d tensors {"loss", "mse", "esr"} of the params the step
    started from.  While a profiler records, a step is a ``wdf.train_step``
    span (``runtime.profiler``) holding ``wdf.loss``, ``wdf.backward`` and
    ``wdf.adam``.
    """
    loss_fn = make_loss_fn(circuit, cfg)

    def make_optimizer(params):
        return make_adam(params, cfg, trainable_filter)

    @span("wdf.train_step")
    def train_step(params, opt, batches):
        opt.zero_grad(set_to_none=True)
        with span("wdf.loss"):
            loss, aux = loss_fn(params, batches)
        with span("wdf.backward"):
            loss.backward()
        with span("wdf.adam"):
            opt.step()
        return {"loss": loss.detach(), **{k: v.detach() for k, v in aux.items()}}

    @torch.no_grad()
    def eval_step(params, batches):
        loss, aux = loss_fn(params, batches)
        return {"loss": loss, **aux}

    return make_optimizer, train_step, eval_step


def train_clipper(
    circuit: Circuit,
    params,
    train_batches,
    val_batches=None,
    cfg: CircuitTrainConfig = CircuitTrainConfig(),
    trainable_filter: Optional[Callable] = None,
    on_epoch: Optional[Callable] = None,
):
    """Full training loop.  Returns (params, history) with the reference's
    history keys (loss/mse/esr + val_ variants, ``clipper_pot.py:233-240``).
    The given params are not modified: training runs on a copy, returned
    detached."""
    make_optimizer, train_step, eval_step = make_train_step(circuit, cfg, trainable_filter)
    params = _map(lambda x: x.detach().clone(), params)
    opt = make_optimizer(params)
    history = {k: [] for k in ("loss", "mse", "esr", "val_loss", "val_mse", "val_esr")}
    for epoch in range(cfg.epochs):
        m = train_step(params, opt, train_batches)
        for k in ("loss", "mse", "esr"):
            history[k].append(float(m[k]))
        if val_batches is not None:
            vm = eval_step(params, val_batches)
            for k in ("loss", "mse", "esr"):
                history["val_" + k].append(float(vm[k]))
        if on_epoch is not None and cfg.log_every and epoch % cfg.log_every == 0:
            on_epoch(epoch, params, history)
    return _map(lambda x: x.detach(), params), history


def _constrain_(circuit: Circuit, params) -> None:
    """``circuit.constrain`` in place: clip each bounded leaf to its element
    bounds, so the optimizer keeps updating the same tensors."""
    with torch.no_grad():
        for name, fields in circuit.param_constraints().items():
            for field, (lo, hi) in fields.items():
                params[name][field].clamp_(lo, hi)


def _component(params, key: str) -> torch.Tensor:
    node, field = key.split(".", 1)
    return params[node][field]


def joint_fit_clipper(
    circuit: Circuit,
    params,
    train_batches,
    component_lrs: Dict[str, float],
    cfg: CircuitTrainConfig = CircuitTrainConfig(),
    mlp_lr: Optional[float] = None,
):
    """Joint physics+neural training: learn component values (R/C, clipped
    to their element bounds) AND the root's weights in-circuit,
    simultaneously.

    The reference has two disjoint workloads — neural-root training with
    frozen components (``clipper_pot.py:245-269``) and component fitting with
    an analytic root (``lpf.py:79-99``) — but never combines them; fully
    differentiable physics makes the combination one optimizer here.
    ``component_lrs`` maps "Node.field" (e.g. "Vs.R", "C.C") to per-parameter
    Adam learning rates (the reference's separate-optimizers trick, one Adam
    parameter group each); the root's subtree trains at ``mlp_lr`` (default
    cfg.learning_rate); every other leaf is frozen and gets no step.
    ``cfg.engine`` "fused_generic" runs the generic fused engine, "scan" the
    scan engine.  The given params are not modified.

    Returns (params, history) where history carries loss/mse/esr plus the
    per-epoch trajectory of every fitted component value.
    """
    if cfg.engine not in ("scan", "fused_generic"):
        raise ValueError(f"joint_fit_clipper runs engine 'scan' or 'fused_generic', "
                         f"not {cfg.engine!r}")
    mlp_lr = cfg.learning_rate if mlp_lr is None else mlp_lr
    params = _map(lambda x: x.detach().clone(), params)
    groups = [{"params": [_component(params, k)], "lr": lr} for k, lr in component_lrs.items()]
    if circuit.root.name in params:
        groups.append({"params": _leaves(params[circuit.root.name]), "lr": mlp_lr})
    for group in groups:
        for x in group["params"]:
            x.requires_grad_(True)
    opt = torch.optim.Adam(groups, betas=(cfg.beta1, 0.999), eps=1e-8)

    emphasis = (lambda t: pre_emphasis(t, axis=1)) if cfg.use_pre_emphasis else None
    forward = (_make_fused_generic_forward(circuit, cfg) if cfg.engine == "fused_generic"
               else lambda p, b: clipper_forward(circuit, p, b))

    history = {"loss": [], "mse": [], "esr": []}
    history.update({k: [] for k in component_lrs})
    for _ in range(cfg.epochs):
        opt.zero_grad(set_to_none=True)
        outs = forward(params, train_batches)
        o = outs[:, cfg.skip_samples:]
        t = train_batches["y"][:, cfg.skip_samples:]
        if emphasis is not None:
            o, t = emphasis(o), emphasis(t)
        m, e = mse(t, o), esr(t, o)
        (m + e).backward()
        opt.step()
        _constrain_(circuit, params)  # element bounds (R in [180, 1e6] etc.)
        for k, v in (("loss", m + e), ("mse", m), ("esr", e)):
            history[k].append(float(v.detach()))
        for k in component_lrs:
            history[k].append(float(_component(params, k).detach()))
    return _map(lambda x: x.detach(), params), history


# ---------------------------------------------------------------------------
# Simple-circuit component fitting (the reference's sanity workloads)
# ---------------------------------------------------------------------------


def fit_components(
    circuit: Circuit,
    params,
    inputs,
    target,
    lr_by_param: Dict[str, float],
    epochs: int = 100,
    constrain: bool = True,
):
    """Learn component values (R/C) against a target waveform with separate
    per-parameter learning rates — e.g. {"R1.R": 25.0, "C1.C": 1e-8}
    (reference ``lpf.py:79-99``), one Adam (betas 0.9, 0.999) parameter
    group each.  Parameters not listed are frozen.  The loss is the MSE of
    ``circuit.process`` from the circuit's initial state on ``inputs`` (the
    scan engine).  The given params are not modified.

    Returns (params, history dict of per-epoch loss, taken before each
    step, and the param trees after it, as floats).
    """
    params = _map(lambda x: x.detach().clone(), params)
    groups = [{"params": [_component(params, k)], "lr": lr} for k, lr in lr_by_param.items()]
    for group in groups:
        group["params"][0].requires_grad_(True)
    opt = torch.optim.Adam(groups, betas=(0.9, 0.999), eps=1e-8)
    state0 = circuit.init_state(target.device)
    history = {"loss": [], "params": []}
    for _ in range(epochs):
        opt.zero_grad(set_to_none=True)
        out, _ = circuit.process(params, state0, inputs)
        loss = mse(target, out)
        loss.backward()
        opt.step()
        if constrain:
            _constrain_(circuit, params)
        history["loss"].append(float(loss.detach()))
        history["params"].append(_map(lambda x: float(x.detach()), params))
    return _map(lambda x: x.detach(), params), history
