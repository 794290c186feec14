"""Synthetic diode pretraining: an NxH MLP taught the closed-form diode pair.

Reference configuration: a grid of 20 R decades x 1000 a-points, an MLP of
the "NxH" family (orthogonal init), loss = MSE + ESR(N=1000), Adam lr 2e-5
(eps 1e-7), 2000 epochs of shuffled minibatches of 32.  The targets come
from the real-line Wright omega (``data.synthetic.pretraining_grid``).

On a card, one epoch's minibatch steps (gather, forward, MSE + ESR,
backward, Adam) are captured once in CUDA graphs and replayed every epoch:
a graph of ``GRAPH_STEPS`` steps (or the largest divisor of the epoch's
step count below it) replayed until the epoch is done, then a graph that
writes the epoch's full-set metrics into preallocated history buffers.  All
counters (step, position in the epoch, epoch) live on the card, so before
each epoch the host writes only the epoch's order into the index buffer;
the order comes from a ``torch.Generator`` per seed, on the host.

Every seed trains at once: each parameter carries a leading seed axis, all
of them views of one flat (S, P) buffer that the gradient and the Adam
moments share, so the step's matmuls are batched over the seeds and one
graph trains every seed.  A single seed is the case S = 1.  On the CPU (the
tests) the same steps run eagerly.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..core.elements import Device
from ..data.synthetic import pretraining_grid
from ..roots.diode import DiodeConfig
from ..roots.neural import MLPParams, mlp_apply, mlp_arch, mlp_init
from .losses import esr, mse

#: the most minibatch steps one captured graph holds
GRAPH_STEPS = 128
#: Adam's moment decays (optax and keras defaults)
B1, B2 = 0.9, 0.999


@dataclasses.dataclass
class PretrainConfig:
    n_layers: int = 2
    layer_size: int = 16
    epochs: int = 2000
    batch_size: int = 32
    learning_rate: float = 2e-5
    n_r: int = 20
    n_a: int = 1000
    a_span: float = 2.5
    seed: int = 0
    log_every: int = 0  # epochs between host-side metric reports (0 = end only)
    schedule: str = "const"  # "const" (reference parity) | "cosine" (warmup+decay)
    adam_eps: float = 1e-7  # keras default (the reference trains with keras Adam)
    epochs_per_call: int = 2000  # epochs queued on the device between two
    # host synchronisations
    matmul_precision: str = "default"  # "default" | "highest": full f32
    # matmuls (TF32 off; reduced-precision matmuls put a ~1e-6 floor under
    # the reachable MSE of these 2-in, 4..16-wide MLPs); "high": TF32 allowed


def _init_params(generator: torch.Generator, sizes: Sequence[int], device: Device) -> MLPParams:
    """One seed's initial weights (orthogonal kernels, zero biases)."""
    return mlp_init(generator, sizes, device)


def _epoch_order(generator: torch.Generator, n: int, n_batches: int,
                 batch_size: int) -> torch.Tensor:
    """One seed's minibatch order for one epoch: (n_batches, batch_size)
    indices of a permutation of the n points (the n % batch_size left over
    are dropped)."""
    perm = torch.randperm(n, generator=generator)
    return perm[: n_batches * batch_size].view(n_batches, batch_size)


def _lr_table(cfg: PretrainConfig, total_steps: int) -> np.ndarray:
    """The learning rate of every step: constant, or optax's
    ``warmup_cosine_decay_schedule(0, lr, int(0.02 total), total,
    end_value=lr 1e-2)``."""
    lr = cfg.learning_rate
    k = np.arange(total_steps, dtype=np.float64)
    if cfg.schedule == "const":
        return np.full(total_steps, lr, np.float32)
    if cfg.schedule != "cosine":
        raise ValueError(f"schedule must be 'const' or 'cosine', got {cfg.schedule!r}")
    warmup = int(0.02 * total_steps)
    alpha = 1e-2
    decay = total_steps - warmup
    warm = lr * (k / warmup if warmup > 0 else np.ones_like(k))
    c = np.minimum(k - warmup, decay)
    cos = lr * ((1.0 - alpha) * 0.5 * (1.0 + np.cos(np.pi * c / decay)) + alpha)
    return np.where(k < warmup, warm, cos).astype(np.float32)


@contextlib.contextmanager
def _matmul_precision(precision: str):
    """TF32 off for "default" and "highest", allowed for "high", for the
    duration of the call."""
    if precision not in ("default", "high", "highest"):
        raise ValueError(f"matmul_precision must be default, high or highest, got {precision!r}")
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "high"
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _graph_steps(n_batches: int) -> int:
    """The steps one captured graph holds: the largest divisor of the
    epoch's step count up to GRAPH_STEPS."""
    return max(d for d in range(1, min(n_batches, GRAPH_STEPS) + 1) if n_batches % d == 0)


class _Layout:
    """Where each layer's kernel and bias sit in a flat (S, P) buffer."""

    def __init__(self, sizes: Sequence[int]):
        self.shapes: List[Tuple[int, int]] = list(zip(sizes[:-1], sizes[1:]))

    def views(self, flat: torch.Tensor) -> MLPParams:
        """Kernels (S, in, out) and biases (S, 1, out) as views of flat."""
        S, layers, off = flat.shape[0], [], 0
        for i, o in self.shapes:
            kernel = flat[:, off: off + i * o].view(S, i, o)
            off += i * o
            bias = flat[:, off: off + o].view(S, 1, o)
            off += o
            layers.append({"kernel": kernel, "bias": bias})
        return {"layers": layers}

    def flatten(self, params: Sequence[MLPParams]) -> torch.Tensor:
        """One row per seed of the given unstacked params."""
        rows = [torch.cat([t.reshape(-1) for l in p["layers"] for t in (l["kernel"], l["bias"])])
                for p in params]
        return torch.stack(rows).float().contiguous()


class _Trainer:
    """The training state of S seeds on one device, and the step and
    epoch-end functions that a CUDA graph captures or the host runs."""

    def __init__(self, diode: DiodeConfig, cfg: PretrainConfig, seeds, device: Device):
        self.cfg = cfg
        self.device = device = torch.device(device)
        x_np, y_np = pretraining_grid(diode, n_r=cfg.n_r, n_a=cfg.n_a, a_span=cfg.a_span,
                                      device=device)
        self.x = torch.as_tensor(x_np, device=device)
        self.y = torch.as_tensor(y_np, device=device)[:, None]
        self.n = n = self.x.shape[0]
        self.n_batches = n // cfg.batch_size
        if self.n_batches == 0:
            raise ValueError(f"batch_size {cfg.batch_size} exceeds the {n} grid points")
        sizes, self.acts = mlp_arch(cfg.n_layers, cfg.layer_size)
        self.layout = _Layout(sizes)
        self.generators = [torch.Generator().manual_seed(int(s)) for s in seeds]
        S = len(self.generators)
        self.flat = self.layout.flatten(
            [_init_params(g, sizes, device) for g in self.generators]).requires_grad_(True)
        total = cfg.epochs * self.n_batches
        f32 = dict(dtype=torch.float32, device=device)
        i64 = dict(dtype=torch.long, device=device)
        self.lr = torch.as_tensor(_lr_table(cfg, max(total, 1)), device=device)
        self.m = torch.zeros_like(self.flat, requires_grad=False)
        self.v = torch.zeros_like(self.flat, requires_grad=False)
        self.count = torch.zeros((), **f32)   # Adam's step count
        self.step_i = torch.zeros(1, **i64)    # index into the lr table
        self.pos = torch.zeros(1, **i64)       # minibatch within the epoch
        self.epoch_i = torch.zeros(1, **i64)
        self.loss_acc = torch.zeros(S, **f32)
        self.order = torch.zeros((S, self.n_batches, cfg.batch_size), **i64)
        self.hist = torch.zeros((3, S, cfg.epochs), **f32)  # loss, mse, esr
        self.y_all = self.y.expand(S, n, 1)
        self.mse = torch.func.vmap(mse)
        self.esr = torch.func.vmap(functools.partial(esr, n_norm=cfg.n_a))

    def _mutable(self) -> List[torch.Tensor]:
        return [self.flat, self.m, self.v, self.count, self.step_i, self.pos, self.epoch_i,
                self.loss_acc, self.hist]

    def write_order(self) -> None:
        """The next epoch's order of every seed into the index buffer."""
        cfg = self.cfg
        order = torch.stack([_epoch_order(g, self.n, self.n_batches, cfg.batch_size)
                             for g in self.generators])
        self.order.copy_(order.to(torch.long))

    def step(self) -> None:
        """One minibatch step of every seed: gather, forward, loss,
        backward, Adam in optax's form (m = b1 m + (1-b1) g, v = b2 v +
        (1-b2) g^2, p -= lr m^ / (sqrt(v^) + eps), m^ and v^ bias-corrected
        by the device step count), the lr read from the device table.

        Adam is written out rather than taken from ``torch.optim.Adam``: a
        Python-float lr would be baked into the graph at capture, so the
        cosine schedule could not move inside it, and the update has to be
        optax's (eps added to sqrt(v^)) for the histories to match the JAX
        package's."""
        S, B = self.flat.shape[0], self.cfg.batch_size
        idx = self.order.index_select(1, self.pos).view(S, B)
        xb, yb = self.x[idx], self.y[idx]
        with torch.enable_grad():
            pred = mlp_apply(self.layout.views(self.flat), self.acts, xb)
            loss = self.mse(yb, pred) + self.esr(yb, pred)
            (g,) = torch.autograd.grad(loss.sum(), self.flat)
        with torch.no_grad():
            self.loss_acc += loss
            self.count += 1.0
            lr = self.lr.index_select(0, self.step_i)
            self.step_i += 1
            self.pos += 1
            self.m.mul_(B1).add_(g, alpha=1.0 - B1)
            self.v.mul_(B2).addcmul_(g, g, value=1.0 - B2)
            m_hat = self.m / (1.0 - torch.pow(B1, self.count))
            v_hat = self.v / (1.0 - torch.pow(B2, self.count))
            self.flat.sub_(lr * (m_hat / (torch.sqrt(v_hat) + self.cfg.adam_eps)))

    def epoch_end(self) -> None:
        """The epoch's mean minibatch loss and full-set MSE and ESR into the
        history at the device epoch index; the epoch counters reset."""
        with torch.no_grad():
            pred = mlp_apply(self.layout.views(self.flat), self.acts, self.x)
            m = torch.stack([self.loss_acc / self.n_batches, self.mse(self.y_all, pred),
                             self.esr(self.y_all, pred)])
            self.hist.index_copy_(2, self.epoch_i, m[:, :, None])
            self.epoch_i += 1
            self.loss_acc.zero_()
            self.pos.zero_()

    def _capture(self):
        """(steps graph, epoch-end graph, replays of the steps graph an
        epoch), after a warm-up on a side stream whose effects are undone."""
        chunk = _graph_steps(self.n_batches)
        saved = [t.detach().clone() for t in self._mutable()]
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            for _ in range(2):
                self.step()
            self.epoch_end()
        torch.cuda.current_stream(self.device).wait_stream(side)
        with torch.no_grad():
            for t, s in zip(self._mutable(), saved):
                t.copy_(s)
        torch.cuda.synchronize(self.device)
        steps, end = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        with torch.cuda.graph(steps):
            for _ in range(chunk):
                self.step()
        with torch.cuda.graph(end, pool=steps.pool()):
            self.epoch_end()
        return steps, end, self.n_batches // chunk

    def epoch(self, graphs) -> None:
        """One epoch of every seed: the order written, then the captured
        ``graphs`` (steps graph, epoch-end graph, replays) replayed, or with
        ``graphs`` None the same steps run eagerly."""
        self.write_order()
        if graphs is not None:
            steps, end, replays = graphs
            for _ in range(replays):
                steps.replay()
            end.replay()
        else:
            for _ in range(self.n_batches):
                self.step()
            self.epoch_end()

    def run(self, graph: bool) -> Dict[str, np.ndarray]:
        """Train every epoch, replayed from CUDA graphs or (``graph`` False)
        stepped eagerly; the per-seed histories as (S, epochs) numpy."""
        cfg = self.cfg
        with _matmul_precision(cfg.matmul_precision):
            graphs = self._capture() if graph else None
            for e in range(cfg.epochs):
                self.epoch(graphs)
                if self.device.type == "cuda" and (e + 1) % max(cfg.epochs_per_call, 1) == 0:
                    torch.cuda.synchronize(self.device)
        hist = self.hist.cpu().numpy()
        return {"loss": hist[0], "mse": hist[1], "esr": hist[2]}

    def params(self, seed_axis: bool) -> MLPParams:
        """The trained params: a leading seed axis on every leaf, or seed 0's."""
        out = []
        for layer in self.layout.views(self.flat.detach())["layers"]:
            k, b = layer["kernel"].clone(), layer["bias"][:, 0].clone()
            out.append({"kernel": k, "bias": b} if seed_axis else {"kernel": k[0], "bias": b[0]})
        return {"layers": out}


def pretrain_diode(diode: DiodeConfig, cfg: PretrainConfig = PretrainConfig(), *,
                   device: Device = "cuda"
                   ) -> Tuple[MLPParams, Tuple[str, ...], Dict[str, np.ndarray]]:
    """Train an MLP to mimic the closed-form diode pair on ``device``.

    Returns (mlp_params, activations, metrics) where metrics carries the
    per-epoch curves (loss/mse/esr arrays of length epochs).  On a card the
    epochs replay CUDA graphs; the CPU runs the same steps eagerly."""
    tr = _Trainer(diode, cfg, [cfg.seed], device)
    hist = tr.run(tr.device.type == "cuda")
    return tr.params(False), tr.acts, {k: v[0] for k, v in hist.items()}


def pretrain_diode_multiseed(diode: DiodeConfig, cfg: PretrainConfig, seeds, *,
                             device: Device = "cuda"
                             ) -> Tuple[MLPParams, Tuple[str, ...], Dict[str, np.ndarray]]:
    """Train the same architecture from several seeds at once (one graph, the
    seeds batched in every matmul).  Returns (stacked_params, acts,
    stacked_metrics) with a leading seed axis on every leaf."""
    tr = _Trainer(diode, cfg, list(seeds), device)
    hist = tr.run(tr.device.type == "cuda")
    return tr.params(True), tr.acts, hist


def evaluate_pretrained(params: MLPParams, acts, diode: DiodeConfig, cfg: PretrainConfig, *,
                        device: Device = "cuda") -> Dict[str, float]:
    """Final MSE/ESR on the full grid (the numbers of the results table)."""
    x_np, y_np = pretraining_grid(diode, n_r=cfg.n_r, n_a=cfg.n_a, a_span=cfg.a_span,
                                  device=device)
    x = torch.as_tensor(x_np, device=device)
    y = torch.as_tensor(y_np, device=device)[:, None]
    p = {"layers": [{k: t.to(device) for k, t in l.items()} for l in params["layers"]]}
    with _matmul_precision(cfg.matmul_precision), torch.no_grad():
        pred = mlp_apply(p, acts, x)
    return {"mse": float(mse(y, pred)), "esr": float(esr(y, pred, n_norm=cfg.n_a))}

