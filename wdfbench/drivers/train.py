"""Closed-loop training: full-batch gradient steps over ``rows`` chunks of
``block`` samples, the next step issued as soon as the host can.

Set-up builds the one training-step object of the system (model, optimizer
state and its batch), drives it through its first ``reference_steps``
steps through the same call the window makes (they also warm it up), and
hands that object to the window.  Kept from those steps: each step's loss,
the first gradient as Adam holds it after one step (exp_avg / (1 - beta1)),
and each leaf's change after the steps, read before the window's first step
moves it.

Checked after the window, once the program's state is freed, against the
plain reference's own run of the same steps (float64, autograd, Adam by
hand): loss_gap, the largest relative gap of a step's loss; grad_gap, the
largest gap between a leaf's norm and the reference's, over the larger of
the reference's norm of that leaf and of the median leaf; change_gap, the
median over the leaves of the same gap of their changes.  The median leaf,
since an element whose gradient is rounding noise steps under Adam by an
amount set by that noise (against eps), and one such element can move its
leaf's norm by a thousandth on some seeds.  A leaf whose reference gradient
is under a thousandth of the median leaf's moves under Adam by rounding
alone and is left out of change_gap.
"""

from __future__ import annotations

import statistics
import time

import torch

from wdfbench import inputs
from wdfbench.reference import wdf

UNIT = "step"
ROUNDING_LEAF = 1e-3


def batches(cell, device) -> dict:
    """The training batch made from the seed: inputs, targets and, where the
    configuration drives a pot per chunk, each chunk's resistance.  Where
    it plays at several levels, each chunk's input is scaled by its own."""
    tr, cfg = cell.traffic, cell.cfg
    x = inputs.signal(cfg["input"], cfg["fs"], 1, tr["rows"], tr["block"], cell.seed, device)[0]
    if cfg.get("level_rows"):
        x = x * inputs.row_values(cfg["level_rows"], tr["rows"], device)[:, None]
    out = {"x": x, "y": inputs.target(cfg["target"], x)}
    if cfg.get("pot_rows"):
        out["r0"] = inputs.row_values(cfg["pot_rows"], tr["rows"], device)
    return out


def setup(cell) -> dict:
    tr, beta1 = cell.traffic, cell.cfg["train"]["beta1"]
    step, leaves, opt = cell.system.trainer(cell.cfg, cell.weights(cell.device),
                                            batches(cell, cell.device))
    start = [x.detach().clone() for x in leaves]
    losses, first_grad = [], None
    for _ in range(tr["reference_steps"]):
        losses.append(step()["loss"])
        if first_grad is None:  # a leaf Adam has not stepped holds no moment: zero
            first_grad = [opt.state[x]["exp_avg"].detach() / (1 - beta1)
                          if "exp_avg" in opt.state[x] else torch.zeros_like(x) for x in leaves]
    change = [x.detach() - x0 for x, x0 in zip(leaves, start)]
    cell.sync()
    return {"step": step, "losses": losses, "first_grad": first_grad, "change": change}


def loop(job: dict, until: float) -> int:
    step, n = job["step"], 0
    while time.perf_counter() < until:
        step()
        n += 1
    return n


def host_spans(job: dict, cell) -> dict:
    return {}


def _gaps(got, want, keep=None) -> list:
    """|norm(got) - norm(want)| / max(norm(want), median) of each leaf kept."""
    g = [wdf.norm(x) for x in got]
    w = [wdf.norm(x) for x in want]
    idx = [i for i in range(len(w)) if keep is None or keep[i]]
    med = statistics.median(w[i] for i in idx)
    return [abs(g[i] - w[i]) / max(w[i], med, 1e-300) for i in idx]


def check(job: dict, cell) -> list:
    """[(name, value, limit)] of the comparison with the plain reference.
    Frees the program's state first."""
    tc = cell.cfg["train"]
    losses = [float(x) for x in job["losses"]]
    got_grad = [x.double().cpu() for x in job["first_grad"]]
    got_change = [x.double().cpu() for x in job["change"]]
    job.clear()
    cell.free()
    data = batches(cell, cell.device)
    model = cell.reference_model(torch.float64, cell.device, pot_rows=data.get("r0"))
    ref_losses, ref_grad, ref_change = wdf.train_steps(
        model, data["x"].double(), data["y"].double(), steps=len(losses),
        skip=tc["skip_samples"], lr=tc["learning_rate"], betas=(tc["beta1"], tc["beta2"]),
        eps=tc["eps"])
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(losses, ref_losses))
    grad_gap = max(_gaps(got_grad, ref_grad))
    norms = [wdf.norm(g) for g in ref_grad]
    med = statistics.median(norms)
    keep = [n >= ROUNDING_LEAF * med for n in norms]
    change_gap = statistics.median(_gaps(got_change, ref_change, keep))
    lim = cell.limits
    return [("loss_gap", loss_gap, lim["loss_gap"]), ("grad_gap", grad_gap, lim["grad_gap"]),
            ("change_gap", change_gap, lim["change_gap"])]
