"""Stand-ins for the system under test that the check has to refuse: the
control (the plain reference in the program's place, computed in TF32, the
precision below the configuration's float32 with TF32 off) and planted
faults of the timed path.  Each is a function of the cell that returns an
object with the system's ``server``, ``trainer`` and ``counters``.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from wdfbench.reference import wdf


def control(cell):
    """The reference at float32 with every matrix product in TF32."""

    def server(cfg, mlp, device):
        model = cell.reference_model(torch.float32, device, tf32=True)
        return (lambda v, z: model.run(v, z),
                lambda B: torch.zeros(B, model.n_states, device=device), lambda z: z)

    def trainer(cfg, mlp, batches):
        tc, x, y = cfg["train"], batches["x"], batches["y"]
        model = cell.reference_model(torch.float32, x.device, pot_rows=batches.get("r0"),
                                     tf32=True)
        leaves = model.weights()
        for w in leaves:
            w.requires_grad_(True)
        opt = torch.optim.Adam(leaves, lr=tc["learning_rate"], betas=(tc["beta1"], tc["beta2"]),
                               eps=tc["eps"])
        z0 = torch.zeros(x.shape[0], model.n_states, device=x.device)
        skip = tc["skip_samples"]

        def step():
            opt.zero_grad(set_to_none=True)
            out, _ = model.run(x, z0)
            t = y[:, skip:]
            loss = wdf.loss_of_sums(((t - out[:, skip:]) ** 2).sum(), (t ** 2).sum(), t.numel())
            loss.backward()
            opt.step()
            return {"loss": loss.detach()}

        return step, leaves, opt

    return SimpleNamespace(server=server, trainer=trainer, counters=dict)


def state_unchanged(cell):
    """Serving hands back the state it was given; training's optimizer step
    leaves the parameters as they were."""
    real = cell.system

    def server(cfg, mlp, device):
        call, zero, states = real.server(cfg, mlp, device)
        return (lambda v, z: (call(v, z)[0], z)), zero, states

    def trainer(cfg, mlp, batches):
        step, leaves, opt = real.trainer(cfg, mlp, batches)
        opt.step = lambda *a, **k: None
        return step, leaves, opt

    return SimpleNamespace(server=server, trainer=trainer, counters=real.counters)


def half_batch(cell):
    """Half of the batch left out: serving runs the first half of the
    streams and returns zeros for the rest; training's loss is the mean
    over the first half of the chunks."""
    real = cell.system

    def server(cfg, mlp, device):
        call, zero, states = real.server(cfg, mlp, device)
        zero_half = None

        def half(v, z):
            nonlocal zero_half
            B = v.shape[0]
            if zero_half is None:
                zero_half = zero(B - B // 2)
            out, zh = call(v[:B // 2].contiguous(), _rows(z, slice(0, B // 2)))
            full = torch.zeros_like(v)
            full[:B // 2] = out
            return full, _cat(zh, zero_half)
        return half, zero, states

    def trainer(cfg, mlp, batches):
        B = batches["x"].shape[0]
        return real.trainer(cfg, mlp, {k: x[:B // 2] for k, x in batches.items()})

    return SimpleNamespace(server=server, trainer=trainer, counters=real.counters)


def answer_altered(cell):
    """An answer altered where it is produced: serving adds 1e-3 to one
    sample of every stream's block; training scales the first leaf's
    gradient by 1.01 before each optimizer step."""
    real = cell.system

    def server(cfg, mlp, device):
        call, zero, states = real.server(cfg, mlp, device)

        def altered(v, z):
            out, z2 = call(v, z)
            out[:, out.shape[1] // 2] += 1e-3
            return out, z2
        return altered, zero, states

    def trainer(cfg, mlp, batches):
        step, leaves, opt = real.trainer(cfg, mlp, batches)
        inner = opt.step

        def step_altered(*a, **k):
            leaves[0].grad.mul_(1.01)
            return inner(*a, **k)
        opt.step = step_altered
        return step, leaves, opt

    return SimpleNamespace(server=server, trainer=trainer, counters=real.counters)


def _rows(z, rows):
    if isinstance(z, dict):
        return {n: {f: x[rows].contiguous() for f, x in d.items()} for n, d in z.items()}
    return z[rows].contiguous()


def _cat(a, b):
    if isinstance(a, dict):
        return {n: {f: torch.cat([x, b[n][f]]) for f, x in d.items()} for n, d in a.items()}
    return torch.cat([a, b])


STANDINS = {"control": control, "state_unchanged": state_unchanged, "half_batch": half_batch,
            "answer_altered": answer_altered}
