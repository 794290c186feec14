"""Closed-loop serving: ``rows`` streams in blocks of ``block`` samples, the
state carried from block to block, the next block issued as soon as the
host can.  As an offline render stages its input, each stream's next
``pool_blocks`` consecutive blocks are held on the card, made at set-up;
the window walks through them and starts over at the end.

Checked after the window, on ``check_rows`` rows drawn from the seed,
against the plain reference in float64 on the cell's device, in two runs
of ``block`` samples: the first two blocks, chained from the zero state
(the start, wholly independent of the program); one call drawn from the
window's first ``check_within`` and the window's last call, each from the
state the program carried into it (the reference cannot replay the
thousands of blocks before it).  Compared: the output blocks (out_gap) and
the carried states (state_gap), each as the largest gap over the largest
magnitude of the reference's.
"""

from __future__ import annotations

import time

import torch

from wdfbench import inputs

UNIT = "call"


def setup(cell) -> dict:
    tr, cfg = cell.traffic, cell.cfg
    B, T, P = tr["rows"], tr["block"], tr["pool_blocks"]
    v = inputs.signal(cfg["input"], cfg["fs"], P, B, T, cell.seed, cell.device)
    call, zero_state, states = cell.system.server(cfg, cell.weights(cell.device), cell.device)
    z = zero_state(B)
    o0, z1 = call(v[0], z)
    o1, z2 = call(v[1], z1)
    cell.sync()
    return {"v": v, "call": call, "states": states, "z": z2, "k": 2, "start": (o0, o1, z1, z2),
            "pick": inputs.sample(1, tr["check_within"], cell.seed)[0], "kept": []}


def loop(job: dict, until: float) -> int:
    """Serve blocks until the host clock passes ``until``; the number of
    calls issued.  Keeps the drawn call and the last one."""
    call, v, P, pick = job["call"], job["v"], job["v"].shape[0], job["pick"]
    z, k, n = job["z"], job["k"], 0
    z_in = out = None
    while time.perf_counter() < until:
        z_in = z
        out, z = call(v[k % P], z)
        if n == pick:
            job["kept"].append((k, z_in, out, z))
        k, n = k + 1, n + 1
    if n and n - 1 != pick:
        job["kept"].append((k - 1, z_in, out, z))
    job["z"], job["k"] = z, k
    return n


def host_spans(job: dict, cell, calls: int = 30) -> dict:
    """Host milliseconds of the entry, one call at a time on an idle card
    (each call's launch sequence, adaptation and argument set-up)."""
    call, v, P = job["call"], job["v"], job["v"].shape[0]
    z, k, ms = job["z"], job["k"], []
    for _ in range(calls):
        cell.sync()
        t0 = time.perf_counter()
        _, z = call(v[k % P], z)
        ms.append((time.perf_counter() - t0) * 1e3)
        k += 1
    cell.sync()
    job["z"], job["k"] = z, k
    return {"call_host_ms": ms}


def check(job: dict, cell) -> list:
    """[(name, value, limit)] of the comparison with the plain reference in
    float64 on the cell's device.  Frees the program's state first."""
    tr, cfg = cell.traffic, cell.cfg
    B, T, P = tr["rows"], tr["block"], tr["pool_blocks"]
    rows = torch.tensor(inputs.sample(tr["check_rows"], B, cell.seed))
    states = job["states"]
    cpu = lambda x: x.detach()[rows.to(x.device)].double().cpu()  # noqa: E731
    o0, o1, z1, z2 = job["start"]
    start = (cpu(o0), cpu(o1), cpu(states(z1)), cpu(states(z2)))
    kept = [(k, cpu(states(z_in)), cpu(out), cpu(states(z_out)))
            for k, z_in, out, z_out in job["kept"]]
    job.clear()
    cell.free()
    v = inputs.signal(cfg["input"], cfg["fs"], P, B, T, cell.seed, cell.device)
    v = v[:, rows.to(v.device)].double()
    model = cell.reference_model(torch.float64, cell.device)
    R, S = len(rows), model.n_states
    with torch.inference_mode():
        # block 0 from the zero state and each kept call from its carried
        # state in one run, then block 1 from the reference's own state
        z0 = torch.zeros(R, S, dtype=torch.float64, device=v.device)
        ref_out, ref_z = model.run(torch.cat([v[0]] + [v[k % P] for k, *_ in kept]),
                                   torch.cat([z0] + [z_in.to(v.device) for _, z_in, _, _ in kept]))
        ref_out1, ref_z1 = model.run(v[1], ref_z[:R])
    ref_out, ref_z, ref_out1, ref_z1 = ref_out.cpu(), ref_z.cpu(), ref_out1.cpu(), ref_z1.cpu()
    out_pairs = [(start[0], ref_out[:R]), (start[1], ref_out1)]
    state_pairs = [(start[2], ref_z[:R]), (start[3], ref_z1)]
    if kept:
        out_pairs.append((torch.cat([out for *_, out, _ in kept]), ref_out[R:]))
        state_pairs.append((torch.cat([z for *_, z in kept]), ref_z[R:]))
    scale = max(float(ref.abs().max()) for _, ref in out_pairs)
    out_gap = max(float((p - ref).abs().max()) for p, ref in out_pairs) / scale
    zs = [max(float(ref[:, s].abs().max()) for _, ref in state_pairs) for s in range(S)]
    state_gap = max(float((p[:, s] - ref[:, s]).abs().max()) / max(zs[s], 1e-30)
                    for p, ref in state_pairs for s in range(S))
    lim = cell.limits
    return [("out_gap", out_gap, lim["out_gap"]), ("state_gap", state_gap, lim["state_gap"])]
