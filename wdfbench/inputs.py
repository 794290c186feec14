"""The benchmark's one generator: signals, targets, per-row pot positions
and levels, and root weights, all made from ``--seed`` on the device, in a
few large calls.

The same seed gives the same values: every function takes its own
``torch.Generator`` seeded from (seed, purpose), so the check after the
window makes the same inputs again without keeping them.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch

# a separate stream of random numbers for each purpose
_PURPOSE = {"signal": 1, "weights": 2, "sample": 4}


def generator(seed: int, purpose: str, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 16 + _PURPOSE[purpose]) % (2 ** 63))
    return g


def signal(spec: dict, fs: float, blocks: int, rows: int, T: int, seed: int, device):
    """(blocks, rows, T) float32: each row a stream, ``tone_amp`` times a
    sine at ``tone_hz`` with a random phase a row, plus ``noise_std`` times
    white Gaussian noise; block k holds the stream's samples k T .. (k+1) T."""
    g = generator(seed, "signal", device)
    phase = 2 * math.pi * torch.rand(rows, generator=g, device=device)
    out = torch.randn(blocks, rows, T, generator=g, device=device).mul_(spec["noise_std"])
    if spec.get("tone_amp", 0.0):
        w = 2 * math.pi * spec["tone_hz"] / fs
        for k in range(blocks):
            n = torch.arange(k * T, (k + 1) * T, device=device, dtype=torch.float64)
            out[k].add_((spec["tone_amp"] * torch.sin(w * n + phase.double()[:, None])).float())
    return out


def target(spec: dict, x: torch.Tensor) -> torch.Tensor:
    """The training target of inputs x: ``level * tanh(gain * x)``, a plain
    soft clip standing in for a measured output."""
    return spec["level"] * torch.tanh(spec["gain"] * x)


def row_values(values: List[float], rows: int, device) -> torch.Tensor:
    """(rows,) float32: ``values`` in equal shares, in the order a data set
    of one recording a value reads: each value's rows together, the first
    value first (where rows do not divide, the first values take one row
    more)."""
    base = torch.tensor(values, dtype=torch.float32, device=device)
    return base[torch.arange(rows, device=device) * len(values) // rows]


def seeded_mlp(sizes: List[int], seed: int, device) -> List[Dict[str, torch.Tensor]]:
    """Layers {kernel [in, out], bias [out]} of a dense stack: kernels
    N(0, 1 / max(in, out)) (the spread of an orthogonal initialisation),
    biases zero, drawn in one call."""
    g = generator(seed, "weights", device)
    shapes = list(zip(sizes[:-1], sizes[1:]))
    flat = torch.randn(sum(i * o for i, o in shapes), generator=g, device=device)
    layers, at = [], 0
    for i, o in shapes:
        k = flat[at:at + i * o].reshape(i, o) / math.sqrt(max(i, o))
        layers.append({"kernel": k.contiguous(), "bias": torch.zeros(o, device=device)})
        at += i * o
    return layers


def sample(n: int, high: int, seed: int) -> List[int]:
    """``n`` distinct integers in [0, high), drawn from the seed, sorted."""
    g = generator(seed, "sample", "cpu")
    return sorted(torch.randperm(high, generator=g)[:n].tolist())
