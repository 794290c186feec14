"""Analysis tools: training-history plots and transconductance extraction.

Loss-curve figures from metric histories, and recovery of a trained diode
model's I/V curve from wave-domain probes (i = (a-b)/2R, v = (a+b)/2)
compared against the Shockley ideal.  ``matplotlib`` is imported only by the
plotting functions.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .roots.diode import DiodeConfig, shockley_current
from .roots.neural import MLPParams, mlp_apply


def transconductance(
    mlp_params: MLPParams,
    activations: Sequence[str],
    r_values: Sequence[float] = (100.0, 1000.0, 10000.0),
    a_span: float = 10.0,
    n: int = 100,
):
    """Drive the neural root with a wave grid and recover (v, i) per R, on
    the device of the weights.  Returns {R: (v, i)} numpy arrays."""
    device = mlp_params["layers"][0]["kernel"].device
    a = np.linspace(-a_span, a_span, n, dtype=np.float32)
    out = {}
    for r in r_values:
        x = np.stack([a, np.full_like(a, np.log(r))], axis=-1)
        with torch.no_grad():
            y = mlp_apply(mlp_params, activations, torch.as_tensor(x, device=device))
        b = -y[:, 0].cpu().numpy()
        i = (a - b) / (2.0 * r)
        v = (a + b) / 2.0
        out[r] = (v, i)
    return out


def transconductance_error(
    mlp_params: MLPParams,
    activations: Sequence[str],
    diode: DiodeConfig,
    r: float = 1000.0,
    v_limit: float = 0.6,
):
    """RMS relative current error vs the Shockley ideal inside |v| < v_limit
    (a scalar physics-consistency metric)."""
    (v, i) = transconductance(mlp_params, activations, (r,))[r]
    vt = diode.Vt * diode.nabla
    i_ideal = shockley_current(torch.as_tensor(v), diode.Is, vt).numpy()
    mask = np.abs(v) < v_limit
    denom = np.sqrt(np.mean(i_ideal[mask] ** 2)) + 1e-18
    return float(np.sqrt(np.mean((i[mask] - i_ideal[mask]) ** 2)) / denom)


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def plot_history(history: Dict[str, List[float]], path: Optional[str] = None,
                 title: str = "Training history"):
    """Loss-curve figure."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    for key in ("loss", "val_loss", "mse", "esr", "val_mse", "val_esr"):
        if key in history and len(history[key]):
            ax.semilogy(history[key], label=key)
    ax.set_xlabel("Epoch")
    ax.set_ylabel("Loss")
    ax.grid(True)
    ax.legend()
    ax.set_title(title)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_transconductance(
    mlp_params: MLPParams,
    activations: Sequence[str],
    diode: DiodeConfig,
    path: Optional[str] = None,
    r: float = 100.0,
):
    """Model-vs-Shockley transconductance figure."""
    plt = _pyplot()
    vt = diode.Vt * diode.nabla
    v_ideal = np.linspace(-1.2, 1.2, 100)
    i_ideal = shockley_current(torch.as_tensor(v_ideal), diode.Is, vt).numpy()
    (v, i) = transconductance(mlp_params, activations, (r,))[r]

    fig, ax = plt.subplots()
    ax.plot(v_ideal, 1e3 * i_ideal, label="Ideal model")
    ax.plot(v, 1e3 * i, "--", label="Neural model")
    ax.set_xlim(-2.5, 2.5)
    ax.set_ylim(-65, 65)
    ax.set_xlabel("Voltage [V]")
    ax.set_ylabel("Current [mA]")
    ax.grid(True)
    ax.legend()
    ax.set_title(f"Diode Network Transconductance ({diode.name})")
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_target_pred(target, pred, path: Optional[str] = None, title: str = ""):
    """Target-vs-prediction checkpoint plot."""
    plt = _pyplot()
    fig, ax = plt.subplots()
    ax.plot(np.asarray(target), label="Target")
    ax.plot(np.asarray(pred), "--", label="Predicted")
    ax.set_xlabel("Time [samples]")
    ax.set_ylabel("Voltage")
    ax.grid(True)
    ax.legend(loc="lower left")
    ax.set_title(title)
    if path:
        fig.savefig(path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def load_history(path) -> Dict[str, List[float]]:
    """Load a training history for plotting: this package's JSONL metrics
    files, or a pickled history dict (only files this program wrote:
    unpickling runs code)."""
    import json as _json

    spath = str(path)
    if spath.endswith((".pkl", ".pickle")):
        import pickle

        with open(path, "rb") as f:
            return pickle.load(f)
    hist: Dict[str, List[float]] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = _json.loads(line)
            for k, v in rec.items():
                if isinstance(v, (int, float)) and k not in ("epoch", "step"):
                    hist.setdefault(k, []).append(float(v))
    return hist
