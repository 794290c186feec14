"""Synthetic dataset generation.

Two roles:

1. The pretraining grid: (incident wave a, port impedance R) -> reflected wave
   targets from the closed-form diode-pair equation — the reference's
   synthetic-pretraining path (``diode_pretraining.py:63-105``), vectorized
   with the real-line Wright omega instead of a 20 000-point scipy loop.

2. Synthetic "measured" clipper data: the reference's diode_dataset CSVs are
   large blobs absent from this checkout, so equivalent measurements are
   synthesized by simulating the training circuit with the analytic
   (TOMS-equivalent) root, and can be written in the exact CSV format the
   importer expects — keeping the whole measured-data pipeline executable
   end to end.  The LPF clipper runs through the fused analytic kernel
   (``ops.fused_clipper.fused_clipper_analytic``) and the Tube Screamer
   through its generated kernel (``ops.fused_circuit``), one stream per
   file: on a CUDA device that is one launch, where a loop over the samples
   of an 18-second file would take minutes.

Every function takes the ``device`` it simulates on and returns numpy.
"""

from __future__ import annotations

import os
from typing import Sequence, Tuple

import numpy as np
import torch

from ..core.elements import Device
from ..roots.diode import DiodeConfig, DiodePairRoot, diode_pair_reflected


def pretraining_grid(
    diode: DiodeConfig,
    n_r: int = 20,
    r_log10_lo: float = 1.0,
    r_log10_hi: float = 9.0,
    n_a: int = 1000,
    a_span: float = 2.5,
    *,
    device: Device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Build the synthetic pretraining set.

    Returns (x, y): x[:, 0] = a, x[:, 1] = log(R) (the log-impedance input
    convention, ``diode_pretraining.py:104-105``), y = **negated** reflected
    wave (the -1 target convention, ``diode_pretraining.py:98-102``).
    Grid: n_r log-spaced R decades x n_a points in [-a_span, a_span].
    """
    Vt = diode.Vt * diode.nabla
    r_vals = 10.0 ** np.linspace(r_log10_lo, r_log10_hi, n_r)
    a_vals = np.linspace(-a_span, a_span, n_a)
    A, R = np.meshgrid(a_vals, r_vals, indexing="xy")  # [n_r, n_a]
    a_flat = A.reshape(-1).astype(np.float32)
    r_flat = R.reshape(-1).astype(np.float32)
    b = diode_pair_reflected(
        torch.from_numpy(a_flat).to(device), torch.from_numpy(r_flat).to(device),
        diode.Is, Vt, float(diode.N_up), float(diode.N_down),
    )
    x = np.stack([a_flat, np.log(r_flat)], axis=-1).astype(np.float32)
    y = -b.cpu().numpy().astype(np.float32)
    return x, y


def _stimulus(n: int, fs: float, duration_s: float, seed: int, amp: float,
              f0: float, f1: float, noise: float) -> np.ndarray:
    """Exponential sine sweep f0 -> f1 plus a little noise, with a 50 ms
    fade-in, like a measurement stimulus."""
    rng = np.random.default_rng(seed)
    t = np.arange(n) / fs
    phase = 2 * np.pi * f0 * (f1 / f0) ** (t / duration_s) * t / np.log(f1 / f0)
    vin = amp * np.sin(phase).astype(np.float32)
    vin += noise * rng.standard_normal(n).astype(np.float32)
    env = np.minimum(1.0, t * 20.0).astype(np.float32)  # fade-in
    return (vin * env).astype(np.float32)


def synth_clipper_measurement(
    diode: DiodeConfig,
    r_source: float,
    cap: float = 4.7e-9,
    fs: float = 48000.0,
    duration_s: float = 1.0,
    seed: int = 0,
    amp: float = 2.5,
    *,
    device: Device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate the training clipper (Vs(R) || C + analytic diode root) on a
    multi-tone + noise excitation; returns (vin, vout) float32 arrays.

    Stands in for a lab measurement at source resistance ``r_source``.  The
    whole signal is one stream of the fused analytic kernel.
    """
    from ..models.diode_clipper import make_training_clipper
    from ..ops.fused_clipper import fused_clipper_analytic

    root = DiodePairRoot(name="dp", diode=diode, quality="best")
    ckt = make_training_clipper(root, fs, r_source=r_source, cap=cap)
    params = {**ckt.init_params(device), **root.init_params(device)}
    p = {k: float(v) for k, v in params[root.name].items()}

    n = int(duration_s * fs)
    vin = _stimulus(n, fs, duration_s, seed, amp, 40.0, 4000.0, 0.05)
    out, _ = fused_clipper_analytic(
        torch.from_numpy(vin).to(device)[None], torch.zeros(1, device=device),
        float(params["Vs"]["R"]), float(params["C"]["C"]), p["Is"], p["nabla"] * p["Vt"],
        p["N_up"], p["N_down"], fs=fs, quality_iters=root.iters,
    )
    return vin, out[0].cpu().numpy().astype(np.float32)


def synth_hpf_measurement(
    diode: DiodeConfig,
    r_load: float = 47.0e3,
    cap: float = 2.2e-9,
    fs: float = 48000.0,
    duration_s: float = 1.0,
    seed: int = 0,
    amp: float = 2.5,
    *,
    device: Device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate the HPF-topology clipper (``HPFDiodeClipper.h:26-32``) with
    the analytic diode root on a multi-tone excitation; returns (vin, vout).

    Stands in for the reference's ``placeholder_data/HPF`` measurement CSVs
    (large blobs absent from the checkout) — used to train the HPF "2x16
    Trained" zoo model (``HPFDiodeClipper.cpp:29-30``).  Runs the circuit's
    sequential ``Circuit.process``: no kernel serves the HPF topology yet.
    """
    from ..models.diode_clipper import make_hpf_diode_clipper

    root = DiodePairRoot(name="dp", diode=diode, quality="best")
    ckt = make_hpf_diode_clipper(root, fs, r_load=r_load, cap=cap)
    params = {**ckt.init_params(device), **root.init_params(device)}

    n = int(duration_s * fs)
    vin = _stimulus(n, fs, duration_s, seed, amp, 40.0, 4000.0, 0.05)
    with torch.no_grad():
        out, _ = ckt.process(params, ckt.init_state(device),
                             {"Vs": {"v": torch.from_numpy(vin).to(device)}})
    return vin, out.cpu().numpy().astype(np.float32)


def synth_ts_measurement(
    diode: DiodeConfig,
    drive: float = 0.5,
    fs: float = 48000.0,
    duration_s: float = 1.0,
    seed: int = 0,
    amp: float = 0.1,
    *,
    device: Device,
) -> Tuple[np.ndarray, np.ndarray]:
    """Simulate the Tube Screamer clipping stage (``TubeScreamer.h:24-74``)
    with the fast-approx analytic diode root (the reference's own analytic
    TS choice, ``TubeScreamer.h:73``, quality "low") on a guitar-level
    multi-tone; returns (vin, vout).  Stands in for a measurement used to
    circuit-train the TS "1N4148 2x16" neural model in its own topology.
    The whole signal is one stream of the generated circuit kernel
    (``ops.fused_circuit``)."""
    from ..models.tube_screamer import make_tube_screamer
    from ..ops.fused_circuit import fused_circuit_process

    root = DiodePairRoot(name="dp", diode=diode, quality="low")
    ckt = make_tube_screamer(root, fs, drive=drive)
    params = {**ckt.init_params(device), **root.init_params(device)}

    n = int(duration_s * fs)
    vin = _stimulus(n, fs, duration_s, seed, amp, 60.0, 3000.0, 0.005)
    state0 = {node: {field: torch.zeros(1, device=device) for field in fields}
              for node, fields in ckt.init_state("cpu").items()}
    out, _ = fused_circuit_process(ckt, params, torch.from_numpy(vin).to(device)[None], state0,
                                   input_node="Vin")
    return vin, out[0].cpu().numpy().astype(np.float32)


def write_reference_csv(path, vin, vout, fs: float):
    """Write a measurement CSV in the reference dataset's on-disk format
    (header rows incl. '#Sample rate: ...Hz' at row 4, '#Samples: N' at row
    5, data from row 10 — parsed by ``dataimport.py:10-22,30``)."""
    n = len(vin)
    with open(path, "w") as f:
        f.write("#Synthetic diode clipper measurement\n")
        f.write("#Generated by diffwdf_tpu\n")
        f.write("#\n")
        f.write("#\n")
        f.write(f"#Sample rate: {fs}Hz\n")
        f.write(f"#Samples: {n}\n")
        f.write("#\n")
        f.write("#\n")
        f.write("#\n")
        f.write("in_voltage,out_voltage\n")
        for a, b in zip(vin, vout):
            f.write(f"{a:.7g},{b:.7g}\n")


def make_synthetic_dataset_dir(
    base_dir,
    diode: DiodeConfig,
    r_kohms: Sequence[float] = (10.0, 25.0, 45.2, 75.0, 99.0),
    cap: float = 4.7e-9,
    fs: float = 48000.0,
    duration_s: float = 1.0,
    *,
    device: Device,
):
    """Create a diode_dataset-style directory tree:
    ``{base}/{family}/{N_up}up{N_down}down/{R}k_4.7nF.csv`` (layout per
    ``dataimport.py:62-79`` and the R-from-filename rule ``:95``)."""
    family = "1N4148" if "1N4148" in diode.name else diode.name.split()[0]
    sub = os.path.join(base_dir, family, f"{diode.N_up}up{diode.N_down}down")
    os.makedirs(sub, exist_ok=True)
    paths = []
    for i, rk in enumerate(r_kohms):
        vin, vout = synth_clipper_measurement(
            diode, rk * 1000.0, cap=cap, fs=fs, duration_s=duration_s, seed=i, device=device
        )
        p = os.path.join(sub, f"{rk}k_{cap*1e9:g}nF.csv")
        write_reference_csv(p, vin, vout, fs)
        paths.append(p)
    return paths
