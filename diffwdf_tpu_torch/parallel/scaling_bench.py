"""Scaling-efficiency harness (BASELINE.json acceptance: >= 80% scaling
efficiency).

Weak-scaling curves over meshes of the first n ranks
(``distributed.measure_scaling``), each with its control:

- **DP training**: the circuit-training step (gradient all-reduce over the
  mesh "data" axis, ``parallel.data_parallel``) with a fixed number of
  sequence chunks *per rank*: perfect scaling keeps the step time flat as
  ranks (and chunks) grow.  Control: the single-process step on each rank's
  shard, no collective, all ranks at once.
- **Time-block decode**: overlap-save long-signal processing
  (``parallel.time_block``) with a fixed signal length *per rank* on the
  mesh "time" axis.  Control: each rank's overlap-save block alone (no
  gather), all ranks at once.
- **Time-block training**: overlap-save BPTT, the whole step (forward,
  gradient, all-reduces, Adam) timed.

The slowest rank's time counts.  Ranks that share a host's cores (gloo on
the CPU, or two ranks on one card) measure the structure (no hidden
serialisation, the collectives in place), not the interconnect.
"""

from __future__ import annotations

import os
import subprocess
from typing import Dict, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..core.elements import Device
from ..data.synthetic import synth_clipper_measurement
from ..models.diode_clipper import make_diode_clipper, make_training_clipper
from ..ops.fused_circuit import fused_circuit_process
from ..roots.diode import DiodePairRoot, diode_1n4148_1u1d
from ..roots.neural import NeuralDiodeRoot
from ..training.circuit_train import (CircuitTrainConfig, _map, make_clipper_batches,
                                      make_train_step)
from .data_parallel import make_dp_train_step
from .distributed import measure_scaling
from .mesh import axis_index, rank_device
from .time_block import make_time_block_train_step, time_block_process

DIODE_R = 45e3


def _samples(res: Dict[int, Dict[str, float]]) -> Dict[int, Dict[str, float]]:
    """Name the rate as the time-block curves do: samples a second."""
    return {n: {("samples_per_s" if k == "items_per_s" else k): v for k, v in rec.items()}
            for n, rec in res.items()}


def _dp_setup(device_counts, chunks_per_device, batch_size, fs, dev):
    need_s = (max(device_counts) * chunks_per_device * batch_size + batch_size) / fs
    vin, vout = synth_clipper_measurement(diode_1n4148_1u1d, DIODE_R, fs=fs,
                                          duration_s=need_s, device=dev)
    data = {"x": vin, "r": np.full_like(vin, DIODE_R), "y": vout}
    root = NeuralDiodeRoot(name="dp", n_layers=2, layer_size=16)
    ckt = make_training_clipper(root, fs)
    return data, ckt, {**ckt.init_params(dev), **root.init_params(dev)}


def _copy(params):
    return _map(lambda x: x.detach().clone(), params)


def dp_training_scaling(device_counts: Sequence[int] = (1, 2, 4, 8), chunks_per_device: int = 4,
                        batch_size: int = 256, fs: float = 8000.0, iters: int = 5, *,
                        device: Device = "cuda") -> Dict[int, Dict[str, float]]:
    """Weak-scaling curve of the DP circuit-training step."""
    dev = rank_device(device)
    data, ckt, params0 = _dp_setup(device_counts, chunks_per_device, batch_size, fs, dev)

    def make_step(mesh):
        cfg = CircuitTrainConfig(batch_size=batch_size,
                                 max_chunks=mesh.size() * chunks_per_device)
        batches = make_clipper_batches(data, cfg.batch_size, cfg.max_chunks, device="cpu")
        make_optimizer, dp_step, _, prepare = make_dp_train_step(ckt, cfg, mesh, device=dev)
        p, b = prepare(params0, batches)
        opt = make_optimizer(p)
        return lambda: dp_step(p, opt, b)

    return measure_scaling(make_step, device_counts, iters=iters,
                           items_per_call=chunks_per_device * batch_size, device=dev)


def dp_concurrent_control(device_counts: Sequence[int] = (1, 2, 4, 8),
                          chunks_per_device: int = 4, batch_size: int = 256,
                          fs: float = 8000.0, iters: int = 5, *,
                          device: Device = "cuda") -> Dict[int, Dict[str, float]]:
    """Control of the DP curve: the single-process training step
    (``make_train_step``) on each rank's shard of the same chunks, no
    collective, all ranks at once.  The same data parallelism without the
    all-reduces: where this scales and the DP curve does not, the
    collectives hold the step."""
    dev = rank_device(device)
    data, ckt, params0 = _dp_setup(device_counts, chunks_per_device, batch_size, fs, dev)
    make_optimizer, train_step, _ = make_train_step(ckt, CircuitTrainConfig(batch_size=batch_size))

    def make_step(mesh):
        r = axis_index(mesh, "data")
        all_b = make_clipper_batches(data, batch_size, mesh.size() * chunks_per_device,
                                     device="cpu")
        shard = {k: v[r * chunks_per_device:(r + 1) * chunks_per_device].to(dev)
                 for k, v in all_b.items()}
        p = _copy(params0)
        opt = make_optimizer(p)
        return lambda: train_step(p, opt, shard)

    return measure_scaling(make_step, device_counts, iters=iters,
                           items_per_call=chunks_per_device * batch_size, device=dev)


def _lpf_clipper(fs: float, dev):
    root = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d)
    ckt = make_diode_clipper(root, fs)
    return ckt, {**ckt.init_params(dev), **root.init_params(dev)}


def time_block_scaling(device_counts: Sequence[int] = (1, 2, 4, 8), t_per_device: int = 16384,
                       warmup: int = 256, fs: float = 48000.0, iters: int = 5, *,
                       device: Device = "cuda") -> Dict[int, Dict[str, float]]:
    """Weak-scaling curve of overlap-save time-block decode (the analytic
    LPF clipper)."""
    dev = rank_device(device)
    ckt, params = _lpf_clipper(fs, dev)

    def make_step(mesh):
        x = np.random.default_rng(0).normal(size=mesh.size() * t_per_device).astype(np.float32)
        inputs = {"Vs": {"v": torch.from_numpy(x).to(dev)}}
        return lambda: time_block_process(ckt, params, inputs, mesh, warmup=warmup, device=dev)

    return _samples(measure_scaling(make_step, device_counts, iters=iters,
                                    items_per_call=t_per_device, axis="time", device=dev))


def time_block_training_scaling(device_counts: Sequence[int] = (1, 2, 4, 8),
                                t_per_device: int = 4096, warmup: int = 192,
                                fs: float = 48000.0, iters: int = 5, *,
                                device: Device = "cuda") -> Dict[int, Dict[str, float]]:
    """Weak-scaling curve of overlap-save BPTT training: one long sequence,
    t_per_device samples a rank on the mesh time axis, the whole train step
    (forward, gradient, all-reduces, Adam) timed."""
    dev = rank_device(device)
    root = NeuralDiodeRoot(name="dp", n_layers=1, layer_size=8)
    ckt = make_training_clipper(root, fs)
    params0 = {**ckt.init_params(dev), **root.init_params(dev)}
    cfg = CircuitTrainConfig(learning_rate=1e-3, skip_samples=50)

    def make_step(mesh):
        rng = np.random.default_rng(0)
        x = torch.from_numpy((0.8 * rng.standard_normal(mesh.size() * t_per_device))
                             .astype(np.float32)).to(dev)
        y = torch.tanh(x)
        make_optimizer, step, _ = make_time_block_train_step(ckt, cfg, mesh, warmup=warmup,
                                                             device=dev)
        p = _copy(params0)
        opt = make_optimizer(p)
        return lambda: step(p, opt, x, y)

    return _samples(measure_scaling(make_step, device_counts, iters=iters,
                                    items_per_call=t_per_device, axis="time", device=dev))


def time_block_concurrent_control(device_counts: Sequence[int] = (1, 2, 4, 8),
                                  t_per_device: int = 16384, warmup: int = 256,
                                  fs: float = 48000.0, iters: int = 5, *,
                                  device: Device = "cuda") -> Dict[int, Dict[str, float]]:
    """Control of the time-block curve: each rank's overlap-save block
    (t_per_device + warmup samples from zero state through B7 at B = 1, the
    warm-up dropped) alone, no gather, all ranks at once."""
    dev = rank_device(device)
    ckt, params = _lpf_clipper(fs, dev)

    def make_step(mesh):
        r = axis_index(mesh, "time")
        x = np.random.default_rng(0).normal(size=mesh.size() * t_per_device + warmup)
        v = torch.from_numpy(x[r * t_per_device:(r + 1) * t_per_device + warmup]
                             .astype(np.float32)).to(dev)[None]
        z0 = {"C": {"z": torch.zeros(1, device=dev)}}

        def step():
            out, _ = fused_circuit_process(ckt, params, v, z0, input_node="Vs")
            return out[0, warmup:]

        return step

    return _samples(measure_scaling(make_step, device_counts, iters=iters,
                                    items_per_call=t_per_device, axis="time", device=dev))


def _card() -> Optional[Dict[str, str]]:
    """The card's name and power limit as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None
    name, limit = (s.strip() for s in out.split(",", 1))
    return {"name": name, "power_limit": limit}


def run_scaling_suite(device_counts: Sequence[int] = (1, 2, 4, 8), iters: int = 5, *,
                      device: Device = "cuda") -> Dict:
    """The five curves at their default shapes and where they ran: ``env``
    holds the device type, the world size, the host's cores and, on CUDA,
    the card's name and power limit.  ``note`` is None: the curves carry no
    diagnosis of their own."""
    dev = rank_device(device)
    card = _card() if dev.type == "cuda" else None
    env = {"backend": dev.type, "n_devices": dist.get_world_size() if dist.is_initialized() else 1,
           "device0": card["name"] if card else str(dev), "physical_cores": os.cpu_count(),
           "power_limit": card["power_limit"] if card else None}
    curves = {"dp_training": dp_training_scaling, "dp_control": dp_concurrent_control,
              "time_block": time_block_scaling, "time_block_control": time_block_concurrent_control,
              "time_block_training": time_block_training_scaling}
    out = {"env": env, "note": None}
    for name, curve in curves.items():
        out[name] = curve(device_counts, iters=iters, device=dev)
    return out
