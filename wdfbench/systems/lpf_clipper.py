"""The system under test for a ``circuit: lpf_clipper`` configuration: the
port's LPF diode clipper with an NxH root, served by ``fused_clipper_neural``
(B1) and trained by ``make_train_step(engine="fused")`` (B3, B4 and the
parameter VJP)."""

from __future__ import annotations

import torch

from diffwdf_tpu_torch.models.diode_clipper import make_training_clipper
from diffwdf_tpu_torch.ops import clipper_train, fused_clipper
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.training.circuit_train import CircuitTrainConfig, make_train_step


def server(cfg: dict, mlp: dict, device):
    """(call(v, z) -> (out, z'), zero_state(B), states(z) -> (B, S))."""
    r, cap, fs = cfg["r_source"], cfg["cap"], cfg["fs"]

    def call(v, z):
        return fused_clipper.fused_clipper_neural(v, z, mlp, r, cap, fs=fs)

    return (call, lambda B: torch.zeros(B, device=device), lambda z: z[:, None])


def trainer(cfg: dict, mlp: dict, batches: dict):
    """(step() -> metrics, the trainable leaves, the optimizer): one
    training step object, built once."""
    tc = cfg["train"]
    root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, cfg["root"]["activations"])
    circuit = make_training_clipper(root, cfg["fs"], r_source=cfg["r_source"], cap=cfg["cap"])
    params = {**circuit.init_params(mlp["layers"][0]["kernel"].device), **frag}
    train_cfg = CircuitTrainConfig(batch_size=batches["x"].shape[1], engine="fused",
                                   learning_rate=tc["learning_rate"], beta1=tc["beta1"],
                                   skip_samples=tc["skip_samples"])
    make_optimizer, train_step, _ = make_train_step(circuit, train_cfg, lambda p: p["dp"])
    opt = make_optimizer(params)
    leaves = [x for layer in params["dp"]["layers"] for x in (layer["kernel"], layer["bias"])]
    return (lambda: train_step(params, opt, batches)), leaves, opt


def counters() -> dict:
    return {"B1": fused_clipper.fused_clipper_neural.launches,
            "B3": fused_clipper.fused_clipper_neural_train_fwd.launches,
            "B4": clipper_train.clipper_adjoint.launches}
