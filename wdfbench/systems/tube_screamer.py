"""The system under test for a ``circuit: tube_screamer`` configuration:
the port's Tube Screamer clipping stage with an NxH root, served by the
generated kernel through ``fused_circuit_process_neural`` (B7) and trained
by ``make_train_step(engine="fused_generic")`` (B7's training form, B8 and
the parameter pass)."""

from __future__ import annotations

import torch

from diffwdf_tpu_torch.models.tube_screamer import make_tube_screamer
from diffwdf_tpu_torch.ops import fused_circuit, parallel_bptt
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot
from diffwdf_tpu_torch.training.circuit_train import CircuitTrainConfig, make_train_step

STATES = (("C2", "z"), ("C3", "z"), ("C4", "z"))


def _circuit(cfg: dict, mlp: dict):
    root, frag = NeuralDiodeRoot.from_mlp("dp", mlp, cfg["root"]["activations"])
    return make_tube_screamer(root, cfg["fs"], drive=cfg["drive"]), frag


def server(cfg: dict, mlp: dict, device):
    """(call(v, z) -> (out, z'), zero_state(B), states(z) -> (B, S))."""
    circuit, _ = _circuit(cfg, mlp)
    params = circuit.init_params(device)
    del params["dp"]

    def call(v, z):
        return fused_circuit.fused_circuit_process_neural(circuit, params, mlp, v, z,
                                                          input_node="Vin")

    def zero_state(B):
        return {node: {field: torch.zeros(B, device=device)} for node, field in STATES}

    def states(z):
        return torch.stack([z[node][field] for node, field in STATES], 1)

    return call, zero_state, states


def trainer(cfg: dict, mlp: dict, batches: dict):
    """(step() -> metrics, the trainable leaves, the optimizer): one
    training step object, built once."""
    tc = cfg["train"]
    circuit, frag = _circuit(cfg, mlp)
    params = {**circuit.init_params(mlp["layers"][0]["kernel"].device), **frag}
    train_cfg = CircuitTrainConfig(batch_size=batches["x"].shape[1], engine="fused_generic",
                                   learning_rate=tc["learning_rate"], beta1=tc["beta1"],
                                   skip_samples=tc["skip_samples"])
    make_optimizer, train_step, _ = make_train_step(circuit, train_cfg, lambda p: p["dp"])
    opt = make_optimizer(params)
    leaves = [x for layer in params["dp"]["layers"] for x in (layer["kernel"], layer["bias"])]
    return (lambda: train_step(params, opt, batches)), leaves, opt


def counters() -> dict:
    return {"B7": fused_circuit.fused_circuit_process.launches,
            "B7_lanes": fused_circuit.fused_circuit_process.lane_launches,
            "B8": parallel_bptt.fused_backward.launches}
