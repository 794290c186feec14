"""The serving kernels as ``torch.library`` custom ops, for ``torch.export``.

The serving artifact (``runtime/artifact.py``) is a ``torch.export``
program, and a traced program can hold a kernel only as an operator of the
dispatcher.  Three ops, namespace ``diffwdf_torch``, each with a fake
implementation for tracing and no autograd (serving only, as the JAX
package's artifact is forward-only):

- ``clipper_analytic``: the LPF clipper with the analytic diode pair, B2
  (``fused_clipper.fused_clipper_analytic``);
- ``clipper_neural``: the LPF clipper with an NxH root, B1
  (``fused_clipper.fused_clipper_neural``);
- ``circuit_forward``: any circuit's generated forward, B7
  (``fused_circuit.launch_source``), its diode-pair and NxH forms among
  them.  The generated source and its host source are arguments, so the op
  builds (or loads) its kernel from the program alone, with no circuit
  object.

Each op calls the wrapper or launch that ``runtime/stream.py`` calls: on
CUDA tensors the wrapper's kernel with the wrapper's arguments, on the
current stream, so the wrapper's bits and the wrapper's launch counter
(``fused_clipper_analytic.launches``, ``fused_clipper_neural.launches``,
``fused_circuit_process.launches``).  On CPU tensors B1 and B2 run their
plain versions and B7 runs the generated source's ``circuit_host_run``,
built for the host (``_build.host_library``).  The device of the tensors
alone chooses; a failed launch raises.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch
from torch import Tensor

from . import _build
from . import fused_circuit as fcirc
from . import fused_clipper as fc


def _fresh(z: Tensor, z0: Tensor) -> Tensor:
    """z, copied where it is z0 itself (an op's output may not alias its input)."""
    return z.clone() if z is z0 else z


@torch.library.custom_op("diffwdf_torch::clipper_analytic", mutates_args=())
def clipper_analytic(vin: Tensor, z0: Tensor, r_source: float, cap: float, Is: float,
                     vt_eff: float, n_up: float, n_down: float, fs: float,
                     quality_iters: int) -> Tuple[Tensor, Tensor]:
    """B2: vin (B, T), z0 (B,) f32 -> (out (B, T), z_final (B,)), as
    ``fused_clipper.fused_clipper_analytic``."""
    out, zf = fc.fused_clipper_analytic(vin, z0, r_source, cap, Is, vt_eff, n_up, n_down,
                                        fs=fs, quality_iters=quality_iters)
    return out, _fresh(zf, z0)


@clipper_analytic.register_fake
def _(vin, z0, r_source, cap, Is, vt_eff, n_up, n_down, fs, quality_iters):
    return torch.empty_like(vin), torch.empty_like(z0)


def _mlp(layers: List[Tensor]):
    """[kernel0, bias0, kernel1, bias1, ...] -> MLP params."""
    return {"layers": [{"kernel": k, "bias": b} for k, b in zip(layers[::2], layers[1::2])]}


def mlp_layers(mlp_params) -> List[Tensor]:
    """MLP params -> the flat list :func:`clipper_neural` takes."""
    return [t for layer in mlp_params["layers"] for t in (layer["kernel"], layer["bias"])]


@torch.library.custom_op("diffwdf_torch::clipper_neural", mutates_args=())
def clipper_neural(vin: Tensor, z0: Tensor, layers: List[Tensor], r_source: float, cap: float,
                   fs: float) -> Tuple[Tensor, Tensor]:
    """B1: vin (B, T), z0 (B,) f32, an NxH root's layers (:func:`mlp_layers`)
    -> (out (B, T), z_final (B,)), as ``fused_clipper.fused_clipper_neural``
    (the lanes per stream of ``neural_lanes``)."""
    out, zf = fc.fused_clipper_neural(vin, z0, _mlp(layers), r_source, cap, fs=fs)
    return out, _fresh(zf, z0)


@clipper_neural.register_fake
def _(vin, z0, layers, r_source, cap, fs):
    return torch.empty_like(vin), torch.empty_like(z0)


def host_run(host_source: str, vin: Tensor, z0: Tensor, vec: Tensor, rows: Tensor,
             times: Tensor, warr: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """A generated forward's ``circuit_host_run`` on CPU tensors (one host
    thread over the streams and samples): vin (B, T), z0 (S, B) and the
    slots as :func:`circuit_forward` -> (out (B, T), z_final (S, B))."""
    lib = _build.host_library(host_source)
    vin, z0 = vin.contiguous(), z0.contiguous()
    vec, rows, times = vec.contiguous(), rows.contiguous(), times.contiguous()
    dummy = torch.zeros(1)  # a valid pointer where an argument is empty
    w = warr.contiguous() if warr is not None else dummy
    out, zf = torch.empty_like(vin), torch.empty_like(z0)
    B, T = vin.shape
    ptr = [(x if x.numel() else dummy).data_ptr() for x in (vec, rows, times, w)]
    lib.circuit_host_run(vin.data_ptr(), z0.data_ptr(), out.data_ptr(), zf.data_ptr(), None,
                         B, T, *ptr)
    return out, zf


@torch.library.custom_op("diffwdf_torch::circuit_forward", mutates_args=())
def circuit_forward(source: str, host_source: str, vin: Tensor, z0: Tensor, vec: Tensor,
                    rows: Tensor, times: Tensor, warr: Optional[Tensor],
                    lanes: int) -> Tuple[Tensor, Tensor]:
    """B7: the generated forward of a program (``CircuitProgram.source`` and
    ``.host_source``) on its launch arguments (``fused_circuit.prepare``):
    vin (B, T), z0 (S, B) in the program's state order, the slots and the
    root array (or None) -> (out (B, T), z_final (S, B)), as
    ``fused_circuit.fused_circuit_process``; ``lanes`` the lanes per stream
    (``fused_circuit.lanes_for`` at the served B)."""
    if vin.device.type == "cpu":
        return host_run(host_source, vin, z0, vec, rows, times, warr)
    if vin.shape[0] == 0:
        return torch.empty_like(vin), z0.clone()
    out, zf, _ = fcirc.launch_source(source, vin, z0.contiguous(), vec, rows, times, warr,
                                     lanes=lanes)
    return out, zf


@circuit_forward.register_fake
def _(source, host_source, vin, z0, vec, rows, times, warr, lanes):
    return torch.empty_like(vin), torch.empty_like(z0)
