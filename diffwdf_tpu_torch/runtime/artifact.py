"""Compiled serving artifacts via ``torch.export``.

The reference's deploy path is: train in Python -> weights to JSON
(``wdf_py/lib/model_utils.py:82-85``) -> JSON baked into the plugin binary
(``plugin/src/CMakeLists.txt:16-34``) -> parsed by RTNeural at plugin load.
The point of that pipeline is a self-contained deployable artifact: the
serving side needs no training stack, just the artifact plus a fixed
runtime.

Here a circuit at fixed params is traced once into a block-processing
module, ``(state (S,), vin (block_len,)) -> (vout (block_len,), state
(S,))``, exported with ``torch.export`` and written, with its metadata and
initial state, as one file (``torch.export.save``'s archive).  The block is
served by the kernel that the scan engine of ``runtime/stream.py`` launches
for the circuit, held in the program as a custom op of ``ops.registry``:

- the LPF clipper with the analytic diode pair: ``clipper_analytic`` (B2);
- the LPF clipper with an NxH neural root: ``clipper_neural`` (B1);
- any other circuit the generator takes (the Tube Screamer, the HPF
  clipper, the RC lowpass, a root of another kind: an MLP outside the NxH
  family, such as a JSON model with relu layers, or a distilled root):
  ``circuit_forward`` (B7), its generated source an argument of the op.

The params and static controls are closed over: the weights, the adaptor
coefficients (the B7 slot vector) and the root's constants become constants
of the program, buffers that move with the module.  Loading needs the op
registry and no circuit, root or params object; the program runs on the
card, or on the CPU when asked (B1 and B2 through their plain versions, B7
through its host build).  A B7 artifact carries native code: serving it
compiles and runs the sources it holds, so load only trusted files
(:func:`load_artifact`).
"""

from __future__ import annotations

import dataclasses
import json
import zipfile
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
from torch import nn

from ..core.adaptors import Parallel
from ..core.circuit import Circuit
from ..core.elements import Capacitor, ResistiveVoltageSource
from ..ops import registry  # importing it registers the ops the programs call
from ..ops.circuit_codegen import state_order
from ..ops.fused_circuit import lanes_for, prepare
from ..roots.diode import DiodePairRoot
from .stream import _diode_pair_args, _host_floats, _kernel_nxh

FORMAT = "diffwdf-torch-artifact-v1"
_META, _STATE = "meta.json", "init_state.json"

_ops = torch.ops.diffwdf_torch


class _AnalyticBlock(nn.Module):
    """B2 at B = 1: the constants of ``_lpf_exact_runner`` as floats."""

    def __init__(self, consts, fs: float, iters: int):
        super().__init__()
        self.consts, self.fs, self.iters = tuple(consts), float(fs), int(iters)

    def forward(self, state, vin):
        out, zf = _ops.clipper_analytic(vin[None], state, *self.consts, self.fs, self.iters)
        return out[0], zf


class _NeuralBlock(nn.Module):
    """B1 at B = 1: the root's layers as buffers, R and C as floats."""

    def __init__(self, mlp, r_source: float, cap: float, fs: float):
        super().__init__()
        layers = registry.mlp_layers(mlp)
        for i, t in enumerate(layers):
            self.register_buffer(f"w{i}", t.detach().clone().float())
        self.n, self.r, self.cap, self.fs = len(layers), float(r_source), float(cap), float(fs)

    def forward(self, state, vin):
        layers = [getattr(self, f"w{i}") for i in range(self.n)]
        out, zf = _ops.clipper_neural(vin[None], state, layers, self.r, self.cap, self.fs)
        return out[0], zf


class _CircuitBlock(nn.Module):
    """B7 at B = 1: the generated program's sources and lanes, its slots and
    root array as buffers."""

    def __init__(self, prep, lanes: int):
        super().__init__()
        self.source, self.host_source, self.lanes = prep.prog.source, prep.prog.host_source, lanes
        self.register_buffer("vec", prep.vec.detach().clone())
        self.register_buffer("rows", prep.rows.detach().clone())
        self.register_buffer("times", prep.times.detach().clone())
        self.has_warr = prep.warr is not None
        self.register_buffer("warr", prep.warr.detach().clone() if self.has_warr else None)

    def forward(self, state, vin):
        out, zf = _ops.circuit_forward(self.source, self.host_source, vin[None], state[:, None],
                                       self.vec, self.rows, self.times,
                                       self.warr if self.has_warr else None, self.lanes)
        return out[0], zf[:, 0]


def _is_lpf_clipper(circuit: Circuit, input_node: str, input_field: str) -> bool:
    """Whether ``circuit`` is the LPF clipper Vs(R) || C probed at C and
    driven at Vs.v (``models.diode_clipper.make_diode_clipper``)."""
    tree = circuit.tree
    return (isinstance(tree, Parallel) and isinstance(tree.p1, ResistiveVoltageSource)
            and isinstance(tree.p2, Capacitor) and tree.p1.name == "Vs" and tree.p2.name == "C"
            and tuple(circuit.outputs) == ("C",) and (input_node, input_field) == ("Vs", "v"))


def _block_module(circuit: Circuit, params, input_node: str, input_field: str,
                  static_controls, device) -> Tuple[nn.Module, str]:
    """The block module of the kernel the scan engine serves ``circuit``
    with, and that kernel's name."""
    root = circuit.root
    if _is_lpf_clipper(circuit, input_node, input_field):
        if isinstance(root, DiodePairRoot):
            consts = _diode_pair_args(params, static_controls, root.name)
            return _AnalyticBlock(consts, circuit.fs, root.iters), "B2 clipper_analytic"
        if _kernel_nxh(root):
            r = (static_controls or {}).get("Vs", {}).get("R", params["Vs"]["R"])
            r, cap = _host_floats(r, params["C"]["C"])
            return _NeuralBlock(params[root.name], r, cap, circuit.fs), "B1 clipper_neural"
    if input_field != "v":
        raise ValueError(f"export_circuit: the generated kernel drives {input_node}.v, "
                         f"got {input_node}.{input_field}")
    prep = prepare(circuit, params, device, input_node=input_node,
                   static_controls=static_controls)
    return _CircuitBlock(prep, lanes_for(prep.prog, 1)), "B7 circuit_forward"


def _params_device(params) -> torch.device:
    stack = [params]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            return x.device
        if isinstance(x, dict):
            stack.extend(x.values())
        elif isinstance(x, (list, tuple)):
            stack.extend(x)
    return torch.device("cpu")


def export_circuit(
    circuit: Circuit,
    params,
    *,
    input_node: str = "Vs",
    input_field: str = "v",
    block_len: int = 2048,
    fs: Optional[float] = None,
    static_controls: Optional[Dict[str, Dict[str, Any]]] = None,
):
    """Trace ``circuit`` at fixed ``params`` into an exported program on the
    params' device.

    Params and static controls are closed over (constants of the program).
    State is a flat (S,) f32 tensor in the sorted (node, field) order of the
    circuit's state, so the artifact describes itself without a state
    dict.  Returns (exported program, meta, initial state leaves).
    """
    device = _params_device(params)
    order = state_order(circuit)
    state0 = circuit.init_state("cpu")
    leaves = tuple(np.asarray(state0[node][field].detach().cpu().numpy(), np.float32)
                   for node, field in order)
    module, kernel = _block_module(circuit, params, input_node, input_field, static_controls,
                                   device)
    example = (torch.zeros(len(order), device=device),
               torch.zeros(int(block_len), device=device))
    ep = torch.export.export(module, example)
    meta = {
        "format": FORMAT,
        "block_len": int(block_len),
        "fs": fs,
        "n_state": len(order),
        "state_order": [list(k) for k in order],
        "input_node": input_node,
        "kernel": kernel,
        "exported_on": device.type,
        "torch_version": torch.__version__,
    }
    return ep, meta, leaves


def save_artifact(path: str, circuit: Circuit, params, **kw) -> Dict[str, Any]:
    """Export ``circuit`` and write one artifact file: the exported program
    (``torch.export.save``) with the meta JSON and the initial state."""
    ep, meta, leaves = export_circuit(circuit, params, **kw)
    state = json.dumps([float(x) for x in leaves])
    torch.export.save(ep, path, extra_files={_META: json.dumps(meta), _STATE: state})
    return meta


@dataclasses.dataclass
class ServingArtifact:
    """A loaded artifact: the block program on its device and its initial state."""

    meta: Dict[str, Any]
    init_state: Tuple[np.ndarray, ...]
    _module: Any
    device: torch.device

    @property
    def block_len(self) -> int:
        return int(self.meta["block_len"])

    def process(self, state: Tuple, vin) -> Tuple[torch.Tensor, Tuple]:
        """One block: (state, vin[block_len]) -> (vout[block_len], state),
        tensors on the artifact's device."""
        st = [torch.as_tensor(s, dtype=torch.float32, device=self.device).reshape(())
              for s in state]
        st = torch.stack(st) if st else torch.zeros(0, device=self.device)
        v = torch.as_tensor(vin, dtype=torch.float32, device=self.device)
        out, st2 = self._module(st, v)
        return out, tuple(st2.unbind(0))

    def run(self, vin) -> np.ndarray:
        """Convenience: stream a full signal (padded to whole blocks)."""
        vin = np.asarray(vin, np.float32)
        n, bl = vin.shape[0], self.block_len
        vin = np.pad(vin, (0, (-n) % bl))
        state = self.init_state
        outs = []
        for i in range(0, vin.shape[0], bl):
            y, state = self.process(state, vin[i: i + bl])
            outs.append(y.cpu().numpy())
        return np.concatenate(outs)[:n]


def _read_meta(path: str) -> Dict[str, Any]:
    """The meta of an artifact file; refuses any other file by name."""
    try:
        with zipfile.ZipFile(path) as z:
            names = z.namelist()
            ours = [n for n in names if n.split("/")[-1] == _META and "/extra/" in f"/{n}"]
            if ours:
                return json.loads(z.read(ours[0]))
            if "meta.npy" in names:
                with z.open("meta.npy") as f:
                    fmt = json.loads(str(np.lib.format.read_array(f))).get("format")
                raise ValueError(f"not a {FORMAT} file: {path} is a {fmt} file (the JAX "
                                 "package's StableHLO artifact, diffwdf_tpu.runtime.artifact)")
    except zipfile.BadZipFile:
        pass
    raise ValueError(f"not a {FORMAT} file: {path}")


def load_artifact(path: str, device="cuda") -> ServingArtifact:
    """Load an artifact written by :func:`save_artifact` onto ``device``
    (the card by default; "cpu" runs B1 and B2's plain versions and B7's
    host build).  Needs no circuit definition: the program is
    self-contained.  Raises where CUDA is asked for and absent.

    Load only artifacts from a trusted source, as with a pickle: a B7
    artifact holds the generated CUDA and host C++ sources as arguments of
    ``circuit_forward``, and serving it compiles that code (nvcc on the
    card, the host ``c++`` on the CPU) and runs it in this process."""
    meta = _read_meta(path)
    if meta.get("format") != FORMAT:
        raise ValueError(f"not a {FORMAT} file: {path} (format {meta.get('format')!r})")
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("load_artifact: device cuda asked for, and no CUDA device is "
                           "available (pass device='cpu' to serve on the CPU)")
    extra = {_META: "", _STATE: ""}
    ep = torch.export.load(path, extra_files=extra)
    leaves = tuple(np.float32(x) for x in json.loads(extra[_STATE]))
    module = ep.module().to(device)
    return ServingArtifact(meta=meta, init_state=leaves, _module=module, device=device)
