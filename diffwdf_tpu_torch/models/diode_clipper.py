"""Diode clipper circuits (LPF and HPF topologies) and the root-model zoo.

- LPF clipper: ResistiveVoltageSource(R) || Capacitor(C), diode root on top,
  output = V(C); cutoff sets the source resistance R = 1/(2 pi f C).
- HPF clipper: Parallel(R, Series(Vs, C)), output = V(R).
- Training-side clipper: the same LPF tree with a per-sample driven source
  resistance (the "pot").

The root-model zoo lists the 12 switchable roots: analytic best/approx
quality plus neural MLPs loaded from the JSON model-zoo schema.  A "model
switch" is a different `Circuit` object over the same tree.
"""

from __future__ import annotations

import math
import os
from pathlib import Path
from typing import Optional, Tuple

import torch

from ..core.adaptors import Parallel, Series
from ..core.circuit import Circuit, Root
from ..core.elements import Capacitor, Device, Resistor, ResistiveVoltageSource
from ..nn.serialization import load_model_json
from ..roots.diode import DiodeConfig, DiodePairRoot, diode_1n4148_1u1d
from ..roots.neural import NeuralDiodeRoot

#: the checkout's root: relative zoo paths are resolved against it, so the
#: checked-in weights load from any working directory
_REPO_ROOT = Path(__file__).resolve().parents[2]


def cutoff_to_resistance(cutoff_hz: float, cap: float) -> float:
    """R = 1 / (2 pi f C) — the clipper's cutoff->source-R map."""
    return 1.0 / (2.0 * math.pi * cutoff_hz * cap)


def make_diode_clipper(
    root: Root,
    fs: float,
    r_source: float = 47.0e3,
    cap: float = 2.2e-9,
) -> Circuit:
    """LPF-topology diode clipper: Vs(R) || C with a nonlinear root.

    Controls: {"Vs": {"v": ...}} and optionally {"Vs": {"R": ...}} for a
    per-sample pot sweep.
    """
    vs = ResistiveVoltageSource("Vs", R=r_source)
    cc = Capacitor("C", C=cap)
    p1 = Parallel("P1", vs, cc)
    return Circuit(tree=p1, root=root, fs=fs, outputs=("C",))


def make_training_clipper(
    root: Root,
    fs: float,
    r_source: float = 45.0e3,
    cap: float = 4.7e-9,
) -> Circuit:
    """The measured-data training circuit: Vs(45k pot-driven) || C(4.7n)."""
    return make_diode_clipper(root, fs, r_source=r_source, cap=cap)


def make_hpf_diode_clipper(
    root: Root,
    fs: float,
    r_load: float = 47.0e3,
    cap: float = 2.2e-9,
) -> Circuit:
    """HPF-topology clipper: Parallel(R, Series(Vs, C)), output across R."""
    vs = ResistiveVoltageSource("Vs", R=1.0)
    cc = Capacitor("C", C=cap)
    s1 = Series("S1", vs, cc)
    rr = Resistor("R", r_load)
    p1 = Parallel("P1", rr, s1)
    return Circuit(tree=p1, root=root, fs=fs, outputs=("R",))


# ---------------------------------------------------------------------------
# Root-model zoo
# ---------------------------------------------------------------------------

#: (kind, spec) entries in the model-switch order
ZOO = (
    ("analytic", "best"),       # 0: TOMS917-equivalent root
    ("analytic", "low"),        # 1: fast approximation root
    ("neural", (2, 4)),         # 2
    ("neural", (2, 8)),         # 3
    ("neural", (2, 16)),        # 4
    ("neural", (4, 4)),         # 5
    ("neural", (4, 8)),         # 6
    ("neural", (2, 16)),        # 7:  1U-2D
    ("neural", (2, 16)),        # 8:  2U-2D
    ("neural", (2, 16)),        # 9:  1U-3D
    ("neural", (2, 16)),        # 10: 2U-3D
    ("neural", (2, 16)),        # 11: 3U-3D
)


def pretrained_model_path(n_layers: int, width: int,
                          config: str = "1U-1D") -> str:
    """Canonical checked-in pretrained-zoo artifact path for an NxH net,
    relative to the checkout's root."""
    return (f"models/pretrained/1N4148 ({config})_{n_layers}x{width}"
            "_pretrained_model.json")


#: zoo index -> (n_layers, width, diode config) of its default weights
_ZOO_NEURAL_SPECS = {
    2: (2, 4, "1U-1D"), 3: (2, 8, "1U-1D"), 4: (2, 16, "1U-1D"),
    5: (4, 4, "1U-1D"), 6: (4, 8, "1U-1D"),
    7: (2, 16, "1U-2D"), 8: (2, 16, "2U-2D"), 9: (2, 16, "1U-3D"),
    10: (2, 16, "2U-3D"), 11: (2, 16, "3U-3D"),
}
ZOO_MODEL_PATHS = {
    i: pretrained_model_path(n, w, cfg)
    for i, (n, w, cfg) in _ZOO_NEURAL_SPECS.items()
}


def _checkout_path(path: str) -> Path:
    return _REPO_ROOT / path


def make_neural_root_or_default(
    name: str,
    n_layers: int,
    width: int,
    json_path: Optional[str] = None,
    config: str = "1U-1D",
    *,
    device: Device,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Root, dict]:
    """NeuralDiodeRoot from ``json_path`` (missing explicit path = error),
    else the checked-in pretrained default for that size, else random init
    from ``generator``.  Returns (root, params_fragment)."""
    if json_path is not None:
        if not os.path.exists(json_path):
            raise FileNotFoundError(f"model JSON {json_path!r} not found")
        mlp, acts, _ = load_model_json(json_path, device=device)
        return NeuralDiodeRoot.from_mlp(name, mlp, acts)
    default = _checkout_path(pretrained_model_path(n_layers, width, config))
    if default.exists():
        mlp, acts, _ = load_model_json(default, device=device)
        return NeuralDiodeRoot.from_mlp(name, mlp, acts)
    root = NeuralDiodeRoot(name=name, n_layers=n_layers, layer_size=width)
    return root, root.init_params(device, generator)


def make_root_from_zoo(
    index: int,
    diode: DiodeConfig = diode_1n4148_1u1d,
    json_path: Optional[str] = None,
    name: str = "dp",
    *,
    device: Device,
    generator: Optional[torch.Generator] = None,
) -> Tuple[Root, dict]:
    """Build root #index of the zoo.  Neural entries load weights from
    ``json_path`` (reference-schema JSON) when given — a missing explicit
    path is an error, never a silent random net — else from the checked-in
    pretrained zoo (ZOO_MODEL_PATHS) when present, else random init from
    ``generator``.  Returns (root, params_fragment)."""
    kind, spec = ZOO[index]
    if kind == "analytic":
        root = DiodePairRoot(name=name, diode=diode, quality=spec)
        return root, root.init_params(device)
    n_layers, width = spec
    if json_path is not None:
        if not os.path.exists(json_path):
            raise FileNotFoundError(
                f"model JSON {json_path!r} for zoo entry {index} not found"
            )
        mlp, acts, _ = load_model_json(json_path, device=device)
        return NeuralDiodeRoot.from_mlp(name, mlp, acts)
    default = ZOO_MODEL_PATHS.get(index)
    if default is not None and _checkout_path(default).exists():
        mlp, acts, _ = load_model_json(_checkout_path(default), device=device)
        return NeuralDiodeRoot.from_mlp(name, mlp, acts)
    root = NeuralDiodeRoot(name=name, n_layers=n_layers, layer_size=width)
    return root, root.init_params(device, generator)
