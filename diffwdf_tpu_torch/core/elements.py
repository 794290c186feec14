"""One-port WDF elements, as pure functional tree nodes (PyTorch).

Every element is a *static tree-description object* whose methods are pure
functions over explicit dicts of tensors:

- ``params``  : {node name: {field: tensor}}   — component values
- ``state``   : {node name: {field: tensor}}   — reactive-element memory (z^-1)
- ``controls``: {node name: {field: tensor}}   — per-sample driven inputs (Vs, pot R)
- ``coeffs``  : {node name: {...}}             — impedances + scattering coefficients
                                                 produced by the adaptation pass
- ``waves``   : {node name: (a, b)}            — the wave trace of one sample step,
                                                 used for voltage/current probes

The tree structure is plain static Python; recursing over it issues a short
straight line of elementwise tensor ops per sample.  A batch of circuits is
written out as trailing tensor dimensions (state and controls broadcast), so
no per-element code knows about batching.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Tuple

import torch

Device = Any  # torch.device or a string such as "cpu" / "cuda"


def voltage(waves: Dict[str, Tuple[Any, Any]], name: str):
    """Voltage across element `name`: v = (a + b) / 2."""
    a, b = waves[name]
    return (a + b) * 0.5


def current(waves: Dict[str, Tuple[Any, Any]], coeffs: Dict[str, Any], name: str):
    """Current through element `name`: i = (a - b) / (2 R)."""
    a, b = waves[name]
    return (a - b) / (2.0 * coeffs[name]["R"])


def _scalar(value: float, device: Device) -> torch.Tensor:
    return torch.tensor(value, dtype=torch.float32, device=device)


class WDFNode:
    """Base class for all WDF tree nodes (elements and adaptors)."""

    #: names of control fields that change the port impedance when driven
    #: per-sample (e.g. a potentiometer's "R").  Used to decide whether the
    #: adaptation pass must run inside the sample loop.
    impedance_controls: Tuple[str, ...] = ()
    #: names of control fields that do NOT affect impedance (e.g. source "v").
    signal_controls: Tuple[str, ...] = ()

    name: str
    children: Tuple["WDFNode", ...] = ()

    # ---- parameter / state builders --------------------------------------
    def init_params(self, device: Device) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for c in self.children:
            out.update(c.init_params(device))
        own = self._own_params(device)
        if own:
            out[self.name] = own
        return out

    def init_state(self, device: Device) -> Dict[str, Dict[str, Any]]:
        out: Dict[str, Dict[str, Any]] = {}
        for c in self.children:
            out.update(c.init_state(device))
        own = self._own_state(device)
        if own:
            out[self.name] = own
        return out

    def _own_params(self, device: Device) -> Dict[str, Any]:
        return {}

    def _own_state(self, device: Device) -> Dict[str, Any]:
        return {}

    def param_constraints(self) -> Dict[str, Dict[str, Tuple[float, float]]]:
        """{name: {field: (lo, hi)}} clip bounds, applied after optimizer steps."""
        out: Dict[str, Dict[str, Tuple[float, float]]] = {}
        for c in self.children:
            out.update(c.param_constraints())
        own = self._own_constraints()
        if own:
            out[self.name] = own
        return out

    def _own_constraints(self) -> Dict[str, Tuple[float, float]]:
        return {}

    # ---- functional WDF protocol ----------------------------------------
    def adapt(self, params, controls, coeffs, fs) -> Any:
        """Bottom-up impedance adaptation.  Fills ``coeffs[self.name]``
        (must include key "R") and returns this node's port impedance."""
        raise NotImplementedError

    def reflected(self, coeffs, state, controls, waves) -> Any:
        """Up-traversal: compute the reflected wave b of this node (toward the
        root), recording (a=None placeholder, b) into ``waves``."""
        raise NotImplementedError

    def incident(self, coeffs, state, controls, waves, x) -> Dict[str, Dict[str, Any]]:
        """Down-traversal: accept incident wave ``x``; propagate to children.
        Returns the new state entries for this subtree."""
        raise NotImplementedError

    def _record_b(self, waves, b):
        waves[self.name] = (None, b)
        return b

    def _record_a(self, waves, a):
        _, b = waves[self.name]
        waves[self.name] = (a, b)


# ---------------------------------------------------------------------------
# Leaf elements
# ---------------------------------------------------------------------------


@dataclasses.dataclass(eq=False)
class Resistor(WDFNode):
    """WDF resistor: port impedance R, reflects nothing (b = 0)."""

    name: str
    R: float = 1.0e3
    trainable: bool = False

    children = ()
    impedance_controls = ("R",)

    def _own_params(self, device):
        return {"R": _scalar(self.R, device)}

    def _own_constraints(self):
        return {"R": (180.0, 1.0e6)} if self.trainable else {}

    def adapt(self, params, controls, coeffs, fs):
        R = controls.get(self.name, {}).get("R", params[self.name]["R"])
        coeffs[self.name] = {"R": R}
        return R

    def reflected(self, coeffs, state, controls, waves):
        # zero in the port impedance's dtype and device, so an f64 oracle
        # run stays f64 end to end
        return self._record_b(waves, torch.zeros_like(torch.as_tensor(coeffs[self.name]["R"])))

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        return {}


@dataclasses.dataclass(eq=False)
class Capacitor(WDFNode):
    """WDF capacitor via the bilinear transform: R = 1 / (2 C fs), one-sample
    memory z (b = z; incident stores z <- a)."""

    name: str
    C: float = 1.0e-6
    trainable: bool = False

    children = ()

    def _own_params(self, device):
        return {"C": _scalar(self.C, device)}

    def _own_state(self, device):
        return {"z": _scalar(0.0, device)}

    def _own_constraints(self):
        return {"C": (0.1e-12, 1.0)} if self.trainable else {}

    def adapt(self, params, controls, coeffs, fs):
        C = params[self.name]["C"]
        R = 1.0 / (2.0 * C * fs)
        coeffs[self.name] = {"R": R}
        return R

    def reflected(self, coeffs, state, controls, waves):
        return self._record_b(waves, state[self.name]["z"])

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        return {self.name: {"z": x}}


@dataclasses.dataclass(eq=False)
class Inductor(WDFNode):
    """WDF inductor via the bilinear transform: R = 2 L fs, b = -z, z <- a."""

    name: str
    L: float = 1.0e-3
    trainable: bool = False

    children = ()

    def _own_params(self, device):
        return {"L": _scalar(self.L, device)}

    def _own_state(self, device):
        return {"z": _scalar(0.0, device)}

    def adapt(self, params, controls, coeffs, fs):
        L = params[self.name]["L"]
        R = 2.0 * L * fs
        coeffs[self.name] = {"R": R}
        return R

    def reflected(self, coeffs, state, controls, waves):
        return self._record_b(waves, -state[self.name]["z"])

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        return {self.name: {"z": x}}


@dataclasses.dataclass(eq=False)
class ResistiveVoltageSource(WDFNode):
    """Voltage source with series resistance; matched port, so b = Vs.

    Controls: "v" (source voltage, per-sample) and optionally "R" (pot).
    """

    name: str
    R: float = 1.0e-9
    trainable: bool = False

    children = ()
    impedance_controls = ("R",)
    signal_controls = ("v",)

    def _own_params(self, device):
        return {"R": _scalar(self.R, device)}

    def adapt(self, params, controls, coeffs, fs):
        R = controls.get(self.name, {}).get("R", params[self.name]["R"])
        coeffs[self.name] = {"R": R}
        return R

    def reflected(self, coeffs, state, controls, waves):
        return self._record_b(waves, torch.as_tensor(controls[self.name]["v"]))

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        return {}


@dataclasses.dataclass(eq=False)
class ResistiveCurrentSource(WDFNode):
    """Current source with parallel resistance; matched port: b = Is * R.

    Controls: "i" (source current)."""

    name: str
    R: float = 1.0e9

    children = ()
    impedance_controls = ("R",)
    signal_controls = ("i",)

    def _own_params(self, device):
        return {"R": _scalar(self.R, device)}

    def adapt(self, params, controls, coeffs, fs):
        R = controls.get(self.name, {}).get("R", params[self.name]["R"])
        coeffs[self.name] = {"R": R}
        return R

    def reflected(self, coeffs, state, controls, waves):
        i = controls[self.name]["i"]
        return self._record_b(waves, i * coeffs[self.name]["R"])

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        return {}
