"""Circuit = adapted WDF tree + root nonlinearity, as pure step/process fns.

A circuit is described once as a static tree, and `Circuit` turns it into

- ``adapt(params, controls) -> coeffs``   impedance/scatter coefficients
- ``step(params, coeffs, state, controls) -> (state, waves)``  one audio sample
- ``process(params, state, inputs) -> (outputs, state)``  a loop over time

``process`` is the sequential oracle of the fused clipper kernels
(``diffwdf_tpu_torch.ops.fused_clipper``): it runs one sample at a time, each
sample a short chain of elementwise tensor ops, and autograd differentiates
through it.  A batch of circuits is carried as trailing tensor dimensions of
the controls and state (e.g. inputs ``{"Vs": {"v": (T, B)}}``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Sequence, Tuple

import torch

from .elements import Device, WDFNode, voltage


class Root:
    """Protocol for WDF root (unadapted) elements.

    ``reflect(a, R, params, controls)`` maps the incident wave collected at the
    top of the adapted tree (and the tree's port impedance R) to the reflected
    wave sent back down.  Pure function; params live under ``self.name``.
    """

    name: str = "root"

    def init_params(self, device: Device) -> Dict[str, Dict[str, Any]]:
        return {}

    def reflect(self, a, R, params, controls):
        raise NotImplementedError


@dataclasses.dataclass(eq=False)
class IdealVoltageSourceRoot(Root):
    """Ideal voltage source used as the tree root: b = -a + 2 Vs.
    Control field: "v"."""

    name: str = "Vs"

    def reflect(self, a, R, params, controls):
        return -a + 2.0 * controls[self.name]["v"]


@dataclasses.dataclass(eq=False)
class OpenCircuitRoot(Root):
    """Open circuit at the root: total reflection, b = a."""

    name: str = "open"

    def reflect(self, a, R, params, controls):
        return a


def _collect_impedance_controls(node: WDFNode, out: Dict[str, Tuple[str, ...]]):
    out[node.name] = tuple(node.impedance_controls)
    for c in node.children:
        _collect_impedance_controls(c, out)


@dataclasses.dataclass(eq=False)
class Circuit:
    """A complete WDF circuit: adapted tree + root + output probes.

    outputs: element names whose voltage is the circuit output (stacked on the
    last axis if more than one).
    """

    tree: WDFNode
    root: Root
    fs: float
    outputs: Sequence[str] = ()

    # ---- parameter / state dicts -----------------------------------------
    def init_params(self, device: Device) -> Dict[str, Any]:
        p = self.tree.init_params(device)
        p.update(self.root.init_params(device))
        return p

    def init_state(self, device: Device) -> Dict[str, Any]:
        return self.tree.init_state(device)

    def param_constraints(self):
        return self.tree.param_constraints()

    def constrain(self, params):
        """Clip params to their element bounds; returns a new dict."""
        out = dict(params)
        for name, fields in self.param_constraints().items():
            out[name] = dict(out[name])
            for f, (lo, hi) in fields.items():
                out[name][f] = torch.clamp(params[name][f], lo, hi)
        return out

    # ---- pure functions --------------------------------------------------
    def adapt(self, params, controls=None) -> Dict[str, Any]:
        coeffs: Dict[str, Any] = {}
        self.tree.adapt(params, controls or {}, coeffs, self.fs)
        return coeffs

    def step(self, params, coeffs, state, controls):
        """One sample: up-traversal, root solve, down-traversal."""
        waves: Dict[str, Any] = {}
        a_root = self.tree.reflected(coeffs, state, controls, waves)
        R_up = coeffs[self.tree.name]["R"]
        b_root = self.root.reflect(a_root, R_up, params, controls)
        new_entries = self.tree.incident(coeffs, state, controls, waves, b_root)
        new_state = {**state, **new_entries}
        waves[self.root.name] = (a_root, b_root)
        return new_state, waves

    def probe(self, waves):
        outs = [voltage(waves, n) for n in self.outputs]
        if len(outs) == 1:
            return outs[0]
        return torch.stack(outs, dim=-1)

    def needs_per_sample_adapt(self, inputs: Dict[str, Dict[str, Any]]) -> bool:
        imp: Dict[str, Tuple[str, ...]] = {}
        _collect_impedance_controls(self.tree, imp)
        for name, fields in inputs.items():
            for f in fields:
                if f in imp.get(name, ()):
                    return True
        return False

    def process(
        self,
        params,
        state,
        inputs: Dict[str, Dict[str, Any]],
        *,
        static_controls: Optional[Dict[str, Dict[str, Any]]] = None,
        adapt_per_sample: Optional[bool] = None,
    ):
        """Run the sample recursion over the leading time axis of ``inputs``.

        inputs: {node: {field: tensor[T, ...]}}.  Returns (outputs[T, ...],
        final_state).  If any driven field affects impedance (pot sweep), the
        adaptation pass runs every sample; otherwise it runs once.

        static_controls: {node: {field: scalar}} per-call (block-rate)
        controls, e.g. a cutoff-derived source resistance held for the
        block.  Impedance adaptation with them still runs once.
        """
        if adapt_per_sample is None:
            adapt_per_sample = self.needs_per_sample_adapt(inputs)
        static_controls = static_controls or {}

        def merge(controls_t):
            if not static_controls:
                return controls_t
            out = {k: dict(v) for k, v in static_controls.items()}
            for node, fields in controls_t.items():
                out.setdefault(node, {})
                out[node].update(fields)
            return out

        n_steps = {x.shape[0] for fields in inputs.values() for x in fields.values()}
        if len(n_steps) != 1:
            raise ValueError(f"inputs disagree on the time axis length: {sorted(n_steps)}")
        (n_steps,) = n_steps

        coeffs = None if adapt_per_sample else self.adapt(params, static_controls)
        outs = []
        for t in range(n_steps):
            ct = merge({node: {f: x[t] for f, x in fields.items()}
                        for node, fields in inputs.items()})
            coeffs_t = self.adapt(params, ct) if adapt_per_sample else coeffs
            state, waves = self.step(params, coeffs_t, state, ct)
            outs.append(self.probe(waves))
        return torch.stack(outs), state

    def __call__(self, params, state, inputs, **kw):
        return self.process(params, state, inputs, **kw)
