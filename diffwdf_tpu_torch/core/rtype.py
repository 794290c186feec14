"""R-type (rigid) N-port adaptors with derived scattering matrices (PyTorch).

The adaptor's internal linear (possibly active) network is described as a
tiny netlist (resistors and controlled sources), and the scattering matrix
is derived numerically at adaptation time.

Derivation (works even when the open-circuit impedance matrix doesn't exist,
e.g. floating op-amp input nodes): terminate every port p with its port
resistance R_p.  A port driven by incident wave a_p behaves exactly like a
resistive voltage source (V = a_p in series with R_p), because with
v = (a+b)/2 and i = (a-b)/(2 R_p) the source relation v = V - R i gives
a_p = V.  So:

1. stamp the internal network and all port resistors into one MNA system;
2. column j of the excitation: Norton current a_j / R_j into port j's
   nodes, with a_j = 1;
3. solve for the node voltages; port voltages V[i, j] follow, and
       S = 2 V - I          (from b = 2 v - a).

The adapted (root-facing) port-0 resistance is the Thevenin impedance seen
into port 0 with ports 1..k terminated (unit current injection, port 0's own
resistor omitted), which makes S[0,0] = 0 by construction.

``xp`` selects the array library: numpy for the float64 host bake
(``bake_static_scatter``, fixed component values), torch for the in-graph
derivation in the parameters' dtype (``make_netlist_scatter_fn``, with
``torch.linalg.solve``).  Either runs in the adaptation pass, outside the
sample loop.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime.profiler import h2d
from .elements import WDFNode


@dataclasses.dataclass(frozen=True)
class VCVS:
    """Voltage-controlled voltage source: v(out_p) - v(out_m) =
    gain * (v(ctrl_p) - v(ctrl_m)).  Node 0 is ground."""

    out_p: int
    out_m: int
    ctrl_p: int
    ctrl_m: int
    gain: float


@dataclasses.dataclass(frozen=True)
class Netlist:
    """Internal network of an R-type adaptor.

    n_nodes: node count excluding ground (nodes are 1..n_nodes; 0 = ground).
    resistors: (node_a, node_b, ohms) internal fixed resistors.
    vcvs: controlled sources (ideal-op-amp models use one VCVS + Ri + Ro).
    ports: (plus_node, minus_node) per port; port 0 is the adapted up-port.
    """

    n_nodes: int
    resistors: Tuple[Tuple[int, int, float], ...]
    vcvs: Tuple[VCVS, ...]
    ports: Tuple[Tuple[int, int], ...]


def _internal_mna(net: Netlist):
    """numpy stamps of the internal network: A0 [(n+m) x (n+m)] and the port
    incidence matrix inc [n x n_ports] (+1 plus node, -1 minus node)."""
    n, m = net.n_nodes, len(net.vcvs)
    A = np.zeros((n + m, n + m))
    for (na, nb, r) in net.resistors:
        g = 1.0 / r
        if na > 0:
            A[na - 1, na - 1] += g
        if nb > 0:
            A[nb - 1, nb - 1] += g
        if na > 0 and nb > 0:
            A[na - 1, nb - 1] -= g
            A[nb - 1, na - 1] -= g
    for k, s in enumerate(net.vcvs):
        col = n + k
        if s.out_p > 0:
            A[s.out_p - 1, col] += 1.0
        if s.out_m > 0:
            A[s.out_m - 1, col] -= 1.0
        row = n + k
        if s.out_p > 0:
            A[row, s.out_p - 1] += 1.0
        if s.out_m > 0:
            A[row, s.out_m - 1] -= 1.0
        if s.ctrl_p > 0:
            A[row, s.ctrl_p - 1] -= s.gain
        if s.ctrl_m > 0:
            A[row, s.ctrl_m - 1] += s.gain
    inc = np.zeros((n, len(net.ports)))
    for j, (p, q) in enumerate(net.ports):
        if p > 0:
            inc[p - 1, j] += 1.0
        if q > 0:
            inc[q - 1, j] -= 1.0
    return A, inc


def _const(x, like, xp):
    """numpy constant x as an array of xp, in like's dtype and device."""
    if xp is np:
        return np.asarray(x, np.float64)
    return torch.as_tensor(x, dtype=like.dtype, device=like.device)


def _stack(rs, xp):
    if xp is np:
        return np.asarray(rs, np.float64)
    if isinstance(rs, (list, tuple)):
        return torch.stack([torch.as_tensor(r) for r in rs])
    return torch.as_tensor(rs)


def _pad_square(x, size, xp):
    """x (n, n) zero-padded to (size, size)."""
    extra = size - x.shape[0]
    if xp is np:
        return np.pad(x, ((0, extra), (0, extra)))
    return torch.nn.functional.pad(x, (0, extra, 0, extra))


def _stamp_port_resistors(A0, inc, g_ports, xp, skip: Sequence[int] = ()):
    """A0 + sum_j g_j * inc_j inc_j^T (resistor across port j's nodes)."""
    A = _const(A0, g_ports, xp)
    for j in range(inc.shape[1]):
        if j in skip:
            continue
        col = _const(inc[:, j], g_ports, xp)
        A = A + g_ports[j] * _pad_square(xp.outer(col, col), A0.shape[0], xp)
    return A


def scattering_matrix(net: Netlist, r_ports, xp=torch):
    """S (b = S a) for the internal network with port resistances r_ports."""
    A0, inc = _internal_mna(net)
    g = 1.0 / _stack(r_ports, xp)
    A = _stamp_port_resistors(A0, inc, g, xp)
    # Norton sources: column j injects a_j / R_j = g_j at port j's nodes
    n, m = net.n_nodes, A0.shape[0] - net.n_nodes
    B = _const(np.concatenate([inc, np.zeros((m, inc.shape[1]))], axis=0), g, xp)
    B = B * g[None, :]
    X = xp.linalg.solve(A, B)
    V = _const(inc.T, g, xp) @ X[:n]
    return 2.0 * V - _const(np.eye(inc.shape[1]), g, xp)


def adapted_resistance(net: Netlist, r_rest, xp=torch):
    """Thevenin impedance into port 0, ports 1.. terminated by r_rest."""
    A0, inc = _internal_mna(net)
    r_rest = _stack(r_rest, xp)
    g = 1.0 / r_rest
    g = (np.concatenate([[1.0], g]) if xp is np
         else torch.cat([torch.ones(1, dtype=g.dtype, device=g.device), g]))
    A = _stamp_port_resistors(A0, inc, g, xp, skip=(0,))
    n, m = net.n_nodes, A0.shape[0] - net.n_nodes
    b = _const(np.concatenate([inc[:, 0], np.zeros((m,))]), g, xp)
    x = xp.linalg.solve(A, b)
    return _const(inc[:, 0], g, xp) @ x[:n]


def make_netlist_scatter_fn(net: Netlist) -> Callable:
    """Build s_fn(child_impedances) -> (S, Ra) from a netlist, derived with
    torch in the impedances' dtype.  Child impedances fill ports 1..k; the
    adapted port-0 resistance is derived."""

    def s_fn(child_rs):
        child = torch.stack([torch.as_tensor(r) for r in child_rs])
        ra = adapted_resistance(net, child, xp=torch)
        r_all = torch.cat([ra[None], child])
        S = scattering_matrix(net, r_all, xp=torch)
        return S, ra

    return s_fn


def bake_static_scatter(net: Netlist, child_rs: Sequence[float]):
    """Host-side float64 derivation for fixed component values; returns
    (S, Ra) rounded to float32 CPU tensors, the adapted coefficients of a
    static adaptor."""
    child = np.asarray(child_rs, np.float64)
    ra = float(adapted_resistance(net, child, xp=np))
    r_all = np.concatenate([[ra], child])
    S = scattering_matrix(net, r_all, xp=np)
    return (torch.as_tensor(S, dtype=torch.float32),
            torch.tensor(ra, dtype=torch.float32))


@dataclasses.dataclass(eq=False)
class RTypeAdaptor(WDFNode):
    """N-port rigid adaptor; port 0 faces the root, children fill ports 1..k.

    ``s_fn(child_rs) -> (S, Ra)`` supplies the scattering matrix; build one
    from a netlist with :func:`make_netlist_scatter_fn`, or pass
    ``static_s=(S, Ra)`` constants from :func:`bake_static_scatter`.
    """

    name: str
    ports: Tuple[WDFNode, ...] = ()
    s_fn: Optional[Callable] = None
    static_s: Optional[Tuple] = None
    #: static_s on each device it has been adapted on (copied once per device)
    _static_on: dict = dataclasses.field(default_factory=dict, init=False, repr=False)

    def __post_init__(self):
        self.children = tuple(self.ports)
        if (self.s_fn is None) == (self.static_s is None):
            raise ValueError("provide exactly one of s_fn / static_s")

    def adapt(self, params, controls, coeffs, fs):
        child_rs = [c.adapt(params, controls, coeffs, fs) for c in self.children]
        if self.static_s is not None:
            # on the children's device, so serving on a card copies S once
            device = torch.as_tensor(child_rs[0]).device
            if device not in self._static_on:
                self._static_on[device] = tuple(h2d(x, device, None)
                                                for x in self.static_s)
            S, ra = self._static_on[device]
        else:
            # keeps the incoming dtype (f32 serving, f64 oracle runs)
            S, ra = self.s_fn([torch.as_tensor(r) for r in child_rs])
        coeffs[self.name] = {"R": ra, "S": S}
        return ra

    def reflected(self, coeffs, state, controls, waves):
        bs = [c.reflected(coeffs, state, controls, waves) for c in self.children]
        S = coeffs[self.name]["S"]
        # port 0's incident wave is unknown on the way up; S[0,0] = 0 by
        # adaptation, so it contributes nothing here.  The sum starts from
        # Python's 0, as the JAX package's does.
        b0 = sum(S[0, j + 1] * bj for j, bj in enumerate(bs))
        return self._record_b(waves, b0)

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        S = coeffs[self.name]["S"]
        bs = [waves[c.name][1] for c in self.children]
        new = {}
        for i, c in enumerate(self.children):
            bi = S[i + 1, 0] * x
            for j, bj in enumerate(bs):
                bi = bi + S[i + 1, j + 1] * bj
            new.update(c.incident(coeffs, state, controls, waves, bi))
        return new
