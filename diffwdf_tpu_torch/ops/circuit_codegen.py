"""Generate the CUDA C++ source of one fused kernel for a WDF `Circuit`.

The kernel runs a circuit's whole sample recursion for a batch of streams,
one thread per stream (``ops.fused_circuit``).  Its per-sample step is
generated by **tracing** the circuit's own pure step: the tree's
``reflected`` / ``incident`` methods (``core``) run once on symbolic scalars
(``Sym``) that write each operation as one line of C, so the scatter algebra
has one source of truth, as the Pallas kernel has when it traces
``circuit.step``.  Each traced operation is emitted as a round-to-nearest
intrinsic (``__fmul_rn``, ``__fadd_rn``, ...), which nvcc never contracts
into an FMA, so the tree's algebra rounds exactly as the plain version's
separate torch operations do (the Tube Screamer's op-amp scatter amplifies
any difference).  The root is not traced: each root kind has an emitter
that calls its device code (``csrc/omega.cuh``, ``nxh_mlp.cuh``,
``cheb.cuh``) and a plain PyTorch twin of the same math.

What the source depends on: the tree's topology and node names, the root's
kind and shape (the omega iteration count; the MLP's H and L; the Chebyshev
degrees) and the shapes of the coefficients.  Never on a value: every
component value reaches the kernel at launch, so moving a pot (the Tube
Screamer's drive, R6) or any component is a new argument, not a new build.

Launch arguments, in fixed orders:

- **State slots**: the circuit's state entries sorted by (node name, field),
  as ``(S, B)`` arrays; ``z[k]`` in the step.
- **Coefficient vector** (f32, ``c[i]`` in the step): the leaves of the
  adapted coeffs, then of the params (without the root's fragment), then of
  the static controls, each dict in sorted key order; a scalar takes one
  slot, a matrix of at most 64 entries (the R-type S) its entries row-major.
  Then the root's own slots (the diode pair's seven constants).
- **Root array** (f32, staged to shared memory, ``w`` in the step): the NxH
  weights with log R folded into the first bias, or the Chebyshev segments
  and coefficients.

Supported node classes: ``Resistor``, ``Capacitor``, ``Inductor``,
``ResistiveVoltageSource``, ``ResistiveCurrentSource``, ``Series``,
``Parallel``, ``Inverter``, ``RTypeAdaptor``; roots: ``DiodePairRoot``,
``NeuralDiodeRoot`` (all-tanh NxH, linear head), ``PiecewiseChebRoot``,
``IdealVoltageSourceRoot``, ``OpenCircuitRoot``.  Anything else raises
``NotImplementedError`` naming it.  One output probe.

The step is emitted as a ``__device__`` function of plain C
(``CircuitProgram.step_source``; ``__device__`` because the root headers'
functions are device functions), so the CPU tests compile it with the host
compiler, the CUDA qualifiers defined away, and drive it through
``CircuitProgram.host_source``.
"""

from __future__ import annotations

import dataclasses
import math
import re
import weakref
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.adaptors import Inverter, Parallel, Series
from ..core.circuit import Circuit, IdealVoltageSourceRoot, OpenCircuitRoot
from ..core.elements import (
    Capacitor,
    Inductor,
    Resistor,
    ResistiveCurrentSource,
    ResistiveVoltageSource,
    Symbolic,
)
from ..core.rtype import RTypeAdaptor
from ..roots.diode import DiodePairRoot
from ..roots.distilled import PiecewiseChebRoot, cheb_eval
from ..roots.neural import NeuralDiodeRoot
from .fused_clipper import (
    _nxh_layers,
    cheb_arguments,
    cheb_parameters,
    cheb_root_ops,
    diode_pair_root,
    nxh_mlp,
)

#: node classes whose reflected/incident methods trace into the step
NODE_CLASSES = (Resistor, Capacitor, Inductor, ResistiveVoltageSource, ResistiveCurrentSource,
                Series, Parallel, Inverter, RTypeAdaptor)
#: matrix coefficients up to 8x8 take slots (the R-type S)
MAX_MATRIX = 64


# ---------------------------------------------------------------------------
# Symbolic scalars
# ---------------------------------------------------------------------------


_WORD = re.compile(r"\b\w+\b")


def _literal(v: float) -> str:
    f = float(np.float32(v))
    if not math.isfinite(f):
        raise ValueError(f"circuit step has a non-finite constant {v!r}")
    text = repr(f) + "f"
    return f"({text})" if f < 0 else text


class _Trace:
    """The lines of one step, in order, each with its operation count."""

    def __init__(self):
        self.entries: List[Tuple[Optional[str], str, int]] = []  # (name, line, ops)
        self._n = 0

    def let(self, expr: str, ops: int, prefix: str = "t") -> "Sym":
        name = f"{prefix}{self._n}"
        self._n += 1
        self.entries.append((name, f"const float {name} = {expr};", ops))
        return Sym(self, name)

    def raw(self, line: str) -> None:
        """A line kept as it is (a comment, a root's own statement)."""
        self.entries.append((None, line, 0))

    def const(self, v) -> "Sym":
        return Sym(self, _literal(v), float(np.float32(v)))

    def live(self, uses: str) -> Tuple[List[str], int]:
        """The lines the code ``uses`` needs, in order, and their operation
        count: a named line whose value nothing reads (a wave sent into a
        source or resistor) is dropped."""
        needed = set(_WORD.findall(uses))
        kept = []
        for name, line, ops in reversed(self.entries):
            if name is None or name in needed:
                kept.append((line, ops))
                needed.update(_WORD.findall(line))
        kept.reverse()
        return [line for line, _ in kept], sum(ops for _, ops in kept)


class Sym(Symbolic):
    """A float of the step: a C expression (a slot, a temporary or a
    literal).  Arithmetic emits one line per operation, as an uncontracted
    round-to-nearest intrinsic; additions of 0 and multiplications by 0 or 1
    fold away (exact for finite values)."""

    def __init__(self, trace: _Trace, ref: str, value: Optional[float] = None):
        self.trace, self.ref, self.value = trace, ref, value

    def zeros_like(self) -> "Sym":
        return self.trace.const(0.0)

    def _sym(self, other) -> "Sym":
        if isinstance(other, Sym):
            return other
        if isinstance(other, (int, float, np.floating)) and not isinstance(other, bool):
            return self.trace.const(other)
        raise TypeError(f"cannot trace an operation with {type(other).__name__}")

    def __add__(self, o):
        return _binary(self, self._sym(o), "+")

    def __radd__(self, o):
        return _binary(self._sym(o), self, "+")

    def __sub__(self, o):
        return _binary(self, self._sym(o), "-")

    def __rsub__(self, o):
        return _binary(self._sym(o), self, "-")

    def __mul__(self, o):
        return _binary(self, self._sym(o), "*")

    def __rmul__(self, o):
        return _binary(self._sym(o), self, "*")

    def __truediv__(self, o):
        return _binary(self, self._sym(o), "/")

    def __rtruediv__(self, o):
        return _binary(self._sym(o), self, "/")

    def __neg__(self):
        if self.value is not None:
            return self.trace.const(-self.value)
        return self.trace.let(f"-{self.ref}", 0)  # a sign flip rides on its consumer


_FOLD = {"+": np.add, "-": np.subtract, "*": np.multiply, "/": np.divide}
#: round-to-nearest intrinsics: nvcc never contracts them into FMAs, so the
#: traced algebra rounds as the plain version's separate operations do
_INTRINSIC = {"+": "__fadd_rn", "-": "__fsub_rn", "*": "__fmul_rn", "/": "__fdiv_rn"}


def _binary(x: Sym, y: Sym, op: str) -> Sym:
    tr = x.trace
    if x.value is not None and y.value is not None:
        return tr.const(_FOLD[op](np.float32(x.value), np.float32(y.value)))
    if op == "+" and x.value == 0.0:
        return y
    if op in "+-" and y.value == 0.0:
        return x
    if op == "-" and x.value == 0.0:
        return -y
    if op == "*" and 0.0 in (x.value, y.value):
        return tr.const(0.0)
    if op == "*" and x.value == 1.0:
        return y
    if op in "*/" and y.value == 1.0:
        return x
    return tr.let(f"{_INTRINSIC[op]}({x.ref}, {y.ref})", 1)


class Matrix:
    """A small matrix of scalars (symbols or 0-d tensors) with the ``S[i, j]``
    indexing the adaptors use."""

    def __init__(self, rows):
        self.rows = rows

    def __getitem__(self, ij):
        i, j = ij
        return self.rows[i][j]


# ---------------------------------------------------------------------------
# Slot layout
# ---------------------------------------------------------------------------


def _leaves(tree, prefix=()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) of a nested dict, keys in sorted order."""
    if isinstance(tree, dict):
        return [kv for k in sorted(tree) for kv in _leaves(tree[k], prefix + (k,))]
    return [(prefix, tree)]


def _shape(leaf) -> Tuple[int, ...]:
    shape = tuple(torch.as_tensor(leaf).shape)
    n = int(np.prod(shape)) if shape else 1
    if n == 1:
        return ()
    if len(shape) == 2 and n <= MAX_MATRIX:
        return shape
    raise ValueError(
        f"fused_circuit: unsupported coefficient shape {shape}: scalars and matrices of at "
        f"most {MAX_MATRIX} entries only (per-row and per-sample pot streams are ROADMAP B8)")


def _nest(items) -> dict:
    """Rebuild a nested dict from (path, value) pairs."""
    out: dict = {}
    for path, value in items:
        d = out
        for k in path[:-1]:
            d = d.setdefault(k, {})
        d[path[-1]] = value
    return out


def _bundle(circuit: Circuit, coeffs, params, static_controls):
    """The (coeffs, params without the root's fragment, static controls)
    triple whose leaves fill the coefficient vector."""
    tree_params = {k: v for k, v in params.items() if k != circuit.root.name}
    return {"coeffs": coeffs, "params": tree_params, "static": static_controls or {}}


# ---------------------------------------------------------------------------
# Root emitters
# ---------------------------------------------------------------------------


class _RootEmitter:
    """How a root kind enters the step: header, slots, root array, C lines,
    operation count, and the plain PyTorch twin of the same math."""

    headers: Tuple[str, ...] = ()
    n_slots = 0
    ops = 0

    def key(self) -> tuple:
        return (type(self).__name__,)

    def slots(self, r_up, params) -> List[torch.Tensor]:
        return []

    def array(self, r_up, params, device) -> Optional[torch.Tensor]:
        return None

    def emit(self, tr: _Trace, a: Sym, r_up: Sym, slots: List[Sym], controls, params) -> Sym:
        raise NotImplementedError

    def plain(self, a, r_up, slots, array, controls, params):
        raise NotImplementedError


class _TracedRoot(_RootEmitter):
    """A root whose ``reflect`` is arithmetic on its inputs
    (IdealVoltageSourceRoot, OpenCircuitRoot): traced like the tree."""

    def __init__(self, root):
        self.root = root

    def key(self):
        return (type(self.root).__name__,)

    def emit(self, tr, a, r_up, slots, controls, params):
        return self.root.reflect(a, r_up, params, controls)

    def plain(self, a, r_up, slots, array, controls, params):
        return self.root.reflect(a, r_up, params, controls)


class _DiodePairEmitter(_RootEmitter):
    """Asymmetric diode pair (Werner eqn 45) with the real-line omega of
    omega.cuh; slots: log(R Is / (n_up Vt)), log(R Is / (n_down Vt)),
    1 / (n_up Vt), 1 / (n_down Vt), 2 Vt, n_up, n_down (Vt = nabla Vt),
    computed in double from the adapted R and rounded to f32.  The lines
    around omega round as ``diode_pair_root`` does (uncontracted)."""

    headers = ("omega.cuh",)
    n_slots = 7

    def __init__(self, root: DiodePairRoot):
        self.name, self.iters = root.name, int(root.iters)
        # sign 3, compare 1, six selects, |a| 1, two omega arguments 4,
        # b = a - 2Vt lam (mu0 w0 - mu1 w1) 6; omega: region guess 10 and
        # 6 per Newton step (counted from omega.cuh)
        self.ops = 21 + 2 * (10 + 6 * self.iters)

    def key(self):
        return ("DiodePairRoot", self.iters)

    def slots(self, r_up, params):
        p = {k: torch.as_tensor(v).double() for k, v in params[self.name].items()}
        r = torch.as_tensor(r_up).double().to(p["Is"].device)
        vte = p["nabla"] * p["Vt"]
        n_up, n_dn = p["N_up"], p["N_down"]
        return [torch.log(r * p["Is"] / (n_up * vte)), torch.log(r * p["Is"] / (n_dn * vte)),
                1.0 / (n_up * vte), 1.0 / (n_dn * vte), 2.0 * vte, n_up, n_dn]

    def emit(self, tr, a, r_up, slots, controls, params):
        log_up, log_dn, inv_up, inv_dn, two_vt, n_up, n_dn = (s.ref for s in slots)
        x = a.ref
        for line in [
            f"// root: asymmetric diode pair, omega.cuh with {self.iters} Newton iterations",
            f"const float d_lam = sign0({x});",
            f"const bool d_pos = {x} >= 0.f;",
            f"const float d_mu0 = d_pos ? {n_dn} : {n_up};",
            f"const float d_mu1 = d_pos ? {n_up} : {n_dn};",
            f"const float d_log0 = d_pos ? {log_dn} : {log_up};",
            f"const float d_log1 = d_pos ? {log_up} : {log_dn};",
            f"const float d_inv0 = d_pos ? {inv_dn} : {inv_up};",
            f"const float d_inv1 = d_pos ? {inv_up} : {inv_dn};",
            f"const float d_la = __fmul_rn(d_lam, {x});",
            f"const float d_w0 = omega(__fadd_rn(d_log0, __fmul_rn(d_la, d_inv0)), {self.iters});",
            f"const float d_w1 = omega(__fsub_rn(d_log1, __fmul_rn(d_la, d_inv1)), {self.iters});",
            f"const float d_mw = __fsub_rn(__fmul_rn(d_mu0, d_w0), __fmul_rn(d_mu1, d_w1));",
        ]:
            tr.raw(line)
        return tr.let(f"__fsub_rn({x}, __fmul_rn(__fmul_rn({two_vt}, d_lam), d_mw))", self.ops,
                      "root")

    def plain(self, a, r_up, slots, array, controls, params):
        return diode_pair_root(a, *slots, self.iters)


class _NeuralEmitter(_RootEmitter):
    """NxH all-tanh MLP with a linear head, b = -MLP([a, log R]), through
    nxh_mlp.cuh; root array: w1a[H], c1[H] (log R folded in), w3[H], b3,
    then per hidden layer W[H][H] and bias[H] (fused_clipper.cu's layout)."""

    headers = ("nxh_mlp.cuh",)

    def __init__(self, name: str, mlp_params, activations: Sequence[str]):
        acts = tuple(activations)
        if acts and (set(acts[:-1]) != {"tanh"} or acts[-1] not in ("", "linear")):
            raise ValueError(
                "the fused circuit kernel takes all-tanh hidden layers with a linear head "
                f"only; root {name!r} has activations {acts}")
        self.mlp = mlp_params
        self.H, _, _, hidden, _, _ = _nxh_layers(mlp_params)
        self.L = len(hidden)
        # first layer FMA + tanh, hidden H x H FMAs + bias + tanh, head FMAs
        self.ops = 3 * self.H + self.L * (2 * self.H * self.H + 2 * self.H) + 2 * self.H

    def key(self):
        return ("NeuralDiodeRoot", self.H, self.L)

    def _weights(self, r_up):
        H, W1, b1, hidden, w3, b3 = _nxh_layers(self.mlp)
        log_r = torch.log(torch.as_tensor(r_up).double()).float().to(W1.device)
        return W1[0], W1[1] * log_r + b1, hidden, w3, b3

    def array(self, r_up, params, device):
        w1a, c1, hidden, w3, b3 = self._weights(r_up)
        parts = [w1a, c1, w3, b3] + [x.reshape(-1) for layer in hidden for x in layer]
        return torch.cat([p.detach().to(device, torch.float32) for p in parts])

    def emit(self, tr, a, r_up, slots, controls, params):
        H = self.H
        tr.raw(f"// root: NxH MLP, H = {H}, {self.L} hidden layers (nxh_mlp.cuh)")
        return tr.let(f"-nxh_forward<{H}>({a.ref}, w, w + {H}, w + {3 * H + 1}, {self.L}, "
                      f"w + {2 * H}, w[{3 * H}])", self.ops, "root")

    def plain(self, a, r_up, slots, array, controls, params):
        w1a, c1, hidden, w3, b3 = self._weights(r_up)
        return -nxh_mlp(a, w1a, c1, hidden, w3, b3)


class _ChebEmitter(_RootEmitter):
    """Distilled piecewise-odd Chebyshev root through cheb.cuh; root array:
    cheb_parameters' layout; the segment count and padded degree go into the
    source."""

    headers = ("cheb.cuh",)

    def __init__(self, root: PiecewiseChebRoot):
        self.root = root
        _, self.padded = cheb_parameters(root)
        self.degrees = tuple(len(c) - 1 for c in root.coeffs)
        self.ops = cheb_root_ops(len(self.degrees), self.padded)

    def key(self):
        return ("PiecewiseChebRoot", self.degrees)

    def array(self, r_up, params, device):
        return cheb_arguments(self.root, device)[0]

    def emit(self, tr, a, r_up, slots, controls, params):
        degrees = ", ".join(map(str, self.degrees))
        tr.raw(f"// root: distilled piecewise Chebyshev, degrees {degrees} (cheb.cuh)")
        return tr.let(f"cheb_root<{self.padded}>({a.ref}, w, {len(self.degrees)})", self.ops,
                      "root")

    def plain(self, a, r_up, slots, array, controls, params):
        root = self.root
        return cheb_eval(a, float(root.a_max), tuple(float(b) for b in root.breaks), root.coeffs)


def root_emitter(circuit: Circuit, params, neural_mlp=None) -> _RootEmitter:
    """The emitter of the circuit's root (an NxH MLP replaces it when
    ``neural_mlp`` is given, as ``fused_circuit_process_neural`` does)."""
    root = circuit.root
    if neural_mlp is not None:
        return _NeuralEmitter(root.name, neural_mlp, getattr(root, "activations", ()))
    if type(root) is DiodePairRoot:
        return _DiodePairEmitter(root)
    if type(root) is NeuralDiodeRoot:
        return _NeuralEmitter(root.name, params[root.name], root.activations)
    if type(root) is PiecewiseChebRoot:
        return _ChebEmitter(root)
    if type(root) in (IdealVoltageSourceRoot, OpenCircuitRoot):
        return _TracedRoot(root)
    raise NotImplementedError(
        f"fused_circuit: no kernel rule for root {root.name!r} of class {type(root).__name__}")


# ---------------------------------------------------------------------------
# The step, traced or plain
# ---------------------------------------------------------------------------


def step(circuit: Circuit, coeffs, state, controls, root_fn: Callable):
    """One sample of the circuit (``Circuit.step`` with the root replaced by
    ``root_fn(a, R_up, controls)``): returns (new state, output)."""
    waves: Dict[str, Any] = {}
    a = circuit.tree.reflected(coeffs, state, controls, waves)
    b = root_fn(a, coeffs[circuit.tree.name]["R"], controls)
    new_entries = circuit.tree.incident(coeffs, state, controls, waves, b)
    waves[circuit.root.name] = (a, b)
    return {**state, **new_entries}, circuit.probe(waves)


def _check_tree(node) -> None:
    if type(node) not in NODE_CLASSES:
        raise NotImplementedError(
            f"fused_circuit: no kernel rule for node {node.name!r} of class {type(node).__name__}")
    for c in node.children:
        _check_tree(c)


def _describe(node) -> str:
    if not node.children:
        return node.name
    return f"{node.name}({', '.join(_describe(c) for c in node.children)})"


@dataclasses.dataclass(frozen=True)
class CircuitProgram:
    """The generated kernel of one circuit structure and its launch layout."""

    source: str            # the whole .cu: step, kernel, launch function
    step_source: str       # includes and the per-sample step
    host_source: str       # step_source and a host loop (tests)
    state_order: Tuple[Tuple[str, str], ...]
    layout: Tuple[Tuple[Tuple[str, ...], Tuple[int, ...]], ...]
    n_coeffs: int          # slots, the root's included
    ops_per_sample: int    # counted from the emitted step
    emitter: Any

    def coefficients(self, circuit: Circuit, coeffs, params, static_controls, device):
        """The f32 coefficient vector on ``device``."""
        leaves = _leaves(_bundle(circuit, coeffs, params, static_controls))
        parts = [torch.as_tensor(v).reshape(-1).to(device, torch.float32) for _, v in leaves]
        r_up = coeffs[circuit.tree.name]["R"]
        parts += [torch.as_tensor(s).reshape(1).to(device, torch.float32)
                  for s in self.emitter.slots(r_up, params)]
        return torch.cat(parts) if parts else torch.zeros(1, device=device)

    def unflatten(self, vec: torch.Tensor):
        """(coeffs, params, static controls, root slots) rebuilt from the
        vector as 0-d tensors and ``Matrix`` entries: the values the kernel
        gets."""
        items, i = [], 0
        for path, shape in self.layout:
            if shape:
                r, c = shape
                items.append((path, Matrix([[vec[i + a * c + b] for b in range(c)]
                                            for a in range(r)])))
                i += r * c
            else:
                items.append((path, vec[i]))
                i += 1
        tree = _nest(items)
        slots = [vec[i + k] for k in range(self.emitter.n_slots)]
        return (tree.get("coeffs", {}), tree.get("params", {}), tree.get("static", {}), slots)


def _layout(circuit, coeffs, params, static_controls):
    return tuple((path, _shape(v)) for path, v in
                 _leaves(_bundle(circuit, coeffs, params, static_controls)))


def generate(circuit: Circuit, coeffs, params, static_controls, input_node: str,
             emitter: _RootEmitter) -> CircuitProgram:
    """Trace ``circuit``'s step into a CircuitProgram.  ``coeffs`` (the
    adapted coefficients), ``params`` and ``static_controls`` give the slot
    layout by their shapes; their values are not read."""
    _check_tree(circuit.tree)
    if len(circuit.outputs) != 1:
        raise ValueError(f"fused_circuit: one output probe, got {tuple(circuit.outputs)}")
    layout = _layout(circuit, coeffs, params, static_controls)
    state_order = tuple((node, field) for (node, field), _ in
                        _leaves(circuit.init_state("cpu")))

    tr = _Trace()
    items, slot, slot_names = [], 0, []
    for path, shape in layout:
        name = ".".join(path)
        if shape:
            r, c = shape
            items.append((path, Matrix([[Sym(tr, f"c[{slot + a * c + b}]") for b in range(c)]
                                        for a in range(r)])))
            slot_names.append(f"c[{slot}..{slot + r * c - 1}] {name} ({r}x{c}, row-major)")
            slot += r * c
        else:
            items.append((path, Sym(tr, f"c[{slot}]")))
            slot_names.append(f"c[{slot}] {name}")
            slot += 1
    root_slots = [Sym(tr, f"c[{slot + k}]") for k in range(emitter.n_slots)]
    if emitter.n_slots:
        slot_names.append(f"c[{slot}..{slot + emitter.n_slots - 1}] root constants")
    tree = _nest(items)
    coeffs_s, params_s, static_s = (tree.get(k, {}) for k in ("coeffs", "params", "static"))

    state = _nest([((node, field), Sym(tr, f"s{k}")) for k, (node, field) in
                   enumerate(state_order)])
    controls = {k: dict(v) for k, v in static_s.items()}
    controls.setdefault(input_node, {})["v"] = Sym(tr, "v")
    new_state, out = step(
        circuit, coeffs_s, state, controls,
        lambda a, r_up, ctl: emitter.emit(tr, a, r_up, root_slots, ctl, params_s))
    out = out if isinstance(out, Sym) else tr.const(float(out))
    n_state = len(state_order)
    n_coeffs = slot + emitter.n_slots
    writes = [f"z[{k}] = {new_state[node][field].ref};"
              for k, (node, field) in enumerate(state_order)]
    reads = [f"const float s{k} = z[{k}];" for k in range(n_state)]
    lines, ops = tr.live(" ".join(writes + [out.ref]))

    headers = "".join(f'#include "{h}"\n' for h in emitter.headers)
    body = "\n".join("  " + line for line in reads + lines + writes)
    comment = "\n".join(
        [f"// Tree: {_describe(circuit.tree)}; root {type(circuit.root).__name__} "
         f"{emitter.key()[1:]}; output V({circuit.outputs[0]}); input {input_node}.v",
         "// State slots: " + ", ".join(f"z[{k}] {n}.{f}" for k, (n, f) in
                                        enumerate(state_order)),
         f"// Coefficient slots ({n_coeffs}):"]
        + [f"//   {s}" for s in slot_names]
        + [f"// Operations per sample (counted from this step): {ops}"])
    step_source = f"""\
// Generated by diffwdf_tpu_torch.ops.circuit_codegen: the fused sample step
// of one circuit structure.  Replaces the kernel body the Pallas TPU kernel
// of diffwdf_tpu/ops/fused_circuit.py (fused_circuit_process) traces.
{comment}
#include <cuda_runtime.h>

{headers}
#define CIRCUIT_NS {n_state}
#define CIRCUIT_NC {n_coeffs}

namespace {{

// One sample: v the input, z[CIRCUIT_NS] the state (updated in place),
// c[CIRCUIT_NC] the coefficient slots, w the root array.  Returns the output.
// Plain C: with the CUDA qualifiers defined away it compiles for the host.
__device__ __forceinline__ float circuit_step(float v, float* z, const float* c,
                                              const float* w) {{
  (void)c;
  (void)w;
{body}
  return {out.ref};
}}

}}  // namespace
"""
    zn, cn = max(n_state, 1), max(n_coeffs, 1)
    kernel = f"""
#include "tile.cuh"

// One thread per stream over all T samples: the state and the coefficient
// slots in registers, the root array in shared memory, (B, T) staged through
// shared memory in (128, 32) tiles for whole-line loads and stores.  Exact
// f32: no fast-math flags or intrinsics.
namespace {{

__global__ void __launch_bounds__(kTileRows)
circuit_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
               float* __restrict__ out, float* __restrict__ zf, int B, int T,
               const float* __restrict__ coef, const float* __restrict__ warr, int n_warr) {{
  extern __shared__ float sw[];
  __shared__ Tile tile;
  for (int i = threadIdx.x; i < n_warr; i += blockDim.x) sw[i] = warr[i];
  float c[{cn}];
#pragma unroll
  for (int i = 0; i < CIRCUIT_NC; ++i) c[i] = coef[i];
  const int b0 = blockIdx.x * kTileRows;
  const int b = b0 + threadIdx.x;
  const bool live = b < B;
  float z[{zn}];
#pragma unroll
  for (int k = 0; k < CIRCUIT_NS; ++k) z[k] = live ? z0[static_cast<size_t>(k) * B + b] : 0.f;
  for (int t0 = 0; t0 < T; t0 += kTileCols) {{
    const int tc = min(kTileCols, T - t0);
    tile_load(tile, vin, B, T, b0, t0, tc);  // its barrier also covers sw
    for (int k = 0; k < tc; ++k) {{
      tile[threadIdx.x][k] = circuit_step(tile[threadIdx.x][k], z, c, sw);
    }}
    tile_store(tile, out, B, T, b0, t0, tc);
  }}
  if (live) {{
#pragma unroll
    for (int k = 0; k < CIRCUIT_NS; ++k) zf[static_cast<size_t>(k) * B + b] = z[k];
  }}
}}

}}  // namespace

extern "C" {{

int circuit_launch(const float* vin, const float* z0, float* out, float* zf, int B, int T,
                   const float* coef, const float* warr, int n_warr, void* stream) {{
  const size_t smem = sizeof(float) * static_cast<size_t>(n_warr);
  if (smem + sizeof(Tile) > 48 * 1024) {{
    const cudaError_t e = cudaFuncSetAttribute(
        circuit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }}
  const int blocks = (B + kTileRows - 1) / kTileRows;
  circuit_kernel<<<blocks, kTileRows, smem, static_cast<cudaStream_t>(stream)>>>(
      vin, z0, out, zf, B, T, coef, warr, n_warr);
  return static_cast<int>(cudaGetLastError());
}}

const char* circuit_error_string(int err) {{
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}}

}}  // extern "C"
"""
    host = f"""
// Host loop over streams and samples (CPU tests of the step).
extern "C" void circuit_host_run(const float* vin, const float* z0, float* out, float* zf,
                                 int B, int T, const float* c, const float* w) {{
  for (int b = 0; b < B; ++b) {{
    float z[{zn}];
    for (int k = 0; k < CIRCUIT_NS; ++k) z[k] = z0[static_cast<long>(k) * B + b];
    for (int t = 0; t < T; ++t) {{
      out[static_cast<long>(b) * T + t] = circuit_step(vin[static_cast<long>(b) * T + t], z, c, w);
    }}
    for (int k = 0; k < CIRCUIT_NS; ++k) zf[static_cast<long>(k) * B + b] = z[k];
  }}
}}
"""
    return CircuitProgram(
        source=step_source + kernel, step_source=step_source, host_source=step_source + host,
        state_order=state_order, layout=layout, n_coeffs=n_coeffs, ops_per_sample=ops,
        emitter=emitter)


#: circuit -> {(input node, slot layout, root key): program}; held weakly, so
#: a circuit's programs go with it
_programs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def program(circuit: Circuit, coeffs, params, static_controls, input_node: str,
            neural_mlp=None) -> CircuitProgram:
    """The (cached) program of a circuit structure: keyed by the circuit
    object, the input node, the slot layout and the root's kind and shape."""
    emitter = root_emitter(circuit, params, neural_mlp)
    layout = _layout(circuit, coeffs, params, static_controls)
    per_circuit = _programs.setdefault(circuit, {})
    key = (input_node, layout, emitter.key())
    prog = per_circuit.get(key)
    if prog is None:
        prog = per_circuit[key] = generate(circuit, coeffs, params, static_controls, input_node,
                                           emitter)
    return dataclasses.replace(prog, emitter=emitter)
