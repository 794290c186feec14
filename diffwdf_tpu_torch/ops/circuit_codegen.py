"""Generate the CUDA C++ sources of the fused kernels of a WDF `Circuit`.

Three kernels per circuit structure:

- the **forward** (``CircuitProgram.source``, ``ops.fused_circuit``): the
  circuit's whole sample recursion over a batch of streams, one thread per
  stream or a group of K lanes per stream (the tree on every lane; an NxH
  neural root's MLP or a general MLP's hidden layers split across them, a
  diode pair's two omega solves on a pair of lanes, a distilled root's
  Chebyshev segments one a lane: ``_lanes_parts``), optionally writing the
  pre-step state trajectory z_{t-1} (the residual of training);
- the **adjoint** (``AdjointProgram.source``, ``ops.parallel_bptt``): the
  reverse-time recursion lam_{t-1} = J_t^T lam_t + A_t^T obar_t of training
  over the stored trajectory, in two passes: the step's tangents at every
  (b, t) in parallel into a scratch, then one thread per stream walking
  t = T-1 ... 0 through them (``generate_adjoint``);
- the **DEER solve** (``DeerProgram.source``, ``ops.deer_circuit``): one
  stream's recursion solved parallel in time by Newton sweeps over the
  whole trajectory, on a cluster of CTAs (``csrc/deer_cluster.cuh``), its
  step writing f and the S x S state Jacobian from S forward-mode tangents
  (``generate_deer``).

The per-sample steps are generated by **tracing** the circuit's own pure
step: the tree's ``reflected`` / ``incident`` methods (``core``) run once on
symbolic scalars (``Sym``) that write each operation as one line of C, so
the scatter algebra has one source of truth, as the Pallas kernels have when
they trace ``circuit.step``.  Each traced operation is emitted as a
round-to-nearest intrinsic (``__fmul_rn``, ``__fadd_rn``, ...), which nvcc
never contracts into an FMA, so the tree's algebra rounds exactly as the
plain version's separate torch operations do (the Tube Screamer's op-amp
scatter amplifies any difference).  The root is not traced: each root kind
has an emitter that calls its device code (``csrc/omega.cuh``,
``nxh_mlp.cuh``, ``mlp_dense.cuh``, ``cheb.cuh``; the lane forms'
``omega_lanes.cuh``, ``nxh_lanes.cuh``, ``mlp_dense_lanes.cuh``,
``cheb_lanes.cuh``) and a plain PyTorch twin of the same math.

The adjoint step is the forward-mode derivative of the same trace: the step
runs again on dual symbols (``Dual``: a primal and one tangent per
direction), with S + 1 directions (each state, then the input v), so every
tangent line is again one uncontracted intrinsic.  Coefficients carry no
tangent; the tree is linear in the waves, so the tangent lines are products
with coefficient slots.  The root's derivative m = db/da is computed once
per step at the primal a (the diode pair's derivative through
``omega_slope``, the NxH MLP's by ``nxh_tangent``, the distilled root's by
``cheb_root_tangent``) and the S + 1 pulls of
the root are db = m da.  The cotangents are then contracted with the carried
lam and the output's cotangent; pass 1 writes the tangents that are not
exact constants, pass 2 contracts them in the one-pass step's order, so the
two give its bits.  For an NxH root whose R_up is one value or one per row
(``root_streams``) one more direction, the root's reflected wave b, gives
the step's b column: pass 1 writes the root's incident wave a and pass 2
G = (dF/db)^T (lam, obar), the streams of the root's parameter pass.
The DEER step
is the same trace with the S state directions only, its primal f and its
tangents J written out; there the root's value and slope come from one
pass (``emit_value_slope``: one omega pair, ``nxh_forward_tangent`` or
``cheb_root_value_tangent``).

What a source depends on: the tree's topology and node names, the root's
kind and shape (the omega iteration count; the NxH MLP's H and L, a general
MLP's widths and activations; the Chebyshev degrees) and the kinds and shapes of the coefficients.  Never on a value:
every component value reaches the kernel at launch, so moving a pot (the
Tube Screamer's drive, R6) or any component is a new argument, not a new
build.

Launch arguments, in fixed orders:

- **State slots**: the circuit's state entries sorted by (node name, field),
  as ``(S, B)`` arrays; ``z[k]`` in the step.
- **Coefficient vector** (f32, ``c[i]`` in the step): the scalar and matrix
  leaves of the adapted coeffs, then of the params (without the root's
  fragment), then of the static controls, each dict in sorted key order; a
  scalar takes one slot, a matrix of at most 64 entries (the R-type S) its
  entries row-major.  Then the root's own slots (the diode pair's seven
  constants), unless they are per row.
- **Row slots** (``(NR, B)`` f32, ``r[j]`` in the step, one register each):
  the leaves that a per-row pot control (``row_controls`` of shape (B,))
  made per row, in the same order, then the root's slots if the root's port
  impedance is per row.
- **Time slots** (``(NQ, B, T)`` f32, ``q[j]`` in the step): the leaves that
  a per-sample pot control (shape (B, T)) made per sample, staged through
  shared memory like the input and read per step.
- **Root array** (f32, staged to shared memory, ``w`` in the step): the NxH
  weights (log R folded into the first bias when R is one value), a general
  MLP's layers, or the Chebyshev segments and coefficients.

Supported node classes: ``Resistor``, ``Capacitor``, ``Inductor``,
``ResistiveVoltageSource``, ``ResistiveCurrentSource``, ``Series``,
``Parallel``, ``Inverter``, ``RTypeAdaptor``; roots: ``DiodePairRoot``,
``NeuralDiodeRoot`` (an all-tanh NxH with a linear head in every kernel;
any other widths and activations in the forward only, ``_DenseEmitter``),
``PiecewiseChebRoot``, ``IdealVoltageSourceRoot``, ``OpenCircuitRoot``.  Anything
else raises ``NotImplementedError`` naming it.  One output probe.  A pot
control must not reach a matrix coefficient (no pot inside an R-type
adaptor): that raises ``ValueError``.

The steps are emitted as ``__device__`` functions of plain C
(``step_source``; ``__device__`` because the root headers' functions are
device functions), so the CPU tests compile them with the host compiler, the
CUDA qualifiers defined away, and drive them through ``host_source``.
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
from ..runtime.profiler import count, h2d
from .fused_clipper import (
    LANE_TARGETS,
    LANES,
    _nxh_layers,
    cheb_arguments,
    cheb_lanes,
    cheb_parameters,
    cheb_root_ops,
    diode_pair_root,
    first_bias,
    nxh_mlp,
)

#: node classes whose reflected/incident methods trace into the step
NODE_CLASSES = (Resistor, Capacitor, Inductor, ResistiveVoltageSource, ResistiveCurrentSource,
                Series, Parallel, Inverter, RTypeAdaptor)
#: matrix coefficients up to 8x8 take slots (the R-type S)
MAX_MATRIX = 64
#: slot kinds of a per-row and a per-sample coefficient in a layout
ROW, TIME = ("row",), ("time",)


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

    def _name(self, prefix: str) -> str:
        name = f"{prefix}{self._n}"
        self._n += 1
        return name

    def let(self, expr: str, ops: int, prefix: str = "t", ctype: str = "float") -> "Sym":
        name = self._name(prefix)
        self.entries.append((name, f"const {ctype} {name} = {expr};", ops))
        return Sym(self, name)

    def decl(self, statement: str, ops: int, prefix: str) -> str:
        """A statement that declares its own name (``statement`` formatted
        with ``name``), e.g. an array a root fills; dropped when unread."""
        name = self._name(prefix)
        self.entries.append((name, statement.format(name=name), ops))
        return name

    def raw(self, line: str) -> None:
        """A line kept as it is (a comment)."""
        self.entries.append((None, line, 0))

    def const(self, v) -> "Sym":
        return Sym(self, _literal(v), float(np.float32(v)))

    def live(self, uses: str) -> Tuple[List[str], int]:
        """The lines the code ``uses`` needs, in order, and their operation
        count: a named line whose value nothing reads (a wave sent into a
        source or resistor, a primal no tangent reads) is dropped."""
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
    fold away (exact for finite values).  An operation with a ``Dual`` is
    the dual's."""

    def __init__(self, trace: _Trace, ref: str, value: Optional[float] = None):
        self.trace, self.ref, self.value = trace, ref, value

    def zeros_like(self) -> "Sym":
        return self.trace.const(0.0)

    def _sym(self, other) -> Optional["Sym"]:
        if isinstance(other, Sym):
            return other
        if isinstance(other, Dual):
            return None
        if isinstance(other, (int, float, np.floating)) and not isinstance(other, bool):
            return self.trace.const(other)
        raise TypeError(f"cannot trace an operation with {type(other).__name__}")

    def _op(self, o, op: str, reflected: bool = False):
        o = self._sym(o)
        if o is None:
            return NotImplemented
        return _binary(o, self, op) if reflected else _binary(self, o, op)

    def __add__(self, o):
        return self._op(o, "+")

    def __radd__(self, o):
        return self._op(o, "+", True)

    def __sub__(self, o):
        return self._op(o, "-")

    def __rsub__(self, o):
        return self._op(o, "-", True)

    def __mul__(self, o):
        return self._op(o, "*")

    def __rmul__(self, o):
        return self._op(o, "*", True)

    def __truediv__(self, o):
        return self._op(o, "/")

    def __rtruediv__(self, o):
        return self._op(o, "/", True)

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


def _tadd(x: Optional[Sym], y: Optional[Sym]) -> Optional[Sym]:
    """x + y of two tangents, None standing for an exact zero."""
    if x is None:
        return y
    return x if y is None else x + y


def _tsub(x: Optional[Sym], y: Optional[Sym]) -> Optional[Sym]:
    if y is None:
        return x
    return -y if x is None else x - y


def _tmul(x: Optional[Sym], y: Sym) -> Optional[Sym]:
    return None if x is None else x * y


class Dual(Symbolic):
    """A float of the step with its tangents along the adjoint's directions:
    ``p`` the primal ``Sym``, ``d`` one ``Sym`` per direction (None for an
    exact zero).  The product and quotient rules emit the tangent lines."""

    def __init__(self, p: Sym, d: Sequence[Optional[Sym]]):
        self.p, self.d = p, tuple(d)

    def zeros_like(self) -> Sym:
        return self.p.trace.const(0.0)

    def _lift(self, o) -> "Dual":
        if isinstance(o, Dual):
            return o
        if isinstance(o, Sym):
            return Dual(o, (None,) * len(self.d))
        return Dual(self.p._sym(o), (None,) * len(self.d))

    def __add__(self, o):
        o = self._lift(o)
        return Dual(self.p + o.p, map(_tadd, self.d, o.d))

    def __radd__(self, o):
        return self._lift(o) + self

    def __sub__(self, o):
        o = self._lift(o)
        return Dual(self.p - o.p, map(_tsub, self.d, o.d))

    def __rsub__(self, o):
        return self._lift(o) - self

    def __mul__(self, o):
        o = self._lift(o)
        return Dual(self.p * o.p, (_tadd(_tmul(dx, o.p), _tmul(dy, self.p))
                                   for dx, dy in zip(self.d, o.d)))

    def __rmul__(self, o):
        return self._lift(o) * self

    def __truediv__(self, o):
        o = self._lift(o)
        q = self.p / o.p
        return Dual(q, (None if dx is None and dy is None else _tsub(dx, _tmul(dy, q)) / o.p
                        for dx, dy in zip(self.d, o.d)))

    def __rtruediv__(self, o):
        return self._lift(o) / self

    def __neg__(self):
        return Dual(-self.p, (None if t is None else -t for t in self.d))


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


def _shape(leaf, batch: int = 0, time: int = 0) -> Tuple:
    """The slot kind of a leaf: () a scalar, (r, c) a matrix, ``ROW`` a
    per-row (batch,) value and ``TIME`` a per-sample (batch, time) value;
    the last two only when pot controls are given (``batch`` > 0)."""
    shape = tuple(torch.as_tensor(leaf).shape)
    n = int(np.prod(shape)) if shape else 1
    if n == 1:
        return ()
    if batch and shape == (batch,):
        return ROW
    if batch and time and shape == (batch, time):
        return TIME
    if len(shape) == 2 and n <= MAX_MATRIX:
        return shape
    if batch:
        raise ValueError(
            f"fused_circuit: unsupported coefficient shape {shape}: per-row and per-sample "
            "pot controls must not reach matrix-valued coefficients (keep the pot outside "
            "R-type adaptors or bake the adaptor's scattering matrix)")
    raise ValueError(
        f"fused_circuit: unsupported coefficient shape {shape}: scalars and matrices of at "
        f"most {MAX_MATRIX} entries, or per-row and per-sample pot streams (row_controls)")


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
    triple whose leaves fill the slots."""
    tree_params = {k: v for k, v in params.items() if k != circuit.root.name}
    return {"coeffs": coeffs, "params": tree_params, "static": static_controls or {}}


def state_order(circuit: Circuit) -> Tuple[Tuple[str, str], ...]:
    """The circuit's state entries as (node, field), sorted: the kernels'
    state slot order."""
    return tuple((node, field) for (node, field), _ in _leaves(circuit.init_state("cpu")))


# ---------------------------------------------------------------------------
# Root emitters
# ---------------------------------------------------------------------------


class _RootEmitter:
    """How a root kind enters the steps: header, slots, root array, C lines
    of b and of its derivative m = db/da, and the plain PyTorch twin.

    ``r_kind`` is the kind of the root's port impedance R_up: "scalar", "row"
    (a per-row pot reaches the top of the tree) or "time" (a per-sample pot).
    The root's ``n_slots`` slots are per row for a row R_up and in the
    coefficient vector otherwise; ``n_keep`` floats per thread (``p``) come
    from ``prologue`` lines run once per stream."""

    headers: Tuple[str, ...] = ()
    n_slots = 0
    n_keep = 0
    traced = False
    #: the kernels' __launch_bounds__.  Every generated kernel is bound by one
    #: stream's chain of dependent operations, so a second resident block
    #: per SM buys nothing; with the block size alone ptxas may still trade
    #: registers for one, which is harmless for the light roots (measured
    #: faster with it) and spilled the MLP root (see _NeuralEmitter)
    launch_bounds = "kTileRows"

    def __init__(self, r_kind: str = "scalar"):
        self.r_kind = r_kind

    def key(self) -> tuple:
        return (type(self).__name__,)

    def slots(self, r_up, params) -> List[torch.Tensor]:
        return []

    def array(self, r_up, params, device) -> Optional[torch.Tensor]:
        return None

    def prologue(self, slots: List[Sym]) -> List[str]:
        return []

    def emit(self, tr: _Trace, a, r_up: Sym, slots: List[Sym], controls, params):
        raise NotImplementedError

    def emit_slope(self, tr: _Trace, a: Sym, r_up: Sym, slots: List[Sym], controls,
                   params) -> Sym:
        raise NotImplementedError

    def emit_value_slope(self, tr: _Trace, a: Sym, r_up: Sym, slots: List[Sym], controls,
                         params) -> Tuple[Sym, Sym]:
        """(b, m = db/da) at a from one evaluation, for a step that needs
        both (the DEER step)."""
        raise NotImplementedError

    def plain(self, a, r_up, slots, array, controls, params):
        raise NotImplementedError

    # --- the lane-cooperative forward (``_lanes_parts``): a root with lanes

    #: headers of the lane form's root code
    lane_headers: Tuple[str, ...] = ()
    #: threads a block of the lane form (a multiple of 32 and of every K)
    lane_threads = 128
    #: substrings that mark the root's own lines of a traced step: the lines
    #: the lane form may emit differently (``_lanes_parts``' tree check drops
    #: them and requires every other line to be the one-thread step's)
    own_marks: Tuple[str, ...] = ("// root",)

    def lane_counts(self, every: bool = False) -> Tuple[int, ...]:
        """The group sizes K of the lane-cooperative forward kernel built for
        this root (``every``: the K sweep's build); none: the one-thread
        kernel alone."""
        return ()

    def lane_weights(self) -> Tuple[str, str]:
        """(the C++ type of a lane's weights in the lane form, given K; the
        statement that loads them for lane ``rank`` from the root array
        ``w``): none by default."""
        return "CircuitNoLaneWeights", ""

    def prologue_lanes(self, slots) -> List[str]:
        """The lane form's prologue: none by default."""
        return []

    def lane_definitions(self) -> str:
        """C++ the lane form's weights type needs, emitted before it (the
        general MLP's per-layer weights struct): none by default."""
        return ""

    def own_line(self, line: str) -> bool:
        return any(mark in line for mark in self.own_marks)


class _TracedRoot(_RootEmitter):
    """A root whose ``reflect`` is arithmetic on its inputs
    (IdealVoltageSourceRoot, OpenCircuitRoot): traced like the tree, on
    duals in the adjoint."""

    traced = True

    def __init__(self, root, r_kind: str = "scalar"):
        super().__init__(r_kind)
        self.root = root

    def key(self):
        return (type(self.root).__name__,)

    def emit(self, tr, a, r_up, slots, controls, params):
        return self.root.reflect(a, r_up, params, controls)

    def plain(self, a, r_up, slots, array, controls, params):
        return self.root.reflect(a, r_up, params, controls)


class _DiodePairEmitter(_RootEmitter):
    """Asymmetric diode pair (Werner eqn 45) with the real-line omega of
    omega.cuh.  Slots, computed in double from the adapted R and rounded to
    f32 (per row for a per-row R): log(R Is / (n_up Vt)),
    log(R Is / (n_down Vt)), 1 / (n_up Vt), 1 / (n_down Vt), 2 Vt, n_up,
    n_down (Vt = nabla Vt).  For a per-sample R the two logs are taken in
    the step, in f32 and in the order of ``diode_pair_reflected``
    (R Is / Vt, then / n, then log), and the slots are Is, Vt and the last
    five.  The lines around omega round as ``diode_pair_root`` does
    (uncontracted).

    The forward step solves the pair branch-free with the Newton steps
    unrolled: ``omega_pair`` on one thread, ``omega_pair_lanes`` on a pair
    of lanes (K = 2, omega_lanes.cuh), each lane one solve, the same bits.
    The adjoint and DEER steps keep ``omega()``."""

    headers = ("omega.cuh",)
    lane_headers = ("omega_lanes.cuh",)
    own_marks = ("// root", "omega_pair")
    #: blocks of 64 threads (32 streams) in the lane form: against 128 at
    #: (8192, 2048) on an H100, in turns, the TS took 0.998x and the LPF
    #: 0.995x the time (chip_smoke.py's block-shape line)
    lane_threads = 64
    n_slots = 7

    def __init__(self, root: DiodePairRoot, r_kind: str = "scalar"):
        super().__init__(r_kind)
        self.name, self.iters = root.name, int(root.iters)
        self.omega_ops = 10 + 6 * self.iters  # region guess 10, 6 per Newton step

    def key(self):
        return ("DiodePairRoot", self.iters)

    def lane_counts(self, every: bool = False) -> Tuple[int, ...]:
        """K = 2: the pair's two solves on a pair of lanes, at every B."""
        return (2,)

    def slots(self, r_up, params):
        p = {k: torch.as_tensor(v).detach().double() for k, v in params[self.name].items()}
        vte = p["nabla"] * p["Vt"]
        n_up, n_dn = p["N_up"], p["N_down"]
        common = [1.0 / (n_up * vte), 1.0 / (n_dn * vte), 2.0 * vte, n_up, n_dn]
        if self.r_kind == "time":
            return [p["Is"], vte] + common
        r = torch.as_tensor(r_up).detach().double().to(p["Is"].device)
        out = [torch.log(r * p["Is"] / (n_up * vte)), torch.log(r * p["Is"] / (n_dn * vte))]
        return [torch.broadcast_to(x, r.shape) for x in out + common]

    def _logs(self, tr, r_up, slots):
        if self.r_kind != "time":
            return slots[0], slots[1]
        i_s, vte, _, _, _, n_up, n_dn = (s.ref for s in slots)
        riv = tr.let(f"__fdiv_rn(__fmul_rn({r_up.ref}, {i_s}), {vte})", 2, "d")
        return (tr.let(f"logf(__fdiv_rn({riv.ref}, {n_up}))", 2, "d"),
                tr.let(f"logf(__fdiv_rn({riv.ref}, {n_dn}))", 2, "d"))

    def _core(self, tr, a, r_up, slots, pair: Optional[str] = None):
        """The branch selects and the two omega values at a: a dict of the
        symbols b and m are built from.  ``pair``: the function that solves
        both at once (``omega_pair`` of the forward step, or
        ``omega_pair_lanes`` of its lane form), else two ``omega()`` calls."""
        log_up, log_dn = (s.ref for s in self._logs(tr, r_up, slots))
        inv_up, inv_dn, two_vt, n_up, n_dn = (s.ref for s in slots[2:])
        x = a.ref
        s = {"two_vt": two_vt}
        s["lam"] = tr.let(f"sign0({x})", 3, "d").ref
        pos = tr.let(f"{x} >= 0.f", 1, "d", "bool").ref
        for name, (when_pos, when_neg) in (("mu0", (n_dn, n_up)), ("mu1", (n_up, n_dn)),
                                           ("log0", (log_dn, log_up)), ("log1", (log_up, log_dn)),
                                           ("inv0", (inv_dn, inv_up)), ("inv1", (inv_up, inv_dn))):
            s[name] = tr.let(f"{pos} ? {when_pos} : {when_neg}", 1, "d").ref
        la = tr.let(f"__fmul_rn({s['lam']}, {x})", 1, "d").ref
        x0 = f"__fadd_rn({s['log0']}, __fmul_rn({la}, {s['inv0']}))"
        x1 = f"__fsub_rn({s['log1']}, __fmul_rn({la}, {s['inv1']}))"
        if pair is None:
            s["w0"] = tr.let(f"omega({x0}, {self.iters})", 2 + self.omega_ops, "d").ref
            s["w1"] = tr.let(f"omega({x1}, {self.iters})", 2 + self.omega_ops, "d").ref
            return s
        # one statement fills both, w[0] = omega(x0) and w[1] = omega(x1): as
        # many names as the two omega() lines, so that the lines after them
        # keep their names
        rank = ", rank" if pair == "omega_pair_lanes" else ""
        w = tr.decl(f"float {{name}}[2]; {pair}<{self.iters}>({x0}, {x1}, {{name}}[0], "
                    f"{{name}}[1]{rank});", 4 + 2 * self.omega_ops, "om")
        s["w0"], s["w1"] = f"{w}[0]", f"{w}[1]"
        return s

    def emit(self, tr, a, r_up, slots, controls, params, lanes: bool = False):
        """b at a; with ``lanes`` the pair form (``omega_pair_lanes`` on the
        pair of lanes of the kernel's group, ``rank`` the lane's place in
        it), which only the lane-cooperative forward kernel emits."""
        if lanes:
            tr.raw(f"// root: asymmetric diode pair, its two omega solves on a pair of lanes "
                   f"(omega_lanes.cuh), {self.iters} Newton iterations")
        else:
            tr.raw(f"// root: asymmetric diode pair, omega.cuh's omega_pair with {self.iters} "
                   "Newton iterations")
        s = self._core(tr, a, r_up, slots, "omega_pair_lanes" if lanes else "omega_pair")
        return tr.let(f"__fsub_rn({a.ref}, __fmul_rn(__fmul_rn({s['two_vt']}, {s['lam']}), "
                      f"__fsub_rn(__fmul_rn({s['mu0']}, {s['w0']}), "
                      f"__fmul_rn({s['mu1']}, {s['w1']}))))", 6, "root")

    def emit_slope(self, tr, a, r_up, slots, controls, params):
        tr.raw("// root slope: d/da of the diode pair, omega' = 1 / (1 + 1/omega)")
        return self._slope(tr, self._core(tr, a, r_up, slots))

    def _slope(self, tr, s):
        # db/da = 1 - 2 Vt lam (mu0 w0' lam inv0 + mu1 w1' lam inv1), w' the
        # implicit derivative of omega (omega_slope), JAX's custom jvp
        terms = [tr.let(f"__fmul_rn(__fmul_rn({s[mu]}, __fmul_rn({s['lam']}, {s[inv]})), "
                        f"omega_slope({s[w]}))", 6, "d").ref
                 for mu, inv, w in (("mu0", "inv0", "w0"), ("mu1", "inv1", "w1"))]
        return tr.let(f"__fsub_rn(1.f, __fmul_rn(__fmul_rn({s['two_vt']}, {s['lam']}), "
                      f"__fadd_rn({terms[0]}, {terms[1]})))", 4, "slope")

    def emit_value_slope(self, tr, a, r_up, slots, controls, params):
        tr.raw(f"// root: asymmetric diode pair and its slope, omega.cuh with {self.iters} "
               "Newton iterations, one omega pair for both")
        s = self._core(tr, a, r_up, slots)
        b = tr.let(f"__fsub_rn({a.ref}, __fmul_rn(__fmul_rn({s['two_vt']}, {s['lam']}), "
                   f"__fsub_rn(__fmul_rn({s['mu0']}, {s['w0']}), "
                   f"__fmul_rn({s['mu1']}, {s['w1']}))))", 6, "root")
        return b, self._slope(tr, s)

    def plain(self, a, r_up, slots, array, controls, params):
        if self.r_kind == "time":
            i_s, vte, inv_up, inv_dn, two_vt, n_up, n_dn = slots
            riv = r_up * i_s / vte
            slots = [torch.log(riv / n_up), torch.log(riv / n_dn), inv_up, inv_dn, two_vt,
                     n_up, n_dn]
        return diode_pair_root(a, *slots, self.iters)


class _NeuralEmitter(_RootEmitter):
    """NxH all-tanh MLP with a linear head, b = -MLP([a, log R]), through
    nxh_mlp.cuh (and nxh_lanes.cuh in the lane-cooperative forward).  Root
    array for one R: w1a[H], c1[H] (log R folded in), w3[H], b3, then per
    hidden layer W[H][H] and bias[H] (fused_clipper.cu's layout); for a
    per-row or per-sample R: w1a[H], w1r[H], b1[H], w3[H], b3, then the
    hidden layers (clipper_train.cu's layout), with c1 built by
    ``nxh_first_bias`` once per stream from the row's log R (a row slot,
    taken in double) or per step from logf of the streamed R.  Zeros after
    b3 start the hidden layers at a multiple of 4 floats, so that the lane
    form reads every block in 16-byte words."""

    headers = ("nxh_mlp.cuh",)
    lane_headers = ("nxh_lanes.cuh",)
    own_marks = ("// root", "nxh_")
    #: one block per SM: with the block size alone ptxas put the Tube
    #: Screamer 2x16 at 96 registers and spilled the MLP's activations
    launch_bounds = "kTileRows, 1"

    def __init__(self, name: str, mlp_params, activations: Sequence[str],
                 r_kind: str = "scalar"):
        super().__init__(r_kind)
        if not _nxh_activations(activations):
            raise ValueError(
                "the fused circuit kernel takes all-tanh hidden layers with a linear head "
                f"only; root {name!r} has activations {tuple(activations)}")
        self.mlp = mlp_params
        self.H, _, _, hidden, _, _ = _nxh_layers(mlp_params)
        self.L = len(hidden)
        H, L = self.H, self.L
        # first layer FMA + tanh, hidden H x H FMAs + bias + tanh, head FMAs
        self.ops = 3 * H + L * (2 * H * H + 2 * H) + 2 * H
        # the forward again, the first layer's dh (3H), per hidden layer the
        # tangent FMAs and dg (2H^2 + 3H), the head's 2H (nxh_tangent)
        self.slope_ops = self.ops - 2 * H + 3 * H + L * (2 * H * H + 3 * H) + 2 * H
        self.n_slots = 1 if r_kind == "row" else 0
        self.n_keep = H if r_kind == "row" else 0
        # offsets into the root array: c1 (or w1r), the head, b3, hidden
        self._head = 2 * H if r_kind == "scalar" else 3 * H
        self._hidden = _pad4(self._head + H + 1)

    def key(self):
        return ("NeuralDiodeRoot", self.H, self.L)

    def _layers(self):
        """The weights as the kernel gets them: values, out of any graph."""
        H, W1, b1, hidden, w3, b3 = _nxh_layers(self.mlp)
        return (W1.detach(), b1.detach(), [(k.detach(), b.detach()) for k, b in hidden],
                w3.detach(), b3.detach())

    def slots(self, r_up, params):
        if self.r_kind != "row":
            return []
        return [torch.log(torch.as_tensor(r_up).detach().double())]

    def array(self, r_up, params, device):
        W1, b1, hidden, w3, b3 = self._layers()
        if self.r_kind == "scalar":
            log_r = h2d(torch.log(torch.as_tensor(r_up).detach().double()).float(), W1.device)
            parts = [W1[0], W1[1] * log_r + b1, w3, b3]
        else:
            parts = [W1[0], W1[1], b1, w3, b3]
        parts.append(torch.zeros(self._hidden - self._head - self.H - 1, device=W1.device))
        parts += [x.reshape(-1) for layer in hidden for x in layer]
        return torch.cat([h2d(p, device) for p in parts])

    def prologue(self, slots):
        if self.r_kind != "row":
            return []
        H = self.H
        return [f"nxh_first_bias<{H}>(w + {H}, w + {2 * H}, {slots[0].ref}, "
                f"*reinterpret_cast<float(*)[{H}]>(p));"]

    def lane_counts(self, every: bool = False) -> Tuple[int, ...]:
        """The group sizes K of the lane-cooperative forward kernel built for
        this root (``nxh_lanes.cuh``): ``_mlp_lane_counts`` of H."""
        return _mlp_lane_counts((self.H,), every)

    def lane_weights(self) -> Tuple[str, str]:
        """(the C++ type of a lane's weights in the lane form, given K; the
        statement that loads them for lane ``rank`` from the root array
        ``w``): registers where N H L + H <= 96 (nxh_lanes.cuh)."""
        H, L = self.H, self.L
        return (f"NxhLaneWeights<{H}, K, {L}, ({H} / K) * {H} * {L} + {H} <= 96>",
                f"lw.load(w + {self._hidden}, w + {self._head}, rank);")

    def prologue_lanes(self, slots) -> List[str]:
        """The lane form's prologue: each lane's N = H / K entries of c1."""
        if self.r_kind != "row":
            return []
        H = self.H
        return [f"nxh_first_bias_lanes<{H}, K>(w + {H}, w + {2 * H}, {slots[0].ref}, rank, p);"]

    def _c1(self, tr, r_up, lanes: bool = False) -> str:
        H = self.H
        if self.r_kind == "scalar":
            return f"w + {H}"
        if self.r_kind == "row":
            return "p"
        if lanes:
            return tr.decl(f"float {{name}}[{H} / K]; nxh_first_bias_lanes<{H}, K>(w + {H}, "
                           f"w + {2 * H}, logf({r_up.ref}), rank, {{name}});", 2 * H + 1, "c1_")
        return tr.decl(f"float {{name}}[{H}]; nxh_first_bias<{H}>(w + {H}, w + {2 * H}, "
                       f"logf({r_up.ref}), {{name}});", 2 * H + 1, "c1_")

    def emit(self, tr, a, r_up, slots, controls, params, lanes: bool = False):
        """b at a; with ``lanes`` the lane form (``nxh_forward_lanes`` on the
        group of K lanes of the kernel's template, ``rank`` the lane's place
        in it), which only the lane-cooperative forward kernel emits."""
        H = self.H
        if lanes:
            tr.raw(f"// root: NxH MLP on K lanes, H = {H}, {self.L} hidden layers "
                   "(nxh_lanes.cuh)")
            c1 = self._c1(tr, r_up, lanes=True)
            local = "false" if self.r_kind == "scalar" else "true"
            return tr.let(f"-nxh_forward_lanes<{H}, K, {self.L}, {local}>({a.ref}, w, {c1}, "
                          f"w + {self._hidden}, w + {self._head}, w[{self._head + H}], rank, "
                          "lw)", self.ops, "root")
        tr.raw(f"// root: NxH MLP, H = {H}, {self.L} hidden layers (nxh_mlp.cuh)")
        c1 = self._c1(tr, r_up)
        return tr.let(f"-nxh_forward<{H}>({a.ref}, w, {c1}, w + {self._hidden}, {self.L}, "
                      f"w + {self._head}, w[{self._head + H}])", self.ops, "root")

    def emit_slope(self, tr, a, r_up, slots, controls, params):
        H = self.H
        tr.raw(f"// root slope: -dMLP/da by nxh_tangent, H = {H}, {self.L} hidden layers")
        c1 = self._c1(tr, r_up)
        return tr.let(f"-nxh_tangent<{H}>({a.ref}, w, {c1}, w + {self._hidden}, {self.L}, "
                      f"w + {self._head})", self.slope_ops, "slope")

    def emit_value_slope(self, tr, a, r_up, slots, controls, params):
        H = self.H
        tr.raw(f"// root and slope: -MLP and -dMLP/da in one pass by nxh_forward_tangent, "
               f"H = {H}, {self.L} hidden layers")
        c1 = self._c1(tr, r_up)
        # one statement fills both: [0] = b, [1] = m
        pair = tr.decl(f"float {{name}}[2]; {{name}}[0] = -nxh_forward_tangent<{H}>("
                       f"{a.ref}, w, {c1}, w + {self._hidden}, {self.L}, w + {self._head}, "
                       f"w[{self._head + H}], {{name}}[1]); {{name}}[1] = -{{name}}[1];",
                       self.slope_ops + 2 * H, "mlp")
        return tr.let(f"{pair}[0]", 0, "root"), tr.let(f"{pair}[1]", 0, "slope")

    def plain(self, a, r_up, slots, array, controls, params):
        W1, b1, hidden, w3, b3 = self._layers()
        if self.r_kind == "scalar":
            log_r = torch.log(torch.as_tensor(r_up).double()).float().to(W1.device)
            c1 = W1[1] * log_r + b1
        else:
            c1 = first_bias(W1, b1, slots[0] if self.r_kind == "row" else torch.log(r_up))
        return -nxh_mlp(a, W1[0], c1, hidden, w3, b3)


class _ChebEmitter(_RootEmitter):
    """Distilled piecewise-odd Chebyshev root through cheb.cuh; root array:
    cheb_parameters' layout; the segment count and padded degree go into the
    source.  Its slope (the adjoint's pass 1, the DEER step) is forward mode
    of the Clenshaw recurrence (``cheb_root_tangent``,
    ``cheb_root_value_tangent``), JAX's autodiff of the root's reflect.

    The forward's lane form is B6's: one segment a lane of a group of K = 4
    (8 for five to eight segments), its edges and coefficients in registers
    (``ChebLane``), the selected segment's h by one shuffle
    (``cheb_root_lanes``, cheb_lanes.cuh), the one-thread step's bits."""

    headers = ("cheb.cuh",)
    lane_headers = ("cheb_lanes.cuh",)
    own_marks = ("// root", "cheb_root")

    def __init__(self, root: PiecewiseChebRoot, r_kind: str = "scalar"):
        super().__init__(r_kind)
        self.root = root
        _, self.padded = cheb_parameters(root)
        self.degrees = tuple(len(c) - 1 for c in root.coeffs)
        self.ops = cheb_root_ops(len(self.degrees), self.padded)
        # the forward again, the tangent's 4 a Clenshaw step (every thread
        # runs the padded degree), dt/ds with its clip slope 7, dh/ds 4, ds/da
        # with its clip slope 5, m 3
        self.slope_ops = self.ops + 4 * self.padded + 19

    def key(self):
        return ("PiecewiseChebRoot", self.degrees)

    def array(self, r_up, params, device):
        return cheb_arguments(self.root, device)[0]

    def _degrees(self) -> str:
        return ", ".join(map(str, self.degrees))

    def lane_counts(self, every: bool = False) -> Tuple[int, ...]:
        """K = cheb_lanes(segments), B6's choice, at every B; with ``every``
        also 8 where K is 4 (the sweep's build)."""
        k = cheb_lanes(len(self.degrees))
        return tuple(x for x in (4, 8) if x >= k) if every else (k,)

    def lane_weights(self) -> Tuple[str, str]:
        """A lane's segment and the lower edges in registers (ChebLane)."""
        return (f"ChebLane<{self.padded}, K>",
                f"lw.load(w, {len(self.degrees)}, rank);")

    def emit(self, tr, a, r_up, slots, controls, params, lanes: bool = False):
        """b at a; with ``lanes`` the lane form (``cheb_root_lanes`` on the
        group of K lanes of the kernel's template), which only the
        lane-cooperative forward kernel emits."""
        if lanes:
            tr.raw(f"// root: distilled piecewise Chebyshev on K lanes, one segment a lane, "
                   f"degrees {self._degrees()} (cheb_lanes.cuh)")
            return tr.let(f"cheb_root_lanes<{self.padded}, K>({a.ref}, lw)", self.ops, "root")
        tr.raw(f"// root: distilled piecewise Chebyshev, degrees {self._degrees()} (cheb.cuh)")
        return tr.let(f"cheb_root<{self.padded}>({a.ref}, w, {len(self.degrees)})", self.ops,
                      "root")

    def emit_slope(self, tr, a, r_up, slots, controls, params):
        tr.raw(f"// root slope: d/da of the distilled root by cheb_root_tangent, degrees "
               f"{self._degrees()}")
        return tr.let(f"cheb_root_tangent<{self.padded}>({a.ref}, w, {len(self.degrees)})",
                      self.slope_ops, "slope")

    def emit_value_slope(self, tr, a, r_up, slots, controls, params):
        tr.raw(f"// root and slope: the distilled root and d/da in one pass by "
               f"cheb_root_value_tangent, degrees {self._degrees()}")
        # one statement fills both: [0] = b, [1] = m
        pair = tr.decl(f"float {{name}}[2]; {{name}}[0] = cheb_root_value_tangent<{self.padded}>("
                       f"{a.ref}, w, {len(self.degrees)}, {{name}}[1]);", self.slope_ops, "cheb")
        return tr.let(f"{pair}[0]", 0, "root"), tr.let(f"{pair}[1]", 0, "slope")

    def plain(self, a, r_up, slots, array, controls, params):
        root = self.root
        return cheb_eval(a, float(root.a_max), tuple(float(b) for b in root.breaks), root.coeffs)


#: each activation of roots/neural.py's _ACTS: (mlp_dense.cuh's DenseAct, its
#: operations an output (softmax: the max, the shift, expf, the sum and the
#: division), the plain twin)
_DENSE_ACTS = {
    "tanh": ("kDenseTanh", 1, torch.tanh),
    "relu": ("kDenseRelu", 1, torch.relu),
    "sigmoid": ("kDenseSigmoid", 4, torch.sigmoid),
    "softmax": ("kDenseSoftmax", 5, lambda x: torch.softmax(x, dim=-1)),
    "": ("kDenseLinear", 0, lambda x: x),
    "linear": ("kDenseLinear", 0, lambda x: x),
}


def _pad4(n: int) -> int:
    """n rounded up to a multiple of 4 floats (a 16-byte word)."""
    return (n + 3) // 4 * 4


def _mlp_lane_counts(widths: Sequence[int], every: bool) -> Tuple[int, ...]:
    """The group sizes K of an MLP root's lane form: of the K in LANES that
    divide every width of ``widths``, the largest at most each target of
    LANE_TARGETS (those that ``fused_circuit.lanes_for`` can pick), or with
    ``every`` all of them (the K sweep); none where no K divides them all, or
    no width is given (the one-thread kernel serves such a root alone)."""
    ks = [k for k in LANES if widths and all(w % k == 0 for w in widths)]
    if not every:
        ks = {max(k for k in ks if k <= target) for _, target in LANE_TARGETS
              if any(k <= target for k in ks)}
    return tuple(sorted(ks))


def _nxh_activations(acts: Sequence[str]) -> bool:
    """Tanh hidden layers and a linear head (or none given): the NxH
    family's activations."""
    acts = tuple(acts)
    return not acts or (set(acts[:-1]) == {"tanh"} and acts[-1] in ("", "linear"))


def is_nxh(activations: Sequence[str], mlp) -> bool:
    """Whether an MLP root is of the NxH family the NxH kernels take: its
    activations (``_nxh_activations``) and the shapes ``_nxh_layers`` takes."""
    if not _nxh_activations(activations):
        return False
    try:
        _nxh_layers(mlp)
    except (ValueError, TypeError):
        return False
    return True


class _DenseEmitter(_RootEmitter):
    """A general MLP root, b = -MLP([a, log R]), with any layer widths and
    any activation of ``roots/neural._ACTS`` per layer, through
    mlp_dense.cuh: the MLP roots outside the NxH family (a JSON model that
    mixes relu and tanh).  The layers run as ``mlp_apply`` zips them with
    the activations.  log R is a slot taken in double (a coefficient slot
    for one R, a row slot for a per-row R) or ``logf`` of the streamed R.
    Root array: each layer's kernel [IN][OUT] and bias [OUT], in order, each
    block zero-padded to a multiple of 4 floats for the lane form's 16-byte
    loads.

    The forward's lane form (mlp_dense_lanes.cuh) splits each hidden
    layer's outputs over a group of K lanes and computes the head on every
    lane, the one-thread step's bits; it is built where a K of LANES divides
    every hidden width (``lane_counts``), and such a root's lane weights go
    in registers where a lane's share is at most 96 floats.

    Forward only: JAX's adjoint and DEER kernels refuse such a root, and so
    do ``emit_slope`` and ``emit_value_slope``, in the words of its own
    refusals (the training engines and ``fused_deer_neural`` refuse it before
    they reach an emitter)."""

    headers = ("mlp_dense.cuh",)
    lane_headers = ("mlp_dense_lanes.cuh",)
    own_marks = ("// root", "mlp")
    #: one block per SM: no register cap, so the widest layer's activations
    #: stay in registers (as _NeuralEmitter)
    launch_bounds = "kTileRows, 1"

    def __init__(self, name: str, mlp_params, activations: Sequence[str],
                 r_kind: str = "scalar"):
        super().__init__(r_kind)
        unknown = [a for a in activations if a not in _DENSE_ACTS]
        if unknown:
            raise ValueError(f"root {name!r}: unknown activations {unknown}; the kernels take "
                             f"{sorted(_DENSE_ACTS)}")
        self.layers = [(l["kernel"].detach(), l["bias"].detach())
                       for l, _ in zip(mlp_params["layers"], activations)]
        self.acts = tuple(_DENSE_ACTS[a] for a, _ in zip(activations, self.layers))
        self.widths = tuple([int(self.layers[0][0].shape[0])]
                            + [int(k.shape[1]) for k, _ in self.layers])
        if self.widths[0] != 2:
            raise ValueError(f"root {name!r}: the first layer takes [a, log R], 2 inputs, "
                             f"not {self.widths[0]}")
        self.ops = (int(r_kind == "time") + sum(
            2 * n_in * n_out + n_out + act_ops * n_out
            for n_in, n_out, (_, act_ops, _) in zip(self.widths[:-1], self.widths[1:],
                                                     self.acts)))
        self.n_slots = 0 if r_kind == "time" else 1
        # each layer's (kernel, bias) offsets in the root array
        self._offsets, offset = [], 0
        for n_in, n_out in zip(self.widths[:-1], self.widths[1:]):
            w_off = offset
            offset += _pad4(n_in * n_out)
            self._offsets.append((w_off, offset))
            offset += _pad4(n_out)

    def key(self):
        return ("NeuralDiodeRoot", self.widths, tuple(act for act, _, _ in self.acts))

    def slots(self, r_up, params):
        if self.r_kind == "time":
            return []
        return [torch.log(torch.as_tensor(r_up).detach().double())]

    def array(self, r_up, params, device):
        parts = []
        for layer in self.layers:
            for x in layer:
                x = h2d(x.reshape(-1), device)
                parts += [x, x.new_zeros(_pad4(x.numel()) - x.numel())]
        return torch.cat(parts)

    def _layer_lines(self, lanes: bool) -> List[str]:
        """One call a layer: ``dense_layer`` on one thread, or
        ``dense_layer_lanes`` (the hidden layers split over the group, the
        head whole on every lane)."""
        acts = [act for act, _, _ in self.acts]
        last = len(acts) - 1
        code = []
        for i, (n_in, n_out, act) in enumerate(zip(self.widths[:-1], self.widths[1:], acts)):
            w_off, b_off = self._offsets[i]
            args = f"w + {w_off}, w + {b_off}, mlp_x{i}, mlp_x{i + 1}"
            if not lanes:
                code.append(f"float mlp_x{i + 1}[{n_out}]; dense_layer<{n_in}, {n_out}, {act}>("
                            f"{args});")
                continue
            size = f"{n_out}" if i == last else f"{n_out} / K"
            split_in = "true" if i > 0 else "false"
            code.append(f"float mlp_x{i + 1}[{size}]; dense_layer_lanes<{n_in}, {n_out}, {act}, "
                        f"K, {split_in}>({args}, rank, lw.l{i});")
        return code

    def emit(self, tr, a, r_up, slots, controls, params, lanes: bool = False):
        """b at a; with ``lanes`` the lane form (``dense_layer_lanes`` on the
        group of K lanes of the kernel's template, ``rank`` the lane's place
        in it), which only the lane-cooperative forward kernel emits."""
        widths, acts = "x".join(map(str, self.widths)), [act for act, _, _ in self.acts]
        if lanes:
            tr.raw(f"// root: MLP {widths} on K lanes, activations {', '.join(acts)} "
                   "(mlp_dense_lanes.cuh)")
        else:
            tr.raw(f"// root: MLP {widths}, activations {', '.join(acts)} (mlp_dense.cuh)")
        log_r = f"logf({r_up.ref})" if self.r_kind == "time" else slots[0].ref
        code = [f"const float mlp_x0[2] = {{{a.ref}, {log_r}}};"] + self._layer_lines(lanes)
        code.append(f"@ = -mlp_x{len(self.acts)}[0];")
        block = " ".join(code).replace("{", "{{").replace("}", "}}").replace("@", "{name}")
        name = tr.decl(f"float {{name}}; {{{{ {block} }}}}", self.ops, "mlp")
        return tr.let(name, 0, "root")

    def lane_counts(self, every: bool = False) -> Tuple[int, ...]:
        """The group sizes K of the lane form: ``_mlp_lane_counts`` of the
        hidden widths (none for a root without a hidden layer)."""
        return _mlp_lane_counts(self.widths[1:-1], every)

    def lane_definitions(self) -> str:
        """``MlpLaneWeights<K>``: one ``DenseLaneLayer`` a layer (the hidden
        layers' N = OUT / K columns, the head whole), in registers where
        their floats add up to at most 96 (as ``NxhLaneWeights``)."""
        last = len(self.acts) - 1
        pairs = list(zip(self.widths[:-1], self.widths[1:]))
        floats = " + ".join(f"{n_in + 1} * {n_out}" if i == last else
                            f"{n_in + 1} * ({n_out} / K)" for i, (n_in, n_out) in enumerate(pairs))
        members = "\n".join(
            f"  DenseLaneLayer<{n_in}, {n_out}, K, {'true' if i == last else 'false'}, kRegs> "
            f"l{i};" for i, (n_in, n_out) in enumerate(pairs))
        loads = "\n".join(f"    l{i}.load(w + {w_off}, w + {b_off}, rank);"
                          for i, (w_off, b_off) in enumerate(self._offsets))
        return f"""
// a lane's weights of the MLP {"x".join(map(str, self.widths))}: its columns of
// each hidden layer and the whole head, in registers where they fit
template <int K>
struct MlpLaneWeights {{
  static constexpr bool kRegs = {floats} <= 96;
{members}
  __device__ __forceinline__ void load(const float* w, int rank) {{
{loads}
  }}
}};
"""

    def lane_weights(self) -> Tuple[str, str]:
        return "MlpLaneWeights<K>", "lw.load(w, rank);"

    def _refuse(self):
        raise ValueError(
            "the generated adjoint and DEER kernels take all-tanh hidden layers with a linear "
            "head only (as JAX's kernels); an MLP root with other activations or widths is "
            "served by the generated forward alone")

    def emit_slope(self, tr, a, r_up, slots, controls, params):
        self._refuse()

    def emit_value_slope(self, tr, a, r_up, slots, controls, params):
        self._refuse()

    def plain(self, a, r_up, slots, array, controls, params):
        log_r = torch.log(r_up) if self.r_kind == "time" else slots[0]
        x = torch.stack(torch.broadcast_tensors(a, log_r.to(a.dtype)), dim=-1)
        for (kernel, bias), (_, _, act) in zip(self.layers, self.acts):
            x = act(x @ kernel.to(x) + bias.to(x))
        return -x[..., 0]


def root_emitter(circuit: Circuit, params, neural_mlp=None, r_kind: str = "scalar"
                 ) -> _RootEmitter:
    """The emitter of the circuit's root (an NxH MLP replaces it when
    ``neural_mlp`` is given, as ``fused_circuit_process_neural`` does) for a
    port impedance of kind ``r_kind``.  A ``NeuralDiodeRoot`` of the NxH
    family gets the NxH emitter, any other MLP root the general one."""
    root = circuit.root
    if neural_mlp is not None:
        return _NeuralEmitter(root.name, neural_mlp, getattr(root, "activations", ()), r_kind)
    if type(root) is DiodePairRoot:
        return _DiodePairEmitter(root, r_kind)
    if type(root) is NeuralDiodeRoot:
        mlp = params[root.name]
        if is_nxh(root.activations, mlp):
            return _NeuralEmitter(root.name, mlp, root.activations, r_kind)
        return _DenseEmitter(root.name, mlp, root.activations, r_kind)
    if type(root) is PiecewiseChebRoot:
        return _ChebEmitter(root, r_kind)
    if type(root) in (IdealVoltageSourceRoot, OpenCircuitRoot):
        return _TracedRoot(root, r_kind)
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
    """The generated forward kernel of one circuit structure and its launch
    layout."""

    source: str            # the whole .cu: step, kernel, launch function
    step_source: str       # includes, the prologue and the per-sample step
    host_source: str       # step_source and a host loop (tests)
    state_order: Tuple[Tuple[str, str], ...]
    layout: Tuple[Tuple[Tuple[str, ...], Tuple], ...]
    input_node: str
    n_coeffs: int          # coefficient vector slots, the root's included
    n_rows: int            # row slots, the root's included
    n_times: int           # time slots
    ops_per_sample: int    # counted from the emitted step
    emitter: Any
    #: the lanes per stream ``circuit_launch`` takes: 1 (one thread per
    #: stream, every root) and, for a root with a lane form (an NxH or a
    #: general MLP, the diode pair, the distilled root), the group sizes K of
    #: the lane-cooperative kernel
    lanes: Tuple[int, ...] = (1,)
    lanes_source: str = ""  # the lane form's prologue and step (device only)

    def arguments(self, circuit: Circuit, coeffs, params, static_controls, device):
        """(coefficient vector (NC,), row slots (NR, B), time slots
        (NQ, B, T)) as f32 on ``device``; empty where there are none.  A
        value held on the host is copied through ``runtime.profiler.h2d``."""
        vec, rows, times = [], [], []
        for (_, kind), (_, v) in zip(self.layout,
                                     _leaves(_bundle(circuit, coeffs, params, static_controls))):
            t = h2d(v, device)
            if kind == ROW:
                rows.append(t)
            elif kind == TIME:
                times.append(t)
            else:
                vec.append(t.reshape(-1))
        slots = [h2d(s, device)
                 for s in self.emitter.slots(coeffs[circuit.tree.name]["R"], params)]
        if self.emitter.r_kind == "row":
            rows += slots
        else:
            vec += [s.reshape(1) for s in slots]
        empty = torch.zeros(0, device=device)
        return (torch.cat(vec) if vec else empty,
                torch.stack(rows).contiguous() if rows else empty,
                torch.stack(times).contiguous() if times else empty)

    def unflatten(self, vec: torch.Tensor, rows: torch.Tensor, times: torch.Tensor,
                  t: Optional[int] = None):
        """(coeffs, params, static controls, root slots) rebuilt from the
        arguments as 0-d tensors, (B,) rows, time streams ((B,) at step
        ``t``, (B, T) without) and ``Matrix`` entries: the values the kernel
        gets."""
        items, i, j, k = [], 0, 0, 0
        for path, kind in self.layout:
            if kind == ROW:
                items.append((path, rows[j]))
                j += 1
            elif kind == TIME:
                items.append((path, times[k] if t is None else times[k][:, t]))
                k += 1
            elif kind:
                r, c = kind
                items.append((path, Matrix([[vec[i + a * c + b] for b in range(c)]
                                            for a in range(r)])))
                i += r * c
            else:
                items.append((path, vec[i]))
                i += 1
        tree = _nest(items)
        n = self.emitter.n_slots
        slots = ([rows[j + s] for s in range(n)] if self.emitter.r_kind == "row"
                 else [vec[i + s] for s in range(n)])
        return tree.get("coeffs", {}), tree.get("params", {}), tree.get("static", {}), slots


@dataclasses.dataclass(frozen=True)
class AdjointProgram:
    """The generated adjoint kernel of one circuit structure (the layout is
    its forward program's)."""

    source: str            # the whole .cu: the passes' steps, kernels, launch functions
    host_source: str       # the one-pass step, the passes' steps and host loops (tests)
    ops_per_sample: int    # counted from the emitted one-pass adjoint step
    jacobian_ops: int      # pass 1 a sample (the tangents), counted from its step
    recursion_ops: int     # pass 2 a sample (the contraction)
    n_entries: int         # floats a sample in the scratch between the passes
    n_state: int
    #: whether pass 1 writes the root's incident wave a and pass 2 the
    #: cotangent G of its reflected wave b at every sample (``root_streams``)
    root_streams: bool = False

    #: the scratch cap of one adjoint call: longer inputs run in time chunks
    SCRATCH_CAP_BYTES = 256 * 2 ** 20
    #: streams a block of pass 2 walks.  Pass 2 is paced by each SM's pull of
    #: its group's entries, so few streams are better spread thin: B = 1,024
    #: gives 128 blocks of 8 on 132 SMs
    GROUP = 8

    @staticmethod
    def padded(n_entries: int) -> int:
        """Floats a sample in the scratch: the entries padded to a multiple
        of 4 (16-byte words), at least 4."""
        return max(4, (n_entries + 3) // 4 * 4)

    def chunk(self, B: int, T: int) -> int:
        """Samples per time chunk: all T where the scratch of (B, T) stays
        under ``SCRATCH_CAP_BYTES``, else the longest multiple of 32 that
        does (at least 32)."""
        per_sample = 4 * self.scratch_floats(B, 1)
        if per_sample * T <= self.SCRATCH_CAP_BYTES:
            return T
        return max(32, self.SCRATCH_CAP_BYTES // per_sample // 32 * 32)

    def scratch_floats(self, B: int, tc: int) -> int:
        """The scratch of one chunk of tc samples: ``padded(n_entries)``
        floats a sample over ceil(B / GROUP) groups of GROUP streams."""
        g = self.GROUP
        return self.padded(self.n_entries) * (-(-B // g) * g) * tc


def _layout(circuit, coeffs, params, static_controls, batch=0, time=0):
    return tuple((path, _shape(v, batch, time)) for path, v in
                 _leaves(_bundle(circuit, coeffs, params, static_controls)))


def _symbols(tr: _Trace, layout, emitter: _RootEmitter):
    """The step's symbols of the slots: ((coeffs, params, static) trees,
    root slots, slot descriptions, (NC, NR, NQ))."""
    items, names = [], []
    c = r = q = 0
    for path, kind in layout:
        name = ".".join(path)
        if kind == ROW:
            items.append((path, Sym(tr, f"r[{r}]")))
            names.append(f"r[{r}] {name} (per row)")
            r += 1
        elif kind == TIME:
            items.append((path, Sym(tr, f"q[{q}]")))
            names.append(f"q[{q}] {name} (per sample)")
            q += 1
        elif kind:
            rr, cc = kind
            items.append((path, Matrix([[Sym(tr, f"c[{c + a * cc + b}]") for b in range(cc)]
                                        for a in range(rr)])))
            names.append(f"c[{c}..{c + rr * cc - 1}] {name} ({rr}x{cc}, row-major)")
            c += rr * cc
        else:
            items.append((path, Sym(tr, f"c[{c}]")))
            names.append(f"c[{c}] {name}")
            c += 1
    n = emitter.n_slots
    if emitter.r_kind == "row":
        root_slots = [Sym(tr, f"r[{r + k}]") for k in range(n)]
        if n:
            names.append(f"r[{r}..{r + n - 1}] root constants (per row)")
        r += n
    else:
        root_slots = [Sym(tr, f"c[{c + k}]") for k in range(n)]
        if n:
            names.append(f"c[{c}..{c + n - 1}] root constants")
        c += n
    tree = _nest(items)
    trees = tuple(tree.get(k, {}) for k in ("coeffs", "params", "static"))
    return trees, root_slots, names, (c, r, q)


def _controls(static_s, input_node, v):
    controls = {k: dict(x) for k, x in static_s.items()}
    controls.setdefault(input_node, {})["v"] = v
    return controls


def _used(kind: str, text: str) -> List[int]:
    """The indices of ``kind[...]`` slots that ``text`` reads."""
    return sorted({int(m) for m in re.findall(rf"\b{kind}\[(\d+)\]", text)})


def _prelude(circuit, emitter, input_node, state_order_, slot_names, counts, n_keep,
             prologue, what: str, ops: int) -> str:
    n_state = len(state_order_)
    nc, nr, nq = counts
    headers = "".join(f'#include "{h}"\n' for h in emitter.headers)
    comment = "\n".join(
        [f"// Tree: {_describe(circuit.tree)}; root {type(circuit.root).__name__} "
         f"{emitter.key()[1:]} (R_up {emitter.r_kind}); output V({circuit.outputs[0]}); "
         f"input {input_node}.v",
         "// State slots: " + ", ".join(f"z[{k}] {n}.{f}" for k, (n, f) in
                                        enumerate(state_order_)),
         f"// Slots ({nc} coefficients, {nr} per row, {nq} per sample):"]
        + [f"//   {s}" for s in slot_names]
        + [f"// Operations per sample (counted from the {what} step): {ops}"])
    body = "\n".join("  " + line for line in prologue)
    replaces = {"forward": "diffwdf_tpu/ops/fused_circuit.py, fused_circuit_process",
                "adjoint": "diffwdf_tpu/ops/parallel_bptt.py, _fused_backward_kernel"}[what]
    return f"""\
// Generated by diffwdf_tpu_torch.ops.circuit_codegen: the fused {what} step
// of one circuit structure.  Replaces the kernel body the Pallas TPU kernel
// traces ({replaces}).
{comment}
#include <cuda_runtime.h>
#include <math.h>

{headers}
#define CIRCUIT_NS {n_state}
#define CIRCUIT_NC {nc}
#define CIRCUIT_NR {nr}
#define CIRCUIT_NQ {nq}

namespace {{

// Once per stream: the root's per-stream values p[{max(n_keep, 1)}] from the
// coefficient slots c, the row slots r and the root array w.
__device__ __forceinline__ void circuit_prologue(const float* c, const float* r,
                                                 const float* w, float* p) {{
  (void)c;
  (void)r;
  (void)w;
  (void)p;
{body}
}}
"""


# ---------------------------------------------------------------------------
# The forward program
# ---------------------------------------------------------------------------


def _trace_forward(circuit: Circuit, layout, input_node: str, emitter: _RootEmitter,
                   lanes: bool = False):
    """The forward step's symbols and lines: (body lines, output ref,
    operations, root slots, slot descriptions, slot counts).  With ``lanes``
    the root is the NxH root's lane form."""
    order = state_order(circuit)
    tr = _Trace()
    (coeffs_s, params_s, static_s), root_slots, slot_names, counts = _symbols(tr, layout, emitter)
    state = _nest([((node, field), Sym(tr, f"s{k}")) for k, (node, field) in enumerate(order)])
    kw = {"lanes": True} if lanes else {}
    new_state, out = step(
        circuit, coeffs_s, state, _controls(static_s, input_node, Sym(tr, "v")),
        lambda a, r_up, ctl: emitter.emit(tr, a, r_up, root_slots, ctl, params_s, **kw))
    out = out if isinstance(out, Sym) else tr.const(float(out))
    writes = [f"z[{k}] = {new_state[node][field].ref};" for k, (node, field) in enumerate(order)]
    reads = [f"const float s{k} = z[{k}];" for k in range(len(order))]
    lines, ops = tr.live(" ".join(writes + [out.ref]))
    body = "\n".join("  " + line for line in reads + lines + writes)
    return body, out.ref, ops, root_slots, slot_names, counts


def generate(circuit: Circuit, layout, input_node: str, emitter: _RootEmitter,
             every_lane: bool = False, lane_threads: Optional[int] = None) -> CircuitProgram:
    """Trace ``circuit``'s step into a CircuitProgram for a slot ``layout``
    (``_layout``: the kinds and shapes of the adapted coefficients, params
    and static controls).  A root with a lane form gets it for the K of its
    ``lane_counts``: an NxH root (and a general MLP) for the K that
    ``fused_circuit.lanes_for`` can pick (with ``every_lane`` every K that
    divides H, or every hidden width), the diode pair for K = 2, the
    distilled root for ``cheb_lanes(segments)`` (with ``every_lane`` 4 and
    8); its blocks hold ``lane_threads`` threads (default the emitter's
    ``lane_threads``)."""
    _check_tree(circuit.tree)
    if len(circuit.outputs) != 1:
        raise ValueError(f"fused_circuit: one output probe, got {tuple(circuit.outputs)}")
    order = state_order(circuit)
    body, out_ref, ops, root_slots, slot_names, counts = _trace_forward(
        circuit, layout, input_node, emitter)
    nc, nr, nq = counts
    n_state = len(order)
    prelude = _prelude(circuit, emitter, input_node, order, slot_names, counts, emitter.n_keep,
                       emitter.prologue(root_slots), "forward", ops)
    step_source = prelude + f"""
// One sample: v the input, z[CIRCUIT_NS] the state (updated in place), the
// slots c, r and q (this step's per-sample values), the root array w and
// the prologue's p.  Returns the output.  Plain C: with the CUDA qualifiers
// defined away it compiles for the host.
__device__ __forceinline__ float circuit_step(float v, float* z, const float* c, const float* r,
                                              const float* q, const float* w, const float* p) {{
  (void)c;
  (void)r;
  (void)q;
  (void)w;
  (void)p;
{body}
  return {out_ref};
}}

}}  // namespace
"""
    zn, cn, rn, qn, pn = (max(x, 1) for x in (n_state, nc, nr, nq, emitter.n_keep))
    used_q = _used("q", body)
    q_loads = "".join(f"\n      tile_load(tiles[{1 + i}], times + static_cast<size_t>({j}) * B * "
                      f"T, B, T, b0, t0, tc);" for i, j in enumerate(used_q))
    q_reads = "".join(f"\n        q[{j}] = tiles[{1 + i}][threadIdx.x][k];"
                      for i, j in enumerate(used_q))
    seq0 = 1 + len(used_q)
    lane_counts = emitter.lane_counts(every_lane)
    lanes_source = lanes_kernel = ""
    if lane_counts:
        lanes_source, lanes_kernel = _lanes_parts(
            circuit, layout, input_node, emitter, body, lane_counts, (zn, cn, rn, qn, pn),
            lane_threads or emitter.lane_threads)
    lane_cases = "".join(
        f"\n    case {k}:\n      kernel = with_seq ? circuit_lanes_kernel<true, {k}> : "
        f"circuit_lanes_kernel<false, {k}>;\n      threads = CIRCUIT_LANE_THREADS;\n"
        "      break;" for k in lane_counts)
    kernel = f"""
#include "tile.cuh"
{lanes_kernel}
// One thread per stream over all T samples (lanes = 1): the state and the
// coefficient and row slots in registers, the root array in shared memory,
// (B, T) streams (the input, the per-sample slots this step reads, the
// output and the optional state trajectory) staged through shared memory in
// (128, 32) tiles for whole-line loads and stores.  Exact f32: no fast-math
// flags or intrinsics.  Launch bounds: {emitter.launch_bounds} (the root
// emitter's choice; see _RootEmitter.launch_bounds).
namespace {{

constexpr int kTimeTiles = {len(used_q)};  // per-sample slot streams the step reads

template <bool kSeq>
__global__ void __launch_bounds__({emitter.launch_bounds})
circuit_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
               float* __restrict__ out, float* __restrict__ zf, float* __restrict__ seq, int B,
               int T, const float* __restrict__ coef, const float* __restrict__ rows,
               const float* __restrict__ times, const float* __restrict__ warr, int n_warr,
               int writer) {{
  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < n_warr; i += blockDim.x) smem[i] = warr[i];
  __syncthreads();
  const float* sw = smem;
  Tile* tiles = reinterpret_cast<Tile*>(smem + ((n_warr + 3) & ~3));
  (void)times;
  (void)seq;
  (void)writer;
  float c[{cn}];
#pragma unroll
  for (int i = 0; i < CIRCUIT_NC; ++i) c[i] = coef[i];
  const int b0 = blockIdx.x * kTileRows;
  const int b = b0 + threadIdx.x;
  const bool live = b < B;
  float r[{rn}];
#pragma unroll
  for (int j = 0; j < CIRCUIT_NR; ++j) r[j] = live ? rows[static_cast<size_t>(j) * B + b] : 0.f;
  float p[{pn}];
  circuit_prologue(c, r, sw, p);
  float z[{zn}];
#pragma unroll
  for (int k = 0; k < CIRCUIT_NS; ++k) z[k] = live ? z0[static_cast<size_t>(k) * B + b] : 0.f;
  for (int t0 = 0; t0 < T; t0 += kTileCols) {{
    const int tc = min(kTileCols, T - t0);
    tile_load(tiles[0], vin, B, T, b0, t0, tc);{q_loads}
    for (int k = 0; k < tc; ++k) {{
      float q[{qn}];{q_reads}
      if (kSeq) {{
#pragma unroll
        for (int s = 0; s < CIRCUIT_NS; ++s) tiles[{seq0} + s][threadIdx.x][k] = z[s];
      }}
      tiles[0][threadIdx.x][k] = circuit_step(tiles[0][threadIdx.x][k], z, c, r, q, sw, p);
    }}
    tile_store(tiles[0], out, B, T, b0, t0, tc);
    if (kSeq) {{
      for (int s = 0; s < CIRCUIT_NS; ++s) {{
        tile_store(tiles[{seq0} + s], seq + static_cast<size_t>(s) * B * T, B, T, b0, t0, tc);
      }}
    }}
  }}
  if (live) {{
#pragma unroll
    for (int k = 0; k < CIRCUIT_NS; ++k) zf[static_cast<size_t>(k) * B + b] = z[k];
  }}
}}

}}  // namespace

extern "C" {{

// seq: (S, B, T) pre-step states, or null for none.  lanes: the lanes per
// stream, 1 or a group size K of the lane-cooperative kernel (none: 1 only);
// writer: the lane of a group that writes, 0 <= writer < lanes.
int circuit_launch(const float* vin, const float* z0, float* out, float* zf, float* seq, int B,
                   int T, const float* coef, const float* rows, const float* times,
                   const float* warr, int n_warr, int lanes, int writer, void* stream) {{
  if (writer < 0 || writer >= lanes) return static_cast<int>(cudaErrorInvalidValue);
  const bool with_seq = seq != nullptr;
  const int n_tiles = 1 + kTimeTiles + (with_seq ? CIRCUIT_NS : 0);
  decltype(&circuit_kernel<false>) kernel = nullptr;
  int threads = kTileRows;  // a block: kTileRows threads, or the lane kernel's
  switch (lanes) {{
    case 1:
      kernel = with_seq ? circuit_kernel<true> : circuit_kernel<false>;
      break;{lane_cases}
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }}
  const int rows_per_block = threads / lanes;  // streams per block
  const size_t smem = sizeof(float) * static_cast<size_t>((n_warr + 3) & ~3) +
                      sizeof(float) * static_cast<size_t>(rows_per_block) * (kTileCols + 1) *
                          static_cast<size_t>(n_tiles);
  if (smem > 48 * 1024) {{
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }}
  const int blocks = (B + rows_per_block - 1) / rows_per_block;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      vin, z0, out, zf, seq, B, T, coef, rows, times, warr, n_warr, writer);
  return static_cast<int>(cudaGetLastError());
}}

const char* circuit_error_string(int err) {{
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}}

}}  // extern "C"
"""
    host = f"""
// Host loop over streams and samples (CPU tests of the step); seq may be null.
extern "C" void circuit_host_run(const float* vin, const float* z0, float* out, float* zf,
                                 float* seq, int B, int T, const float* c, const float* rows,
                                 const float* times, const float* w) {{
  for (long b = 0; b < B; ++b) {{
    float r[{rn}], p[{pn}], z[{zn}];
    for (int j = 0; j < CIRCUIT_NR; ++j) r[j] = rows[j * B + b];
    circuit_prologue(c, r, w, p);
    for (int k = 0; k < CIRCUIT_NS; ++k) z[k] = z0[k * B + b];
    for (long t = 0; t < T; ++t) {{
      float q[{qn}];
      for (int j = 0; j < CIRCUIT_NQ; ++j) q[j] = times[(j * B + b) * T + t];
      if (seq) for (int k = 0; k < CIRCUIT_NS; ++k) seq[(k * B + b) * T + t] = z[k];
      out[b * T + t] = circuit_step(vin[b * T + t], z, c, r, q, w, p);
    }}
    for (int k = 0; k < CIRCUIT_NS; ++k) zf[k * B + b] = z[k];
  }}
}}
"""
    return CircuitProgram(
        source=step_source + lanes_source + kernel, step_source=step_source,
        host_source=step_source + host, state_order=order, layout=layout, input_node=input_node,
        n_coeffs=nc, n_rows=nr, n_times=nq, ops_per_sample=ops, emitter=emitter,
        lanes=(1,) + lane_counts, lanes_source=lanes_source)


def _tree_lines(emitter: _RootEmitter, body: str) -> List[str]:
    """The lines of a traced step that are not the root's own."""
    return [line for line in body.splitlines() if not emitter.own_line(line)]


def _lanes_parts(circuit, layout, input_node, emitter, body, lane_counts, sizes, lane_threads):
    """(the lane form's prologue and step, its kernel) for a root with a
    lane form (an NxH or a general MLP, the diode pair, the distilled root):
    the step traced again with the root's lane form; every line that is not
    the root's own is the one-thread step's (checked)."""
    zn, cn, rn, qn, pn = sizes
    lbody, lout, _, root_slots, _, _ = _trace_forward(circuit, layout, input_node, emitter,
                                                      lanes=True)
    if _tree_lines(emitter, body) != _tree_lines(emitter, lbody):
        raise AssertionError("the lane form's tree differs from the one-thread step's")
    prologue = "\n".join("  " + line for line in emitter.prologue_lanes(root_slots))
    weights_type, weights_load = emitter.lane_weights()
    headers = "".join(f'#include "{h}"\n' for h in emitter.lane_headers)
    source = f"""
// The lane form of the step (lane-cooperative kernel below; device only):
// the same tree lines on every lane of a group of K, the root's work split
// across the group (the header below); rank is the lane's place in its group.
{headers}
namespace {{

// the root's weights that a lane holds in registers (a root without lane
// weights holds none)
struct CircuitNoLaneWeights {{}};
{emitter.lane_definitions()}
template <int K>
using CircuitLaneWeights = {weights_type};

template <int K>
__device__ __forceinline__ void circuit_prologue_lanes(const float* c, const float* r,
                                                       const float* w, float* p, int rank) {{
  (void)c;
  (void)r;
  (void)w;
  (void)p;
  (void)rank;
{prologue}
}}

template <int K>
__device__ __forceinline__ float circuit_step_lanes(float v, float* z, const float* c,
                                                    const float* r, const float* q,
                                                    const float* w, const float* p, int rank,
                                                    const CircuitLaneWeights<K>& lw) {{
  (void)c;
  (void)r;
  (void)q;
  (void)w;
  (void)p;
{lbody}
  return {lout};
}}

}}  // namespace
"""
    used_q = _used("q", lbody)
    q_loads = "".join(f"\n      rows_load<R, CIRCUIT_LANE_THREADS>(tiles[{1 + i}], times + "
                      f"static_cast<size_t>({j}) * B * T, B, T, b0, t0, tc);"
                      for i, j in enumerate(used_q))
    q_reads = "".join(f"\n        q[{j}] = tiles[{1 + i}][row][k];" for i, j in enumerate(used_q))
    seq0 = 1 + len(used_q)
    kernel = f"""
// Lane-cooperative kernel (lanes = K in {{{", ".join(map(str, lane_counts))}}}): a group of K
// consecutive lanes serves one stream, so a block of CIRCUIT_LANE_THREADS
// threads holds R = CIRCUIT_LANE_THREADS / K streams.  What bounds the
// one-thread kernel on this card: each stream is one thread's chain of
// dependent operations a sample (a 2x16 MLP root's ~1,200, 1,168 of them the
// MLP's; a diode pair's two omega solves, whose IEEE divisions ptxas runs
// one after the other), one warp a scheduler at most.  Here every lane of a
// group runs the tree on the same values and ends each step with the same
// bits, so the state is replicated, not exchanged, and the root's work is
// split across the group: an NxH MLP's neurons (nxh_lanes.cuh; the chain a
// sample falls from H^2 L to ~H (L + 1) FMAs and shuffles; at many streams
// the issue rate bounds it, since every lane repeats the tree, and the
// launch then takes fewer lanes: ops/fused_circuit.py, lanes_for), a
// general MLP's hidden-layer outputs (mlp_dense_lanes.cuh, the same scheme
// for any widths and activations), the diode pair's two omega solves, one a
// lane (omega_lanes.cuh; the chain is one solve long), or the distilled
// root's Chebyshev segments, one a lane (cheb_lanes.cuh; the chain is one
// segment's Clenshaw recurrence, no loop over the segments and no load of
// the selected segment's coefficients).  One lane of a group (`writer`, 0
// but for the tests)
// writes the output, the final state and the trajectory, through (R, 32)
// tiles that the block stores as whole lines; rows past B run on zeros, so
// that every lane of a live warp shuffles.  Launch bounds
// (CIRCUIT_LANE_THREADS, 1): no register cap, so no spill.
#define CIRCUIT_LANE_THREADS {lane_threads}  // the root emitter's lane_threads
namespace {{

template <bool kSeq, int K>
__global__ void __launch_bounds__(CIRCUIT_LANE_THREADS, 1)
circuit_lanes_kernel(const float* __restrict__ vin, const float* __restrict__ z0,
                     float* __restrict__ out, float* __restrict__ zf, float* __restrict__ seq,
                     int B, int T, const float* __restrict__ coef,
                     const float* __restrict__ rows, const float* __restrict__ times,
                     const float* __restrict__ warr, int n_warr, int writer) {{
  constexpr int R = CIRCUIT_LANE_THREADS / K;  // streams per block
  extern __shared__ float4 lanes_smem[];  // 16-byte aligned: the root array's blocks
  float* smem = reinterpret_cast<float*>(lanes_smem);
  for (int i = threadIdx.x; i < n_warr; i += blockDim.x) smem[i] = warr[i];
  __syncthreads();
  const float* sw = smem;
  RowTile<R>* tiles = reinterpret_cast<RowTile<R>*>(smem + ((n_warr + 3) & ~3));
  (void)times;
  (void)seq;
  float c[{cn}];
#pragma unroll
  for (int i = 0; i < CIRCUIT_NC; ++i) c[i] = coef[i];
  const int rank = threadIdx.x % K;  // the lane's place in its stream's group
  const int row = threadIdx.x / K;
  const bool lead = rank == writer;  // the lane that writes the group's streams (0; the
                                     // tests run every lane as the writer)
  const int b0 = blockIdx.x * R;
  const int b = b0 + row;
  const bool live = b < B;
  float r[{rn}];
#pragma unroll
  for (int j = 0; j < CIRCUIT_NR; ++j) r[j] = live ? rows[static_cast<size_t>(j) * B + b] : 0.f;
  float p[{pn}];
  circuit_prologue_lanes<K>(c, r, sw, p, rank);
  CircuitLaneWeights<K> lw;
  {{
    const float* w = sw;
    {weights_load}
  }}
  float z[{zn}];
#pragma unroll
  for (int k = 0; k < CIRCUIT_NS; ++k) z[k] = live ? z0[static_cast<size_t>(k) * B + b] : 0.f;
  for (int t0 = 0; t0 < T; t0 += kTileCols) {{
    const int tc = min(kTileCols, T - t0);
    rows_load<R, CIRCUIT_LANE_THREADS>(tiles[0], vin, B, T, b0, t0, tc);{q_loads}
    for (int k = 0; k < tc; ++k) {{
      float q[{qn}];{q_reads}
      if (kSeq && lead) {{
#pragma unroll
        for (int s = 0; s < CIRCUIT_NS; ++s) tiles[{seq0} + s][row][k] = z[s];
      }}
      const float y = circuit_step_lanes<K>(tiles[0][row][k], z, c, r, q, sw, p, rank, lw);
      __syncwarp();  // every lane of the group has read v_t
      if (lead) tiles[0][row][k] = y;
    }}
    rows_store<R, CIRCUIT_LANE_THREADS>(tiles[0], out, B, T, b0, t0, tc);
    if (kSeq) {{
      for (int s = 0; s < CIRCUIT_NS; ++s) {{
        rows_store<R, CIRCUIT_LANE_THREADS>(tiles[{seq0} + s], seq + static_cast<size_t>(s) * B * T,
                                            B, T, b0, t0, tc);
      }}
    }}
  }}
  if (live && lead) {{
#pragma unroll
    for (int k = 0; k < CIRCUIT_NS; ++k) zf[static_cast<size_t>(k) * B + b] = z[k];
  }}
}}

}}  // namespace
"""
    return source, kernel


# ---------------------------------------------------------------------------
# The adjoint program
# ---------------------------------------------------------------------------


def _dual(x, n: int) -> Dual:
    if isinstance(x, Dual):
        return x
    return Dual(x, (None,) * n)


def _scan_shape(n_entries: int, n_out: int) -> Tuple[int, int]:
    """(steps per pipeline slab of a group's entries, stages in the ring) of
    the recursion kernel: a ring of about 128 KB of shared memory beside the
    n_out output tiles (S + 1, and one more for G where the program writes
    the root's streams), at least two stages, at most 16; a slab is 32
    steps (fewer for very wide states), a divisor of the 32 columns of an
    output tile."""
    g = AdjointProgram.GROUP
    step_bytes = g * AdjointProgram.padded(n_entries) * 4
    slab = 32
    tiles = n_out * g * 33 * 4
    while slab > 1 and 2 * slab * step_bytes + tiles > 200 * 1024:
        slab //= 2
    stages = max(2, min(16, (128 * 1024) // (slab * step_bytes)))
    return slab, stages


def root_streams(emitter: _RootEmitter) -> bool:
    """Whether the adjoint of a program with this root writes the root's
    streams for the parameter pass (B4's pass 3 on the card): an NxH root
    (widths 4, 8, 16, at least one hidden layer) whose port impedance is one
    value or one per row.  A per-sample R_up, and every other root, leave
    the root's cotangents to autograd (``parallel_bptt``)."""
    return isinstance(emitter, _NeuralEmitter) and emitter.r_kind in ("scalar", "row")


def generate_adjoint(circuit: Circuit, prog: CircuitProgram) -> AdjointProgram:
    """The adjoint of ``prog``'s circuit structure: per step, from v_t,
    obar_t, z_{t-1} and the carried lam = lam_t, g_vin_t = (dF/dv)^T (lam,
    obar) and lam_{t-1} = (dF/dz)^T (lam, obar), by S + 1 tangents of the
    traced step.

    Where :func:`root_streams` holds, one more direction, the root's
    reflected wave b itself (the "b column": the step is linear in b), gives
    G_t = (dF/db)^T (lam_t, obar_t), the cotangent of b (and so -G that of
    the MLP's output y = -b): pass 1 stores the b column's entries after the
    others and writes the root's incident wave a, pass 2 contracts them with
    lam_t before its update and writes G.

    The device runs it in two passes.  The tangents depend on the trajectory
    alone, so the **Jacobian step** (every (b, t) independent) writes the
    tangents new[i].d[k] and the products out.d[k] obar_t that are not exact
    constants ("entries", E <= (S + 1)^2 floats a sample); the
    **recursion step** then contracts them with lam in ``pull``'s order and
    rounding.  The one-pass ``circuit_adjoint_step`` (tangents and
    contraction in one step, whose operations ``ops_per_sample`` counts)
    is in the host source alone, as the reference of the two."""
    emitter = prog.emitter
    order = prog.state_order
    streams = root_streams(emitter)
    S = len(order)
    n_dir = S + 1 + streams  # each state, v, and b where the root's streams are written
    tr = _Trace()
    (coeffs_s, params_s, static_s), root_slots, slot_names, counts = _symbols(
        tr, prog.layout, emitter)
    nc, nr, nq = counts
    one = tr.const(1.0)

    def basis(k):
        return tuple(one if i == k else None for i in range(n_dir))

    state = _nest([((node, field), Dual(Sym(tr, f"s{k}"), basis(k)))
                   for k, (node, field) in enumerate(order)])
    v = Dual(Sym(tr, "v"), basis(S))
    root_a: List[Sym] = []  # the root's incident wave, for pass 1 to write

    def root_fn(a, r_up, ctl):
        if emitter.traced:
            return emitter.emit(tr, a, r_up, root_slots, ctl, params_s)
        a = _dual(a, n_dir)
        n = len(tr.entries)
        b = emitter.emit(tr, a.p, r_up, root_slots, ctl, params_s)  # dropped: no tangent reads it
        tr.entries[n:] = [e for e in tr.entries[n:] if e[0] is not None]  # and its comment
        m = emitter.emit_slope(tr, a.p, r_up, root_slots, ctl, params_s)
        root_a.append(a.p)
        d = [_tmul(x, m) for x in a.d]
        if streams:  # a is read before b is made: its tangent along b is zero
            d[S + 1] = one
        return Dual(b, d)

    new_state, out = step(circuit, coeffs_s, state, _controls(static_s, prog.input_node, v),
                          root_fn)
    out = _dual(out if isinstance(out, Symbolic) else tr.const(float(out)), n_dir)
    new = [_dual(new_state[node][field], n_dir) for node, field in order]
    lam = [Sym(tr, f"l{k}") for k in range(S)]
    go = Sym(tr, "go")

    def pull(k):
        """sum_i dF_i/d(direction k) lam_i + dF_o/d(direction k) obar."""
        acc = None
        for z_new, l in zip(new, lam):
            acc = _tadd(acc, _tmul(z_new.d[k], l))
        return _tadd(acc, _tmul(out.d[k], go)) or tr.const(0.0)

    lam_new = [pull(k) for k in range(S)]
    g_vin = pull(S)
    writes = [f"lam[{k}] = {lam_new[k].ref};" for k in range(S)]
    lines, ops = tr.live(" ".join(writes + [g_vin.ref]))
    used = set(_WORD.findall(" ".join(lines + writes + [g_vin.ref])))
    reads = ([f"const float s{k} = z[{k}];" for k in range(S) if f"s{k}" in used]
             + [f"const float l{k} = lam[{k}];" for k in range(S) if f"l{k}" in used])
    body = "\n".join("  " + line for line in reads + lines + writes)

    # --- the two passes: the entries pull reads, then pull on them ----------
    stored: List[str] = []

    def entry(x: Optional[Sym]):
        """None (an exact zero), ("const", value) or ("J", index): a
        non-constant symbol is stored once, whatever reads it."""
        if x is None:
            return None
        if x.value is not None:
            return ("const", x.value)
        if x.ref not in stored:
            stored.append(x.ref)
        return ("J", stored.index(x.ref))

    cols = [[entry(z_new.d[k]) for z_new in new] + [entry(_tmul(out.d[k], go))]
            for k in range(n_dir)]
    n_entries = len(stored)
    e4 = AdjointProgram.padded(n_entries)
    j_writes = [f"J[{m}] = {ref};" for m, ref in enumerate(stored)]
    if streams:
        j_writes.append(f"*ra = {root_a[0].ref};")
    j_lines, j_ops = tr.live(" ".join(j_writes))
    j_used = set(_WORD.findall(" ".join(j_lines + j_writes)))
    j_reads = [f"const float s{k} = z[{k}];" for k in range(S) if f"s{k}" in j_used]
    j_body = "\n".join("  " + line for line in j_reads + j_lines + j_writes)

    tr2 = _Trace()
    lam2 = [Sym(tr2, f"l{k}") for k in range(S)]

    def sym2(e):
        if e is None:
            return None
        return tr2.const(e[1]) if e[0] == "const" else Sym(tr2, f"J[{e[1]}]")

    def pull2(k):
        """pull(k) on the stored entries: the same operations in the same
        order, so the same bits."""
        acc = None
        for i in range(S):
            acc = _tadd(acc, _tmul(sym2(cols[k][i]), lam2[i]))
        return _tadd(acc, sym2(cols[k][S])) or tr2.const(0.0)

    lam_new2 = [pull2(k) for k in range(S)]
    g_vin2 = pull2(S)
    r_writes = [f"lam[{k}] = {lam_new2[k].ref};" for k in range(S)]
    if streams:  # G from lam_t, before the update
        r_writes.append(f"*rg = {pull2(S + 1).ref};")
    r_lines, r_ops = tr2.live(" ".join(r_writes + [g_vin2.ref]))
    r_used = set(_WORD.findall(" ".join(r_lines + r_writes + [g_vin2.ref])))
    r_reads = [f"const float l{k} = lam[{k}];" for k in range(S) if f"l{k}" in r_used]
    r_body = "\n".join("  " + line for line in r_reads + r_lines + r_writes)
    slab, stages = _scan_shape(n_entries, S + 1 + streams)

    prelude = _prelude(circuit, emitter, prog.input_node, order, slot_names, counts,
                       emitter.n_keep, emitter.prologue(root_slots), "adjoint", ops)
    one_pass = f"""
// One reverse step at sample t: v = v_t, go = the output's cotangent obar_t,
// z[CIRCUIT_NS] = z_(t-1) the pre-step state, lam[CIRCUIT_NS] = lam_t on
// entry and lam_(t-1) on return; the slots as the forward step's.  Returns
// the input's cotangent g_vin_t.  Plain C, as the forward step.  The
// reference of the two passes below.
__device__ __forceinline__ float circuit_adjoint_step(float v, float go, const float* z,
                                                      float* lam, const float* c,
                                                      const float* r, const float* q,
                                                      const float* w, const float* p) {{
  (void)v;
  (void)go;
  (void)z;
  (void)lam;
  (void)c;
  (void)r;
  (void)q;
  (void)w;
  (void)p;
{body}
  return {g_vin.ref};
}}
"""
    passes = f"""
#define CIRCUIT_NE {n_entries}
#define CIRCUIT_NE4 {e4}  // floats a sample in the scratch: CIRCUIT_NE padded to 4 (at least 4)
#define CIRCUIT_GROUP {AdjointProgram.GROUP}  // streams a block of pass 2 walks
// 1: pass 1 writes the root's incident wave a, pass 2 the cotangent G of
// its reflected wave b (an NxH root, R_up one value or one per row)
#define CIRCUIT_ROOT_STREAMS {int(streams)}

// Pass 1 at sample t: the CIRCUIT_NE entries J[m] that the recursion step
// reads (the tangents of the step and the output's tangents times go that
// are not exact constants; with CIRCUIT_ROOT_STREAMS the b column's last),
// and with CIRCUIT_ROOT_STREAMS the root's incident wave in *ra.
// Operations: {j_ops}.
__device__ __forceinline__ void circuit_jacobian_step(float v, float go, const float* z,
                                                      float* J, float* ra, const float* c,
                                                      const float* r, const float* q,
                                                      const float* w, const float* p) {{
  (void)v;
  (void)go;
  (void)z;
  (void)J;
  (void)ra;
  (void)c;
  (void)r;
  (void)q;
  (void)w;
  (void)p;
{j_body}
}}

// Pass 2 at sample t: lam = lam_t on entry, lam_(t-1) on return; returns
// g_vin_t.  circuit_adjoint_step's contraction on the stored entries, in its
// order and rounding; with CIRCUIT_ROOT_STREAMS also G_t (the b column
// contracted with lam_t) in *rg.  Operations: {r_ops}.
__device__ __forceinline__ float circuit_recursion_step(const float* J, float* lam, float* rg) {{
  (void)J;
  (void)lam;
  (void)rg;
{r_body}
  return {g_vin2.ref};
}}

// Where entry m of sample (b, t) of a chunk of tc samples lives in the
// scratch: [b / g][t][b % g][m] for stream groups of g = CIRCUIT_GROUP, so
// that a group's steps are contiguous for pass 2 (whole slabs in one bulk
// copy) and each stream's entries of a step are 16-byte words (pass 1
// stores them as such, pass 2 loads them as such).
__host__ __device__ __forceinline__ size_t circuit_jac_index(int b, int t, int m, int tc) {{
  constexpr int g = CIRCUIT_GROUP;
  return ((static_cast<size_t>(b / g) * tc + t) * g + b % g) * CIRCUIT_NE4 + m;
}}

}}  // namespace
"""
    zn, cn, rn, qn, pn = (max(x, 1) for x in (S, nc, nr, nq, emitter.n_keep))
    q0 = 2 + S
    jq_used = _used("q", j_body)
    jq_loads = "".join(f"\n  tile_load(tiles[{q0 + i}], times + static_cast<size_t>({j}) * B * T, "
                       f"B, T, b0, t0 + s0, n);" for i, j in enumerate(jq_used))
    jq_reads = "".join(f"\n    q[{j}] = tiles[{q0 + i}][threadIdx.x][k];"
                       for i, j in enumerate(jq_used))
    kernel = f"""
#include "bulk_copy.cuh"
#include "tile.cuh"

// The adjoint on the card: pass 1 (circuit_jacobian_kernel) and pass 2
// (circuit_recursion_kernel) over one chunk of time [t0, t0 + tc), chained
// by the wrapper (ops/parallel_bptt.py, launch_adjoint) from the last chunk
// to the first.  Replaces the Pallas TPU kernel
// diffwdf_tpu/ops/parallel_bptt.py, _fused_backward_kernel.
//
// Why two passes: one thread per stream walking all T steps, the S + 1
// tangents of the step and the contraction per step, is one stream's chain
// of ~2,450 dependent operations a sample (the NxH root's slope), 8 blocks
// at B = 1,024 on 132 SMs.  But the tangents depend on the trajectory
// alone, not on lam: only the contraction is a chain.  So pass 1
// gives every (b, t) sample its own thread and fills the card (bound by the
// card's f32 issue rate: the tanh-heavy tangent of the MLP); pass 2 is the
// chain, S^2 + S multiply-adds a step on CIRCUIT_NE stored floats, bound by
// how fast the SMs that walk it pull the scratch.
//
// Scratch: CIRCUIT_NE4 = {e4} floats a sample (CIRCUIT_NE = {n_entries} entries
// padded), ceil(B / g) g tc samples in all (g = CIRCUIT_GROUP; 168 MB for
// the Tube Screamer 2x16 at (1024, 2048), its 16 tangents and 4 of the b
// column), laid out by circuit_jac_index; the wrapper allocates it and cuts
// time into chunks under its cap.
// Exact f32, uncontracted as the step's lines are: the two
// passes give the one-pass step's bits (circuit_adjoint_step of the host
// source).
namespace {{

constexpr int kE4 = CIRCUIT_NE4;
constexpr int kGroup = CIRCUIT_GROUP;
constexpr int kSlab = {slab};          // steps per pipeline stage of pass 2
constexpr int kStages = {stages};        // stages in the ring (kStages - 1 in flight)
constexpr int kSlabFloats = kSlab * kGroup * kE4;  // one stage

// Pass 1: block (x, y) takes streams 128 x .. 128 x + 127 over chunk samples
// 32 y .. 32 y + 31: v, obar, the trajectory and the per-sample slots come
// in as (128, 32) tiles (whole lines), each thread runs the Jacobian step
// of its stream for the 32 samples (its row prologue once) and writes the
// entries as 16-byte words.  Lanes past B in the last group of kGroup
// compute on zeros and are written, never read out.  Where the program
// writes the root's streams, each step's a takes its v's place in the
// input tile, which then goes out to aseq (B, T) as whole lines.
__global__ void __launch_bounds__({emitter.launch_bounds})
circuit_jacobian_kernel(const float* __restrict__ vin, const float* __restrict__ gout,
                        const float* __restrict__ zseq, float* __restrict__ jac,
                        float* __restrict__ aseq, int B, int T,
                        int t0, int tc, const float* __restrict__ coef,
                        const float* __restrict__ rows, const float* __restrict__ times,
                        const float* __restrict__ warr, int n_warr) {{
  extern __shared__ float smem[];
  for (int i = threadIdx.x; i < n_warr; i += blockDim.x) smem[i] = warr[i];
  __syncthreads();
  const float* sw = smem;
  Tile* tiles = reinterpret_cast<Tile*>(smem + ((n_warr + 3) & ~3));
  (void)times;
  float c[{cn}];
#pragma unroll
  for (int i = 0; i < CIRCUIT_NC; ++i) c[i] = coef[i];
  const int b0 = blockIdx.x * kTileRows;
  const int b = b0 + threadIdx.x;
  const bool live = b < B;
  const bool padded = b < (B + kGroup - 1) / kGroup * kGroup;  // inside the scratch
  float r[{rn}];
#pragma unroll
  for (int j = 0; j < CIRCUIT_NR; ++j) r[j] = live ? rows[static_cast<size_t>(j) * B + b] : 0.f;
  float p[{pn}];
  circuit_prologue(c, r, sw, p);
  const int s0 = blockIdx.y * kTileCols;
  const int n = min(kTileCols, tc - s0);
  tile_load(tiles[0], vin, B, T, b0, t0 + s0, n);
  tile_load(tiles[1], gout, B, T, b0, t0 + s0, n);
  for (int s = 0; s < CIRCUIT_NS; ++s) {{
    tile_load(tiles[2 + s], zseq + static_cast<size_t>(s) * B * T, B, T, b0, t0 + s0, n);
  }}{jq_loads}
  for (int k = 0; k < n; ++k) {{
    float z[{zn}];
#pragma unroll
    for (int s = 0; s < CIRCUIT_NS; ++s) z[s] = tiles[2 + s][threadIdx.x][k];
    float q[{qn}];{jq_reads}
    float J[kE4];
#pragma unroll
    for (int m = CIRCUIT_NE; m < kE4; ++m) J[m] = 0.f;
    float ra = 0.f;
    circuit_jacobian_step(tiles[0][threadIdx.x][k], tiles[1][threadIdx.x][k], z, J, &ra, c, r, q,
                          sw, p);
    if (CIRCUIT_ROOT_STREAMS) tiles[0][threadIdx.x][k] = ra;  // this thread's v, read
    if (padded) {{
      float4* dst = reinterpret_cast<float4*>(jac + circuit_jac_index(b, s0 + k, 0, tc));
#pragma unroll
      for (int i = 0; i < kE4 / 4; ++i) {{
        dst[i] = make_float4(J[4 * i], J[4 * i + 1], J[4 * i + 2], J[4 * i + 3]);
      }}
    }}
  }}
  if (CIRCUIT_ROOT_STREAMS) tile_store(tiles[0], aseq, B, T, b0, t0 + s0, n);
}}

// Pass 2: one warp per group of kGroup streams (a block each, so that the
// groups spread over the SMs: 128 blocks at B = 1,024), walking the chunk
// from its last sample to its first.  One warp's chain of S^2 + S
// multiply-adds a step is short; the pace is set by how fast one SM pulls
// its group's entries (kGroup E floats a step).  So the entries stream into
// a ring of kStages stages in shared memory by bulk copies (the Tensor
// Memory Accelerator: one lane issues a whole slab of kSlab steps,
// contiguous in the scratch, and an mbarrier counts its bytes), kStages - 1
// slabs in flight; each active lane reads its stream's entries of a step as
// 16-byte words.  lam_t (before the update) and g_vin go out through
// (kGroup, 32) tiles as whole lines (16-byte stores where T allows).
// lam_in and lam_out may alias: each thread reads its own stream's lam
// first and writes it last.  Where the program writes the root's streams,
// G goes out through one more tile to gseq (B, T).
__global__ void __launch_bounds__(32, 1)
circuit_recursion_kernel(const float* __restrict__ jac, const float* lam_in, float* lam_out,
                         float* __restrict__ lam_seq, float* __restrict__ gvin,
                         float* __restrict__ gseq, int B, int T, int t0, int tc) {{
  extern __shared__ float4 smem4[];
  __shared__ unsigned long long full[kStages];  // one mbarrier a stage
  float* ring = reinterpret_cast<float*>(smem4);
  // lam_t (CIRCUIT_NS tiles), g_vin, and G where the program writes it
  float (*otile)[kGroup][kTileCols + 1] =
      reinterpret_cast<float (*)[kGroup][kTileCols + 1]>(ring + kStages * kSlabFloats);
  const int lane = threadIdx.x;
  const bool active = lane < kGroup;
  const int b = blockIdx.x * kGroup + lane;
  const bool live = active && b < B;
  const float* src = jac + static_cast<size_t>(blockIdx.x) * tc * kGroup * kE4;
  float lam[{zn}];
#pragma unroll
  for (int s = 0; s < CIRCUIT_NS; ++s) lam[s] = live ? lam_in[static_cast<size_t>(s) * B + b] : 0.f;
  if (lane == 0) {{
    for (int i = 0; i < kStages; ++i) mbar_init(&full[i], 1);
    mbar_fence_init();
  }}
  __syncwarp();
  const int n_slabs = (tc + kSlab - 1) / kSlab;
  // the u-th slab walked (slab n_slabs - 1 - u) into stage u % kStages
  auto issue = [&](int u) {{
    if (lane == 0 && u < n_slabs && CIRCUIT_NE > 0) {{
      const int j = n_slabs - 1 - u;
      const int n = min(kSlab, tc - j * kSlab);
      const unsigned bytes = static_cast<unsigned>(n) * kGroup * kE4 * sizeof(float);
      mbar_expect_tx(&full[u % kStages], bytes);
      bulk_copy(ring + (u % kStages) * kSlabFloats, src + static_cast<size_t>(j) * kSlabFloats,
                bytes, &full[u % kStages]);
    }}
  }};
  // one step: this lane's entries of it at e, its column in the output tiles
  auto step = [&](const float* e, int col) {{
    float J[kE4];
#pragma unroll
    for (int i = 0; i < kE4 / 4; ++i) {{
      const float4 x = reinterpret_cast<const float4*>(e)[i];
      J[4 * i] = x.x;
      J[4 * i + 1] = x.y;
      J[4 * i + 2] = x.z;
      J[4 * i + 3] = x.w;
    }}
#pragma unroll
    for (int s = 0; s < CIRCUIT_NS; ++s) otile[s][lane][col] = lam[s];  // lam_t
    float rg = 0.f;
    otile[CIRCUIT_NS][lane][col] = circuit_recursion_step(J, lam, &rg);
    if (CIRCUIT_ROOT_STREAMS) otile[CIRCUIT_NS + 1][lane][col] = rg;
  }};
  const bool vec_out = T % 4 == 0;  // 16-byte stores of whole tiles
  for (int u = 0; u < kStages - 1; ++u) issue(u);
  for (int u = 0; u < n_slabs; ++u) {{
    issue(u + kStages - 1);  // into the stage that slab u - 1 left
    if (CIRCUIT_NE > 0) mbar_wait(&full[u % kStages], (u / kStages) & 1);  // slab u has landed
    const int j = n_slabs - 1 - u;
    const float* mine = ring + (u % kStages) * kSlabFloats + lane * kE4;
    const int n = min(kSlab, tc - j * kSlab);
    if (active) {{
      for (int k = n - 1; k >= 0; --k) step(mine + k * kGroup * kE4, (j * kSlab + k) % kTileCols);
    }}
    __syncwarp();
    // flush each output tile whose first column this slab wrote
    for (int tb = (j * kSlab + kTileCols - 1) / kTileCols * kTileCols; tb < j * kSlab + n;
         tb += kTileCols) {{
      const int nb = min(kTileCols, tc - tb);
      if (vec_out && nb == kTileCols) {{
        for (int i = lane; i < kGroup * kTileCols / 4; i += 32) {{
          const int rr = i / (kTileCols / 4), cc = 4 * (i % (kTileCols / 4));
          const int bb = blockIdx.x * kGroup + rr;
          if (bb < B) {{
            const size_t at = static_cast<size_t>(bb) * T + t0 + tb + cc;
#pragma unroll
            for (int s = 0; s <= CIRCUIT_NS + CIRCUIT_ROOT_STREAMS; ++s) {{
              float* dst = s < CIRCUIT_NS ? lam_seq + static_cast<size_t>(s) * B * T + at
                                          : (s == CIRCUIT_NS ? gvin : gseq) + at;
              *reinterpret_cast<float4*>(dst) = make_float4(otile[s][rr][cc], otile[s][rr][cc + 1],
                                                            otile[s][rr][cc + 2],
                                                            otile[s][rr][cc + 3]);
            }}
          }}
        }}
      }} else {{
        for (int i = lane; i < kGroup * kTileCols; i += 32) {{
          const int rr = i / kTileCols, cc = i % kTileCols;
          const int bb = blockIdx.x * kGroup + rr;
          if (bb < B && cc < nb) {{
            const size_t at = static_cast<size_t>(bb) * T + t0 + tb + cc;
#pragma unroll
            for (int s = 0; s < CIRCUIT_NS; ++s) {{
              lam_seq[static_cast<size_t>(s) * B * T + at] = otile[s][rr][cc];
            }}
            gvin[at] = otile[CIRCUIT_NS][rr][cc];
            if (CIRCUIT_ROOT_STREAMS) gseq[at] = otile[CIRCUIT_NS + CIRCUIT_ROOT_STREAMS][rr][cc];
          }}
        }}
      }}
    }}
    __syncwarp();  // stage u % kStages and the tiles are free again
  }}
  if (live) {{
#pragma unroll
    for (int s = 0; s < CIRCUIT_NS; ++s) lam_out[static_cast<size_t>(s) * B + b] = lam[s];
  }}
}}

cudaError_t allow_smem(const void* kernel, size_t smem) {{
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(smem));
}}

}}  // namespace

extern "C" {{

// Pass 1 over samples [t0, t0 + tc) of the (B, T) streams into jac
// (circuit_jac_index with tc); with CIRCUIT_ROOT_STREAMS also the root's
// incident wave into aseq (B, T) there (else aseq is not read).
int circuit_jacobian_launch(const float* vin, const float* gout, const float* zseq, float* jac,
                            float* aseq, int B, int T, int t0, int tc, const float* coef,
                            const float* rows, const float* times, const float* warr,
                            int n_warr, void* stream) {{
  const size_t smem = sizeof(float) * static_cast<size_t>((n_warr + 3) & ~3) +
                      sizeof(Tile) * static_cast<size_t>(2 + CIRCUIT_NS + {len(jq_used)});
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(circuit_jacobian_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((B + kTileRows - 1) / kTileRows, (tc + kTileCols - 1) / kTileCols);
  circuit_jacobian_kernel<<<grid, kTileRows, smem, static_cast<cudaStream_t>(stream)>>>(
      vin, gout, zseq, jac, aseq, B, T, t0, tc, coef, rows, times, warr, n_warr);
  return static_cast<int>(cudaGetLastError());
}}

// Pass 2 over samples t0 + tc - 1 ... t0: lam_in (S, B) = lam at t0 + tc,
// lam_out (S, B) = lam at t0 (may be lam_in); writes lam_seq (S, B, T) and
// g_vin (B, T) there, and with CIRCUIT_ROOT_STREAMS G into gseq (B, T)
// (else gseq is not read).
int circuit_recursion_launch(const float* jac, const float* lam_in, float* lam_out,
                             float* lam_seq, float* gvin, float* gseq, int B, int T, int t0,
                             int tc, void* stream) {{
  const size_t smem = sizeof(float) * (static_cast<size_t>(kStages) * kSlabFloats +
                                       static_cast<size_t>(CIRCUIT_NS + 1 + CIRCUIT_ROOT_STREAMS) *
                                           kGroup * (kTileCols + 1));
  const cudaError_t e = allow_smem(reinterpret_cast<const void*>(circuit_recursion_kernel), smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  circuit_recursion_kernel<<<(B + kGroup - 1) / kGroup, 32, smem,
                             static_cast<cudaStream_t>(stream)>>>(jac, lam_in, lam_out, lam_seq,
                                                                  gvin, gseq, B, T, t0, tc);
  return static_cast<int>(cudaGetLastError());
}}

const char* circuit_error_string(int err) {{
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}}

}}  // extern "C"
"""
    host = f"""
// Host loop over streams, t = T-1 ... 0 (CPU tests of the adjoint step).
extern "C" void circuit_adjoint_host_run(const float* vin, const float* gout, const float* zseq,
                                         const float* lam_t, float* lam_seq, float* gvin,
                                         float* gz0, int B, int T, const float* c,
                                         const float* rows, const float* times, const float* w) {{
  for (long b = 0; b < B; ++b) {{
    float r[{rn}], p[{pn}], lam[{zn}];
    for (int j = 0; j < CIRCUIT_NR; ++j) r[j] = rows[j * B + b];
    circuit_prologue(c, r, w, p);
    for (int s = 0; s < CIRCUIT_NS; ++s) lam[s] = lam_t[s * B + b];
    for (long t = T - 1; t >= 0; --t) {{
      float z[{zn}], q[{qn}];
      for (int s = 0; s < CIRCUIT_NS; ++s) {{
        z[s] = zseq[(s * B + b) * T + t];
        lam_seq[(s * B + b) * T + t] = lam[s];
      }}
      for (int j = 0; j < CIRCUIT_NQ; ++j) q[j] = times[(j * B + b) * T + t];
      gvin[b * T + t] = circuit_adjoint_step(vin[b * T + t], gout[b * T + t], z, lam, c, r, q,
                                             w, p);
    }}
    for (int s = 0; s < CIRCUIT_NS; ++s) gz0[s * B + b] = lam[s];
  }}
}}

// The two passes on the host over samples [t0, t0 + tc) (CPU tests): pass 1
// into jac (circuit_jac_index, ceil(B / g) g tc CIRCUIT_NE4 floats for
// g = CIRCUIT_GROUP), then pass 2 from lam_in to lam_out, as the kernels do,
// with the root's streams into aseq and gseq where the program writes them.
extern "C" void circuit_jacobian_host_run(const float* vin, const float* gout,
                                          const float* zseq, float* jac, float* aseq, int B,
                                          int T, int t0, int tc, const float* c,
                                          const float* rows, const float* times,
                                          const float* w) {{
  for (long b = 0; b < B; ++b) {{
    float r[{rn}], p[{pn}];
    for (int j = 0; j < CIRCUIT_NR; ++j) r[j] = rows[j * B + b];
    circuit_prologue(c, r, w, p);
    for (int k = 0; k < tc; ++k) {{
      const long t = t0 + k;
      float z[{zn}], q[{qn}], J[{e4}], ra = 0.f;
      for (int s = 0; s < CIRCUIT_NS; ++s) z[s] = zseq[(s * B + b) * T + t];
      for (int j = 0; j < CIRCUIT_NQ; ++j) q[j] = times[(j * B + b) * T + t];
      circuit_jacobian_step(vin[b * T + t], gout[b * T + t], z, J, &ra, c, r, q, w, p);
      for (int m = 0; m < CIRCUIT_NE; ++m) jac[circuit_jac_index(b, k, m, tc)] = J[m];
      if (CIRCUIT_ROOT_STREAMS) aseq[b * T + t] = ra;
    }}
  }}
}}

extern "C" void circuit_recursion_host_run(const float* jac, const float* lam_in, float* lam_out,
                                           float* lam_seq, float* gvin, float* gseq, int B,
                                           int T, int t0, int tc) {{
  for (long b = 0; b < B; ++b) {{
    float lam[{zn}], J[{e4}];
    for (int s = 0; s < CIRCUIT_NS; ++s) lam[s] = lam_in[s * B + b];
    for (int k = tc - 1; k >= 0; --k) {{
      const long t = t0 + k;
      for (int m = 0; m < CIRCUIT_NE; ++m) J[m] = jac[circuit_jac_index(b, k, m, tc)];
      for (int s = 0; s < CIRCUIT_NS; ++s) lam_seq[(s * B + b) * T + t] = lam[s];
      float rg = 0.f;
      gvin[b * T + t] = circuit_recursion_step(J, lam, &rg);
      if (CIRCUIT_ROOT_STREAMS) gseq[b * T + t] = rg;
    }}
    for (int s = 0; s < CIRCUIT_NS; ++s) lam_out[s * B + b] = lam[s];
  }}
}}
"""
    return AdjointProgram(source=prelude + passes + kernel,
                          host_source=prelude + one_pass + passes + host,
                          ops_per_sample=ops, jacobian_ops=j_ops, recursion_ops=r_ops,
                          n_entries=n_entries, n_state=S, root_streams=streams)


# ---------------------------------------------------------------------------
# The DEER program (single-stream parallel-in-time solve)
# ---------------------------------------------------------------------------

#: the DEER kernel's time partition (the JAX kernel's 8 x 128 blocks) and
#: the size of its CTAs
DEER_BLOCKS, DEER_THREADS = 1024, 256
#: CTAs of the cluster that serves a solve (DeerProgram.source): 16, a
#: non-portable cluster size
DEER_CLUSTER = 16

@dataclasses.dataclass(frozen=True)
class DeerProgram:
    """The generated DEER kernel of one circuit structure (scalar slots
    only; the layout is its forward program's)."""

    source: str            # the served .cu: the steps, the cluster kernel at DEER_CLUSTER CTAs
    step_source: str       # the forward and DEER steps and CircuitDeer, both sources' start
    host_source: str       # step_source and a host loop of the DEER step (tests)
    n_state: int
    ops_per_sample: int    # the DEER step (f and J), counted from the emitted code
    step_ops: int          # the forward step (relaxation and emit passes)

    def scratch_floats(self, T: int) -> int:
        """Global scratch of one solve: the input, two trajectory buffers
        (S each) and the rows
        (J_t, c_t) or their within-block prefixes (S^2 + S), T floats each."""
        S = self.n_state
        return (1 + 3 * S + S * S) * T


#: the cluster kernel on the generated step (deer_cluster.cuh)
_DEER_CLUSTER_KERNEL = """template <int C>
__global__ void __launch_bounds__(kThreads, 1)
deer_cluster_kernel(DeerArgs a, const float* __restrict__ coef, const float* __restrict__ warr,
                    int n_warr) {
  extern __shared__ float smem[];
  float* s_coef = smem;
  float* s_w = smem + ((CIRCUIT_NC + 3) & ~3);
  for (int i = threadIdx.x; i < CIRCUIT_NC; i += kThreads) s_coef[i] = coef[i];
  for (int i = threadIdx.x; i < n_warr; i += kThreads) s_w[i] = warr[i];
  __syncthreads();
  CircuitDeer st;
  st.c = s_coef;
  st.w = s_w;
  const float r_none[1] = {0.f};
  circuit_prologue(s_coef, r_none, s_w, st.p);
  deer_cluster_solve<C, kThreads, S>(st, a);
}
"""


def generate_deer(circuit: Circuit, prog: CircuitProgram) -> DeerProgram:
    """The DEER step and kernel of ``prog``'s circuit structure: per step,
    from v_t and z_{t-1}, f = F(z_{t-1}, v_t) and its state Jacobian
    J = dF/dz (S x S, row-major) by S forward-mode tangents of the traced
    step (the states only; the first tangent pass's primal is f, as in the
    JAX kernel).  The relaxation and emit passes run the forward program's
    ``circuit_step``."""
    emitter = prog.emitter
    if prog.n_rows or prog.n_times or emitter.r_kind != "scalar":
        raise ValueError("fused_deer_circuit serves one stream: scalar coefficient slots only "
                         "(pots are block-rate static controls, not per-row or per-sample)")
    order = prog.state_order
    S = len(order)
    if S == 0:
        raise ValueError("fused_deer_circuit: a stateless circuit needs no parallel-in-time solve")
    tr = _Trace()
    (coeffs_s, params_s, static_s), root_slots, _, _ = _symbols(tr, prog.layout, emitter)
    one = tr.const(1.0)
    state = _nest([((node, field), Dual(Sym(tr, f"s{k}"), tuple(one if i == k else None
                                                                 for i in range(S))))
                   for k, (node, field) in enumerate(order)])

    def root_fn(a, r_up, ctl):
        if emitter.traced:
            return emitter.emit(tr, a, r_up, root_slots, ctl, params_s)
        a = _dual(a, S)
        b, m = emitter.emit_value_slope(tr, a.p, r_up, root_slots, ctl, params_s)
        return Dual(b, (_tmul(d, m) for d in a.d))

    new_state, out = step(circuit, coeffs_s, state,
                          _controls(static_s, prog.input_node, Sym(tr, "v")), root_fn)
    out = out.p if isinstance(out, Dual) else out
    out = out if isinstance(out, Sym) else tr.const(float(out))
    new = [_dual(new_state[node][field], S) for node, field in order]
    writes = [f"f[{i}] = {new[i].p.ref};" for i in range(S)]
    writes += [f"J[{i * S + k}] = {new[i].d[k].ref if new[i].d[k] is not None else '0.f'};"
               for i in range(S) for k in range(S)]
    _, ops = tr.live(" ".join(writes))  # what a sweep needs: the output is not counted
    lines, _ = tr.live(" ".join(writes + [out.ref]))
    used = set(_WORD.findall(" ".join(lines + writes + [out.ref])))
    reads = [f"const float s{k} = z[{k}];" for k in range(S) if f"s{k}" in used]
    body = "\n".join("  " + line for line in reads + lines + writes)
    deer_step = f"""
// Generated by diffwdf_tpu_torch.ops.circuit_codegen: the DEER step of the
// structure above, traced on dual symbols with {S} tangents (one per state).
// Operations per sample (counted from the emitted f and J lines): {ops}
namespace {{

constexpr int kDeerKeep = {max(emitter.n_keep, 1)};  // floats of the prologue's p

// One linearisation: v = v_t, z[CIRCUIT_NS] = z_(t-1); writes f = F(z, v)
// and J[i * CIRCUIT_NS + k] = dF_i / dz_k, returns the output.  Plain C, as
// circuit_step.
__device__ __forceinline__ float circuit_deer_step(float v, const float* z, float* f, float* J,
                                                   const float* c, const float* w,
                                                   const float* p) {{
  (void)v;
  (void)z;
  (void)c;
  (void)w;
  (void)p;
{body}
  return {out.ref};
}}

// The circuit as deer_cluster.cuh's step: the coefficient slots c and the
// root array w (shared memory), the prologue's per-thread p.  Its relax and
// emit are the forward step, its lin the DEER step.
struct CircuitDeer {{
  const float* c;
  const float* w;
  float p[kDeerKeep];

  __device__ __forceinline__ float bound(float vmax) const {{
    return __fmul_rn(100.f, __fadd_rn(vmax, 1.f));
  }}
  __device__ __forceinline__ void relax(float v, float* z) const {{
    const float none[1] = {{0.f}};
    circuit_step(v, z, c, none, none, w, p);
  }}
  __device__ __forceinline__ void lin(float v, const float* z, float* f, float* J) const {{
    circuit_deer_step(v, z, f, J, c, w, p);
  }}
  __device__ __forceinline__ float emit(float v, const float* prev, float* f,
                                        const float* z) const {{
    (void)z;
    const float none[1] = {{0.f}};
    for (int k = 0; k < {S}; ++k) f[k] = prev[k];
    return circuit_step(v, f, c, none, none, w, p);
  }}
}};

}}  // namespace
"""
    host = f"""
// Host loop of the DEER step over n linearisation points (CPU tests):
// z (S, n), v (n,) in; f (S, n), J (S * S, n), out (n,) out.
extern "C" void circuit_deer_host_run(const float* z, const float* v, float* f, float* J,
                                      float* out, int n, const float* c, const float* w) {{
  for (long b = 0; b < n; ++b) {{
    float r[1] = {{0.f}}, p[{max(emitter.n_keep, 1)}], zb[{S}], fb[{S}], Jb[{S * S}];
    circuit_prologue(c, r, w, p);
    for (int k = 0; k < {S}; ++k) zb[k] = z[k * n + b];
    out[b] = circuit_deer_step(v[b], zb, fb, Jb, c, w, p);
    for (int k = 0; k < {S}; ++k) f[k * n + b] = fb[k];
    for (int m = 0; m < {S * S}; ++m) J[m * n + b] = Jb[m];
  }}
}}
"""
    step_source = prog.step_source + deer_step
    return DeerProgram(source=step_source + _deer_kernel(S), step_source=step_source,
                       host_source=step_source + host, n_state=S, ops_per_sample=ops,
                       step_ops=prog.ops_per_sample)


def _deer_kernel(S: int) -> str:
    """The kernel, launch function and occupancy query of a DEER source
    (after its steps): deer_cluster_kernel<DEER_CLUSTER>."""
    c = DEER_CLUSTER
    name = "circuit_deer"
    pad = "\n" + " " * len(f"int {name}_launch(")
    args = pad.join(("const float* vin, const float* z0, float* out, float* zf, float* info,",
                     "float* scratch, int L, const float* coef, const float* warr, int n_warr,",
                     "int sweeps, int relax_passes, int unroll, float damping, float tol,",
                     "int track, void* stream"))
    text = f"""
#include "deer_scan.cuh"
#include "deer_cluster.cuh"

// Replaces the Pallas TPU kernel diffwdf_tpu/ops/deer_circuit.py,
// fused_deer_circuit / fused_deer_neural: the whole single-stream DEER solve
// of one block of T = 1024 L samples in one launch.

// deer_cluster_kernel<C>: one cluster of C CTAs of {DEER_THREADS} threads on
// neighbouring SMs (C = {c}; deer_cluster.cuh has the passes):
// CTA k owns {DEER_BLOCKS} / C time blocks, the step and apply passes run over
// its samples in parallel, one thread per block runs a relaxation and
// composes its rows, the block totals are scanned in the CTA and then across
// the cluster through distributed shared memory; two cluster barriers a
// sweep.  Scratch (1 + 3 S + S^2) T floats.  __launch_bounds__({DEER_THREADS}, 1): the
// Tube Screamer's DEER step needs well over 64 registers.
namespace {{

constexpr int kBlocks = {DEER_BLOCKS};
constexpr int kThreads = {DEER_THREADS};
constexpr int S = CIRCUIT_NS;
using Map = DeerAffine<S>;

{_DEER_CLUSTER_KERNEL}
// dynamic shared memory of a kernel: the coefficient slots, the root array
size_t deer_smem(int n_warr) {{
  return sizeof(float) * (static_cast<size_t>((CIRCUIT_NC + 3) & ~3) + n_warr);
}}

}}  // namespace

extern "C" {{

// One solve on `stream` by a cluster of {c} CTAs: vin (T,), z0 (S,), out (T,),
// zf (S,), info (2,) = (residual, sweeps run), scratch ({1 + 3 * S + S * S} T
// floats); T = 1024 L.  A refused launch returns CUDA's error.
int {name}_launch({args}) {{
  if (L < 1 || sweeps < 0 || relax_passes < 0 || unroll < 1 || n_warr < 0) {{
    return static_cast<int>(cudaErrorInvalidValue);
  }}
  const DeerArgs a{{vin, z0, out, zf, info, info + 1, scratch, L, sweeps, relax_passes, unroll,
                   damping, tol, track}};
  return static_cast<int>(deer_cluster_launch<{c}, &deer_cluster_kernel<{c}>>(
      kThreads, deer_smem(n_warr), static_cast<cudaStream_t>(stream), a, coef, warr, n_warr));
}}

// cudaOccupancyMaxActiveClusters of that kernel with a root array of n_warr
// floats (negative: a CUDA error).
int {name}_max_clusters(int n_warr) {{
  return deer_cluster_max_active<{c}, &deer_cluster_kernel<{c}>>(kThreads, deer_smem(n_warr));
}}
"""
    return text + """
const char* circuit_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
"""


#: circuit -> {(input node, slot layout, root key): program}; held weakly, so
#: a circuit's programs go with it
_programs: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
#: circuit -> {forward source: adjoint program}
_adjoints: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()
#: circuit -> {forward source: DEER program}
_deers: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def program(circuit: Circuit, coeffs, params, static_controls, input_node: str,
            neural_mlp=None, batch: int = 0, time: int = 0) -> CircuitProgram:
    """The (cached) forward program of a circuit structure: keyed by the
    circuit object, the input node, the slot layout (the kinds and shapes of
    ``coeffs``, ``params`` and ``static_controls``; (batch,) and
    (batch, time) leaves are row and time slots when ``batch`` > 0) and the
    root's kind and shape.  A miss, which generates the program, counts one
    in ``runtime.profiler``'s ``programs_generated``, as do those of
    :func:`adjoint_program` and :func:`deer_program`."""
    layout = _layout(circuit, coeffs, params, static_controls, batch, time)
    r_kind = {ROW: "row", TIME: "time"}.get(dict(layout)[("coeffs", circuit.tree.name, "R")],
                                            "scalar")
    emitter = root_emitter(circuit, params, neural_mlp, r_kind)
    per_circuit = _programs.setdefault(circuit, {})
    key = (input_node, layout, emitter.key())
    prog = per_circuit.get(key)
    if prog is None:
        count("programs_generated")
        prog = per_circuit[key] = generate(circuit, layout, input_node, emitter)
    return dataclasses.replace(prog, emitter=emitter)


def sweep_program(circuit: Circuit, prog: CircuitProgram) -> CircuitProgram:
    """``prog`` with its lane form built for every K its root can take
    (``lane_counts(every=True)``: each K of LANES that divides an MLP's
    hidden widths, 4 and 8 for a distilled root of up to four segments),
    not only the K that ``fused_circuit.lanes_for`` picks: a source of its
    own for the K sweep of chip_smoke.py and the card tests."""
    return generate(circuit, prog.layout, prog.input_node, prog.emitter, every_lane=True)


def shape_program(circuit: Circuit, prog: CircuitProgram, lane_threads: int) -> CircuitProgram:
    """``prog`` with blocks of ``lane_threads`` threads in its lane form: a
    source of its own for chip_smoke.py's block-shape measurement."""
    return generate(circuit, prog.layout, prog.input_node, prog.emitter,
                    lane_threads=lane_threads)


def adjoint_program(circuit: Circuit, prog: CircuitProgram) -> AdjointProgram:
    """The (cached) adjoint program of ``prog``'s circuit structure."""
    per_circuit = _adjoints.setdefault(circuit, {})
    adj = per_circuit.get(prog.source)
    if adj is None:
        count("programs_generated")
        adj = per_circuit[prog.source] = generate_adjoint(circuit, prog)
    return adj


def deer_program(circuit: Circuit, prog: CircuitProgram) -> DeerProgram:
    """The (cached) DEER program of ``prog``'s circuit structure."""
    per_circuit = _deers.setdefault(circuit, {})
    deer = per_circuit.get(prog.source)
    if deer is None:
        count("programs_generated")
        deer = per_circuit[prog.source] = generate_deer(circuit, prog)
    return deer
