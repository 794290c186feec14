"""Streaming block processor: the single-stream serving path.

Capability parity with the reference's C++ plugin shell
(``plugin/src/DifferentiableWDFPlugin.cpp:40-82`` and the circuit wrappers
``DiodeClipper.cpp:20-50`` etc.): mono summing, ramped input gain, circuit
dispatch by name, a 25 Hz one-pole DC blocker, per-block parameter updates
(cutoff -> source R, drive pot), and state carried across blocks so arbitrary
block sizes stream gap-free.

The processor keeps its circuit state, DC-blocker state and parameters on one
``device`` (the card by default).  Each (circuit, block length, engine
variant) gets a block function, built once and cached: the circuit's solve is
one kernel launch where the circuit has a kernel (the parallel-in-time DEER
kernel, or the exact recursion's batched kernel at B=1), and the gain ramp
and the DC blocker are a few dozen torch ops around it.  The processor also
exposes the parameter schema of each circuit (name/kind/range), the
equivalent of the reference's GUI parameter reflection
(``CircuitModelGUI.cpp:55-66``).
"""

from __future__ import annotations

import dataclasses
import inspect
import math
import time
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ..core.circuit import Circuit

DC_BLOCKER_HZ = 25.0  # reference: DifferentiableWDFPlugin.cpp:31


@dataclasses.dataclass
class ParamSpec:
    """Introspectable parameter descriptor (GUI-reflection parity).

    ``name`` is the reference's parameter tag (``DiodeClipper.cpp:5-7``);
    ``api`` is how the parameter is driven through this framework:
    the ``process_block`` keyword for block-rate params ("gain_db",
    "cutoff_hz", "drive"), or "circuit" for the model choice (selected as
    the circuit name passed to ``process_block``, the analogue of the
    reference's root hot-swap).  ``skew_centre`` mirrors JUCE's
    ``NormalisableRange::setSkewForCentre`` so a GUI can reproduce the
    reference's log-feel cutoff slider.
    """

    name: str
    kind: str  # "float" | "choice"
    lo: float = 0.0
    hi: float = 1.0
    default: float = 0.0
    choices: Tuple[str, ...] = ()
    default_choice: int = 0
    skew_centre: Optional[float] = None
    api: str = ""

    def to_dict(self) -> Dict[str, Any]:
        d = dataclasses.asdict(self)
        d["choices"] = list(self.choices)
        return d


def _cutoff_spec() -> ParamSpec:
    # 200 Hz .. 20 kHz, skewed for centre 2 kHz, default 4 kHz
    # (DiodeClipper.cpp:25-27, identical in MultiDiodeClipper/HPFDiodeClipper)
    return ParamSpec("cutoff", "float", 200.0, 20000.0, 4000.0,
                     skew_centre=2000.0, api="cutoff_hz")


def clipper_param_specs(
    choices: Tuple[str, ...] = (
        "1N4148 Ideal", "1N4148 Approx", "1N4148 2x4", "1N4148 2x8",
        "1N4148 2x16", "1N4148 4x4", "1N4148 4x8",
    ),
) -> Tuple[ParamSpec, ...]:
    """The DiodeClipper parameter set (``DiodeClipper.cpp:20-31``):
    gain 0..24 dB, skewed cutoff, 7-model choice."""
    return (
        ParamSpec("gain", "float", 0.0, 24.0, 0.0, api="gain_db"),
        _cutoff_spec(),
        ParamSpec("model", "choice", choices=tuple(choices), api="circuit"),
    )


def multi_diode_param_specs() -> Tuple[ParamSpec, ...]:
    """MultiDiodeClipper parameters (``MultiDiodeClipper.cpp:20-31``):
    same gain/cutoff as the clipper, 5 multi-diode-config models."""
    return (
        ParamSpec("gain", "float", 0.0, 24.0, 0.0, api="gain_db"),
        _cutoff_spec(),
        ParamSpec("model", "choice", choices=(
            "1up/2down 2x16", "2up/2down 2x16", "1up/3down 2x16",
            "2up/3down 2x16", "3up/3down 2x16",
        ), api="circuit"),
    )


def tube_screamer_param_specs() -> Tuple[ParamSpec, ...]:
    """TubeScreamer parameters (``TubeScreamer.cpp:21-29``):
    gain -12..12 dB, drive 0..1 (default 0.5), 2-model choice."""
    return (
        ParamSpec("gain", "float", -12.0, 12.0, 0.0, api="gain_db"),
        ParamSpec("drive", "float", 0.0, 1.0, 0.5, api="drive"),
        ParamSpec("model", "choice",
                  choices=("1N4148 Approx", "1N4148 2x16"), api="circuit"),
    )


def hpf_param_specs() -> Tuple[ParamSpec, ...]:
    """HPFDiodeClipper parameters (``HPFDiodeClipper.cpp:21-31``):
    gain/cutoff as the clipper, 4-model choice incl. the extrapolation
    probe pair."""
    return (
        ParamSpec("gain", "float", 0.0, 24.0, 0.0, api="gain_db"),
        _cutoff_spec(),
        ParamSpec("model", "choice", choices=(
            "1N4148 Ideal", "1N4148 Approx",
            "1N4148 2x16 Extrapolated", "1N4148 2x16 Trained",
        ), api="circuit"),
    )


def default_clipper_params() -> Tuple[ParamSpec, ...]:
    """Deprecated alias for :func:`clipper_param_specs`."""
    return clipper_param_specs()


def _dc_blocker_coeff(fs: float, f_hz: float = DC_BLOCKER_HZ) -> float:
    return 1.0 - 2.0 * math.pi * f_hz / fs


def _structure(tree):
    """The nesting of a state dict (its keys, not its values)."""
    if isinstance(tree, dict):
        return tuple((k, _structure(v)) for k, v in sorted(tree.items()))
    return None


def _dc_blocker_tables(rho: float, block_len: int, device):
    """(decay, powers) of the DC blocker for one block length, in f32 like
    the state: decay[t] = rho^(t+1) on ``device``, powers[i] = rho^(2^i)."""
    r = torch.tensor(rho, dtype=torch.float32)
    decay = r ** torch.arange(1, block_len + 1, dtype=torch.float32)
    powers = [float(r ** (1 << i)) for i in range(max(block_len - 1, 0).bit_length())]
    return decay.to(device), powers


def _dc_blocker(out, dc_state, decay, powers):
    """First-order DC blocker y[t] = x[t] - x[t-1] + rho y[t-1] over a block.

    The linear recurrence y = rho y_prev + d runs as a log-depth doubling
    scan in torch ops (Hillis-Steele: at step k every y[t] with t >= k adds
    rho^k y[t-k]), what ``jax.lax.associative_scan`` computes; never a
    per-sample loop, and never the closed form with rho^-t, whose factor
    outgrows f32's digits within a long block.  decay[t] = rho^(t+1) carries
    the state y1 in; powers[i] = rho^(2^i) (``_dc_blocker_tables``).
    Returns (y, new dc_state)."""
    x1, y1 = dc_state
    d = out - torch.cat([x1.reshape(1), out[:-1]])
    y, k = d, 1
    for rho_k in powers:
        y = torch.cat([y[:k], torch.add(y[k:], y[:-k], alpha=rho_k)])
        k *= 2
    y = torch.addcmul(y, decay, y1)
    return y, (out[-1], y[-1])


def _host_floats(*xs):
    """Python floats of scalars, some of them perhaps tensors on the card:
    the tensors come to the host in one copy."""
    ts = [x for x in xs if isinstance(x, torch.Tensor)]
    vals = iter(torch.stack([t.reshape(()).float() for t in ts]).tolist() if ts else ())
    return [next(vals) if isinstance(x, torch.Tensor) else float(x) for x in xs]


class StreamingProcessor:
    """Block-streaming WDF processor with gain ramp + DC blocker.

    circuits: {name: (Circuit, params)}; the active circuit is selected per
    block (the analogue of the reference's root hot-swap,
    ``DiodeClipperWDF.cpp:36-41``).

    groups: {group_name: (member, member, ...)}: a group is one *served
    circuit* whose root model is switchable at block rate (the reference's
    "model" parameter hot-swaps all 12 clipper roots on one shared tree,
    ``DiodeClipperWDF.cpp:32-41``).  Members of a group share ONE state dict
    (checked structurally identical), so switching the model mid-stream
    carries the reactive state across, as the reference's
    ``connectToParent`` + ``calcImpedance`` hot-swap does.
    ``process_block(audio, group, model=k)`` selects member k; the group's
    registered "model" ParamSpec choices map 1:1 onto the members (checked
    at construction: the schema can never over-advertise).

    process_overrides: {name: fn} replacing the circuit's exact engine
    inside the block function, e.g. the parallel-in-time DEER kernel as a
    low-latency serving engine; fn(params, state, inputs, static_controls)
    -> (out, state) or (out, state, residual).

    exact_runners: {name: fn} with the same signature returning (out,
    state): the circuit's exact engine, which serves the blocks that no
    override serves (and the residual fallback).  A circuit without one is
    served by ``Circuit.process``, a host loop over the samples.

    An override or exact runner that launches generated kernels
    (``ops.circuit_codegen``) names their sources in its attribute
    ``sources(params, static_controls, device) -> [source, ...]``;
    ``warmup`` builds them all first, one nvcc per source, all started
    together.

    fallback_tol: always-correct serving guard.  An override emits a
    residual certificate; if it exceeds this tolerance the block is
    recomputed with the exact engine (from the same block-input state): the
    parallel solver is an optimization, never a correctness change (the
    reference's engines are unconditionally correct at every operating
    point, ``Toms917DiodePair.h:51-58``).  ``fallbacks`` counts these per
    circuit; set ``fallback_tol=None`` to surface the raw residual only.

    device: where the state, the DC-blocker state and the blocks live; the
    circuits' params must lie there too.
    """

    def __init__(self, circuits: Dict[str, Tuple[Circuit, Any]], fs: float,
                 param_maps: Optional[Dict[str, Callable]] = None,
                 param_schemas: Optional[Dict[str, Tuple[ParamSpec, ...]]] = None,
                 process_overrides: Optional[Dict[str, Callable]] = None,
                 groups: Optional[Dict[str, Tuple[str, ...]]] = None,
                 fallback_tol: Optional[float] = 1e-3,
                 exact_runners: Optional[Dict[str, Callable]] = None,
                 *, device="cuda"):
        self.circuits = dict(circuits)
        self.fs = fs
        self.device = torch.device(device)
        #: per-circuit mapping of block-rate params (cutoff_hz, drive, ...)
        #: to static controls {node: {field: value}} (setParameters parity)
        self.param_maps = param_maps or {}
        #: per-circuit parameter schemas (GUI-reflection parity); factories
        #: register the reference's exact schema per circuit, ad-hoc circuits
        #: get a schema derived from their param_map signature
        self.param_schemas = dict(param_schemas or {})
        #: per-circuit replacement for the exact engine inside the block fn
        self.process_overrides = dict(process_overrides or {})
        #: per-circuit exact engine (else Circuit.process)
        self.exact_runners = dict(exact_runners or {})
        #: last solver-residual certificate per circuit (deer engines emit
        #: max|f(z_prev) - z|, the serving health metric next to `load`;
        #: 0.0 for the exact engine)
        self.last_residual: Dict[str, float] = {}
        #: residual-triggered exact recomputations per circuit
        self.fallbacks: Dict[str, int] = {}
        self.fallback_tol = fallback_tol
        self.groups = {g: tuple(m) for g, m in (groups or {}).items()}
        # group members share one state slot; check state compatibility
        self._state_key: Dict[str, str] = {}
        for g, members in self.groups.items():
            if g in self.circuits:
                raise ValueError(f"group {g!r} collides with a circuit name")
            ref_def = None
            for m in members:
                if m not in self.circuits:
                    raise ValueError(f"group {g!r} member {m!r} not registered")
                sdef = _structure(self.circuits[m][0].init_state("cpu"))
                ref_def = ref_def if ref_def is not None else sdef
                if sdef != ref_def:
                    raise ValueError(
                        f"group {g!r}: member {m!r} state structure {sdef} "
                        f"!= {ref_def}: members must share state"
                    )
                self._state_key[m] = g
        self._fns: Dict[Tuple[str, int, bool], Callable] = {}
        self._state: Dict[str, Any] = {}
        for name, (ckt, _) in circuits.items():
            self._state.setdefault(self._state_key.get(name, name),
                                   ckt.init_state(self.device))
        self._dc_state = self._zero_dc_state()  # (x1, y1)
        self._gain = 1.0
        self._load = 0.0
        self._assert_schema_consistency()

    def _zero_dc_state(self):
        return (torch.zeros((), device=self.device), torch.zeros((), device=self.device))

    def _assert_schema_consistency(self):
        """Every registered "model" choice spec must be actionable: its
        choices map 1:1 onto the selectable set (group members, or, for an
        ungrouped circuit registered under several sibling names sharing one
        schema, the sibling circuit names themselves)."""
        for name, specs in self.param_schemas.items():
            for s in specs:
                if s.kind != "choice" or s.api != "circuit":
                    continue
                if name in self.groups:
                    n_sel = len(self.groups[name])
                elif name in self._state_key:  # member: group's schema
                    n_sel = len(self.groups[self._state_key[name]])
                else:
                    # ungrouped: each choice must name a registered circuit
                    missing = [c for c in s.choices if c not in self.circuits]
                    if missing:
                        raise ValueError(
                            f"schema for {name!r} advertises model choices "
                            f"{missing} that are not registered circuits"
                        )
                    continue
                if len(s.choices) != n_sel:
                    raise ValueError(
                        f"schema for {name!r} advertises {len(s.choices)} "
                        f"model choices but {n_sel} are selectable"
                    )

    def _resolve(self, circuit: str, model) -> str:
        """Map (circuit-or-group, model choice) -> concrete circuit name.
        ``model`` may be a choice index, a choice label from the group's
        schema, or a member name."""
        if circuit in self.groups:
            members = self.groups[circuit]
            if model is None:
                specs = self.param_schemas.get(circuit, ())
                choice = next(
                    (s for s in specs if s.kind == "choice"
                     and s.api == "circuit"), None
                )
                return members[choice.default_choice if choice else 0]
            if isinstance(model, str):
                if model in members:
                    return model
                specs = self.param_schemas.get(circuit, ())
                for s in specs:
                    if s.kind == "choice" and model in s.choices:
                        return members[s.choices.index(model)]
                raise KeyError(
                    f"unknown model {model!r} for {circuit!r}; "
                    f"members {members}"
                )
            idx = int(model)
            if not 0 <= idx < len(members):
                raise KeyError(
                    f"model index {idx} out of range for {circuit!r}: "
                    f"{len(members)} choices {members}"
                )
            return members[idx]
        if circuit not in self.circuits:
            raise KeyError(
                f"unknown circuit {circuit!r}; have "
                f"{sorted(self.circuits) + sorted(self.groups)}"
            )
        if model is not None:
            raise ValueError(
                f"circuit {circuit!r} is not a model group; "
                f"pass the circuit name directly"
            )
        return circuit

    # -- parameter schema (GUI reflection parity) --------------------------
    def param_specs(self, name: str) -> Tuple[ParamSpec, ...]:
        """The parameter schema of circuit ``name``, the analogue of the
        reference's auto-generated GUI (``CircuitModelGUI.cpp:55-66``
        reflects over each circuit's paramTags; here a GUI/CLI reflects over
        these specs).  Registered schemas come from the circuit factories;
        unregistered circuits derive a schema from their param_map signature
        so every circuit exposes something renderable."""
        if name not in self.circuits and name not in self.groups:
            raise KeyError(
                f"unknown circuit {name!r}; have "
                f"{sorted(self.circuits) + sorted(self.groups)}"
            )
        if name in self.param_schemas:
            return self.param_schemas[name]
        specs = [ParamSpec("gain", "float", 0.0, 24.0, 0.0, api="gain_db")]
        mapper = self.param_maps.get(name)
        if mapper is not None:
            for arg in inspect.signature(mapper).parameters:
                if arg == "cutoff_hz":
                    specs.append(_cutoff_spec())
                elif arg == "drive":
                    specs.append(
                        ParamSpec("drive", "float", 0.0, 1.0, 0.5, api="drive")
                    )
                else:
                    specs.append(ParamSpec(arg, "float", api=arg))
        return tuple(specs)

    def surfaces(self) -> Tuple[str, ...]:
        """The served circuit names: model groups plus ungrouped circuits,
        what a GUI/CLI should render (group members are internal variants,
        addressed via the group's "model" parameter)."""
        return tuple(self.groups) + tuple(
            n for n in self.circuits if n not in self._state_key
        )

    @property
    def load(self) -> float:
        """Smoothed processing-load estimate (CPU-meter parity,
        ``CPUMeter.h:42-80``): block wall time / block duration."""
        return self._load

    # -- core ---------------------------------------------------------------
    def _block_fn(self, name: str, block_len: int,
                  use_override: bool = True) -> Callable:
        key = (name, block_len, use_override)
        if key not in self._fns:
            ckt, _ = self.circuits[name]
            node = "Vin" if "Vin" in ckt.init_params("cpu") else "Vs"  # drive node
            override = self.process_overrides.get(name) if use_override else None
            exact = self.exact_runners.get(name)
            # per block length: the gain ramp's time axis and the DC
            # blocker's tables
            ramp = ((torch.arange(block_len, dtype=torch.float32) + 1.0) / block_len).to(self.device)
            decay, powers = _dc_blocker_tables(_dc_blocker_coeff(self.fs), block_len, self.device)

            def fn(params, state, dc_state, vin, gain0, gain1, static_controls):
                g0, dg = np.float32(gain0), np.float32(gain1) - np.float32(gain0)
                inputs = {node: {"v": vin * (ramp * float(dg) + float(g0))}}
                residual = 0.0
                if override is not None:
                    res = override(params, state, inputs, static_controls)
                    out, state = res[0], res[1]
                    if len(res) > 2:
                        residual = res[2]
                elif exact is not None:
                    out, state = exact(params, state, inputs, static_controls)
                else:
                    out, state = ckt.process(params, state, inputs,
                                             static_controls=static_controls)
                out_dc, dc_state = _dc_blocker(out, dc_state, decay, powers)
                return out_dc, state, dc_state, residual

            self._fns[key] = fn
        return self._fns[key]

    def process_block(
        self,
        audio: np.ndarray,
        circuit: str,
        gain_db: float = 0.0,
        model=None,
        **block_params,
    ) -> np.ndarray:
        """Process one audio block.

        audio: (T,) mono or (C, T) multichannel, summed to mono, processed,
        fanned back out to all channels (``DifferentiableWDFPlugin.cpp:50-81``).

        model: for a group circuit, the block's root-model choice (index,
        schema label, or member name), switchable per block with state
        continuity, the reference's model hot-swap
        (``DiodeClipperWDF.cpp:32-41``).
        """
        x = np.asarray(audio, dtype=np.float32)
        multi = x.ndim == 2
        mono = x.mean(axis=0) if multi else x
        T = mono.shape[-1]

        member = self._resolve(circuit, model)
        state_key = self._state_key.get(member, member)
        gain1 = float(10.0 ** (gain_db / 20.0))
        fn = self._block_fn(member, T)
        _, params = self.circuits[member]
        static_controls = {}
        if block_params:
            mapper = self.param_maps.get(member) or self.param_maps.get(circuit)
            if mapper is None:
                raise ValueError(f"no param map for circuit {circuit!r}")
            static_controls = mapper(**block_params)
        state_in = self._state[state_key]
        t0 = time.perf_counter()
        vin = torch.tensor(mono, device=self.device)
        out, state, dc_state, residual = fn(
            params, state_in, self._dc_state, vin, self._gain, gain1, static_controls)
        residual = float(residual)  # the certificate is read in every block
        if (
            self.fallback_tol is not None
            and member in self.process_overrides
            and residual > self.fallback_tol
        ):
            # the parallel-in-time engine self-flagged this block: recompute
            # with the exact engine from the same block-input state so
            # serving stays unconditionally correct at every operating point
            exact = self._block_fn(member, T, use_override=False)
            out, state, dc_state, _ = exact(
                params, state_in, self._dc_state, vin, self._gain, gain1, static_controls)
            self.fallbacks[member] = self.fallbacks.get(member, 0) + 1
            if circuit != member:
                self.fallbacks[circuit] = self.fallbacks.get(circuit, 0) + 1
        out = out.cpu().numpy()
        dt = time.perf_counter() - t0
        block_dur = T / self.fs
        self._load = 0.9 * self._load + 0.1 * (dt / block_dur)

        self._state[state_key] = state
        self._dc_state = dc_state
        self.last_residual[member] = residual
        if circuit != member:
            self.last_residual[circuit] = residual
        self._gain = gain1
        if multi:
            return np.broadcast_to(out, x.shape).copy()
        return out

    def warmup(self, block_sizes, circuits=None,
               block_params: Optional[Dict[str, Dict[str, Any]]] = None
               ) -> Dict[str, Any]:
        """Run every (member, block size, engine variant, control variant)
        block function once, on zeros, so the FIRST streamed block runs at
        steady-state latency.

        The reference engine is real-time safe from sample one because
        ``prepareToPlay`` does all setup up front
        (``DifferentiableWDFPlugin.cpp:27-38``).  Here the set-up is building
        (or loading) the kernel library at first use, each block length's
        constants, and the first launch of each kernel and torch op: without
        this call the first block at a new size, the first hot-swap to a new
        group member and the first residual-triggered fallback each pay it.

        block_sizes: iterable of block lengths.
        circuits: served names (groups and/or circuit names; default = all
        surfaces).  Group names expand to every member, so every hot-swap
        target is warmed.  On the card, the members' generated kernels
        (``_kernel_sources``) are built first, in parallel, so that no
        served block runs nvcc.
        block_params: optional {served_name: {kwarg: value}} exercised
        through the circuit's param map; by default the registered schema's
        float defaults are used (so the warmed call matches real
        ``process_block(..., cutoff_hz=...)`` usage), plus the bare
        no-block-params call.  For each member with a parallel-in-time
        override the exact fallback variant is warmed too.

        Returns {"n_compiled": int, "seconds": float, "keys": [...]}.
        Processor state (circuit state, DC blocker, gain) is untouched.
        """
        t0 = time.perf_counter()
        if circuits is None:
            circuits = self.surfaces()
        members = []  # (served_name, member_name)
        for c in circuits:
            if c in self.groups:
                members.extend((c, m) for m in self.groups[c])
            else:
                self._resolve(c, None)  # raises on unknown names
                members.append((c, c))

        def _default_block_params(served):
            mapper = self.param_maps.get(served)
            if mapper is None:
                return None
            args = set(inspect.signature(mapper).parameters)
            kw = {}
            for s in self.param_specs(served):
                if s.kind == "float" and s.api in args:
                    kw[s.api] = s.default
            return kw if set(kw) == args else None

        plan = []  # (served, member, control variants)
        for served, member in members:
            mapper = self.param_maps.get(member) or self.param_maps.get(served)
            ctl_variants = [{}]
            kw = (block_params or {}).get(served)
            if kw is None:
                kw = _default_block_params(served)
            if kw and mapper is not None:
                ctl_variants.append(mapper(**kw))
            plan.append((served, member, ctl_variants))
        if self.device.type == "cuda":
            # every generated kernel the warmed blocks launch, one nvcc per
            # source, all started together (a source depends on the
            # structure and the control variant, never on a value)
            from ..ops import _build

            sources = [src for _, member, ctls in plan for ctl in ctls
                       for src in self._kernel_sources(member, ctl)]
            _build.build_generated(list(dict.fromkeys(sources)))

        compiled = []
        for served, member, ctl_variants in plan:
            _, params = self.circuits[member]
            state = self._state[self._state_key.get(member, member)]
            variants = [True]
            if (member in self.process_overrides
                    and self.fallback_tol is not None):
                variants.append(False)  # the exact fallback path
            for T in block_sizes:
                x = torch.zeros((int(T),), dtype=torch.float32, device=self.device)
                for use_override in variants:
                    fn = self._block_fn(member, int(T), use_override)
                    for ctl in ctl_variants:
                        fn(params, state, self._dc_state, x, 1.0, 1.0, ctl)
                        if self.device.type == "cuda":
                            torch.cuda.synchronize(self.device)
                        compiled.append((member, int(T), use_override,
                                         bool(ctl)))
        return {
            "n_compiled": len(compiled),
            "seconds": time.perf_counter() - t0,
            "keys": compiled,
        }

    def _kernel_sources(self, member: str, static_controls) -> list:
        """The generated kernel sources that ``member``'s runners launch
        under ``static_controls``: the exact engine's, then the override's."""
        params = self.circuits[member][1]
        return [src for run in (self.exact_runners.get(member), self.process_overrides.get(member))
                if hasattr(run, "sources")
                for src in run.sources(params, static_controls, self.device)]

    def reset(self):
        for name, (ckt, _) in self.circuits.items():
            self._state[self._state_key.get(name, name)] = ckt.init_state(self.device)
        self._dc_state = self._zero_dc_state()

    def set_params(self, circuit: str, params, model=None) -> None:
        """Replace the trained params of a circuit; group-aware: for a
        group name this targets the member selected by ``model`` (the
        group's default choice when omitted)."""
        member = self._resolve(circuit, model)
        self.circuits[member] = (self.circuits[member][0], params)


def _diode_pair_args(params, static_controls, root_name: str = "dp"):
    """(r_source, cap, Is, Vt_eff, n_up, n_down) of an LPF clipper with a
    diode-pair root, as host floats: the block's static source R where one
    is given, and Vt_eff = Vt nabla in f32, as the root computes it."""
    r = (static_controls or {}).get("Vs", {}).get("R", params["Vs"]["R"])
    d = params[root_name]
    r, cap, Is, vt, nabla, n_up, n_dn = _host_floats(
        r, params["C"]["C"], d["Is"], d["Vt"], d["nabla"], d["N_up"], d["N_down"])
    return r, cap, Is, float(np.float32(vt) * np.float32(nabla)), n_up, n_dn


def _kernel_nxh(root) -> bool:
    """Whether ``root`` is an NxH neural root the kernels compute: all
    hidden layers tanh, a linear head, at least one hidden H->H layer, H in
    NEURAL_WIDTHS."""
    from ..ops.fused_clipper import NEURAL_WIDTHS
    from ..roots.neural import NeuralDiodeRoot

    if not isinstance(root, NeuralDiodeRoot):
        return False
    acts = tuple(root.activations)
    return (root.n_layers >= 1 and root.layer_size in NEURAL_WIDTHS
            and len(acts) == root.n_layers + 2 and set(acts[:-1]) == {"tanh"}
            and acts[-1] in ("", "linear"))


def _lpf_exact_runner(ckt: Circuit) -> Callable:
    """The exact engine of an LPF clipper as one kernel launch at B=1.

    The batched clipper kernels compute exactly the sequential recursion of
    ``Circuit.process``: ``fused_clipper_analytic`` for a ``DiodePairRoot``
    (with its quality's omega iteration count), ``fused_clipper_neural`` for
    a ``NeuralDiodeRoot`` of the NxH family (``_kernel_nxh``).  Any other
    root, e.g. a JSON model with relu layers or a distilled root, gets the
    generated forward of the circuit (``_generic_exact_runner``, B7).
    The runner takes (params, state, inputs, static_controls) and returns
    (out, state); a static "R" of "Vs" overrides the params' source R.
    """
    from ..ops.fused_clipper import fused_clipper_analytic, fused_clipper_neural
    from ..roots.diode import DiodePairRoot

    root = ckt.root
    if isinstance(root, DiodePairRoot):
        def run(params, state, inputs, static_controls):
            out, zf = fused_clipper_analytic(
                inputs["Vs"]["v"][None], state["C"]["z"].reshape(1),
                *_diode_pair_args(params, static_controls, root.name), fs=ckt.fs,
                quality_iters=root.iters)
            return out[0], {"C": {"z": zf[0]}}

        return run
    if _kernel_nxh(root):
        def run(params, state, inputs, static_controls):
            r = (static_controls or {}).get("Vs", {}).get("R", params["Vs"]["R"])
            r, cap = _host_floats(r, params["C"]["C"])
            out, zf = fused_clipper_neural(
                inputs["Vs"]["v"][None], state["C"]["z"].reshape(1), params[root.name], r, cap,
                fs=ckt.fs)
            return out[0], {"C": {"z": zf[0]}}

        return run
    return _generic_exact_runner(ckt, "Vs")


def _generic_exact_runner(ckt: Circuit, node: str) -> Callable:
    """The exact engine of any circuit the generated kernels take (the Tube
    Screamer, the HPF clipper, an MLP root of any widths and activations):
    one launch of ``fused_circuit_process`` (B7) at B=1, the block's static
    controls as slot values.  It serves the scan engine, the blocks whose
    length is no multiple of 1024 and the residual fallbacks of the DEER
    engine.  Takes and returns as ``_lpf_exact_runner``; ``node`` is the
    input node.  ``run.sources`` names its generated kernel."""
    from ..ops.fused_circuit import fused_circuit_process, prepare

    def run(params, state, inputs, static_controls):
        z0 = {k: {f: z.reshape(1) for f, z in d.items()} for k, d in state.items()}
        out, zf = fused_circuit_process(ckt, params, inputs[node]["v"][None], z0,
                                        input_node=node, static_controls=static_controls)
        return out[0], {k: {f: z[0] for f, z in d.items()} for k, d in zf.items()}

    def sources(params, static_controls, device):
        return [prepare(ckt, params, device, input_node=node,
                        static_controls=static_controls).prog.source]

    run.sources = sources
    return run


def _deer_runner(ckt: Circuit, node: str, exact_run: Callable, **solver_kw) -> Callable:
    """The DEER engine of a circuit (B9): ``fused_deer_neural`` for an NxH
    root, else ``fused_deer_circuit``, with ``solver_kw`` (sweeps,
    relax_passes, damping, adapt_tol); a block whose length is no multiple
    of 1024 goes to ``exact_run``.
    Returns (out, state, residual).  ``run.sources`` names its generated
    kernel."""
    from ..ops.circuit_codegen import deer_program
    from ..ops.deer_circuit import NB, fused_deer_circuit, fused_deer_neural
    from ..ops.fused_circuit import prepare
    from ..roots.neural import NeuralDiodeRoot

    solver = fused_deer_neural if isinstance(ckt.root, NeuralDiodeRoot) else fused_deer_circuit

    def run(params, state, inputs, static_controls):
        v = inputs[node]["v"]
        if v.shape[0] % NB:
            return exact_run(params, state, inputs, static_controls)
        return solver(ckt, params, v, input_node=node, static_controls=static_controls,
                      state0=state, **solver_kw)

    def sources(params, static_controls, device):
        prog = prepare(ckt, params, device, input_node=node,
                       static_controls=static_controls).prog
        return [deer_program(ckt, prog).source]

    run.sources = sources
    return run


def _clipper_deer_runner(exact_run: Callable, fs: float, sweeps: int, qiters: int) -> Callable:
    """The LPF clipper's own DEER kernel (B5) for a diode-pair member, with
    (sweeps, omega iterations); other block lengths go to ``exact_run``."""
    from ..ops.parallel_time_deer import NB, fused_deer_clipper

    def run(params, state, inputs, static_controls):
        v = inputs["Vs"]["v"]
        if v.shape[0] % NB:  # block length the kernel does not take
            return exact_run(params, state, inputs, static_controls)
        out, zf, res = fused_deer_clipper(
            v, *_diode_pair_args(params, static_controls), fs=fs, z0=state["C"]["z"],
            sweeps=sweeps, quality_iters=qiters)
        return out, {"C": {"z": zf}}, res

    return run


def _check_engine(engine: str) -> None:
    if engine not in ("scan", "deer"):
        raise ValueError(f"engine must be 'scan' or 'deer', got {engine!r}")


def make_clipper_processor(
    fs: float,
    cutoff_hz: float = 4000.0,
    models: Tuple[str, ...] = ("toms", "approx", "neural_2x16"),
    mlp_json: Optional[str] = None,
    engine: str = "scan",
    *,
    device="cuda",
) -> StreamingProcessor:
    """Build the reference plugin's circuit set: the LPF diode clipper under
    the given root models, as one model group "clipper", with cutoff mapped
    to source resistance.

    engine="scan" serves every member with its exact engine: one launch of
    the batched clipper kernel at B=1 (``_lpf_exact_runner``).
    engine="deer" serves every member parallel in time whenever the block
    length is a multiple of 1024: the analytic members ("toms"/"approx")
    through the clipper's DEER kernel (``ops.parallel_time_deer``), a neural
    member through the generic one (``ops.deer_circuit.fused_deer_neural``,
    8 sweeps, 2 relaxations), each the whole block in one launch; other
    block lengths, and blocks whose residual exceeds the processor's
    ``fallback_tol``, get the exact engine.

    device: where the processor serves (the card by default; tests pass
    "cpu", where every kernel wrapper runs its plain version).
    """
    from ..models.diode_clipper import (
        cutoff_to_resistance, make_diode_clipper, make_neural_root_or_default)
    from ..roots.diode import DiodePairRoot, diode_1n4148_1u1d

    _check_engine(engine)
    device = torch.device(device)
    cap = 2.2e-9
    r = cutoff_to_resistance(cutoff_hz, cap)
    circuits = {}
    for m in models:
        if m in ("toms", "approx"):
            root = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d,
                                 quality="best" if m == "toms" else "low")
            ckt = make_diode_clipper(root, fs, r_source=r, cap=cap)
            params = ckt.init_params(device)
        elif m.startswith("neural"):
            try:  # "neural_2x16" -> (2, 16); bare "neural" -> 2x16
                n_l, width = (int(v) for v in m.split("_")[1].split("x"))
            except (IndexError, ValueError):
                n_l, width = 2, 16
            root, frag = make_neural_root_or_default("dp", n_l, width, json_path=mlp_json,
                                                     device=device)
            ckt = make_diode_clipper(root, fs, r_source=r, cap=cap)
            params = {**ckt.init_params(device), **frag}
        else:
            raise ValueError(m)
        circuits[m] = (ckt, params)

    def clipper_map(cutoff_hz):
        return {"Vs": {"R": cutoff_to_resistance(cutoff_hz, cap)}}

    exact = {m: _lpf_exact_runner(ckt) for m, (ckt, _) in circuits.items()}
    overrides = {}
    if engine == "deer":
        # (sweeps, omega iters) per root: the omega iteration count must
        # match the exact engine's quality knob so switching engines never
        # changes the model ("approx" = chowdsp-style 1-iter omega)
        cfg_of = {"toms": (8, 3), "approx": (4, 1)}
        for m, (ckt, _) in circuits.items():
            if m in cfg_of:
                overrides[m] = _clipper_deer_runner(exact[m], fs, *cfg_of[m])
            else:
                overrides[m] = _deer_runner(ckt, "Vs", exact[m])

    specs = clipper_param_specs(choices=tuple(circuits))
    names = list(circuits) + ["clipper"]
    return StreamingProcessor(
        circuits, fs, param_maps={m: clipper_map for m in names},
        param_schemas={m: specs for m in names},
        process_overrides=overrides,
        groups={"clipper": tuple(circuits)},
        exact_runners=exact,
        device=device,
    )


#: the HPF clipper's DEER settings: its series capacitor is a marginal slow
#: mode that needs damped Newton; 48 is the cap of the adaptive loop, which
#: stops once a sweep moves the trajectory by less than 1e-5 (the JAX
#: package's make_hpf_processor)
HPF_DEER = dict(sweeps=48, damping=0.5, adapt_tol=1e-5)


def make_hpf_processor(
    fs: float,
    cutoff_hz: float = 4000.0,
    lpf_trained_json: Optional[str] = None,
    hpf_trained_json: Optional[str] = None,
    engine: str = "scan",
    *,
    device="cuda",
) -> StreamingProcessor:
    """The HPF clipper circuit under its 4 root choices
    (``HPFDiodeClipper.cpp:29-30,60-66``): TOMS, approx, the LPF-trained
    2x16 run in the unseen topology ("extrapolated"), and the HPF-trained
    2x16 ("trained").  Cutoff maps to the load resistor R = 1/(2 pi f C)
    with C fixed at 2.2 nF.

    engine="scan" serves every member with its exact engine, the generated
    kernel at B=1 (``_generic_exact_runner``); engine="deer" through the
    generic DEER kernel (``HPF_DEER``: damped, adaptive, at most 48 sweeps)
    for blocks of a multiple of 1024 samples, the exact engine otherwise and
    on a residual fallback."""
    from ..models.diode_clipper import (
        cutoff_to_resistance, make_hpf_diode_clipper, make_hpf_root_from_zoo)

    _check_engine(engine)
    device = torch.device(device)
    cap = 2.2e-9
    r_load = cutoff_to_resistance(cutoff_hz, cap)
    names = ("toms", "approx", "extrapolated", "trained")
    json_for = {"extrapolated": lpf_trained_json, "trained": hpf_trained_json}
    circuits = {}
    for i, name in enumerate(names):
        root, frag = make_hpf_root_from_zoo(i, json_path=json_for.get(name), device=device)
        ckt = make_hpf_diode_clipper(root, fs, r_load=r_load, cap=cap)
        circuits[name] = (ckt, {**ckt.init_params(device), **frag})

    def hpf_map(cutoff_hz):
        return {"R": {"R": cutoff_to_resistance(cutoff_hz, cap)}}

    exact = {n: _generic_exact_runner(ckt, "Vs") for n, (ckt, _) in circuits.items()}
    overrides = {}
    if engine == "deer":
        overrides = {n: _deer_runner(ckt, "Vs", exact[n], **HPF_DEER)
                     for n, (ckt, _) in circuits.items()}

    specs = hpf_param_specs()
    all_names = list(circuits) + ["hpf"]
    return StreamingProcessor(
        circuits, fs, param_maps={n: hpf_map for n in all_names},
        param_schemas={n: specs for n in all_names},
        process_overrides=overrides,
        groups={"hpf": tuple(circuits)},
        exact_runners=exact,
        device=device,
    )


def make_plugin_processor(
    fs: float,
    cutoff_hz: float = 4000.0,
    drive: float = 0.5,
    mlp_json: Optional[str] = None,
    clipper_zoo: Optional[int] = None,
    clipper_json: Optional[str] = None,
    engine: str = "scan",
    *,
    device="cuda",
) -> StreamingProcessor:
    """The full reference-plugin circuit set (``DifferentiableWDFPlugin.h:41-43``):
    diode clipper, multi-diode clipper, and Tube Screamer, as model GROUPS:
    every advertised "model" choice is registered and hot-swappable at block
    rate with state continuity, the reference's root hot-swap
    (``DiodeClipperWDF.cpp:32-41``, ``MultiDiodeClipper.cpp:48``,
    ``CircuitModelGUI.cpp:55-66``):

    - "clipper": all 7 DiodeClipper roots (zoo entries 0-6: TOMS, approx,
      five 1U-1D neural sizes), members "clipper/0".."clipper/6";
    - "multi_diode_clipper": the 5 multi-diode 2x16 nets (zoo 7-11);
    - "tube_screamer": approx analytic + 2x16 neural
      (``TubeScreamer.h:73-74``).

    ``clipper_zoo`` picks the DEFAULT model choice by GLOBAL zoo index
    (0-11): 0-6 set the clipper group's default, 7-11 the multi-diode
    group's (``MultiDiodeClipper.cpp:48``); ``clipper_json`` overrides the
    selected entry's neural weights; ``mlp_json`` overrides the Tube
    Screamer's neural-model weights.  Neural entries default to the
    checked-in pretrained zoo (ZOO_MODEL_PATHS).

    engine="scan" serves every member with its exact engine: the clipper
    kernels at B=1 for the clippers, the generated kernel at B=1 for the
    Tube Screamer.  engine="deer" serves every member parallel in time for
    blocks of a multiple of 1024 samples: zoo 0 and 1 through the clipper's
    DEER kernel with (8, 3) and (4, 1) (sweeps, omega iterations), the
    neural clipper and multi-diode members and both Tube Screamer members
    through the generic one (8 sweeps, 2 relaxations); other block lengths
    and residual fallbacks get the exact engine.
    """
    from ..models.diode_clipper import (
        cutoff_to_resistance, make_diode_clipper, make_neural_root_or_default,
        make_root_from_zoo)
    from ..models.tube_screamer import drive_to_r6, make_tube_screamer
    from ..roots.diode import DiodePairRoot, diode_1n4148_1u1d

    _check_engine(engine)
    device = torch.device(device)
    cap = 2.2e-9
    r = cutoff_to_resistance(cutoff_hz, cap)
    circuits, param_maps, groups = {}, {}, {}

    zoo = clipper_zoo if clipper_zoo is not None else 0
    if not 0 <= zoo < 12:
        raise ValueError(f"clipper_zoo must be a zoo index 0-11, got {zoo}")
    default_clipper = zoo if zoo < 7 else 0
    default_md = zoo - 7 if zoo >= 7 else 0

    # clipper group: the full 7-root zoo, one circuit per root on the shared
    # Vs(R) || C tree (state {"C": {"z"}} carried across model switches);
    # multi-diode group: zoo entries 7-11 (``MultiDiodeClipper.cpp:48``
    # offsets the model index by +7 into the same WDF)
    members = {"clipper": [], "multi_diode_clipper": []}
    for i in range(12):
        root, frag = make_root_from_zoo(i, json_path=clipper_json if i == zoo else None,
                                        device=device)
        ckt_i = make_diode_clipper(root, fs, r_source=r, cap=cap)
        group, k = ("clipper", i) if i < 7 else ("multi_diode_clipper", i - 7)
        name = f"{group}/{k}"
        circuits[name] = (ckt_i, {**ckt_i.init_params(device), **frag})
        members[group].append(name)
    clipper_members, md_members = members["clipper"], members["multi_diode_clipper"]
    groups["clipper"], groups["multi_diode_clipper"] = tuple(clipper_members), tuple(md_members)

    def clipper_map(cutoff_hz):
        return {"Vs": {"R": cutoff_to_resistance(cutoff_hz, cap)}}

    for n in clipper_members + md_members + ["clipper", "multi_diode_clipper"]:
        param_maps[n] = clipper_map

    # tube screamer group: approx analytic root (the reference's
    # wdft::DiodePairT choice) + the 2x16 neural root
    ts_root0 = DiodePairRoot(name="dp", diode=diode_1n4148_1u1d, quality="low")
    ts0 = make_tube_screamer(ts_root0, fs, drive=drive)
    circuits["tube_screamer/0"] = (ts0, {**ts0.init_params(device),
                                         **ts_root0.init_params(device)})
    ts_root1, ts_frag1 = make_neural_root_or_default("dp", 2, 16, json_path=mlp_json,
                                                     device=device)
    ts1 = make_tube_screamer(ts_root1, fs, drive=drive)
    circuits["tube_screamer/1"] = (ts1, {**ts1.init_params(device), **ts_frag1})
    ts_members = ("tube_screamer/0", "tube_screamer/1")
    groups["tube_screamer"] = ts_members

    def ts_map(drive):
        return {"R6": {"R": drive_to_r6(drive)}}

    for n in ts_members + ("tube_screamer",):
        param_maps[n] = ts_map

    exact = {n: _lpf_exact_runner(circuits[n][0]) for n in clipper_members + md_members}
    exact.update({n: _generic_exact_runner(circuits[n][0], "Vin") for n in ts_members})
    overrides = {}
    if engine == "deer":
        # (sweeps, omega iters) of zoo 0 and 1 mirror make_clipper_processor's
        # so that the engine switch never changes the model
        cfg_of = {0: (8, 3), 1: (4, 1)}
        for i, name in enumerate(clipper_members + md_members):
            ckt = circuits[name][0]
            if i in cfg_of:
                overrides[name] = _clipper_deer_runner(exact[name], fs, *cfg_of[i])
            else:
                overrides[name] = _deer_runner(ckt, "Vs", exact[name])
        for name in ts_members:
            overrides[name] = _deer_runner(circuits[name][0], "Vin", exact[name])

    def with_default(specs, choice):
        return tuple(dataclasses.replace(s, default_choice=choice) if s.name == "model" else s
                     for s in specs)

    cl_specs = with_default(clipper_param_specs(), default_clipper)
    md_specs = with_default(multi_diode_param_specs(), default_md)
    ts_specs = tube_screamer_param_specs()
    schemas = {"clipper": cl_specs, "multi_diode_clipper": md_specs,
               "tube_screamer": ts_specs}
    schemas.update({m: cl_specs for m in clipper_members})
    schemas.update({m: md_specs for m in md_members})
    schemas.update({m: ts_specs for m in ts_members})

    return StreamingProcessor(
        circuits, fs, param_maps=param_maps,
        param_schemas=schemas,
        process_overrides=overrides,
        groups=groups,
        exact_runners=exact,
        device=device,
    )
