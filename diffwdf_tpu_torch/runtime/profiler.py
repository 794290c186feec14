"""Profiling / timing harness, and the port's own spans and counters.

- :class:`Timer`: steady-state timing of a callable, with input rotation;
  on a CUDA device the time is taken with CUDA events around the timed
  calls, on the CPU with ``time.perf_counter``;
- :func:`trace`: a ``torch.profiler`` trace of the with-block, written as a
  Chrome trace ``trace.json`` under ``log_dir`` (the port's ``wdf.*`` spans
  in it beside the kernels), with ``counters.json`` beside it: each
  counter's change over the block;
- :func:`span`: a named span of the port's own work (``wdf.call``,
  ``wdf.prepare``, ``wdf.launch.B7``, ...), recorded only while a
  ``torch.profiler`` records: then it opens a ``record_function`` range of
  that name and keeps a record on the host clock the profiler uses
  (``time.time_ns``), read by :func:`spans` (emptied by
  :func:`clear_spans`); otherwise it costs one C call;
- :func:`counters`: every counter of the port by name, for the whole
  process: the kernel wrappers' launch counts (``B1`` ... ``B9``), the
  builds, and the copies of host values to the card that go through
  :func:`h2d` (``h2d_copies``, ``h2d_bytes``), the generated programs
  (``programs_generated``) and the generated libraries loaded
  (``libraries_loaded``);
- :func:`device_memory_stats`: the CUDA caching allocator's counters;
- :func:`enable_nan_checks`: a guard that raises on the first NaN any
  operation produces while it is on (forward and backward alike).

This module imports only torch, so every module of the port can record
into it.
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import json
import os
import tempfile
import threading
import time
from typing import Any, Callable, Dict, List, NamedTuple, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten


def _cuda_device(tree) -> Optional[torch.device]:
    """The device of the first CUDA tensor in ``tree``, or None."""
    for x in tree_flatten(tree)[0]:
        if isinstance(x, torch.Tensor) and x.is_cuda:
            return x.device
    return None


class Timer:
    """Benchmark a callable: warmup + n back-to-back calls + sync."""

    def __init__(self, warmup: int = 2, iters: int = 20):
        self.warmup = warmup
        self.iters = iters

    def time(self, fn: Callable, args_list: Sequence[tuple]) -> Dict[str, float]:
        out = None
        for i in range(self.warmup):
            out = fn(*args_list[i % len(args_list)])
        dev = _cuda_device((args_list, out))
        if dev is None:
            t0 = time.perf_counter()
            for i in range(self.iters):
                fn(*args_list[i % len(args_list)])
            dt = (time.perf_counter() - t0) / self.iters
        else:
            with torch.cuda.device(dev):
                torch.cuda.synchronize()
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                for i in range(self.iters):
                    fn(*args_list[i % len(args_list)])
                end.record()
                end.synchronize()
            dt = start.elapsed_time(end) / 1e3 / self.iters
        return {"mean_s": dt, "mean_ms": dt * 1e3}

    def throughput(self, fn, args_list, items_per_call: int) -> Dict[str, float]:
        r = self.time(fn, args_list)
        r["items_per_s"] = items_per_call / r["mean_s"]
        return r


@contextlib.contextmanager
def trace(log_dir: Optional[str] = None):
    """Profile the with-block (the card too, where there is one) and write
    the Chrome trace ``trace.json`` under ``log_dir`` (default: a
    ``diffwdf_trace`` folder in the temporary directory), the ``wdf.*``
    spans in it, and ``counters.json``: each of :func:`counters` as its
    change over the block.  Empties the span buffer first, so that
    :func:`spans` reads the block's spans afterwards."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "diffwdf_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    clear_spans()
    before = counters()
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    after = counters()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "counters.json"), "w") as f:
        json.dump({k: v - before.get(k, 0) for k, v in after.items()}, f, indent=1)


# ---------------------------------------------------------------------------
# Spans: the port's own work, on the profiler's clock
# ---------------------------------------------------------------------------

#: True only while a torch.profiler records (on this thread; autograd's
#: device threads inherit it)
_recording = torch._C._autograd._profiler_enabled
#: the most records the span buffer keeps; later ones are counted as dropped
SPAN_CAP = 1 << 18


class SpanRecord(NamedTuple):
    """One closed span: start and end in ``time.time_ns()`` nanoseconds
    (the clock of the profiler's host events), the thread it ran on, its
    parent's id (-1 for none) and its unit's id."""

    id: int
    name: str
    start_ns: int
    end_ns: int
    thread: int
    parent: int
    unit: int


_records: List[SpanRecord] = []
_dropped = 0
_ids = itertools.count()
_units = itertools.count()
_local = threading.local()
#: (id, the owning thread's stack of open spans) of the unit open now
_open_unit: Optional[tuple] = None
#: guards the unit open now, the buffer's count of drops and the counters
_lock = threading.Lock()


class _Off:
    """The span of one name while no profiler records: entering and leaving
    it do nothing.  As a decorator it opens a span of its name at each call
    of the function."""

    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def __call__(self, fn: Callable) -> Callable:
        name = self.name

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)

        return spanned


_off: Dict[str, _Off] = {}


class _Span(_Off):
    """A span while a profiler records (see :func:`span`)."""

    __slots__ = ("id", "parent", "unit", "start", "stack", "range")

    def __enter__(self):
        global _open_unit
        stack = getattr(_local, "stack", None)
        if stack is None:
            stack = _local.stack = []
        with _lock:
            if stack:  # inside an open span of this thread
                self.parent, self.unit = stack[-1].id, stack[-1].unit
            elif _open_unit is not None:  # another thread's unit (autograd's device thread)
                self.unit, owner = _open_unit
                self.parent = owner[-1].id if owner else -1
            else:  # the outermost span: a new unit
                self.parent, self.unit = -1, next(_units)
                _open_unit = (self.unit, stack)
            self.id, self.stack = next(_ids), stack
        stack.append(self)
        self.start = time.time_ns()
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        return self

    def __exit__(self, *exc):
        global _open_unit, _dropped
        self.range.__exit__(*exc)
        end = time.time_ns()
        record = SpanRecord(self.id, self.name, self.start, end, threading.get_ident(),
                            self.parent, self.unit)
        with _lock:
            self.stack.pop()
            if not self.stack and _open_unit is not None and _open_unit[1] is self.stack:
                _open_unit = None
            if len(_records) < SPAN_CAP:
                _records.append(record)
            else:
                _dropped += 1
        return False


def span(name: str):
    """A span of the port's work named ``name``: a context manager, and a
    decorator of a function (a span at each call).

    While no ``torch.profiler`` records, it returns the no-op context of
    that name, one for every call (made at the name's first use), and calls
    nothing of ``torch.profiler``.  While one records, it opens a
    ``torch.profiler.record_function(name)`` range and, when the span
    closes, keeps a :class:`SpanRecord`: start and end on ``time.time_ns()``
    around the range, the thread, the parent span and the unit.  The
    outermost open span starts a new unit (one serving call, one training
    step); a span opened on another thread while a unit is open (autograd's
    device thread, running a custom backward) joins that unit, its parent
    the innermost span the unit has open."""
    if _recording():
        return _Span(name)
    off = _off.get(name)
    if off is None:
        off = _off[name] = _Off(name)
    return off


def spans() -> List[SpanRecord]:
    """The records of the spans closed since :func:`clear_spans`, in the
    order they closed (a child before its parent)."""
    return list(_records)


def clear_spans() -> None:
    """Empty the span buffer and its count of dropped records."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def dropped_spans() -> int:
    """Records the buffer dropped, full at ``SPAN_CAP``, since it was emptied."""
    return _dropped


# ---------------------------------------------------------------------------
# Counters
# ---------------------------------------------------------------------------

_counts: Dict[str, int] = {"h2d_copies": 0, "h2d_bytes": 0, "programs_generated": 0,
                           "libraries_loaded": 0}


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` (one of :func:`counters`' own four)."""
    with _lock:
        _counts[name] += n


def h2d(x, device, dtype: Optional[torch.dtype] = torch.float32) -> torch.Tensor:
    """``torch.as_tensor(x).detach().to(device, dtype)`` (None: x's dtype): a
    value set up on ``device`` (pageable and blocking, as the call it stands
    for).  Where that copies from host memory to another device, it counts
    one in ``h2d_copies`` and the bytes that land in ``h2d_bytes``, and
    copies in a ``wdf.h2d`` span."""
    t = torch.as_tensor(x).detach()
    if t.device.type != "cpu" or t.device == torch.device(device):
        return t.to(device, dtype)
    with span("wdf.h2d"):
        out = t.to(device, dtype)
    count("h2d_copies")
    count("h2d_bytes", out.numel() * out.element_size())
    return out


def counters() -> Dict[str, int]:
    """Every counter of the port by name, for the whole process: the launch
    counts the kernel wrappers keep (named by the kernel table's rows), the
    nvcc and host-compiler builds, and this module's own four."""
    from ..ops import (_build, clipper_train, deer_circuit, fused_circuit, fused_clipper,
                       parallel_bptt, parallel_time_deer)

    neural, circuit = fused_clipper.fused_clipper_neural, fused_circuit.fused_circuit_process
    return {
        "B1": neural.launches, "B1.one_thread": neural.one_thread_launches,
        "B2": fused_clipper.fused_clipper_analytic.launches,
        "B3": fused_clipper.fused_clipper_neural_train_fwd.launches,
        "B4": clipper_train.clipper_adjoint.launches,
        "B4.pass3": clipper_train.mlp_param_vjp.launches,
        "B5": parallel_time_deer.fused_deer_clipper.launches,
        "B6": fused_clipper.fused_clipper_cheb.launches,
        "B7": circuit.launches, "B7.lanes": circuit.lane_launches,
        "B7.pair": circuit.pair_launches,
        "B8": parallel_bptt.fused_backward.launches,
        "B8.pass3": parallel_bptt.root_param_vjp.launches,
        "B9": deer_circuit.fused_deer_circuit.launches,
        "B9.neural": deer_circuit.fused_deer_neural.launches,
        "nvcc_builds": _build.build_generated.builds, "host_builds": _build.build_host.builds,
        **_counts,
    }


def device_memory_stats(device=None) -> Optional[Dict[str, Any]]:
    """``torch.cuda.memory_stats`` of ``device`` (default: the current card),
    or None on the CPU or without a card."""
    if device is None:
        if not torch.cuda.is_available():
            return None
        device = torch.device("cuda", torch.cuda.current_device())
    device = torch.device(device)
    if device.type != "cuda":
        return None
    return torch.cuda.memory_stats(device)


class _NanCheck(TorchDispatchMode):
    """Raises ``FloatingPointError`` when an operation returns a NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for x in tree_flatten(out)[0]:
            if (isinstance(x, torch.Tensor) and (x.is_floating_point() or x.is_complex())
                    and bool(torch.isnan(x).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


_nan_mode: Optional[_NanCheck] = None


def enable_nan_checks(on: bool = True):
    """Solver-divergence guard: while on, any operation (autograd's backward
    ones included) that returns a NaN raises ``FloatingPointError``.  Each
    checked output is read on the host, so a guarded run waits on the card
    after every operation.  Turning it off restores unchecked dispatch."""
    global _nan_mode
    if on and _nan_mode is None:
        _nan_mode = _NanCheck()
        _nan_mode.__enter__()
    elif not on and _nan_mode is not None:
        mode, _nan_mode = _nan_mode, None
        mode.__exit__(None, None, None)
