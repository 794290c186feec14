"""The traced window: ``torch.profiler`` over the window, reduced to what
the per-layer readers need.

From the profiler's events: the window's bounds (the harness's
``wdfbench.window`` range, which ends after its synchronise), every device
operation inside it (kernels, copies, sets), the device's busy time (the
union of their intervals), and each idle gap of the device named by what the
host was doing: the innermost recorded host operation around the launch of
the device operation that ends the gap.
"""

from __future__ import annotations

import re
from collections import defaultdict
from typing import Dict, List, Tuple

import torch

WINDOW = "wdfbench.window"

# kernels of PyTorch and its libraries; every other kernel is the program's own
_LIBRARY = re.compile(r"at::native|at::cuda|c10::|\bcub::|cutlass|cublas|cudnn|nvjet|"
                      r"^(void )?(sm\d+_|ampere_|hopper_|gemm|gemv|splitK)|Memcpy|Memset|"
                      r"^CUDA mem")


def is_library(name: str) -> bool:
    return bool(_LIBRARY.search(name))


def matches(name: str, prefix: str) -> bool:
    """Whether kernel ``name`` is the function ``prefix`` (a whole
    identifier inside a demangled name)."""
    return re.search(rf"(^|[^A-Za-z0-9_]){re.escape(prefix)}([^A-Za-z0-9_]|$)", name) is not None


def profiler():
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    return torch.profiler.profile(activities=acts)


def _union(intervals: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _launch_parents(cpu_events) -> Dict[int, str]:
    """{correlation id of a host-side launch or copy call: the name of the
    innermost host operation around it}, thread by thread."""
    by_thread = defaultdict(list)
    for e in cpu_events:
        by_thread[e.start_thread_id()].append(e)
    parents: Dict[int, str] = {}
    for events in by_thread.values():
        events.sort(key=lambda e: (e.start_ns(), -e.end_ns()))
        stack: List = []
        for e in events:
            while stack and stack[-1].end_ns() <= e.start_ns():
                stack.pop()
            if e.name().startswith(("cuda", "cu")) and e.correlation_id():
                outer = [s for s in stack if not s.name().startswith(("cuda", "cu"))]
                parents[e.correlation_id()] = outer[-1].name() if outer else "(none)"
                continue
            stack.append(e)
    return parents


def reduce(prof) -> dict:
    """The window's summary from a finished profiler: window_s, busy_s,
    {device op name: [count, seconds]} inside the window, {host activity:
    idle seconds}, and the device op count."""
    events = prof.profiler.kineto_results.events()
    cuda = torch.autograd.DeviceType.CUDA
    window = [e for e in events if e.name() == WINDOW and e.device_type() != cuda]
    if not window:
        raise RuntimeError("the trace holds no window range")
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    device, cpu = [], []
    for e in events:
        if e.device_type() != cuda:
            cpu.append(e)
        elif not e.is_user_annotation():  # a host range mirrored on the device timeline
            device.append(e)
    ops: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    spans = []
    for e in device:
        s, t = max(e.start_ns(), w0), min(e.end_ns(), w1)
        if t <= s:
            continue
        ops[e.name()][0] += 1
        ops[e.name()][1] += (t - s) * 1e-9
        spans.append((s, t, e))
    busy = _union([(s, t) for s, t, _ in spans])
    parents = _launch_parents(cpu)
    first_at = {}
    for s, _, e in spans:
        if s not in first_at:
            first_at[s] = e
    gaps: Dict[str, float] = defaultdict(float)
    edge = w0
    for s, t in busy + [(w1, w1)]:
        if s > edge:
            if s == w1:
                label = "host: the window's close (the queue drained)"
            else:
                e = first_at.get(s)
                corr = (e.correlation_id() or e.linked_correlation_id()) if e is not None else 0
                label = parents.get(corr, "(launch not traced)")
                if label == WINDOW:
                    label = "host: the loop's own Python"
            gaps[label] += (s - edge) * 1e-9
        edge = max(edge, t)
    return {"window_s": (w1 - w0) * 1e-9, "busy_s": sum(t - s for s, t in busy) * 1e-9,
            "ops": dict(ops), "gaps": dict(gaps), "device_ops": len(spans)}


def breakdown(summary: dict) -> dict:
    """The contract's breakdown: the ten device operations that took most
    time and the ten longest idle totals by host activity."""
    ops = sorted(((n, v[1]) for n, v in summary["ops"].items()), key=lambda x: -x[1])[:10]
    gaps = sorted(summary["gaps"].items(), key=lambda x: -x[1])[:10]
    return {"device_ops": [[n[:160], s] for n, s in ops],
            "idle_gaps": [[n[:160], s] for n, s in gaps]}
