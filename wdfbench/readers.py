"""What the metric readers compute; each ``metrics/<name>.py`` picks one.

A reader takes the run's context (the window's host seconds, the units of
work and samples it completed, the same of the untraced window that a
traced run measures first, the traced window's summary, the host spans,
the program's counters, the frozen work counts of the cell's kind) and
returns a number, or None where it finds nothing to read.

Peaks: one NVIDIA H100 SXM at its full 700 W, 67 TFLOP/s in float32
outside the tensor cores and 3.35 TB/s of HBM (NVIDIA's data sheet).
"""

from __future__ import annotations

import statistics

from wdfbench import trace

PEAK_OPS, PEAK_BYTES = 67e12, 3.35e12


def setup_seconds(ctx):
    return ctx["setup_s"]


def msamples_per_s(ctx):
    """Samples completed over the window's whole time, in millions a second."""
    return ctx["samples"] / ctx["window_s"] / 1e6


def kernel_roofline(ctx):
    """Percent: the least time the program's kernels could take, from the
    frozen counts (the larger of operations at PEAK_OPS and bytes at
    PEAK_BYTES, for every unit of work in the window), over the time they
    took in the trace.  A kernel of the program that the counts do not know
    adds its time with a bound of 0, and is named on the log."""
    tr = ctx["trace"]
    if not tr:
        return None
    port = {n: v[1] for n, v in tr["ops"].items() if not trace.is_library(n)}
    if not port:
        return None
    samples, rows = ctx["samples"], ctx["units"] * ctx["rows"]
    bound, known = 0.0, set()
    for k in ctx["work"]["kernels"]:
        names = {n for n in port if any(trace.matches(n, p) for p in k["prefixes"])}
        if names:
            known |= names
            bound += max(k["ops_per_sample"] * samples / PEAK_OPS,
                         (k["bytes_per_sample"] * samples + k["bytes_per_row"] * rows)
                         / PEAK_BYTES)
    for n in sorted(set(port) - known):
        print(f"wdfbench: kernel without frozen counts (bound 0): {n}", file=ctx["log"])
    return 100.0 * bound / sum(port.values())


def idle_share(ctx):
    """Percent of the traced window in which no operation ran on the device."""
    tr = ctx["trace"]
    if not tr or not tr["device_ops"]:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def torch_ops_ms(ctx):
    """Device milliseconds a unit of work in operations that are not the
    program's own kernels (PyTorch's and its libraries')."""
    tr = ctx["trace"]
    if not tr or not ctx["units"]:
        return None
    lib = sum(v[1] for n, v in tr["ops"].items() if trace.is_library(n))
    return 1e3 * lib / ctx["units"] if lib else None


def mfu(ctx):
    """Percent of the float32 peak: the operations the work needs (the
    frozen counts of every kernel and torch stage of the kind, times the
    samples completed) over the seconds of the traced run's window without
    the profiler, which the harness runs just before the traced one."""
    run = ctx.get("untraced")
    if not run:
        return None
    per_sample = sum(k["ops_per_sample"] for k in ctx["work"]["kernels"] + ctx["work"]["torch"])
    return 100.0 * per_sample * run["samples"] / run["window_s"] / PEAK_OPS


def wrapper_host_ms(ctx):
    """Median host milliseconds of one call of the entry on an idle card."""
    ms = ctx["spans"].get("call_host_ms")
    return statistics.median(ms) if ms else None
