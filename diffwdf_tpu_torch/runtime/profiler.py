"""Profiling / timing harness.

- :class:`Timer`: steady-state timing of a callable, with input rotation;
  on a CUDA device the time is taken with CUDA events around the timed
  calls, on the CPU with ``time.perf_counter``;
- :func:`trace`: a ``torch.profiler`` trace of the with-block, written as a
  Chrome trace under ``log_dir``;
- :func:`device_memory_stats`: the CUDA caching allocator's counters;
- :func:`enable_nan_checks`: a guard that raises on the first NaN any
  operation produces while it is on (forward and backward alike).
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import time
from typing import Any, Callable, Dict, Optional, Sequence

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
    ``diffwdf_trace`` folder in the temporary directory)."""
    log_dir = log_dir or os.path.join(tempfile.gettempdir(), "diffwdf_trace")
    os.makedirs(log_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


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
