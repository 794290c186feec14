"""diffwdf_tpu_torch's profiling harness (``runtime/profiler.py``) on the CPU.

The behaviours tests/test_profiler.py pins for the JAX package: timing
returns sane positive numbers, throughput divides by them, a trace leaves
files on disk, the NaN guard trips while on and lets NaN through once off,
and the memory snapshot is a dict or None.  On the CPU the Timer reads the
host clock; on a card it times with CUDA events (tests/test_torch_gpu.py).
"""

import os

import pytest
import torch

from diffwdf_tpu_torch.runtime import profiler


def test_timer_times_a_callable():
    f = lambda x: torch.tanh(x) @ x  # noqa: E731
    args = [(torch.ones((64, 64)) * i,) for i in range(3)]
    r = profiler.Timer(warmup=1, iters=5).time(f, args)
    assert r["mean_s"] > 0 and r["mean_ms"] == pytest.approx(r["mean_s"] * 1e3)


def test_timer_throughput_items_per_s():
    r = profiler.Timer(warmup=1, iters=3).throughput(
        lambda x: x * 2.0, [(torch.ones((128,)),)], items_per_call=128)
    assert r["items_per_s"] > 0


def test_trace_writes_artifacts(tmp_path):
    log_dir = str(tmp_path / "trace")
    with profiler.trace(log_dir) as d:
        (torch.ones((8,)) + 1).sum()
    found = [os.path.join(r, f) for r, _, fs in os.walk(d) for f in fs]
    assert found, "profiler trace produced no files"


def test_nan_guard_trips_and_resets():
    bad = lambda x: torch.log(x)  # noqa: E731  log(-1) -> NaN
    profiler.enable_nan_checks(True)
    try:
        with pytest.raises(FloatingPointError):
            bad(torch.tensor(-1.0))
        # backward operations are checked too
        x = torch.tensor(0.0, requires_grad=True)
        y = torch.sqrt(x) * 0.0
        with pytest.raises(FloatingPointError):
            y.backward()
    finally:
        profiler.enable_nan_checks(False)
    # guard off: NaN flows through silently again
    assert torch.isnan(bad(torch.tensor(-1.0)))
    profiler.enable_nan_checks(False)  # turning it off twice is harmless


def test_device_memory_stats_shape():
    stats = profiler.device_memory_stats()
    assert stats is None or isinstance(stats, dict)
    assert profiler.device_memory_stats("cpu") is None
