"""The work's share of the float32 peak over the window without the profiler."""

from wdfbench.readers import mfu as read  # noqa: F401
