"""Median host milliseconds of one serving call: the program's outermost
``wdf.call`` span."""

from wdfbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "wdf.call")
