"""Host milliseconds a serving call in ``wdf.prepare`` (adaptation, program
lookup, slot vector, root array)."""

from wdfbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "wdf.prepare")
