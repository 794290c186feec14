"""Host milliseconds a training step in the parameter pass (``wdf.param_pass``)."""

from wdfbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "wdf.param_pass")
