"""Host milliseconds a training step in the parameter pass through ``adapt``
and the batched step (``wdf.param_pass``)."""

from wdfbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "wdf.param_pass")
