"""Host milliseconds a training step in ``wdf.prepare``: B7's forward's and B8's."""

from wdfbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "wdf.prepare")
