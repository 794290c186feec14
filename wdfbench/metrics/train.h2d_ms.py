"""Host milliseconds a training step in copies of host values to the card
(``wdf.h2d``)."""

from wdfbench.spans import host_ms


def read(ctx):
    return host_ms(ctx, "wdf.h2d")
