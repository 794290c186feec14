"""Copies of host values to the card a serving call (``wdf.h2d`` spans)."""

from wdfbench.spans import per_unit


def read(ctx):
    return per_unit(ctx, "wdf.h2d")
