"""Readers of the program's own spans: the records that
``diffwdf_tpu_torch.runtime.profiler`` keeps of its ``wdf.*`` spans while a
profiler records, which in a run is the traced window alone.

A unit of work is one serving call or one training step: the program's
outermost span and every span opened inside it (on autograd's device thread
too).  The window's units are the last ``ctx["units"]`` units recorded.
``host_ms(ctx, name)`` is the median, over those units, of the host
milliseconds inside the unit's outermost spans of that name (one inside
another of the same name is not counted again); ``per_unit(ctx, name)`` the
median number of spans of that name a unit.  Each reads 0.0 where the
window has units but no span of that name, and None where the program keeps
no spans (an earlier program, or a stand-in for it).
"""

from __future__ import annotations

import statistics
from collections import defaultdict


def window_units(ctx):
    """The traced window's units, each a list of span records, or None."""
    from diffwdf_tpu_torch.runtime import profiler

    read = getattr(profiler, "spans", None)  # None in a program without spans
    records = read() if read is not None else None
    if not records or not ctx["units"]:
        return None
    units = defaultdict(list)
    for r in records:
        units[r.unit].append(r)
    return [units[u] for u in sorted(units)[-ctx["units"]:]]


def _outermost_ms(unit, name: str) -> float:
    by_id = {r.id: r for r in unit}
    total = 0
    for r in unit:
        if r.name != name:
            continue
        p = by_id.get(r.parent)
        while p is not None and p.name != name:
            p = by_id.get(p.parent)
        if p is None:
            total += r.end_ns - r.start_ns
    return total / 1e6


def host_ms(ctx, name: str):
    units = window_units(ctx)
    return statistics.median(_outermost_ms(u, name) for u in units) if units else None


def per_unit(ctx, name: str):
    units = window_units(ctx)
    return (float(statistics.median(sum(r.name == name for r in u) for u in units))
            if units else None)
