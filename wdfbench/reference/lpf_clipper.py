"""The LPF diode clipper's wave step, written out plainly.

Circuit (Chowdhury & Clarke, SMC 2022; the reference ``wdf_py/diode_clipper``):
a resistive voltage source Vs(R) in parallel with a capacitor C, the diode
pair (here its neural model) as the root on top, the output the voltage
across C.  The capacitor is a bilinear-transform one-sample memory,
R_C = 1 / (2 C fs).

This file imports nothing of the system under test: the adaptation and the
step are the textbook three-port parallel adaptor, in float64.
"""

from __future__ import annotations

import numpy as np

#: the reactive states, in order: the capacitor's memory
STATES = ("C.z",)


def coefficients(fs: float, r_source, cap: float) -> dict:
    """Adapted coefficients for source resistance(s) ``r_source`` (a float,
    or one per row): the parallel adaptor's p1R = G_s / (G_s + G_C) and the
    root's port resistance R_up = 1 / (G_s + G_C)."""
    g_s = 1.0 / np.asarray(r_source, np.float64)
    g_c = 2.0 * cap * fs
    g = g_s + g_c
    return {"p1R": g_s / g, "r_up": 1.0 / g}


def step(c: dict, z, v, root):
    """One sample: z = [capacitor memory], v the source voltage, ``root``
    maps the incident wave at the root to its reflected wave.  Returns
    (new states, output voltage)."""
    (zc,) = z
    b_temp = -c["p1R"] * (zc - v)          # parallel adaptor, up pass
    a = zc + b_temp                          # the wave the root sees
    b = root(a)
    zc_new = b + b_temp                      # down pass into the capacitor
    return [zc_new], 0.5 * (zc_new + zc)     # V(C) = (a_C + b_C) / 2


def for_config(cfg: dict, pot_rows=None) -> dict:
    """The coefficients of a configuration, per row where the rows carry
    their own pot resistance ``pot_rows``."""
    r = cfg["r_source"] if pot_rows is None else np.asarray(pot_rows, np.float64)
    return coefficients(cfg["fs"], r, cfg["cap"])
