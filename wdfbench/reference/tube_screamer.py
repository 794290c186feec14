"""The Tube Screamer clipping stage's wave step, written out plainly.

Circuit: the reference plugin's ``TubeScreamer.h:24-84`` (``.cpp:43-66``).
Port B of the op-amp's R-type adaptor is (Vin in series with C2) in
parallel with R5; port C is R4 in series with C3; port D the load RL; port A,
adapted, faces (R6 + drive * Pot1) || C4, which joins the adaptor in
parallel under the diode pair at the root.  The output is the voltage
across RL.

The R-type adaptor's scattering matrix is derived here from its netlist by
modified nodal analysis in float64: V+ (1), V- (2), the op-amp's internal
source (3) and its output (4); Ri across the inputs, the output resistance
(entered as -Ro, which reproduces the plugin's closed-form R-solver), and a
voltage-controlled source v3 = Ag (v1 - v2).  Terminating every port with
its resistance and driving one port's incident wave at a time gives the
port voltages V, and S = 2 V - I; the adapted port's resistance is the
Thevenin resistance into port A with the others terminated.

This file imports nothing of the system under test.
"""

from __future__ import annotations

import numpy as np

OPAMP_GAIN, OPAMP_RIN, OPAMP_ROUT = 100.0, 1.0e9, 1.0e-1
C2, R5, R4, C3, RL = 1.0e-6, 10.0e3, 4.7e3, 0.047e-6, 1.0e6
R6, POT1, C4 = 51.0e3, 500.0e3, 51.0e-12
R_VIN = 1.0

#: the reactive states, in order: C2, C3, C4 memories
STATES = ("C2.z", "C3.z", "C4.z")

# netlist: nodes 1..4 (0 is ground); ports as (plus node, minus node):
# A = (2, 4) adapted, B = (0, 1), C = (0, 2), D = (0, 4)
_PORTS = ((2, 4), (0, 1), (0, 2), (0, 4))
_RESISTORS = ((1, 2, OPAMP_RIN), (3, 4, -OPAMP_ROUT))


def _mna(g_ports, skip_port0: bool):
    """The 5 x 5 MNA matrix (4 nodes, the source's current) with every
    port's resistor stamped (port A's left out if ``skip_port0``), and the
    4 x 4 port incidence matrix."""
    A = np.zeros((5, 5))

    def stamp(na, nb, g):
        for n in (na, nb):
            if n > 0:
                A[n - 1, n - 1] += g
        if na > 0 and nb > 0:
            A[na - 1, nb - 1] -= g
            A[nb - 1, na - 1] -= g

    for na, nb, r in _RESISTORS:
        stamp(na, nb, 1.0 / r)
    # v3 - 0 = Ag (v1 - v2): the source's current enters node 3's row
    A[2, 4] += 1.0
    A[4, 2] += 1.0
    A[4, 0] -= OPAMP_GAIN
    A[4, 1] += OPAMP_GAIN
    inc = np.zeros((4, 4))
    for j, (p, q) in enumerate(_PORTS):
        if p > 0:
            inc[p - 1, j] += 1.0
        if q > 0:
            inc[q - 1, j] -= 1.0
    for j, g in enumerate(g_ports):
        if j == 0 and skip_port0:
            continue
        A[:4, :4] += g * np.outer(inc[:, j], inc[:, j])
    return A, inc


def rtype_scatter(r_children):
    """(S, Ra): the 4 x 4 scattering matrix and port A's adapted resistance
    for ports B, C, D terminated by ``r_children``."""
    g = 1.0 / np.asarray(r_children, np.float64)
    A, inc = _mna(np.concatenate([[1.0], g]), skip_port0=True)
    rhs = np.concatenate([inc[:, 0], [0.0]])
    ra = float(inc[:, 0] @ np.linalg.solve(A, rhs)[:4])
    g_all = np.concatenate([[1.0 / ra], g])
    A, inc = _mna(g_all, skip_port0=False)
    rhs = np.concatenate([inc, np.zeros((1, 4))]) * g_all[None, :]  # Norton a_j / R_j
    V = inc.T @ np.linalg.solve(A, rhs)[:4]
    return 2.0 * V - np.eye(4), ra


def _parallel(r1, r2):
    g1, g2 = 1.0 / r1, 1.0 / r2
    return 1.0 / (g1 + g2), g1 / (g1 + g2)


def coefficients(fs: float, drive: float) -> dict:
    """Adapted coefficients of the stage at ``fs`` and drive pot ``drive``."""
    r_c2, r_c3, r_c4 = 1.0 / (2 * C2 * fs), 1.0 / (2 * C3 * fs), 1.0 / (2 * C4 * fs)
    r_s1 = R_VIN + r_c2
    r_p1, p1_p1 = _parallel(r_s1, R5)
    r_s2 = R4 + r_c3
    S, ra = rtype_scatter([r_p1, r_s2, RL])
    r_p2, p1_p2 = _parallel(R6 + drive * POT1, r_c4)
    r_up, p1_p3 = _parallel(r_p2, ra)
    return {"p1_s1": R_VIN / r_s1, "p1_p1": p1_p1, "p1_s2": R4 / r_s2, "S": S,
            "p1_p2": p1_p2, "p1_p3": p1_p3, "r_up": r_up}


def step(c: dict, z, v, root):
    """One sample: z = [C2, C3, C4 memories], v the input voltage, ``root``
    maps the root's incident wave to its reflected wave.  Returns (new
    states, voltage across RL)."""
    z2, z3, z4 = z
    S = c["S"]
    # up pass: each adaptor's reflected wave toward the root
    b_s1 = -(v + z2)                          # series (Vin, C2)
    bd1 = 0.0 - b_s1                          # parallel (S1, R5), R5 reflects 0
    bt1 = -c["p1_p1"] * bd1
    b_p1 = 0.0 + bt1
    b_s2 = -(0.0 + z3)                        # series (R4, C3)
    b_r = S[0, 1] * b_p1 + S[0, 2] * b_s2     # R-type port A (RL reflects 0)
    bd2 = z4 - 0.0                            # parallel (R6, C4)
    bt2 = -c["p1_p2"] * bd2
    b_p2 = z4 + bt2
    bd3 = b_r - b_p2                          # parallel (P2, R-type) under the root
    bt3 = -c["p1_p3"] * bd3
    a = b_r + bt3
    b = root(a)
    # down pass
    x_r = b + bt3                             # into the R-type adaptor
    z4_new = (bd3 + x_r) + bt2                # P2 -> C4
    b1 = S[1, 0] * x_r + S[1, 1] * b_p1 + S[1, 2] * b_s2
    b2 = S[2, 0] * x_r + S[2, 1] * b_p1 + S[2, 2] * b_s2
    b3 = S[3, 0] * x_r + S[3, 1] * b_p1 + S[3, 2] * b_s2
    xs = bd1 + (b1 + bt1)                     # P1 -> S1
    b_vin = v - c["p1_s1"] * (xs + v + z2)
    z2_new = -(xs + b_vin)                    # S1 -> C2
    b_r4 = 0.0 - c["p1_s2"] * (b2 + 0.0 + z3)
    z3_new = -(b2 + b_r4)                     # S2 -> C3
    return [z2_new, z3_new, z4_new], 0.5 * b3  # V(RL) = (a_RL + 0) / 2


def for_config(cfg: dict, pot_rows=None) -> dict:
    """The coefficients of a configuration (the drive pot is fixed, so no
    row carries its own)."""
    if pot_rows is not None:
        raise ValueError("the Tube Screamer configuration drives no pot per row")
    return coefficients(cfg["fs"], cfg["drive"])
