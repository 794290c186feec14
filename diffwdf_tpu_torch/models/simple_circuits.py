"""Simple linear circuits — the component-learning sanity workloads
(PyTorch): a resistive voltage divider and an RC lowpass, both with
trainable component values, plus an RL highpass (inductor exercise).
"""

from __future__ import annotations

from ..core.adaptors import Inverter, Series
from ..core.circuit import Circuit, IdealVoltageSourceRoot
from ..core.elements import Capacitor, Inductor, Resistor


def make_voltage_divider(fs: float, r1: float = 2.0e3, r2: float = 100.0) -> Circuit:
    """Vs -> series(R1, R2), output across R1; learn R1, R2."""
    R1 = Resistor("R1", r1, trainable=True)
    R2 = Resistor("R2", r2, trainable=True)
    tree = Inverter("I1", Series("S1", R1, R2))
    return Circuit(
        tree=tree, root=IdealVoltageSourceRoot("Vs"), fs=fs, outputs=("R1",)
    )


def make_rc_lowpass(fs: float, r: float = 1000.0, c: float = 1.0e-6) -> Circuit:
    """Vs -> series(R1, C1), output across C1; learn R and C."""
    R1 = Resistor("R1", r, trainable=True)
    C1 = Capacitor("C1", c, trainable=True)
    tree = Inverter("I1", Series("S1", R1, C1))
    return Circuit(
        tree=tree, root=IdealVoltageSourceRoot("Vs"), fs=fs, outputs=("C1",)
    )


def make_rl_highpass(fs: float, r: float = 1000.0, l: float = 0.1) -> Circuit:
    """Vs -> series(R1, L1), output across L1."""
    R1 = Resistor("R1", r, trainable=True)
    L1 = Inductor("L1", l, trainable=True)
    tree = Inverter("I1", Series("S1", R1, L1))
    return Circuit(
        tree=tree, root=IdealVoltageSourceRoot("Vs"), fs=fs, outputs=("L1",)
    )
