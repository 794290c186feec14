"""Three-port series/parallel scattering adaptors and the two-port inverter.

Standard Fettweis adaptor math as pure functions over the coeffs/state/waves
dicts.  The adaptation pass precomputes the single scattering coefficient
each 3-port adaptor needs, so the per-sample body is a handful of
multiply-adds.
"""

from __future__ import annotations

import dataclasses

from .elements import WDFNode


@dataclasses.dataclass(eq=False)
class Series(WDFNode):
    """3-port series adaptor, adapted up-port.

    R_up = R1 + R2; up-going reflection b = -(b1 + b2); downstream scattering
    uses p1R = R1 / (R1 + R2).
    """

    name: str
    p1: WDFNode
    p2: WDFNode

    def __post_init__(self):
        self.children = (self.p1, self.p2)

    def adapt(self, params, controls, coeffs, fs):
        R1 = self.p1.adapt(params, controls, coeffs, fs)
        R2 = self.p2.adapt(params, controls, coeffs, fs)
        R = R1 + R2
        coeffs[self.name] = {"R": R, "p1R": R1 / R}
        return R

    def reflected(self, coeffs, state, controls, waves):
        b1 = self.p1.reflected(coeffs, state, controls, waves)
        b2 = self.p2.reflected(coeffs, state, controls, waves)
        return self._record_b(waves, -(b1 + b2))

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        b1 = waves[self.p1.name][1]
        b2 = waves[self.p2.name][1]
        p1R = coeffs[self.name]["p1R"]
        b1_down = b1 - p1R * (x + b1 + b2)
        new = {}
        new.update(self.p1.incident(coeffs, state, controls, waves, b1_down))
        new.update(self.p2.incident(coeffs, state, controls, waves, -(x + b1_down)))
        return new


@dataclasses.dataclass(eq=False)
class Parallel(WDFNode):
    """3-port parallel adaptor, adapted up-port.

    G_up = G1 + G2; the up pass computes b_diff = b2 - b1 and
    b_temp = -(G1/G) * b_diff which the down pass reuses.
    """

    name: str
    p1: WDFNode
    p2: WDFNode

    def __post_init__(self):
        self.children = (self.p1, self.p2)

    def adapt(self, params, controls, coeffs, fs):
        R1 = self.p1.adapt(params, controls, coeffs, fs)
        R2 = self.p2.adapt(params, controls, coeffs, fs)
        G1 = 1.0 / R1
        G2 = 1.0 / R2
        G = G1 + G2
        coeffs[self.name] = {"R": 1.0 / G, "p1R": G1 / G}
        return coeffs[self.name]["R"]

    def reflected(self, coeffs, state, controls, waves):
        b1 = self.p1.reflected(coeffs, state, controls, waves)
        b2 = self.p2.reflected(coeffs, state, controls, waves)
        b_diff = b2 - b1
        b_temp = -coeffs[self.name]["p1R"] * b_diff
        # stash scatter intermediates in waves under a side-key so the down
        # pass stays a pure function of recorded traces
        waves[self.name + "/scratch"] = (b_diff, b_temp)
        return self._record_b(waves, b2 + b_temp)

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        b_diff, b_temp = waves[self.name + "/scratch"]
        b2_down = x + b_temp
        new = {}
        new.update(self.p1.incident(coeffs, state, controls, waves, b_diff + b2_down))
        new.update(self.p2.incident(coeffs, state, controls, waves, b2_down))
        return new


@dataclasses.dataclass(eq=False)
class Inverter(WDFNode):
    """2-port polarity inverter: negates both wave directions."""

    name: str
    p1: WDFNode

    def __post_init__(self):
        self.children = (self.p1,)

    def adapt(self, params, controls, coeffs, fs):
        R = self.p1.adapt(params, controls, coeffs, fs)
        coeffs[self.name] = {"R": R}
        return R

    def reflected(self, coeffs, state, controls, waves):
        b = self.p1.reflected(coeffs, state, controls, waves)
        return self._record_b(waves, -b)

    def incident(self, coeffs, state, controls, waves, x):
        self._record_a(waves, x)
        return self.p1.incident(coeffs, state, controls, waves, -x)
