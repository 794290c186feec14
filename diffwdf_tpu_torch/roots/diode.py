"""Analytic diode-pair WDF roots (Wright-omega closed form, PyTorch).

Implements the wave-domain diode-pair solutions from Werner et al., "An
Improved and Generalized Diode Clipper Model for Wave Digital Filters":

- the symmetric pair (paper eqn 39), and
- the generalized asymmetric pair (eqn 45: N_up / N_down diodes per branch).

Diode physics (Is, Vt, ideality nabla, N_up, N_down) live in the params
dict, so they are differentiable like the R/C values.  The quality knob maps
to Newton iteration counts in the omega solve.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Dict, NamedTuple

import torch

from ..core.circuit import Root
from ..core.elements import Device
from .omega import omega_quality_iters, wright_omega


class DiodeConfig(NamedTuple):
    """Diode physics parameters."""

    name: str = ""
    Is: float = 1.0e-9
    nabla: float = 1.0
    Vt: float = 25.85e-3
    N_up: int = 1
    N_down: int = 1


default_diode = DiodeConfig("DefaultDiode")

# 1N4148 parameter set (SPICE fit)
_1N4148 = dict(Is=4.352e-9, nabla=1.906)
diode_1n4148_1u1d = DiodeConfig("1N4148 (1U-1D)", **_1N4148)
diode_1n4148_1u2d = DiodeConfig("1N4148 (1U-2D)", N_up=1, N_down=2, **_1N4148)
diode_1n4148_1u3d = DiodeConfig("1N4148 (1U-3D)", N_up=1, N_down=3, **_1N4148)
diode_1n4148_2u2d = DiodeConfig("1N4148 (2U-2D)", N_up=2, N_down=2, **_1N4148)
diode_1n4148_2u3d = DiodeConfig("1N4148 (2U-3D)", N_up=2, N_down=3, **_1N4148)
diode_1n4148_3u3d = DiodeConfig("1N4148 (3U-3D)", N_up=3, N_down=3, **_1N4148)

# OA1154 gold-bonded germanium diode: Is = 2 uA, nabla = 1.3 give the
# typical Ge forward drop, Vf(10 mA) ~= 0.29 V.
diode_oa1154_1u1d = DiodeConfig("OA1154 (1U-1D)", Is=2.0e-6, nabla=1.3)

ALL_1N4148 = {
    d.name: d
    for d in (
        diode_1n4148_1u1d,
        diode_1n4148_1u2d,
        diode_1n4148_1u3d,
        diode_1n4148_2u2d,
        diode_1n4148_2u3d,
        diode_1n4148_3u3d,
    )
}


def diode_pair_reflected(a, R, Is, Vt_eff, n_up, n_down, iters: int = 3):
    """Reflected wave of an asymmetric diode pair (Werner et al. eqn 45).

    a: incident wave; R: port impedance; Vt_eff = nabla * Vt;
    n_up / n_down: diodes in each anti-parallel branch.  Broadcasts over any
    shapes; the up/down branch selection is a sign select, not control flow.
    """
    a = torch.as_tensor(a)
    lam = torch.sign(a)  # 0 at a == 0, as the kernel's (a > 0) - (a < 0)
    n_up = torch.as_tensor(n_up, dtype=a.dtype, device=a.device)
    n_down = torch.as_tensor(n_down, dtype=a.dtype, device=a.device)
    # mu0 acts on the branch conducting for the current polarity
    mu0 = torch.where(a >= 0, n_down, n_up)
    mu1 = torch.where(a >= 0, n_up, n_down)
    r_is_over_vt = R * Is / Vt_eff
    x0 = torch.log(r_is_over_vt / mu0) + lam * a / (mu0 * Vt_eff)
    x1 = torch.log(r_is_over_vt / mu1) - lam * a / (mu1 * Vt_eff)
    return a - 2.0 * Vt_eff * lam * (
        mu0 * wright_omega(x0, iters) - mu1 * wright_omega(x1, iters)
    )


def diode_pair_reflected_symmetric(a, R, Is, Vt_eff, n_diodes=1.0, iters: int = 3):
    """Symmetric diode pair (eqn 39), with Vt pre-scaled by the diode count."""
    a = torch.as_tensor(a)
    Vt = Vt_eff * n_diodes
    lam = torch.sign(a)
    log_r_is_over_vt = torch.log(torch.as_tensor(R * Is / Vt))
    lam_a_over_vt = lam * a / Vt
    return a - 2.0 * Vt * lam * (
        wright_omega(log_r_is_over_vt + lam_a_over_vt, iters)
        - wright_omega(log_r_is_over_vt - lam_a_over_vt, iters)
    )


def shockley_current(v, Is, Vt_eff):
    """Ideal anti-parallel pair I/V curve i = 2 Is sinh(v / Vt_eff)."""
    return 2.0 * Is * torch.sinh(torch.as_tensor(v) / Vt_eff)


@dataclasses.dataclass(eq=False)
class DiodePairRoot(Root):
    """Analytic diode-pair root for a WDF tree.

    quality: "best" (3 Newton iters), "good", or "low" (fast approximation).
    """

    name: str = "dp"
    diode: DiodeConfig = default_diode
    quality: str = "best"

    def init_params(self, device: Device) -> Dict[str, Dict[str, Any]]:
        d = self.diode

        def f32(v):
            return torch.tensor(float(v), dtype=torch.float32, device=device)

        return {
            self.name: {
                "Is": f32(d.Is),
                "Vt": f32(d.Vt),
                "nabla": f32(d.nabla),
                "N_up": f32(d.N_up),
                "N_down": f32(d.N_down),
            }
        }

    @property
    def iters(self) -> int:
        return omega_quality_iters[self.quality]

    def reflect(self, a, R, params, controls):
        p = params[self.name]
        return diode_pair_reflected(
            a, R, p["Is"], p["nabla"] * p["Vt"], p["N_up"], p["N_down"], self.iters
        )
