"""The single-stream DEER kernels' comparison forms.

The served kernels run one solve on a cluster of 16 CTAs: B5, the LPF
clipper's (``ops.parallel_time_deer``, ``csrc/parallel_time_deer.cu``), and
B9, a generated circuit's (``ops.deer_circuit``, ``DeerProgram.source``).
Beside them, for the before-and-after timings of ``chip_smoke.py`` and the
card tests only, this module launches

- ``C8``: the same cluster kernels at 8 CTAs;
- ``ONE_CTA``: the kernels before the cluster redesign, one CTA on one SM.

They are built on first use from sources of their own, which the served
path never compiles: ``csrc/forms/deer_clipper_forms.cu`` for the clipper, a
circuit's ``DeerProgram.forms_source`` for B9.  Each launch function takes
the form first and then the arguments of the served one
(``parallel_time_deer.launch``, ``deer_circuit.launcher``), so that a caller
can put it in the served one's place.
"""

from __future__ import annotations

import functools

import torch

from . import _build
from .circuit_codegen import DEER_FORMS, DEER_ONE_CTA, deer_program
from .deer_circuit import bind
from .fused_circuit import Prepared
from .parallel_time_deer import launch_args

ONE_CTA = DEER_ONE_CTA
C8 = 8
FORMS = DEER_FORMS
CLIPPER_FORMS_SOURCE = _build.CSRC_DIR / "forms" / "deer_clipper_forms.cu"
_NAMES = {ONE_CTA: "onecta", C8: "c8"}


def _name(form: int) -> str:
    if form not in _NAMES:
        raise ValueError(f"no DEER comparison form {form}: {FORMS}")
    return _NAMES[form]


@functools.cache
def clipper_library():
    """The clipper's comparison forms, built first if needed."""
    return _build.generated_library(CLIPPER_FORMS_SOURCE.read_text())


def clipper_launch(form: int, vin, s0, out, zf, res, L: int, consts, sweeps: int,
                   relax_passes: int, iters: int) -> None:
    """B5's ``form`` on the arguments of ``parallel_time_deer.launch``: one
    solve on the current stream into out, zf and res.  Raises with CUDA's
    message if the launch is refused."""
    fn = getattr(clipper_library(), f"deer_clipper_{_name(form)}_launch")
    scratch = torch.empty((4 if form == ONE_CTA else 5) * vin.shape[0], dtype=torch.float32,
                          device=vin.device)
    err = fn(*launch_args(vin, s0, out, zf, res, scratch, L, consts, sweeps, relax_passes,
                          iters))
    _build.check(err, f"fused_deer_clipper launch ({_name(form)})")


def clipper_max_clusters() -> int:
    """cudaOccupancyMaxActiveClusters of B5 at 8 CTAs."""
    n = clipper_library().deer_clipper_c8_max_clusters()
    _build.check(max(0, -n), "cudaOccupancyMaxActiveClusters at 8 CTAs")
    return n


def circuit_launcher(form: int, circuit, prep: Prepared, vin, s0, L: int, sweeps: int,
                     relax_passes: int, damping: float, adapt_tol: float, entry):
    """B9's ``form`` on the arguments of ``deer_circuit.launcher``: a
    callable that launches it, counts it in ``entry.launches`` and returns
    as the served launcher's."""
    deer = deer_program(circuit, prep.prog)
    lib = _build.generated_library(deer.forms_source)
    return bind(lib, f"circuit_deer_{_name(form)}_launch", deer, prep, vin, s0, L, sweeps,
                relax_passes, damping, adapt_tol, entry)


def circuit_max_clusters(circuit, prep: Prepared) -> int:
    """cudaOccupancyMaxActiveClusters of B9 at 8 CTAs."""
    lib = _build.generated_library(deer_program(circuit, prep.prog).forms_source)
    n = lib.circuit_deer_c8_max_clusters(0 if prep.warr is None else prep.warr.numel())
    _build.check(max(0, -n), "cudaOccupancyMaxActiveClusters at 8 CTAs",
                 lib.circuit_error_string)
    return n
