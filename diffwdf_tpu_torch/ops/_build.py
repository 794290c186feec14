"""Build and load the package's CUDA kernels (``csrc/*.cu``).

At first use, ``library()`` compiles every ``.cu`` file under ``csrc/`` with
``nvcc`` into one shared library with a plain C interface and loads it with
``ctypes``.  The library lands in ``diffwdf_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the sources and flags, so an
edited source is rebuilt and an unchanged one is loaded as it is.  Nothing
is compiled when the module is imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, into the build log
)

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signatures of the exported launch functions (pointers and the stream as
#: c_void_p so ctypes never truncates them to 32 bits)
_SIGNATURES = {
    "fused_clipper_analytic_launch": (
        [_vp, _vp, _vp, _vp, _i, _i] + [_f] * 8 + [_i, _vp], ctypes.c_int),
    "fused_clipper_neural_launch": (
        [_vp, _vp, _vp, _vp, _i, _i, _vp, _i, _i, _f, _vp], ctypes.c_int),
    "diffwdf_cuda_error_string": ([_i], ctypes.c_char_p),
}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")
    return found


def _sources():
    sources = sorted(CSRC_DIR.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC_DIR}")
    return sources


def library_path() -> Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdiffwdf_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists.
    The compiler's output (with ``-Xptxas -v``) is kept beside it as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *map(str, _sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return so


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    lib = ctypes.CDLL(str(build()))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = restype
    return lib


def check(err: int, what: str) -> None:
    """Raise if a launch function returned a CUDA error."""
    if err != 0:
        msg = library().diffwdf_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")
