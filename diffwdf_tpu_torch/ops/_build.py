"""Build and load the package's CUDA kernels (``csrc/*.cu``).

At first use, ``library()`` compiles every ``.cu`` file of ``csrc/`` (not of
``csrc/forms/``) with ``nvcc`` (one compiler process per source, all started together), links the
objects into one shared library with a plain C interface and loads it with
``ctypes``.  The library lands in ``diffwdf_tpu_torch/_build/`` (listed in
``.gitignore``) under a name keyed by a hash of the sources, the headers
(``csrc/*.cuh``) and the flags, so an edited source or header is rebuilt and
an unchanged one is loaded as it is.  Nothing is compiled when the module is
imported.

Generated sources (``ops.circuit_codegen``, a forward, an adjoint and a DEER
solve per circuit structure) and ``csrc/forms/omega_forms.cu``, which
``library()`` leaves out, take another path: ``generated_library(source)``
writes the source into the same directory, compiles it alone into its own
library with the same flags (the headers of ``csrc/`` on the include path)
and keys it by a hash of the source, the headers and the flags, so a circuit
that only changes values never builds again.

A generated forward also builds for the host: ``host_library(source)``
compiles a program's ``host_source`` (the step and ``circuit_host_run``, a
one-thread loop over streams and samples) with the host ``c++``, the CUDA
qualifiers defined away by ``csrc/host_standin.h`` and no FMA contraction,
into the same directory, keyed by a hash of the source, the headers and the
flags.  It serves the artifact's circuit op on the CPU and the command
line's native engine.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

from ..runtime.profiler import count

CSRC_DIR = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills per kernel, into the build log
)

_vp, _i, _f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signatures of the exported launch functions (pointers and the stream as
#: c_void_p so ctypes never truncates them to 32 bits)
_SIGNATURES = {
    "fused_clipper_analytic_launch": (
        [_vp, _vp, _vp, _vp, _i, _i] + [_f] * 8 + [_i, _vp], ctypes.c_int),
    "fused_clipper_neural_launch": (
        [_vp, _vp, _vp, _vp, _i, _i, _vp, _i, _i, _f, _i, _vp], ctypes.c_int),
    "fused_clipper_neural_onethread_launch": (
        [_vp, _vp, _vp, _vp, _i, _i, _vp, _i, _i, _f, _vp], ctypes.c_int),
    "clipper_train_fwd_launch": (
        [_vp] * 7 + [_i, _i, _vp, _i, _i, _i, _i, _vp], ctypes.c_int),
    "clipper_train_fwd_onethread_launch": (
        [_vp] * 7 + [_i, _i, _vp, _i, _i, _vp], ctypes.c_int),
    "clipper_tangent_launch": ([_vp] * 4 + [_i, _i, _vp, _i, _i, _vp], ctypes.c_int),
    "clipper_recursion_launch": ([_vp] * 6 + [_i, _i, _vp], ctypes.c_int),
    "clipper_param_ctas": ([_i, _i, _vp], ctypes.c_int),
    "clipper_param_launch": ([_vp] * 4 + [_i, _vp, _i, _i, _vp, _i, _i, _vp], ctypes.c_int),
    "deer_clipper_launch": (
        [_vp] * 6 + [_i] + [_f] * 8 + [_i] * 3 + [_vp], ctypes.c_int),
    "deer_clipper_max_clusters": ([], ctypes.c_int),
    "fused_clipper_cheb_launch": (
        [_vp] * 4 + [_i, _i, _vp, _i, _i, _i, _f, _vp], ctypes.c_int),
    "diffwdf_cuda_error_string": ([_i], ctypes.c_char_p),
}


def _tag(so: Path) -> str:
    """The stem of a build's temporary files: the library's, the process's
    and the thread's, so builders of one source in two processes or two
    threads never share a temporary file (the last to finish replaces the
    library, atomically, with the same bytes)."""
    return f"{so.stem}.{os.getpid()}.{threading.get_ident()}"


def _write_atomic(path: Path, text: str, tag: str) -> None:
    tmp = path.with_name(f"{tag}.{path.name}.tmp")
    tmp.write_text(text)
    os.replace(tmp, path)


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
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cuh")) + _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libdiffwdf_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless a library for them already exists.
    The compilers' output (with ``-Xptxas -v``) is kept beside it as ``.log``."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = _tag(so)
    nvcc = _nvcc()
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in _sources()]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(_sources(), objs)]
    logs = [f"$ nvcc -c {src.name}\n{proc.communicate()[0]}"
            for src, proc in zip(_sources(), procs)]
    failed = [src.name for src, proc in zip(_sources(), procs) if proc.returncode != 0]
    tmp = so.with_name(f"{tag}.tmp.so")
    if not failed:
        link = subprocess.run([nvcc, *NVCC_FLAGS[:2], "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        logs.append(f"$ nvcc -shared\n{link.stdout}{link.stderr}")
        if link.returncode != 0:
            failed.append("link")
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "\n".join(logs)
    _write_atomic(so.with_suffix(".log"), log, tag)
    if failed:
        raise RuntimeError(f"nvcc failed ({', '.join(failed)}):\n{log}")
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


def check(err: int, what: str, error_string=None) -> None:
    """Raise if a launch function returned a CUDA error.  ``error_string``
    is the C function naming the error (default: the kernel library's)."""
    if err != 0:
        msg = (error_string or library().diffwdf_cuda_error_string)(err).decode()
        raise RuntimeError(f"{what} failed: CUDA error {err} ({msg})")


# ---------------------------------------------------------------------------
# Generated sources (ops/circuit_codegen.py): one library per source
# ---------------------------------------------------------------------------

#: C signatures of the generated circuit kernel libraries (a forward source
#: exports circuit_launch, an adjoint source its two passes, a DEER source
#: circuit_deer_launch and its cluster occupancy query) and of
#: csrc/forms/omega_forms.cu (omega() against omega_select)
_GENERATED_SIGNATURES = {
    "circuit_launch": ([_vp] * 5 + [_i, _i] + [_vp] * 4 + [_i] * 3 + [_vp], ctypes.c_int),
    "circuit_jacobian_launch": ([_vp] * 5 + [_i] * 4 + [_vp] * 4 + [_i, _vp], ctypes.c_int),
    "circuit_recursion_launch": ([_vp] * 6 + [_i] * 4 + [_vp], ctypes.c_int),
    "circuit_deer_launch": ([_vp] * 6 + [_i] + [_vp] * 2 + [_i] * 4 + [_f] * 2 + [_i, _vp],
                            ctypes.c_int),
    "circuit_deer_max_clusters": ([_i], ctypes.c_int),
    "circuit_error_string": ([_i], ctypes.c_char_p),
    "omega_forms_launch": ([_vp] * 3 + [_i, _i, _vp], ctypes.c_int),
}


@functools.cache
def _headers_digest() -> bytes:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for hdr in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return h.digest()


def generated_path(source: str) -> Path:
    """Where the library of a generated source lives: keyed by a hash of the
    source, the headers it may include (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256(_headers_digest())
    h.update(source.encode())
    return BUILD_DIR / f"libcircuit_{h.hexdigest()[:16]}.so"


def build_generated(sources) -> list:
    """Compile each generated source that has no library yet: one nvcc per
    source, all started together.  The source is kept beside its library as
    ``.cu`` and the compiler's output (``-Xptxas -v``) as ``.log``.  Every
    nvcc started adds one to ``build_generated.builds``.  A failed nvcc
    raises with its log.  Returns the library paths, in order."""
    paths = [generated_path(s) for s in sources]
    todo = {p: s for p, s in zip(paths, sources) if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for so, src in todo.items():
        tag = _tag(so)
        cu = so.with_suffix(".cu")
        _write_atomic(cu, src, tag)
        tmp = BUILD_DIR / f"{tag}.tmp.so"
        procs.append((so, tag, tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-I", str(CSRC_DIR), "-shared", "-o", str(tmp), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        build_generated.builds += 1
    failed = []
    for so, tag, tmp, proc in procs:
        log = f"$ nvcc -shared {so.stem}.cu\n{proc.communicate()[0]}"
        _write_atomic(so.with_suffix(".log"), log, tag)
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            failed.append(log)
        else:
            os.replace(tmp, so)  # atomic, as build()
    if failed:
        raise RuntimeError("nvcc failed on a generated circuit kernel:\n" + "\n".join(failed))
    return paths


build_generated.builds = 0

#: source -> its loaded library: a launch finds its library without hashing
#: the source (tens of kilobytes) again
_generated_libs: dict = {}


def generated_library(source: str) -> ctypes.CDLL:
    """The loaded library of a generated source, built first if needed.  A
    miss counts one in ``runtime.profiler``'s ``libraries_loaded``."""
    lib = _generated_libs.get(source)
    if lib is None:
        count("libraries_loaded")
        lib = ctypes.CDLL(str(build_generated([source])[0]))
        for name, (argtypes, restype) in _GENERATED_SIGNATURES.items():
            if not hasattr(lib, name):
                continue
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = restype
        _generated_libs[source] = lib
    return lib


# ---------------------------------------------------------------------------
# Host builds of generated forwards (circuit_host_run)
# ---------------------------------------------------------------------------

HOST_STANDIN = CSRC_DIR / "host_standin.h"
#: no contraction: an FMA rounds once where the card's __f*_rn steps round
#: twice, and the Tube Screamer amplifies that ~10x
HOST_FLAGS = ("-O2", "-ffp-contract=off", "-shared", "-fPIC", "-x", "c++")
#: circuit_host_run(vin, z0, out, zf, seq, B, T, coef, rows, times, warr)
HOST_RUN_SIGNATURE = [_vp] * 5 + [_i, _i] + [_vp] * 4


def _cxx() -> str:
    found = os.environ.get("CXX") or shutil.which("c++") or shutil.which("g++")
    if found is None:
        raise RuntimeError("no host C++ compiler: set CXX or put c++ on PATH")
    return found


def host_path(source: str) -> Path:
    """Where the host library of a generated host source lives."""
    h = hashlib.sha256(" ".join(HOST_FLAGS).encode())
    for hdr in [HOST_STANDIN] + sorted(CSRC_DIR.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    h.update(source.encode())
    return BUILD_DIR / f"libhost_{h.hexdigest()[:16]}.so"


def build_host(source: str) -> Path:
    """Compile a generated host source unless its library exists: the host
    ``c++`` with ``HOST_FLAGS``, ``csrc/host_standin.h`` as
    ``cuda_runtime.h``.  Every compiler run adds one to
    ``build_host.builds``; a failed one raises with its output."""
    so = host_path(source)
    if so.exists():
        return so
    tag = _tag(so)
    inc = BUILD_DIR / f"{tag}.include"
    inc.mkdir(parents=True, exist_ok=True)
    (inc / "cuda_runtime.h").write_text(HOST_STANDIN.read_text())
    cpp, tmp = so.with_suffix(".cpp"), BUILD_DIR / f"{tag}.tmp.so"
    _write_atomic(cpp, source, tag)
    proc = subprocess.run([_cxx(), *HOST_FLAGS, f"-I{inc}", f"-I{CSRC_DIR}", "-o", str(tmp),
                           str(cpp)], capture_output=True, text=True)
    build_host.builds += 1
    shutil.rmtree(inc, ignore_errors=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"c++ failed on a generated host source:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, so)  # atomic, as build()
    return so


build_host.builds = 0

#: host source -> its loaded library
_host_libs: dict = {}


def host_library(source: str) -> ctypes.CDLL:
    """The loaded host library of a generated host source (a program's
    ``host_source``), built first if needed, with ``circuit_host_run``
    bound."""
    lib = _host_libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build_host(source)))
        lib.circuit_host_run.argtypes = HOST_RUN_SIGNATURE
        lib.circuit_host_run.restype = None
        _host_libs[source] = lib
    return lib
