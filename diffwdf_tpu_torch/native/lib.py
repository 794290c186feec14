"""ctypes bindings + on-demand build of the native WDF runtime.

A copy of the JAX package's ``diffwdf_tpu/native/lib.py`` (the same
functions and C API), which cannot be imported from here: importing it
imports jax through ``diffwdf_tpu/__init__.py``.  ``wdf_native.cpp`` is built
with the host ``g++`` on first use into ``diffwdf_tpu_torch/_build/``,
under a name keyed by a hash of the source and the flags; the C ABI +
ctypes is the binding layer.  ``available()`` says whether the build
succeeded.  ``clipper_process_neural`` takes the port's MLP parameters
(tensors on any device, or arrays).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "wdf_native.cpp"
_BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
_FLAGS = ("-O3", "-march=native", "-ffast-math", "-fno-finite-math-only", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libwdf_native_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> Optional[str]:
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    try:
        subprocess.run(["g++", *_FLAGS, "-o", str(tmp), str(_SRC)], check=True,
                       capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        tmp.unlink(missing_ok=True)
        return getattr(e, "stderr", str(e)) or str(e)
    os.replace(tmp, so)  # atomic: a concurrent loader sees all or nothing
    return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _lib, _build_error
    with _lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            return None
        so = _so_path()
        if not so.exists():
            err = _build(so)
            if err is not None:
                _build_error = err
                return None
        lib = ctypes.CDLL(str(so))
        lib.wdf_wrightomega.restype = ctypes.c_double
        lib.wdf_wrightomega.argtypes = [ctypes.c_double]
        lib.wdf_wrightomega_batch.restype = None
        lib.wdf_wrightomega_batch.argtypes = [
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_int64,
        ]
        lib.wdf_clipper_process.restype = None
        lib.wdf_clipper_process.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ] + [ctypes.c_double] * 7
        lib.wdf_clipper_process_neural.restype = None
        lib.wdf_clipper_process_neural.argtypes = [
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_double,
            ctypes.c_double,
            ctypes.c_double,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_int32,
        ]
        lib.wdf_load_csv.restype = ctypes.c_int64
        lib.wdf_load_csv.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return get_lib() is not None


def build_error() -> Optional[str]:
    get_lib()
    return _build_error


def _require() -> ctypes.CDLL:
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native runtime build failed:\n{_build_error}")
    return lib


# ---------------------------------------------------------------------------
# High-level wrappers
# ---------------------------------------------------------------------------


def wrightomega(x):
    """float64 Wright omega on the real line (native oracle)."""
    lib = _require()
    x = np.ascontiguousarray(np.atleast_1d(np.asarray(x, np.float64)))
    out = np.empty_like(x)
    lib.wdf_wrightomega_batch(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        x.size,
    )
    return out


def clipper_process(
    vin,
    z0: float,
    r_source: float,
    cap: float,
    fs: float,
    Is: float,
    vt_eff: float,
    n_up: float = 1.0,
    n_down: float = 1.0,
) -> Tuple[np.ndarray, float]:
    """Single-stream analytic clipper on the CPU engine."""
    lib = _require()
    x = np.ascontiguousarray(np.asarray(vin, np.float32))
    out = np.empty_like(x)
    z = ctypes.c_double(z0)
    lib.wdf_clipper_process(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.size,
        ctypes.byref(z),
        r_source,
        cap,
        fs,
        Is,
        vt_eff,
        n_up,
        n_down,
    )
    return out, z.value


def _host(x) -> np.ndarray:
    """A tensor (on any device) or array as a host f32 array."""
    if hasattr(x, "detach"):
        x = x.detach().cpu()
    return np.asarray(x, np.float32)


def _flatten_mlp(mlp_params):
    """MLP params -> (weights flat, sizes, acts) arrays for the C ABI."""
    layers = mlp_params["layers"]
    sizes = [int(layers[0]["kernel"].shape[0])]
    acts = []
    chunks = []
    for i, l in enumerate(layers):
        k = _host(l["kernel"])
        b = _host(l["bias"])
        sizes.append(int(k.shape[1]))
        acts.append(1 if i < len(layers) - 1 else 0)  # NxH family: tanh+linear head
        chunks.append(k.reshape(-1))
        chunks.append(b.reshape(-1))
    return (
        np.concatenate(chunks).astype(np.float32),
        np.asarray(sizes, np.int32),
        np.asarray(acts, np.int32),
    )


def clipper_process_neural(
    vin, z0: float, mlp_params, r_source: float, cap: float, fs: float
) -> Tuple[np.ndarray, float]:
    """Single-stream neural clipper on the CPU engine (RTNeural role)."""
    lib = _require()
    weights, sizes, acts = _flatten_mlp(mlp_params)
    x = np.ascontiguousarray(np.asarray(vin, np.float32))
    out = np.empty_like(x)
    z = ctypes.c_double(z0)
    lib.wdf_clipper_process_neural(
        x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        x.size,
        ctypes.byref(z),
        r_source,
        cap,
        fs,
        weights.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        sizes.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        acts.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        len(sizes) - 1,
    )
    return out, z.value


def load_csv(path: str) -> Tuple[np.ndarray, np.ndarray, float]:
    """Fast native CSV loader (reference measurement format)."""
    lib = _require()
    fs = ctypes.c_double(0.0)
    n = lib.wdf_load_csv(path.encode(), None, None, 0, ctypes.byref(fs))
    if n < 0:
        raise FileNotFoundError(path)
    vin = np.empty(n, np.float32)
    vout = np.empty(n, np.float32)
    lib.wdf_load_csv(
        path.encode(),
        vin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        vout.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        n,
        ctypes.byref(fs),
    )
    return vin, vout, fs.value
