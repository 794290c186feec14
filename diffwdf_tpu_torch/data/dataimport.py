"""Measurement-CSV importer, format-compatible with the reference dataset.

Parses the diode_dataset CSV layout (behavior parity with
``wdf_py/lib/dataimport.py``):

- header: '#Sample rate: <fs>Hz' on line 5, '#Samples: <n>' on line 6,
  column header on line 10, data rows after (``dataimport.py:10-30``);
- trims a 2.5 s lead-in and keeps 14.3 s of data (``:33-37``) — both
  configurable here since synthetic sets may use other timings;
- source resistance parsed from the filename ('45.2k_4.7nF.csv' -> 45.2 kOhm,
  ``:95``);
- train/validation split by R: train if R < 36 kOhm or R > 73 kOhm, else
  validation — the interpolation-regime holdout (``:98,116``).

Returns plain numpy; batching into tensors lives in
``diffwdf_tpu_torch.training.circuit_train``.  The logic is the JAX
package's module, copied: importing that one would import jax.
"""

from __future__ import annotations

import math
import os
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional

import numpy as np

#: reference trim constants (``dataimport.py:33-37``)
TRIM_PRE_S = 2.5
KEEP_S = 14.3

#: reference train/val R split in kOhm (``dataimport.py:98``)
VAL_R_LO_KOHM = 36.0
VAL_R_HI_KOHM = 73.0


@dataclass
class Measurement:
    vin: np.ndarray
    vout: np.ndarray
    fs: float
    r_ohms: float
    path: str


def read_csv(path, trim_pre_s: Optional[float] = TRIM_PRE_S, keep_s: Optional[float] = KEEP_S):
    """Parse one measurement CSV.  Returns (data[N, 2], fs)."""
    fs = None
    with open(path, "r") as f:
        lines = f.readlines()
    for ln in lines[:9]:
        if ln.startswith("#Sample rate:"):
            fs = float(ln.split("#Sample rate:")[1].split("Hz")[0])
    if fs is None:
        raise ValueError(f"no '#Sample rate:' header in {path}")
    rows = np.loadtxt(
        io_lines(lines[10:]), delimiter=",", dtype=np.float32, ndmin=2
    )
    if trim_pre_s is not None:
        start = math.floor(trim_pre_s * fs)
        end = math.ceil((trim_pre_s + (keep_s or 0)) * fs) if keep_s else len(rows)
        rows = rows[start:end]
    return rows, fs


def io_lines(lines):
    import io

    return io.StringIO("".join(lines))


def r_from_filename(path) -> float:
    """'45.2k_4.7nF.csv' -> 45200.0 Ohm (``dataimport.py:95``)."""
    stem = os.path.basename(str(path))
    return float(stem.partition("k")[0]) * 1000.0


def iter_measurements(
    data_dir,
    trim_pre_s: Optional[float] = TRIM_PRE_S,
    keep_s: Optional[float] = KEEP_S,
) -> List[Measurement]:
    out = []
    for p in sorted(Path(data_dir).iterdir()):
        if p.suffix.lower() != ".csv":
            continue
        rows, fs = read_csv(p, trim_pre_s, keep_s)
        out.append(
            Measurement(
                vin=rows[:, 0].astype(np.float32),
                vout=rows[:, 1].astype(np.float32),
                fs=fs,
                r_ohms=r_from_filename(p),
                path=str(p),
            )
        )
    return out


def data_path_for_diode(diode, base_dir, hpf: bool = False):
    """Directory scheme {base}/{family}/{N_up}up{N_down}down
    (``dataimport.py:62-79``)."""
    if "1N4148" in diode.name:
        family = "placeholder_data/HPF" if hpf else "1N4148"
    elif "OA1154" in diode.name:
        family = "OA1154"
    else:
        raise ValueError(f"no data available for diode {diode.name!r}")
    return Path(base_dir) / family / f"{diode.N_up}up{diode.N_down}down"


def load_diode_data(
    diode,
    base_dir,
    hpf: bool = False,
    trim_pre_s: Optional[float] = TRIM_PRE_S,
    keep_s: Optional[float] = KEEP_S,
    start_offset: int = 0,
    csv_samples: int = -1,
):
    """Load and split all measurements for a diode config.

    Returns (train, val, fs) where each split is a dict of concatenated
    arrays {"x": vin, "r": R per sample, "y": vout} — the same (x, R, y_ref)
    row triple the reference assembles (``dataimport.py:104-112``).
    """
    d = data_path_for_diode(diode, base_dir, hpf)
    train = {"x": [], "r": [], "y": []}
    val = {"x": [], "r": [], "y": []}
    fs = None
    for m in iter_measurements(d, trim_pre_s, keep_s):
        fs = m.fs
        rk = m.r_ohms / 1000.0
        split = train if (rk < VAL_R_LO_KOHM or rk > VAL_R_HI_KOHM) else val
        # per-file windowing parity (``dataimport.py:82,104-107``)
        end = None if csv_samples < 0 else start_offset + csv_samples
        vin = m.vin[start_offset:end]
        vout = m.vout[start_offset:end]
        split["x"].append(vin)
        split["r"].append(np.full_like(vin, m.r_ohms))
        split["y"].append(vout)

    def cat(d_):
        return {
            k: (np.concatenate(v) if v else np.zeros((0,), np.float32))
            for k, v in d_.items()
        }

    return cat(train), cat(val), fs


def batch_sequences(data: dict, batch_size: int) -> dict:
    """Chop concatenated streams into [n_seq, batch_size] sequence chunks
    (the reference's 'batches', ``clipper_pot.py:61-80``); drops the tail."""
    n = len(data["x"]) // batch_size
    out = {}
    for k, v in data.items():
        out[k] = v[: n * batch_size].reshape(n, batch_size)
    return out
