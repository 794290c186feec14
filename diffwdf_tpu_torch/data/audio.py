"""WAV audio file I/O for the serving path.

The plugin shell sums the host's multi-channel float blocks to mono before
the WDF; this is the file-based equivalent for batch serving: read a WAV
(any PCM/float encoding scipy supports), mono-sum, normalise to float32 in
[-1, 1]; write mono float32 WAVs back out.  numpy and scipy only.
"""

from __future__ import annotations

import numpy as np

_PCM_SCALE = {
    np.dtype(np.int16): 1.0 / 32768.0,
    np.dtype(np.int32): 1.0 / 2147483648.0,
    np.dtype(np.uint8): 1.0 / 128.0,  # offset-binary
}


def read_wav(path: str) -> tuple[float, np.ndarray]:
    """Read a WAV file -> (sample_rate, mono float32 signal in [-1, 1])."""
    from scipy.io import wavfile

    fs, data = wavfile.read(path)
    data = np.asarray(data)
    if data.dtype in _PCM_SCALE:
        scale = _PCM_SCALE[data.dtype]
        if data.dtype == np.uint8:
            data = data.astype(np.float32) - 128.0
        x = data.astype(np.float32) * scale
    else:
        x = data.astype(np.float32)
    if x.ndim > 1:  # mono sum, matching the plugin shell
        x = x.mean(axis=1)
    return float(fs), x


def write_wav(path: str, fs: float, x: np.ndarray) -> None:
    """Write a mono float32 WAV."""
    from scipy.io import wavfile

    wavfile.write(path, int(round(fs)), np.asarray(x, dtype=np.float32))
