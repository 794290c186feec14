"""Fused diode-clipper sample recursion: CUDA kernels and their plain versions.

The LPF clipper Vs(R) || C with a diode root is served over a batch of
independent streams, (B, T) blocks with the capacitor state z (B,) carried
from block to block.  Per sample and stream:

    b_temp = -p1R (z - v),  a = z + b_temp,  b = root(a),
    z' = b + b_temp,        out = (z' + z) / 2

Two roots, one wrapper each, with the JAX package's signatures:

- ``fused_clipper_analytic``: asymmetric diode pair (Werner eqn 45) with the
  real-line Wright omega inline (quality = Newton iteration count);
- ``fused_clipper_neural``: the "NxH" all-tanh MLP root with a linear head,
  H in {4, 8, 16} and any number L >= 1 of hidden H->H layers.

A wrapper given CPU tensors runs its plain version (``*_plain``: a loop over
time, vectorised over B); given CUDA tensors it launches its kernel from
``csrc/fused_clipper.cu`` or raises.  Each wrapper counts its kernel
launches in the plain integer ``<wrapper>.launches``.  The plain versions
run on any device and are what the kernels are held against.

Scalar constants (p1R, the diode-pair logs and reciprocals, log R) are
computed once on the host in double precision and rounded to f32, so kernel
and plain version see the same values.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ..roots.neural import MLPParams
from ..roots.omega import wright_omega_u
from . import _build

#: hidden widths the neural kernel is compiled for (the pretrained zoo's)
NEURAL_WIDTHS = (4, 8, 16)


def _f32(x) -> float:
    return float(np.float32(float(x)))


def _lpf_adaptor(r_source, cap, fs) -> Tuple[float, float]:
    """(p1R, R_up) of the parallel adaptor joining Vs(R) and C."""
    r_source, cap = float(r_source), float(cap)
    r_c = 1.0 / (2.0 * cap * fs)
    g = 1.0 / r_source + 1.0 / r_c
    return (1.0 / r_source) / g, 1.0 / g


def _check_io(vin: torch.Tensor, z0: torch.Tensor) -> None:
    if vin.dim() != 2:
        raise ValueError(f"vin must be (B, T), got shape {tuple(vin.shape)}")
    if z0.shape != (vin.shape[0],):
        raise ValueError(f"z0 must be (B,) = ({vin.shape[0]},), got {tuple(z0.shape)}")
    if vin.dtype != torch.float32 or z0.dtype != torch.float32:
        raise TypeError(f"vin and z0 must be float32, got {vin.dtype} and {z0.dtype}")
    if z0.device != vin.device:
        raise ValueError(f"vin on {vin.device} but z0 on {z0.device}")
    if vin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vin.device}")


def _launch_args(vin, z0):
    """Contiguous inputs, fresh outputs and the current stream of vin's card."""
    vin, z0 = vin.contiguous(), z0.contiguous()
    out, zf = torch.empty_like(vin), torch.empty_like(z0)
    stream = torch.cuda.current_stream(vin.device).cuda_stream
    return vin, z0, out, zf, stream


# ---------------------------------------------------------------------------
# Analytic diode-pair root
# ---------------------------------------------------------------------------


def _analytic_constants(r_source, cap, fs, Is, Vt_eff, n_up, n_down):
    p1R, r_up = _lpf_adaptor(r_source, cap, fs)
    Is, Vt_eff, n_up, n_down = map(float, (Is, Vt_eff, n_up, n_down))
    return tuple(_f32(c) for c in (
        p1R,
        math.log(r_up * Is / (n_up * Vt_eff)),
        math.log(r_up * Is / (n_down * Vt_eff)),
        1.0 / (n_up * Vt_eff),
        1.0 / (n_down * Vt_eff),
        2.0 * Vt_eff,
        n_up,
        n_down,
    ))


def fused_clipper_analytic_plain(vin, z0, r_source, cap, Is, Vt_eff, n_up, n_down,
                                 *, fs: float, quality_iters: int = 3):
    """Plain PyTorch version of the analytic kernel: the same constants and
    per-sample math, one sample at a time over the whole batch."""
    _check_io(vin, z0)
    p1R, log_up, log_dn, inv_up, inv_dn, two_vt, n_up, n_dn = _analytic_constants(
        r_source, cap, fs, Is, Vt_eff, n_up, n_down)
    out = torch.empty_like(vin)
    z = z0
    for t in range(vin.shape[1]):
        b_temp = -p1R * (z - vin[:, t])
        a = z + b_temp
        lam = torch.sign(a)
        pos = a >= 0
        mu0 = torch.where(pos, n_dn, n_up)
        mu1 = torch.where(pos, n_up, n_dn)
        log0 = torch.where(pos, log_dn, log_up)
        log1 = torch.where(pos, log_up, log_dn)
        inv0 = torch.where(pos, inv_dn, inv_up)
        inv1 = torch.where(pos, inv_up, inv_dn)
        la = lam * a
        w0 = torch.exp(wright_omega_u(log0 + la * inv0, quality_iters))
        w1 = torch.exp(wright_omega_u(log1 - la * inv1, quality_iters))
        z_new = a - two_vt * lam * (mu0 * w0 - mu1 * w1) + b_temp
        out[:, t] = 0.5 * (z_new + z)
        z = z_new
    return out, z


def fused_clipper_analytic(vin, z0, r_source, cap, Is, Vt_eff, n_up, n_down,
                           *, fs: float, quality_iters: int = 3):
    """Fused LPF diode clipper with the analytic diode-pair root.

    vin: (B, T) float32; z0: (B,) initial capacitor state.  Returns
    (out (B, T), z_final (B,)).  Source R, cap and the diode physics are
    held for the block.
    """
    if vin.device.type == "cpu":
        return fused_clipper_analytic_plain(vin, z0, r_source, cap, Is, Vt_eff, n_up,
                                            n_down, fs=fs, quality_iters=quality_iters)
    _check_io(vin, z0)
    consts = _analytic_constants(r_source, cap, fs, Is, Vt_eff, n_up, n_down)
    B, T = vin.shape
    if B == 0:
        return torch.empty_like(vin), torch.empty_like(z0)
    lib = _build.library()
    with torch.cuda.device(vin.device):
        vin, z0, out, zf, stream = _launch_args(vin, z0)
        err = lib.fused_clipper_analytic_launch(
            vin.data_ptr(), z0.data_ptr(), out.data_ptr(), zf.data_ptr(), B, T,
            *consts, int(quality_iters), stream)
    _build.check(err, "fused_clipper_analytic launch")
    fused_clipper_analytic.launches += 1
    return out, zf


fused_clipper_analytic.launches = 0


# ---------------------------------------------------------------------------
# Neural-root kernel
# ---------------------------------------------------------------------------


def _neural_weights(mlp_params: MLPParams, log_r: float):
    """Split an NxH MLP into (H, w1a, c1, hidden, w3, b3), with the log-R
    column of the first layer folded into its bias c1.  Raises on an
    architecture the kernel does not take."""
    layers = mlp_params["layers"]
    if len(layers) < 3:
        raise ValueError("fused neural kernel needs >= 1 hidden H->H layer")
    W1, b1 = layers[0]["kernel"], layers[0]["bias"]
    H = W1.shape[1]
    if H not in NEURAL_WIDTHS:
        raise ValueError(f"fused neural kernel takes widths {NEURAL_WIDTHS}, got {H}")
    want = [((2, H), (H,))] + [((H, H), (H,))] * (len(layers) - 2) + [((H, 1), (1,))]
    for i, (layer, (ks, bs)) in enumerate(zip(layers, want)):
        if tuple(layer["kernel"].shape) != ks or tuple(layer["bias"].shape) != bs:
            raise ValueError(
                f"layer {i}: kernel {tuple(layer['kernel'].shape)} / bias "
                f"{tuple(layer['bias'].shape)}, the NxH family needs {ks} / {bs}")
        if layer["kernel"].dtype != torch.float32 or layer["bias"].dtype != torch.float32:
            raise TypeError(f"layer {i}: weights must be float32")
    c1 = W1[1] * log_r + b1
    hidden = [(l["kernel"], l["bias"]) for l in layers[1:-1]]
    return H, W1[0], c1, hidden, layers[-1]["kernel"][:, 0], layers[-1]["bias"]


def fused_clipper_neural_plain(vin, z0, mlp_params: MLPParams, r_source, cap, *, fs: float):
    """Plain PyTorch version of the neural kernel: the same folded weights
    and per-sample math, one sample at a time over the whole batch."""
    _check_io(vin, z0)
    p1R, r_up = _lpf_adaptor(r_source, cap, fs)
    p1R = _f32(p1R)
    _, w1a, c1, hidden, w3, b3 = _neural_weights(mlp_params, _f32(math.log(r_up)))
    out = torch.empty_like(vin)
    z = z0
    for t in range(vin.shape[1]):
        b_temp = -p1R * (z - vin[:, t])
        a = z + b_temp
        h = torch.tanh(a[:, None] * w1a + c1)
        for k, b in hidden:
            h = torch.tanh(h @ k + b)
        z_new = -(h @ w3 + b3) + b_temp
        out[:, t] = 0.5 * (z_new + z)
        z = z_new
    return out, z


def fused_clipper_neural(vin, z0, mlp_params: MLPParams, r_source, cap, *, fs: float):
    """Fused LPF diode clipper with an NxH neural root (all-tanh, linear head).

    vin: (B, T) float32; z0: (B,).  Returns (out (B, T), z_final (B,)).
    """
    if vin.device.type == "cpu":
        return fused_clipper_neural_plain(vin, z0, mlp_params, r_source, cap, fs=fs)
    _check_io(vin, z0)
    p1R, r_up = _lpf_adaptor(r_source, cap, fs)
    H, w1a, c1, hidden, w3, b3 = _neural_weights(mlp_params, _f32(math.log(r_up)))
    parts = [w1a, c1, w3, b3] + [x.reshape(-1) for layer in hidden for x in layer]
    if any(p.device != vin.device for p in parts):
        raise ValueError(f"MLP weights must lie on {vin.device}, like vin")
    B, T = vin.shape
    if B == 0:
        return torch.empty_like(vin), torch.empty_like(z0)
    lib = _build.library()
    with torch.cuda.device(vin.device):
        weights = torch.cat(parts).contiguous()
        vin, z0, out, zf, stream = _launch_args(vin, z0)
        err = lib.fused_clipper_neural_launch(
            vin.data_ptr(), z0.data_ptr(), out.data_ptr(), zf.data_ptr(), B, T,
            weights.data_ptr(), H, len(hidden), _f32(p1R), stream)
    _build.check(err, "fused_clipper_neural launch")
    fused_clipper_neural.launches += 1
    return out, zf


fused_clipper_neural.launches = 0
