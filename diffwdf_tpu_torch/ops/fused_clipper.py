"""Fused diode-clipper sample recursion: CUDA kernels and their plain versions.

The LPF clipper Vs(R) || C with a diode root is served over a batch of
independent streams, (B, T) blocks with the capacitor state z (B,) carried
from block to block.  Per sample and stream:

    b_temp = -p1R (z - v),  a = z + b_temp,  b = root(a),
    z' = b + b_temp,        out = (z' + z) / 2

Three roots, one wrapper each, with the JAX package's signatures:

- ``fused_clipper_analytic``: asymmetric diode pair (Werner eqn 45) with the
  real-line Wright omega inline (quality = Newton iteration count);
- ``fused_clipper_neural``: the "NxH" all-tanh MLP root with a linear head,
  H in {4, 8, 16} and any number L >= 1 of hidden H->H layers;
- ``fused_clipper_cheb``: a distilled piecewise-Chebyshev root
  (``roots.distilled``), no transcendentals (``csrc/cheb.cu``), one segment
  a lane of its stream's group (:func:`cheb_lanes`).

and the training forward of the neural clipper,
``fused_clipper_neural_train_fwd``: the source resistance is per row (the
hoisted per-chunk pot of the training data), and the root's incident wave
a_t is written out as the residual of the adjoint (``ops.clipper_train``);
its kernel gives each stream a group of lanes of a warp (:func:`nxh_lanes`).

A wrapper given CPU tensors runs its plain version (``*_plain``: a loop over
time, vectorised over B); given CUDA tensors it launches its kernel from
``csrc/fused_clipper.cu`` (``csrc/clipper_train.cu`` for the training
forward, ``csrc/cheb.cu`` for the distilled root) or raises.  Each wrapper
counts its kernel launches in the plain integer ``<wrapper>.launches``.  The plain versions
run on any device and are what the kernels are held against.  Spans
(``runtime.profiler``, while a profiler records): ``wdf.call`` around each call
of ``fused_clipper_neural``, ``wdf.launch.B1`` and ``wdf.launch.B3`` around the
launches of the serving and the training forward kernels.

Constants (p1R, the diode-pair logs and reciprocals, log R; per row for
training) are computed once in double precision and rounded to f32, so
kernel and plain version see the same values.
"""

from __future__ import annotations

import math
import weakref
from typing import Optional, Tuple

import numpy as np
import torch

from ..roots.distilled import cheb_eval
from ..roots.neural import MLPParams
from ..roots.omega import wright_omega
from ..runtime.profiler import h2d, span
from . import _build

#: hidden widths the neural kernel is compiled for (the pretrained zoo's)
NEURAL_WIDTHS = (4, 8, 16)
#: the group sizes K (lanes per stream) a lane-cooperative kernel of an NxH
#: root can take, where they divide H (csrc/nxh_lanes.cuh; the generated
#: forward, ``circuit_codegen._NeuralEmitter.lane_counts``, and the clipper's
#: serving and training forward, :func:`nxh_lanes`)
LANES = (4, 8, 16)
#: the most lanes per stream a lane-cooperative kernel gives B streams: the
#: target of the first row whose bound B does not exceed.  Measured on an
#: H100 (chip_smoke.py's K sweep, T = 2,048; PERF.md): the Tube Screamer 2x16
#: and the HPF 2x16 run fastest at K = 16 at B = 1,024, K = 16 and 8 tie
#: (within 2%) at 2,048, K = 8 wins at 4,096 and 8,192 (K = 4 reads its
#: weights from shared memory, K = 16 repeats the tree and the shuffles on
#: too many lanes)
LANE_TARGETS = ((2048, 16), (None, 8))
#: the (H, L) of the NxH families the clipper's lane kernels are built for
#: (by_family of csrc/clipper_train.cu, the training forward, and of
#: csrc/fused_clipper.cu, serving): the pretrained zoo's 2x4, 4x4, 2x8, 4x8,
#: 2x16 and the 1x16.  Serving runs any other NxH root one thread a stream.
TRAIN_FAMILIES = ((4, 2), (4, 4), (8, 2), (8, 4), (16, 1), (16, 2))


def _lanes_up_to(H: int, target: int) -> int:
    return max(k for k in LANES if H % k == 0 and k <= target)


def nxh_lanes(H: int, B: int) -> int:
    """The lanes per stream of the clipper's lane kernels (the serving
    kernel B1 and the training forward B3) for B streams of an NxH root of
    width H: the largest K of LANES that divides H and is at most the
    batch's target in LANE_TARGETS (K = 16 up to B = 2,048, else 8, for
    H = 16)."""
    return _lanes_up_to(H, next(k for bound, k in LANE_TARGETS if bound is None or B <= bound))


def nxh_lane_counts(H: int) -> Tuple[int, ...]:
    """The K the clipper's lane kernels are built for at width H: those
    :func:`nxh_lanes` can pick (H = 16: 8 and 16)."""
    return tuple(sorted({_lanes_up_to(H, target) for _, target in LANE_TARGETS}))


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


def diode_pair_root(a, log_up, log_dn, inv_up, inv_dn, two_vt, n_up, n_dn, quality_iters):
    """The asymmetric diode pair's reflected wave from its precomputed
    constants (``_analytic_constants`` without p1R): the per-sample math of
    the analytic kernels.  Constants are floats or tensors that broadcast
    with a.  Autograd differentiates omega implicitly (``wright_omega``),
    as the JAX package's custom jvp does."""
    lam = torch.sign(a)
    pos = a >= 0
    mu0 = torch.where(pos, n_dn, n_up)
    mu1 = torch.where(pos, n_up, n_dn)
    log0 = torch.where(pos, log_dn, log_up)
    log1 = torch.where(pos, log_up, log_dn)
    inv0 = torch.where(pos, inv_dn, inv_up)
    inv1 = torch.where(pos, inv_up, inv_dn)
    la = lam * a
    w0 = wright_omega(log0 + la * inv0, quality_iters)
    w1 = wright_omega(log1 - la * inv1, quality_iters)
    return a - two_vt * lam * (mu0 * w0 - mu1 * w1)


def fused_clipper_analytic_plain(vin, z0, r_source, cap, Is, Vt_eff, n_up, n_down,
                                 *, fs: float, quality_iters: int = 3):
    """Plain PyTorch version of the analytic kernel: the same constants and
    per-sample math, one sample at a time over the whole batch."""
    _check_io(vin, z0)
    p1R, *consts = _analytic_constants(r_source, cap, fs, Is, Vt_eff, n_up, n_down)
    out = torch.empty_like(vin)
    z = z0
    for t in range(vin.shape[1]):
        b_temp = -p1R * (z - vin[:, t])
        a = z + b_temp
        z_new = diode_pair_root(a, *consts, quality_iters) + b_temp
        out[:, t] = 0.5 * (z_new + z)
        z = z_new
    return out, z


def launch_analytic(vin, z0, r_source, cap, Is, Vt_eff, n_up, n_down, *, fs: float,
                    quality_iters: int = 3):
    """Launch the analytic kernel on CUDA tensors (arguments and results as
    :func:`fused_clipper_analytic`, B > 0): the diode pair's two omega
    solves branch-free with their Newton steps unrolled, one on each lane of
    a pair of lanes a stream, built for quality_iters 1, 2 and 3 (a run-time
    loop for any other count).  Counts nothing."""
    consts = _analytic_constants(r_source, cap, fs, Is, Vt_eff, n_up, n_down)
    B, T = vin.shape
    lib = _build.library()
    with torch.cuda.device(vin.device):
        vin, z0, out, zf, stream = _launch_args(vin, z0)
        err = lib.fused_clipper_analytic_launch(vin.data_ptr(), z0.data_ptr(), out.data_ptr(),
                                                zf.data_ptr(), B, T, *consts,
                                                int(quality_iters), stream)
    _build.check(err, "fused_clipper_analytic_launch")
    return out, zf


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
    if vin.shape[0] == 0:
        return torch.empty_like(vin), torch.empty_like(z0)
    result = launch_analytic(vin, z0, r_source, cap, Is, Vt_eff, n_up, n_down, fs=fs,
                             quality_iters=quality_iters)
    fused_clipper_analytic.launches += 1
    return result


fused_clipper_analytic.launches = 0


# ---------------------------------------------------------------------------
# Neural-root kernel
# ---------------------------------------------------------------------------


def _nxh_layers(mlp_params: MLPParams):
    """Split an NxH MLP into (H, W1, b1, hidden, w3, b3), hidden a list of
    (kernel, bias).  Raises on an architecture the kernels do not take."""
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
    hidden = [(l["kernel"], l["bias"]) for l in layers[1:-1]]
    return H, W1, b1, hidden, layers[-1]["kernel"][:, 0], layers[-1]["bias"]


def _neural_weights(mlp_params: MLPParams, log_r: float):
    """(H, w1a, c1, hidden, w3, b3) of an NxH MLP, with the log-R column of
    the first layer folded into its bias c1."""
    H, W1, b1, hidden, w3, b3 = _nxh_layers(mlp_params)
    return H, W1[0], W1[1] * log_r + b1, hidden, w3, b3


def nxh_mlp(a, w1a, c1, hidden, w3, b3):
    """y = MLP(a) of an NxH root with log R folded into c1 (the kernels'
    ``nxh_forward``), over a batch a (B,)."""
    h = torch.tanh(a[:, None] * w1a + c1)
    for k, b in hidden:
        h = torch.tanh(h @ k + b)
    return h @ w3 + b3


def _neural_recursion(vin, z0, p1R, w1a, c1, hidden, w3, b3):
    """The clipper's sample loop with an NxH root, vectorised over B.
    p1R is a scalar or (B,), c1 (H,) or (B, H).  Returns (out, z_final,
    a_seq)."""
    out, a_seq = torch.empty_like(vin), torch.empty_like(vin)
    z = z0
    for t in range(vin.shape[1]):
        b_temp = -p1R * (z - vin[:, t])
        a = z + b_temp
        z_new = -nxh_mlp(a, w1a, c1, hidden, w3, b3) + b_temp
        out[:, t] = 0.5 * (z_new + z)
        a_seq[:, t] = a
        z = z_new
    return out, z, a_seq


def fused_clipper_neural_plain(vin, z0, mlp_params: MLPParams, r_source, cap, *, fs: float):
    """Plain PyTorch version of the neural kernel: the same folded weights
    and per-sample math, one sample at a time over the whole batch."""
    _check_io(vin, z0)
    p1R, r_up = _lpf_adaptor(r_source, cap, fs)
    _, w1a, c1, hidden, w3, b3 = _neural_weights(mlp_params, _f32(math.log(r_up)))
    out, z, _ = _neural_recursion(vin, z0, _f32(p1R), w1a, c1, hidden, w3, b3)
    return out, z


def serve_weights(mlp_params: MLPParams, r_source, cap, fs: float, device):
    """(H, L, p1R, weights) for the serving kernels: one contiguous f32
    buffer w1a[H], c1[H] (log R folded in), w3[H], b3, then per hidden layer
    W[H][H] and bias[H] (the layout of csrc/clipper_serve.cuh)."""
    p1R, r_up = _lpf_adaptor(r_source, cap, fs)
    H, w1a, c1, hidden, w3, b3 = _neural_weights(mlp_params, _f32(math.log(r_up)))
    parts = [w1a, c1, w3, b3] + [x.reshape(-1) for layer in hidden for x in layer]
    if any(p.device != device for p in parts):
        raise ValueError(f"MLP weights must lie on {device}, like vin")
    return H, len(hidden), _f32(p1R), torch.cat([p.detach() for p in parts]).contiguous()


def neural_lanes(H: int, L: int, B: int) -> int:
    """The lanes per stream of the serving kernel for B streams of an NxH
    root with L hidden layers: :func:`nxh_lanes` for the families of
    TRAIN_FAMILIES, which the lane kernel is built for, and 1 (the
    one-thread kernel) for any other."""
    return nxh_lanes(H, B) if (H, L) in TRAIN_FAMILIES else 1


def launch_neural(vin, z0, mlp_params: MLPParams, r_source, cap, *, fs: float,
                  lanes: Optional[int] = None):
    """Launch the neural kernel on CUDA tensors (arguments and results as
    :func:`fused_clipper_neural`, B > 0): ``lanes`` the lanes per stream
    (default :func:`neural_lanes`; 1 is the one-thread kernel, which takes
    any L, the lane kernel's earlier form that the card tests and
    ``chip_smoke.py`` hold it to).  Counts nothing."""
    H, L, p1R, weights = serve_weights(mlp_params, r_source, cap, fs, vin.device)
    B, T = vin.shape
    lanes = neural_lanes(H, L, B) if lanes is None else lanes
    if lanes != 1 and ((H, L) not in TRAIN_FAMILIES or lanes not in nxh_lane_counts(H)):
        raise ValueError(f"fused_clipper_neural: no lane kernel for a {L}x{H} root at "
                         f"lanes={lanes}; it is built for (H, L) in {TRAIN_FAMILIES} at "
                         f"nxh_lane_counts(H), and lanes=1 takes any root")
    lib = _build.library()
    with torch.cuda.device(vin.device):
        vin, z0, out, zf, stream = _launch_args(vin, z0)
        args = (vin.data_ptr(), z0.data_ptr(), out.data_ptr(), zf.data_ptr(), B, T,
                weights.data_ptr(), H, L, p1R)
        with span("wdf.launch.B1"):
            if lanes == 1:
                err = lib.fused_clipper_neural_onethread_launch(*args, stream)
            else:
                err = lib.fused_clipper_neural_launch(*args, lanes, stream)
    _build.check(err, "fused_clipper_neural launch")
    return out, zf


@span("wdf.call")
def fused_clipper_neural(vin, z0, mlp_params: MLPParams, r_source, cap, *, fs: float):
    """Fused LPF diode clipper with an NxH neural root (all-tanh, linear head).

    vin: (B, T) float32; z0: (B,).  Returns (out (B, T), z_final (B,)).  On
    the card each stream of a root in TRAIN_FAMILIES runs on a group of
    lanes (:func:`neural_lanes`), any other root one thread a stream; the
    launches of the latter are counted in ``one_thread_launches`` too.
    """
    if vin.device.type == "cpu":
        return fused_clipper_neural_plain(vin, z0, mlp_params, r_source, cap, fs=fs)
    _check_io(vin, z0)
    H, _, _, hidden, _, _ = _nxh_layers(mlp_params)
    if vin.shape[0] == 0:
        return torch.empty_like(vin), torch.empty_like(z0)
    lanes = neural_lanes(H, len(hidden), vin.shape[0])
    result = launch_neural(vin, z0, mlp_params, r_source, cap, fs=fs, lanes=lanes)
    fused_clipper_neural.launches += 1
    fused_clipper_neural.one_thread_launches += int(lanes == 1)
    return result


fused_clipper_neural.launches = 0
fused_clipper_neural.one_thread_launches = 0


# ---------------------------------------------------------------------------
# Training forward: per-row source R, root input written out
# ---------------------------------------------------------------------------


def row_constants(r_rows: torch.Tensor, cap, fs: float):
    """Per-row (p1R, log R_up) of the LPF clipper with source resistances
    r_rows (B,): the parallel adaptor's scatter coefficient and the log of
    its port impedance, computed in double and rounded to f32."""
    r = r_rows.double()
    g = 1.0 / r + 2.0 * float(cap) * fs
    return ((1.0 / r) / g).float(), torch.log(1.0 / g).float()


def first_bias(W1: torch.Tensor, b1: torch.Tensor, log_r: torch.Tensor) -> torch.Tensor:
    """c1[b, h] = W1[1, h] log_r[b] + b1[h]: the first layer's bias with each
    row's log R folded in, (B, H)."""
    return log_r[:, None] * W1[1] + b1


def _check_rows(r_rows: torch.Tensor, vin: torch.Tensor) -> None:
    if r_rows.shape != (vin.shape[0],):
        raise ValueError(f"r_rows must be (B,) = ({vin.shape[0]},), got {tuple(r_rows.shape)}")
    if not r_rows.is_floating_point():
        raise TypeError(f"r_rows must be floating point, got {r_rows.dtype}")
    if r_rows.device != vin.device:
        raise ValueError(f"vin on {vin.device} but r_rows on {r_rows.device}")


def train_weights(mlp_params: MLPParams, device):
    """(H, L, weights) for the training kernels: one contiguous f32 buffer
    w1a[H], w1r[H], b1[H], w3[H], b3, then per hidden layer W[H][H] and
    bias[H] (the layout of csrc/clipper_train.cuh)."""
    H, W1, b1, hidden, w3, b3 = _nxh_layers(mlp_params)
    parts = [W1[0], W1[1], b1, w3, b3] + [x.reshape(-1) for layer in hidden for x in layer]
    if any(p.device != device for p in parts):
        raise ValueError(f"MLP weights must lie on {device}, like the streams")
    return H, len(hidden), torch.cat([p.detach() for p in parts]).contiguous()


def fused_clipper_neural_train_fwd_plain(vin, z0, mlp_params: MLPParams, r_rows, cap, *,
                                         fs: float):
    """Plain PyTorch version of the training forward kernel: the same per-row
    constants and per-sample math, one sample at a time over the batch."""
    _check_io(vin, z0)
    _check_rows(r_rows, vin)
    p1r, log_r = row_constants(r_rows, cap, fs)
    _, W1, b1, hidden, w3, b3 = _nxh_layers(mlp_params)
    return _neural_recursion(vin, z0, p1r, W1[0], first_bias(W1, b1, log_r), hidden, w3, b3)


def launch_train_fwd(vin, z0, mlp_params: MLPParams, r_rows, cap, *, fs: float,
                     lanes: Optional[int] = None, writer: int = 0):
    """Launch the training forward kernel on CUDA tensors (arguments and
    results as :func:`fused_clipper_neural_train_fwd`, B > 0): ``lanes`` the
    lanes per stream (default :func:`nxh_lanes`; 1 is the one-thread
    kernel, the lane form's earlier form, which the card tests and
    ``chip_smoke.py`` hold it to), ``writer`` the lane of a group that
    writes the results (the tests run each).  Counts nothing."""
    H, L, weights = train_weights(mlp_params, vin.device)
    B, T = vin.shape
    lanes = nxh_lanes(H, B) if lanes is None else lanes
    if lanes != 1 and (H, L) not in TRAIN_FAMILIES:
        raise ValueError(f"fused_clipper_neural_train_fwd: no kernel for a {L}x{H} root; the "
                         f"kernel is built for (H, L) in {TRAIN_FAMILIES}")
    if lanes != 1 and lanes not in nxh_lane_counts(H):
        raise ValueError(f"fused_clipper_neural_train_fwd: lanes={lanes}, a root of width {H} "
                         f"takes 1 or {nxh_lane_counts(H)}")
    lib = _build.library()
    with torch.cuda.device(vin.device):
        p1r, log_r = row_constants(r_rows, cap, fs)
        vin, z0, out, zf, stream = _launch_args(vin, z0)
        a_seq = torch.empty_like(vin)
        args = (vin.data_ptr(), z0.data_ptr(), p1r.data_ptr(), log_r.data_ptr(), out.data_ptr(),
                a_seq.data_ptr(), zf.data_ptr(), B, T, weights.data_ptr(), H, L)
        with span("wdf.launch.B3"):
            if lanes == 1:
                err = lib.clipper_train_fwd_onethread_launch(*args, stream)
            else:
                err = lib.clipper_train_fwd_launch(*args, lanes, writer, stream)
    _build.check(err, "fused_clipper_neural_train_fwd launch")
    return out, zf, a_seq


def fused_clipper_neural_train_fwd(vin, z0, mlp_params: MLPParams, r_rows, cap, *, fs: float):
    """Training forward of the LPF clipper with an NxH neural root and a
    per-row source resistance.

    vin: (B, T) float32; z0: (B,); r_rows: (B,) source resistance of each
    row.  Returns (out (B, T), z_final (B,), a_seq (B, T)), a_seq[b, t] the
    root's incident wave at step t: the residual of the adjoint
    (``ops.clipper_train``).  The differentiable op is
    ``ops.clipper_train.make_fused_clipper_train``.  On the card each stream
    runs on a group of lanes (:func:`nxh_lanes`); the root's (H, L) must be
    one of TRAIN_FAMILIES.
    """
    if vin.device.type == "cpu":
        return fused_clipper_neural_train_fwd_plain(vin, z0, mlp_params, r_rows, cap, fs=fs)
    _check_io(vin, z0)
    _check_rows(r_rows, vin)
    if vin.shape[0] == 0:
        train_weights(mlp_params, vin.device)
        return torch.empty_like(vin), torch.empty_like(z0), torch.empty_like(vin)
    result = launch_train_fwd(vin, z0, mlp_params, r_rows, cap, fs=fs)
    fused_clipper_neural_train_fwd.launches += 1
    return result


fused_clipper_neural_train_fwd.launches = 0


# ---------------------------------------------------------------------------
# Distilled (piecewise-Chebyshev) root kernel
# ---------------------------------------------------------------------------

#: most segments a distilled root may have (csrc/cheb.cuh kMaxChebSegments)
MAX_CHEB_SEGMENTS = 8
#: the degrees the Chebyshev kernel is compiled for (csrc/cheb.cu's
#: dispatch); a root's coefficients are zero-padded to the next one
CHEB_DEGREES = (8, 16, 24, 32, 48, 64)


def cheb_parameters(root) -> Tuple[np.ndarray, int]:
    """(parameters, padded degree) of a PiecewiseChebRoot in the layout of
    csrc/cheb.cuh: a_max, then lo, hi + lo and hi - lo of each segment, then
    each segment's coefficients zero-padded to the first of CHEB_DEGREES at
    or above the largest degree, computed in double and rounded to f32."""
    a_max = float(root.a_max)
    edges = (0.0,) + tuple(float(b) for b in root.breaks) + (a_max,)
    coeffs = [np.asarray(c, np.float64) for c in root.coeffs]
    if not 1 <= len(coeffs) <= MAX_CHEB_SEGMENTS or len(edges) != len(coeffs) + 1:
        raise ValueError(f"distilled root needs 1..{MAX_CHEB_SEGMENTS} segments and one break "
                         f"between each two, got {len(coeffs)} segments, {len(root.breaks)} breaks")
    top = max(len(c) for c in coeffs) - 1
    degree = next((d for d in CHEB_DEGREES if d >= top), None)
    if degree is None:
        raise ValueError(f"distilled root of degree {top}: the kernels take up to "
                         f"{CHEB_DEGREES[-1]}")
    seg = [x for lo, hi in zip(edges[:-1], edges[1:]) for x in (lo, hi + lo, hi - lo)]
    padded = [np.pad(c, (0, degree + 1 - len(c))) for c in coeffs]
    params = np.concatenate([[a_max], seg] + padded).astype(np.float32)
    return params, degree


def cheb_root_ops(n_seg: int, degree: int) -> int:
    """Operations of one cheb_root call (csrc/cheb.cuh) at a padded degree:
    |a| and its clip 3, the segment compares, t with its clip 6, the Clenshaw
    steps 3 each (every lane runs the padded degree), the last step 3, the
    sign and b 5."""
    return 17 + (n_seg - 1) + 3 * degree


_cheb_on_device: "weakref.WeakKeyDictionary" = weakref.WeakKeyDictionary()


def cheb_arguments(root, device) -> Tuple[torch.Tensor, int]:
    """``cheb_parameters`` of a distilled root as an f32 tensor on
    ``device``, copied once per root and device (a distilled root is a
    fixed deployment artifact), so a served block does not wait on a copy."""
    per_root = _cheb_on_device.setdefault(root, {})
    device = torch.device(device)
    if device not in per_root:
        params, degree = cheb_parameters(root)
        per_root[device] = (h2d(torch.from_numpy(params), device, None), degree)
    return per_root[device]


def fused_clipper_cheb_plain(vin, z0, root, r_source, cap, *, fs: float):
    """Plain PyTorch version of the distilled kernel: the JAX kernel's
    evaluate-every-segment-then-select root (``roots.distilled.cheb_eval``),
    one sample at a time over the whole batch."""
    _check_io(vin, z0)
    p1R = _f32(_lpf_adaptor(r_source, cap, fs)[0])
    a_max, breaks = float(root.a_max), tuple(float(b) for b in root.breaks)
    out = torch.empty_like(vin)
    z = z0
    for t in range(vin.shape[1]):
        b_temp = -p1R * (z - vin[:, t])
        a = z + b_temp
        z_new = cheb_eval(a, a_max, breaks, root.coeffs) + b_temp
        out[:, t] = 0.5 * (z_new + z)
        z = z_new
    return out, z


def cheb_lanes(n_seg: int) -> int:
    """The lanes per stream of the distilled kernel (csrc/cheb.cu): one
    segment a lane, 4 for up to four segments, 8 for five to eight."""
    return 4 if n_seg <= 4 else 8


def launch_cheb(vin, z0, root, r_source, cap, *, fs: float):
    """Launch the distilled kernel on CUDA tensors (arguments and results as
    :func:`fused_clipper_cheb`, B > 0): a group of :func:`cheb_lanes` lanes a
    stream, one segment a lane.  Counts nothing."""
    root_params, degree = cheb_arguments(root, vin.device)
    p1R = _f32(_lpf_adaptor(r_source, cap, fs)[0])
    B, T = vin.shape
    lib = _build.library()
    with torch.cuda.device(vin.device):
        vin, z0, out, zf, stream = _launch_args(vin, z0)
        err = lib.fused_clipper_cheb_launch(
            vin.data_ptr(), z0.data_ptr(), out.data_ptr(), zf.data_ptr(), B, T,
            root_params.data_ptr(), root_params.numel(), len(root.coeffs), degree, p1R, stream)
    _build.check(err, "fused_clipper_cheb_launch")
    return out, zf


def fused_clipper_cheb(vin, z0, root, r_source, cap, *, fs: float):
    """Fused LPF diode clipper with a distilled PiecewiseChebRoot
    (``roots.distilled``): no transcendentals, each segment's Clenshaw
    recurrence on a lane of its stream's group (:func:`launch_cheb`).

    vin: (B, T) float32; z0: (B,).  Returns (out (B, T), z_final (B,)).
    The root's coefficients travel as one small argument, so another
    distilled root is another argument, not another build.
    """
    if vin.device.type == "cpu":
        return fused_clipper_cheb_plain(vin, z0, root, r_source, cap, fs=fs)
    _check_io(vin, z0)
    if vin.shape[0] == 0:
        return torch.empty_like(vin), torch.empty_like(z0)
    result = launch_cheb(vin, z0, root, r_source, cap, fs=fs)
    fused_clipper_cheb.launches += 1
    return result


fused_clipper_cheb.launches = 0
