"""Differentiable fused clipper: the training forward kernel and its adjoint.

Forward recursion (per step and row; s = capacitor state, p = p1R of the
row's source resistance):

    b_temp_t = -p (s_t - v_t)
    a_t      = s_t + b_temp_t
    y_t      = MLP([a_t, log R])
    s_{t+1}  = -y_t + b_temp_t
    o_t      = (s_{t+1} + s_t) / 2

Reverse mode: with m_t = dMLP/da at a_t, the state cotangent
``lam_t = dL/ds_t`` satisfies the first-order linear recurrence

    lam_t = c_t lam_{t+1} + 0.5 (1 + c_t) go_t,
    c_t   = -(m_t (1 - p) + p),

from lam_T = dL/ds_T.  m_t depends on a_t alone, so on the card
``clipper_adjoint`` computes every m_t at once (pass 1) and then walks the
scalar recursion backwards in time (pass 2); it returns the input
cotangent ``g_vin = p (1 - m) G``, the stream
``G_t = lam_{t+1} + 0.5 go_t`` (the total cotangent of s_{t+1}) and
``g_z0 = lam_0``; the only residual the forward stores is a_t.  The MLP
parameters' cotangent is one batched VJP with dL/dy = -G over every (b, t)
(``mlp_param_vjp``): on the card the adjoint's third pass, one kernel after
pass 2 (G comes from pass 2's recursion) whose blocks each sum a share of
the samples' outer products and a second launch that adds the blocks'
partials in order; the JAX package leaves this VJP to XLA.

``make_fused_clipper_train`` wraps the kernels in a
``torch.autograd.Function``.  r_rows (measured pot data) and cap get no
cotangent BY DESIGN: this engine serves the measured-data regime where R is
data and C is frozen (the reference freezes both, ``clipper_pot.py``).

A wrapper given CPU tensors runs its plain version; given CUDA tensors it
launches its kernel from ``csrc/clipper_train.cu`` or raises.  Each wrapper
counts its launches in ``<wrapper>.launches``.  Spans (``runtime.profiler``,
while a profiler records): ``wdf.bptt`` around the op's backward, with
``wdf.launch.B4.pass1`` and ``wdf.launch.B4.pass2`` (the adjoint's two
launches) and ``wdf.param_pass`` (``mlp_param_vjp``, with
``wdf.launch.B4.pass3`` around its launch) inside.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Sequence

import torch
from torch.autograd.function import once_differentiable

from ..roots.neural import MLPParams, mlp_apply
from ..runtime.profiler import span
from . import _build
from .fused_clipper import (
    _nxh_layers,
    first_bias,
    fused_clipper_neural_train_fwd,
    row_constants,
    train_weights,
)


def _check_adjoint_io(a_seq, g_out, g_zf, r_rows) -> None:
    if a_seq.dim() != 2 or g_out.shape != a_seq.shape:
        raise ValueError(f"a_seq and g_out must be one (B, T) shape, got "
                         f"{tuple(a_seq.shape)} and {tuple(g_out.shape)}")
    B = a_seq.shape[0]
    if g_zf.shape != (B,) or r_rows.shape != (B,):
        raise ValueError(f"g_zf and r_rows must be (B,) = ({B},), got "
                         f"{tuple(g_zf.shape)} and {tuple(r_rows.shape)}")
    if any(x.dtype != torch.float32 for x in (a_seq, g_out, g_zf)):
        raise TypeError("a_seq, g_out and g_zf must be float32")
    if any(x.device != a_seq.device for x in (g_out, g_zf, r_rows)):
        raise ValueError(f"all streams must lie on {a_seq.device}, like a_seq")
    if a_seq.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {a_seq.device}")


def _mlp_tangent(a, w1a, c1, hidden, w3):
    """m = dMLP/da at every element of a: the forward with its tangent in
    closed form, dh = (1 - h^2) w1a, dg = (1 - g^2) (W^T dh), m = w3 . dh."""
    h = torch.tanh(a[..., None] * w1a + c1)
    dh = (1.0 - h * h) * w1a
    for k, b in hidden:
        h = torch.tanh(h @ k + b)
        dh = (1.0 - h * h) * (dh @ k)
    return dh @ w3


def clipper_adjoint_plain(a_seq, g_out, g_zf, r_rows, mlp_params: MLPParams, cap, *,
                          fs: float):
    """Plain PyTorch version of the adjoint kernel: m_t for every (b, t) at
    once, then the lam recurrence one step at a time backwards over the
    batch.  Returns (g_vin (B, T), G (B, T), g_z0 (B,))."""
    _check_adjoint_io(a_seq, g_out, g_zf, r_rows)
    p1r, log_r = row_constants(r_rows, cap, fs)
    _, W1, b1, hidden, w3, _ = _nxh_layers(mlp_params)
    m = _mlp_tangent(a_seq, W1[0], first_bias(W1, b1, log_r)[:, None, :], hidden, w3)
    p = p1r[:, None]
    c = -(m * (1.0 - p) + p)
    G = torch.empty_like(a_seq)
    lam = g_zf
    for t in reversed(range(a_seq.shape[1])):
        go = g_out[:, t]
        G[:, t] = lam + 0.5 * go
        lam = c[:, t] * lam + 0.5 * (1.0 + c[:, t]) * go
    return p * (1.0 - m) * G, G, lam


#: streams a block of the adjoint's pass 2 walks (csrc/clipper_train.cuh
#: kAdjointGroup); the scratch holds whole groups
ADJOINT_GROUP = 8


def adjoint_scratch_floats(B: int, T: int) -> int:
    """Floats of the adjoint's scratch at (B, T): the pair (m, go) of every
    sample of ceil(B / ADJOINT_GROUP) whole groups of streams."""
    return 2 * -(-B // ADJOINT_GROUP) * ADJOINT_GROUP * T


def launch_adjoint(a_seq, g_out, g_zf, r_rows, mlp_params: MLPParams, cap, *, fs: float):
    """The adjoint kernel on CUDA tensors (arguments and results as
    :func:`clipper_adjoint`, B > 0): pass 1 (``clipper_tangent_launch``, the
    tangent m of every (b, t) sample in parallel) writes (m, go) pairs into a
    scratch of :func:`adjoint_scratch_floats` that this function allocates,
    pass 2 (``clipper_recursion_launch``, one warp per group of
    ADJOINT_GROUP streams) walks it back in time.  Counts nothing."""
    H, L, weights = train_weights(mlp_params, a_seq.device)
    B, T = a_seq.shape
    lib = _build.library()
    with torch.cuda.device(a_seq.device):
        p1r, log_r = row_constants(r_rows, cap, fs)
        a_seq, g_out, g_zf = a_seq.contiguous(), g_out.contiguous(), g_zf.contiguous()
        g_vin, G, g_z0 = torch.empty_like(a_seq), torch.empty_like(a_seq), torch.empty_like(g_zf)
        scratch = torch.empty(adjoint_scratch_floats(B, T), device=a_seq.device)
        stream = torch.cuda.current_stream(a_seq.device).cuda_stream
        with span("wdf.launch.B4.pass1"):
            err = lib.clipper_tangent_launch(a_seq.data_ptr(), g_out.data_ptr(),
                                             log_r.data_ptr(), scratch.data_ptr(), B, T,
                                             weights.data_ptr(), H, L, stream)
        _build.check(err, "clipper_adjoint launch (pass 1)")
        with span("wdf.launch.B4.pass2"):
            err = lib.clipper_recursion_launch(scratch.data_ptr(), g_zf.data_ptr(),
                                               p1r.data_ptr(), g_vin.data_ptr(), G.data_ptr(),
                                               g_z0.data_ptr(), B, T, stream)
    _build.check(err, "clipper_adjoint launch (pass 2)")
    return g_vin, G, g_z0


def clipper_adjoint(a_seq, g_out, g_zf, r_rows, mlp_params: MLPParams, cap, *, fs: float):
    """Reverse-time adjoint of ``fused_clipper_neural_train_fwd``.

    a_seq: (B, T) root inputs the forward wrote; g_out: (B, T) cotangent of
    out; g_zf: (B,) cotangent of z_final; r_rows: (B,) source resistances.
    Returns (g_vin (B, T), G (B, T), g_z0 (B,)).  On the card one call is
    the two kernels of :func:`launch_adjoint`, counted once.
    """
    if a_seq.device.type == "cpu":
        return clipper_adjoint_plain(a_seq, g_out, g_zf, r_rows, mlp_params, cap, fs=fs)
    _check_adjoint_io(a_seq, g_out, g_zf, r_rows)
    if a_seq.shape[0] == 0:
        train_weights(mlp_params, a_seq.device)
        return torch.empty_like(a_seq), torch.empty_like(a_seq), torch.empty_like(g_zf)
    result = launch_adjoint(a_seq, g_out, g_zf, r_rows, mlp_params, cap, fs=fs)
    clipper_adjoint.launches += 1
    return result


clipper_adjoint.launches = 0


def mlp_leaves(mlp_params: MLPParams):
    """The MLP's tensors as a flat list: kernel0, bias0, kernel1, bias1, ..."""
    return [x for layer in mlp_params["layers"] for x in (layer["kernel"], layer["bias"])]


def mlp_tree(leaves) -> MLPParams:
    """Inverse of ``mlp_leaves``."""
    return {"layers": [{"kernel": k, "bias": b} for k, b in zip(leaves[::2], leaves[1::2])]}


def mlp_param_vjp_plain(mlp_params: MLPParams, activations: Sequence[str], a_seq, log_r, G):
    """Plain PyTorch version of :func:`mlp_param_vjp`: autograd of the MLP
    over every (b, t) at once."""
    with torch.enable_grad():
        leaves = [x.detach().requires_grad_(True) for x in mlp_leaves(mlp_params)]
        x = torch.stack([a_seq, log_r[:, None].expand_as(a_seq)], dim=-1)
        y = mlp_apply(mlp_tree(leaves), activations, x)[..., 0]
        return list(torch.autograd.grad(y, leaves, grad_outputs=-G))


@functools.lru_cache(maxsize=None)
def _param_ctas(device_index: int, H: int, L: int) -> int:
    """The blocks pass 3 runs at most for (H, L) on a card: as many as it
    holds resident at once (``clipper_param_ctas``)."""
    ctas = ctypes.c_int(0)
    with torch.cuda.device(device_index):
        err = _build.library().clipper_param_ctas(H, L, ctypes.byref(ctas))
    _build.check(err, "mlp_param_vjp (pass 3's blocks)")
    return ctas.value


def launch_param_vjp(mlp_params: MLPParams, a_seq, log_r, G, launch_span: str):
    """B4's pass 3 on CUDA tensors (arguments and result as
    :func:`mlp_param_vjp`, B, T > 0): ``clipper_param_launch``, the
    kernel's blocks each writing one partial of the cotangents into a scratch
    this function allocates, then their sum in block order, inside a span
    named ``launch_span`` (``wdf.launch.B4.pass3`` for the clipper,
    ``wdf.launch.B8.pass3`` for the generic engine's root).  Counts
    nothing."""
    H, L, weights = train_weights(mlp_params, a_seq.device)
    B, T = a_seq.shape
    lib = _build.library()
    with torch.cuda.device(a_seq.device):
        ctas = _param_ctas(a_seq.device.index, H, L)
        leaves = mlp_leaves(mlp_params)
        a_seq, G, log_r = a_seq.contiguous(), G.contiguous(), log_r.contiguous()
        out = torch.empty(sum(x.numel() for x in leaves), device=a_seq.device)
        partials = torch.empty(ctas * out.numel(), device=a_seq.device)
        with span(launch_span):
            err = lib.clipper_param_launch(a_seq.data_ptr(), G.data_ptr(), log_r.data_ptr(),
                                           partials.data_ptr(), ctas, out.data_ptr(), B, T,
                                           weights.data_ptr(), H, L,
                                           torch.cuda.current_stream(a_seq.device).cuda_stream)
    _build.check(err, "mlp_param_vjp launch (pass 3)")
    return [g.view_as(x) for g, x in zip(out.split([x.numel() for x in leaves]), leaves)]


def _check_nxh(activations, what: str) -> None:
    """Raise unless ``activations`` are the NxH family's (all-tanh hidden
    layers, linear head): the kernels hard-code tanh."""
    acts = tuple(activations)
    if not (all(a == "tanh" for a in acts[:-1]) and acts[-1] in ("", "linear")):
        raise ValueError(f"{what} supports the all-tanh NxH family, got {acts}")


def _check_param_io(activations, a_seq, log_r, G) -> None:
    _check_nxh(activations, "mlp_param_vjp's kernel")
    if a_seq.dim() != 2 or G.shape != a_seq.shape or log_r.shape != a_seq.shape[:1]:
        raise ValueError(f"a_seq and G must be one (B, T) shape and log_r (B,), got "
                         f"{tuple(a_seq.shape)}, {tuple(G.shape)} and {tuple(log_r.shape)}")
    if any(x.dtype != torch.float32 for x in (a_seq, log_r, G)):
        raise TypeError("a_seq, log_r and G must be float32")
    if any(x.device != a_seq.device for x in (log_r, G)):
        raise ValueError(f"all streams must lie on {a_seq.device}, like a_seq")


@span("wdf.param_pass")
def mlp_param_vjp(mlp_params: MLPParams, activations: Sequence[str], a_seq, log_r, G):
    """Cotangents of the MLP parameters: the VJP of y = MLP([a_seq, log_r])
    over every (b, t) with dL/dy = -G.  Returns a list in the order kernel0,
    bias0, kernel1, bias1, ...  On the card one call is the adjoint's third
    pass (:func:`launch_param_vjp`), counted once; it takes the all-tanh NxH
    roots of the widths B4's pass 1 takes and raises on any other."""
    if a_seq.device.type == "cpu":
        return mlp_param_vjp_plain(mlp_params, activations, a_seq, log_r, G)
    if a_seq.device.type != "cuda":
        raise ValueError(f"unsupported device {a_seq.device}")
    return param_vjp_on_card(mlp_param_vjp, "wdf.launch.B4.pass3", mlp_params, activations, a_seq,
                             log_r, G)


mlp_param_vjp.launches = 0


def param_vjp_on_card(counter, launch_span: str, mlp_params: MLPParams,
                      activations: Sequence[str], a_seq, log_r, G):
    """:func:`mlp_param_vjp` on the card, for each engine that runs pass 3:
    checks the arguments, launches (:func:`launch_param_vjp`, in a span
    named ``launch_span``) and counts one call in ``counter.launches``."""
    _check_param_io(activations, a_seq, log_r, G)
    if a_seq.numel() == 0:
        train_weights(mlp_params, a_seq.device)
        return [torch.zeros_like(x) for x in mlp_leaves(mlp_params)]
    result = launch_param_vjp(mlp_params, a_seq, log_r, G, launch_span)
    counter.launches += 1
    return result


class _FusedClipperTrain(torch.autograd.Function):
    """(vin, z0, r_rows, cap, fs, activations, *mlp leaves) -> (out, z_final):
    forward kernel B3, backward kernel B4 plus the parameter VJP."""

    @staticmethod
    def forward(ctx, vin, z0, r_rows, cap, fs, activations, *leaves):
        out, zf, a_seq = fused_clipper_neural_train_fwd(vin, z0, mlp_tree(leaves), r_rows, cap,
                                                        fs=fs)
        ctx.save_for_backward(a_seq, r_rows, *leaves)
        ctx.cap, ctx.fs, ctx.activations = cap, fs, activations
        ctx.set_materialize_grads(False)
        return out, zf

    @staticmethod
    @once_differentiable
    @span("wdf.bptt")
    def backward(ctx, g_out, g_zf):
        a_seq, r_rows, *leaves = ctx.saved_tensors
        if g_out is None:
            g_out = torch.zeros_like(a_seq)
        if g_zf is None:
            g_zf = a_seq.new_zeros(a_seq.shape[0])
        mlp = mlp_tree(leaves)
        g_vin, G, g_z0 = clipper_adjoint(a_seq, g_out, g_zf, r_rows, mlp, ctx.cap, fs=ctx.fs)
        g_leaves = [None] * len(leaves)
        if any(ctx.needs_input_grad[6:]):
            _, log_r = row_constants(r_rows, ctx.cap, ctx.fs)
            g_leaves = mlp_param_vjp(mlp, ctx.activations, a_seq, log_r, G)
        return (g_vin, g_z0, None, None, None, None, *g_leaves)


def make_fused_clipper_train(activations: Sequence[str], cap: float, fs: float):
    """Build the differentiable fused clipper op for one (cap, fs) config.

    Returns ``f(vin, z0, mlp_params, r_rows) -> (out, z_final)`` whose
    forward is ``fused_clipper_neural_train_fwd`` and whose backward is
    ``clipper_adjoint`` followed by ``mlp_param_vjp``.  Gradients reach vin,
    z0 and the MLP parameters; r_rows gets none.  ``activations`` must be the
    reference NxH family (all-tanh hidden, linear head): the kernels
    hard-code tanh.  The op is once-differentiable.
    """
    activations = tuple(activations)
    _check_nxh(activations, "fused kernel")
    cap, fs = float(cap), float(fs)

    def f(vin, z0, mlp_params: MLPParams, r_rows):
        return _FusedClipperTrain.apply(vin, z0, r_rows, cap, fs, activations,
                                        *mlp_leaves(mlp_params))

    return f
