"""Single-stream parallel-in-time clipper solve: the CUDA kernel and its plain version.

One mono stream of the LPF diode clipper, a block of T samples with the
capacitor state z carried in, is solved as DEER (Newton over the whole
trajectory) instead of sample by sample.  The step map
z_t = f(z_{t-1}, v_t) is linearised around the current guess,

    z_t = J_t z_{t-1} + c_t,   J_t = df/dz,   c_t = f(z^_{t-1}) - J_t z^_{t-1},

with the analytic Jacobian, which shares the two omega solves with f:

    f(z, v) = b_root(a) + b_temp,  a = z + b_temp,  b_temp = -p1R (z - v)
    df/dz   = (1 - p1R) b_root'(a) - p1R
    b_root'(a) = 1 - 2 Vt (mu0 inv0 w0/(1+w0) + mu1 inv1 w1/(1+w1))

and the affine recurrence is solved exactly by a blocked prefix composition:
time is cut into 1024 contiguous blocks of L = T/1024 samples, each block
composes its own prefixes over its L rows, and the 1024 block totals are
composed by a scan.  ``relax_passes`` nonlinear block relaxations come first
(a warm start into Newton's basin under hard overdrive), every iterate is
clamped to +-(max|v| + 1), and a last pass emits the output, the state after
the block and the residual max|f(z_{t-1}) - z_t|: a convergence certificate
that the streaming processor uses to fall back to the exact recursion.

``fused_deer_clipper`` given a CPU tensor runs ``fused_deer_clipper_plain``;
given a CUDA tensor it launches ``deer_clipper_cluster_kernel`` from
``csrc/parallel_time_deer.cu`` on one cluster of ``CLUSTER`` CTAs
(``csrc/deer_cluster.cuh``) or raises with CUDA's message, and counts the
launch in ``fused_deer_clipper.launches``.  The plain version is the same DEER algorithm in torch ops on the (L, 1024)
layout, vectorised over the blocks:
it is what the kernel is held against.  At 8 sweeps DEER agrees with the
sequential recursion (``ops.fused_clipper.fused_clipper_analytic``) only to
~1e-6, so both are also held against that recursion.

The constants are those of the analytic clipper kernel, computed in double
and rounded to f32 once.
"""

from __future__ import annotations

import torch

from . import _build
from .fused_clipper import _analytic_constants
from ..roots.omega import wright_omega_u

#: time blocks per solve (the JAX kernel's partition)
NB = 1024
#: CTAs of the cluster that runs one solve (csrc/parallel_time_deer.cu
#: kCluster): 16, a non-portable cluster size
CLUSTER = 16


def scratch_floats(T: int) -> int:
    """Global scratch of one solve: the input, two trajectory buffers and
    the rows (J_t, c_t)."""
    return 5 * T


def _check_vin(vin: torch.Tensor) -> int:
    """L = T / 1024 of a valid input block; raises on anything else."""
    if vin.dim() != 1:
        raise ValueError(f"vin must be (T,), got shape {tuple(vin.shape)}")
    if vin.dtype != torch.float32:
        raise TypeError(f"vin must be float32, got {vin.dtype}")
    T = vin.shape[0]
    if T == 0 or T % NB:
        raise ValueError(f"T={T} must be a positive multiple of {NB}")
    if vin.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {vin.device}")
    return T // NB


def _state_in(z0, vin: torch.Tensor) -> torch.Tensor:
    """The initial state as a 0-d f32 tensor on vin's device (a tensor given
    stays on the device: no host round trip)."""
    if isinstance(z0, torch.Tensor):
        if z0.numel() != 1 or z0.device != vin.device:
            raise ValueError(f"z0 must be one value on {vin.device}, got {tuple(z0.shape)} "
                             f"on {z0.device}")
        return z0.reshape(()).to(torch.float32)
    return torch.full((), float(z0), dtype=torch.float32, device=vin.device)


def fused_deer_clipper_plain(vin, r_source, cap, Is, Vt_eff, n_up, n_down, *, fs: float,
                             z0=0.0, sweeps: int = 8, relax_passes: int = 2,
                             quality_iters: int = 3):
    """Plain PyTorch version of the DEER kernel: the same constants,
    relaxations, sweeps, block scan, clamp and emit pass, vectorised over
    the 1024 blocks of the (L, 1024) layout."""
    L = _check_vin(vin)
    p1R, log_up, log_dn, inv_up, inv_dn, two_vt, n_up, n_dn = _analytic_constants(
        r_source, cap, fs, Is, Vt_eff, n_up, n_down)
    s0 = _state_in(z0, vin)
    x = vin.reshape(NB, L).T  # x[r, b] = vin[b L + r]
    z_bound = x.abs().max() + 1.0

    def f_and_j(z, v):
        b_temp = -p1R * (z - v)
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
        f = a - two_vt * lam * (mu0 * w0 - mu1 * w1) + b_temp
        droot = 1.0 - two_vt * (mu0 * inv0 * w0 / (1.0 + w0) + mu1 * inv1 * w1 / (1.0 + w1))
        return f, (1.0 - p1R) * droot - p1R

    def prev_rows(z):
        """The guess at the sample before each (r, b): z[r-1, b], and for
        r = 0 the previous block's last (the initial state for block 0)."""
        first = torch.cat([s0.reshape(1), z[-1, :-1]])
        return torch.cat([first[None], z[:-1]])

    def compose(Ja, ca, Jb, cb):
        """(Jb, cb) AFTER (Ja, ca): z -> Jb (Ja z + ca) + cb."""
        return Jb * Ja, Jb * ca + cb

    z = torch.zeros_like(x)
    for _ in range(relax_passes):
        prev, rows = prev_rows(z)[0], []
        for r in range(L):
            prev = f_and_j(prev, x[r])[0]
            rows.append(prev)
        z = torch.stack(rows)

    one, zero = torch.ones_like(x[0]), torch.zeros_like(x[0])
    for _ in range(sweeps):
        prev = prev_rows(z)
        f, j = f_and_j(prev, x)
        c = f - j * prev
        # within-block affine prefixes, sequential over the L rows
        Jr, cr, jp, cp = one, zero, [], []
        for r in range(L):
            Jr, cr = compose(Jr, cr, j[r], c[r])
            jp.append(Jr)
            cp.append(cr)
        # block totals composed across the 1024 blocks (Hillis-Steele,
        # identity-padded), then shifted to the exclusive prefix
        Jb, cb, d = Jr, cr, 1
        while d < NB:
            Js = torch.cat([one[:d], Jb[:-d]])
            cs = torch.cat([zero[:d], cb[:-d]])
            Jb, cb = compose(Js, cs, Jb, cb)
            d *= 2
        Je = torch.cat([one[:1], Jb[:-1]])
        ce = torch.cat([zero[:1], cb[:-1]])
        z_start = Je * s0 + ce
        z_new = torch.stack(jp) * z_start + torch.stack(cp)
        z = torch.minimum(torch.maximum(z_new, -z_bound), z_bound)

    prev = prev_rows(z)
    residual = (f_and_j(prev, x)[0] - z).abs().max()
    out = (0.5 * (z + prev)).T.reshape(-1)
    return out, z[-1, -1].clone(), residual


def fused_deer_clipper(vin, r_source, cap, Is, Vt_eff, n_up, n_down, *, fs: float, z0=0.0,
                       sweeps: int = 8, relax_passes: int = 2, quality_iters: int = 3):
    """Single-stream LPF diode clipper solved parallel-in-time in one launch.

    vin: (T,) float32 with T a multiple of 1024 (ValueError otherwise); z0 the
    capacitor state before the block, a float or a one-element tensor on
    vin's device.  Returns (out (T,), z_final, residual), the last two 0-d
    tensors on vin's device; residual is max|f(z_{t-1}) - z_t| of the
    converged trajectory.  Matches the sequential recursion to ~1e-6 at
    sweeps=8 for audio-range drive; at pathological operating points (source
    R at the 180-Ohm element bound, every sample clipping hard) the solve
    does not converge and the residual says so.
    """
    if vin.device.type == "cpu":
        return fused_deer_clipper_plain(vin, r_source, cap, Is, Vt_eff, n_up, n_down, fs=fs,
                                        z0=z0, sweeps=sweeps, relax_passes=relax_passes,
                                        quality_iters=quality_iters)
    L = _check_vin(vin)
    consts = _analytic_constants(r_source, cap, fs, Is, Vt_eff, n_up, n_down)
    with torch.cuda.device(vin.device):
        vin = vin.contiguous()
        s0 = _state_in(z0, vin).contiguous()
        out = torch.empty_like(vin)
        zf = torch.empty((), dtype=torch.float32, device=vin.device)
        res = torch.empty((), dtype=torch.float32, device=vin.device)
        launch(vin, s0, out, zf, res, L, consts, int(sweeps), int(relax_passes),
               int(quality_iters))
    fused_deer_clipper.launches += 1
    return out, zf, res


fused_deer_clipper.launches = 0


def launch(vin, s0, out, zf, res, L: int, consts, sweeps: int, relax_passes: int,
           iters: int) -> None:
    """One solve on the current stream into out, zf and res.  Allocates the
    scratch; raises with CUDA's message if the launch is refused (nothing
    falls back)."""
    lib = _build.library()
    scratch = torch.empty(scratch_floats(vin.shape[0]), dtype=torch.float32, device=vin.device)
    err = lib.deer_clipper_launch(vin.data_ptr(), s0.data_ptr(), out.data_ptr(), zf.data_ptr(),
                                  res.data_ptr(), scratch.data_ptr(), L, *consts, sweeps,
                                  relax_passes, iters,
                                  torch.cuda.current_stream(vin.device).cuda_stream)
    _build.check(err, "fused_deer_clipper launch")


def max_active_clusters() -> int:
    """cudaOccupancyMaxActiveClusters of the kernel: how many clusters of
    ``CLUSTER`` CTAs the card can hold at once."""
    n = _build.library().deer_clipper_max_clusters()
    _build.check(max(0, -n), f"cudaOccupancyMaxActiveClusters at {CLUSTER} CTAs")
    return n
