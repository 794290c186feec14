"""Generic single-stream parallel-in-time solve: any `Circuit`, one generated
CUDA kernel, and its plain PyTorch version.

``ops.parallel_time_deer`` solves the LPF clipper's scalar recursion by DEER
(Newton over the whole trajectory); this module does the same for any
adapted WDF tree the generator takes (S reactive states, series, parallel
and R-type adaptors, analytic or NxH neural roots): the Tube Screamer (S = 3),
the HPF clipper and the clippers with neural roots, on one stream, a block of
T samples (T a multiple of 1024) with the state carried in.

The step map z_t = F(z_{t-1}, v_t) is linearised around the current guess,

    z_t = J_t z_{t-1} + c_t,   J_t = dF/dz (S x S),   c_t = F(z^_{t-1}) - J_t z^_{t-1},

and the affine recurrence is solved exactly by a blocked prefix composition
over 1024 contiguous time blocks of L = T/1024 samples.  ``relax_passes``
nonlinear block relaxations come first, every iterate is clamped to
+-100 (max|v| + 1) and then damped (z <- z_old + d (z_new - z_old); the HPF
clipper's series capacitor is a marginal mode that needs d = 0.5), with
``adapt_tol`` > 0 the sweeps stop once the largest state update falls below
it (tested after every u-th sweep, u the largest divisor of ``sweeps`` up to
4), and an emit pass gives the probe output, the final state and the
residual max|f(z_{t-1}) - z_t| over all states and samples.

``fused_deer_circuit`` / ``fused_deer_neural`` given a CPU tensor run
``fused_deer_circuit_plain``; given a CUDA tensor they launch the kernel that
``ops.circuit_codegen.generate_deer`` generates for the circuit's structure
(B9 in ROADMAP) on one cluster of ``CLUSTER`` CTAs (``csrc/deer_cluster.cuh``)
or raise with CUDA's message, and count the launch in their own
``.launches``.  The plain version is the same algorithm in torch ops on the
(L, 1024) layout, vectorised over the blocks:
the step is ``circuit_codegen.step`` with the root emitter's plain twin, and
the S x S Jacobian comes from S forward-mode passes (``torch.autograd.
forward_ad``; the diode root's omega carries its implicit ``jvp``).  The
block scan is a Hillis-Steele doubling over the 1024 totals.  The kernel's
scan composes in another order, so the two agree to rounding.

Block-rate impedance controls (the Tube Screamer's drive R6, the HPF's load
R, the clipper's source R) go in ``static_controls`` and reach the kernel as
coefficient values: a knob change is a new argument, not a new build.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.autograd.forward_ad as fwAD

from . import _build
from .circuit_codegen import DEER_BLOCKS, DEER_CLUSTER, deer_program
from .fused_circuit import Controls, Prepared, _state_dict, plain_step, prepare
from .fused_clipper import _nxh_layers

NB = DEER_BLOCKS
#: CTAs of the cluster that runs one solve: 16, a non-portable cluster size
CLUSTER = DEER_CLUSTER


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


def _state_vector(prep: Prepared, circuit, state0, vin) -> torch.Tensor:
    """The initial state as an (S,) f32 tensor on vin's device, in the
    program's state order (a tensor given stays on the device)."""
    if state0 is None:
        state0 = circuit.init_state(vin.device)
    leaves = []
    for node, field in prep.prog.state_order:
        z = torch.as_tensor(state0[node][field], dtype=torch.float32, device=vin.device)
        if z.numel() != 1:
            raise ValueError(f"state {node}.{field} must be one value, got {tuple(z.shape)}")
        leaves.append(z.reshape(()))
    return torch.stack(leaves)


def _unroll(sweeps: int) -> int:
    """The sweeps between two exit tests: the largest divisor of ``sweeps``
    up to min(sweeps, 4), as the JAX kernel's default sweep_unroll."""
    u = max(1, min(sweeps, 4))
    while sweeps % u:
        u -= 1
    return u


# ---------------------------------------------------------------------------
# The plain version
# ---------------------------------------------------------------------------


def _compose(Jb, cb, Ja, ca):
    """(Jb, cb) AFTER (Ja, ca): J = Jb Ja, c = Jb ca + cb, on lists of
    tensors, summed over k in order (the JAX kernel's mat_compose)."""
    S = len(cb)
    J = [[sum(Jb[i][k] * Ja[k][j] for k in range(S)) for j in range(S)] for i in range(S)]
    c = [sum(Jb[i][k] * ca[k] for k in range(S)) + cb[i] for i in range(S)]
    return J, c


def _plain(circuit, prep: Prepared, vin, s0, L: int, sweeps: int, relax_passes: int,
           damping: float, adapt_tol: float):
    """The DEER solve in torch ops: (out (T,), z_final (S,), residual,
    sweeps run), the last two 0-d tensors."""
    S = s0.shape[0]
    run = plain_step(circuit, prep)
    x = vin.reshape(NB, L).T  # x[r, b] = vin[b L + r]
    xf = x.reshape(-1)
    v_bound = 100.0 * (x.abs().max() + 1.0)
    one, zero = torch.ones_like(x[0]), torch.zeros_like(x[0])

    def step(z, v):
        new, y = run(z, v, 0)
        return [n.expand_as(v) for n in new], y

    def starts(z):
        """The guess at the sample before each block's first: (S, 1024)."""
        return [torch.cat([s0[k].reshape(1), z[k][-1, :-1]]) for k in range(S)]

    def prev_rows(z):
        """The guess at the sample before each (r, b), flattened."""
        st = starts(z)
        return [torch.cat([st[k][None], z[k][:-1]]).reshape(-1) for k in range(S)]

    def f_and_jac(prev, v):
        """f = F(prev, v) and J[i][k] = dF_i/dz_k by S forward-mode passes;
        the first pass's primal is f."""
        f, cols = None, []
        with fwAD.dual_level():
            for k in range(S):
                dual = [fwAD.make_dual(p, torch.ones_like(p) if i == k else torch.zeros_like(p))
                        for i, p in enumerate(prev)]
                new, _ = step(dual, v)
                unpacked = [fwAD.unpack_dual(n) for n in new]
                if f is None:
                    f = [u.primal.detach().clone() for u in unpacked]
                cols.append([torch.zeros_like(v) if u.tangent is None else u.tangent.clone()
                             for u in unpacked])
        return f, [[cols[k][i] for k in range(S)] for i in range(S)]

    z = [torch.zeros_like(x) for _ in range(S)]
    for _ in range(relax_passes):
        prev, rows = starts(z), []
        for r in range(L):
            prev, _ = step(prev, x[r])
            rows.append(prev)
        z = [torch.stack([row[k] for row in rows]) for k in range(S)]

    def sweep(z, track):
        prev = prev_rows(z)
        f, J = f_and_jac(prev, xf)
        c = [f[i] - sum(J[i][k] * prev[k] for k in range(S)) for i in range(S)]
        J = [[J[i][k].reshape(L, NB) for k in range(S)] for i in range(S)]
        c = [ci.reshape(L, NB) for ci in c]
        eye = [[one if i == k else zero for k in range(S)] for i in range(S)]
        Jr, cr, jp, cp = eye, [zero] * S, [], []
        for r in range(L):  # within-block prefixes, sequential over the rows
            Jr, cr = _compose([[J[i][k][r] for k in range(S)] for i in range(S)],
                              [ci[r] for ci in c], Jr, cr)
            jp.append(Jr)
            cp.append(cr)
        # block totals composed across the 1024 blocks (Hillis-Steele,
        # identity-padded), then shifted to the exclusive prefix
        Jb, cb, d = Jr, cr, 1
        while d < NB:
            Js = [[torch.cat([eye[i][k][:d], Jb[i][k][:-d]]) for k in range(S)] for i in range(S)]
            cs = [torch.cat([zero[:d], cb[i][:-d]]) for i in range(S)]
            Jb, cb = _compose(Jb, cb, Js, cs)
            d *= 2
        Je = [[torch.cat([eye[i][k][:1], Jb[i][k][:-1]]) for k in range(S)] for i in range(S)]
        ce = [torch.cat([zero[:1], cb[i][:-1]]) for i in range(S)]
        z_start = [sum(Je[i][k] * s0[k] for k in range(S)) + ce[i] for i in range(S)]
        new_z, dmax = [], torch.zeros((), device=x.device)
        for i in range(S):
            zn = torch.stack([sum(jp[r][i][k] * z_start[k] for k in range(S)) + cp[r][i]
                              for r in range(L)])
            zn = torch.minimum(torch.maximum(zn, -v_bound), v_bound)
            if damping != 1.0:
                zn = z[i] + damping * (zn - z[i])
            if track:
                dmax = torch.maximum(dmax, (zn - z[i]).abs().max())
            new_z.append(zn)
        return new_z, dmax

    track = adapt_tol > 0.0
    limit = float(np.float32(adapt_tol)) if track else -1.0
    u = _unroll(sweeps)
    done, delta = 0, math.inf
    while done < sweeps and delta >= limit:
        for _ in range(u):
            z, d = sweep(z, track)
        done += u
        delta = float(d)
    done = min(done, sweeps)

    prev = prev_rows(z)
    new, y = step(prev, xf)
    residual = torch.stack([(new[k] - z[k].reshape(-1)).abs().max() for k in range(S)]).max()
    out = y.reshape(L, NB).T.reshape(-1)
    zf = torch.stack([z[k][-1, -1] for k in range(S)])
    return out, zf, residual, torch.tensor(float(done), device=vin.device)


# ---------------------------------------------------------------------------
# The kernel
# ---------------------------------------------------------------------------


def launcher(circuit, prep: Prepared, vin, s0, L: int, sweeps: int, relax_passes: int,
             damping: float, adapt_tol: float, entry):
    """The generated DEER kernel's launch on (L, 1024) arguments prepared
    once (``prepare``, the initial state (S,) from ``_state_vector``) and
    outputs allocated once: a callable that launches the kernel on the
    current stream, counts it in ``entry.launches`` (the public entry that
    was called) and returns as :func:`_plain`, the last two read from the
    card's info pair without a host copy.  Each call overwrites the previous
    one's outputs (chip_smoke.py times the kernel through it)."""
    deer = deer_program(circuit, prep.prog)
    lib = _build.generated_library(deer.source)
    T = vin.shape[0]
    with torch.cuda.device(vin.device):
        vin = vin.contiguous()
        s0 = s0.contiguous()
        out = torch.empty_like(vin)
        zf = torch.empty_like(s0)
        info = torch.empty(2, dtype=torch.float32, device=vin.device)
        scratch = torch.empty(deer.scratch_floats(T), dtype=torch.float32, device=vin.device)
        warr = prep.warr if prep.warr is not None else prep.vec
        args = (vin.data_ptr(), s0.data_ptr(), out.data_ptr(), zf.data_ptr(), info.data_ptr(),
                scratch.data_ptr(), L, prep.vec.data_ptr(), warr.data_ptr(),
                0 if prep.warr is None else prep.warr.numel(), int(sweeps), int(relax_passes),
                _unroll(int(sweeps)), float(damping), float(adapt_tol), int(adapt_tol > 0.0),
                torch.cuda.current_stream(vin.device).cuda_stream)

    def launch():
        err = lib.circuit_deer_launch(*args)
        _build.check(err, "fused_deer_circuit launch", lib.circuit_error_string)
        entry.launches += 1
        return out, zf, info[0], info[1]

    launch.buffers = (vin, s0, prep, scratch)  # the pointers in args stay valid
    return launch


def _launch(*args):
    """One launch on fresh outputs (see :func:`launcher`)."""
    return launcher(*args)()


def max_active_clusters(circuit, prep: Prepared) -> int:
    """cudaOccupancyMaxActiveClusters of the circuit's kernel: how many
    clusters of ``CLUSTER`` CTAs the card can hold at once."""
    lib = _build.generated_library(deer_program(circuit, prep.prog).source)
    n = lib.circuit_deer_max_clusters(0 if prep.warr is None else prep.warr.numel())
    _build.check(max(0, -n), f"cudaOccupancyMaxActiveClusters at {CLUSTER} CTAs",
                 lib.circuit_error_string)
    return n


def _solve(circuit, params, vin, neural_mlp, *, input_node, static_controls, state0, sweeps,
           relax_passes, damping, adapt_tol, return_info, plain):
    L = _check_vin(vin)
    if sweeps < 0 or relax_passes < 0:
        raise ValueError(f"sweeps and relax_passes must be >= 0, got {sweeps}, {relax_passes}")
    prep = prepare(circuit, params, vin.device, input_node=input_node,
                   static_controls=static_controls, neural_mlp=neural_mlp)
    deer_program(circuit, prep.prog)  # the structure checks, on every device
    s0 = _state_vector(prep, circuit, state0, vin)
    args = (circuit, prep, vin, s0, L, int(sweeps), int(relax_passes), float(damping),
            float(adapt_tol))
    if plain or vin.device.type == "cpu":
        out, zf, res, n = _plain(*args)
    else:
        out, zf, res, n = _launch(*args, fused_deer_circuit if neural_mlp is None
                                  else fused_deer_neural)
    state = _state_dict(prep.prog, list(zf))
    return (out, state, res, n) if return_info else (out, state, res)


def fused_deer_circuit_plain(circuit, params, vin, *, input_node: str = "Vin",
                             static_controls: Controls = None, state0=None, sweeps: int = 8,
                             relax_passes: int = 2, damping: float = 1.0,
                             adapt_tol: float = 0.0, return_info: bool = False):
    """Plain PyTorch version of :func:`fused_deer_circuit`, on any device."""
    return _solve(circuit, params, vin, None, input_node=input_node,
                  static_controls=static_controls, state0=state0, sweeps=sweeps,
                  relax_passes=relax_passes, damping=damping, adapt_tol=adapt_tol,
                  return_info=return_info, plain=True)


def fused_deer_circuit(circuit, params, vin, *, input_node: str = "Vin",
                       static_controls: Controls = None, state0=None, sweeps: int = 8,
                       relax_passes: int = 2, damping: float = 1.0, adapt_tol: float = 0.0,
                       return_info: bool = False):
    """Solve ``circuit``'s sample recursion on one stream, parallel in time,
    in one kernel launch.

    vin: (T,) float32, T a multiple of 1024 (ValueError otherwise).
    state0: the circuit's state dict of one value per leaf (default: its
    initial state).  Returns (out (T,), final state dict, residual), and
    with ``return_info`` also the sweeps run (a multiple of the exit-test
    granularity when adaptive); the residual, the sweeps run and the state
    leaves are 0-d tensors on vin's device.  ``damping`` is the Newton step
    fraction (1.0 for contractive circuits, 0.5 with more sweeps for the HPF
    clipper's marginal mode); ``adapt_tol`` > 0 makes ``sweeps`` a cap.
    Matches ``circuit.process`` with hoisted adaptation to the solver's
    tolerance; the residual certifies it per block.
    """
    return _solve(circuit, params, vin, None, input_node=input_node,
                  static_controls=static_controls, state0=state0, sweeps=sweeps,
                  relax_passes=relax_passes, damping=damping, adapt_tol=adapt_tol,
                  return_info=return_info, plain=False)


fused_deer_circuit.launches = 0


def _neural_mlp(circuit, params):
    acts = tuple(getattr(circuit.root, "activations", ()))
    if acts and (set(acts[:-1]) != {"tanh"} or acts[-1] not in ("", "linear")):
        raise ValueError(
            "fused_deer_neural supports all-tanh hidden layers with a linear head only; "
            f"circuit root has activations {acts}: serve this model through the scan engine")
    mlp = params[circuit.root.name]
    _nxh_layers(mlp)  # ValueError without a hidden H->H layer or at another width
    return mlp


def fused_deer_neural_plain(circuit, params, vin, *, input_node: str = "Vs",
                            static_controls: Controls = None, state0=None, sweeps: int = 8,
                            relax_passes: int = 2, damping: float = 1.0,
                            adapt_tol: float = 0.0, return_info: bool = False):
    """Plain PyTorch version of :func:`fused_deer_neural`, on any device."""
    return _solve(circuit, params, vin, _neural_mlp(circuit, params), input_node=input_node,
                  static_controls=static_controls, state0=state0, sweeps=sweeps,
                  relax_passes=relax_passes, damping=damping, adapt_tol=adapt_tol,
                  return_info=return_info, plain=True)


def fused_deer_neural(circuit, params, vin, *, input_node: str = "Vs",
                      static_controls: Controls = None, state0=None, sweeps: int = 8,
                      relax_passes: int = 2, damping: float = 1.0, adapt_tol: float = 0.0,
                      return_info: bool = False):
    """:func:`fused_deer_circuit` for a circuit with an NxH neural diode root,
    b = -MLP([a, log R]) (all-tanh hidden layers, a linear head, at least one
    hidden H->H layer, H in 4, 8, 16; anything else raises ``ValueError``).
    The MLP runs in exact f32 from shared memory, log R folded into the first
    bias, and its slope by the closed-form tangent (``nxh_mlp.cuh``)."""
    return _solve(circuit, params, vin, _neural_mlp(circuit, params), input_node=input_node,
                  static_controls=static_controls, state0=state0, sweeps=sweeps,
                  relax_passes=relax_passes, damping=damping, adapt_tol=adapt_tol,
                  return_info=return_info, plain=False)


fused_deer_neural.launches = 0
