#!/usr/bin/env python3
"""GPU smoke run of diffwdf_tpu_torch's main path: batched diode-clipper serving.

Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py [--seed N]

It builds the CUDA kernels from ``diffwdf_tpu_torch/ops/csrc`` and prints
one line per phase:

  toolchain  the card (name, power limit), torch, CUDA and nvcc versions
  build      nvcc compile of the kernel library, timed as set-up
  kernels    each kernel against its plain PyTorch version on the card at
             the served shape (8192 streams x 2048 samples), beside its budget
  serve      the slice as a user drives it: zoo roots 4 (neural 2x16,
             pretrained) and 0 (analytic, quality "best") in the LPF clipper
             answer four consecutive (8192, 2048) request blocks with the
             capacitor state carried between them; the launch counters must
             rise, the output must be finite and equal one (8192, 8192) run
  reference  kernels against the circuit's sequential Circuit.process on a
             small input
  timing     CUDA-event medians of kernel and plain version at (8192, 2048)

then a JSON line with every kernel's launches, error and times, the card's
name and power limit, and finally ``{"ok": true, "device": {...}}``.  Any
failed check raises, so the script exits non-zero and prints no result; so
does a machine without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

from diffwdf_tpu_torch.models.diode_clipper import make_diode_clipper, make_root_from_zoo
from diffwdf_tpu_torch.ops import _build
from diffwdf_tpu_torch.ops import fused_clipper as fc
from diffwdf_tpu_torch.roots.diode import diode_1n4148_1u1d, diode_1n4148_1u2d
from diffwdf_tpu_torch.roots.neural import NeuralDiodeRoot

FS = 96000.0
B, T, BLOCKS = 8192, 2048, 4
REPS = 10  # timed runs per version, after warm-up
BUDGET = {"analytic": 5e-6, "neural": 2e-5}  # the JAX suite's kernel-vs-scan budgets
SOURCE = "diffwdf_tpu_torch/ops/csrc/fused_clipper.cu"
REPLACES = {
    "analytic": "diffwdf_tpu/ops/fused_clipper.py:168",
    "neural": "diffwdf_tpu/ops/fused_clipper.py:336",
}


def _card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return out.strip().splitlines()[0]


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def _max_err(x: torch.Tensor, y: torch.Tensor) -> float:
    return float((x - y).abs().max())


def _zoo_circuit(index: int, device):
    root, root_params = make_root_from_zoo(index, device=device)
    ckt = make_diode_clipper(root, FS)
    return ckt, {**ckt.init_params(device), **root_params}


def block_server(ckt, params):
    """The serving function of the LPF clipper ``ckt``: its block-rate
    scalars (source R, C, diode physics) are read to the host once, so that
    answering a block launches one kernel and never waits on the card.
    Returns serve(vin, z, plain=False) -> (out, z_final), with ``plain``
    selecting the kernel's plain PyTorch version."""
    root = ckt.root
    r_source, cap = float(params["Vs"]["R"]), float(params["C"]["C"])
    if isinstance(root, NeuralDiodeRoot):
        mlp = params[root.name]

        def serve(vin, z, plain=False):
            fn = fc.fused_clipper_neural_plain if plain else fc.fused_clipper_neural
            return fn(vin, z, mlp, r_source, cap, fs=ckt.fs)

        return serve
    p = {k: float(v) for k, v in params[root.name].items()}
    args = (r_source, cap, p["Is"], p["nabla"] * p["Vt"], p["N_up"], p["N_down"])

    def serve(vin, z, plain=False):
        fn = fc.fused_clipper_analytic_plain if plain else fc.fused_clipper_analytic
        return fn(vin, z, *args, fs=ckt.fs, quality_iters=root.iters)

    return serve


def _cuda_ms(fn, runs: int, calls: int = 1) -> list:
    """CUDA-event time of ``calls`` back-to-back calls of fn, per call, for
    each of ``runs`` runs."""
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    times = []
    for _ in range(runs):
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return times


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0, help="seed of the input signal")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is false; this run needs a GPU")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False  # plain versions in full f32
    torch.backends.cudnn.allow_tf32 = False
    card = _card()
    kind = torch.cuda.get_device_name(0)

    # --- toolchain ---------------------------------------------------------
    nvcc = subprocess.run([_build._nvcc(), "--version"], capture_output=True, text=True,
                          check=True).stdout.strip().splitlines()[-1]
    print(f"phase toolchain card={card!r} torch={torch.__version__} "
          f"cuda={torch.version.cuda} nvcc={nvcc!r}", flush=True)

    # --- build (set-up) ----------------------------------------------------
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0
    log = _build.library_path().with_suffix(".log")
    ptxas = [l.strip() for l in log.read_text().splitlines()
             if "registers" in l or "spill" in l] if log.exists() else []
    print(f"phase build seconds={build_s:.2f} lib={_build.library_path().name}", flush=True)
    for line in ptxas:
        print(f"  ptxas {line}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(args.seed)
    signal = 2.0 * torch.randn(B, BLOCKS * T, generator=gen, device=dev)
    blocks = [signal[:, i * T:(i + 1) * T].contiguous() for i in range(BLOCKS)]
    z0 = torch.zeros(B, device=dev)

    circuits = {"neural": _zoo_circuit(4, dev), "analytic": _zoo_circuit(0, dev)}
    servers = {name: block_server(*c) for name, c in circuits.items()}
    _check(isinstance(circuits["neural"][0].root, NeuralDiodeRoot)
           and circuits["neural"][0].root.layer_size == 16, "zoo entry 4 is the 2x16 net")
    _check(circuits["analytic"][0].root.diode == diode_1n4148_1u1d
           and circuits["analytic"][0].root.quality == "best", "zoo entry 0 is 1U-1D best")

    # --- kernels vs plain at the served shape --------------------------------
    max_err = {}
    cases = [("neural", "2x16 pretrained", servers["neural"])]
    for diode in (diode_1n4148_1u1d, diode_1n4148_1u2d):
        root, rp = make_root_from_zoo(0, diode=diode, device=dev)
        ckt = make_diode_clipper(root, FS)
        cases.append(("analytic", f"best {diode.name}",
                      block_server(ckt, {**ckt.init_params(dev), **rp})))
    for name, label, serve in cases:
        got, got_z = serve(blocks[0], z0)
        want, want_z = serve(blocks[0], z0, plain=True)
        torch.cuda.synchronize()
        err = max(_max_err(got, want), _max_err(got_z, want_z))
        max_err[name] = max(max_err.get(name, 0.0), err)
        print(f"phase kernels {name} {label} shape=({B}, {T}) max_abs_err={err:.3e} "
              f"budget={BUDGET[name]:.0e}", flush=True)
        _check(bool(torch.isfinite(got).all()) and err <= BUDGET[name],
               f"{name} kernel {label} within {BUDGET[name]} of its plain version")

    # --- serve: the main path, counted -------------------------------------
    fc.fused_clipper_neural.launches = 0
    fc.fused_clipper_analytic.launches = 0
    served, wall_ms = {}, {}
    for name, serve in servers.items():
        t0 = time.perf_counter()
        z, outs = z0, []
        for blk in blocks:
            out, z = serve(blk, z)
            outs.append(out)
        torch.cuda.synchronize()
        wall_ms[name] = (time.perf_counter() - t0) * 1e3 / BLOCKS
        served[name] = (torch.cat(outs, dim=1), z)
    launches = {"neural": fc.fused_clipper_neural.launches,
                "analytic": fc.fused_clipper_analytic.launches}
    for name, serve in servers.items():
        out, z = served[name]
        whole, whole_z = serve(signal, z0)
        torch.cuda.synchronize()
        carry_err = max(_max_err(out, whole), _max_err(z, whole_z))
        finite = bool(torch.isfinite(out).all() and torch.isfinite(z).all())
        print(f"phase serve {name} zoo={4 if name == 'neural' else 0} blocks={BLOCKS}x({B}, {T}) "
              f"launches={launches[name]} finite={finite} shape={tuple(out.shape)} "
              f"wall_ms_per_block={wall_ms[name]:.4f} "
              f"carry_vs_one_run_max_abs={carry_err:.3e} budget=1e-06", flush=True)
        _check(launches[name] >= BLOCKS, f"{name} kernel launched on the main path")
        _check(finite and tuple(out.shape) == (B, BLOCKS * T), f"{name} output finite, shaped")
        _check(carry_err <= 1e-6, f"{name} blocks with carried state equal one run")

    # --- reference: kernels vs the circuit's sequential loop ----------------
    small = blocks[1][:256, :256].contiguous()
    for name, (ckt, params) in circuits.items():
        got, _ = servers[name](small, z0[:256])
        want, _ = ckt.process(params, ckt.init_state(dev), {"Vs": {"v": small.T}})
        err = _max_err(got, want.T)
        print(f"phase reference {name} shape=(256, 256) vs Circuit.process "
              f"max_abs_err={err:.3e} budget={BUDGET[name]:.0e}", flush=True)
        _check(err <= BUDGET[name], f"{name} kernel within budget of Circuit.process")

    # --- timing --------------------------------------------------------------
    times = {}
    for name, serve in servers.items():
        def kernel():
            serve(blocks[0], z0)

        def plain():
            serve(blocks[0], z0, plain=True)

        _cuda_ms(kernel, 1, 2)  # warm-up
        _cuda_ms(plain, 1)
        k_ms, p_ms = [], []
        for rep in range(REPS):  # alternate which goes first
            order = (kernel, plain) if rep % 2 else (plain, kernel)
            for fn in order:
                if fn is kernel:  # back-to-back launches keep the card busy
                    k_ms += _cuda_ms(kernel, 1, 10)
                else:
                    p_ms += _cuda_ms(plain, 1)
        km, pm = statistics.median(k_ms), statistics.median(p_ms)
        times[name] = (km, pm)
        print(f"phase timing {name} shape=({B}, {T}) runs={REPS} "
              f"kernel_ms={km:.4f} [{min(k_ms):.4f}, {max(k_ms):.4f}] "
              f"({B * T / km / 1e3:.1f} Msamples/s, 10 launches per run) "
              f"plain_ms={pm:.4f} [{min(p_ms):.4f}, {max(p_ms):.4f}] "
              f"({B * T / pm / 1e3:.1f} Msamples/s) card={card!r}", flush=True)

    print(json.dumps({"kernels": [
        {"name": f"fused_clipper_{name}", "route": "cuda", "source": SOURCE,
         "replaces": REPLACES[name], "launches": launches[name],
         "max_abs_err": max_err[name], "ms": times[name][0], "plain_ms": times[name][1]}
        for name in ("neural", "analytic")]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
