"""Process-group initialisation, scaling measurement and a process launcher.

The multi-device story of the port is the standard PyTorch one: one process
a rank (``torchrun`` or :func:`spawn`), ``torch.distributed`` over NCCL
between cards or gloo on the CPU, one ``DeviceMesh`` over the ranks
(``parallel.mesh``) and the same functions on every rank
(``parallel.data_parallel``, ``parallel.time_block``, ``parallel.sweep``).
NCCL refuses two ranks on one card; gloo takes them (``parallel.mesh`` then
moves CUDA tensors through host copies for the collectives).

``measure_scaling`` is the scaling-efficiency harness (BASELINE.json:
samples/s at 1 card / N cards, efficiency = T_1 / T_n of a weak-scaled
step).
"""

from __future__ import annotations

import multiprocessing
import multiprocessing.connection
import os
import pickle
import shutil
import tempfile
import time
import traceback
from datetime import timedelta
from pathlib import Path
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.distributed as dist

from ..core.elements import Device
from .mesh import make_mesh, rank_device, reduce_group_


def _backend(device: Device) -> str:
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


#: how long a collective may wait before it fails (instead of hanging)
INIT_TIMEOUT_S = 600.0


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *,
               device: Device = "cuda") -> bool:
    """Initialise the default process group of a multi-process run.

    ``coordinator_address`` is an ``init_method`` ("tcp://host:port",
    "file:///path") or "host:port"; by default torchrun's environment
    (``env://``: MASTER_ADDR, MASTER_PORT, WORLD_SIZE, RANK).
    ``num_processes`` and ``process_id`` default to WORLD_SIZE and RANK.
    The backend is NCCL for a CUDA device (each rank on card LOCAL_RANK, or
    its rank modulo the cards), gloo for the CPU.  Collectives time out
    after ``INIT_TIMEOUT_S``.

    Returns False for one process (nothing to initialise) or a group already
    initialised, True once initialised; any other failure raises."""
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 or dist.is_initialized():
        return False
    if process_id is None:
        if "RANK" not in os.environ:
            raise ValueError("initialize: pass process_id or set RANK (torchrun sets it)")
        process_id = int(os.environ["RANK"])
    if coordinator_address is None:
        init_method = "env://"
    elif "://" in coordinator_address:
        init_method = coordinator_address
    else:
        init_method = f"tcp://{coordinator_address}"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize: no CUDA device found; pass device='cpu' for gloo")
        local = os.environ.get("LOCAL_RANK")
        torch.cuda.set_device(int(local) if local is not None
                              else process_id % torch.cuda.device_count())
    dist.init_process_group(_backend(dev), init_method=init_method,
                            world_size=num_processes, rank=process_id,
                            timeout=timedelta(seconds=INIT_TIMEOUT_S))
    return True


def _drain(device: Device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _slowest(seconds: float, device: Device) -> float:
    """The largest of every rank's ``seconds`` (an all-reduce with MAX over
    the whole group, which also holds every rank until all have timed)."""
    t = torch.tensor([seconds], dtype=torch.float64, device=rank_device(device))
    return float(reduce_group_(t, dist.group.WORLD, dist.ReduceOp.MAX).item())


def measure_scaling(make_step: Callable[[object], Callable], device_counts: Sequence[int],
                    iters: int = 10, items_per_call: Optional[int] = None, *,
                    axis: str = "data", device: Device = "cuda") -> Dict[int, Dict[str, float]]:
    """Run ``make_step(mesh)() -> outputs`` on meshes over the first n ranks
    for each n of ``device_counts`` up to the world size, the n ranks on
    ``axis`` of ("data", "time") (shape (n, 1) for "data", (1, n) for
    "time"), and report throughput and efficiency against the first mesh.

    Every rank calls it.  ``make_step`` receives the mesh and returns a
    zero-argument callable doing one (sharded) step; the workload should be
    weak-scaled (items_per_call * n items a call), so perfect scaling keeps
    the step time flat and efficiency = t_first / t_n.  A warm-up call is
    drained (on CUDA, ``torch.cuda.synchronize``) before the clock starts;
    the ranks outside the mesh wait.  The slowest rank's time counts.
    Returns {n: {"mean_s", "items_per_s" (with items_per_call),
    "efficiency"}} on every rank."""
    results: Dict[int, Dict[str, float]] = {}
    base = None
    for n in device_counts:
        if n > _world(device):
            continue
        shape = (n, 1) if axis == "data" else (1, n)
        mesh = make_mesh(shape, ("data", "time"), devices=range(n), device=device)
        seconds = 0.0
        if dist.get_rank() < n:
            step = make_step(mesh)
            step()
            _drain(device)
            t0 = time.perf_counter()
            for _ in range(iters):
                step()
            _drain(device)
            seconds = (time.perf_counter() - t0) / iters
        dt = _slowest(seconds, device)
        rec = {"mean_s": dt}
        if items_per_call:
            rec["items_per_s"] = items_per_call * n / dt
        if base is None:
            base = dt
        rec["efficiency"] = base / dt if dt > 0 else 0.0
        results[n] = rec
    return results


def _world(device: Device) -> int:
    if not dist.is_initialized():
        make_mesh(device=device)  # one rank: a group of its own
    return dist.get_world_size()


# ---------------------------------------------------------------------------
# spawn: world_size ranks in fresh processes (the tests, chip_smoke.py)
# ---------------------------------------------------------------------------


def _rank_main(rank: int, world_size: int, fn: Callable, args: tuple, backend: str,
               device: str, init_method: str, out_dir: str, timeout_s: float) -> None:
    torch.set_num_threads(1)
    out = Path(out_dir)
    status = 1
    try:
        if torch.device(device).type == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=timedelta(seconds=timeout_s))
        result = fn(rank, world_size, *args)
        tmp = out / f"rank{rank}.tmp"
        with open(tmp, "wb") as f:
            pickle.dump(result, f)
        os.replace(tmp, out / f"rank{rank}.pkl")
        status = 0
    except Exception:
        (out / f"rank{rank}.err").write_text(traceback.format_exc())
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    raise SystemExit(status)


def _failures(procs, out: Path) -> str:
    """Every failed rank's traceback (or exit code), in the order the ranks
    wrote their errors."""
    failed = [r for r, p in enumerate(procs) if p.exitcode not in (None, 0)]
    errs = {r: out / f"rank{r}.err" for r in failed}
    failed.sort(key=lambda r: errs[r].stat().st_mtime if errs[r].exists() else float("inf"))
    parts = [f"--- rank {r} ---\n" + (errs[r].read_text() if errs[r].exists()
                                       else f"exit code {procs[r].exitcode}\n")
             for r in failed]
    return f"spawn: ranks {failed} of {len(procs)} failed:\n" + "".join(parts)


def spawn(fn: Callable, world_size: int, *args, backend: str = "gloo", device: Device = "cpu",
          timeout_s: float = 120.0) -> list:
    """Run ``fn(rank, world_size, *args)`` in ``world_size`` spawned
    processes, one process group among them: ``backend`` over a FileStore
    (``init_method="file://..."``, a file in a fresh temporary directory,
    so concurrent launchers never race for a port),
    each rank on one thread (``torch.set_num_threads(1)``) and, for a CUDA
    ``device``, on card rank modulo the cards.  ``fn`` must be importable
    (a module-level function) and its result picklable.

    Returns the ranks' results in rank order.  A rank that raises or dies
    ends the run: the others are terminated and this raises
    ``RuntimeError`` with every failed rank's traceback, the first to fail
    first; the whole run outlasting ``timeout_s`` raises ``TimeoutError``."""
    ctx = multiprocessing.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="diffwdf_spawn_")
    init_method = f"file://{os.path.join(tmp, 'store')}"
    procs = [ctx.Process(target=_rank_main, daemon=True,
                         args=(r, world_size, fn, args, backend, str(device), init_method, tmp,
                               timeout_s))
             for r in range(world_size)]
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        while not all(p.exitcode == 0 for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                # the others fail soon after (their peer is gone): let them
                # write their errors, then report every failed rank, the
                # first to fail first
                grace = time.monotonic() + 5.0
                while any(p.exitcode is None for p in procs) and time.monotonic() < grace:
                    multiprocessing.connection.wait(
                        [p.sentinel for p in procs if p.exitcode is None],
                        timeout=max(grace - time.monotonic(), 0.0))
                raise RuntimeError(_failures(procs, Path(tmp)))
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(f"spawn: {world_size} ranks of {fn.__name__} outlasted "
                                   f"{timeout_s:g} s")
            multiprocessing.connection.wait([p.sentinel for p in procs if p.exitcode is None],
                                            timeout=min(left, 1.0))
        results = []
        for r in range(world_size):
            with open(Path(tmp, f"rank{r}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
