"""Run one cell once: find its pieces by name, set up, measure the window,
check the outputs against the plain reference, and assemble the result.

``run_cell`` is the whole run but the look for a card (``run.py`` makes
that), so that the tests can drive a run on the CPU at a small size.
"""

from __future__ import annotations

import contextlib
import gc
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType

import torch

from wdfbench import inputs, trace
from wdfbench.reference import wdf

#: the modules that may not be loaded in the process that prints a result,
#: compared by whole top-level names
FORBIDDEN = ("jax", "jaxlib", "flax", "diffwdf_tpu")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path) -> ModuleType:
    """The Python file ``path`` as a module of its own."""
    if not path.exists():
        raise FileNotFoundError(f"no {path}")
    name = "wdfbench_piece." + ".".join(path.with_suffix("").parts[-2:])
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Cell:
    """One cell's pieces, found by name under ``root`` (the checkout that
    holds BENCHMARK.json and wdfbench/), and its seed and device."""

    def __init__(self, root: Path, workload: str, seed: int, device):
        self.root, self.seed = Path(root), int(seed)
        self.bench = load_json(self.root / "BENCHMARK.json")
        cells = {w["name"]: w for w in self.bench["workloads"]}
        if workload not in cells:
            raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
        self.spec = cells[workload]
        self.name = workload
        pieces = self.root / "wdfbench"
        self.cfg = load_json(pieces / "configs" / f"{self.spec['config']}.json")
        self.traffic = load_json(pieces / "traffic" / f"{self.spec['traffic']}.json")
        self.limits = load_json(pieces / "limits" / f"{workload}.json")["limits"]
        self.work = load_json(pieces / "work" / f"{self.spec['config']}.json")["kinds"][
            self.traffic["kind"]]
        self.system = load_module(pieces / "systems" / f"{self.cfg['circuit']}.py")
        self.reference = load_module(pieces / "reference" / f"{self.cfg['circuit']}.py")
        self.driver = load_module(pieces / "drivers" / f"{self.traffic['kind']}.py")
        self.device = torch.device(device)

    def weights(self, device) -> dict:
        """The root's MLP as the program takes it ({"layers": [{kernel,
        bias}]}, float32 on ``device``), made afresh from the configuration:
        read from its weights file, or drawn from the seed."""
        spec = self.cfg["root"]
        if spec["weights"] == "seed":
            sizes = [2] + [spec["width"]] * (spec["n_layers"] + 1) + [1]
            return {"layers": inputs.seeded_mlp(sizes, self.seed, device)}
        layers, _ = wdf.load_mlp_json(self.root / spec["weights"])
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32, device=device)  # noqa: E731
        return {"layers": [{"kernel": f32(k), "bias": f32(b)} for k, b in layers]}

    def reference_model(self, dtype, device, pot_rows=None, tf32: bool = False) -> wdf.Model:
        """The plain reference of this configuration: its own adaptation and
        linear maps in float64, the root's weights as the program gets them,
        computed in ``dtype`` (``tf32``: the control's precision)."""
        rows = None if pot_rows is None else pot_rows.double().cpu().numpy()
        coef = self.reference.for_config(self.cfg, rows)
        ca, M = wdf.linear_maps(self.reference.step, coef, len(self.reference.STATES),
                                0 if rows is None else len(rows))
        # drawn on the cell's device, as the program's were: the same values
        layers = [(l["kernel"].double().cpu().numpy(), l["bias"].double().cpu().numpy())
                  for l in self.weights(self.device)["layers"]]
        return wdf.Model(ca, M, coef["r_up"], layers, self.cfg["root"]["activations"],
                         dtype=dtype, device=device, tf32=tf32)

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def free(self) -> None:
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({e})"


def _metric_specs(cell: Cell, trace_on: bool) -> list:
    """The metrics this cell reports: its end-to-end ones (tracing off) or
    its per-layer ones (tracing on), by each metric's ``workloads``."""
    e2e = cell.bench["end_to_end"]
    mine = {m["name"] for m in e2e if cell.name in m.get("workloads", [cell.name])}
    if not trace_on:
        return [m for m in e2e if m["name"] in mine]
    return [m for m in cell.bench["per_layer"]
            if cell.name in m.get("workloads", [cell.name] if m["moves"] in mine else [])]


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def run_cell(root, workload: str, seed: int, seconds: float, trace_on: bool, device,
             started: float = None, log=sys.stderr, system=None) -> dict:
    """One run of a cell: the result line's dict, its ``checks`` last.
    ``system(cell)``, where given, stands in for the system under test (the
    control, or a planted fault: ``wdfbench.faults``)."""
    started = time.perf_counter() if started is None else started
    cell = Cell(root, workload, seed, device)
    if system is not None:
        cell.system = system(cell)
    driver = cell.driver
    job = driver.setup(cell)
    cell.sync()
    setup_s = time.perf_counter() - started

    def window(prof):
        with prof, torch.profiler.record_function(trace.WINDOW):
            cell.sync()
            t0 = time.perf_counter()
            n = driver.loop(job, t0 + seconds)
            cell.sync()
            return n, time.perf_counter() - t0

    untraced = None
    if trace_on:  # the rates of the whole step come from a window without the profiler
        n, s = window(contextlib.nullcontext())
        untraced = {"window_s": s, "samples": n * cell.traffic["rows"] * cell.traffic["block"]}
    prof = trace.profiler() if trace_on else contextlib.nullcontext()
    units, window_s = window(prof)
    summary = trace.reduce(prof) if trace_on else None
    del prof
    spans = driver.host_spans(job, cell) if trace_on else {}
    counters = cell.system.counters()
    peak = (torch.cuda.max_memory_allocated(cell.device) if cell.device.type == "cuda" else 0)

    t_check = time.perf_counter()
    checks = driver.check(job, cell)
    print(f"wdfbench: the check against the reference took "
          f"{time.perf_counter() - t_check:.2f} s", file=log)
    ctx = {"setup_s": setup_s, "window_s": window_s, "units": units,
           "samples": units * cell.traffic["rows"] * cell.traffic["block"],
           "rows": cell.traffic["rows"], "untraced": untraced,
           "work": cell.work, "trace": summary, "spans": spans, "counters": counters,
           "log": log}
    metrics = {}
    for spec in _metric_specs(cell, trace_on):
        value = load_module(cell.root / "wdfbench" / "metrics" / f"{spec['name']}.py").read(ctx)
        if value is not None:
            metrics[spec["name"]] = {"value": value, "unit": spec["unit"]}

    correct = all(math.isfinite(v) and v <= lim for _, v, lim in checks)
    dev = {"platform": "gpu" if cell.device.type == "cuda" else cell.device.type,
           "kind": (torch.cuda.get_device_name(cell.device) if cell.device.type == "cuda"
                    else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": units, "failed": 0,
              "metrics": metrics, "device": dev}
    if trace_on:
        dev["busy_s"], dev["window_s"] = summary["busy_s"], summary["window_s"]
        result["breakdown"] = trace.breakdown(summary)
        print(f"wdfbench: traced window {summary['window_s']:.4f} s, device ops "
              f"{summary['device_ops']}, {driver.UNIT}s {units}, program counters {counters}, "
              f"card {_power_limit() if cell.device.type == 'cuda' else 'none'}", file=log)
    result["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return result


def report_checks(result: dict, log=sys.stderr) -> None:
    """The numbers compared, each beside its limit, as the last lines."""
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "OVER"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {ok}", file=log)
    log.flush()
