"""Run one cell of the benchmark once and print its result line.

    python3 -m wdfbench.run --workload <config>.<traffic> --seed N --seconds S --trace 0|1

From the root of a checkout on a machine with an NVIDIA GPU.  It sets up
(build, weights and inputs from the seed, warm-up), measures a closed-loop
window of S seconds (with --trace 1, one such window without the profiler
for the rates, then one traced with torch.profiler), checks
the outputs against the plain reference, prints the compared numbers beside
their limits as the last lines of standard error, and prints one JSON line
last on standard output.  Without a CUDA device, or with fewer than the
cell asks for, it exits 2 and prints no result.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache of the program at a fixed path inside the checkout
CACHE = ROOT / "wdfbench_cache"
for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                 ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "cuda")):
    os.environ[var] = str(CACHE / sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

from wdfbench import harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench = harness.load_json(ROOT / "BENCHMARK.json")
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}.get(args.workload)
    if chips is None:
        print(f"wdfbench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"wdfbench: the cell needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    torch.set_num_threads(min(4, torch.get_num_threads()))
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              "cuda:0", started=STARTED)
    found = harness.forbidden_modules()
    if found:
        print(f"wdfbench: the process loaded {found}; no result", file=sys.stderr)
        return 3
    harness.report_checks(result)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
