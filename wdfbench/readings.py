"""Read a cell's compared numbers over many seeds, for the program or for a
stand-in that the check must refuse (``wdfbench.faults``), all in one
process so that the build and the imports are paid once.  The limits in
``limits/<workload>.json`` are set from these readings.

    python3 -m wdfbench.readings --workload W --seeds 1,2,3 [--standin control] [--seconds 1]

One JSON line a seed: {"seed", "standin", "units", "checks"}.  Needs a card.
"""

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from wdfbench import faults, harness  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--standin", choices=sorted(faults.STANDINS), default=None)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    system = faults.STANDINS[args.standin] if args.standin else None
    for seed in (int(s) for s in args.seeds.split(",")):
        r = harness.run_cell(ROOT, args.workload, seed, args.seconds, False, args.device,
                             system=system)
        print(json.dumps({"seed": seed, "standin": args.standin or "program",
                          "units": r["attempted"], "checks": r["checks"],
                          "metrics": r["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
