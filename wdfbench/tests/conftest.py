"""Shared fixtures of the benchmark's CPU tests: a copy of the benchmark's
pieces under a temporary root, with small traffic mixes beside the real
ones, so that a whole run fits in seconds on the CPU."""

import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
if str(REPO) not in sys.path:
    sys.path.insert(0, str(REPO))

#: each cell's small stand-in: (rows, block) of its traffic
SMALL = {"train_8192": (12, 128), "serve_2k": (16, 160),
         "serve_16k": (12, 256)}


def small_root(tmp: Path) -> Path:
    """A root holding BENCHMARK.json, wdfbench/ and the repo's models/, whose
    cells run the real configurations, limits and code on small traffic
    mixes (same names)."""
    shutil.copytree(REPO / "wdfbench", tmp / "wdfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(REPO / "BENCHMARK.json", tmp / "BENCHMARK.json")
    (tmp / "models").symlink_to(REPO / "models")  # the zoo's trained roots
    for name, (rows, block) in SMALL.items():
        path = tmp / "wdfbench" / "traffic" / f"{name}.json"
        d = json.loads(path.read_text())
        d.update(rows=rows, block=block)
        if "check_rows" in d:
            d["check_rows"] = 8
        path.write_text(json.dumps(d))
    return tmp


@pytest.fixture(scope="session")
def small(tmp_path_factory) -> Path:
    return small_root(tmp_path_factory.mktemp("wdfbench"))


def cells():
    return [w["name"] for w in json.loads((REPO / "BENCHMARK.json").read_text())["workloads"]]
