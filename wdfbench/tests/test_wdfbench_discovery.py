"""The harness takes a configuration, a traffic mix, a cell's limits and a
metric that are added as new files, and edits no existing one."""

import hashlib
import json
import shutil

from wdfbench import harness



def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted((root / "wdfbench").rglob("*")) if p.is_file()}


def test_new_files_are_found_by_name(small, tmp_path):
    root = tmp_path / "root"
    shutil.copytree(small, root, symlinks=True)
    before = _digest(root)
    pieces = root / "wdfbench"
    # a configuration: the clipper with the zoo's 2x8 root
    cfg = json.loads((pieces / "configs" / "clipper_2x16.json").read_text())
    cfg["root"].update(width=8,
                       weights="models/pretrained/1N4148 (1U-1D)_2x8_pretrained_model.json")
    (pieces / "configs" / "clipper_2x8.json").write_text(json.dumps(cfg))
    shutil.copy(pieces / "work" / "clipper_2x16.json", pieces / "work" / "clipper_2x8.json")
    # a traffic mix, the cell's limits and a metric that counts the calls
    (pieces / "traffic" / "serve_tiny.json").write_text(json.dumps(
        {"kind": "serve", "rows": 6, "block": 64, "pool_blocks": 2, "check_rows": 3,
         "check_within": 2, "why": "a test"}))
    (pieces / "limits" / "clipper_2x8.serve_tiny.json").write_text(json.dumps(
        {"limits": {"out_gap": 1e-4, "state_gap": 1e-4}}))
    (pieces / "metrics" / "serve.calls.py").write_text(
        "def read(ctx):\n    return ctx['units']\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "clipper_2x8", "source": "x",
                             "file": "wdfbench/configs/clipper_2x8.json", "reduced": [],
                             "why": "a test"})
    bench["workloads"].append({"name": "clipper_2x8.serve_tiny", "config": "clipper_2x8",
                               "traffic": "serve_tiny", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "serve_msamples_per_s":
            m["workloads"].append("clipper_2x8.serve_tiny")
    bench["per_layer"].append({"name": "serve.calls", "unit": "calls", "better": "higher",
                               "source": "program_counter", "layer": "kernel wrappers",
                               "moves": "serve_msamples_per_s",
                               "workloads": ["clipper_2x8.serve_tiny"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))

    r = harness.run_cell(root, "clipper_2x8.serve_tiny", 3, 0.1, True, "cpu")
    assert r["correct"] and r["metrics"]["serve.calls"]["value"] == r["attempted"] >= 1
    r = harness.run_cell(root, "clipper_2x8.serve_tiny", 3, 0.1, False, "cpu")
    assert set(r["metrics"]) == {"serve_msamples_per_s", "setup_s"}
    after = _digest(root)
    assert all(after[p] == h for p, h in before.items())  # nothing edited, only added
