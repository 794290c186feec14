"""Nothing the harness or the reference imports is JAX or the JAX package,
compared by whole top-level names (the port's name begins with the JAX
package's); the reference imports nothing of the port either.  Each check
runs in a fresh interpreter, since this test process may hold JAX."""

import json
import subprocess
import sys

from .conftest import REPO

LOADED = "import json, sys; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"


def _top_level(code: str) -> set:
    out = subprocess.run([sys.executable, "-c", f"{code}\n{LOADED}"], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_harness_and_a_whole_run_load_no_jax(small):
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import wdfbench.run, wdfbench.readings, wdfbench.faults\n"
            "from wdfbench import harness\n"
            f"harness.run_cell({str(small)!r}, 'clipper_2x16.serve_2k', 5, 0.1, True, 'cpu',"
            " log=open('/dev/null', 'w'))\n"
            f"harness.run_cell({str(small)!r}, 'ts_2x16.train_8192', 5, 0.1, False, 'cpu')")
    loaded = _top_level(code)
    assert not loaded & {"jax", "jaxlib", "flax", "diffwdf_tpu"}
    assert "diffwdf_tpu_torch" in loaded  # the system under test did run


def test_reference_loads_nothing_of_the_port():
    code = ("import sys; sys.path.insert(0, '.')\n"
            "import wdfbench.reference.wdf, wdfbench.reference.lpf_clipper, "
            "wdfbench.reference.tube_screamer, wdfbench.inputs")
    loaded = _top_level(code)
    assert not loaded & {"jax", "jaxlib", "flax", "diffwdf_tpu", "diffwdf_tpu_torch"}


def test_harness_sees_a_forbidden_module_by_whole_name(monkeypatch):
    from wdfbench import harness

    for name in list(sys.modules):
        if name.split(".")[0] in harness.FORBIDDEN:
            monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "diffwdf_tpu_torch_x", sys)
    assert harness.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "diffwdf_tpu.ops", sys)
    assert harness.forbidden_modules() == ["diffwdf_tpu"]
