"""The benchmark of diffwdf_tpu_torch on an NVIDIA GPU.

One command runs one cell (a configuration under a traffic mix) once:

    python3 -m wdfbench.run --workload <config>.<traffic> --seed N --seconds S --trace 0|1

Every piece is found by the name ``BENCHMARK.json`` gives it: a
configuration in ``configs/<name>.json``, a traffic mix in
``traffic/<name>.json``, the limits of a cell's correctness check in
``limits/<workload>.json``, a metric's reader in ``metrics/<name>.py``, the
frozen operation and byte counts of a configuration's kernels in
``work/<config>.json``; a configuration's ``circuit`` names the files that
drive the system under test (``systems/<circuit>.py``) and its plain
reference (``reference/<circuit>.py``), and a traffic mix's ``kind`` the
loop that drives it (``drivers/<kind>.py``).  Adding a cell, a
configuration or a metric adds files and edits none.
"""
