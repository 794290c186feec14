"""The plain reference against the port's plain CPU paths, and whole runs
of every cell on the CPU at a small size: the program must come out
correct against the reference under the cell's own limits."""

import numpy as np
import pytest
import torch

from wdfbench import harness
from wdfbench.reference import tube_screamer, wdf

from .conftest import cells


@pytest.mark.parametrize("workload", cells())
def test_every_cell_runs_correct_on_the_cpu(small, workload):
    r = harness.run_cell(small, workload, 2**31 + 77, 0.2, False, "cpu")
    assert r["correct"], r["checks"]
    assert list(r)[-1] == "checks" and r["attempted"] >= 1
    assert {"setup_s"} < set(r["metrics"])


def test_rtype_scatter_matches_the_port_bake():
    from diffwdf_tpu_torch.core.rtype import bake_static_scatter
    from diffwdf_tpu_torch.models.tube_screamer import tube_screamer_netlist

    rs = [2193.3, 26861.9, 1.0e6]
    S, ra = tube_screamer.rtype_scatter(rs)
    S_port, ra_port = bake_static_scatter(tube_screamer_netlist(), rs)
    np.testing.assert_allclose(S, S_port.double().numpy(), rtol=1e-6, atol=1e-7)
    assert abs(ra - float(ra_port)) <= 1e-6 * abs(ra)
    assert abs(S[0, 0]) < 1e-9  # port A adapted


def test_tf32_rounds_to_ten_mantissa_bits():
    # ulp 2^-10 in [1, 2), 2^-9 in [2, 4); halves go away from zero
    x = torch.tensor([1.0 + 2.0 ** -11, 1.0 + 2.0 ** -10 + 2.0 ** -12, -3.0 - 2.0 ** -10,
                      -3.0 - 2.0 ** -11])
    got = wdf._tf32(x)
    assert got.tolist() == [1.0 + 2.0 ** -10, 1.0 + 2.0 ** -10, -3.0 - 2.0 ** -9, -3.0]


def test_linear_maps_reproduce_the_wave_step():
    coef = tube_screamer.coefficients(48000.0, 0.5)
    ca, M = wdf.linear_maps(tube_screamer.step, coef, 3)
    rng = np.random.default_rng(0)
    z, v = list(rng.standard_normal(3)), float(rng.standard_normal())
    root = lambda a: np.tanh(a) - 0.3 * a  # noqa: E731
    z_new, out = tube_screamer.step(coef, z, v, root)
    a = np.concatenate([z, [v]]) @ ca
    y = np.concatenate([z, [v, root(a)]]) @ M
    np.testing.assert_allclose(y, np.concatenate([z_new, [out]]), rtol=1e-12, atol=1e-12)
