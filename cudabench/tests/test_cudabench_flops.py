"""The frozen operation counts give the step counts the benchmark's
rooflines and MFU rest on."""

import pytest

import flops
import harness


def test_heat_step():
    assert flops.step_flops(7, 64, 2, 128, 3) \
        + 12 * flops.n_params(2, 128, 3) == 133_523_980


def test_dgm_replica_step():
    assert flops.dgm_step_flops(3, 100, 128, 4, 2) == 474_931_200


def test_cells_step_costs():
    f, b = harness.step_cost(harness.load_cell("heat1d.fused.solve"))
    assert f == 133_523_980
    assert flops.bound_s(f, b) == pytest.approx(1.993e-6, rel=1e-3)
    f, b = harness.step_cost(harness.load_cell("fhn.fused.ensemble16"))
    assert f == 16 * (474_931_200 + 12 * flops.dgm_n_params(128, 4, 2))
    assert flops.bound_s(f, b) == pytest.approx(114.2e-6, rel=1e-3)
    f, _ = harness.step_cost(
        harness.load_cell("heat1d.population.batch_sizes"))
    rows = 5 * (2 ** 11 - 1)
    assert f == rows * flops.step_flops(7, 1, 2, 128, 3) \
        + 55 * 12 * flops.n_params(2, 128, 3)
    assert f == pytest.approx(21.29e9, rel=1e-3)
