"""On the card: each cell's control (the reference in TF32, one precision
below the configurations' strict fp32, put in the program's place) and the
planted faults fail the cell's comparison, and the fp32 reference passes
it, on three seeds at the cell's own size. Skipped without a card."""

import pytest
import torch

import control
import harness

CELLS = ["heat1d.fused.solve", "fhn.fused.ensemble16", "heat1d.scan.solve",
         "heat1d.population.batch_sizes"]
SEEDS = [2147483713, 2147483714, 2147483715]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 is a tensor-core mode")
    return torch.device("cuda")


def _fails(numbers, limits):
    return any(v > limits[k] for k, v in numbers.items() if k in limits)


@pytest.mark.gpu
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_the_sound_reference_passes(card, cell):
    c = harness.load_cell(cell)
    faults = ["tf32", "unchanged", "half_batch"]
    if c.workload["check"] == "train_losses":
        faults.append("frozen")
    for seed in SEEDS:
        got = control.readings(c, seed, card)
        assert not _fails(got["fp32"], c.workload["limits"])
        for variant in faults:
            assert _fails(got[variant], c.workload["limits"]), (variant, got)
