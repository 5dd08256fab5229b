"""A run with its timed path broken underneath comes out not correct: each
cell is driven on the CPU at a small size (the port's plain versions), past
the harness's look for a card, once sound and once with each fault the cell
can have planted in the program: a step that returns its state unchanged,
half of each batch left out (the mean over the rest), an answer altered
where it is produced (the solution's grid, or a training call's losses)
and, in a training cell, a state that stops advancing after the first
steps (as after a CUDA graph's first replay on the card). A single card
has no exchange between chips to leave out. The training cells run 128
steps on two replicas or six trials, with the program's graph length
taken as 8 steps (its constant patched: the CPU replays no graphs), so a
call runs far past its first replay as the card's calls do."""

import math

import pytest
import torch

import run
from differential_equations_dnn_tpu_torch.equations import Heat1D
from differential_equations_dnn_tpu_torch.kernels import (
    fused_dgm,
    fused_train,
    graphs,
    taylor_mlp,
)
from differential_equations_dnn_tpu_torch.parallel import population
from differential_equations_dnn_tpu_torch.train import trainer

SMALL = {
    "heat1d.fused.solve": {"cfg": {"iterations": 12},
                           "mix": {"warmup_iterations": 2}},
    "heat1d.scan.solve": {"cfg": {"iterations": 12},
                          "mix": {"warmup_iterations": 2}},
    "fhn.fused.ensemble16": {
        "cfg": {"iterations": 128},
        "mix": {"warmup_iterations": 2, "net_rows": [[100, 2]],
                "args": {"n_replicas": 2, "chunk_size": 25000}}},
    "heat1d.population.batch_sizes": {
        "cfg": {"ablation_iterations": 128},
        "mix": {"warmup_iterations": 2,
                "net_rows": [[1, 2], [8, 2], [64, 2]],
                "args": {"batch_sizes": [1, 8, 64], "runs": 2}}},
}
ALTERED = 1.0 + 1e-3
# Steps a frozen-late state still takes: the three that loss_gap follows.
FIRST = 3


@pytest.fixture(autouse=True)
def short_graphs(monkeypatch):
    monkeypatch.setattr(graphs, "GRAPH_STEPS", 8)
    monkeypatch.setattr(population, "GRAPH_STEPS", 8)


def drive(cell):
    return run.main(["--workload", cell, "--seed", "2147483701",
                     "--seconds", "0.01", "--trace", "0"], device="cpu",
                    require_card=False, overrides=SMALL[cell])


def frozen_after(chunk, at, first):
    """``chunk`` whose state stops advancing after its first ``first``
    steps: each later step runs one a call from the state those left, and
    hands that state back (``first`` = 0: a step that returns its state
    unchanged). ``at`` is the position of (params, m, v, uniforms, step0)
    in its arguments."""

    def broken(*args, **kwargs):
        args = list(args)
        u, step0 = args[at + 3], args[at + 4]
        losses = []
        if first:
            args[at + 3] = u[:first]
            *state, head = chunk(*args, **kwargs)
            args[at:at + 3] = state
            losses.append(head)
        for k in range(first, u.shape[0]):
            args[at + 3:at + 5] = [u[k:k + 1], step0 + k]
            losses.append(chunk(*args, **kwargs)[3])
        return (*args[at:at + 3], torch.cat(losses, -1))

    return broken


def half_batch(chunk, at):
    """``chunk`` on the first half of each step's rows."""

    def broken(*args, **kwargs):
        args = list(args)
        u = args[at + 3]
        args[at + 3] = u[:, :u.shape[1] // 2].contiguous()
        return chunk(*args, **kwargs)

    return broken


def scaled_losses(chunk):
    def broken(*args, **kwargs):
        p, m, v, losses = chunk(*args, **kwargs)
        return p, m, v, losses * ALTERED

    return broken


def altered_grid(monkeypatch):
    orig = taylor_mlp.mlp_forward
    monkeypatch.setattr(taylor_mlp, "mlp_forward",
                        lambda *a, **k: orig(*a, **k) * ALTERED)


def plant(monkeypatch, cell, fault):
    if cell == "heat1d.fused.solve":
        chunk = fused_train.heat_fused_train_chunk
        target = {"unchanged": lambda: frozen_after(chunk, 1, 0),
                  "half_batch": lambda: half_batch(chunk, 1)}
        if fault == "altered":
            return altered_grid(monkeypatch)
        monkeypatch.setattr(fused_train, "heat_fused_train_chunk",
                            target[fault]())
    elif cell == "fhn.fused.ensemble16":
        chunk = fused_dgm.fused_dgm_packed_chunk
        target = {"unchanged": lambda: frozen_after(chunk, 2, 0),
                  "frozen_late": lambda: frozen_after(chunk, 2, FIRST),
                  "half_batch": lambda: half_batch(chunk, 2),
                  "altered": lambda: scaled_losses(chunk)}
        monkeypatch.setattr(fused_dgm, "fused_dgm_packed_chunk",
                            target[fault]())
    elif cell == "heat1d.scan.solve":
        if fault == "altered":
            return altered_grid(monkeypatch)
        if fault == "unchanged":
            orig = trainer.make_optimizer

            def frozen(config, params, fused=None):
                opt = orig(config, params, fused)
                for group in opt.param_groups:
                    group["lr"] = 0.0
                return opt

            monkeypatch.setattr(trainer, "make_optimizer", frozen)
        else:
            orig = Heat1D.point_loss
            monkeypatch.setattr(
                Heat1D, "point_loss",
                lambda self, model, batch: orig(self, model, batch)[
                    :batch["xt"].shape[0] // 2])
    else:
        orig = population.make_population_step

        def broken(problem, model, params, state, opt_state, lr, mask):
            if fault == "unchanged":
                lr = lr * 0.0
            if fault == "half_batch":
                live = mask.sum(1, keepdim=True)
                idx = torch.arange(mask.shape[1], device=mask.device)
                mask = idx[None, :] < torch.div(live + 1, 2,
                                                rounding_mode="floor")
            if fault == "frozen_late":
                lr = lr.clone()
            step = orig(problem, model, params, state, opt_state, lr, mask)
            if fault == "altered":
                return lambda batch: step(batch) * ALTERED
            if fault != "frozen_late":
                return step
            taken = [0]

            def frozen_late(batch):
                losses = step(batch)
                taken[0] += 1
                if taken[0] == FIRST:
                    lr.zero_()
                return losses

            return frozen_late

        monkeypatch.setattr(population, "make_population_step", broken)


CELLS = list(SMALL)
TRAINING = ["fhn.fused.ensemble16", "heat1d.population.batch_sizes"]


@pytest.mark.parametrize("cell", CELLS)
def test_sound_run_passes_every_comparison(cell):
    result = drive(cell)
    for name, r in result["checks"].items():
        if name != "mae":  # a few steps train nothing worth its limit
            assert r["value"] <= r["limit"], (name, r)


@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
@pytest.mark.parametrize("cell", CELLS)
def test_fault_makes_the_run_not_correct(monkeypatch, cell, fault):
    plant(monkeypatch, cell, fault)
    result = drive(cell)
    assert result["correct"] is False
    gaps = [r["value"] > r["limit"] for name, r in result["checks"].items()
            if name != "mae"]
    assert any(gaps), result["checks"]
    assert result["failed"] == result["attempted"] >= 1
    assert all(math.isfinite(r["limit"]) for r in result["checks"].values())


@pytest.mark.parametrize("cell", TRAINING)
def test_state_frozen_after_the_first_steps_is_caught_at_the_end(
        monkeypatch, cell):
    plant(monkeypatch, cell, "frozen_late")
    result = drive(cell)
    checks = result["checks"]
    assert result["correct"] is False
    assert checks["loss_gap"]["value"] <= checks["loss_gap"]["limit"]
    ends = [n for n in ("end_loss", "net_loss") if n in checks]
    assert all(checks[n]["value"] > checks[n]["limit"] for n in ends), checks
