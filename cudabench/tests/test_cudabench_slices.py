"""The trace reduction and the readers on a made-up trace: kernels that
overlap count once in the busy time, idle gaps are named by the runtime
call in flight, and steps are the traced calls' own or the traced graph
replays times the program's steps a replay."""

import pytest

import harness
import readers
from slices import Slice

MS = 1_000_000


def _slice():
    ops = [("k_a loss_sum_kernel", 0, 2 * MS), ("k_b", 1 * MS, 3 * MS),
           ("k_a loss_sum_kernel", 5 * MS, 6 * MS),
           ("Memcpy HtoD", 6 * MS, 7 * MS), ("late", 9 * MS, 12 * MS)]
    runtime = [("cudaGraphLaunch", 3 * MS, 5 * MS),
               ("cudaStreamSynchronize", 7 * MS, 10 * MS)]
    return Slice(0, 10 * MS, ops, runtime)


def test_busy_idle_and_gaps():
    s = _slice()
    assert s.window_s == pytest.approx(0.010)
    assert s.busy_s() == pytest.approx(0.006)  # 0-3, 5-7, 9-10 ms
    assert s.busy_s(s.matching("loss_sum")) == pytest.approx(0.003)
    assert s.count("loss_sum_kernel") == 2
    gaps = dict(s.idle_gaps())
    assert gaps == pytest.approx({"cudaGraphLaunch": 0.002,
                                  "cudaStreamSynchronize": 0.002})
    assert s.top_ops(1) == [["k_a loss_sum_kernel", pytest.approx(0.003)]]


def test_readers_on_the_slice():
    cell = harness.load_cell("heat1d.fused.solve")
    calls = [harness.Call(1, 0.0, 1.0, None, 15000, [64], 0.9),
             harness.Call(2, 1.0, 2.0, None, 15000, [64], 0.9),
             harness.Call(3, 2.0, 4.0, None, 2, [64], 1.9)]
    f, b = harness.step_cost(cell)
    ctx = harness.Context(cell, calls, 0.0, 4.0, 9.0, _slice(), f, b, 2)
    assert readers.solve_s(ctx) == pytest.approx(4.0 / 3)
    assert ctx.steps_in_trace() == 2  # the traced call's, not a kernel's
    assert readers.net_steps_per_s(ctx) == pytest.approx(30002 / 4.0)
    assert readers.overhead_ms(ctx) == pytest.approx(100.0)
    assert readers.step_mfu_pct(ctx) == pytest.approx(
        100 * 30000 * f / 2.0 / 67e12)
    assert readers.device_idle_pct(ctx) == pytest.approx(40.0)
    assert readers.kernels_per_step(ctx) == pytest.approx(4 / 2)
    assert readers.roofline_pct(ctx, "loss_sum") == pytest.approx(
        100 * 1.993e-6 / 0.0015, rel=1e-3)


@pytest.mark.parametrize("cell, constant", [
    ("heat1d.scan.solve", "train.trainer:GRAPH_STEPS"),
    ("heat1d.population.batch_sizes", "parallel.population:GRAPH_STEPS")])
def test_replays_count_the_programs_steps_per_replay(cell, constant):
    c = harness.load_cell(cell)
    assert c.workload["replay_steps"] == constant
    per_replay = harness.program_constant(constant)
    traced = _slice()
    traced.replays = 3
    ctx = harness.Context(c, [], 0.0, 1.0, 1.0, traced, 1.0, 1.0, 1)
    assert ctx.steps_in_trace() == 3 * per_replay
    assert readers.kernels_per_step(ctx) == pytest.approx(
        4 / (3 * per_replay))


def test_replays_mode_traces_its_replays_and_unhooks(monkeypatch):
    import torch

    import slices

    class Graph:
        replays = 0

        def replay(self):
            Graph.replays += 1

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    original = Graph.replay
    rec = slices.SliceRecorder({"mode": "replays", "from_call": 1,
                                "skip": 1, "replays": 2})
    rec.before_call(0)
    Graph().replay()
    assert Graph.replay is original and rec.result is None
    rec.before_call(1)
    for _ in range(5):
        Graph().replay()
    assert Graph.replays == 6
    assert Graph.replay is original
    traced = rec.finish()
    assert isinstance(traced, slices.Slice)
    assert traced.replays == 2
