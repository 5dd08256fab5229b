"""The readers of the program's spans on made-up calls, spans and a
made-up trace: each keeps the spans inside the calls no profiler touched
and averages over them, the replays' share of the idle device counts the
part of a gap a replay span covers, and a program without the registry
gives no reading."""

import time
from types import SimpleNamespace

import pytest

import harness
import spans
from slices import Slice

MS = 1_000_000
S = 1_000_000_000
# Where the made-up profiler clock stands against perf_counter_ns.
OFFSET = 1_700_000_000 * S


def _span(name, t0, t1):
    return SimpleNamespace(name=name, start_ns=int(t0), end_ns=int(t1))


SPANS = [
    # Call 0 (1-2 s) and call 1 (2-4 s): the calls no profiler touched.
    _span("graph.capture", 1.1 * S, 1.3 * S),
    _span("train.draw", 1.40 * S, 1.45 * S),
    _span("graph.replay", 1.5 * S, 1.6 * S),
    _span("train.eager", 1.70 * S, 1.71 * S),
    _span("solve.eval", 1.90 * S, 1.92 * S),
    _span("graph.capture", 2.1 * S, 2.2 * S),
    _span("train.draw", 2.30 * S, 2.33 * S),
    _span("graph.replay", 2.5 * S, 2.8 * S),
    _span("solve.eval", 3.90 * S, 3.94 * S),
    # Outside every call, across two calls, in the traced call (4-5 s).
    _span("graph.capture", 0.5 * S, 0.6 * S),
    _span("graph.capture", 1.95 * S, 2.05 * S),
    _span("graph.capture", 4.1 * S, 4.5 * S),
    # The traced slice's replay, 3.5-7.5 ms into the slice.
    _span("graph.replay", 4_203.5 * MS, 4_207.5 * MS),
]

# Mean ms over calls 0 and 1.
WANT = {"capture_ms.solve": 150.0, "capture_ms.train": 150.0,
        "host_draw_ms.solve": 40.0, "host_draw_ms.train": 40.0,
        "replay_host_ms.solve": 200.0, "eager_ms.solve": 5.0,
        "eval_ms": 30.0,
        # Idle 2-5 and 6-9 ms of the slice; the replay covers 3.5-7.5.
        "replay_idle_pct.solve": 50.0}


def _slice():
    t0 = OFFSET + 4_200 * MS
    ops = [("a", t0, t0 + 2 * MS), ("b", t0 + 5 * MS, t0 + 6 * MS),
           ("c", t0 + 9 * MS, t0 + 10 * MS)]
    return Slice(t0, t0 + 10 * MS, ops, [])


def _ctx(cell="heat1d.scan.solve"):
    calls = [harness.Call(1, 1.0, 2.0, None, 10, [64], 0.5),
             harness.Call(2, 2.0, 4.0, None, 10, [64], 0.5),
             harness.Call(3, 4.0, 5.0, None, 10, [64], 0.5)]
    return harness.Context(harness.load_cell(cell), calls, 1.0, 5.0, 9.0,
                           _slice(), 0.0, 0.0, 2)


@pytest.fixture
def program(monkeypatch):
    module = SimpleNamespace(spans=lambda: list(SPANS),
                             clock_offset_ns=lambda: OFFSET)
    monkeypatch.setattr(spans, "registry", lambda: module)
    return module


@pytest.mark.parametrize("metric", sorted(WANT))
def test_each_reader_on_made_up_spans(program, metric):
    got = harness.load_module("metrics", metric).read(_ctx())
    assert got == pytest.approx(WANT[metric])


@pytest.mark.parametrize("metric", sorted(WANT))
def test_no_registry_no_reading(monkeypatch, metric):
    monkeypatch.setattr(spans, "registry", lambda: None)
    assert harness.load_module("metrics", metric).read(_ctx()) is None


def test_a_registry_with_no_such_span_reads_zero(program):
    program.spans = lambda: [s for s in SPANS if s.name != "train.eager"]
    read = harness.load_module("metrics", "eager_ms.solve").read
    assert read(_ctx()) == 0.0


def test_an_idle_gap_half_inside_a_replay():
    sl = _slice()
    t0 = sl.start_ns
    assert spans.idle_intervals(sl) == [(t0 + 2 * MS, t0 + 5 * MS),
                                        (t0 + 6 * MS, t0 + 9 * MS)]
    half = [_span("graph.replay", 3.5 * MS, 5.5 * MS)]  # half of gap 1
    assert spans.idle_inside_pct(sl, half, "graph.replay", t0) == \
        pytest.approx(25.0)
    both = half + [_span("graph.replay", 5 * MS, 7 * MS)]  # overlapping
    assert spans.idle_inside_pct(sl, both, "graph.replay", t0) == \
        pytest.approx(100 * 2.5 / 6)
    assert spans.idle_inside_pct(sl, [], "graph.replay", t0) == 0.0
    busy = Slice(t0, t0 + 2 * MS, [("a", t0, t0 + 2 * MS)], [])
    assert spans.idle_inside_pct(busy, half, "graph.replay", t0) is None
    assert spans.idle_inside_pct(None, half, "graph.replay", t0) is None


def test_the_harness_reads_the_new_metrics_in_their_cells(program):
    names = {"heat1d.scan.solve": {"capture_ms.solve", "host_draw_ms.solve",
                                   "replay_host_ms.solve", "eager_ms.solve",
                                   "eval_ms", "replay_idle_pct.solve"},
             "heat1d.fused.solve": {"eval_ms"},
             "heat1d.population.batch_sizes": {"capture_ms.train",
                                               "host_draw_ms.train"},
             "fhn.fused.ensemble16": set()}
    for cell, want in names.items():
        ctx = _ctx(cell)
        spanned = {m["name"] for m in ctx.cell.per_layer
                   if m["source"] == "program_span"
                   and m["name"] != "solve_overhead_ms"}
        assert spanned == want, cell
        got = harness.read_metrics(ctx, [m for m in ctx.cell.per_layer
                                         if m["name"] in want])
        assert {k: v["value"] for k, v in got.items()} == pytest.approx(
            {k: WANT[k] for k in want})


def test_the_programs_own_spans_inside_a_call():
    """A CPU solve of the port records a solve.eval span inside the call
    the harness times around it, on the same clock."""
    from differential_equations_dnn_tpu_torch import solve

    start = time.perf_counter()
    solve("heat", engine="fused", iterations=4, batch_size=8, nodes=5,
          seed=1, device="cpu")
    call = harness.Call(1, start, time.perf_counter(), None, 4, [8], None)
    assert spans.registry() is not None
    got = spans.ms_per_call([call], spans.program_spans(), "solve.eval")
    assert 0 < got < 1e3 * (call.end - call.start)
