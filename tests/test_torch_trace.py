"""The port's spans and counters (utils/trace.py): nesting, the ring's
bound, the spans the CPU paths record, each inside its parent, and their
place on a ``torch.profiler`` session's clock, where they leave no event
of their own."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from differential_equations_dnn_tpu_torch import solve  # noqa: E402
from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    Heat1D,
)
from differential_equations_dnn_tpu_torch.models import MLP  # noqa: E402
from differential_equations_dnn_tpu_torch.parallel import (  # noqa: E402
    PopulationConfig,
    train_population,
)
from differential_equations_dnn_tpu_torch.utils import trace  # noqa: E402


@pytest.fixture(autouse=True)
def fresh():
    trace.reset()
    yield
    trace.reset()


def _by_index():
    return sorted(trace.spans(), key=lambda s: s.index)


def _tree(spans):
    """(name, parent's name) of each span, in the order they opened."""
    names = {s.index: s.name for s in spans}
    return [(s.name, names.get(s.parent)) for s in spans]


def _nested(spans):
    """Every span with a parent lies inside it and shares its call."""
    by = {s.index: s for s in spans}
    for s in spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            p = by[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, s
            assert p.call_id == s.call_id


def test_nesting_parents_and_calls():
    with trace.span("a", k=1) as a:
        with trace.span("b"):
            with trace.span("c"):
                pass
        with trace.span("d"):
            pass
        a.attrs["late"] = 2
    with trace.span("e"):
        pass
    spans = _by_index()
    assert [s.name for s in trace.spans()] == ["c", "b", "d", "a", "e"]
    assert _tree(spans) == [("a", None), ("b", "a"), ("c", "b"), ("d", "a"),
                            ("e", None)]
    assert [s.index - spans[0].index for s in spans] == [0, 1, 2, 3, 4]
    assert len({s.call_id for s in spans[:4]}) == 1
    assert spans[4].call_id == spans[0].call_id + 1
    assert spans[0].attrs == {"k": 1, "late": 2}
    _nested(spans)


def test_a_span_closes_when_its_block_raises():
    with pytest.raises(ValueError):
        with trace.span("outer"):
            with trace.span("inner"):
                raise ValueError
    with trace.span("next"):
        pass
    assert _tree(_by_index()) == [("outer", None), ("inner", "outer"),
                                  ("next", None)]


def test_the_ring_keeps_the_last_spans_and_reset_clears_it():
    n = trace.RING_SPANS + 10
    for i in range(n):
        with trace.span("s", i=i):
            pass
    spans = trace.spans()
    assert len(spans) == trace.RING_SPANS
    assert [s.attrs["i"] for s in spans[:2]] == [10, 11]
    assert spans[-1].attrs["i"] == n - 1
    trace.reset()
    assert trace.spans() == []


def test_reset_forgets_spans_and_keeps_counters():
    before = trace.counters().get("test.count", 0)
    with trace.span("counted"):
        trace.count("test.count", 3)
    trace.count("test.count")
    trace.reset()
    assert trace.spans() == []
    assert trace.counters()["test.count"] == before + 4


def test_counters_report_the_kernel_wrappers_launches(monkeypatch):
    counts = trace.counters()
    wrappers = trace.wrappers()
    assert {f"launches.{fn.__name__}" for fn in wrappers} <= set(counts)
    engine = wrappers[2]
    assert engine.__name__ == "fused_engine_chunk"
    monkeypatch.setattr(engine, "step_math_runs", 1234)
    monkeypatch.setattr(engine, "bf16_launches", 5)
    counts = trace.counters()
    assert counts["step_math_runs.fused_engine_chunk"] == 1234
    assert counts["bf16_launches.fused_engine_chunk"] == 5


def _scan_solve():
    solve("heat", engine="scan", iterations=260, batch_size=8, nodes=5,
          seed=3, device="cpu")


def _fused_solve():
    solve("heat", engine="fused", iterations=60, batch_size=8, nodes=5,
          seed=3, device="cpu")


def _population():
    train_population(Heat1D(), MLP(2, 1, 8, 1, "tanh",
                                   generator=generator(0)), 3,
                     np.array([1e-3, 3e-3], np.float32), [8, 3],
                     PopulationConfig(iterations=40, max_batch_size=8),
                     device="cpu")


PATHS = {
    "scan_solve": (_scan_solve, [
        ("solve", None), ("solve.setup", "solve"), ("solve.train", "solve"),
        ("train.setup", "solve.train"), ("train.warmup", "solve.train"),
        ("train.draw", "solve.train"), ("train.eager", "solve.train"),
        ("train.draw", "solve.train"), ("train.eager", "solve.train"),
        ("train.fetch", "solve.train"), ("solve.eval", "solve")]),
    "fused_solve": (_fused_solve, [
        ("solve", None), ("solve.setup", "solve"), ("solve.train", "solve"),
        ("train.setup", "solve.train"), ("train.warmup", "solve.train"),
        ("train.draw", "solve.train"),
        ("train.chunk", "solve.train"), ("train.fetch", "solve.train"),
        ("solve.eval", "solve")]),
    "population": (_population, [
        ("train.draw", None), ("train.eager", None),
        ("train.draw", None), ("train.eager", None),
        ("train.fetch", None)]),
}


@pytest.mark.parametrize("path", sorted(PATHS))
def test_cpu_paths_record_their_spans(path):
    run, want = PATHS[path]
    run()
    spans = _by_index()
    assert _tree(spans) == want
    _nested(spans)
    steps = [s.attrs["steps"] for s in spans if s.name == "train.eager"]
    if path == "scan_solve":
        assert steps == [256, 4]
        assert spans[0].attrs == {"equation": "heat", "engine": "scan",
                                  "route": "scan", "ensemble": 0}
    elif path == "population":
        assert steps == [32, 8]
        assert len({s.call_id for s in spans}) == len(spans)
    else:
        chunk = next(s for s in spans if s.name == "train.chunk")
        assert chunk.attrs == {"precision": "highest", "steps": 60}
        assert spans[0].attrs["route"] == "heat"


def test_spans_sit_on_the_profilers_clock():
    """clock_offset_ns places a span on a profiler's clock: a mark opened
    first thing inside each span starts within 2 ms of the span's start
    mapped by it. The spans themselves leave no event in the session."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(3):
            with trace.span("marked", i=i):
                with torch.profiler.record_function(f"mark.{i}"):
                    pass
        _fused_solve()
    offset = trace.clock_offset_ns()
    events = {ev.name(): ev.start_ns()
              for ev in prof.profiler.kineto_results.events()}
    spans = trace.spans()
    assert not {s.name for s in spans} & set(events)
    assert not [n for n in events if n.startswith("dednn.")]
    marked = [s for s in spans if s.name == "marked"]
    assert len(marked) == 3
    for s in marked:
        gap = events[f"mark.{s.attrs['i']}"] - (s.start_ns + offset)
        assert abs(gap) < 2_000_000, gap


def test_no_record_function_without_a_profiler(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    _fused_solve()
    assert len(trace.spans()) == len(PATHS["fused_solve"][1])
