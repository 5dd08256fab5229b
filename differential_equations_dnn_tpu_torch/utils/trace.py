"""Spans and counters of the port's layers, in one registry per process.

    from differential_equations_dnn_tpu_torch.utils import trace

    with trace.span("solve.eval", nodes=40):
        ...
    trace.count("graph.captures.scan")
    trace.spans(), trace.counters(), trace.reset()

A span records ``(name, call_id, parent, start_ns, end_ns, attrs)`` and
its own ``index`` into a ring of the last RING_SPANS spans, on
``time.perf_counter_ns()``, the clock a caller times its calls by. The
outermost open span opens a new ``call_id``; a nested span carries its
call's id and its parent's index. Spans sit at layer boundaries only (a
call, a phase, a block of graph steps), never around a step or a kernel,
so a call records tens to hundreds of them. A span adds no device work
and waits for nothing: what it encloses is timed on the host, and a wait
for the device shows only where the enclosed code already waits.

A span leaves no mark in a ``torch.profiler`` session: a
``record_function`` range that encloses kernels is copied onto the
device's timeline as an event of its own, which a trace's readers would
count as device work. :func:`clock_offset_ns` maps a span's times onto
the profiler's clock (Unix-epoch nanoseconds) instead, which the device's
events in that trace share.

Every rank is a process of its own and spans open on the main thread
only, so the stack of open spans is the module's.
"""

import collections
import time
from typing import NamedTuple

# Spans kept: a long process keeps its last RING_SPANS.
RING_SPANS = 65_536


class Span(NamedTuple):
    name: str
    call_id: int
    parent: int | None      # the enclosing span's index; None outermost
    start_ns: int           # time.perf_counter_ns()
    end_ns: int
    attrs: dict
    index: int              # in the order spans opened, from 0 a process


_ring: collections.deque = collections.deque(maxlen=RING_SPANS)
_open: list = []            # (index, call_id) of each open span
_counts: dict = {}
_next_index = 0
_next_call = 0


class span:
    """``with span(name, **attrs) as s:`` records one span; ``s.attrs``
    may gain entries before the block ends."""

    __slots__ = ("name", "attrs", "_index", "_call", "_parent", "_start")

    def __init__(self, name, **attrs):
        self.name = name
        self.attrs = attrs

    def __enter__(self):
        global _next_index, _next_call
        if _open:
            self._parent, self._call = _open[-1]
        else:
            self._parent, self._call = None, _next_call
            _next_call += 1
        self._index = _next_index
        _next_index += 1
        _open.append((self._index, self._call))
        self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.pop()
        _ring.append(Span(self.name, self._call, self._parent, self._start,
                          end, self.attrs, self._index))
        return False


def spans():
    """The recorded spans, oldest first by their end."""
    return list(_ring)


def reset():
    """Forget the recorded spans (counters keep counting)."""
    _ring.clear()


def clock_offset_ns():
    """``time.time_ns() − time.perf_counter_ns()``, read as a pair: add it
    to a span's times to place them on the profiler's clock."""
    return time.time_ns() - time.perf_counter_ns()


def count(name, n=1):
    _counts[name] = _counts.get(name, 0) + n


def wrappers():
    """The wrappers of the port's hand-written kernels, whose launch
    counters (function attributes, ``fused_train.count_launch``) report
    through :func:`counters`."""
    from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd
    from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe
    from differential_equations_dnn_tpu_torch.kernels import fused_train as ft
    from differential_equations_dnn_tpu_torch.kernels import taylor_mlp as tm

    return [tm.mlp_forward, ft.heat_fused_train_chunk, fe.fused_engine_chunk,
            fe.engine_loss_grad, fd.fused_dgm_chunk, fd.dgm_loss_grad,
            fe.fused_engine_packed_chunk, fd.fused_dgm_packed_chunk,
            tm.heat_fused_streams]


# The wrappers' counting attributes, reported as "<attribute>.<wrapper>".
LAUNCH_COUNTS = ("launches", "bf16_launches", "sweep_launches",
                 "step_math_runs", "bf16_step_math_runs")


def counters():
    """Every counter's total: those of :func:`count` (``graph.captures.
    <trainer>``, ``graph.replays.<trainer>``, ``graph.evictions``, and
    ``graph.reuses.<trainer>``: the calls of the scan and population
    trainers served by a cached graph) and the kernel wrappers' launch
    counts."""
    out = dict(_counts)
    for fn in wrappers():
        for attr in LAUNCH_COUNTS:
            if hasattr(fn, attr):
                out[f"{attr}.{fn.__name__}"] = getattr(fn, attr)
    return out
