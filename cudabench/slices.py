"""The device trace of a run: a slice of the measured window recorded by
``torch.profiler`` (CUPTI), reduced to kernel intervals.

A whole window of some cells holds millions of kernels, more than the
profiler can hold and reduce within a run's time limit, so a traced run
records a fixed part of it, set in the cell's file (see
:class:`SliceRecorder`).
"""

import bisect
import re
from dataclasses import dataclass, field

import torch

DEVICE_KINDS = ("cuda",)
# Marks at the traced part's two ends, in the profiler's own clock.
OPEN, CLOSE = "cudabench.slice.open", "cudabench.slice.close"


@dataclass
class Slice:
    """Device operations ``(name, start_ns, end_ns)`` in the traced slice,
    the host's CUDA runtime calls likewise, the slice's bounds and, in the
    "replays" mode, the graph replays it holds."""
    start_ns: int
    end_ns: int
    ops: list = field(default_factory=list)
    runtime: list = field(default_factory=list)
    replays: int = 0

    @property
    def window_s(self):
        return (self.end_ns - self.start_ns) * 1e-9

    def clipped(self, ops=None):
        """``ops`` (default: all) cut to the slice's bounds."""
        out = []
        for name, s, e in self.ops if ops is None else ops:
            s, e = max(s, self.start_ns), min(e, self.end_ns)
            if e > s:
                out.append((name, s, e))
        return out

    def matching(self, pattern):
        """Device operations whose name matches ``pattern`` (a regex)."""
        rx = re.compile(pattern)
        return [op for op in self.ops if rx.search(op[0])]

    def count(self, pattern):
        """Operations matching ``pattern`` that start inside the slice."""
        return sum(1 for _, s, _ in self.matching(pattern)
                   if self.start_ns <= s < self.end_ns)

    def busy_s(self, ops=None):
        """Seconds of the slice in which at least one of ``ops`` (default:
        every device operation) ran: the union of their intervals."""
        total, cur_s, cur_e = 0, None, None
        for _, s, e in sorted(self.clipped(ops), key=lambda op: op[1]):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    total += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        if cur_e is not None:
            total += cur_e - cur_s
        return total * 1e-9

    def top_ops(self, n=10):
        """The ``n`` device operations that took most time, by name."""
        by_name = {}
        for name, s, e in self.clipped():
            by_name[name] = by_name.get(name, 0) + (e - s)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns * 1e-9] for name, ns in top]

    def idle_gaps(self, n=10):
        """Idle time of the device summed by what the host was doing: the
        CUDA runtime call that overlaps most of each gap (or "host
        compute" where none does); the ``n`` largest sums."""
        ops = sorted(self.clipped(), key=lambda op: op[1])
        gaps, edge = [], self.start_ns
        for _, s, e in ops:
            if s > edge:
                gaps.append((edge, s))
            edge = max(edge, e)
        if self.end_ns > edge:
            gaps.append((edge, self.end_ns))
        runtime = sorted(self.runtime, key=lambda op: op[1])
        starts = [s for _, s, _ in runtime]
        longest = max((e - s for _, s, e in runtime), default=0)
        by_name = {}
        for g0, g1 in gaps:
            best, best_ns = "host compute", 0
            lo = bisect.bisect_left(starts, g0 - longest)
            for name, s, e in runtime[lo:bisect.bisect_right(starts, g1)]:
                ov = min(e, g1) - max(s, g0)
                if ov > best_ns:
                    best, best_ns = name, ov
            by_name[best] = by_name.get(best, 0) + (g1 - g0)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:200], ns * 1e-9] for name, ns in top]


class SliceRecorder:
    """Records the traced part of a window, in one of two modes (the cell's
    ``mode``):

    * "calls": the whole calls ``from_call .. from_call + calls − 1``, on
      the main thread, which starts the profiler before the first of them
      and stops it after the last. For calls whose kernels fit the
      profiler, and the only mode that sees the kernels the port launches
      from its own library (CUPTI drops those of a thread other than the
      profiler's);
    * "replays": the graph replays ``skip .. skip + replays − 1`` of the
      call ``from_call`` (``torch.cuda.CUDAGraph.replay``, which the scan
      trainer and the population replay their steps by), on the main
      thread, from just before the first of them to just before the next.
      For calls of torch kernels too long to trace whole.

    A profiler started or stopped from another thread loses kernels or
    hangs (Kineto initialises on the thread that loaded torch), so both
    modes run it on the main thread. Marks recorded there give the traced
    part's ends in the profiler's clock."""

    def __init__(self, spec):
        self.mode = spec["mode"]
        self.from_call = int(spec["from_call"])
        self.n_calls = int(spec.get("calls", 0))
        self.skip = int(spec.get("skip", 0))
        self.n_replays = int(spec.get("replays", 0))
        self.result = None
        self._prof = self._replay = None
        self._seen = 0

    def before_call(self, index):
        """The window's hook before call ``index``."""
        if self.mode == "calls":
            if index == self.from_call:
                self._prof = _open()
            elif index == self.from_call + self.n_calls:
                self._close()
        elif index == self.from_call:
            self._hook_replays()
        elif index == self.from_call + 1:
            self._close()

    def _hook_replays(self):
        graph = torch.cuda.CUDAGraph
        original = self._replay = graph.replay
        recorder = self

        def replay(self_):
            if recorder._seen == recorder.skip:
                recorder._prof = _open()
            elif recorder._seen == recorder.skip + recorder.n_replays:
                recorder._close()
            recorder._seen += 1
            return original(self_)

        graph.replay = replay

    def _close(self):
        if self._replay is not None:
            torch.cuda.CUDAGraph.replay = self._replay
            self._replay = None
        if self._prof is not None and self.result is None:
            _mark(CLOSE)
            self._prof.stop()
            self.result = reduce(self._prof)
            if self.mode == "replays":
                self.result.replays = min(self._seen - self.skip,
                                          self.n_replays)

    def finish(self):
        """The traced part, once the window has closed (None if the window
        closed before it began)."""
        self._close()
        return self.result


def _mark(name):
    with torch.profiler.record_function(name):
        pass


def _open():
    prof = torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
    prof.start()
    _mark(OPEN)
    return prof


def _events(prof):
    """(name, kind, start_ns, end_ns) of every recorded event."""
    for ev in prof.profiler.kineto_results.events():
        yield (ev.name(), str(ev.device_type()).split(".")[-1].lower(),
               ev.start_ns(), ev.end_ns())


def reduce(prof):
    """The device operations and the host's CUDA runtime calls of a
    stopped profiler, between its two marks."""
    ops, runtime, marks = [], [], {}
    for name, kind, s, e in _events(prof):
        if name in (OPEN, CLOSE):
            marks[name] = s
        elif kind in DEVICE_KINDS:
            ops.append((name, s, e))
        elif name.startswith("cu"):
            runtime.append((name, s, e))
    if OPEN not in marks or CLOSE not in marks:
        raise RuntimeError("the profiler recorded no slice marks")
    return Slice(marks[OPEN], marks[CLOSE], ops, runtime)
