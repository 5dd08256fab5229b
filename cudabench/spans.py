"""What the metrics that read the program's own spans share. The port
records its spans in ``differential_equations_dnn_tpu_torch.utils.trace``
(loaded in the run's process by the drivers) on ``time.perf_counter``, the
clock of the harness's ``Call.start`` and ``Call.end``. A program without
that registry (a tree older than it) gives None, and the harness leaves
the metric out."""

import sys

TRACE = "differential_equations_dnn_tpu_torch.utils.trace"


def registry():
    """The port's trace module, if the run's process has loaded it."""
    return sys.modules.get(TRACE)


def program_spans():
    """Every span the program kept, or None without a registry."""
    module = registry()
    return None if module is None else module.spans()


def ms_per_call(calls, spans, name):
    """Mean milliseconds a call spends in the spans named ``name`` that lie
    inside it, over ``calls``; None without spans or calls."""
    if spans is None or not calls:
        return None
    total = 0
    for s in spans:
        if s.name == name and any(c.start * 1e9 <= s.start_ns
                                  and s.end_ns <= c.end * 1e9
                                  for c in calls):
            total += s.end_ns - s.start_ns
    return total * 1e-6 / len(calls)


def span_ms(ctx, name):
    """:func:`ms_per_call` of the program's spans over the calls no
    profiler touched."""
    return ms_per_call(ctx.clean_calls, program_spans(), name)


def idle_intervals(sl):
    """The intervals ``(start_ns, end_ns)`` of a ``Slice`` in which no
    device operation ran (the gaps ``Slice.idle_gaps`` sums)."""
    gaps, edge = [], sl.start_ns
    for _, s, e in sorted(sl.clipped(), key=lambda op: op[1]):
        if s > edge:
            gaps.append((edge, s))
        edge = max(edge, e)
    if sl.end_ns > edge:
        gaps.append((edge, sl.end_ns))
    return gaps


def overlap_ns(gaps, intervals):
    """Nanoseconds of ``gaps`` (disjoint) that lie inside the union of
    ``intervals``."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return sum(max(0, min(g1, e) - max(g0, s))
               for g0, g1 in gaps for s, e in merged)


def idle_inside_pct(sl, spans, name, offset_ns):
    """The share of a slice's device-idle time that lies inside the spans
    named ``name``, mapped onto the slice's clock by ``offset_ns``, in
    percent; None without a slice, spans or idle time."""
    if sl is None or not sl.ops or spans is None:
        return None
    gaps = idle_intervals(sl)
    idle = sum(g1 - g0 for g0, g1 in gaps)
    if not idle:
        return None
    inside = overlap_ns(gaps, [(s.start_ns + offset_ns, s.end_ns + offset_ns)
                               for s in spans if s.name == name])
    return 100.0 * inside / idle


def replay_idle_pct(ctx):
    """The traced slice's idle time inside the program's ``graph.replay``
    spans, over all of its idle time, in percent."""
    module = registry()
    if module is None:
        return None
    return idle_inside_pct(ctx.trace, module.spans(), "graph.replay",
                           module.clock_offset_ns())
