"""Milliseconds a training call spends capturing CUDA graphs: the
program's graph.capture spans inside it (the population's, per call),
averaged over the calls no profiler touched."""

import spans


def read(ctx):
    return spans.span_ms(ctx, "graph.capture")
