"""Host milliseconds a solve spends in its CUDA-graph replays (the static
copies and the graph launches): the program's graph.replay spans inside
it, averaged over the solves no profiler touched."""

import spans


def read(ctx):
    return spans.span_ms(ctx, "graph.replay")
