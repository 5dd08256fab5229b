"""Milliseconds a solve spends capturing CUDA graphs: the program's
graph.capture spans inside it (ScanGraph, captured per call), averaged over
the solves no profiler touched."""

import spans


def read(ctx):
    return spans.span_ms(ctx, "graph.capture")
