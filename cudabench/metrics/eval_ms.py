"""Milliseconds a solve spends evaluating its net on the grid and taking
the MAE: the program's solve.eval spans inside it, averaged over the
solves no profiler touched."""

import spans


def read(ctx):
    return spans.span_ms(ctx, "solve.eval")
