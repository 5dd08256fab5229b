"""Milliseconds a solve spends drawing its training batches on the host:
the program's train.draw spans inside it (one per block of steps),
averaged over the solves no profiler touched."""

import spans


def read(ctx):
    return spans.span_ms(ctx, "train.draw")
