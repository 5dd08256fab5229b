"""Milliseconds a solve spends in the training steps it runs outside a
CUDA graph (the last, partial block): the program's train.eager spans
inside it, averaged over the solves no profiler touched."""

import spans


def read(ctx):
    return spans.span_ms(ctx, "train.eager")
