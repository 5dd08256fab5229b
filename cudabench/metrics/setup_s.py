"""Seconds from process start to the window's start: imports, the card's
context, the kernels' build or load, weights and one warm-up call at the
cell's shapes."""

import readers


def read(ctx):
    return readers.setup_s(ctx)
