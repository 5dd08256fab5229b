"""Device kernels per training step in the traced slice of a solve cell."""

import readers


def read(ctx):
    return readers.kernels_per_step(ctx)
