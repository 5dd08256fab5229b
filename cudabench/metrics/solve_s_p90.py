"""The 90th percentile of every solve's own wall seconds in the window."""

import readers


def read(ctx):
    return readers.call_seconds_quantile(ctx, 0.9)
