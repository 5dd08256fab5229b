"""Counted operations of a training cell's completed steps (live rows only)
over the window's seconds and 67 TFLOP/s (fp32), in percent."""

import readers


def read(ctx):
    return readers.step_mfu_pct(ctx)
