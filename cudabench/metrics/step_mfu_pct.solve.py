"""Counted operations of a solve cell's completed training steps over the
window's seconds and 67 TFLOP/s (fp32), in percent."""

import readers


def read(ctx):
    return readers.step_mfu_pct(ctx)
