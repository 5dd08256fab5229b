"""Kernel #1 (csrc/heat_train.cu): a step's bound over the device time of its
kernels per step, in percent."""

import readers


def read(ctx):
    return readers.roofline_pct(ctx, readers.FUSED_STEP)
