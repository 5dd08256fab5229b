"""Kernel #5 around #7 (csrc/dgm_train.cu): a packed step's bound over the
device time of its kernels per step, in percent."""

import readers


def read(ctx):
    return readers.roofline_pct(ctx, readers.FUSED_STEP)
