"""The scan trainer's graphed step of torch kernels (train/trainer.py): a
step's bound over its kernels' device time per step, in percent."""

import readers


def read(ctx):
    return readers.roofline_pct(ctx, readers.TORCH_STEP)
