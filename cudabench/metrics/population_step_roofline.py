"""The population step's vmapped torch kernels (parallel/population.py): the
live rows' bound over the kernels' device time per step, in percent."""

import readers


def read(ctx):
    return readers.roofline_pct(ctx, readers.TORCH_STEP)
