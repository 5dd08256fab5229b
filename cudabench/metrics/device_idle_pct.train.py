"""The share of the traced slice of a training cell in which no operation ran
on the device, in percent."""

import readers


def read(ctx):
    return readers.device_idle_pct(ctx)
