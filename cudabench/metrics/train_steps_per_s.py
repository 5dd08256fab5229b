"""Net-steps per second: Adam steps times the nets each advances, summed over
the window's calls, over the window's seconds."""

import readers


def read(ctx):
    return readers.net_steps_per_s(ctx)
