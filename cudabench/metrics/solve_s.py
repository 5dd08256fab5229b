"""Wall seconds per solve: the window, from the first solve's start to the end
of the last solve that began in it, over the solves completed."""

import readers


def read(ctx):
    return readers.solve_s(ctx)
