"""Milliseconds a solve spends outside its training steps (api.solve's init,
warm-up chunk, grid and MAE): the harness's clock around the call less
SolveResult.wall_time."""

import readers


def read(ctx):
    return readers.overhead_ms(ctx)
