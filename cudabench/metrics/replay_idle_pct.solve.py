"""The share of the traced slice's device-idle time that falls inside the
program's graph.replay spans (mapped onto the trace's clock), in percent:
how much of the idle device waits on the host's replays."""

import spans


def read(ctx):
    return spans.replay_idle_pct(ctx)
