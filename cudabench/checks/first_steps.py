"""The first training steps of every net a call trains, followed by the
plain reference from the call's seed and held against the losses the
program reported for them."""

import numpy as np

from reference import draws, pinn

STEPS = 3


def reference_losses(mix, cfg, seed, rows, device, lrate=None, steps=STEPS,
                     rows_used=None):
    """[nets, steps] losses of the reference following each net's first
    ``steps`` Adam steps (``lrate`` default: the configuration's). Net i
    trains on ``rows[i]`` rows; ``rows_used`` (default: the same) is how
    many of them its loss takes, for a planted fault that drops rows."""
    return reference_run(mix, cfg, seed, rows, device, lrate, steps,
                         rows_used)[0]


def reference_run(mix, cfg, seed, rows, device, lrate=None, steps=STEPS,
                  rows_used=None):
    """:func:`reference_losses` and each net's parameters after them."""
    lr = cfg["lrate"] if lrate is None else lrate
    used = rows if rows_used is None else rows_used
    losses, params = [], []
    for net, (r, n) in enumerate(zip(rows, used)):
        p0 = draws.initial(mix, cfg, seed, net, device)
        pts = [x[:n] for x in draws.batches(mix, cfg, seed, net, r, steps,
                                            device)]
        out, p = pinn.adam_steps(cfg, p0, pts, lr, steps)
        losses.append(out)
        params.append(p)
    return np.asarray(losses, np.float64), params


def gap(got, want):
    """The widest relative gap between the program's first losses ``got``
    [nets, ≥ steps] and the reference's ``want`` [nets, steps]."""
    got = np.asarray(got, np.float64)[:, :want.shape[1]]
    if got.shape != want.shape or not np.all(np.isfinite(got)):
        return float("inf")
    return float(np.max(np.abs(got - want) / np.abs(want)))


def bad_losses(losses, nets, steps):
    """How far the loss history falls short of ``nets`` × ``steps`` finite
    losses: 0 when the program reported every step of every net."""
    losses = np.asarray(losses, np.float64)
    if losses.shape != (nets, steps):
        return float(abs(nets * steps - losses.size) or 1)
    return float(np.count_nonzero(~np.isfinite(losses)))
