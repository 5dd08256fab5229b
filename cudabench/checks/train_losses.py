"""A training call's answer held against the plain reference: the first
three steps of every net it trains (each replica or trial from its own
initial weights and draws, under its own batch), how far its training got
past its first graph replay by the end of the call, and the count of its
losses.

The reference follows each net's first ``G`` steps, ``G`` the steps one of
the program's graph replays advances (the cell's ``replay_steps``).
Numbers: ``loss_gap`` (the widest relative gap of the first three losses
over all nets), ``end_loss`` (the program's losses over each net's last
``TAIL`` steps against the losses of the reference's net after G steps on
the same batches), ``net_loss`` (where the answer returns its nets: the
reference's loss of each returned net on its step-0 batch against that of
the reference's net after G steps) and ``bad_losses`` (missing or
non-finite losses). A state that stops advancing after the first replay
reads 1 in ``end_loss`` and ``net_loss``, to rounding; a call that trains
on reads less. Following G steps of every net takes tens of seconds, so
a run reads these two on one of its calls (``DEEP``)."""

import numpy as np

import harness
from checks import first_steps
from reference import draws, nets, pinn

# Steps at the end of a call whose losses ``end_loss`` compares.
TAIL = 32
# The numbers the harness reads on one call of a run.
DEEP = ("end_loss", "net_loss")


def losses_of(mix, answer):
    """[nets, steps] losses of a call's answer: a TrainResult's
    ``loss_history`` or an AblationResult's ``all_losses`` flattened to
    trials (trial i·runs + r is run r of batch size i)."""
    losses = np.asarray(getattr(answer, mix["losses"]), np.float64)
    return losses.reshape(-1, losses.shape[-1])


def end_loss(losses, base_losses):
    """The mean of each net's losses over its last ``TAIL`` steps, summed
    over the nets, over the same of ``base_losses`` [nets, TAIL], the
    losses of the reference's nets after G steps on those steps' batches
    (summed, so a trial of one row weighs no more than its loss)."""
    losses = np.asarray(losses, np.float64)
    if losses.shape[0] != len(base_losses) or losses.shape[1] < TAIL:
        return float("inf")
    return float(np.sum(np.mean(losses[:, -TAIL:], 1))
                 / np.sum(np.mean(base_losses, 1)))


def late_losses(mix, cfg, seed, rows, params, steps, device):
    """[nets, TAIL] reference losses of the nets ``params`` on each net's
    batches of a ``steps``-step call's last ``TAIL`` steps."""
    return np.asarray(
        [[float(pinn.loss(cfg, p, x).detach())
          for x in draws.batches(mix, cfg, seed, net, r, TAIL, device,
                                 start=steps - TAIL)]
         for net, (r, p) in enumerate(zip(rows, params))], np.float64)


def net_loss(mix, cfg, seed, rows, params, base, device):
    """The reference's loss of each net in ``params`` (dicts by the
    program's names) on its step-0 batch, summed, over the same of the
    nets ``base``."""
    got = want = 0.0
    for net, (r, p, q) in enumerate(zip(rows, params, base)):
        pts = draws.batches(mix, cfg, seed, net, r, 1, device)[0]
        got += float(pinn.loss(cfg, p, pts).detach())
        want += float(pinn.loss(cfg, q, pts).detach())
    return got / want


def numbers(cell, call, device, deep=True):
    """The call's numbers; ``end_loss`` and ``net_loss`` only if
    ``deep``."""
    mix, cfg = cell.mix, cell.cfg
    losses = losses_of(mix, call.answer)
    want, base = first_steps.reference_run(
        mix, cfg, call.seed, call.rows, device,
        steps=harness.replay_steps(cell) if deep else first_steps.STEPS)
    out = {"loss_gap": first_steps.gap(losses, want[:, :first_steps.STEPS]),
           "bad_losses": first_steps.bad_losses(losses, len(call.rows),
                                                call.steps)}
    if not deep:
        return out
    out["end_loss"] = end_loss(losses, late_losses(
        mix, cfg, call.seed, call.rows, base, call.steps, device))
    returned = getattr(call.answer, "params", None)
    if isinstance(returned, (list, tuple)) and len(returned) == len(base):
        params = [{k: v.to(device) for k, v in nets.read_params(m).items()}
                  for m in returned]
        out["net_loss"] = net_loss(mix, cfg, call.seed, call.rows, params,
                                   base, device)
    return out


def frozen_numbers(cell, seed, steps, device):
    """``end_loss`` and ``net_loss`` of a call whose state stops advancing
    after its first graph replay, as the reference put in the program's
    place gives them: its last ``TAIL`` losses and its nets are those of
    the state after G steps. The fault that ``end_loss`` and ``net_loss``
    are held against; it reads 1 in both."""
    mix, cfg = cell.mix, cell.cfg
    rows = harness.net_rows(mix, cfg)
    _, base = first_steps.reference_run(
        mix, cfg, seed, rows, device, steps=harness.replay_steps(cell))
    late = late_losses(mix, cfg, seed, rows, base, steps, device)
    return {"end_loss": end_loss(late, late),
            "net_loss": net_loss(mix, cfg, seed, rows, base, base, device)}
