"""The program's initial weights and first collocation batches, rebuilt
from a call's seed by the rules each traffic mix names:

* ``init``: "single" (a single run's net from ``generator(seed)``) or
  "replica" (net r of an ensemble or population from
  ``replica_generator(seed, r)``);
* ``draws``: "fused_uniforms" (the fused trainers' step-keyed uniforms,
  shared by every replica), "step_generator" (the scan trainer's
  ``torch.rand`` from ``step_generator(seed, i)``) or "trial_generator"
  (a population trial's ``step_generator(trial_seed(seed, t), i)`` over
  the largest batch, masked to the trial's own).
"""

import torch

from reference import nets, pinn, prng


def initial(mix, cfg, seed, net, device):
    g = (prng.generator(seed) if mix["init"] == "single"
         else prng.replica_generator(seed, net))
    return {k: v.to(device) for k, v in nets.init(cfg, g).items()}


def batches(mix, cfg, seed, net, rows, steps, device, start=0):
    """The collocation points of net ``net`` (training on ``rows`` rows)
    at steps start .. start + steps − 1."""
    U = cfg["n_uniform"]
    ks = range(start, start + steps)
    if mix["draws"] == "fused_uniforms":
        u = list(prng.step_uniforms(seed, start, steps, rows, U))
    elif mix["draws"] == "step_generator":
        u = [torch.rand((rows, U), generator=prng.step_generator(seed, k))
             for k in ks]
    else:
        drawn = max(r for r, _ in mix["net_rows"])
        s = prng.trial_seed(seed, net)
        u = [torch.rand((drawn, U), generator=prng.step_generator(s, k))
             [:rows] for k in ks]
    return [pinn.points(cfg, x.to(device)) for x in u]
