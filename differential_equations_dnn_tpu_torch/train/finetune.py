"""L-BFGS fine-tuning: the PINN polish after Adam.

Counterpart of the JAX package's train/finetune.py, which runs
``optax.lbfgs()`` for a fixed number of steps on one fixed off-grid
collocation batch. Here ``torch.optim.LBFGS`` is set up like optax's
defaults (history 10, step size 1, a strong-Wolfe line search) and runs
plain torch ops on the model's device, as the JAX polish runs outside any
Pallas kernel.
"""

import numpy as np
import torch

_LINE_SEARCH_EVALS = 20  # optax.scale_by_zoom_linesearch's max steps


def finetune_lbfgs(problem, model, steps: int = 200, batch_size: int = 4096,
                   generator=None):
    """Polish ``model`` in place with full-batch L-BFGS on ``problem.loss``
    over one fixed ``problem.validation_sample(batch_size, generator)``
    batch (dense off-grid points: a fixed training grid would be
    overfitted). FitzHugh–Nagumo with ``causal_eps > 0`` polishes its causal
    loss, as in the JAX package.

    Runs exactly ``steps`` iterations, as optax's fixed-length scan does:
    each ``step`` call makes one L-BFGS iteration, and the gradient and
    change tolerances are 0, so no iteration ends the loop early. Each
    iteration's line search may evaluate the loss 20 times, as optax's zoom
    line search may (torch would derive 1 evaluation per call, the initial
    one, from ``max_iter=1``, leaving the search none). Returns ``(model,
    losses np[steps])``, the loss at the start of each iteration.
    """
    device = next(model.parameters()).device
    batch = problem.validation_sample(batch_size, generator, device)
    opt = torch.optim.LBFGS(model.parameters(), lr=1.0, max_iter=1,
                            max_eval=1 + _LINE_SEARCH_EVALS, history_size=10,
                            tolerance_grad=0.0, tolerance_change=0.0,
                            line_search_fn="strong_wolfe")

    def closure():
        opt.zero_grad()
        loss = problem.loss(model, batch)
        loss.backward()
        return loss.detach()

    losses = np.empty(steps, np.float32)
    for i in range(steps):
        losses[i] = float(opt.step(closure))
    return model, losses
