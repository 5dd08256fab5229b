"""Stateful models (BatchNorm): the protocol every trainer speaks.

Counterpart of the JAX package's models/stateful.py. The reference trains
its BatchNorm MLPs through the same loop as every other net
(batchnorm_effect_heat.py:239-290); here the running statistics are a
model's buffers, and three rules keep them as the JAX package threads its
state pytree:

* A train-mode forward (``model.train()``, the default) normalises by the
  batch's own statistics and writes no buffer. ``nn.BatchNorm1d`` would
  update its statistics in every forward, and a loss calls the net several
  times a step (interior, IC, BC), so the statistics would move several
  times a step.
* :func:`update_state` refreshes the buffers with one train-mode forward
  (``model.running_stats(inputs)``), once per optimizer step, on the
  step's interior points with the updated parameters.
* An eval-mode forward (``model.eval()``) normalises by the buffers.

A model is stateful when its ``stateful`` is true; its running statistics
are its buffers named ``mean`` and ``var`` (:func:`state_names`), which
``running_stats`` returns new values for, by name. Any other buffer (a
Fourier-feature matrix) is a frozen parameter.
"""

import contextlib

import torch

from differential_equations_dnn_tpu_torch.core.rows import all_rows, row_count


def is_stateful(model) -> bool:
    """Whether ``model`` carries running statistics."""
    return bool(getattr(model, "stateful", False))


def state_names(model) -> list[str]:
    """The names of ``model``'s running-statistics buffers (none for a
    stateless model)."""
    if not is_stateful(model):
        return []
    return [name for name, _ in model.named_buffers()
            if name.rsplit(".", 1)[-1] in ("mean", "var")]


def update_state(model, inputs) -> None:
    """One train-mode forward on ``inputs`` that refreshes ``model``'s
    running statistics in place; nothing for a stateless model."""
    if not is_stateful(model):
        return
    with torch.no_grad():
        new = model.running_stats(inputs)
        buffers = dict(model.named_buffers())
        for name, value in new.items():
            buffers[name].copy_(value)


@contextlib.contextmanager
def eval_mode(model):
    """``model`` in eval mode (a stateful model normalises by its running
    statistics) for the block, then back in the mode it was in."""
    was = model.training
    model.eval()
    try:
        yield model
    finally:
        model.train(was)


def bn_train(x, gamma, beta, eps):
    """Train-mode batch normalisation over the batch axis; returns the
    normalised activations and the batch's (mean, biased variance). On a
    sharded ``data`` axis (core/rows.py) the moments are the global
    batch's, taken on every rank's rows, and their gradient reaches every
    rank's rows."""
    rows = all_rows(x)
    mean = torch.mean(rows, 0)
    var = torch.mean(torch.square(rows - mean), 0)
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta, (mean, var)


def bn_eval(x, gamma, beta, mean, var, eps):
    return (x - mean) * torch.rsqrt(var + eps) * gamma + beta


def bn_update(mean, var, batch_mean, batch_var, n, momentum):
    """The running statistics after one batch of ``n`` rows (on a sharded
    ``data`` axis, ``n`` rows a rank: the global batch's count): torch's
    rule, the running variance updated with the unbiased estimate."""
    n = row_count(n)
    unbiased = batch_var * (n / max(n - 1, 1))
    return ((1 - momentum) * mean + momentum * batch_mean,
            (1 - momentum) * var + momentum * unbiased)
