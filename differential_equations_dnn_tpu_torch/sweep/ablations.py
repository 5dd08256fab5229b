"""Ablation studies as populations: the batch-size effect and the
BatchNorm placement effect.

Counterpart of the JAX package's sweep/ablations.py. The reference's
batchsize_effect_heat.py sweeps batch sizes 2⁰…2¹⁰ × 5 runs × 15 000
steps and batchnorm_effect_heat.py compares no / pre-activation /
post-activation BatchNorm MLPs, 5 runs × 15 000 steps each, one trial
after another, with two faults the JAX package fixes and the port keeps
fixed: the swept batch size never reached the trainer (hard-coded 64,
batchsize_effect_heat.py:197), and one net was reused across runs without
re-initialisation (:180-199). Here each (config, run) pair is a trial of
its own init, and the batch size its loss mask (parallel/population.py).
"""

from dataclasses import dataclass

import numpy as np

from differential_equations_dnn_tpu_torch.core.prng import (
    fold_seed,
    generator,
)
from differential_equations_dnn_tpu_torch.equations import Heat1D
from differential_equations_dnn_tpu_torch.models import MLP
from differential_equations_dnn_tpu_torch.parallel.population import (
    PopulationConfig,
    train_population,
)


@dataclass
class AblationResult:
    labels: list                 # one per config
    mean_losses: np.ndarray      # [n_configs, iterations], mean over runs
    all_losses: np.ndarray       # [n_configs, runs, iterations]

    def as_dict(self):
        return dict(zip(self.labels, self.mean_losses))


def batch_size_effect(problem=None, seed: int = 0, batch_sizes=None,
                      runs: int = 5, iterations: int = 15_000,
                      lrate: float = 1e-4, mesh=None,
                      chunk_size: int = 1000,
                      device="cuda") -> AblationResult:
    """Loss curves per batch size, averaged over ``runs`` fresh inits (the
    reference's protocol, batchsize_effect_heat.py:186-205, with its faults
    fixed): all ``len(batch_sizes) × runs`` trials train as one population
    of ``max(batch_sizes)`` drawn rows, each masked to its own batch (JAX
    ``batch_size_effect``; its ``key`` is ``seed`` here). Trial
    ``i · runs + r`` is run r of batch size i."""
    problem = problem or Heat1D()
    batch_sizes = list(batch_sizes or [2**i for i in range(11)])
    model = problem.default_model(generator=generator(0))
    n_trials = len(batch_sizes) * runs
    config = PopulationConfig(iterations=iterations,
                              max_batch_size=int(max(batch_sizes)),
                              chunk_size=chunk_size)
    _, _, losses = train_population(
        problem, model, seed, np.full(n_trials, lrate, np.float32),
        np.repeat(batch_sizes, runs), config=config, mesh=mesh,
        device=device)
    curves = losses.T.reshape(len(batch_sizes), runs, iterations)
    return AblationResult(labels=[str(b) for b in batch_sizes],
                          mean_losses=curves.mean(axis=1),
                          all_losses=curves)


def batchnorm_effect(problem=None, seed: int = 0, runs: int = 5,
                     iterations: int = 15_000, batch_size: int = 64,
                     lrate: float = 1e-4, hidden_size: int = 128,
                     num_layers: int = 3, activation: str = "relu",
                     mesh=None, chunk_size: int = 1000,
                     device="cuda") -> AblationResult:
    """No BatchNorm against pre- and post-activation BatchNorm on the heat
    equation (the reference's protocol, batchnorm_effect_heat.py:292-347;
    JAX ``batchnorm_effect``): the three architectures have different
    parameters, so each is a population of ``runs`` trials of its own, at
    seed ``fold_seed(seed, i)`` for config i (JAX's ``fold_in(key, i)``),
    trained one after another."""
    problem = problem or Heat1D()
    configs = [(label, MLP(2, 1, hidden_size, num_layers, activation,
                           batch_norm=bn, generator=generator(0)))
               for label, bn in (("none", None), ("pre", "pre"),
                                 ("post", "post"))]
    config = PopulationConfig(iterations=iterations,
                              max_batch_size=batch_size,
                              chunk_size=chunk_size)
    curves = []
    for i, (_, model) in enumerate(configs):
        _, _, losses = train_population(
            problem, model, fold_seed(seed, i),
            np.full(runs, lrate, np.float32), config=config, mesh=mesh,
            device=device)
        curves.append(losses.T)
    all_losses = np.stack(curves)
    return AblationResult(labels=[label for label, _ in configs],
                          mean_losses=all_losses.mean(axis=1),
                          all_losses=all_losses)
