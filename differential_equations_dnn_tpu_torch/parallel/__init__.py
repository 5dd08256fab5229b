"""Population training: P independent trials stepped together on one GPU
(the JAX package's parallel/population.py). The mesh, sharding and
multi-process modules of the JAX package's parallel/ are not ported
(ROADMAP item 14)."""

from differential_equations_dnn_tpu_torch.parallel.population import (
    PopulationConfig,
    init_trials,
    take_trials,
    train_population,
    trial_model,
    trial_opt_state,
)

__all__ = [
    "PopulationConfig",
    "init_trials",
    "take_trials",
    "train_population",
    "trial_model",
    "trial_opt_state",
]
