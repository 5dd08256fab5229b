"""Parallelism over the ranks of a ``torch.distributed`` group (the JAX
package's parallel/, there over a ``jax.sharding.Mesh``).

Two axes, as in the JAX package:

* ``data`` — the collocation batch split over ranks; the parameters are
  replicated and the gradient mean is one all-reduce a step;
* ``pop``  — population parallelism: trials, replicas or rung slots split
  over ranks with no traffic while they train, gathered at the end.

Both compose: a 2-D ``("pop", "data")`` mesh trains P trials, each rank of
a ``pop`` coordinate the same ones. Each rank is a process (SPMD):
``initialize_distributed`` joins it to the group, ``make_mesh`` names the
axes.
"""

from differential_equations_dnn_tpu_torch.parallel.distributed import (
    global_mesh,
    initialize_distributed,
    spawn_ranks,
)
from differential_equations_dnn_tpu_torch.parallel.mesh import (
    make_mesh,
    single_axis_mesh,
)
from differential_equations_dnn_tpu_torch.parallel.population import (
    PopulationConfig,
    init_trials,
    take_trials,
    train_population,
    trial_model,
    trial_opt_state,
)
from differential_equations_dnn_tpu_torch.parallel.sharding import (
    replicate,
    shard_batch,
)

__all__ = [
    "make_mesh",
    "single_axis_mesh",
    "shard_batch",
    "replicate",
    "PopulationConfig",
    "train_population",
    "take_trials",
    "init_trials",
    "trial_model",
    "trial_opt_state",
    "initialize_distributed",
    "global_mesh",
    "spawn_ranks",
]
