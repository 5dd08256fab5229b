"""Hyperparameter search and ablation studies: the reference's Ray Tune
driver (optimize_heat_ray.py: Optuna's TPE under ASHA) on the fused tier,
every trial inside the port's kernels, and on populations
(parallel/population.py: ``random_search``, ``successive_halving``,
``tpe_search``, ``tpe_halving``) (sweep/search.py); the TPE sampler
(sweep/tpe.py); the reference's batch-size and BatchNorm ablations as
populations (sweep/ablations.py)."""

from differential_equations_dnn_tpu_torch.sweep.search import (
    BUCKET_TILES,
    SearchSpace,
    SweepResult,
    choice,
    halving_search_fused,
    heat_search_space,
    loguniform,
    randint,
    random_search,
    successive_halving,
    tpe_halving,
    tpe_halving_fused,
    tpe_search,
    tpe_search_fused,
    uniform,
)
from differential_equations_dnn_tpu_torch.sweep.tpe import TPESampler
from differential_equations_dnn_tpu_torch.sweep.ablations import (
    AblationResult,
    batch_size_effect,
    batchnorm_effect,
)

__all__ = [
    "AblationResult",
    "BUCKET_TILES",
    "SearchSpace",
    "SweepResult",
    "TPESampler",
    "batch_size_effect",
    "batchnorm_effect",
    "choice",
    "halving_search_fused",
    "heat_search_space",
    "loguniform",
    "randint",
    "random_search",
    "successive_halving",
    "tpe_halving",
    "tpe_halving_fused",
    "tpe_search",
    "tpe_search_fused",
    "uniform",
]
