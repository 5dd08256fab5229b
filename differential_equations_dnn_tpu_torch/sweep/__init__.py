"""Hyperparameter search on the fused tier: the reference's Ray Tune
driver (optimize_heat_ray.py: Optuna's TPE under ASHA) with every trial
trained inside the port's kernels (sweep/search.py) and the TPE sampler
(sweep/tpe.py). The population drivers and the ablation studies of the
JAX package's sweep/ are not ported (ROADMAP item 13)."""

from differential_equations_dnn_tpu_torch.sweep.search import (
    BUCKET_TILES,
    SearchSpace,
    SweepResult,
    choice,
    halving_search_fused,
    heat_search_space,
    loguniform,
    randint,
    tpe_halving_fused,
    tpe_search_fused,
    uniform,
)
from differential_equations_dnn_tpu_torch.sweep.tpe import TPESampler

__all__ = [
    "BUCKET_TILES",
    "SearchSpace",
    "SweepResult",
    "TPESampler",
    "choice",
    "halving_search_fused",
    "heat_search_space",
    "loguniform",
    "randint",
    "tpe_halving_fused",
    "tpe_search_fused",
    "uniform",
]
