"""Utilities: timing, run manifests, artifact IO (the JAX package's
utils/, the same functions and file formats)."""

from differential_equations_dnn_tpu_torch.utils.artifacts import (
    load_array,
    results_dir,
    save_array,
)
from differential_equations_dnn_tpu_torch.utils.manifest import (
    parameters_summary,
)
from differential_equations_dnn_tpu_torch.utils.timing import Timer, fn_timer

__all__ = [
    "fn_timer",
    "Timer",
    "parameters_summary",
    "save_array",
    "load_array",
    "results_dir",
]
