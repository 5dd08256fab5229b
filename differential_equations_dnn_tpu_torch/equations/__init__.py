from differential_equations_dnn_tpu_torch.equations.base import (
    Problem,
    TrainDefaults,
)
from differential_equations_dnn_tpu_torch.equations.heat import Heat1D

# The other equations of the JAX package are ROADMAP.md queue 1, items 10-11.
PROBLEMS = {"heat": Heat1D}


def get_problem(name: str, **kwargs) -> Problem:
    """The registered problem ``name``; raises ValueError naming what
    exists."""
    try:
        cls = PROBLEMS[name]
    except KeyError:
        raise ValueError(f"unknown equation {name!r}; available: "
                         f"{sorted(PROBLEMS)}") from None
    return cls(**kwargs)


__all__ = ["PROBLEMS", "Problem", "TrainDefaults", "Heat1D", "get_problem"]
