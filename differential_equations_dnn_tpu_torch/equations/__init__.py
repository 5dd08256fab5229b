from differential_equations_dnn_tpu_torch.equations.advection import (
    Advection1D,
)
from differential_equations_dnn_tpu_torch.equations.base import (
    Problem,
    TrainDefaults,
)
from differential_equations_dnn_tpu_torch.equations.burgers import Burgers
from differential_equations_dnn_tpu_torch.equations.fitzhugh_nagumo import (
    FitzHughNagumo,
)
from differential_equations_dnn_tpu_torch.equations.fredholm import Fredholm2
from differential_equations_dnn_tpu_torch.equations.heat import Heat1D
from differential_equations_dnn_tpu_torch.equations.heat2d import Heat2D
from differential_equations_dnn_tpu_torch.equations.inverse_heat import (
    InverseHeat1D,
    inverse_params_from_jax,
    inverse_params_to_jax,
)
from differential_equations_dnn_tpu_torch.equations.poisson import Poisson2D
from differential_equations_dnn_tpu_torch.equations.simple_ode import (
    SimpleODE,
)
from differential_equations_dnn_tpu_torch.equations.uat import SineFit
from differential_equations_dnn_tpu_torch.equations.volterra import Volterra2
from differential_equations_dnn_tpu_torch.equations.wave import Wave1D

PROBLEMS = {
    "simple_ode": SimpleODE,
    "heat": Heat1D,
    "heat2d": Heat2D,
    "burgers": Burgers,
    "wave": Wave1D,
    "advection": Advection1D,
    "poisson": Poisson2D,
    "fredholm": Fredholm2,
    "fitzhugh_nagumo": FitzHughNagumo,
    "volterra": Volterra2,
    "uat": SineFit,
    "inverse_heat": InverseHeat1D,
}

# Equations of the JAX package that the port does not have yet: none.
NOT_PORTED: dict[str, str] = {}


def get_problem(name: str, **kwargs) -> Problem:
    """The registered problem ``name``; raises ValueError naming what
    exists (and, for an equation still to port, its ROADMAP item)."""
    try:
        cls = PROBLEMS[name]
    except KeyError:
        todo = (f" ({name} is not ported yet: ROADMAP.md {NOT_PORTED[name]})"
                if name in NOT_PORTED else "")
        raise ValueError(f"unknown equation {name!r}; available: "
                         f"{sorted(PROBLEMS)}{todo}") from None
    return cls(**kwargs)


__all__ = ["PROBLEMS", "NOT_PORTED", "Problem", "TrainDefaults",
           "SimpleODE", "Heat1D", "Heat2D", "Burgers", "Wave1D",
           "Advection1D", "Poisson2D", "Fredholm2", "FitzHughNagumo",
           "Volterra2", "SineFit", "InverseHeat1D", "inverse_params_from_jax",
           "inverse_params_to_jax", "get_problem"]
