from differential_equations_dnn_tpu_torch.models.dgm import (
    DGM,
    dgm_params_from_jax,
    dgm_params_to_jax,
)
from differential_equations_dnn_tpu_torch.models.hard import (
    Ansatz,
    HardConstraint,
    hard_params_from_jax,
    hard_params_to_jax,
    heat1d_ansatz,
    heat2d_ansatz,
    poisson_ansatz,
    time_ic_ansatz,
    wave1d_ansatz,
)
from differential_equations_dnn_tpu_torch.models.mlp import (
    MLP,
    params_from_jax,
    params_to_jax,
)
from differential_equations_dnn_tpu_torch.models.perceptron import (
    Perceptron,
    perceptron_params_from_jax,
    perceptron_params_to_jax,
)

__all__ = ["DGM", "dgm_params_from_jax", "dgm_params_to_jax", "Ansatz",
           "HardConstraint", "hard_params_from_jax", "hard_params_to_jax",
           "heat1d_ansatz", "heat2d_ansatz", "poisson_ansatz",
           "time_ic_ansatz", "wave1d_ansatz", "MLP",
           "params_from_jax", "params_to_jax", "Perceptron",
           "perceptron_params_from_jax", "perceptron_params_to_jax"]
