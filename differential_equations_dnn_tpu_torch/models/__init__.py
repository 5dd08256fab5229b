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
    state_to_jax,
)
from differential_equations_dnn_tpu_torch.models.perceptron import (
    Perceptron,
    perceptron_params_from_jax,
    perceptron_params_to_jax,
)
from differential_equations_dnn_tpu_torch.models.resnet import (
    ResidualBlock,
    ResNet,
    resnet_params_from_jax,
    resnet_params_to_jax,
)
from differential_equations_dnn_tpu_torch.models.stateful import (
    eval_mode,
    is_stateful,
    update_state,
)

__all__ = ["DGM", "dgm_params_from_jax", "dgm_params_to_jax", "Ansatz",
           "HardConstraint", "hard_params_from_jax", "hard_params_to_jax",
           "heat1d_ansatz", "heat2d_ansatz", "poisson_ansatz",
           "time_ic_ansatz", "wave1d_ansatz", "MLP",
           "params_from_jax", "params_to_jax", "Perceptron",
           "perceptron_params_from_jax", "perceptron_params_to_jax",
           "ResidualBlock", "ResNet", "resnet_params_from_jax",
           "resnet_params_to_jax", "state_to_jax", "eval_mode",
           "is_stateful", "update_state"]
