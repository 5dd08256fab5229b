from differential_equations_dnn_tpu_torch.core.activations import (
    ACTIVATIONS,
    get_activation,
)
from differential_equations_dnn_tpu_torch.core.init import (
    calculate_gain,
    kaiming_uniform,
    torch_linear_default,
    xavier_uniform,
)
from differential_equations_dnn_tpu_torch.core.precision import dense
from differential_equations_dnn_tpu_torch.core.prng import (
    generator,
    step_generator,
    step_uniforms,
)

__all__ = [
    "ACTIVATIONS",
    "get_activation",
    "calculate_gain",
    "kaiming_uniform",
    "torch_linear_default",
    "xavier_uniform",
    "dense",
    "generator",
    "step_generator",
    "step_uniforms",
]
