from differential_equations_dnn_tpu_torch.models.mlp import (
    MLP,
    params_from_jax,
    params_to_jax,
)

__all__ = ["MLP", "params_from_jax", "params_to_jax"]
