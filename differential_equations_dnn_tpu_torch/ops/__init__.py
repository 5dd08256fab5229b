from differential_equations_dnn_tpu_torch.ops.diff import (
    dirderiv,
    dirderiv2,
    value_dt,
    value_dx_dxx,
)
from differential_equations_dnn_tpu_torch.ops.taylor import (
    heat_fused_streams,
    mlp_streams,
)

__all__ = [
    "dirderiv",
    "dirderiv2",
    "value_dt",
    "value_dx_dxx",
    "heat_fused_streams",
    "mlp_streams",
]
