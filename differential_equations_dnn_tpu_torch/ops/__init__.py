from differential_equations_dnn_tpu_torch.ops.diff import (
    coordinate_taps,
    hessian_diag,
    time_jacobian,
    value_dt,
    value_dx_dxx,
)
from differential_equations_dnn_tpu_torch.ops.quad import (
    gauss_legendre_nodes,
    halton_nodes,
    integrate,
    montecarlo_nodes,
)
from differential_equations_dnn_tpu_torch.ops.sampling import (
    GridSubsample,
    UniformBox,
    coprime_stride,
    stride_strata,
)
from differential_equations_dnn_tpu_torch.ops.taylor import (
    heat_fused_streams,
    mlp_streams,
    mlp_taps,
)

__all__ = [
    "coordinate_taps",
    "hessian_diag",
    "time_jacobian",
    "value_dt",
    "value_dx_dxx",
    "gauss_legendre_nodes",
    "halton_nodes",
    "integrate",
    "montecarlo_nodes",
    "GridSubsample",
    "UniformBox",
    "coprime_stride",
    "stride_strata",
    "heat_fused_streams",
    "mlp_streams",
    "mlp_taps",
]
