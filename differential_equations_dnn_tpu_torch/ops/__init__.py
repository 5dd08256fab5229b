from differential_equations_dnn_tpu_torch.ops.diff import (
    coordinate_taps,
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
    coprime_stride,
    stride_strata,
)
from differential_equations_dnn_tpu_torch.ops.taylor import (
    heat_fused_streams,
    mlp_streams,
)

__all__ = [
    "coordinate_taps",
    "value_dt",
    "value_dx_dxx",
    "gauss_legendre_nodes",
    "halton_nodes",
    "integrate",
    "montecarlo_nodes",
    "GridSubsample",
    "coprime_stride",
    "stride_strata",
    "heat_fused_streams",
    "mlp_streams",
]
