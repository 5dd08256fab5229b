from differential_equations_dnn_tpu_torch.train.finetune import (
    finetune_lbfgs,
)
from differential_equations_dnn_tpu_torch.train.metrics import (
    mean_absolute_error,
)
from differential_equations_dnn_tpu_torch.train.trainer import (
    TrainConfig,
    TrainResult,
)

__all__ = ["finetune_lbfgs", "mean_absolute_error", "TrainConfig",
           "TrainResult"]
