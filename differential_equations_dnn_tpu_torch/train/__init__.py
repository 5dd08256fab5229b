from differential_equations_dnn_tpu_torch.train.checkpoint import (
    checkpoint_like,
    restore_checkpoint,
    save_checkpoint,
)
from differential_equations_dnn_tpu_torch.train.finetune import (
    finetune_lbfgs,
)
from differential_equations_dnn_tpu_torch.train.metrics import (
    mean_absolute_error,
)
from differential_equations_dnn_tpu_torch.train.trainer import (
    TrainConfig,
    TrainResult,
    inject_fault,
    make_train_step,
    opt_state_from_jax,
    train,
)

__all__ = ["checkpoint_like", "restore_checkpoint", "save_checkpoint",
           "finetune_lbfgs", "mean_absolute_error", "TrainConfig",
           "TrainResult", "inject_fault", "make_train_step",
           "opt_state_from_jax", "train"]
