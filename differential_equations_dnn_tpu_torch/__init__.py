"""differential_equations_dnn_tpu_torch — the PyTorch/CUDA port of
``differential_equations_dnn_tpu``, for one NVIDIA H100.

It imports ``torch`` and never ``jax``. The JAX package beside it is the
reference the port is tested against. Ported so far: the fused heat-training
path, ``solve("heat", engine="fused")``, through two hand-written CUDA
kernels (csrc/): the fused heat training step and the MLP forward used for
grid evaluation.

* ``core``       — fp32 policy, activations, initializers, step-keyed draws
* ``models``     — the plain MLP (``nn.Module``) and JAX parameter import
* ``ops``        — forward-mode taps (torch.func.jvp) and Taylor streams
* ``equations``  — the heat problem
* ``train``      — result records and the MAE metric
* ``kernels``    — the CUDA kernels' wrappers, plain versions and build
"""

__version__ = "0.1.0"

from differential_equations_dnn_tpu_torch import (
    core,
    equations,
    kernels,
    models,
    ops,
    train,
)
from differential_equations_dnn_tpu_torch.api import SolveResult, solve

__all__ = [
    "core",
    "models",
    "ops",
    "equations",
    "train",
    "kernels",
    "solve",
    "SolveResult",
    "__version__",
]
