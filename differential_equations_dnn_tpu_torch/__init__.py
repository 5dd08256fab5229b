"""differential_equations_dnn_tpu_torch — the PyTorch/CUDA port of
``differential_equations_dnn_tpu``, for one NVIDIA H100.

It imports ``torch`` and never ``jax``. The JAX package beside it is the
reference the port is tested against. Ported so far: ``solve(name)`` for
simple_ode, heat, burgers, wave, advection, poisson, heat2d,
fitzhugh_nagumo and fredholm on both engines. ``engine="scan"`` (the
default) is the generic trainer, torch ops per step, with heat's
``taps="pallas"`` streams from a hand-written kernel; ``engine="fused"``
trains inside hand-written CUDA kernels (csrc/): the constant-lr heat
trainer, the generic spec engine with its lr schedules, the DGM engine and
their packed-replica ensembles. Grid evaluation runs the MLP-forward
kernel.

* ``core``       — fp32 policy, activations, initializers, step-keyed draws
* ``models``     — the plain MLP and the DGM (``nn.Module``s), JAX
                   parameter import
* ``ops``        — forward-mode taps (torch.func.jvp), Taylor streams,
                   Gauss–Legendre quadrature, the grid subsampler
* ``equations``  — the nine problems (residuals, grids, exact solutions)
* ``train``      — the scan trainer (``train``, ``make_train_step``,
                   ``TrainConfig``, ``TrainResult``, ``inject_fault``,
                   ``opt_state_from_jax``), the L-BFGS polish, the MAE
                   metric
* ``kernels``    — the CUDA kernels' wrappers, plain versions and build
* ``sweep``      — hyperparameter search on the fused tier (TPE, successive
                   halving, TPE × halving), every trial inside the kernels
"""

__version__ = "0.1.0"

from differential_equations_dnn_tpu_torch import (
    core,
    equations,
    kernels,
    models,
    ops,
    sweep,
    train,
)
from differential_equations_dnn_tpu_torch.api import SolveResult, solve
from differential_equations_dnn_tpu_torch.sweep import (
    halving_search_fused,
    tpe_halving_fused,
    tpe_search_fused,
)

__all__ = [
    "core",
    "models",
    "ops",
    "equations",
    "train",
    "kernels",
    "sweep",
    "solve",
    "tpe_search_fused",
    "halving_search_fused",
    "tpe_halving_fused",
    "SolveResult",
    "__version__",
]
