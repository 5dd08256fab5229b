"""differential_equations_dnn_tpu_torch — the PyTorch/CUDA port of
``differential_equations_dnn_tpu``, for one NVIDIA H100.

It imports ``torch`` and never ``jax``. The JAX package beside it is the
reference the port is tested against. ``solve(name)`` runs all twelve
equations on both engines. ``engine="scan"`` (the default) is the generic
trainer, torch ops per step, with heat's ``taps="pallas"`` streams from a
hand-written kernel, any model (BatchNorm, Fourier-feature and ResNet
models too); its ensembles are populations of vmapped trials.
``engine="fused"`` trains inside hand-written CUDA kernels (csrc/): the
constant-lr heat trainer, the generic spec engine with its lr schedules,
the DGM engine and their packed-replica ensembles. Grid evaluation of a
plain MLP runs the MLP-forward kernel.

* ``core``       — fp32 policy, activations, initializers, step-keyed draws
* ``models``     — the MLP (plain, BatchNorm pre/post, Fourier features),
                   the DGM, the ResNet, the Perceptron, hard-constraint
                   trial functions (``nn.Module``s), the stateful protocol,
                   JAX parameter import
* ``ops``        — forward-mode taps (torch.func.jvp), Taylor streams,
                   Gauss–Legendre quadrature, the grid subsampler
* ``equations``  — the nine problems (residuals, grids, exact solutions)
* ``train``      — the scan trainer (``train``, ``make_train_step``,
                   ``TrainConfig``, ``TrainResult``, ``inject_fault``,
                   ``opt_state_from_jax``), the L-BFGS polish, the MAE
                   metric
* ``kernels``    — the CUDA kernels' wrappers, plain versions and build
* ``parallel``   — population training (P trials stepped together) and
                   meshes over ``torch.distributed`` ranks (``mesh=``)
* ``sweep``      — hyperparameter search on the fused tier (TPE, successive
                   halving, TPE × halving, every trial inside the kernels)
                   and on populations (random, halving, TPE, TPE ×
                   halving), and the batch-size and BatchNorm ablations
* ``serving``    — ``export_solution`` / ``load_solution``: a trained
                   solution as a ``torch.export`` program
* ``utils``      — timing, run manifests, ``temp_results/*.npy`` IO
* ``viz``, ``cli`` — the reference's figures and the command line
                   (``python -m differential_equations_dnn_tpu_torch``),
                   imported on first use, so that importing the package
                   loads no matplotlib
"""

__version__ = "0.1.0"

from differential_equations_dnn_tpu_torch import (
    core,
    equations,
    kernels,
    models,
    ops,
    parallel,
    sweep,
    train,
    utils,
)
from differential_equations_dnn_tpu_torch.api import SolveResult, solve
from differential_equations_dnn_tpu_torch.serving import (
    export_solution,
    load_solution,
)
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
    "parallel",
    "sweep",
    "utils",
    "solve",
    "export_solution",
    "load_solution",
    "tpe_search_fused",
    "halving_search_fused",
    "tpe_halving_fused",
    "SolveResult",
    "__version__",
]


def __getattr__(name):
    # viz (matplotlib) and cli load on first use; ``import *`` leaves them.
    if name in ("viz", "cli"):
        import importlib

        return importlib.import_module(f"{__name__}.{name}")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
