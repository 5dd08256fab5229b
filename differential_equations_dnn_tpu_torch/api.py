"""High-level one-call API: ``solve(...)``.

    from differential_equations_dnn_tpu_torch import solve
    result = solve("heat", engine="fused")   # reference defaults, on the GPU
    result.mae, result.solution, result.loss_history
"""

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.core.prng import generator
from differential_equations_dnn_tpu_torch.equations import Problem, get_problem
from differential_equations_dnn_tpu_torch.kernels.fused_train import (
    resolve_device,
    train_heat_fused_result,
)
from differential_equations_dnn_tpu_torch.models import MLP
from differential_equations_dnn_tpu_torch.train import (
    TrainConfig,
    mean_absolute_error,
)


@dataclass
class SolveResult:
    problem: Problem
    params: Any                 # the trained model
    solution: np.ndarray        # net evaluated on the problem grid
    exact: np.ndarray           # analytic ground truth
    mae: float
    loss_history: np.ndarray
    iters_per_sec: float        # steady state: build and warm-up excluded
    wall_time: float
    compile_time: float = 0.0   # kernel build + first dispatch
    device: str = ""            # the name of the device that trained it

    def __repr__(self):
        return (f"SolveResult({self.problem.name}: mae={self.mae:.4g}, "
                f"final_loss={self.loss_history[-1]:.3g}, "
                f"{self.iters_per_sec:.0f} iters/s on {self.device})")


def _fused_route(problem, model) -> str:
    """Which fused engine trains (problem, model). Only the specialised heat
    kernel (kernels.fused_train) is ported."""
    if problem.name != "heat":
        raise NotImplementedError(
            f"the fused engine for {problem.name!r} is not ported yet "
            f"(ROADMAP.md queue 1, items 10-11)")
    if not (isinstance(model, MLP) and model.activation == "tanh"):
        raise ValueError("heat's fused path needs a plain tanh MLP "
                         f"(got {type(model).__name__})")
    return "heat"


def solve(equation: str | Problem, *, iterations: int | None = None,
          batch_size: int | None = None, lrate: float | None = None,
          nodes: int | None = None, seed: int = 0, model=None,
          engine: str = "scan", precision: str = "highest",
          schedule: str | None = None, device="cuda",
          **problem_kwargs) -> SolveResult:
    """Train a network on ``equation`` and validate against its ground truth.

    ``equation`` is a registry name ("heat") or a Problem instance. Unset
    hyperparameters default to the reference's published configuration.
    ``engine="fused"`` trains inside the hand-written CUDA kernels; the
    generic ``"scan"`` trainer is not ported yet. ``model`` (a plain tanh
    MLP, default ``problem.default_model()`` initialised from ``seed``) is
    trained in place. ``device`` defaults to "cuda" and raises without a
    GPU; "cpu" runs the kernels' plain PyTorch versions.
    """
    problem = (get_problem(equation, **problem_kwargs)
               if isinstance(equation, str) else equation)
    if engine == "scan":
        raise NotImplementedError(
            "engine='scan' is not ported yet (ROADMAP.md queue 1, item 6: "
            "train/trainer.py); use engine='fused'")
    if engine != "fused":
        raise ValueError(f"unknown engine {engine!r} (scan | fused)")
    device = resolve_device(device)

    d = problem.defaults
    config = TrainConfig(
        iterations=iterations if iterations is not None else d.iterations,
        batch_size=batch_size if batch_size is not None else d.batch_size,
        lrate=lrate if lrate is not None else d.lrate,
        schedule=schedule if schedule is not None else d.schedule,
    )
    if config.schedule != "constant":
        raise NotImplementedError(
            f"schedule={config.schedule!r} is not ported yet (ROADMAP.md "
            f"queue 2: kernel #4, engine_core.fused_adam_kernel)")
    nodes = nodes if nodes is not None else d.nodes
    if model is None:
        model = problem.default_model(generator=generator(seed))
    _fused_route(problem, model)

    result = train_heat_fused_result(
        problem, seed, config.iterations, batch_size=config.batch_size,
        lrate=config.lrate, chunk_size=config.chunk_size, model=model,
        precision=precision, device=device)
    solution = problem.evaluate(result.params, nodes)
    exact = problem.exact(nodes)
    return SolveResult(
        problem=problem,
        params=result.params,
        solution=solution,
        exact=exact,
        mae=mean_absolute_error(exact, solution),
        loss_history=result.loss_history,
        iters_per_sec=result.iters_per_sec,
        wall_time=result.wall_time,
        compile_time=result.compile_time,
        device=(torch.cuda.get_device_name(device) if device.type == "cuda"
                else "cpu"),
    )
