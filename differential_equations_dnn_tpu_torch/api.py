"""High-level one-call API: ``solve(...)``.

    from differential_equations_dnn_tpu_torch import solve
    result = solve("heat")                   # reference defaults, on the GPU
    result = solve("heat", engine="fused")   # the same, in the fused kernels
    result.mae, result.solution, result.loss_history
"""

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.core.precision import (
    check_precision,
)
from differential_equations_dnn_tpu_torch.core.prng import generator
from differential_equations_dnn_tpu_torch.equations import (
    Problem,
    get_problem,
)
from differential_equations_dnn_tpu_torch.kernels import (
    fused_dgm,
    fused_engine,
)
from differential_equations_dnn_tpu_torch.kernels.build import resolve_device
from differential_equations_dnn_tpu_torch.kernels.fused_train import (
    train_heat_fused_result,
)
from differential_equations_dnn_tpu_torch.models import (
    HardConstraint,
    is_stateful,
    update_state,
)
from differential_equations_dnn_tpu_torch.parallel import (
    PopulationConfig,
    train_population,
    trial_model,
)
from differential_equations_dnn_tpu_torch.parallel.mesh import (
    as_mesh,
    mesh_device,
)
from differential_equations_dnn_tpu_torch.train import (
    TrainConfig,
    TrainResult,
    finetune_lbfgs,
    mean_absolute_error,
)
from differential_equations_dnn_tpu_torch.train import train as train_scan
from differential_equations_dnn_tpu_torch.utils import trace


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


def _auto_defaults(problem, model) -> tuple[int, int]:
    """(ensemble, finetune) used when the caller leaves them ``None``, as
    the JAX package picks them: FitzHugh–Nagumo's DGM arch with causal
    weighting turned off (``causal_eps=0``, the reference's multi-stable
    training) gets a 16-replica ensemble and a 200-step L-BFGS polish;
    everything else (causal FitzHugh–Nagumo included) trains one run,
    unpolished."""
    if model is not None:
        return 0, 0
    if (problem.name == "fitzhugh_nagumo"
            and getattr(problem, "arch", None) == "dgm"
            and getattr(problem, "causal_eps", 0.0) <= 0.0):
        return 16, 200
    return 0, 0


def _residual(problem, model, batch) -> float:
    """The plain mean ``point_loss`` on ``batch``: the selection metric.
    Not ``problem.loss``: a training protocol such as FitzHugh–Nagumo's
    causal weighting would discount late-time divergence out of it."""
    with torch.no_grad():
        return float(torch.mean(problem.point_loss(model, batch)))


def _polish_and_select(problem, models, val_losses, seed, steps):
    """L-BFGS-polish the 3 replicas with the lowest validation residual (JAX
    api.py:73-98), each on one 8192-point batch from ``seed + 3``, and keep
    the one with the lowest residual on a fresh batch from ``seed + 4``:
    which replica polishes best depends on the polish. Returns (picked
    index, polished model, polish losses)."""
    with trace.span("solve.polish", steps=steps, replicas=3):
        order = np.argsort(np.where(np.isfinite(val_losses), val_losses,
                                    np.inf))
        device = next(models[0].parameters()).device
        fresh = problem.validation_sample(4096, generator(seed + 4), device)
        best = None
        for i in order[:3]:
            polished, losses = finetune_lbfgs(problem, models[i], steps,
                                              batch_size=8192,
                                              generator=generator(seed + 3))
            r = _residual(problem, polished, fresh)
            if best is None or r < best[0]:
                best = (r, int(i), polished, losses)
    return best[1:]


def _polish(problem, model, loss_history, steps, seed):
    """A single run's L-BFGS polish on a batch from ``seed + 3``; a
    stateful model's running statistics are then refreshed on 1 024
    validation points from ``seed + 2`` (JAX api.py:425-437)."""
    with trace.span("solve.polish", steps=steps, replicas=1):
        model, ft_losses = finetune_lbfgs(problem, model, steps,
                                          generator=generator(seed + 3))
        if is_stateful(model):
            device = next(model.parameters()).device
            refresh = problem.validation_sample(1024, generator(seed + 2),
                                                device)
            update_state(model, problem.domain_inputs(refresh))
    return model, np.concatenate([loss_history, ft_losses])


def _train_scan_population(problem, model, seed, config, n_trials, device,
                           mesh=None):
    """``ensemble=N`` on the scan engine (JAX api.py:299-321): N trials of
    ``model``'s architecture as one population at the config's lr and
    batch, sharded over ``mesh``'s ``pop`` axis if given. Returns a
    TrainResult whose
    params are the N trained models and whose loss history is [N,
    iterations]; ``iters_per_sec`` counts population steps."""
    timings = {}
    pc = PopulationConfig(iterations=config.iterations,
                          max_batch_size=config.batch_size)
    stacked, opt_state, losses = train_population(
        problem, model, seed, np.full(n_trials, config.lrate, np.float32),
        config=pc, mesh=mesh, timings=timings, device=device)
    template = model.to(next(iter(stacked.values())).device).train()
    models = [trial_model(template, stacked, t, timings["state"])
              for t in range(n_trials)]
    wall = timings["run_time"]
    return TrainResult(params=models, opt_state=opt_state,
                       loss_history=losses.T, wall_time=wall,
                       iters_per_sec=(config.iterations / wall if wall
                                      else float("inf")),
                       compile_time=timings["compile_time"])


def _fused_route(problem, model, schedule="constant", batch_size=None) -> str:
    """Which fused engine trains (problem, model): "heat" (the specialised
    constant-lr heat kernel, kernels.fused_train), "dgm" (the DGM engine,
    kernels.fused_dgm) or "engine" (the generic spec engine,
    kernels.fused_engine). Raises, naming the ROADMAP item, for what the
    port does not run yet.

    A HardConstraint is routed first, as in the JAX package: the generic
    engine's hard specs train it (constant-lr heat included, which the heat
    kernel's soft loss must not take), and any other wrapped model (a
    custom ansatz, fitzhugh_nagumo's DGM) raises a ValueError naming the
    scan engine."""
    if isinstance(model, HardConstraint):
        if fused_engine.supports(problem, model):
            return "engine"
        raise ValueError(
            f"{problem.name!r} with constraint='hard' trains on the scan "
            f"engine (fused hard-constraint specs exist for "
            f"{sorted(fused_engine.HARD_SPECS)} with the default ansatz + "
            f"plain tanh MLP)")
    dgm_spec = fused_dgm.spec_for(problem, batch_size)
    if dgm_spec is not None:
        if fused_dgm.supports_model(dgm_spec, model):
            return "dgm"
        raise ValueError(
            f"{problem.name!r}'s fused path is the DGM engine, which needs "
            f"a DGM 1 → H×L → {dgm_spec.output_dim} with {dgm_spec.act!r} "
            f"gates (got {type(model).__name__}); pass model=None for the "
            f"default")
    if problem.name == "fredholm":
        raise ValueError(
            f"fredholm's fused path is the DGM engine, which needs "
            f"quadrature='gauss' (the {problem.quadrature} mode draws fresh "
            f"nodes per step); drop quadrature={problem.quadrature!r} or use "
            f"engine='scan'")
    if problem.name == "fitzhugh_nagumo":
        raise ValueError(
            "fitzhugh_nagumo's fused path is the DGM engine, which needs "
            "arch='dgm' (the fourier_mlp arch trains on the scan engine); "
            "drop arch= or use engine='scan'")
    spec = fused_engine.spec_for(problem)
    if spec is None:
        taps = getattr(problem, "taps", None)
        raise ValueError(f"no fused-engine spec for equation "
                         f"{problem.name!r}"
                         + (f" with taps={taps!r}" if taps == "pallas" else "")
                         + f" (available: {sorted(fused_engine.SPECS)}); "
                         f"use engine='scan'")
    if not spec.supports_model(model):
        raise ValueError(
            f"{problem.name!r}'s fused path needs "
            f"{spec.model_text.format(D=spec.input_dim)}, no BatchNorm, no "
            f"Fourier features (got {type(model).__name__}); use "
            f"engine='scan'")
    if problem.name == "heat" and schedule == "constant":
        return "heat"
    return "engine"


def solve(equation: str | Problem, *, iterations: int | None = None,
          batch_size: int | None = None, lrate: float | None = None,
          nodes: int | None = None, seed: int = 0, model=None, mesh=None,
          engine: str = "scan", precision: str = "highest",
          schedule: str | None = None, ensemble: int | None = None,
          finetune: int | None = None, device="cuda",
          **problem_kwargs) -> SolveResult:
    """Train a network on ``equation`` and validate against its ground truth.

    ``equation`` is a registry name (simple_ode, heat, burgers, wave,
    advection, poisson, heat2d, fitzhugh_nagumo, fredholm, volterra, uat,
    inverse_heat) or a Problem instance. Unset hyperparameters default to the reference's published
    configuration. ``engine="scan"`` (the default) trains with the generic
    trainer (train.trainer.train): any equation and model, one optimizer
    step of torch ops per batch; heat with ``taps="pallas"`` takes its
    streams from the heat-streams kernel there. ``engine="fused"`` trains
    inside the hand-written CUDA training kernels: constant-lr heat on the
    specialised heat kernel, the DGM equations (fitzhugh_nagumo, fredholm)
    on the DGM engine, everything else on the generic spec engine (uat's
    Perceptron and inverse_heat's net with its learnable κ̂ too);
    Fredholm's and Volterra's stochastic quadratures train on the scan
    engine only, as in the JAX package. ``constraint="hard"`` (simple_ode,
    heat, heat2d, wave, poisson, fitzhugh_nagumo) wraps the net in the
    equation's Lagaris trial function (models/hard.py); it trains on either
    engine, fitzhugh_nagumo's DGM on the scan engine only.
    ``schedule`` ("constant" | "cosine" | "exponential") overrides the
    equation's default lr schedule. ``model`` (default
    ``problem.default_model()`` initialised from ``seed``) is trained in
    place. ``precision`` picks the fused kernels' mode on every fused route,
    single runs and ensembles: "highest" (exact fp32), "default" (the layer
    products take bf16 operands and accumulate in fp32: the kernels' bf16
    tensor-core instances on the card) or "mixed" (the first 65 % of the
    steps at "default", the rest at "highest", on the same state); the scan
    trainer ignores it, as in the JAX package, and runs the port's
    strict-fp32 policy. An unknown precision raises a ValueError.

    ``ensemble=N`` trains N replicas (replica r drawn from
    ``replica_generator(seed, r)``): on the fused engine packed into every
    kernel launch, all on the collocation stream of ``seed``; on the scan
    engine as one population (parallel/population.py), each on its own
    stream. It keeps the replica with
    the lowest finite mean residual on an off-grid validation batch from
    ``seed + 1`` (a stateful replica on train-mode batch statistics);
    ``iters_per_sec`` is then population steps per second. ``finetune=N``
    polishes with N full-batch L-BFGS steps: a single run on a batch from
    ``seed + 3``; an ensemble polishes its best 3 replicas and keeps the one
    with the lowest residual on a fresh batch from ``seed + 4``. Both
    default to ``None`` = the JAX package's automatic choice:
    FitzHugh–Nagumo with ``causal_eps=0`` trains 16 replicas and polishes
    for 200 steps, everything else one unpolished run. A stateful
    population (BatchNorm) is not polished as an ensemble: its pick is
    polished as a single run, and a polished stateful model's running
    statistics are refreshed on 1 024 validation points from ``seed + 2``,
    as in the JAX package. ``device`` defaults to "cuda" and raises
    without a GPU; "cpu" runs the kernels' plain PyTorch versions.

    ``mesh`` (parallel/mesh.py's mesh, or an ``{axis: size}`` dict made
    into one on ``device``) spreads the run over the ranks of a process
    group, each of which calls ``solve`` (JAX api.py:246-372): a fused
    ensemble shards its replicas over the mesh's ``pop`` axis
    (``fused_engine.train_fused_ensemble``,
    ``fused_dgm.train_dgm_fused_ensemble``), a scan ensemble its trials
    (``train_population``), and a single scan run trains data-parallel
    over its ``data`` axis (``train``). A single fused run is one kernel
    and raises. Every rank returns the same result, on its own device.
    """
    with trace.span("solve") as call:
        check_precision(precision)
        problem = (get_problem(equation, **problem_kwargs)
                   if isinstance(equation, str) else equation)
        if ensemble is None or finetune is None:
            auto_ens, auto_ft = _auto_defaults(problem, model)
            ensemble = auto_ens if ensemble is None else ensemble
            finetune = auto_ft if finetune is None else finetune
        if engine not in ("scan", "fused"):
            raise ValueError(f"unknown engine {engine!r} (scan | fused)")
        if mesh is not None and engine == "fused" and ensemble <= 1:
            raise ValueError(
                "a SINGLE fused run is one kernel on one GPU and cannot "
                "shard over a mesh; use ensemble=N with mesh=make_mesh("
                "{'pop': K}) (sharded fused ensemble — kernels.fused_engine."
                "train_fused_ensemble), or engine='scan' with "
                "mesh=make_mesh({'data': K}) for data-parallel single-run "
                "training")
        device = resolve_device(device)
        if mesh is not None:
            mesh = as_mesh(mesh, device)
            device = mesh_device(mesh)

        d = problem.defaults
        config = TrainConfig(
            iterations=iterations if iterations is not None
            else d.iterations,
            batch_size=batch_size if batch_size is not None
            else d.batch_size,
            lrate=lrate if lrate is not None else d.lrate,
            schedule=schedule if schedule is not None else d.schedule,
            verbose=False,
        )
        nodes = nodes if nodes is not None else d.nodes
        with trace.span("solve.setup"):
            single = (model if model is not None
                      else problem.default_model(generator=generator(seed)))
            route = ("scan" if engine == "scan" else
                     _fused_route(problem, single, config.schedule,
                                  config.batch_size))
        call.attrs.update(equation=problem.name, engine=engine, route=route,
                          ensemble=ensemble)

        common = dict(batch_size=config.batch_size, lrate=config.lrate,
                      chunk_size=config.chunk_size, precision=precision,
                      device=device)
        with trace.span("solve.train"):
            if ensemble > 1 and route == "scan":
                result = _train_scan_population(problem, single, seed,
                                                config, ensemble, device,
                                                mesh)
            elif ensemble > 1 and mesh is not None:
                train = (fused_dgm.train_dgm_fused_ensemble if route == "dgm"
                         else fused_engine.train_fused_ensemble)
                timings = {}
                models, losses = train(problem, seed, config.iterations,
                                       ensemble, mesh=mesh, model=model,
                                       schedule=config.schedule,
                                       timings=timings, **common)
                wall = timings["run_time"]
                result = TrainResult(
                    params=models, opt_state=None, loss_history=losses,
                    wall_time=wall,
                    iters_per_sec=(config.iterations / wall if wall
                                   else float("inf")),
                    compile_time=timings["compile_time"])
            elif ensemble > 1:
                train = (fused_dgm.train_dgm_fused_ensemble_packed
                         if route == "dgm"
                         else fused_engine.train_fused_ensemble_packed)
                result = train(problem, seed, config.iterations, ensemble,
                               model=model, schedule=config.schedule,
                               **common)
            elif route == "scan":
                result = train_scan(problem, seed, config, model=single,
                                    device=device, mesh=mesh)
            elif route == "heat":
                result = train_heat_fused_result(problem, seed,
                                                 config.iterations,
                                                 model=single, **common)
            else:
                train = (fused_dgm.train_dgm_fused_result if route == "dgm"
                         else fused_engine.train_fused_result)
                result = train(problem, seed, config.iterations,
                               model=single, schedule=config.schedule,
                               **common)
        if ensemble > 1:
            with trace.span("solve.select"):
                val = problem.validation_sample(4096, generator(seed + 1),
                                                device)
                val_losses = np.array([_residual(problem, m, val)
                                       for m in result.params])
                pick = int(np.argmin(np.where(np.isfinite(val_losses),
                                              val_losses, np.inf)))
            # A stateful population is not polished as an ensemble (JAX
            # api.py:340); its pick is polished below as a single run.
            if finetune and not is_stateful(single):
                pick, trained, ft_losses = _polish_and_select(
                    problem, result.params, val_losses, seed, finetune)
                loss_history = np.concatenate([result.loss_history[pick],
                                               ft_losses])
            else:
                trained = result.params[pick]
                loss_history = result.loss_history[pick]
                if finetune:
                    trained, loss_history = _polish(
                        problem, trained, loss_history, finetune, seed)
        else:
            trained, loss_history = result.params, result.loss_history
            if finetune:
                trained, loss_history = _polish(problem, trained,
                                                loss_history, finetune, seed)
        with trace.span("solve.eval", nodes=nodes):
            solution = problem.evaluate(trained, nodes)
            exact = problem.exact(nodes)
            mae = mean_absolute_error(exact, solution)
        return SolveResult(
            problem=problem,
            params=trained,
            solution=solution,
            exact=exact,
            mae=mae,
            loss_history=loss_history,
            iters_per_sec=result.iters_per_sec,
            wall_time=result.wall_time,
            compile_time=result.compile_time,
            device=(torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
        )

