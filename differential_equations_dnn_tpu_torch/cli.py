"""Command-line interface.

Counterpart of the JAX package's cli.py, flag for flag: one entry point
with per-equation subcommands, preserving the reference's flag set
(``--solve --plot --savefig --niters --nnodes --batch-size``,
heat.py:191-205) plus the framework's extensions (``--lrate --seed
--checkpoint --restore --export --results-dir ...``), and subcommands for
the sweep and ablation drivers (optimize_heat_ray.py,
batchsize_effect_heat.py, batchnorm_effect_heat.py).

Artifact file names and shapes match the reference's ``temp_results/``
layout (heat.py:220-225, simple_ode.py:184-186, fredholm.py:184-185,
fitzhugh_nagumo.py:226-227) and the JAX CLI's, so either package's
``--plot`` reads the other's ``--solve``; the ``<eq>_run.pms`` and
``<eq>_run.json`` manifests carry the same keys. A checkpoint is a
directory (train/checkpoint.py) and an export a ``torch.export`` program
(serving.py).

``--platform`` picks the torch device: ``cuda`` (the default) or
``cpu``. Without a GPU and without ``--platform cpu`` the CLI exits with
an error naming the flag; it never falls back to the CPU by itself.

Usage:
    python -m differential_equations_dnn_tpu_torch heat --solve --plot --savefig
    python -m differential_equations_dnn_tpu_torch heat --solve --engine fused
    python -m differential_equations_dnn_tpu_torch sweep --equation heat --num-samples 10
    python -m differential_equations_dnn_tpu_torch ablation-batchsize
"""

import argparse
import json
from pathlib import Path

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.core.prng import generator
from differential_equations_dnn_tpu_torch.equations import PROBLEMS
from differential_equations_dnn_tpu_torch.train import (
    TrainConfig,
    save_checkpoint,
    train,
)
from differential_equations_dnn_tpu_torch.train.checkpoint import model_state
from differential_equations_dnn_tpu_torch.utils import (
    fn_timer,
    load_array,
    parameters_summary,
    save_array,
)

# (solution, loss, exact, figure) artifact names per equation — reference layout.
ARTIFACTS = {
    "simple_ode": ("test_simple_ode_nn_sol", "test_simple_ode_nn_loss",
                   "test_simple_ode_sol", "figs/simple_ode_solution.pdf"),
    "heat": ("heat_sol_1d_dgm", "heat_sol_1d_dgm_loss",
             "heat_sol_exact_1d", "figs/heat_1dim_solution.pdf"),
    "heat2d": ("heat_sol_2d_dgm", "heat_sol_2d_dgm_loss",
               "heat_sol_exact_2d", "figs/heat_2dim_solution.pdf"),
    "burgers": ("burgers_sol_dgm", "burgers_sol_dgm_loss",
                "burgers_sol_exact", "figs/burgers_solution.pdf"),
    "inverse_heat": ("inverse_heat_sol_dgm", "inverse_heat_sol_dgm_loss",
                     "inverse_heat_sol_exact", "figs/inverse_heat_solution.pdf"),
    "fredholm": ("fredholm_approx", "fredholm_loss",
                 "fredholm_exact", "figs/fredholm_solution.pdf"),
    "fitzhugh_nagumo": ("new_fn_solution_dgm", "new_fn_loss_dgm",
                        "new_fn_solution_exact", "figs/fitzhugh_nagumo_solution.pdf"),
    "uat": ("approximation", "uat_loss", "ground_truth", "figs/universal_approx.pdf"),
    "wave": ("wave_sol_dgm", "wave_sol_dgm_loss",
             "wave_sol_exact", "figs/wave_solution.pdf"),
    "advection": ("advection_sol_dgm", "advection_sol_dgm_loss",
                  "advection_sol_exact", "figs/advection_solution.pdf"),
    "poisson": ("poisson_sol_dgm", "poisson_sol_dgm_loss",
                "poisson_sol_exact", "figs/poisson_solution.pdf"),
    "volterra": ("volterra_approx", "volterra_loss",
                 "volterra_exact", "figs/volterra_solution.pdf"),
}

PLATFORM_HELP = ("the torch device: cuda (default; exits if there is no "
                 "GPU) or cpu (the kernels' plain PyTorch versions)")


def _add_common_flags(p: argparse.ArgumentParser, defaults):
    p.add_argument("--solve", action="store_true")
    p.add_argument("--plot", action="store_true")
    p.add_argument("--savefig", action="store_true")
    p.add_argument("--niters", type=int, default=defaults.iterations)
    p.add_argument("--nnodes", type=int, default=defaults.nodes)
    p.add_argument("--batch-size", type=int, default=defaults.batch_size)
    # default None = "not set on the command line": the effective default
    # (problem.defaults.lrate, possibly remapped by --parity) resolves in
    # _cmd_equation after the problem is built.
    p.add_argument("--lrate", type=float, default=None,
                   help=f"default: {defaults.lrate}")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--schedule",
                   choices=["constant", "cosine", "exponential"],
                   default=None,
                   help=f"lr schedule (default: the equation's own, "
                        f"{defaults.schedule}; --parity on fredholm "
                        f"forces constant)")
    p.add_argument("--checkpoint", type=str, default=None,
                   help="save trained params/opt_state to this directory")
    p.add_argument("--restore", type=str, default=None,
                   help="resume training from a checkpoint directory")
    p.add_argument("--export", type=str, default=None, dest="export_path",
                   help="serialise the trained solution (a torch.export "
                        "program) to this file for serving")
    p.add_argument("--finetune", type=int, default=None,
                   help="polish with N full-batch L-BFGS steps after Adam "
                        "(~2-3x lower MAE; try 200). Default: auto — 200 "
                        "for the init-sensitive fitzhugh-nagumo DGM arch, "
                        "off otherwise; pass 0 to force off")
    p.add_argument("--results-dir", type=str, default="temp_results")
    p.add_argument("--mesh", type=int, default=0,
                   help="shard the collocation batch over N ranks of a "
                        "torch.distributed group (0 = off)")
    p.add_argument("--ensemble", type=int, default=None,
                   help="train N replicas and keep the best by off-grid "
                        "validation residual (default: auto — 16 for the "
                        "init-sensitive fitzhugh-nagumo DGM arch, single "
                        "run otherwise; pass 1 to force single)")
    p.add_argument("--platform", type=str, default="cuda",
                   help=PLATFORM_HELP)


def _restore(problem, model, config, args, fused):
    """Load ``args.restore`` into ``model``; returns (opt_state, start_step). The collocation stream is keyed by the
    seed, so the checkpoint's seed wins over ``--seed``."""
    from differential_equations_dnn_tpu_torch.train import (
        checkpoint_like,
        restore_checkpoint,
    )

    like = checkpoint_like(problem, config, model=model, seed=args.seed,
                           engine="fused" if fused else "scan")
    ckpt = restore_checkpoint(args.restore, like=like, device=args.device)
    # The state_dict holds a stateful model's running statistics too.
    model.load_state_dict(ckpt["params"])
    start_step = int(ckpt["step"])
    if int(ckpt["seed"]) != args.seed:
        # The collocation stream is keyed by the seed; resuming under a
        # different one would silently change the trajectory.
        print(f"[restore] checkpoint was trained with --seed "
              f"{int(ckpt['seed'])}; using it instead of {args.seed}")
        args.seed = int(ckpt["seed"])
    print(f"Restored checkpoint at step {start_step} from {args.restore}")
    return ckpt["opt_state"], start_step


@fn_timer
def _solve(problem, args):
    if getattr(args, "ensemble", 0) and args.ensemble > 1:
        return _solve_ensemble(problem, args)
    schedule = getattr(args, "schedule", None) or problem.defaults.schedule
    config = TrainConfig(iterations=args.niters, batch_size=args.batch_size,
                         lrate=args.lrate, schedule=schedule)
    fused = getattr(args, "engine", "scan") == "fused"
    if fused and args.mesh:
        raise SystemExit("--engine fused is single-GPU (use the default "
                         "scan engine with --mesh)")
    mesh = None
    if args.mesh:
        from differential_equations_dnn_tpu_torch.parallel import make_mesh

        mesh = make_mesh({"data": args.mesh}, device=args.device)
    model = problem.default_model(generator=generator(args.seed))
    route = None
    if fused:
        from differential_equations_dnn_tpu_torch.api import _fused_route

        try:
            # "heat" (kernel #1) at a constant lr; any other schedule of
            # heat's goes to the spec engine.
            route = _fused_route(problem, model, schedule, args.batch_size)
        except ValueError as e:
            raise SystemExit(str(e)) from None
    opt_state = None
    start_step = 0
    if args.restore:
        opt_state, start_step = _restore(problem, model, config, args, fused)
    precision = getattr(args, "precision", "highest")
    if fused:
        common = dict(batch_size=args.batch_size, lrate=args.lrate,
                      model=model, opt_state=opt_state,
                      start_step=start_step, precision=precision,
                      device=args.device)
        if route == "heat":
            from differential_equations_dnn_tpu_torch.kernels.fused_train import (
                train_heat_fused_result,
            )

            result = train_heat_fused_result(problem, args.seed, args.niters,
                                             **common)
        elif route == "dgm":
            from differential_equations_dnn_tpu_torch.kernels import fused_dgm

            result = fused_dgm.train_dgm_fused_result(
                problem, args.seed, args.niters, schedule=schedule, **common)
        else:
            from differential_equations_dnn_tpu_torch.kernels.fused_engine import (
                train_fused_result,
            )

            result = train_fused_result(problem, args.seed, args.niters,
                                        schedule=schedule, **common)
    else:
        result = train(problem, args.seed, config, model=model,
                       opt_state=opt_state, start_step=start_step,
                       device=args.device, mesh=mesh)
    loss_history = result.loss_history
    if getattr(args, "finetune", 0):
        from differential_equations_dnn_tpu_torch.train import finetune_lbfgs

        model, ft_losses = finetune_lbfgs(problem, model, args.finetune,
                                          generator=generator(args.seed + 1))
        loss_history = np.concatenate([loss_history, ft_losses])
        print(f"[{problem.name}] L-BFGS finetune: loss "
              f"{ft_losses[0]:.3e} -> {ft_losses[-1]:.3e}")
    # A plain MLP's grid runs through the MLP-forward kernel (#2).
    y_approx = problem.evaluate(model, args.nnodes)
    y_exact = problem.exact(args.nnodes)

    sol_name, loss_name, exact_name, _ = ARTIFACTS[problem.name]
    save_array(sol_name, y_approx, directory=args.results_dir)
    save_array(loss_name, loss_history, directory=args.results_dir)
    save_array(exact_name, y_exact, directory=args.results_dir)
    if problem.name == "uat":
        # Reference also saves the evaluation grid
        # (demo_universal_approx_theorem.py:89: np.save("space", x0)).
        save_array("space", problem.grid_inputs(args.nnodes),
                   directory=args.results_dir)

    if args.checkpoint:
        # Full optimisation state: resuming continues bit for bit an
        # uninterrupted run (Adam moments and count included; the
        # step-keyed collocation stream makes the data identical too).
        tree = {"params": model.state_dict(),
                "opt_state": result.opt_state,
                "step": start_step + args.niters,
                "seed": args.seed}
        state = model_state(model)
        if state is not None:
            tree["state"] = state
        save_checkpoint(args.checkpoint, tree)
    if args.export_path:
        from differential_equations_dnn_tpu_torch.serving import (
            export_solution,
        )

        export_solution(model, input_dim=model.input_dim,
                        path=args.export_path)
        print(f"Exported solution artifact to {args.export_path}")
    parameters_summary(
        {"equation": problem.name, "iterations": args.niters,
         "batch_size": args.batch_size, "lrate": args.lrate,
         "schedule": schedule,
         "engine": getattr(args, "engine", "scan"),
         "precision": precision,
         "nnodes": args.nnodes, "seed": args.seed,
         "iters_per_sec": round(result.iters_per_sec, 1),
         "wall_time_s": round(result.wall_time, 3),
         "compile_time_s": round(result.compile_time, 3),
         "final_loss": float(loss_history[-1])},
        args.results_dir, name=f"{problem.name}_run",
    )
    if hasattr(problem, "kappa_error"):
        kappa_hat = float(model.kappa().detach())
        print(f"[{problem.name}] identified kappa = {kappa_hat:.4f} "
              f"(true {problem.kappa_true}, |err| "
              f"{problem.kappa_error(model):.4f})")
    print(f"[{problem.name}] {result.iters_per_sec:.0f} iters/s, "
          f"final loss {float(loss_history[-1]):.3e}")
    return result


def _solve_ensemble(problem, args):
    from differential_equations_dnn_tpu_torch.api import solve as api_solve

    res = api_solve(problem, iterations=args.niters,
                    batch_size=args.batch_size, lrate=args.lrate,
                    nodes=args.nnodes, seed=args.seed, ensemble=args.ensemble,
                    finetune=getattr(args, "finetune", 0),
                    engine=getattr(args, "engine", "scan"),
                    precision=getattr(args, "precision", "highest"),
                    schedule=getattr(args, "schedule", None),
                    device=args.device)
    sol_name, loss_name, exact_name, _ = ARTIFACTS[problem.name]
    save_array(sol_name, res.solution, directory=args.results_dir)
    save_array(loss_name, res.loss_history, directory=args.results_dir)
    save_array(exact_name, res.exact, directory=args.results_dir)
    if args.checkpoint:
        tree = {"params": res.params.state_dict(), "step": args.niters,
                "seed": args.seed}
        state = model_state(res.params)
        if state is not None:
            tree["state"] = state
        save_checkpoint(args.checkpoint, tree)
    print(f"[{problem.name}] ensemble={args.ensemble}: best-trial MAE "
          f"{res.mae:.6f}, {res.iters_per_sec:.0f} iters/s (population, "
          f"compile {res.compile_time:.1f}s excluded)")
    return res


def _viz(savefig: bool):
    """The figures module, or None where matplotlib is not installed and no
    figure file was asked for (the MAE needs no figure); ``--savefig``
    without matplotlib exits, naming it."""
    try:
        from differential_equations_dnn_tpu_torch import viz
    except ModuleNotFoundError as e:
        if e.name != "matplotlib":
            raise
        if savefig:
            raise SystemExit("--savefig needs matplotlib, which is not "
                             "installed") from None
        print("[plot] matplotlib is not installed: no figure drawn")
        return None
    return viz


def _plot(problem, args):
    from differential_equations_dnn_tpu_torch.train.metrics import (
        mean_absolute_error,
    )

    sol_name, loss_name, exact_name, fig_name = ARTIFACTS[problem.name]
    try:
        y_approx = load_array(sol_name, directory=args.results_dir)
        loss = load_array(loss_name, directory=args.results_dir)
        y_exact = load_array(exact_name, directory=args.results_dir)
    except FileNotFoundError as e:
        raise SystemExit(
            f"No saved results for '{problem.name}' in {args.results_dir}/ "
            f"({e.filename}). Run with --solve first."
        ) from e
    savepath = fig_name if args.savefig else None
    # Every figure annotates this MAE (heat2d's whole cube, though it draws
    # the mid-time slice).
    mae = mean_absolute_error(y_exact, y_approx)
    viz = _viz(args.savefig)
    if viz is None:
        pass
    elif problem.name in ("heat", "inverse_heat", "wave", "poisson",
                          "advection"):
        viz.plot_heat(y_exact, y_approx, loss, args.niters,
                      savepath=savepath)
    elif problem.name == "burgers":
        viz.plot_heat(y_exact, y_approx, loss, args.niters,
                      savepath=savepath, vmin=None, vmax=None)
    elif problem.name == "heat2d":
        # Plot the mid-time (x, y) slice of the 3-D solution cube.
        mid = y_approx.shape[0] // 2
        viz.plot_heat(y_exact[mid], y_approx[mid], loss, args.niters,
                      savepath=savepath)
    elif problem.name == "fitzhugh_nagumo":
        grid = problem.grid_inputs(len(y_approx))[:, 0].numpy()
        viz.plot_fitzhugh_nagumo(grid, y_exact, y_approx, loss,
                                 savepath=savepath)
    else:
        grid = problem.grid_inputs(len(y_approx))[:, 0].numpy()
        viz.plot_solution_and_loss(grid, y_exact, y_approx, loss,
                                   problem.name, savepath=savepath)
    print(f"[{problem.name}] DGM MAE: {np.round(mae, 6)}")
    return mae


def _cmd_equation(name, args):
    problem_cls = PROBLEMS[name]
    extra = {}
    if getattr(args, "constraint", "soft") == "hard":
        extra["constraint"] = "hard"
        if name in ("heat", "heat2d"):
            # Hard constraints wrap the model, so the Taylor-stream taps
            # cannot read its MLP structure.
            args.taps = "jvp"
    if name == "fredholm":
        parity = getattr(args, "parity", False)
        if parity:
            # Reference-exact configuration (fredholm.py:142-144): k=50
            # Monte-Carlo quadrature nodes, lr 1e-4, constant schedule.
            args.quadrature, args.quad_nodes = "montecarlo", 50
        problem = problem_cls(quadrature=args.quadrature, k=args.quad_nodes)
        if parity:
            from dataclasses import replace

            problem = replace(problem, defaults=replace(
                problem.defaults, lrate=1e-4, schedule="constant"))
    elif name == "volterra":
        problem = problem_cls(quadrature=args.quadrature, k=args.quad_nodes)
    elif name == "advection":
        kw = {}
        if getattr(args, "c", None) is not None:
            kw["c"] = args.c
        if getattr(args, "causal_eps", 0.0):
            kw["causal_eps"] = args.causal_eps
        problem = problem_cls(**kw)
    elif name == "fitzhugh_nagumo":
        problem = problem_cls(arch=args.arch, **extra)
    elif name in ("heat", "heat2d"):
        # The CLI's own default taps ("taylor"), not the class's ("jvp").
        problem = problem_cls(taps=args.taps, **extra)
    else:
        problem = problem_cls(**extra)
    if args.lrate is None:
        # Resolve the sentinel against the final problem (after --parity's
        # defaults remap); an explicit --lrate always survives.
        args.lrate = problem.defaults.lrate
    # The JAX package's robust defaults (api._auto_defaults): the
    # FitzHugh–Nagumo DGM arch with causal weighting off gets ensemble 16
    # and a 200-step L-BFGS polish. Force off with --ensemble 1 /
    # --finetune 0.
    from differential_equations_dnn_tpu_torch.api import _auto_defaults

    auto_ens, auto_ft = _auto_defaults(problem, None)
    if getattr(args, "ensemble", None) is None:
        args.ensemble = auto_ens
        if args.ensemble:
            print(f"[{name}] arch=dgm is init-sensitive: defaulting to "
                  f"--ensemble {args.ensemble} (pass --ensemble 1 to force "
                  f"a single run)")
    if getattr(args, "finetune", None) is None:
        args.finetune = auto_ft
    if args.solve:
        _solve(problem, args)
    if args.plot:
        _plot(problem, args)
    if not (args.solve or args.plot):
        print("Nothing to do: pass --solve and/or --plot")


def _full_space(problem, args):
    """``--space full`` of tpe-fused: the reference's batch_size / n_iters /
    lrate space, on whichever fused engine trains the equation; None (the
    lr-only space) where neither does."""
    from differential_equations_dnn_tpu_torch.kernels import (
        fused_dgm,
        fused_engine,
    )
    from differential_equations_dnn_tpu_torch.sweep import (
        SearchSpace,
        heat_search_space,
        loguniform,
        randint,
    )

    if fused_dgm.supports(problem, None, problem.defaults.batch_size):
        # The budget range from the equation's own protocol (the
        # reference's 1000..50000 is heat's); batch_size spans the
        # reference's randint[1, 512) clamped to the sampler cap.
        it = args.max_iters or problem.defaults.iterations
        print(f"[{args.equation}] DGM fused engine: sweeping the full space "
              f"— batch_size, lrate, n_iters in [{max(100, it // 10)}, {it}]")
        return SearchSpace({
            "batch_size": randint(1, args.max_batch_size),
            "n_iters": randint(max(100, it // 10), it + 1),
            "lrate": loguniform(1e-4, 1e-1),
        })
    if fused_engine.spec_for(problem) is not None:
        return heat_search_space()
    return None


def _cmd_sweep(args):
    from differential_equations_dnn_tpu_torch import sweep

    problem = PROBLEMS[args.equation]()
    mesh = None
    if args.mesh:
        from differential_equations_dnn_tpu_torch.parallel import make_mesh

        mesh = make_mesh({"pop": args.mesh}, device=args.device)
    # The JAX drivers' (key, seed) are (seed, sampler_seed) here.
    common = dict(seed=args.seed, num_samples=args.num_samples,
                  max_batch_size=args.max_batch_size, device=args.device)
    halving = dict(max_budget=args.max_iters, eta=args.eta,
                   min_budget=args.min_budget, sampler_seed=args.seed,
                   mesh=mesh, **common)
    if args.scheduler == "asha":
        result = sweep.successive_halving(problem, **halving)
    elif args.scheduler == "asha-fused":
        # --mesh N shards each rung's trials over a 'pop' mesh.
        result = sweep.halving_search_fused(problem,
                                            schedule=args.lr_schedule,
                                            **halving)
    elif args.scheduler == "tpe-asha-fused":
        result = sweep.tpe_halving_fused(problem, brackets=args.brackets,
                                         schedule=args.lr_schedule,
                                         **halving)
    elif args.scheduler == "tpe":
        result = sweep.tpe_search(problem, max_iters=args.max_iters,
                                  mesh=mesh, sampler_seed=args.seed,
                                  **common)
    elif args.scheduler == "tpe-asha":
        result = sweep.tpe_halving(problem, brackets=args.brackets,
                                   **halving)
    elif args.scheduler == "tpe-fused":
        if args.mesh:
            raise SystemExit("--scheduler tpe-fused is single-GPU")
        space = _full_space(problem, args) if args.space == "full" else None
        result = sweep.tpe_search_fused(
            problem, max_iters=args.max_iters, sampler_seed=args.seed,
            space=space, schedule=args.lr_schedule, q=args.concurrent,
            **common)
    else:
        result = sweep.random_search(problem, max_iters=args.max_iters,
                                     mesh=mesh, **common)
    print("Best config:", json.dumps(result.best_config, default=float))
    print(f"Best loss: {result.best_score:.6e}")
    out = Path(args.results_dir)
    out.mkdir(parents=True, exist_ok=True)
    with (out / f"sweep_{args.equation}.json").open("w") as f:
        json.dump({"best_config": result.best_config,
                   "best_score": float(result.best_score),
                   "configs": result.configs,
                   "scores": np.asarray(result.scores).tolist()}, f,
                  indent=2, default=float)
    return result


def _cmd_ablation_batchsize(args):
    from differential_equations_dnn_tpu_torch.sweep import batch_size_effect

    viz = _viz(args.savefig)  # before the runs: --savefig may exit

    res = batch_size_effect(seed=args.seed, runs=args.runs,
                            iterations=args.niters, device=args.device)
    for label, curve in zip(res.labels, res.mean_losses):
        save_array(f"heat_loss_bs_{label}", curve, directory=args.results_dir)
    # Reference-compatible pickle (batchsize_effect_heat.py:204-205).
    import pickle

    with (Path(args.results_dir) / "losses.pkl").open("wb") as f:
        pickle.dump({int(l): c for l, c in zip(res.labels, res.mean_losses)}, f)
    savepath = "figs/batchsize_effect.pdf" if args.savefig else None
    if viz is not None:
        viz.plot_ablation(res.as_dict(), savepath=savepath)
    return res


def _cmd_ablation_batchnorm(args):
    from differential_equations_dnn_tpu_torch.sweep import batchnorm_effect

    viz = _viz(args.savefig)  # before the runs: --savefig may exit

    res = batchnorm_effect(seed=args.seed, runs=args.runs,
                           iterations=args.niters, device=args.device)
    # Reference artifact names (batchnorm_effect_heat.py:312,330,347).
    names = {"none": "relu_heat_loss_nobn", "pre": "relu_heat_loss_bn_pre",
             "post": "relu_heat_loss_bn_post"}
    for label, curves in zip(res.labels, res.all_losses):
        save_array(names[label], curves, directory=args.results_dir)
    savepath = "figs/batchnorm_effect.pdf" if args.savefig else None
    if viz is not None:
        viz.plot_ablation(res.as_dict(), savepath=savepath)
    return res


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="differential_equations_dnn_tpu_torch",
        description="Deep Galerkin solvers for ODEs, PDEs and integral "
                    "equations on an NVIDIA GPU (PyTorch and CUDA)",
        epilog="-",
    )
    sub = parser.add_subparsers(dest="command", required=True)

    for name in PROBLEMS:
        p = sub.add_parser(name.replace("_", "-"), help=f"solve {name}")
        _add_common_flags(p, PROBLEMS[name]().defaults)
        if name == "fredholm":
            p.add_argument("--quadrature",
                           choices=["montecarlo", "gauss", "halton"],
                           default="gauss",
                           help="integral quadrature (default gauss: beats "
                                "the reference MAE on every seed)")
            p.add_argument("--quad-nodes", type=int, default=50)
            p.add_argument("--parity", action="store_true",
                           help="reference-exact mode: Monte-Carlo "
                                "quadrature with k=50, lr 1e-4, constant "
                                "schedule (fredholm.py:142-144; seed-noisy "
                                "by construction)")
        if name == "heat":
            p.add_argument("--taps", choices=["jvp", "taylor", "pallas"],
                           default="taylor",
                           help="derivative-tap path on the scan engine; "
                                "taylor = stacked Taylor streams (default), "
                                "pallas = the heat-streams kernel (#3), "
                                "jvp = generic")
        if name in ("simple_ode", "heat", "burgers", "wave", "poisson",
                    "heat2d", "fitzhugh_nagumo", "fredholm", "volterra",
                    "advection"):
            p.add_argument("--engine", choices=["scan", "fused"],
                           default="scan",
                           help="training executor: scan = the generic "
                                "trainer; fused = the hand-written CUDA "
                                "training kernels (heat the heat kernel "
                                "#1, MLP equations the spec engine, DGM "
                                "equations the DGM engine)")
            p.add_argument("--precision",
                           choices=["highest", "mixed", "default"],
                           default="highest",
                           help="fused-engine product mode: highest = exact "
                                "fp32 (bit-identical resume); mixed = bf16 "
                                "phase then fp32 phase; default = bf16 "
                                "tensor-core products throughout")
        if name == "heat2d":
            p.add_argument("--taps", choices=["jvp", "taylor"],
                           default="taylor")
        if name == "volterra":
            p.add_argument("--quadrature", choices=["gauss", "montecarlo"],
                           default="gauss",
                           help="variable-limit quadrature: gauss = rescaled "
                                "Gauss-Legendre (deterministic), montecarlo "
                                "= fresh t ~ x*U per step")
            p.add_argument("--quad-nodes", type=int, default=50)
        if name == "advection":
            p.add_argument("--speed", type=float, default=None, dest="c",
                           help="transport speed c (default 2*pi; high c "
                                "is the canonical PINN failure mode — "
                                "pair with --causal-eps)")
            p.add_argument("--causal-eps", type=float, default=0.0,
                           help="causal residual weighting strength "
                                "(Wang et al. 2022; 0 = off)")
        if name == "fitzhugh_nagumo":
            p.add_argument("--arch", choices=["dgm", "fourier_mlp"],
                           default="dgm",
                           help="dgm = reference parity (init-sensitive; "
                                "pair with --ensemble); fourier_mlp = "
                                "seed-robust, ~10x lower MAE")
        if name in ("simple_ode", "heat", "wave", "poisson", "heat2d",
                    "fitzhugh_nagumo"):
            p.add_argument("--constraint", choices=["soft", "hard"],
                           default="soft",
                           help="soft = reference-style weighted IC/BC loss "
                                "terms; hard = Lagaris trial function — "
                                "IC/BC hold exactly, only the domain "
                                "residual trains")
        p.set_defaults(func=lambda a, n=name: _cmd_equation(n, a))

    p = sub.add_parser("sweep", help="hyperparameter search "
                                     "(replaces Ray Tune)")
    p.add_argument("--equation", choices=list(PROBLEMS), default="heat")
    p.add_argument("--num-samples", type=int, default=10)
    p.add_argument("--max-iters", type=int, default=None)
    p.add_argument("--max-batch-size", type=int, default=512)
    p.add_argument("--eta", type=int, default=3,
                   help="halving keep-fraction 1/eta per rung "
                        "(asha/tpe-asha/*-fused variants)")
    p.add_argument("--min-budget", type=int, default=500,
                   help="first halving rung's iteration budget")
    p.add_argument("--brackets", type=int, default=3,
                   help="TPE x halving brackets (tpe-asha, tpe-asha-fused)")
    p.add_argument("--scheduler",
                   choices=["random", "asha", "tpe", "tpe-asha", "tpe-fused",
                            "asha-fused", "tpe-asha-fused"],
                   default="random",
                   help="random = pure sampling; asha = successive halving; "
                        "tpe = adaptive model-based (the reference's "
                        "OptunaSearch role, optimize_heat_ray.py:179); "
                        "tpe-asha = both composed; these four train "
                        "populations on the scan engine. tpe-fused = TPE "
                        "with every trial trained to its own budget inside "
                        "the fused kernels (lr, batch_size and n_iters are "
                        "run-time values; fused-spec equations only); "
                        "asha-fused = successive halving with every rung "
                        "inside the fused kernels; tpe-asha-fused = the "
                        "reference's TPE+ASHA pairing on the fused tier")
    p.add_argument("--lr-schedule",
                   choices=["constant", "cosine", "exponential"],
                   default=None,
                   help="per-trial lr schedule for the fused schedulers "
                        "(tpe-fused, asha-fused, tpe-asha-fused); decay "
                        "schedules follow each trial's/rung's own budget. "
                        "Default: tpe-fused lr-only sweeps inherit the "
                        "equation's schedule; full spaces and the halving "
                        "schedulers use constant")
    p.add_argument("--concurrent", type=int, default=1,
                   help="tpe-fused: q concurrent proposals per TPE round, "
                        "each round one packed kernel launch (the "
                        "reference's ConcurrencyLimiter(max_concurrent=5), "
                        "optimize_heat_ray.py:180)")
    p.add_argument("--space", choices=["full", "lr"], default="full",
                   help="tpe-fused search space: full = the reference's "
                        "batch_size/n_iters/lrate "
                        "(optimize_heat_ray.py:173-176, run-time masked); "
                        "lr = learning rate only")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh", type=int, default=0,
                   help="shard trials over a {'pop': N} mesh of "
                        "torch.distributed ranks")
    p.add_argument("--results-dir", type=str, default="temp_results")
    p.add_argument("--platform", type=str, default="cuda",
                   help=PLATFORM_HELP)
    p.set_defaults(func=_cmd_sweep)

    for cmd, fn, niters in [("ablation-batchsize", _cmd_ablation_batchsize, 15000),
                            ("ablation-batchnorm", _cmd_ablation_batchnorm, 15000)]:
        p = sub.add_parser(cmd)
        p.add_argument("--runs", type=int, default=5)
        p.add_argument("--niters", type=int, default=niters)
        p.add_argument("--savefig", action="store_true")
        p.add_argument("--seed", type=int, default=0)
        p.add_argument("--results-dir", type=str, default="temp_results")
        p.add_argument("--platform", type=str, default="cuda",
                       help=PLATFORM_HELP)
        p.set_defaults(func=fn)

    return parser


def _device(platform: str) -> torch.device:
    """``--platform`` as a torch device; exits, naming the flag, if it asks
    for CUDA and there is no GPU."""
    device = torch.device(platform)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available: pass --platform cpu "
                         "to run on the CPU")
    return device


def main(argv=None):
    args = build_parser().parse_args(argv)
    args.device = _device(args.platform)
    return args.func(args)


if __name__ == "__main__":
    main()
