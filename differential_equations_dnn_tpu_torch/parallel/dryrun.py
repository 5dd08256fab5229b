"""A multi-rank dry run of every mesh path at tiny shapes.

The port's counterpart of the JAX package's ``__graft_entry__.py``
``dryrun_multichip``: the same eight steps, each on a mesh over
``n_ranks`` ranks, each asserting finite results.

    python -m differential_equations_dnn_tpu_torch.parallel.dryrun 4 --device cpu

On the CPU it spawns ``n_ranks`` gloo processes; in a process group that
already exists (under ``torchrun``) it runs at the world's size; one rank
runs in this process, on a one-rank group of its own (``make_mesh``).
"""

import argparse

import numpy as np
import torch.distributed as dist

from differential_equations_dnn_tpu_torch.kernels.build import resolve_device
from differential_equations_dnn_tpu_torch.parallel.distributed import (
    spawn_ranks,
)


def _finite(label, values):
    values = np.asarray(values, np.float64)
    if not np.all(np.isfinite(values)):
        raise AssertionError(f"dryrun step {label}: non-finite {values}")
    return values


def _steps(n_ranks: int, device_type: str) -> dict:
    """The eight steps on this rank; returns each step's losses or best
    score (numpy), the same on every rank."""
    from differential_equations_dnn_tpu_torch.equations import PROBLEMS
    from differential_equations_dnn_tpu_torch.kernels.fused_dgm import (
        train_dgm_fused_ensemble,
    )
    from differential_equations_dnn_tpu_torch.kernels.fused_engine import (
        train_fused_ensemble,
    )
    from differential_equations_dnn_tpu_torch.models import DGM
    from differential_equations_dnn_tpu_torch.parallel import (
        PopulationConfig,
        make_mesh,
        train_population,
    )
    from differential_equations_dnn_tpu_torch.sweep import (
        SearchSpace,
        halving_search_fused,
        loguniform,
        successive_halving,
    )
    from differential_equations_dnn_tpu_torch.sweep.search import randint
    from differential_equations_dnn_tpu_torch.train import TrainConfig, train

    device = device_type
    heat = PROBLEMS["heat"]()
    model = heat.default_model()
    out = {}

    # 1) A pop × data mesh: 2 trials per pop coordinate, one step each.
    pop = n_ranks if n_ranks < 4 else max(2, n_ranks // 4)
    mesh2d = make_mesh({"pop": pop, "data": n_ranks // pop}, device)
    _, _, losses = train_population(
        heat, model, 0, np.full(2 * pop, 1e-4),
        config=PopulationConfig(iterations=1, max_batch_size=16),
        mesh=mesh2d, device=device)
    out["population"] = _finite("1 (population)", losses)

    # 2) Data-parallel training, jvp taps: the batch split over every rank,
    #    the gradient mean one all-reduce a step.
    mesh1d = make_mesh({"data": n_ranks}, device)
    cfg = TrainConfig(iterations=2, batch_size=8 * n_ranks, chunk_size=2,
                      verbose=False)
    out["data_jvp"] = _finite("2 (data, jvp)", train(
        heat, 1, cfg, mesh=mesh1d, device=device).loss_history)

    # 3) The same with the Taylor-stream taps.
    out["data_taylor"] = _finite("3 (data, taylor)", train(
        PROBLEMS["heat"](taps="taylor"), 2, cfg, mesh=mesh1d,
        device=device).loss_history)

    # 4) A successive-halving rung on the pop × data mesh: survivors
    #    re-enter with their optimizer state.
    space = SearchSpace({"lrate": loguniform(1e-5, 1e-3)})
    res = successive_halving(heat, 3, num_samples=2 * pop, space=space,
                             eta=2, min_budget=1, max_budget=2,
                             max_batch_size=8, chunk_size=1, mesh=mesh2d,
                             device=device)
    out["halving"] = _finite("4 (halving)", res.best_score)

    # 5) The MLP engine's ensemble over a pop mesh: each rank's replicas
    #    in one packed kernel run.
    pop_mesh = make_mesh({"pop": n_ranks}, device)
    _, losses = train_fused_ensemble(PROBLEMS["wave"](), 4, 2, n_ranks,
                                     mesh=pop_mesh, batch_size=8,
                                     device=device)
    out["mlp_ensemble"] = _finite("5 (MLP ensemble)", losses)

    # 6) The DGM engine's ensemble.
    fn = PROBLEMS["fitzhugh_nagumo"]()
    _, losses = train_dgm_fused_ensemble(
        fn, 5, 2, n_ranks, mesh=pop_mesh, batch_size=8,
        model=DGM(input_dim=1, output_dim=2, hidden_size=16, num_layers=1,
                  activation="tanh"), device=device)
    out["dgm_ensemble"] = _finite("6 (DGM ensemble)", losses)

    # 7) Fused halving with sharded rungs on the MLP engine.
    hspace = SearchSpace({"lrate": loguniform(1e-5, 1e-3),
                          "batch_size": randint(2, 9)})
    res = halving_search_fused(PROBLEMS["wave"](), 6, num_samples=n_ranks,
                               space=hspace, eta=2, min_budget=1,
                               max_budget=2, mesh=pop_mesh, device=device)
    out["mlp_halving"] = _finite("7 (MLP halving)", res.best_score)

    # 8) The same on the DGM engine, with a batch-size space.
    dspace = SearchSpace({"lrate": loguniform(1e-5, 1e-3),
                          "batch_size": randint(4, 9)})
    res = halving_search_fused(
        PROBLEMS["fredholm"](k=6, quadrature="gauss"), 7,
        num_samples=n_ranks, eta=2, min_budget=1, max_budget=2,
        batch_size=8, max_batch_size=8, space=dspace, mesh=pop_mesh,
        device=device)
    out["dgm_halving"] = _finite("8 (DGM halving)", res.best_score)
    return out


def dryrun_multichip(n_ranks: int, device="cuda") -> dict:
    """The eight steps over ``n_ranks`` ranks (see the module's
    docstring): in this process if its world (1 without a process group)
    has ``n_ranks`` ranks, else, from a single process, in ``n_ranks``
    spawned processes (gloo on the CPU; NCCL needs a card per rank).
    Returns rank 0's results and prints one line."""
    device = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world == n_ranks:
        out = _steps(n_ranks, device.type)
    elif world > 1:
        raise ValueError(f"dryrun over {n_ranks} ranks in a group of "
                         f"{world}")
    else:
        out = spawn_ranks(_steps, n_ranks, n_ranks, device.type,
                          device=device)[0]
    print(f"dryrun_multichip OK on {n_ranks} {device.type} ranks: "
          f"pop×data population, data-parallel jvp and taylor taps, a "
          f"halving rung, fused MLP and DGM ensembles, sharded fused "
          f"halving (MLP and DGM) — losses finite")
    return out


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("n_ranks", type=int)
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    dryrun_multichip(args.n_ranks, args.device)


if __name__ == "__main__":
    main()
