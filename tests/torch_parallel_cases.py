"""What each rank runs in the port's multi-rank tests (test_torch_parallel.py,
test_torch_distributed.py): functions that ``spawn_ranks`` starts in
gloo processes on the CPU. They import torch and the port only, and return
numpy, which the tests hold against the same calls without a mesh in the
test's own process (and against the JAX package there)."""

import numpy as np
import torch

from differential_equations_dnn_tpu_torch import solve
from differential_equations_dnn_tpu_torch.core import generator
from differential_equations_dnn_tpu_torch.equations import PROBLEMS
from differential_equations_dnn_tpu_torch.kernels import fused_dgm as fd
from differential_equations_dnn_tpu_torch.kernels import fused_engine as fe
from differential_equations_dnn_tpu_torch.models import (
    DGM,
    MLP,
    ResNet,
    dgm_params_from_jax,
    dgm_params_to_jax,
    params_from_jax,
    params_to_jax,
)
from differential_equations_dnn_tpu_torch.parallel import (
    PopulationConfig,
    make_mesh,
    train_population,
)
from differential_equations_dnn_tpu_torch.sweep import (
    SearchSpace,
    halving_search_fused,
    loguniform,
    randint,
    random_search,
)
from differential_equations_dnn_tpu_torch.train import (
    TrainConfig,
    make_train_step,
    train,
)
from differential_equations_dnn_tpu_torch.train import trainer as trainer_mod

CPU = dict(device="cpu")
DP_STEPS = 12          # data-parallel steps against the single run
DP = dict(iterations=DP_STEPS, batch_size=16, lrate=1e-3, verbose=False)
POP_LRS = np.array([1e-3, 3e-3, 5e-4, 2e-3], np.float32)
POP_BSS = np.array([16, 9, 3, 12])
POP = dict(iterations=6, max_batch_size=16)
ENS_STEPS = 5
RUNG = dict(trials=[0, 1, 2, 5], lrs=[1e-3, 2e-3, 3e-3, 5e-4],
            bss=[4, 8, 16, 11], ns=[5, 10, 3, 7])
HALVING = dict(num_samples=6, eta=2, min_budget=2, max_budget=8,
               space_bs=(1, 60))


def small_mlp():
    return MLP(2, 1, 8, 2, "tanh", generator=generator(0))


def small_dgm():
    return DGM(input_dim=1, output_dim=2, hidden_size=8, num_layers=1,
               activation="tanh", generator=generator(0))


def small_fredholm_dgm():
    return DGM(input_dim=1, output_dim=1, hidden_size=8, num_layers=1,
               activation="relu", init_scheme="xavier_relu",
               generator=generator(0))


def flat(model):
    return torch.cat([p.detach().reshape(-1)
                      for p in model.parameters()]).numpy()


def data_parallel_train(taps, mesh):
    prob = PROBLEMS["heat"](taps=taps)
    res = train(prob, 3, TrainConfig(**DP), model=small_mlp(), mesh=mesh,
                **CPU)
    return res.loss_history, flat(res.params)


# Data-parallel runs whose loss couples the rows of a batch (core/rows.py):
# pre- and post-BatchNorm MLPs and a ResNet on heat (jvp taps), causal
# advection (eps = 5) and FitzHugh–Nagumo's default DGM (causal, eps = 5).
COUPLED = ("bn_pre", "bn_post", "resnet", "advection_causal",
           "fitzhugh_nagumo")


def coupled_case(case):
    """(problem, model) of a COUPLED case."""
    if case in ("bn_pre", "bn_post"):
        return PROBLEMS["heat"](), MLP(2, 1, 8, 2, "tanh",
                                       batch_norm=case[3:],
                                       generator=generator(0))
    if case == "resnet":
        return PROBLEMS["heat"](), ResNet(hidden_size=4, n_blocks=1,
                                          generator=generator(0))
    if case == "advection_causal":
        return PROBLEMS["advection"](causal_eps=5.0), small_mlp()
    return PROBLEMS["fitzhugh_nagumo"](), small_dgm()


def coupled_train(case, mesh):
    """DP_STEPS of ``train`` on a COUPLED case: (losses, parameters,
    running statistics)."""
    prob, model = coupled_case(case)
    res = train(prob, 3, TrainConfig(**DP), model=model, mesh=mesh, **CPU)
    stats = [b.detach().reshape(-1) for b in res.params.buffers()]
    return (res.loss_history, flat(res.params),
            torch.cat(stats).numpy() if stats else np.zeros(0, np.float32))


def causal_jax_steps(name, jax_params, uniforms, lr, mesh):
    """The data-parallel step from the JAX package's parameters of causal
    advection's MLP (eps = 5) or FitzHugh–Nagumo's DGM over the given
    uniforms' batches: the losses and the parameters as the JAX tree."""
    if name == "advection":
        prob = PROBLEMS["advection"](causal_eps=5.0)
        model, to_jax = params_from_jax(jax_params, "tanh"), params_to_jax
    else:
        prob = PROBLEMS["fitzhugh_nagumo"]()
        model, to_jax = dgm_params_from_jax(jax_params), dgm_params_to_jax
    B = uniforms.shape[1]
    config = TrainConfig(iterations=2 * len(uniforms), batch_size=B,
                         lrate=lr)
    opt = trainer_mod.make_optimizer(config, model.parameters())
    step = make_train_step(prob, model, opt, B, mesh=mesh)
    losses = [float(step(prob.batch_from_uniforms(torch.from_numpy(u))))
              for u in uniforms]
    return np.array(losses), to_jax(model)


def jax_parity_steps(jax_params, uniforms, lr, mesh):
    """The data-parallel step (``make_train_step`` on a mesh) from the JAX
    package's parameters over the given uniforms' batches: the losses and
    the parameters as a numpy tree in the JAX layout's names."""
    prob = PROBLEMS["heat"](taps="taylor")
    model = params_from_jax(jax_params, "tanh")
    config = TrainConfig(iterations=2 * len(uniforms), batch_size=16,
                         lrate=lr)
    opt = trainer_mod.make_optimizer(config, model.parameters())
    step = make_train_step(prob, model, opt, 16, mesh=mesh)
    losses = [float(step(prob.batch_from_uniforms(torch.from_numpy(u))))
              for u in uniforms]
    return np.array(losses), {k: v.detach().numpy()
                              for k, v in model.named_parameters()}


def population(mesh, taps="jvp"):
    params, opt_state, losses = train_population(
        PROBLEMS["heat"](taps=taps), small_mlp(), 0, POP_LRS, POP_BSS,
        config=PopulationConfig(**POP), mesh=mesh, **CPU)
    return (losses, {k: v.numpy() for k, v in params.items()},
            opt_state["count"].numpy())


def mlp_ensemble(mesh):
    models, losses = fe.train_fused_ensemble(
        PROBLEMS["wave"](), 0, ENS_STEPS, 4, mesh=mesh, batch_size=8,
        model=small_mlp(), **CPU)
    return losses, np.stack([flat(m) for m in models])


def dgm_ensemble(mesh):
    models, losses = fd.train_dgm_fused_ensemble(
        PROBLEMS["fitzhugh_nagumo"](), 0, ENS_STEPS, 4, mesh=mesh,
        batch_size=8, model=small_dgm(), **CPU)
    return losses, np.stack([flat(m) for m in models])


def mlp_rung(mesh):
    prob = PROBLEMS["heat"]()
    kw = dict(max_batch=16, model=small_mlp(), **CPU)
    ev = (fe.make_sharded_rung_evaluator(prob, 0, 10, mesh, **kw)
          if mesh is not None else
          fe.make_packed_rung_evaluator(prob, 0, 10, 4, horizon="trial",
                                        **kw))
    finals, p = ev(RUNG["trials"], RUNG["lrs"], RUNG["bss"], RUNG["ns"])
    return np.asarray(finals, np.float64), p.numpy()


def dgm_rung(mesh):
    prob = PROBLEMS["fredholm"](k=6, quadrature="gauss")
    kw = dict(batch_size=8, max_batch=64, model=small_fredholm_dgm(), **CPU)
    ev = (fd.make_sharded_rung_evaluator(prob, 0, 10, mesh, **kw)
          if mesh is not None else
          fd.make_packed_rung_evaluator(prob, 0, 10, 4, horizon="trial",
                                        **kw))
    finals, p = ev(RUNG["trials"], RUNG["lrs"], RUNG["bss"], RUNG["ns"])
    return np.asarray(finals, np.float64), p.numpy()


def fused_halving(mesh):
    """Fused halving on heat over a batch space inside one tile (bs < 60,
    tile 64), so the sharded rungs' one tile is every trial's bucket."""
    h = HALVING
    res = halving_search_fused(
        PROBLEMS["heat"](), 0, num_samples=h["num_samples"],
        space=SearchSpace({"lrate": loguniform(1e-4, 1e-2),
                           "batch_size": randint(*h["space_bs"])}),
        model=small_mlp(), eta=h["eta"], min_budget=h["min_budget"],
        max_budget=h["max_budget"], mesh=mesh, **CPU)
    return (res.scores, res.param_indices, res.best_index,
            res.params.numpy())


def solve_routes(pop_mesh, data_mesh):
    """solve's three mesh routes (the fourth, a single fused run, raises
    before any mesh is made): (MAE, loss history) each."""
    common = dict(iterations=5, batch_size=8, nodes=5, finetune=0, **CPU)
    out = {}
    for label, kw in (
            ("fused_ensemble", dict(equation="wave", engine="fused",
                                    ensemble=2, mesh=pop_mesh)),
            ("scan_ensemble", dict(equation="heat", engine="scan",
                                   ensemble=2, mesh=pop_mesh)),
            ("scan", dict(equation="heat", engine="scan", mesh=data_mesh))):
        res = solve(kw.pop("equation"), model=small_mlp(), **kw, **common)
        out[label] = (res.mae, res.loss_history)
    return out


def refusals(n_ranks):
    """The ValueError each refused call raises on ``n_ranks`` ranks (None:
    it did not raise)."""
    def message(fn):
        try:
            fn()
        except ValueError as err:
            return str(err)
        return None

    heat = PROBLEMS["heat"]()
    pop = {"pop": n_ranks}
    cases = {
        "oversized mesh": lambda: make_mesh({"data": n_ranks + 1}, "cpu"),
        "undersized mesh": lambda: make_mesh({"data": 1}, "cpu"),
        "population indivisible": lambda: train_population(
            heat, small_mlp(), 0, np.full(n_ranks + 1, 1e-3),
            config=PopulationConfig(iterations=1, max_batch_size=4),
            mesh=pop, **CPU),
        "population without pop": lambda: train_population(
            heat, small_mlp(), 0, np.full(n_ranks, 1e-3),
            config=PopulationConfig(iterations=1, max_batch_size=4),
            mesh={"data": n_ranks}, **CPU),
        "ensemble indivisible": lambda: fe.train_fused_ensemble(
            PROBLEMS["wave"](), 0, 1, n_ranks + 1, mesh=pop, batch_size=8,
            model=small_mlp(), **CPU),
        "ensemble without pop": lambda: fd.train_dgm_fused_ensemble(
            PROBLEMS["fitzhugh_nagumo"](), 0, 1, n_ranks,
            mesh={"data": n_ranks}, batch_size=8, model=small_dgm(), **CPU),
        "rung indivisible": lambda: fe.make_sharded_rung_evaluator(
            heat, 0, 4, pop, max_batch=8, model=small_mlp(), **CPU)(
                [0] * (n_ranks + 1), [1e-3] * (n_ranks + 1),
                [4] * (n_ranks + 1), [2] * (n_ranks + 1)),
        "batch indivisible": lambda: train(
            heat, 0, TrainConfig(iterations=1, batch_size=4 * n_ranks + 1,
                                 verbose=False), model=small_mlp(),
            mesh={"data": n_ranks}, **CPU),
    }
    return {name: message(fn) for name, fn in cases.items()}


def two_ranks(jax_params, uniforms, lr, causal):
    """Every 2-rank case on one group; numpy results by case. ``causal``
    maps "advection" and "fitzhugh_nagumo" to (JAX parameters, uniforms)
    for :func:`causal_jax_steps`."""
    data = make_mesh({"data": 2}, "cpu")
    pop = make_mesh({"pop": 2}, "cpu")
    return {
        "train_jvp": data_parallel_train("jvp", data),
        "train_taylor": data_parallel_train("taylor", data),
        "jax_steps": jax_parity_steps(jax_params, uniforms, lr, data),
        **{f"coupled_{case}": coupled_train(case, data) for case in COUPLED},
        **{f"causal_jax_{name}": causal_jax_steps(name, p, u, lr, data)
           for name, (p, u) in causal.items()},
        "population": population(pop),
        "population_pallas": population(pop, "pallas"),
        "mlp_ensemble": mlp_ensemble(pop),
        "dgm_ensemble": dgm_ensemble(pop),
        "mlp_rung": mlp_rung(pop),
        "dgm_rung": dgm_rung(pop),
        "fused_halving": fused_halving(pop),
        "solve": solve_routes(pop, data),
        "refusals": refusals(2),
    }


def four_ranks():
    """The 4-rank cases: a population on a 2 × 2 ("pop", "data") mesh and
    data-parallel training over 4 ranks (the COUPLED cases too)."""
    data = make_mesh({"data": 4}, "cpu")
    return {
        "population_2x2": population(make_mesh({"pop": 2, "data": 2},
                                               "cpu")),
        "train_jvp": data_parallel_train("jvp", data),
        **{f"coupled_{case}": coupled_train(case, data) for case in COUPLED},
    }


def sweep_case(mesh):
    """A population sweep's best score (SimpleODE, 4 trials)."""
    res = random_search(PROBLEMS["simple_ode"](), 2, num_samples=4,
                        max_iters=20, sampler_seed=3, mesh=mesh,
                        model=MLP(1, 1, 8, 1, "tanh",
                                  generator=generator(0)), **CPU)
    return float(res.best_score)


def initialize_and_run(port, rank, from_env, results):
    """One of two processes joined by ``initialize_distributed`` over TCP
    on localhost (rank 1 reads torchrun's variables from its environment):
    a reduction across the processes, data-parallel training and a
    population sweep over the two."""
    import os

    import torch.distributed as dist

    from differential_equations_dnn_tpu_torch.parallel import (
        global_mesh,
        initialize_distributed,
    )

    torch.set_num_threads(1)
    try:
        if from_env:
            os.environ.update(WORLD_SIZE="2", RANK=str(rank),
                              MASTER_ADDR="localhost", MASTER_PORT=str(port))
            joined = initialize_distributed(device="cpu")
        else:
            joined = initialize_distributed(f"localhost:{port}", 2, rank,
                                            device="cpu")
        try:
            total = torch.tensor([float(rank + 1)])
            dist.all_reduce(total)
            results.put((rank, joined, float(total),
                         data_parallel_train("jvp", global_mesh(device="cpu")),
                         sweep_case(global_mesh({"pop": 2}, device="cpu"))))
        finally:
            dist.destroy_process_group()
    except Exception as err:  # noqa: BLE001 — reported to the test
        results.put((rank, False, repr(err), None, None))
