"""Population training: P independent trials stepped together.

Counterpart of the JAX package's parallel/population.py, the engine under
``solve(engine="scan", ensemble=N)``, the population sweeps and the
ablations, and the replacement of the reference's Ray Tune driver
(optimize_heat_ray.py:160-203):

* every trial has its own init (``replica_generator(seed, t)``), its own
  collocation stream (``step_generator(trial_seed(seed, t), i)`` at step
  i, so its batches depend on neither the population's size nor its other
  trials), its own learning rate and its own batch size;
* the trials' parameters are stacked along a leading axis of P and one
  step advances them all: ``torch.func.vmap`` over ``functional_call`` of
  the problem's loss, its gradient by ``torch.func.grad_and_value`` (the
  derivative taps through ``torch.func``: ``ops.diff.functional_taps``);
* Adam is optax's ``scale_by_adam(0.9, 0.999, 1e-8)`` times the trial's
  lr (JAX :49-52), written on the stacked tensors, its count and lr device
  tensors;
* a trial of batch size bs draws ``max_batch_size`` rows and masks its
  loss to the first bs (``Problem.loss(..., mask)``); a BatchNorm trial's
  batch statistics, and its running-statistics refresh after each step,
  span all the drawn rows (JAX :127-145);
* on a CUDA device a run of at least GRAPH_STEPS steps replays
  GRAPH_STEPS population steps captured as one CUDA graph for every whole
  block of draws (the last, partial block eagerly, with the same bits), by
  the scan trainer's protocol (``trainer.capture_graph``); a shorter run,
  and every run on the CPU, steps eagerly. The graph is captured once per
  key (:func:`graph_key`: the problem, the model's structure, the number
  of trials, the drawn rows, the process's math settings) and kept with
  the stacked tensors it reads; a later call of the key copies its
  starting state, lr and mask into them (a call on a mesh captures its
  own). Every call returns copies of its trained tensors. The losses stay
  on the device until the run ends, so ``chunk_size`` (JAX's chunks pace
  its dispatches and fetches) changes nothing here. A step that cannot be
  captured raises, naming the cause: there is no eager fallback.
  Draws are made on the host, one block at a time, while the card replays
  the previous one (:func:`draw_trial_batches`);
* on a mesh (``mesh=``) the trials are sharded over its ``pop`` axis: each
  rank trains its P / n trials, by their global indices, as one
  population of its own, then the ranks gather every trial's result, so
  every rank returns the whole population (the JAX package's sharded
  population). The ranks of one ``pop`` coordinate (a ``("pop",
  "data")`` mesh) train the same trials, as JAX replicates ``data``.

A trial's ``params`` are its module's parameters and its frozen buffers
(a Fourier-feature matrix: its gradient is 0, so Adam leaves it, as JAX's
``stop_gradient`` does); a stateful model's running statistics are its
``state`` (models/stateful.py). Both are dicts of stacked tensors keyed by
the module's names; ``opt_state`` is ``{"count" [P], "mu", "nu"}``.
"""

import copy
import time
from dataclasses import dataclass

import numpy as np
import torch
from torch import nn
from torch.func import functional_call, grad_and_value, vmap

from differential_equations_dnn_tpu_torch.core.prng import (
    replica_generator,
    step_generator,
    trial_seed,
)
from differential_equations_dnn_tpu_torch.equations.base import Problem
from differential_equations_dnn_tpu_torch.kernels import build
from differential_equations_dnn_tpu_torch.kernels import graphs as graph_cache
from differential_equations_dnn_tpu_torch.models.stateful import (
    is_stateful,
    state_names,
)
from differential_equations_dnn_tpu_torch.ops.diff import functional_taps
from differential_equations_dnn_tpu_torch.parallel.mesh import (
    as_mesh,
    mesh_device,
    require_axis,
)
from differential_equations_dnn_tpu_torch.parallel.sharding import (
    gather_rows,
    shard_range,
)
from differential_equations_dnn_tpu_torch.train.trainer import (
    capture_graph,
    count_replays,
    structure_key,
)
from differential_equations_dnn_tpu_torch.utils import trace

# Population steps per captured CUDA graph, and per block of host draws.
# A capture runs each step's Python once (tens of ms a step for a
# BatchNorm population's second-order taps), so the graph is kept short;
# a replay costs the same whatever its length.
GRAPH_STEPS = 32

B1, B2, EPS = 0.9, 0.999, 1e-8


@dataclass(frozen=True)
class PopulationConfig:
    iterations: int = 1000
    max_batch_size: int = 64
    chunk_size: int = 1000  # JAX's dispatch pacing; no effect here
    pop_axis: str = "pop"  # the mesh axis the trials are sharded over


class _Functional(nn.Module):
    """The problem's loss and the model's running statistics as one
    module, so that ``functional_call`` swaps a trial's tensors into the
    model for either."""

    def __init__(self, problem, model):
        super().__init__()
        self.problem = problem
        self.model = model

    def forward(self, what, *args):
        if what == "loss":
            batch, mask = args
            with functional_taps():
                return self.problem.loss(self.model, batch, mask)
        return self.model.running_stats(args[0])


def _split(model):
    """(params, state) of one module: its parameters and frozen buffers,
    and its running statistics, as dicts of detached tensors."""
    names = set(state_names(model))
    params = {k: v.detach() for k, v in model.named_parameters()}
    params.update({k: v.detach() for k, v in model.named_buffers()
                   if k not in names})
    state = {k: v.detach() for k, v in model.named_buffers() if k in names}
    return params, state


def init_trials(model, seed: int, n_trials: int, device=None,
                first: int = 0):
    """The stacked (params, state) of ``n_trials`` trials ``first ..
    first + n_trials − 1``, trial t drawn by
    ``model.fresh(replica_generator(seed, t))`` (the JAX package's
    ``vmap(model.init)(key_chain(...))``); ``state`` is None for a
    stateless model."""
    trials = [_split(model.fresh(generator=replica_generator(seed, t)))
              for t in range(first, first + n_trials)]
    params = {k: torch.stack([p[k] for p, _ in trials]).to(device)
              for k in trials[0][0]}
    state = ({k: torch.stack([s[k] for _, s in trials]).to(device)
              for k in trials[0][1]} if is_stateful(model) else None)
    return params, state


def take_trials(stacked, indices):
    """Trials ``indices`` of a stacked tree (dicts and lists of [P, ...]
    tensors or arrays): how halving rungs re-enter their survivors."""
    if isinstance(stacked, dict):
        return {k: take_trials(v, indices) for k, v in stacked.items()}
    if isinstance(stacked, (list, tuple)):
        return type(stacked)(take_trials(v, indices) for v in stacked)
    if stacked is None:
        return None
    if torch.is_tensor(stacked):
        return stacked[torch.as_tensor(np.asarray(indices),
                                       device=stacked.device)]
    return np.asarray(stacked)[np.asarray(indices)]


def trial_model(model, params, t, state=None):
    """A copy of ``model`` holding trial ``t`` of the stacked ``params``
    (and ``state``)."""
    net = copy.deepcopy(model)
    tensors = {**dict(net.named_parameters()), **dict(net.named_buffers())}
    with torch.no_grad():
        for tree in (params, state or {}):
            for k, v in tree.items():
                tensors[k].copy_(v[t])
    return net.to(next(iter(params.values())).device)


def trial_opt_state(model, opt_state, t) -> dict:
    """Trial ``t``'s Adam state as the state_dict that ``train(...,
    opt_state=)`` resumes from (``trainer.load_opt_state``): its count and
    its moments of ``model``'s parameters (a :func:`trial_model`), so a
    trial can go on as a standalone run."""
    names = [name for name, _ in model.named_parameters()]
    count = float(opt_state["count"][t])
    state = {i: {"step": torch.tensor(count),
                 "exp_avg": opt_state["mu"][name][t].clone(),
                 "exp_avg_sq": opt_state["nu"][name][t].clone()}
             for i, name in enumerate(names)}
    return {"state": state,
            "param_groups": [{"params": list(range(len(names))),
                              "count": int(count)}]}


def _adam_init(params, n_trials, device):
    return {"count": torch.zeros(n_trials, device=device),
            "mu": {k: torch.zeros_like(v) for k, v in params.items()},
            "nu": {k: torch.zeros_like(v) for k, v in params.items()}}


def make_population_step(problem, model, params, state, opt_state, lr,
                         mask):
    """The population step: ``step(batch) -> losses [P]`` advances every
    trial by one Adam step on its ``batch`` rows (each [P, rows, ...])
    under its ``mask`` row, in place on the stacked ``params``,
    ``state`` and ``opt_state``; ``lr`` [P] is each trial's learning
    rate. Nothing in it waits for the device."""
    fmod = _Functional(problem, model)
    stateful = state is not None

    def call(p, s, *args):
        tensors = {f"model.{k}": v for k, v in p.items()}
        tensors.update({f"model.{k}": v for k, v in (s or {}).items()})
        return functional_call(fmod, tensors, args)

    loss_grad = vmap(grad_and_value(
        lambda p, s, batch, m: call(p, s, "loss", batch, m)))
    stats = vmap(lambda p, s, x: call(p, s, "stats", x))
    count, mu, nu = opt_state["count"], opt_state["mu"], opt_state["nu"]

    def step(batch):
        grads, losses = loss_grad(params, state or {}, batch, mask)
        with torch.no_grad():
            count.add_(1.0)
            c1 = 1.0 - torch.pow(B1, count)
            c2 = 1.0 - torch.pow(B2, count)
            for k, g in grads.items():
                view = (-1,) + (1,) * (g.dim() - 1)
                mu[k].mul_(B1).add_(g, alpha=1.0 - B1)
                nu[k].mul_(B2).addcmul_(g, g, value=1.0 - B2)
                u = (mu[k] / c1.view(view)) / (torch.sqrt(nu[k]
                                                          / c2.view(view))
                                               + EPS)
                params[k].sub_(lr.view(view) * u)
            if stateful:
                new = stats(params, state, problem.domain_inputs(batch))
                for k, v in new.items():
                    state[k].copy_(v)
        return losses.detach()

    return step


def draw_trial_batches(problem, seeds, start, n, size, device):
    """The batches of steps ``start .. start + n − 1`` of every trial, each
    ``problem.sample(size, step_generator(seeds[t], i))``, stacked as [n,
    P, size, ...].

    A problem that keeps ``Problem.sample`` (its batch built row by row
    from ``[size, n_uniform]`` U[0, 1) draws) draws only those uniforms on
    the host, one ``torch.rand`` per trial and step from the same
    generators, moves them in one copy (through pinned memory on a CUDA
    device) and builds the whole block there in one
    ``batch_from_uniforms``: the same numbers as the calls of ``sample``,
    which also builds its batch on the device from host draws. Any other
    problem samples each (trial, step) on the host and the block is copied
    once per array."""
    P = len(seeds)
    if type(problem).sample is Problem.sample:
        u = torch.stack([
            torch.stack([torch.rand((size, problem.n_uniform),
                                    generator=step_generator(s, i))
                         for s in seeds])
            for i in range(start, start + n)])
        if device.type == "cuda":
            u = u.pin_memory().to(device, non_blocking=True)
        batch = problem.batch_from_uniforms(u.reshape(-1, problem.n_uniform))
        return {k: v.reshape(n, P, size, *v.shape[1:])
                for k, v in batch.items()}
    steps = [[problem.sample(size, step_generator(s, i)) for s in seeds]
             for i in range(start, start + n)]
    block = {k: torch.stack([torch.stack([b[k] for b in row])
                             for row in steps])
             for k in steps[0][0]}
    if device.type == "cuda":
        block = {k: v.pin_memory().to(device, non_blocking=True)
                 for k, v in block.items()}
    return block


def named_tensors(params, state, opt_state):
    """The stacked tensors a population step reads and writes, as (name,
    tensor) pairs: the params, the state, then the Adam count and
    moments."""
    return [*params.items(), *(state or {}).items(),
            ("count", opt_state["count"]),
            *((f"mu.{k}", v) for k, v in opt_state["mu"].items()),
            *((f"nu.{k}", v) for k, v in opt_state["nu"].items())]


def graph_key(problem, template, named, n_trials, max_batch_size,
              device, mesh=None):
    """The key of the population graph of ``n_trials`` trials of
    ``template`` drawing ``max_batch_size`` rows of ``problem``, over the
    stacked tensors it reads (``named``, :func:`named_tensors`, in the
    order a call copies them in): what the captured kernels read as host
    values or shapes, and the math settings that chose them
    (``trainer.math_key``). The seed, the
    starting state, the lr and the batch sizes (the mask) are left out:
    each call copies them in. None (a graph of the call's own) on a mesh,
    or where the problem or the model cannot be described."""
    structure = structure_key(problem, template)
    if mesh is not None or structure is None:
        return None
    layout = tuple((name, tuple(t.shape), t.dtype) for name, t in named)
    return ("population", structure, is_stateful(template),
            n_trials, max_batch_size, layout, GRAPH_STEPS, device)


class _PopulationEntry:
    """A cached population graph and what it holds pointers to: the
    template (through the step closure, with the problem), the stacked
    params, state and opt_state, the ``lr`` vector and the ``mask``."""

    def __init__(self, step, graph, tensors, lr, mask, trees):
        self.step, self.graph = step, graph
        self.tensors, self.lr, self.mask = tensors, lr, mask
        self.trees = trees  # (params, state, opt_state)

    def free(self):
        """Release the graph and its memory pool (evicted)."""
        self.graph.graph.reset()

    def load(self, tensors, lr, mask):
        """A call's starting state, lr and mask, copied in on the
        device."""
        with torch.no_grad():
            for dst, src in zip(self.tensors + [self.lr, self.mask],
                                tensors + [lr, mask]):
                dst.copy_(src)


class _PopulationGraph:
    """GRAPH_STEPS population steps captured as one CUDA graph
    (``trainer.capture_graph``, the scan trainer's protocol, the stacked
    state put back after its warm-up step): the steps read a static block
    of draws and write their losses to a static ``[GRAPH_STEPS, P]``
    buffer. ``train_population`` keeps the graph across calls of one key
    (:class:`_PopulationEntry`). As the scan trainer's graph, the warm-up
    step's kernel launches count, the capture's do not, and each replay
    adds the launches it holds (a ``taps="pallas"`` population's kernel
    #3, one a step). The capture and each replay are spans
    (utils/trace.py), each counted."""

    def __init__(self, step, block, tensors, n_trials, name):
        with trace.span("graph.capture", trainer="population"):
            device = next(iter(block.values())).device
            self.static = {k: v.clone() for k, v in block.items()}
            self.losses = torch.empty((GRAPH_STEPS, n_trials),
                                      device=device)
            self.graph, self.launches = capture_graph(
                step, self.static, self.losses, tensors,
                f"the population step of {name!r}")
            build.sync(device)
        trace.count("graph.captures.population")

    def replay(self, block):
        with trace.span("graph.replay", trainer="population"):
            for k, v in block.items():
                self.static[k].copy_(v)
            self.graph.replay()
            losses = self.losses.clone()
        count_replays(self.launches)
        trace.count("graph.replays.population")
        return losses


def train_population(problem, model, seed: int, lrates, batch_sizes=None,
                     config: PopulationConfig | None = None, mesh=None,
                     params=None, opt_state=None, state=None,
                     timings: dict | None = None, device="cuda"):
    """Train ``P = len(lrates)`` trials of ``model``'s architecture
    together (JAX ``train_population``; its ``key`` is ``seed`` here).

    ``batch_sizes`` (≤ ``config.max_batch_size``; None: all at the max)
    masks each trial's loss to its own batch. ``params`` / ``opt_state`` /
    ``state`` (stacked, as returned) resume trials, e.g. a halving rung's
    survivors through :func:`take_trials`; a stateful model's trials get
    fresh running statistics unless ``state`` is given. ``model`` itself is
    not trained. ``timings`` receives ``compile_time`` (on the card, the graph's
    capture, its warm-up step included), ``run_time`` (the steps, ending in a
    synchronize) and ``state`` (the trained running statistics, or None).

    Returns (params, opt_state, losses ``[iterations, P]`` numpy).
    ``device`` defaults to "cuda" and raises without a GPU.

    ``mesh`` (a mesh, or an ``{axis: size}`` dict made into one on
    ``device``) shards the trials over its ``config.pop_axis``; P must
    divide evenly over it. Every rank runs this call and returns the whole
    population, on the mesh's device; resumed ``params`` / ``opt_state``
    / ``state`` are whole populations too (each rank takes its trials)."""
    config = config or PopulationConfig()
    device = build.resolve_device(device)
    lrates = np.asarray(lrates, np.float32)
    n_trials = lrates.shape[0]
    max_bs = int(config.max_batch_size)
    bs = (np.full(n_trials, max_bs) if batch_sizes is None
          else np.asarray(batch_sizes, np.int64))
    if bs.shape != (n_trials,) or bs.min() < 1 or bs.max() > max_bs:
        raise ValueError(f"batch_sizes must be {n_trials} sizes in [1, "
                         f"{max_bs}] (got {bs.tolist()})")
    lo, hi = 0, n_trials
    if mesh is not None:
        mesh = as_mesh(mesh, device)
        device = mesh_device(mesh)
        n_shards = require_axis(mesh, config.pop_axis, "a sharded population")
        if n_trials % n_shards:
            raise ValueError(
                f"population size {n_trials} must divide evenly over the "
                f"'{config.pop_axis}' mesh axis ({n_shards} shards)")
        lo, hi = shard_range(n_trials, mesh, config.pop_axis)
        local = np.arange(lo, hi)
        lrates, bs = lrates[lo:hi], bs[lo:hi]
        params, opt_state, state = (take_trials(t, local) for t in
                                    (params, opt_state, state))
    lr = torch.as_tensor(lrates, device=device)
    n_local = hi - lo
    mask = (torch.arange(max_bs, device=device)[None, :]
            < torch.as_tensor(bs, device=device)[:, None])

    template = copy.deepcopy(model).to(device).train()
    stateful = is_stateful(template)
    if params is None:
        params, fresh_state = init_trials(template, seed, n_local, device, lo)
    else:
        params = {k: v.detach().to(device).clone() for k, v in params.items()}
        fresh_state = init_trials(template, seed, 1, device)[1]
        fresh_state = fresh_state and {k: v.expand(n_local, *v.shape[1:])
                                       .clone()
                                       for k, v in fresh_state.items()}
    if stateful:
        state = ({k: v.detach().to(device).clone() for k, v in state.items()}
                 if state is not None else fresh_state)
    else:
        state = None
    if opt_state is None:
        opt_state = _adam_init(params, n_local, device)
    else:
        opt_state = {"count": opt_state["count"].to(device).float().clone(),
                     "mu": {k: v.to(device).clone()
                            for k, v in opt_state["mu"].items()},
                     "nu": {k: v.to(device).clone()
                            for k, v in opt_state["nu"].items()}}

    named = named_tensors(params, state, opt_state)
    tensors = [t for _, t in named]
    seeds = [trial_seed(seed, t) for t in range(lo, hi)]
    graphs = device.type == "cuda" and config.iterations >= GRAPH_STEPS
    key = (graph_key(problem, template, named, n_local, max_bs, device,
                     mesh) if graphs else None)
    entry = graph_cache.TRAINER_GRAPHS.get(key)
    graph = None

    # On the card, the graph's capture (its warm-up step included), or
    # for a cached key the copies in.
    t0 = time.perf_counter()
    if entry is not None:
        entry.load(tensors, lr, mask)
        step, graph = entry.step, entry.graph
        params, state, opt_state = entry.trees
        trace.count("graph.reuses.population")
    else:
        step = make_population_step(problem, template, params, state,
                                    opt_state, lr, mask)
        if graphs:
            block = draw_trial_batches(problem, seeds, 0, GRAPH_STEPS,
                                       max_bs, device)
            graph = _PopulationGraph(step, block, tensors, n_local,
                                     problem.name)
            if key is not None:
                graph_cache.TRAINER_GRAPHS.put(key, _PopulationEntry(
                    step, graph, tensors, lr, mask,
                    (params, state, opt_state)))
    build.sync(device)
    compile_time = time.perf_counter() - t0

    losses = []
    t0 = time.perf_counter()
    for b0 in range(0, config.iterations, GRAPH_STEPS):
        k = min(GRAPH_STEPS, config.iterations - b0)
        with trace.span("train.draw", trainer="population", steps=k):
            block = draw_trial_batches(problem, seeds, b0, k, max_bs,
                                       device)
        if graphs and k == GRAPH_STEPS:
            losses.append(graph.replay(block))
        else:
            with trace.span("train.eager", steps=k):
                losses.extend(step({key: v[j] for key, v
                                    in block.items()})[None]
                              for j in range(k))
    build.sync(device)
    run_time = time.perf_counter() - t0

    with trace.span("train.fetch"):
        losses = (torch.cat(losses).cpu().numpy() if losses
                  else np.zeros((0, n_local), np.float32))
    # Copies: a kept entry's tensors are the next call's.
    params, opt_state, state = take_trials((params, opt_state, state),
                                           np.arange(n_local))
    if mesh is not None:
        params, opt_state, state = gather_rows((params, opt_state, state),
                                               mesh, config.pop_axis)
        losses = gather_rows(losses, mesh, config.pop_axis, dim=1)
    if timings is not None:
        timings["compile_time"] = compile_time
        timings["run_time"] = run_time
        timings["state"] = state
    return params, opt_state, losses
