"""Hyperparameter search on the fused tier: every trial trains inside the
port's hand-written kernels (kernels/fused_engine.py, kernels/fused_dgm.py).

Counterpart of the fused half of the JAX package's sweep/search.py, the
reference's Ray Tune driver (optimize_heat_ray.py: Optuna's TPE under ASHA
over ``batch_size ~ randint[1, 512)``, ``n_iters ~ randint[1000, 50 000)``
and ``lrate ~ loguniform[1e-4, 1e-1]``, at most 5 trials at a time), scored
by each trial's final training loss (:157):

* :func:`tpe_search_fused` — TPE, one trial after another, or rounds of
  ``q`` proposals each trained as packed calls (the reference's
  ``max_concurrent=5``);
* :func:`halving_search_fused` — successive halving (the ASHA role), each
  rung one packed call per bucket tile, every slot at its own lr, batch
  and budget (a pruned slot's blocks return at entry);
* :func:`tpe_halving_fused` — TPE proposing each halving bracket's
  configs (the reference's pairing).

The batch is a row mask over a compiled tile and the budget a step gate,
both values of the kernels' argument block, so one captured CUDA graph per
tile serves every trial. Trials route to the smallest tile of
``BUCKET_TILES`` that holds their batch; a trial's collocation stream is
drawn at its tile's width.

The population drivers train every trial of a round as one population
(parallel/population.py) on the scan engine's torch ops, any equation and
model: :func:`random_search`, :func:`successive_halving` (survivors
re-enter with their optimizer state), :func:`tpe_search` (rounds of TPE
proposals) and :func:`tpe_halving`. Every trial trains to the round's
budget and is scored at its own ``n_iters``.

``mesh=`` (parallel/mesh.py's mesh, or an ``{axis: size}`` dict) spreads a
sweep over the ranks of a process group, each of which runs the driver
and gets the same result: the population drivers shard every population
over the mesh's ``pop`` axis (``train_population(mesh=)``), and
:func:`halving_search_fused` / :func:`tpe_halving_fused` evaluate each
rung with the sharded rung evaluators, as the JAX package does: one tile
of the sweep's largest batch, the rung padded with copies of its last
trial to a multiple of the axis.
"""

from dataclasses import dataclass, field
from typing import Any

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.core.prng import (
    fold_seed,
    generator,
)
from differential_equations_dnn_tpu_torch.kernels import (
    fused_dgm,
    fused_engine,
)
from differential_equations_dnn_tpu_torch.parallel.mesh import (
    as_mesh,
    mesh_shape,
)
from differential_equations_dnn_tpu_torch.parallel.population import (
    PopulationConfig,
    take_trials,
    train_population,
)

# ---- search-space primitives (Ray-Tune-style) -------------------------------


@dataclass(frozen=True)
class loguniform:
    low: float
    high: float

    def sample(self, rng, n):
        return np.exp(rng.uniform(np.log(self.low), np.log(self.high), n))


@dataclass(frozen=True)
class uniform:
    low: float
    high: float

    def sample(self, rng, n):
        return rng.uniform(self.low, self.high, n)


@dataclass(frozen=True)
class randint:
    low: int
    high: int  # exclusive, like ray.tune.randint

    def sample(self, rng, n):
        return rng.integers(self.low, self.high, n)


@dataclass(frozen=True)
class choice:
    values: tuple

    def sample(self, rng, n):
        return np.asarray(self.values)[rng.integers(0, len(self.values), n)]


@dataclass(frozen=True)
class SearchSpace:
    """Named distributions; ``sample(seed, n)`` draws a dict of [n] arrays."""

    specs: dict

    def sample(self, seed: int, n: int) -> dict:
        rng = np.random.default_rng(seed)
        return {name: spec.sample(rng, n) for name, spec in self.specs.items()}


def heat_search_space() -> SearchSpace:
    """The reference's space (optimize_heat_ray.py:173-176)."""
    return SearchSpace({
        "batch_size": randint(1, 512),
        "n_iters": randint(1000, 50_000),
        "lrate": loguniform(1e-4, 1e-1),
    })


# ---- results ----------------------------------------------------------------


@dataclass
class SweepResult:
    configs: list            # per-trial config dicts
    scores: np.ndarray       # [P] final losses (at each trial's own budget)
    losses: np.ndarray | None  # [iters, P] loss curves (None: not kept)
    params: Any              # [len(param_indices), n] trained flat states;
                             # a population driver's stacked param dicts
    param_indices: np.ndarray | None = None  # the trials params holds
    unpack: Any = None       # flat state -> its tensors in flat-state order
    best_index: int = field(init=False)

    def __post_init__(self):
        finite = np.where(np.isfinite(self.scores), self.scores, np.inf)
        if self.param_indices is not None:
            # Only trials still holding params (halving's survivors) can
            # win; their scores are also the fully trained ones.
            eligible = np.full_like(finite, np.inf)
            eligible[self.param_indices] = finite[self.param_indices]
            if not np.isfinite(eligible).any():
                # Every param-holding trial diverged: still point at one
                # of them, whose params exist.
                self.best_index = int(self.param_indices[0])
                return
            finite = eligible
        self.best_index = int(np.argmin(finite))

    @property
    def best_config(self) -> dict:
        return self.configs[self.best_index]

    @property
    def best_score(self) -> float:
        return float(self.scores[self.best_index])

    def best_params(self):
        """The best trial's trained tensors in flat-state order
        (``fused_engine.unpack_state`` / ``fused_dgm.unpack_dgm``), or of a
        population driver its stacked parameter dict, each with a leading
        axis of 1 (the JAX package's ``take_trials``)."""
        if self.param_indices is None:
            pos = self.best_index
        else:
            pos = int(np.where(self.param_indices == self.best_index)[0][0])
        return take_trial(self.params, pos, self.unpack)


def take_trial(params, pos, unpack=None):
    """Row ``pos`` of stacked flat states ``[P, n]`` as ``unpack(row)``'s
    tensors (None: the flat row), each with a leading axis of 1; of a
    population's stacked dicts, those dicts at trial ``pos`` with a leading
    axis of 1 (``take_trials``)."""
    if isinstance(params, dict):
        return take_trials(params, np.array([pos]))
    row = params[pos]
    if unpack is None:
        return row[None]
    return tuple(t[None] for t in unpack(row))


# ---- bucketed tiles of the fused sweep evaluators ---------------------------

#: The row tiles of full-space sweeps: a trial routes to the smallest tile
#: holding its batch_size, and the row mask covers the rest of the tile.
#: Each tile's evaluator (its stream, its CUDA graph) is made on first use.
BUCKET_TILES = (64, 128, 256, 512)


def _tiles_for(max_bs: int, bucket_tiles, floor: int = 1) -> list[int]:
    """The tiles of a sweep capped at ``max_bs``: every bucket in [floor,
    top) and the top tile itself, max_bs rounded up to a multiple of 64.
    ``floor`` is the smallest legal tile (Fredholm's nodes must fit)."""
    top = max(-(-int(max_bs) // 64) * 64, int(floor))
    return sorted({t for t in bucket_tiles if floor <= t < top} | {top})


def _bucketed(tiles: list[int], make):
    """Lazy per-tile evaluators: ``make(tile)`` on first use; ``get(bs)``
    returns the evaluator of the smallest tile ≥ bs. The stream is drawn
    at the tile's width, so a trial's run depends on its bucket (each
    bucket is the unbucketed evaluator at that tile)."""
    evs: dict[int, Any] = {}

    def get(bs: int):
        tile = next((t for t in tiles if t >= bs), tiles[-1])
        if tile not in evs:
            evs[tile] = make(tile)
        return evs[tile]

    return get


def _clamp_batch_cap(problem, max_batch_size: int) -> int:
    """The sweep's batch ceiling clamped to what the problem's sampler can
    give per step (a fixed grid caps it: FitzHugh–Nagumo's, the UAT
    demo's)."""
    cap = problem.max_sample_size
    return int(min(max_batch_size, cap)) if cap else int(max_batch_size)


def _batch_cap(problem, space, max_batch_size):
    """_clamp_batch_cap, and a randint batch space's largest value."""
    max_bs = _clamp_batch_cap(problem, max_batch_size)
    bspec = space.specs.get("batch_size")
    if isinstance(bspec, randint):
        max_bs = min(max_bs, bspec.high - 1)
    return max_bs


def _tile_floor(problem):
    """Fredholm's k nodes must fit one tile; 1 for the others."""
    return -(-problem.k // 64) * 64 if problem.name == "fredholm" else 1


def _mesh(mesh, device):
    """An ``{axis: size}`` dict made into a mesh once per sweep, so that its
    rounds and rungs share it; a mesh (or None) as it is."""
    return as_mesh(mesh, device) if isinstance(mesh, dict) else mesh


def _unpacker(problem, model, is_dgm):
    arch = model or problem.default_model()
    if is_dgm:
        return lambda row: fused_dgm.unpack_dgm(arch, row)
    spec = fused_engine.spec_for(problem)
    return lambda row: fused_engine.unpack_state(spec, arch, row)


# ---- TPE on the fused tier --------------------------------------------------


def tpe_search_fused(problem, seed: int = 0, num_samples: int = 16,
                     sampler_seed: int = 0, model=None,
                     space: SearchSpace | None = None,
                     max_iters: int | None = None,
                     batch_size: int | None = None,
                     max_batch_size: int = 512, gamma: float = 0.25,
                     schedule: str | None = None, q: int = 1,
                     bucket_tiles=BUCKET_TILES, precision: str = "highest",
                     device="cuda") -> SweepResult:
    """TPE with every proposal trained inside the fused kernels (JAX
    ``tpe_search_fused``; its ``key`` is ``seed`` here, the sampler's
    ``seed`` is ``sampler_seed``). lr-only spaces run the fixed-shape
    evaluators (``fused_engine.make_lr_evaluator``, the DGM's
    ``make_trial_evaluator``); spaces with n_iters or batch_size run the
    sweep evaluators, the batch a row mask over the smallest tile of
    ``bucket_tiles`` that holds it and n_iters a step budget, so a trial's
    score is its own-budget final loss. ``schedule`` None: an lr-only sweep
    takes the problem's schedule, any other "constant" (the reference's
    protocol); a decaying schedule runs over each trial's own n_iters.
    ``q > 1`` proposes q trials per round and trains each round's trials of
    one tile as one packed call (:func:`_tpe_fused_batched`). ``mesh`` is
    not taken: the sharded evaluators are not ported."""
    from differential_equations_dnn_tpu_torch.sweep.tpe import TPESampler

    space = space or SearchSpace({"lrate": loguniform(1e-4, 1e-1)})
    names = set(space.specs)
    if not names <= {"lrate", "batch_size", "n_iters"}:
        raise ValueError("tpe_search_fused sweeps lrate/batch_size/"
                         f"n_iters (got {sorted(names)})")
    bs = int(batch_size if batch_size is not None
             else problem.defaults.batch_size)
    lr_only = names == {"lrate"}
    nspec = space.specs.get("n_iters")
    budget = int(max_iters if max_iters is not None
                 else (nspec.high - 1 if isinstance(nspec, randint)
                       else problem.defaults.iterations))
    if not lr_only and schedule is None:
        schedule = "constant"
    if q < 1:
        raise ValueError(f"q (concurrent proposals) must be >= 1 (got {q})")
    common = dict(model=model, schedule=schedule, precision=precision,
                  device=device)
    is_dgm = fused_dgm.supports(problem, model, bs)
    if q > 1:
        return _tpe_fused_batched(problem, seed, num_samples, sampler_seed,
                                  model, space, budget, bs, max_batch_size,
                                  gamma, schedule, q, bucket_tiles,
                                  precision, device)

    def full(c):
        return {"lrate": float(c.get("lrate", problem.defaults.lrate)),
                "batch_size": min(int(c.get("batch_size", bs)), max_bs),
                "n_iters": min(int(c.get("n_iters", budget)), budget)}

    max_bs = bs
    if lr_only:
        make = (fused_dgm.make_trial_evaluator if is_dgm
                else fused_engine.make_lr_evaluator)
        _ev = make(problem, seed, budget, batch_size=bs, **common)
        eval_fn = lambda t, c: _ev(t, c["lrate"])
        resolve = lambda c: {"lrate": float(c["lrate"]), "n_iters": budget,
                             "batch_size": bs}
    elif is_dgm and "batch_size" not in names:
        _ev = fused_dgm.make_sweep_evaluator(problem, seed, budget,
                                             batch_size=bs, **common)
        eval_fn = lambda t, c: _ev(t, c["lrate"], c["n_iters"])
        resolve = full
    else:
        # The full space: trials clamp to max_bs and route to the
        # smallest tile holding their batch.
        max_bs = _batch_cap(problem, space, max_batch_size)
        if is_dgm:
            tiles = _tiles_for(max_bs, bucket_tiles, _tile_floor(problem))
            get_ev = _bucketed(tiles, lambda tile:
                               fused_dgm.make_sweep_evaluator(
                                   problem, seed, budget, max_batch=tile,
                                   **common))
        else:
            tiles = _tiles_for(max_bs, bucket_tiles)
            get_ev = _bucketed(tiles, lambda tile:
                               fused_engine.make_sweep_evaluator(
                                   problem, seed, budget, max_batch=tile,
                                   **common))
        eval_fn = lambda t, c: get_ev(c["batch_size"])(
            t, c["lrate"], c["batch_size"], c["n_iters"])
        resolve = full

    sampler = TPESampler(space=space, seed=sampler_seed, gamma=gamma,
                         n_initial=min(4, num_samples))
    configs: list[dict] = []
    scores: list[float] = []
    best = None
    for t in range(num_samples):
        config = resolve(sampler.ask(1)[0])
        trial_losses, flat = eval_fn(t, config)
        # The trial's final loss at its own budget (the reference metric).
        loss = float(trial_losses[-1])
        sampler.tell([config], [loss])
        configs.append(config)
        scores.append(loss)
        if np.isfinite(loss) and (best is None or loss < best[0]):
            best = (loss, t, flat)
    return _tpe_result(problem, model, is_dgm, configs, scores, best)


def _tpe_result(problem, model, is_dgm, configs, scores, best):
    best_idx = int(np.nanargmin(np.where(np.isfinite(scores), scores,
                                         np.inf)))
    params = None if best is None else best[2][None]
    return SweepResult(configs=configs, scores=np.asarray(scores),
                       losses=None, params=params,
                       param_indices=np.array([best_idx]),
                       unpack=_unpacker(problem, model, is_dgm))


def _tpe_fused_batched(problem, seed, num_samples, sampler_seed, model,
                       space, budget, bs, max_batch_size, gamma, schedule,
                       q, bucket_tiles=BUCKET_TILES, precision="highest",
                       device="cuda"):
    """Batched TPE (``tpe_search_fused(q > 1)``): rounds of q proposals
    that share the surrogate's state, each round's trials grouped by their
    tile and each group one packed call of q slots (the others pruned:
    budget 0, its blocks returning at entry). The reference's
    ``ConcurrencyLimiter(max_concurrent=5)`` role (optimize_heat_ray.py:
    180)."""
    from differential_equations_dnn_tpu_torch.sweep.tpe import TPESampler

    q = min(q, num_samples)
    has_bs = "batch_size" in space.specs
    max_bs = _batch_cap(problem, space, max_batch_size)
    cap = max_bs if has_bs else bs
    is_dgm = fused_dgm.supports(problem, model, bs)
    common = dict(model=model, schedule=schedule, horizon="trial",
                  precision=precision, device=device)
    if is_dgm:
        if has_bs:
            tiles = _tiles_for(max_bs, bucket_tiles, _tile_floor(problem))
            get_ev = _bucketed(tiles, lambda tile:
                               fused_dgm.make_packed_rung_evaluator(
                                   problem, seed, budget, q, batch_size=bs,
                                   max_batch=tile, **common))
        else:
            _ev = fused_dgm.make_packed_rung_evaluator(
                problem, seed, budget, q, batch_size=bs, max_batch=None,
                **common)
            get_ev = lambda bs_: _ev
    else:
        tiles = _tiles_for(cap, bucket_tiles if has_bs else ())
        get_ev = _bucketed(tiles, lambda tile:
                           fused_engine.make_packed_rung_evaluator(
                               problem, seed, budget, q, max_batch=tile,
                               **common))

    def resolve(c):
        return {"lrate": float(c.get("lrate", problem.defaults.lrate)),
                "batch_size": min(int(c.get("batch_size", bs)), cap),
                "n_iters": min(int(c.get("n_iters", budget)), budget)}

    sampler = TPESampler(space=space, seed=sampler_seed, gamma=gamma,
                         n_initial=min(4, num_samples))
    configs: list[dict] = []
    scores: list[float] = []
    best = None
    t0 = 0
    while t0 < num_samples:
        n = min(q, num_samples - t0)
        batch = [resolve(c) for c in sampler.ask(n)]
        # This round's proposals by evaluator (tile): one call per tile.
        groups: dict[int, list[int]] = {}
        for j, c in enumerate(batch):
            groups.setdefault(id(get_ev(c["batch_size"])), []).append(j)
        round_scores = [np.inf] * n
        round_flats = [None] * n
        for js in groups.values():
            ev = get_ev(batch[js[0]]["batch_size"])
            pad = q - len(js)
            finals, stacked = ev(
                [t0 + j for j in js] + [0] * pad,
                [batch[j]["lrate"] for j in js] + [0.0] * pad,
                [batch[j]["batch_size"] for j in js] + [1] * pad,
                [batch[j]["n_iters"] for j in js] + [0] * pad)
            for pos, j in enumerate(js):
                round_scores[j] = float(finals[pos])
                round_flats[j] = stacked[pos]
        sampler.tell(batch, round_scores)
        for j, (cfg, loss) in enumerate(zip(batch, round_scores)):
            configs.append(cfg)
            scores.append(loss)
            if np.isfinite(loss) and (best is None or loss < best[0]):
                best = (loss, t0 + j, round_flats[j])
        t0 += n
    return _tpe_result(problem, model, is_dgm, configs, scores, best)


# ---- successive halving on the fused tier -----------------------------------


def halving_search_fused(problem, seed: int = 0, num_samples: int = 27,
                         sampler_seed: int = 0,
                         space: SearchSpace | None = None, model=None,
                         eta: int = 3, min_budget: int = 500,
                         max_budget: int | None = None,
                         batch_size: int | None = None,
                         max_batch_size: int = 512,
                         schedule: str | None = None,
                         draws: dict | None = None, trial_offset: int = 0,
                         mesh=None, bucket_tiles=BUCKET_TILES,
                         precision: str = "highest",
                         device="cuda") -> SweepResult:
    """Successive halving (the ASHA role) with each rung one packed call per
    bucket tile (JAX ``halving_search_fused``; ``seed`` is its ``key``,
    ``sampler_seed`` its ``seed``). Every rung evaluates its survivors
    afresh: the same init, the same stream and, with the decay horizon
    fixed at ``max_budget`` (``horizon="fixed"``), the same lr curve, so a
    survivor's rerun at eta× the budget replays its earlier rung exactly
    (restart = promotion) and the winner equals a standalone run of
    ``max_budget`` steps. The space is {lrate, batch_size} (n_iters
    belongs to the rungs); ``draws`` overrides the random draws
    (:func:`tpe_halving_fused`'s proposals) and ``trial_offset`` shifts the
    trials' init indices. ``mesh`` evaluates each rung with the sharded
    rung evaluator of its engine, on one tile of the sweep's largest batch
    (the top bucket), the rung padded with copies of its last trial to a
    multiple of the ``pop`` axis (JAX search.py:873-880)."""
    bs = int(batch_size if batch_size is not None
             else problem.defaults.batch_size)
    max_budget = int(max_budget or problem.defaults.iterations)
    if eta < 2:
        raise ValueError(f"halving needs eta >= 2 (got {eta})")
    min_budget = max(1, min(int(min_budget), max_budget))
    schedule = schedule or "constant"
    common = dict(model=model, schedule=schedule, horizon="fixed",
                  precision=precision, device=device)
    is_dgm = fused_dgm.supports(problem, model, bs)
    if is_dgm:
        space = space or SearchSpace({"lrate": loguniform(1e-4, 1e-1)})
    else:
        space = space or SearchSpace({"lrate": loguniform(1e-4, 1e-1),
                                      "batch_size": randint(1, 512)})
    if not set(space.specs) <= {"lrate", "batch_size"}:
        raise ValueError(
            "halving_search_fused sweeps lrate/batch_size; n_iters is "
            f"owned by the rung schedule (got {sorted(space.specs)})")
    has_bs = "batch_size" in space.specs
    # Without a batch space a DGM trains every trial at bs rows.
    max_bs = (bs if is_dgm and not has_bs
              else _batch_cap(problem, space, max_batch_size))
    floor = _tile_floor(problem) if is_dgm else 1
    mesh = _mesh(mesh, device)
    sharded_ev = None
    if mesh is not None:
        # One tile for every trial, the largest bucket's (JAX's design).
        top = _tiles_for(max_bs, (), floor)[-1]
        if is_dgm:
            sharded_ev = fused_dgm.make_sharded_rung_evaluator(
                problem, seed, max_budget, mesh, batch_size=bs,
                max_batch=top if has_bs else None, **common)
        else:
            sharded_ev = fused_engine.make_sharded_rung_evaluator(
                problem, seed, max_budget, mesh, max_batch=top, **common)
        n_pop = mesh_shape(mesh)["pop"]
    elif is_dgm and not has_bs:
        _pev = fused_dgm.make_packed_rung_evaluator(
            problem, seed, max_budget, num_samples, batch_size=bs,
            max_batch=None, **common)
        packed_ev = lambda bs_: _pev
    elif is_dgm:
        tiles = _tiles_for(max_bs, bucket_tiles, floor)
        packed_ev = _bucketed(tiles, lambda tile:
                              fused_dgm.make_packed_rung_evaluator(
                                  problem, seed, max_budget, num_samples,
                                  batch_size=bs, max_batch=tile, **common))
    else:
        tiles = _tiles_for(max_bs, bucket_tiles)
        packed_ev = _bucketed(tiles, lambda tile:
                              fused_engine.make_packed_rung_evaluator(
                                  problem, seed, max_budget, num_samples,
                                  max_batch=tile, **common))

    if draws is None:
        draws = space.sample(sampler_seed, num_samples)
    lrates = np.asarray(
        draws.get("lrate", np.full(num_samples, problem.defaults.lrate)),
        np.float64)
    batch_sizes = np.minimum(
        np.asarray(draws.get("batch_size", np.full(num_samples, bs)),
                   np.int64), max_bs)

    alive = np.arange(num_samples)
    # A single trial has nothing to prune against: the full budget at once.
    budget = max_budget if num_samples == 1 else min_budget
    last_scores = np.zeros(num_samples)
    iters_done = np.zeros(num_samples, dtype=np.int64)
    flats: dict[int, Any] = {}

    def eval_rung(alive, budget):
        if sharded_ev is not None:
            # The live trials only, padded with copies of the last (a copy
            # costs its own budget) to a multiple of the 'pop' axis.
            idx = [int(t) for t in alive]
            idx_p = idx + [idx[-1]] * ((-len(idx)) % n_pop)
            finals, flat_out = sharded_ev(
                [t + trial_offset for t in idx_p],
                [float(lrates[t]) for t in idx_p],
                [int(batch_sizes[t]) for t in idx_p],
                [int(budget)] * len(idx_p))
            for pos, t in enumerate(idx):
                last_scores[t] = float(finals[pos])
                flats[t] = flat_out[pos]
            return
        # One packed call per tile: a trial's tile is fixed by its batch
        # across rungs, so restart = promotion holds within its tile; dead
        # slots train 0 steps, live ones the rung's budget.
        groups: dict[int, list[int]] = {}
        for t in alive:
            groups.setdefault(id(packed_ev(int(batch_sizes[t]))),
                              []).append(int(t))
        for members in groups.values():
            pev = packed_ev(int(batch_sizes[members[0]]))
            ns = np.zeros(num_samples, np.int64)
            ns[members] = budget
            finals, flat_out = pev(np.arange(num_samples) + trial_offset,
                                   lrates, batch_sizes, ns)
            for t in members:
                last_scores[t] = float(finals[t])
                flats[int(t)] = flat_out[t]

    while True:
        eval_rung(alive, budget)
        iters_done[alive] = budget
        if budget >= max_budget or len(alive) <= 1:
            break
        keep = max(1, len(alive) // eta)
        rung = last_scores[alive]
        order = np.argsort(np.where(np.isfinite(rung), rung, np.inf))
        alive = alive[order[:keep]]
        budget = min(budget * eta, max_budget)
        if len(alive) == 1:
            # The lone survivor takes the whole remaining budget.
            budget = max_budget

    params = torch.stack([flats[int(t)] for t in alive])
    configs = [
        {"batch_size": int(batch_sizes[i]), "lrate": float(lrates[i]),
         "n_iters": int(iters_done[i])}
        for i in range(num_samples)
    ]
    return SweepResult(configs=configs, scores=np.asarray(last_scores),
                       losses=None, params=params, param_indices=alive,
                       unpack=_unpacker(problem, model, is_dgm))


# ---- TPE × successive halving (the reference's scheduler pairing) -----------


def _tpe_brackets(space, seed: int, gamma: float, brackets: int,
                  num_samples: int, inner) -> SweepResult:
    """The TPE × halving bracket driver: ``inner(bracket, per_bracket,
    draws) -> SweepResult`` runs one halving bracket on the proposed
    configs; the sampler is told every trial's realised (config, score),
    a dropped trial's at its last rung, and the best fully trained trial
    over the brackets wins."""
    from differential_equations_dnn_tpu_torch.sweep.tpe import TPESampler

    brackets = max(1, min(brackets, num_samples))
    per_bracket = -(-num_samples // brackets)
    sampler = TPESampler(space=space, seed=seed, gamma=gamma,
                         n_initial=per_bracket)
    all_configs: list[dict] = []
    all_scores: list[float] = []
    best_params = None
    best_flat_idx = -1
    best_score = np.inf
    res = None
    for b in range(brackets):
        proposals = sampler.ask(per_bracket)
        draws = {name: np.asarray([c[name] for c in proposals])
                 for name in space.specs}
        res = inner(b, per_bracket, draws)
        sampler.tell(res.configs, res.scores)
        finite = np.where(np.isfinite(res.scores), res.scores, np.inf)
        eligible = np.full_like(finite, np.inf)
        eligible[res.param_indices] = finite[res.param_indices]
        b_best = int(np.argmin(eligible))
        if eligible[b_best] < best_score:
            best_score = float(eligible[b_best])
            best_flat_idx = len(all_configs) + b_best
            best_params = _best_row(res)
        all_configs.extend(res.configs)
        all_scores.extend(float(s) for s in res.scores)
    if best_params is None:
        # Every bracket's survivors diverged: the last bracket's best, so
        # that the result stays inspectable.
        best_flat_idx = len(all_configs) - len(res.configs) + res.best_index
        best_params = _best_row(res)
    return SweepResult(configs=all_configs, scores=np.asarray(all_scores),
                       losses=None, params=best_params,
                       param_indices=np.array([best_flat_idx]),
                       unpack=res.unpack)


def _best_row(res):
    """A result's best trial's flat state, ``[1, n]`` (a population's
    stacked dicts at that trial)."""
    return take_trial(res.params, int(np.where(
        res.param_indices == res.best_index)[0][0]))


def tpe_halving_fused(problem, seed: int = 0, num_samples: int = 27,
                      sampler_seed: int = 0,
                      space: SearchSpace | None = None, model=None,
                      eta: int = 3, min_budget: int = 500,
                      max_budget: int | None = None,
                      batch_size: int | None = None,
                      max_batch_size: int = 512,
                      schedule: str | None = None, brackets: int = 3,
                      gamma: float = 0.1, mesh=None,
                      bucket_tiles=BUCKET_TILES, precision: str = "highest",
                      device="cuda") -> SweepResult:
    """The reference's pairing (OptunaSearch + ASHA, optimize_heat_ray.py:
    179-181) on the fused tier (JAX ``tpe_halving_fused``): TPE proposes
    each bracket's configs, :func:`halving_search_fused` prunes them, and
    every bracket reuses the same evaluators and graphs (the same seed,
    hence the same stream; ``trial_offset`` gives each bracket fresh
    inits). Dropped trials report their last rung's score at their
    realised budget. ``mesh`` as for :func:`halving_search_fused`."""
    mesh = _mesh(mesh, device)
    if space is None:
        bs = int(batch_size if batch_size is not None
                 else problem.defaults.batch_size)
        if fused_dgm.supports(problem, model, bs):
            space = SearchSpace({"lrate": loguniform(1e-4, 1e-1)})
        else:
            space = SearchSpace({"lrate": loguniform(1e-4, 1e-1),
                                 "batch_size": randint(1, 512)})

    def inner(b, per_bracket, draws):
        return halving_search_fused(
            problem, seed, num_samples=per_bracket,
            sampler_seed=sampler_seed + b, space=space, model=model,
            eta=eta, min_budget=min_budget, max_budget=max_budget,
            batch_size=batch_size, max_batch_size=max_batch_size,
            schedule=schedule, draws=draws, trial_offset=b * per_bracket,
            mesh=mesh, bucket_tiles=bucket_tiles, precision=precision,
            device=device)

    return _tpe_brackets(space, sampler_seed, gamma, brackets, num_samples,
                         inner)


# ---- the population drivers (the JAX package's sweep/search.py) ------------


def _default_model(problem, model):
    """The population's architecture: ``model``, or the problem's default
    (its own weights are not trained: every trial draws its init)."""
    return model if model is not None else \
        problem.default_model(generator=generator(0))


def _draw(draws, name, n, default, dtype):
    return np.asarray(draws.get(name, np.full(n, default)), dtype=dtype)


def random_search(problem, seed: int = 0, num_samples: int = 10,
                  space: SearchSpace | None = None, model=None,
                  sampler_seed: int = 0, mesh=None,
                  max_batch_size: int = 512, max_iters: int | None = None,
                  chunk_size: int = 1000, device="cuda") -> SweepResult:
    """Sample ``num_samples`` configs and train them all as one population
    (JAX ``random_search``; its ``key`` is ``seed`` here, its ``seed`` the
    space's ``sampler_seed``). Each trial is scored by its final loss at its
    own budget, minimised: the reference's metric
    (optimize_heat_ray.py:157,196). ``mesh`` shards the population over
    its ``pop`` axis (``train_population(mesh=)``)."""
    space = space or heat_search_space()
    model = _default_model(problem, model)
    max_batch_size = _clamp_batch_cap(problem, max_batch_size)
    draws = space.sample(sampler_seed, num_samples)
    d = problem.defaults
    lrates = _draw(draws, "lrate", num_samples, d.lrate, np.float32)
    batch_sizes = _draw(draws, "batch_size", num_samples, d.batch_size,
                        np.int32)
    n_iters = _draw(draws, "n_iters", num_samples, d.iterations, np.int64)
    budget = int(max_iters if max_iters is not None else n_iters.max())
    n_iters = np.minimum(n_iters, budget)
    batch_sizes = np.minimum(batch_sizes, max_batch_size)

    config = PopulationConfig(iterations=budget,
                              max_batch_size=max_batch_size,
                              chunk_size=chunk_size)
    params, _, losses = train_population(problem, model, seed, lrates,
                                         batch_sizes, config=config,
                                         mesh=mesh, device=device)
    scores = losses[n_iters - 1, np.arange(num_samples)]
    configs = [{"batch_size": int(b), "n_iters": int(i), "lrate": float(l)}
               for b, i, l in zip(batch_sizes, n_iters, lrates)]
    return SweepResult(configs=configs, scores=scores, losses=losses,
                       params=params)


def successive_halving(problem, seed: int = 0, num_samples: int = 27,
                       space: SearchSpace | None = None, model=None,
                       sampler_seed: int = 0, mesh=None, eta: int = 3,
                       min_budget: int = 500, max_budget: int | None = None,
                       max_batch_size: int = 512, chunk_size: int = 500,
                       draws: dict | None = None,
                       device="cuda") -> SweepResult:
    """Synchronous successive halving on populations (JAX
    ``successive_halving``, the ASHA role of optimize_heat_ray.py:181):
    train the population to the rung's budget, keep the best 1/eta,
    continue the survivors with their optimizer state (``take_trials``) at
    eta× the budget, each rung at seed ``fold_seed(seed, spent)`` (JAX's
    ``fold_in(key, spent)``). The scheduler owns the budget: a config's
    ``n_iters`` is the steps its trial trained. ``draws`` (a dict of
    [num_samples] arrays) overrides the space's draws (how
    :func:`tpe_halving` injects proposals). ``mesh`` shards each rung's
    population over its ``pop`` axis, which must divide it."""
    mesh = _mesh(mesh, device)
    space = space or heat_search_space()
    model = _default_model(problem, model)
    max_batch_size = _clamp_batch_cap(problem, max_batch_size)
    if draws is None:
        draws = space.sample(sampler_seed, num_samples)
    d = problem.defaults
    lrates = _draw(draws, "lrate", num_samples, d.lrate, np.float32)
    batch_sizes = np.minimum(_draw(draws, "batch_size", num_samples,
                                   d.batch_size, np.int64),
                             max_batch_size).astype(np.int32)
    max_budget = int(max_budget or d.iterations)
    if eta < 2:
        raise ValueError(f"halving needs eta >= 2 (got {eta})")
    min_budget = max(1, min(int(min_budget), max_budget))

    alive = np.arange(num_samples)
    params = opt_state = None
    # A single trial has nothing to prune against: its full budget at once.
    budget = max_budget if num_samples == 1 else min_budget
    spent = 0
    last_scores = np.zeros(num_samples)
    iters_done = np.zeros(num_samples, dtype=np.int64)
    while True:
        config = PopulationConfig(iterations=budget - spent,
                                  max_batch_size=max_batch_size,
                                  chunk_size=chunk_size)
        params, opt_state, losses = train_population(
            problem, model, fold_seed(seed, spent), lrates[alive],
            batch_sizes[alive], config=config, mesh=mesh, params=params,
            opt_state=opt_state, device=device)
        rung_scores = losses[-1]
        last_scores[alive] = rung_scores
        spent = budget
        iters_done[alive] = spent
        if budget >= max_budget or len(alive) <= 1:
            break
        keep = max(1, len(alive) // eta)
        order = np.argsort(np.where(np.isfinite(rung_scores), rung_scores,
                                    np.inf))
        survivors = order[:keep]
        alive = alive[survivors]
        params = take_trials(params, survivors)
        opt_state = take_trials(opt_state, survivors)
        budget = min(budget * eta, max_budget)

    configs = [{"batch_size": int(batch_sizes[i]), "lrate": float(lrates[i]),
                "n_iters": int(iters_done[i])} for i in range(num_samples)]
    # Pruned trials keep their last rung's score, survivors their final.
    return SweepResult(configs=configs, scores=np.asarray(last_scores),
                       losses=None, params=params, param_indices=alive)


def tpe_search(problem, seed: int = 0, num_samples: int = 10,
               space: SearchSpace | None = None, model=None,
               sampler_seed: int = 0, mesh=None, max_batch_size: int = 512,
               max_iters: int | None = None, chunk_size: int = 1000,
               rounds: int = 3, gamma: float = 0.25,
               device="cuda") -> SweepResult:
    """TPE on populations (JAX ``tpe_search``, the OptunaSearch half of
    optimize_heat_ray.py:179-181): ``num_samples`` trials in ``rounds``
    equal populations, the first the sampler's random bootstrap, each later
    one its proposals given every earlier score; round r trains at seed
    ``fold_seed(seed, r)``. Every trial trains to the shared budget
    (``max_iters`` or the problem's) and is scored at its own ``n_iters``;
    the result holds the globally best trial's parameters. ``mesh``
    shards each round's population over its ``pop`` axis."""
    from differential_equations_dnn_tpu_torch.sweep.tpe import TPESampler

    mesh = _mesh(mesh, device)
    space = space or heat_search_space()
    model = _default_model(problem, model)
    max_batch_size = _clamp_batch_cap(problem, max_batch_size)
    d = problem.defaults
    budget = int(max_iters if max_iters is not None else d.iterations)
    rounds = max(1, min(rounds, num_samples))
    per_round = -(-num_samples // rounds)
    sampler = TPESampler(space=space, seed=sampler_seed, gamma=gamma,
                         n_initial=per_round)
    config = PopulationConfig(iterations=budget,
                              max_batch_size=max_batch_size,
                              chunk_size=chunk_size)
    all_configs: list[dict] = []
    all_scores: list[float] = []
    best_params, best_flat_idx, best_score = None, -1, np.inf
    r = 0
    while len(all_configs) < num_samples:
        proposals = sampler.ask(per_round)
        lrates = np.asarray([float(c.get("lrate", d.lrate))
                             for c in proposals], np.float32)
        batch_sizes = np.asarray(
            [min(int(c.get("batch_size", d.batch_size)), max_batch_size)
             for c in proposals], np.int32)
        n_iters = np.asarray([min(int(c.get("n_iters", budget)), budget)
                              for c in proposals], np.int64)
        params, _, losses = train_population(
            problem, model, fold_seed(seed, r), lrates, batch_sizes,
            config=config, mesh=mesh, device=device)
        scores = losses[n_iters - 1, np.arange(per_round)]
        resolved = [{"batch_size": int(b), "n_iters": int(i),
                     "lrate": float(l)}
                    for b, i, l in zip(batch_sizes, n_iters, lrates)]
        sampler.tell(resolved, scores)
        finite = np.where(np.isfinite(scores), scores, np.inf)
        round_best = int(np.argmin(finite))
        if finite[round_best] < best_score:
            best_score = float(finite[round_best])
            best_flat_idx = len(all_configs) + round_best
            best_params = take_trials(params, np.array([round_best]))
        all_configs.extend(resolved)
        all_scores.extend(float(x) for x in scores)
        r += 1
    return SweepResult(configs=all_configs, scores=np.asarray(all_scores),
                       losses=None, params=best_params,
                       param_indices=np.array([best_flat_idx]))


def tpe_halving(problem, seed: int = 0, num_samples: int = 27,
                space: SearchSpace | None = None, model=None,
                sampler_seed: int = 0, mesh=None, eta: int = 3,
                min_budget: int = 500, max_budget: int | None = None,
                max_batch_size: int = 512, chunk_size: int = 500,
                brackets: int = 3, gamma: float = 0.1,
                device="cuda") -> SweepResult:
    """TPE proposing each halving bracket's configs, on populations (JAX
    ``tpe_halving``: OptunaSearch with AsyncHyperBandScheduler,
    optimize_heat_ray.py:179-181). Bracket b runs
    :func:`successive_halving` at seed ``fold_seed(seed, b)`` on the
    sampler's proposals; the best fully trained trial wins. ``mesh`` as
    for :func:`successive_halving`."""
    mesh = _mesh(mesh, device)
    space = space or heat_search_space()
    model = _default_model(problem, model)
    max_batch_size = _clamp_batch_cap(problem, max_batch_size)

    def inner(b, per_bracket, draws):
        return successive_halving(
            problem, fold_seed(seed, b), num_samples=per_bracket,
            space=space, model=model, sampler_seed=sampler_seed + b,
            eta=eta, min_budget=min_budget, max_budget=max_budget,
            max_batch_size=max_batch_size, chunk_size=chunk_size,
            draws=draws, mesh=mesh, device=device)

    return _tpe_brackets(space, sampler_seed, gamma, brackets, num_samples,
                         inner)
