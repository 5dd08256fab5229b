"""The port's fused sweep tier (differential_equations_dnn_tpu_torch/sweep/
and the evaluators of kernels/fused_engine.py and fused_dgm.py) against the
JAX package's sweep/: the TPE sampler bit for bit, the bucket tiles, the
result type, and the three drivers with the same numpy fake evaluator in
both packages' factories (configs, scores, the trials holding params and the
realised budgets must be equal); then the port's own evaluators on the CPU
at small sizes (H = 8, L = 1, tiles of 16 rows, at most 8 steps): restart
equals promotion, a packed slot equals the sequential trial, and what the
evaluators refuse."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from differential_equations_dnn_tpu import sweep as jsweep  # noqa: E402
from differential_equations_dnn_tpu.equations import (  # noqa: E402
    PROBLEMS as JAX_PROBLEMS,
)
from differential_equations_dnn_tpu.kernels import (  # noqa: E402
    fused_dgm as jfd,
)
from differential_equations_dnn_tpu.kernels import (  # noqa: E402
    fused_engine as jfe,
)
from differential_equations_dnn_tpu.sweep import search as jsearch  # noqa: E402
from differential_equations_dnn_tpu_torch import sweep  # noqa: E402
from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    PROBLEMS,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_dgm as fd,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_engine as fe,
)
from differential_equations_dnn_tpu_torch.models import MLP  # noqa: E402
from differential_equations_dnn_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
)
from differential_equations_dnn_tpu_torch.sweep import (  # noqa: E402
    search,
)

# ---------------------------------------------------------------------------
# The sampler, the tiles and the result type
# ---------------------------------------------------------------------------


def _spaces(pkg):
    """The same spaces built from either package's primitives."""
    return {
        "heat": pkg.heat_search_space(),
        "mixed": pkg.SearchSpace({
            "lrate": pkg.loguniform(1e-4, 1e-1),
            "width": pkg.uniform(0.0, 2.0),
            "depth": pkg.randint(1, 5),
            "act": pkg.choice(("tanh", "relu", "sigmoid")),
        }),
    }


def _objective(cfg):
    """A deterministic score with a basin, so the good group changes."""
    s = (np.log10(float(cfg["lrate"])) + 2.5) ** 2
    for name, scale in (("batch_size", 1e-3), ("n_iters", 1e-5),
                        ("width", 0.3), ("depth", 0.1)):
        if name in cfg:
            s += scale * abs(float(cfg[name]) - 3.0)
    if cfg.get("act") == "relu":
        s += 0.2
    return s


@pytest.mark.parametrize("space", ["heat", "mixed"])
@pytest.mark.parametrize("per_ask", [1, 3])
def test_tpe_sampler_matches_jax(space, per_ask):
    """Twelve rounds of ask/tell from the same seed and the same scores
    propose the same configs, value for value (a numpy copy of JAX's
    sampler)."""
    ours = sweep.TPESampler(space=_spaces(sweep)[space], seed=3, gamma=0.25,
                            n_initial=4)
    theirs = jsweep.TPESampler(space=_spaces(jsweep)[space], seed=3,
                               gamma=0.25, n_initial=4)
    for _ in range(12):
        a, b = ours.ask(per_ask), theirs.ask(per_ask)
        assert len(a) == len(b) == per_ask
        for ca, cb in zip(a, b):
            assert ca.keys() == cb.keys()
            for k in ca:
                assert ca[k] == cb[k], (k, ca[k], cb[k])
        scores = [_objective(c) for c in a]
        ours.tell(a, scores)
        theirs.tell(b, scores)


@pytest.mark.parametrize("max_bs, floor", [(511, 1), (100, 1), (64, 1),
                                           (30, 1), (511, 64), (40, 64),
                                           (1000, 1)])
def test_tiles_for_matches_jax(max_bs, floor):
    got = search._tiles_for(max_bs, search.BUCKET_TILES, floor)
    assert got == jsearch._tiles_for(max_bs, jsearch.BUCKET_TILES, floor)


def test_bucketed_routes_to_the_smallest_tile():
    """A trial takes the smallest tile holding its batch (the top tile past
    it), and each tile's evaluator is made once, on first use, as in
    JAX's _bucketed."""
    made = []
    for mod in (search, jsearch):
        calls = []
        get = mod._bucketed([64, 128, 512],
                            lambda t: calls.append(t) or f"ev{t}")
        made.append(([get(bs) for bs in (1, 64, 65, 300, 900, 2)], calls))
    assert made[0] == made[1]
    assert made[0] == (["ev64", "ev64", "ev128", "ev512", "ev512", "ev64"],
                       [64, 128, 512])


@pytest.mark.parametrize("scores, indices", [
    ([0.3, 0.1, np.nan, 0.2], None),
    ([0.3, 0.1, np.nan, 0.2], [0, 3]),
    ([np.nan, 0.1, np.inf, np.nan], [0, 2]),
])
def test_sweep_result_matches_jax(scores, indices):
    """The best trial as JAX's SweepResult picks it (only trials holding
    params, an all-diverged set pointing at one of them), and best_params
    the tensors of its flat state in flat-state order, each [1, ...]."""
    prob = PROBLEMS["heat"]()
    model = MLP(2, 1, 8, 1, "tanh", generator=generator(0))
    spec = fe.spec_for(prob)
    n = len(indices) if indices is not None else len(scores)
    params = torch.arange(n * fe.state_size(spec, model),
                          dtype=torch.float32).reshape(n, -1)
    pi = None if indices is None else np.asarray(indices)
    ours = search.SweepResult(configs=[{"i": i} for i in range(4)],
                              scores=np.asarray(scores), losses=None,
                              params=params, param_indices=pi,
                              unpack=lambda r: fe.unpack_state(spec, model,
                                                               r))
    theirs = jsearch.SweepResult(configs=[{"i": i} for i in range(4)],
                                 scores=np.asarray(scores), losses=None,
                                 params=None, param_indices=pi)
    assert ours.best_index == theirs.best_index
    assert ours.best_config == {"i": theirs.best_index}
    pos = (ours.best_index if pi is None
           else int(np.where(pi == ours.best_index)[0][0]))
    got = ours.best_params()
    assert [tuple(t.shape) for t in got] == [
        (1,) + s for s in fe.state_shapes(spec, model)]
    assert torch.equal(torch.cat([t.reshape(-1) for t in got]), params[pos])


# ---------------------------------------------------------------------------
# The drivers against JAX's, on one numpy fake evaluator
# ---------------------------------------------------------------------------


def _score(t, lr, bs, n):
    """The fake trial's final loss: a function of its values alone."""
    return (float((np.log10(lr) + 2.0) ** 2 + 1e-3 * abs(bs - 100)
                   + 50.0 / max(n, 1) + 1e-4 * t))


class _Fakes:
    """Both packages' evaluator factories, faked with one numpy score. A
    flat state is the trial index (a tuple of one array for JAX)."""

    def __init__(self, monkeypatch, jax_side):
        self.made = []
        self.jax = jax_side
        eng, dgm = (jfe, jfd) if jax_side else (fe, fd)
        for mod in (eng, dgm):
            monkeypatch.setattr(mod, "make_sweep_evaluator", self.sweep)
            monkeypatch.setattr(mod, "make_packed_rung_evaluator",
                                self.packed)
        monkeypatch.setattr(eng, "make_lr_evaluator", self.lr)
        monkeypatch.setattr(dgm, "make_trial_evaluator", self.lr)
        if jax_side:
            monkeypatch.setattr(jfe, "unpack_params", lambda m, fl: fl)
            monkeypatch.setattr(jfd, "unpack_dgm", lambda fl: fl)

    def _flat(self, t):
        v = np.asarray([float(t)], np.float32)
        return (v,) if self.jax else torch.from_numpy(v)

    def lr(self, problem, key, iterations, batch_size=64, **kw):
        self.made.append(("lr", iterations, batch_size))

        def ev(t, lr=None):
            return (np.asarray([9.0, _score(t, lr, batch_size, iterations)]),
                    self._flat(t))
        return ev

    def sweep(self, problem, key, max_iters, batch_size=100, max_batch=None,
              **kw):
        self.made.append(("sweep", max_iters, max_batch, kw.get("horizon")))
        width = max_batch or batch_size

        def ev(t, lr, *rest):
            bs, n = rest if len(rest) == 2 else (width, rest[0])
            bs = max(1, min(int(bs), width))
            n = max(1, min(int(n), max_iters))
            return np.asarray([9.0, _score(t, lr, bs, n)]), self._flat(t)
        return ev

    def packed(self, problem, key, max_iters, n_slots, batch_size=100,
               max_batch=None, **kw):
        self.made.append(("packed", max_iters, n_slots, max_batch,
                          kw.get("horizon")))
        width = max_batch or batch_size

        def ev(idx, lrs, bss, ns):
            ns = np.clip(np.asarray(ns), 0, max_iters)
            bss = np.clip(np.asarray(bss), 1, width)
            finals = np.asarray([_score(t, lr, bs, n) if n > 0 else np.inf
                                 for t, lr, bs, n in zip(idx, lrs, bss,
                                                         ns)])
            flat = np.asarray(idx, np.float32)[:, None]
            return finals, ((flat,) if self.jax else torch.from_numpy(flat))
        return ev


def _heat_space(pkg):
    s = pkg.heat_search_space()
    return pkg.SearchSpace({**s.specs, "n_iters": pkg.randint(1000, 4000)})


# driver, equation, problem arguments, driver arguments (space built per
# package: None, "lr", "heat", "lr_bs")
DRIVER_CASES = {
    "tpe lr-only mlp": ("tpe", "heat", {}, dict(num_samples=7), "lr"),
    "tpe full mlp": ("tpe", "heat", {}, dict(num_samples=7), "heat"),
    "tpe q=3 mlp": ("tpe", "heat", {}, dict(num_samples=8, q=3), "heat"),
    "tpe lr-only dgm": ("tpe", "fitzhugh_nagumo", dict(causal_eps=0.0),
                        dict(num_samples=5, max_iters=3000), "lr"),
    "tpe full fredholm": ("tpe", "fredholm", dict(k=16),
                          dict(num_samples=6, max_iters=3000), "heat"),
    "tpe q=2 fredholm": ("tpe", "fredholm", dict(k=16),
                         dict(num_samples=5, max_iters=3000, q=2), "heat"),
    "halving mlp": ("halving", "heat", {},
                    dict(num_samples=9, max_budget=4500), None),
    "halving dgm": ("halving", "fitzhugh_nagumo", dict(causal_eps=0.0),
                    dict(num_samples=9, max_budget=4500), None),
    "halving fredholm bs": ("halving", "fredholm", dict(k=16),
                            dict(num_samples=6, max_budget=1500), "lr_bs"),
    "tpe-halving mlp": ("tpe-halving", "heat", {},
                        dict(num_samples=12, max_budget=4500, brackets=2),
                        None),
}


def _run_driver(pkg_side, driver, name, extra, kw, space_kind, seed):
    jax_side = pkg_side == "jax"
    pkg = jsweep if jax_side else sweep
    prob = (JAX_PROBLEMS if jax_side else PROBLEMS)[name](**extra)
    space = {None: None, "heat": _heat_space(pkg),
             "lr": pkg.SearchSpace({"lrate": pkg.loguniform(1e-4, 1e-1)}),
             "lr_bs": pkg.SearchSpace({"lrate": pkg.loguniform(1e-4, 1e-1),
                                       "batch_size": pkg.randint(1, 512)}),
             }[space_kind]
    fn = {"tpe": pkg.tpe_search_fused, "halving": pkg.halving_search_fused,
          "tpe-halving": pkg.tpe_halving_fused}[driver]
    if jax_side:
        return fn(prob, jax.random.key(0), seed=seed, space=space, **kw)
    return fn(prob, seed=0, sampler_seed=seed, space=space, device="cpu",
              **kw)


@pytest.mark.parametrize("case", sorted(DRIVER_CASES))
def test_driver_matches_jax(case, monkeypatch):
    """Both packages' driver on the same fake evaluator: the same configs
    (the realised n_iters among them), scores, trials holding params, best
    trial and evaluators made (budget, tile, horizon)."""
    driver, name, extra, kw, space_kind = DRIVER_CASES[case]
    results, made = [], []
    for side in ("jax", "torch"):
        with monkeypatch.context() as mp:
            fakes = _Fakes(mp, side == "jax")
            results.append(_run_driver(side, driver, name, extra, kw,
                                       space_kind, seed=5))
            made.append(fakes.made)
    theirs, ours = results
    assert made[0] == made[1]
    assert len(ours.configs) == len(theirs.configs)
    for a, b in zip(ours.configs, theirs.configs):
        assert a.keys() == b.keys()
        for k in a:
            assert a[k] == b[k], (k, a[k], b[k])
    np.testing.assert_array_equal(ours.scores, theirs.scores)
    np.testing.assert_array_equal(ours.param_indices, theirs.param_indices)
    assert ours.best_index == theirs.best_index
    # A fake flat state is its trial's index: the params hold the trials
    # param_indices names, the best one among them.
    held = ours.params[:, 0].numpy()
    np.testing.assert_array_equal(held, ours.param_indices)
    assert ours.best_index in ours.param_indices


def test_mesh_is_not_ported():
    """Since item 14 the fused halving drivers take a mesh and evaluate
    their rungs with the sharded rung evaluators
    (tests/test_torch_parallel.py); a mesh without a 'pop' axis is refused
    with the JAX package's ValueError, before any trial trains."""
    mesh = make_mesh({"data": 1}, "cpu")
    with pytest.raises(ValueError, match="'pop' mesh axis"):
        sweep.halving_search_fused(PROBLEMS["heat"](), mesh=mesh,
                                   device="cpu")
    with pytest.raises(ValueError, match="'pop' mesh axis"):
        sweep.tpe_halving_fused(PROBLEMS["heat"](), mesh=mesh, device="cpu")


# ---------------------------------------------------------------------------
# The port's evaluators on the CPU
# ---------------------------------------------------------------------------

SMALL = dict(model=MLP(2, 1, 8, 1, "tanh", generator=generator(0)),
             device="cpu")


@pytest.mark.parametrize("horizon", ["fixed", "trial"])
def test_restart_equals_promotion(horizon):
    """A trial rerun at a larger budget replays its earlier run exactly
    under the fixed horizon (a cosine schedule over max_iters): the first
    3 of 7 steps' losses bit for bit. Under the trial horizon each budget
    has its own lr curve, so they differ."""
    prob = PROBLEMS["heat"]()
    ev = fe.make_sweep_evaluator(prob, 0, 8, max_batch=16,
                                 schedule="cosine", horizon=horizon, **SMALL)
    short, _ = ev(2, 3e-3, 11, 3)
    long, _ = ev(2, 3e-3, 11, 7)
    assert short.shape == (3,) and long.shape == (7,)
    assert np.array_equal(long[:3], short) == (horizon == "fixed")


def test_packed_slot_equals_the_sequential_trial():
    """(b) on the CPU: each slot of the packed rung evaluator (its own lr,
    batch and budget; a pruned slot +inf) equals the sequential
    evaluator's trial bit for bit, its state and its final loss."""
    prob = PROBLEMS["heat"]()
    kw = dict(max_batch=16, schedule="cosine", horizon="fixed", **SMALL)
    packed = fe.make_packed_rung_evaluator(prob, 0, 8, 3, **kw)
    single = fe.make_sweep_evaluator(prob, 0, 8, **kw)
    idx, lrs, bss, ns = [4, 9, 1], [1e-3, 1e-2, 3e-3], [16, 5, 9], [6, 0, 3]
    finals, states = packed(idx, lrs, bss, ns)
    assert finals[1] == np.inf
    for r in (0, 2):
        losses, p = single(idx[r], lrs[r], bss[r], ns[r])
        assert finals[r] == losses[-1]
        assert torch.equal(states[r], p)


def test_dgm_packed_slot_equals_the_sequential_trial():
    """The same on the DGM engine (Fredholm, gauss k = 12, on a 16-row
    tile with its batch masked; FitzHugh–Nagumo lr-only)."""
    from differential_equations_dnn_tpu_torch.models import DGM

    fred = PROBLEMS["fredholm"](k=12)
    model = DGM(1, 1, 8, 1, "relu", "xavier_relu", generator=generator(0))
    kw = dict(max_batch=16, schedule="cosine", horizon="fixed", model=model,
              device="cpu")
    packed = fd.make_packed_rung_evaluator(fred, 0, 6, 2, **kw)
    single = fd.make_sweep_evaluator(fred, 0, 6, **kw)
    finals, states = packed([3, 5], [1e-3, 1e-2], [16, 7], [4, 2])
    for r, (t, lr, bs, n) in enumerate([(3, 1e-3, 16, 4), (5, 1e-2, 7, 2)]):
        losses, p = single(t, lr, bs, n)
        assert finals[r] == losses[-1] and torch.equal(states[r], p)
    fn = PROBLEMS["fitzhugh_nagumo"](causal_eps=0.0)
    model = DGM(1, 2, 8, 1, "tanh", "torch", generator=generator(0))
    kw = dict(batch_size=8, model=model, device="cpu")
    packed = fd.make_packed_rung_evaluator(fn, 0, 5, 2, **kw)
    single = fd.make_sweep_evaluator(fn, 0, 5, **kw)
    finals, states = packed([0, 1], [1e-3, 1e-2], [8, 8], [5, 2])
    losses, p = single(1, 1e-2, 2)
    assert finals[1] == losses[-1] and torch.equal(states[1], p)


def test_masked_trial_equals_its_standalone_run():
    """(a) on the CPU: a trial of batch bs on a 16-row tile equals an
    unmasked chunk of its config on the first bs rows of the tile's stream
    (the same init), to rtol 1e-5 / atol 1e-6."""
    from differential_equations_dnn_tpu_torch.core.prng import step_uniforms

    prob = PROBLEMS["heat"]()
    spec = fe.spec_for(prob)
    ev = fe.make_sweep_evaluator(prob, 0, 8, max_batch=16, **SMALL)
    losses, p = ev(3, 3e-3, 9, 6)
    p0 = fe.trial_state(prob, SMALL["model"], 0, [3],
                        lambda m: fe.pack_state(spec, m), "cpu")[0]
    u = step_uniforms(0, 0, 6, 16, None, 2)[:, :9].contiguous()
    z = torch.zeros_like(p0)
    pw, _, _, lw = fe.fused_engine_chunk(spec, SMALL["model"], p0, z, z, u,
                                         0, 3e-3)
    np.testing.assert_allclose(losses, lw.numpy(), rtol=1e-5, atol=1e-6)
    torch.testing.assert_close(p, pw, rtol=1e-5, atol=1e-6)


def test_lr_sweep_is_its_evaluator():
    """lr_sweep's final losses and states are make_lr_evaluator's trials,
    and "mixed" runs its two phases there; the sweep evaluators refuse
    "mixed" and an unknown horizon."""
    prob = PROBLEMS["heat"]()
    finals, states = fe.lr_sweep(prob, 1, [1e-3, 1e-2], 4, batch_size=8,
                                 **SMALL)
    ev = fe.make_lr_evaluator(prob, 1, 4, batch_size=8, **SMALL)
    for t, lr in enumerate([1e-3, 1e-2]):
        losses, p = ev(t, lr)
        assert finals[t] == losses[-1] and torch.equal(states[t], p)
    mixed = fe.make_lr_evaluator(prob, 1, 4, batch_size=8,
                                 precision="mixed", **SMALL)
    assert mixed(0, 1e-3)[0].shape == (4,)
    with pytest.raises(ValueError, match="single-phase"):
        fe.make_sweep_evaluator(prob, 0, 8, max_batch=16, precision="mixed",
                                **SMALL)
    with pytest.raises(ValueError, match="horizon"):
        fd.make_packed_rung_evaluator(PROBLEMS["fredholm"](), 0, 8, 2,
                                      horizon="rung", device="cpu")


def test_sweep_launches_are_tallied_by_shape():
    """count_launch counts a sweep-mode launch under its (tile, replicas)
    shape too, and a launch outside the mode nowhere there; the four
    sweep-capable wrappers start with an empty tally."""
    from differential_equations_dnn_tpu_torch.kernels.fused_train import (
        count_launch,
    )

    def fn():
        pass

    fn.launches = fn.sweep_launches = fn.bf16_launches = 0
    fn.sweep_shapes = {}
    count_launch(fn, "highest", sweep=True, shape=(512, 5))
    count_launch(fn, "highest", sweep=True, shape=(512, 5))
    count_launch(fn, "default", sweep=True, shape=(64, 1))
    count_launch(fn, "highest")
    assert (fn.launches, fn.sweep_launches, fn.bf16_launches) == (4, 3, 1)
    assert fn.sweep_shapes == {(512, 5): 2, (64, 1): 1}
    for wrapper in (fe.fused_engine_chunk, fe.fused_engine_packed_chunk,
                    fd.fused_dgm_chunk, fd.fused_dgm_packed_chunk):
        assert wrapper.sweep_shapes == {}


def test_fredholm_batch_sweep_needs_its_nodes_in_the_tile():
    """A batch-size sweep refuses a Fredholm tile smaller than its k nodes,
    and runs FitzHugh–Nagumo at causal_eps = 0, as in JAX."""
    with pytest.raises(ValueError, match="quadrature"):
        fd.make_sweep_evaluator(PROBLEMS["fredholm"](k=50), 0, 8,
                                max_batch=32, device="cpu")
    fn = PROBLEMS["fitzhugh_nagumo"]()
    assert fn.causal_eps > 0
    assert fd._sweep_problem(fn, 64).causal_eps == 0.0
    assert fd._sweep_problem(fn, None) is fn


def test_drivers_run_on_the_cpu():
    """The three drivers end to end through the port's evaluators at small
    sizes: finite best scores, the realised budgets, and best_params in
    flat-state order."""
    prob = PROBLEMS["heat"]()
    space = sweep.SearchSpace({"batch_size": sweep.randint(1, 40),
                               "n_iters": sweep.randint(2, 5),
                               "lrate": sweep.loguniform(1e-3, 1e-2)})
    res = sweep.tpe_search_fused(prob, num_samples=4, space=space, q=2,
                                 **SMALL)
    assert np.isfinite(res.best_score)
    assert all(2 <= c["n_iters"] <= 4 for c in res.configs)
    assert [tuple(t.shape) for t in res.best_params()][0] == (1, 2, 8)
    res = sweep.halving_search_fused(prob, num_samples=4, eta=2,
                                     min_budget=2, max_budget=4,
                                     **SMALL)
    assert sorted(c["n_iters"] for c in res.configs) == [2, 2, 4, 4]
    res = sweep.tpe_halving_fused(prob, num_samples=4, min_budget=2,
                                  max_budget=4, brackets=2, **SMALL)
    assert np.isfinite(res.best_score) and len(res.configs) == 4
