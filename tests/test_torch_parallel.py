"""The port's mesh layer (parallel/mesh.py, sharding.py, dryrun.py) and the
drivers' ``mesh=``, mirroring tests/test_parallel.py, on the CPU with gloo.

Each rank of the port is a process, so the multi-rank cases run in 2 and 4
spawned gloo processes (``spawn_ranks``; tests/torch_parallel_cases.py
holds what each rank runs), once per module, and are held here against the
same calls without a mesh: bit for bit where every rank trains whole trials
or replicas (populations, fused ensembles, rung evaluators, fused
halving), to fp32 reassociation (losses rtol 1e-4, atol 1e-6, as
tests/test_parallel.py holds JAX's data parallelism; parameters atol 1e-5)
where a batch's rows are split over ``data``. One-rank meshes run in this
process. Against the JAX package: the data-parallel step against the JAX
trainer's step on a ``make_mesh({"data": 2})`` of the conftest's simulated
devices (test_torch_trainer.py's tolerances), and the mesh drivers of
sweep/search.py against the JAX drivers with a mesh on fake evaluators.
"""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import optax  # noqa: E402

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
from differential_equations_dnn_tpu.models import DGM as JaxDGM  # noqa: E402
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu.parallel import (  # noqa: E402
    make_mesh as jax_make_mesh,
)
from differential_equations_dnn_tpu.parallel.sharding import (  # noqa: E402
    constrain_batch,
)
from differential_equations_dnn_tpu.sweep import (  # noqa: E402
    ablations as jax_ablations,
)
from differential_equations_dnn_tpu.sweep import (  # noqa: E402
    search as jax_search,
)
from differential_equations_dnn_tpu.train import (  # noqa: E402
    TrainConfig as JaxTrainConfig,
)
from differential_equations_dnn_tpu.train import (  # noqa: E402
    trainer as jtrainer,
)
from differential_equations_dnn_tpu_torch import solve, sweep  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    PROBLEMS,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_dgm as fd,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_engine as fe,
)
from differential_equations_dnn_tpu_torch.parallel import (  # noqa: E402
    global_mesh,
    make_mesh,
    replicate,
    shard_batch,
    single_axis_mesh,
    spawn_ranks,
)
from differential_equations_dnn_tpu_torch.parallel import (  # noqa: E402
    dryrun,
)
from differential_equations_dnn_tpu_torch.parallel.mesh import (  # noqa: E402
    as_mesh,
    mesh_shape,
)
from differential_equations_dnn_tpu_torch.parallel.sharding import (  # noqa: E402
    gather_rows,
    mean_over,
)
from differential_equations_dnn_tpu_torch.sweep import (  # noqa: E402
    ablations,
    search,
)

import torch_parallel_cases as cases  # noqa: E402

LOSS_TOL = dict(rtol=1e-4, atol=1e-6)
PARAM_ATOL = 1e-5
JAX_STEPS, JAX_LR = 10, 1e-3


def _jax_case():
    """The JAX model and parameters, and the numpy uniforms of JAX_STEPS
    batches of 16 rows (test_torch_trainer.py's heat taylor case)."""
    jm = JaxMLP(input_dim=2, output_dim=1, hidden_size=16, num_layers=2,
                activation="tanh")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    u = np.random.default_rng(0).uniform(
        size=(JAX_STEPS, 16, 2)).astype(np.float32)
    return jm, jp, u


def _causal_jax_case(name):
    """(JAX model, JAX problem, parameters, JAX_STEPS batches of uniforms)
    of causal advection (eps = 5, a 2 → 16×2 → 1 MLP) or FitzHugh–Nagumo's
    default (DGM 1 → 2, H = 8, L = 1, causal eps = 5), 16 rows a batch."""
    if name == "advection":
        jm = JaxMLP(input_dim=2, output_dim=1, hidden_size=16, num_layers=2,
                    activation="tanh")
        jprob, n_uniform = JAX_PROBLEMS["advection"](causal_eps=5.0), 2
    else:
        jm = JaxDGM(input_dim=1, output_dim=2, hidden_size=8, num_layers=1,
                    activation="tanh")
        jprob, n_uniform = JAX_PROBLEMS["fitzhugh_nagumo"](), 1
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
    u = np.random.default_rng(2).uniform(
        size=(JAX_STEPS, 16, n_uniform)).astype(np.float32)
    return jm, jprob, jp, u


CAUSAL_JAX = ("advection", "fitzhugh_nagumo")


@pytest.fixture(scope="module")
def two():
    """Every 2-rank case, run once on one group of 2 gloo processes; rank
    0's results, after checking that both ranks returned the same."""
    _, jp, u = _jax_case()
    causal = {name: _causal_jax_case(name)[2:] for name in CAUSAL_JAX}
    ranks = spawn_ranks(cases.two_ranks, 2, jp, u, JAX_LR, causal,
                        timeout=240)
    _same_tree(ranks[0], ranks[1])
    return ranks[0]


@pytest.fixture(scope="module")
def four():
    ranks = spawn_ranks(cases.four_ranks, 4, timeout=240)
    for other in ranks[1:]:
        _same_tree(ranks[0], other)
    return ranks[0]


def _same_tree(a, b):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _same_tree(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _same_tree(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# Meshes and the sharding helpers in this process (one rank)
# ---------------------------------------------------------------------------


def test_make_mesh_shapes():
    """Named axes in dict order; ``single_axis_mesh`` and ``global_mesh``
    default to one ``data`` axis over the world (one rank here)."""
    mesh = make_mesh({"pop": 1, "data": 1}, "cpu")
    assert mesh_shape(mesh) == {"pop": 1, "data": 1}
    assert mesh_shape(single_axis_mesh("data", device="cpu")) == {"data": 1}
    assert mesh_shape(global_mesh(device="cpu")) == {"data": 1}
    assert mesh_shape(global_mesh({"pop": 1}, device="cpu")) == {"pop": 1}
    assert as_mesh(mesh, "cpu") is mesh
    assert mesh_shape(as_mesh({"pop": 1}, "cpu")) == {"pop": 1}


def test_oversized_and_malformed_meshes_are_refused():
    with pytest.raises(ValueError, match="mesh needs 2 devices, have 1"):
        make_mesh({"data": 2}, "cpu")
    with pytest.raises(ValueError, match="sizes >= 1"):
        make_mesh({"data": 0}, "cpu")
    with pytest.raises(TypeError, match="DeviceMesh"):
        as_mesh(object(), "cpu")


def test_shard_and_replicate_helpers():
    """At one rank: a shard is the whole batch, a replica and a gather are
    the tensor itself, a mean keeps its bits."""
    mesh = make_mesh({"data": 1}, "cpu")
    batch = {"x": torch.arange(8.0).reshape(4, 2), "y": np.arange(4)}
    sharded = shard_batch(batch, mesh)
    assert torch.equal(sharded["x"], batch["x"])
    np.testing.assert_array_equal(sharded["y"], batch["y"])
    rep = replicate({"w": torch.ones(3)}, mesh)
    assert torch.equal(rep["w"], torch.ones(3))
    t = [torch.tensor([0.1, 0.7]), torch.tensor(3.3)]
    want = [x.clone() for x in t]
    mean_over(t, mesh)
    assert all(torch.equal(a, b) for a, b in zip(t, want))
    got = gather_rows({"a": torch.ones(2, 3), "b": np.zeros((1, 2))}, mesh,
                      "data")
    assert got["a"].shape == (2, 3) and got["b"].shape == (1, 2)
    with pytest.raises(ValueError, match="'pop' mesh axis"):
        shard_batch(batch, mesh, "pop")


def test_one_rank_mesh_equals_no_mesh():
    """On one rank every driver's mesh path is its plain call bit for bit:
    the check the smoke makes on the card."""
    pop, data = make_mesh({"pop": 1}, "cpu"), make_mesh({"data": 1}, "cpu")
    _same_tree(cases.data_parallel_train("jvp", data),
               cases.data_parallel_train("jvp", None))
    _same_tree(cases.population(pop), cases.population(None))
    _same_tree(cases.mlp_ensemble(pop), cases.mlp_ensemble(None))
    _same_tree(cases.dgm_rung(pop), cases.dgm_rung(None))


# ---------------------------------------------------------------------------
# Two and four ranks against the calls without a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("taps", ["jvp", "taylor"])
def test_data_parallel_training_matches_single(two, taps):
    """Data parallelism over 2 ranks gives the single run's trajectory: the
    batch is the same, only its rows' placement changes."""
    losses, params = two[f"train_{taps}"]
    want_losses, want_params = cases.data_parallel_train(taps, None)
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    np.testing.assert_allclose(params, want_params, rtol=0, atol=PARAM_ATOL)


def test_data_parallel_at_four_ranks(four):
    losses, params = four["train_jvp"]
    want_losses, want_params = cases.data_parallel_train("jvp", None)
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    np.testing.assert_allclose(params, want_params, rtol=0, atol=PARAM_ATOL)


def test_population_sharded_over_pop(two):
    """4 trials over 2 ranks: every trial, its Adam count and its losses
    bit for bit those of the unsharded population (each rank draws and
    inits its trials by their global index)."""
    _same_tree(two["population"], cases.population(None))


def test_pallas_population_sharded_over_pop(two):
    """A ``taps="pallas"`` population (kernel #3's trial axis; its plain
    version on the CPU) over 2 ranks, bit for bit the unsharded one."""
    _same_tree(two["population_pallas"], cases.population(None, "pallas"))


@pytest.mark.parametrize("ranks", ["two", "four"])
@pytest.mark.parametrize("case", cases.COUPLED)
def test_coupled_rows_data_parallel_match_single(request, ranks, case):
    """A loss that couples the rows of a batch, data-parallel over 2 and 4
    ranks: BatchNorm moments over the global batch (inside the
    second-order taps and the running-statistics refresh) and causal
    weights over every rank's residuals (core/rows.py) give the single
    run's trajectory. Losses rtol 1e-4 / atol 1e-6, parameters and
    running statistics atol 1e-5, as the plain data-parallel runs are held
    (fp32 reassociation of the loss's and the gradient's means)."""
    losses, params, stats = request.getfixturevalue(ranks)[f"coupled_{case}"]
    want_losses, want_params, want_stats = cases.coupled_train(case, None)
    np.testing.assert_allclose(losses, want_losses, **LOSS_TOL)
    np.testing.assert_allclose(params, want_params, rtol=0, atol=PARAM_ATOL)
    np.testing.assert_allclose(stats, want_stats, rtol=0, atol=PARAM_ATOL)


@pytest.mark.parametrize("case", cases.COUPLED)
def test_one_rank_coupled_rows_equal_no_mesh(case):
    """At one rank a coupled-rows run puts no gather on its path: bit for
    bit the run without a mesh, as the smoke checks on the card."""
    _same_tree(cases.coupled_train(case, make_mesh({"data": 1}, "cpu")),
               cases.coupled_train(case, None))


def test_population_on_a_pop_data_mesh(four):
    """A 2 × 2 ("pop", "data") mesh: the ranks of a pop coordinate train
    the same trials, as JAX replicates data."""
    _same_tree(four["population_2x2"], cases.population(None))


@pytest.mark.parametrize("engine", ["mlp", "dgm"])
def test_fused_ensembles_sharded(two, engine):
    """Replicas over 2 ranks (each rank's as one packed run) bit for bit
    the sequential whole runs of ``mesh=None``, and replica r that of the
    packed ensemble."""
    run = cases.mlp_ensemble if engine == "mlp" else cases.dgm_ensemble
    losses, flats = two[f"{engine}_ensemble"]
    _same_tree((losses, flats), run(None))
    if engine == "mlp":
        packed = fe.train_fused_ensemble_packed(
            PROBLEMS["wave"](), 0, cases.ENS_STEPS, 4, batch_size=8,
            model=cases.small_mlp(), device="cpu")
    else:
        packed = fd.train_dgm_fused_ensemble_packed(
            PROBLEMS["fitzhugh_nagumo"](), 0, cases.ENS_STEPS, 4,
            batch_size=8, model=cases.small_dgm(), device="cpu")
    np.testing.assert_array_equal(losses, packed.loss_history)
    np.testing.assert_array_equal(
        flats, np.stack([cases.flat(m) for m in packed.params]))


@pytest.mark.parametrize("engine", ["mlp", "dgm"])
def test_sharded_rung_evaluators(two, engine):
    """A 4-slot rung over 2 ranks: finals and states bit for bit the packed
    rung evaluator's, each slot by its global trial index."""
    run = cases.mlp_rung if engine == "mlp" else cases.dgm_rung
    _same_tree(two[f"{engine}_rung"], run(None))


def test_fused_halving_over_a_mesh(two):
    """halving_search_fused with sharded rungs (padded to the axis) equals
    the packed rungs of ``mesh=None`` where the tiles match (here one tile
    holds every batch): scores, survivors, winner and its state."""
    _same_tree(two["fused_halving"], cases.fused_halving(None))


@pytest.mark.parametrize("route", ["fused_ensemble", "scan_ensemble",
                                   "scan"])
def test_solve_mesh_routes(two, route):
    """solve's mesh routes against the same solve without a mesh: the two
    ensemble routes bit for bit, data-parallel scan training to fp32
    reassociation."""
    mae, losses = two["solve"][route]
    want = cases.solve_routes(None, None)[route]
    if route == "scan":
        np.testing.assert_allclose(losses, want[1], **LOSS_TOL)
        assert abs(mae - want[0]) < 1e-5
    else:
        np.testing.assert_array_equal(losses, want[1])
        assert mae == want[0]


def test_single_fused_run_refuses_a_mesh():
    """The JAX package's ValueError (api.py:361-372), before any mesh."""
    with pytest.raises(ValueError, match="SINGLE fused run"):
        solve("heat", engine="fused", mesh=object(), device="cpu")


REFUSALS = {
    "oversized mesh": "mesh needs 3 devices, have 2",
    "undersized mesh": "mesh needs 1 devices, have 2",
    "population indivisible": "must divide evenly over the 'pop'",
    "population without pop": "needs a 'pop' mesh axis",
    "ensemble indivisible": "n_replicas 3 not divisible by 'pop'",
    "ensemble without pop": "needs a 'pop' mesh axis",
    "rung indivisible": "3 trials not divisible by the 'pop' axis",
    "batch indivisible": "does not divide evenly over the 'data'",
}


@pytest.mark.parametrize("case", sorted(REFUSALS))
def test_indivisible_sharding_refused(two, case):
    """What a 2-rank mesh cannot shard raises a ValueError that names it
    (the JAX package's messages where it has one)."""
    message = two["refusals"][case]
    assert message is not None and REFUSALS[case] in message, message


def test_dryrun_multichip():
    """The JAX package's dryrun_multichip steps over 4 spawned gloo ranks,
    and at one rank in this process."""
    for out in (dryrun.dryrun_multichip(4, "cpu"),
                dryrun.dryrun_multichip(1, "cpu")):
        assert set(out) == {"population", "data_jvp", "data_taylor",
                            "halving", "mlp_ensemble", "dgm_ensemble",
                            "mlp_halving", "dgm_halving"}
        assert all(np.all(np.isfinite(v)) for v in out.values())


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _jax_data_parallel_steps(jm, jprob, jp, u, prob):
    """The JAX trainer's step with its batch constrained over a 2-device
    ``data`` mesh (trainer.py:201) over the port problem's batches of the
    uniforms ``u``: (losses, final parameters)."""
    config = JaxTrainConfig(iterations=2 * JAX_STEPS, batch_size=16,
                            lrate=JAX_LR)
    opt = jtrainer._make_optimizer(config)
    jmesh = jax_make_mesh({"data": 2})

    @jax.jit
    def step(params, state, batch):
        batch = constrain_batch(batch, jmesh, "data")
        loss, g = jax.value_and_grad(
            lambda p: jprob.loss(jm.apply, p, batch))(params)
        upd, state = opt.update(g, state, params)
        return optax.apply_updates(params, upd), state, loss

    state, want = opt.init(jp), []
    for uk in u:
        batch = {k: v.numpy() for k, v in
                 prob.batch_from_uniforms(torch.from_numpy(uk)).items()}
        jp, state, loss = step(jp, state, batch)
        want.append(float(loss))
    return want, jp


def test_data_parallel_step_matches_jax(two):
    """The port's data-parallel step over 2 ranks against the JAX trainer's
    step with its batch constrained over a 2-device ``data`` mesh
    (trainer.py:201), on the same parameters and batches: losses rtol
    1e-4, parameters atol 1e-5 + 2·lr (test_steps_match_jax's)."""
    jm, jp, u = _jax_case()
    jprob = JAX_PROBLEMS["heat"](taps="taylor", taps_model=jm)
    want, jp = _jax_data_parallel_steps(jm, jprob, jp, u,
                                        PROBLEMS["heat"](taps="taylor"))
    losses, params = two["jax_steps"]
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    for name, value in params.items():
        leaf = jp
        for part in name.split("."):
            leaf = leaf[part]
        np.testing.assert_allclose(value, np.asarray(leaf), rtol=0,
                                   atol=1e-5 + 2 * JAX_LR, err_msg=name)


@pytest.mark.parametrize("name", CAUSAL_JAX)
def test_causal_data_parallel_step_matches_jax(two, name):
    """Causal advection (eps = 5) and FitzHugh–Nagumo's default DGM: the
    port's data-parallel step over 2 ranks, its causal weights over every
    rank's rows with Δt = t_max / B_global, against the JAX step on its
    batch constrained over a 2-device ``data`` mesh, where XLA weighs the
    global batch: losses rtol 1e-4, parameters atol 1e-5 + 2·lr, as
    test_data_parallel_step_matches_jax."""
    jm, jprob, jp, u = _causal_jax_case(name)
    prob = (PROBLEMS["advection"](causal_eps=5.0) if name == "advection"
            else PROBLEMS["fitzhugh_nagumo"]())
    want, jp = _jax_data_parallel_steps(jm, jprob, jp, u, prob)
    losses, tree = two[f"causal_jax_{name}"]
    np.testing.assert_allclose(losses, want, rtol=1e-4)
    assert jax.tree.structure(tree) == jax.tree.structure(jp)
    for got, ref in zip(jax.tree.leaves(tree), jax.tree.leaves(jp)):
        np.testing.assert_allclose(got, np.asarray(ref), rtol=0,
                                   atol=1e-5 + 2 * JAX_LR)


def _recording_fake_population(calls):
    def fake(problem, model, key, lrates, batch_sizes=None, config=None,
             params=None, opt_state=None, mesh=None, **_):
        calls.append((len(np.asarray(lrates)), mesh is not None))
        lr = np.asarray(lrates, np.float64)
        bs = (np.full(lr.shape, config.max_batch_size) if batch_sizes is None
              else np.asarray(batch_sizes, np.float64))
        w = (np.zeros(lr.shape) if params is None
             else np.asarray(params["w"], np.float64))
        steps = np.arange(1, config.iterations + 1)[:, None]
        quality = np.abs(np.log10(lr) + 2.5) + np.abs(bs - 100.0) / 500.0
        losses = quality[None, :] + 1.0 / (1.0 + w[None, :] + steps)
        count = (np.zeros(lr.shape) if opt_state is None
                 else np.asarray(opt_state["count"]))
        return ({"w": w + config.iterations},
                {"count": count + config.iterations},
                losses.astype(np.float32))
    return fake


@pytest.mark.parametrize("driver, kw", [
    ("random_search", dict(num_samples=6, max_iters=40)),
    ("successive_halving", dict(num_samples=8, eta=2, min_budget=7,
                                max_budget=50, max_batch_size=128)),
    ("tpe_search", dict(num_samples=8, rounds=2, max_iters=30)),
    ("tpe_halving", dict(num_samples=8, brackets=2, eta=2, min_budget=5,
                         max_budget=20)),
], ids=["random", "halving", "tpe", "tpe_halving"])
def test_population_drivers_with_a_mesh_match_jax(monkeypatch, driver, kw):
    """Both packages' population drivers with a mesh, on one fake
    train_population: every population gets the mesh, and the configs,
    scores, survivors and winner agree."""
    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(jax_search, "train_population",
                        _recording_fake_population(calls["jax"]))
    monkeypatch.setattr(search, "train_population",
                        _recording_fake_population(calls["torch"]))
    ref = getattr(jax_search, driver)(
        JAX_PROBLEMS["heat"](), jax.random.key(0), seed=3,
        mesh=jax_make_mesh({"pop": 2}), **kw)
    port = getattr(search, driver)(PROBLEMS["heat"](), 0, sampler_seed=3,
                                   mesh=object(), device="cpu", **kw)
    assert calls["torch"] == calls["jax"]
    assert all(with_mesh for _, with_mesh in calls["torch"])
    assert port.configs == ref.configs
    np.testing.assert_array_equal(port.scores, np.asarray(ref.scores))
    assert port.best_index == ref.best_index


@pytest.mark.parametrize("which", ["batch_size", "batchnorm"])
def test_ablations_forward_the_mesh(monkeypatch, which):
    """Both ablations hand their mesh to every population, as the JAX
    package's do, with the same curves on one fake train_population."""
    calls = {"jax": [], "torch": []}
    monkeypatch.setattr(jax_ablations, "train_population",
                        _recording_fake_population(calls["jax"]))
    monkeypatch.setattr(ablations, "train_population",
                        _recording_fake_population(calls["torch"]))
    kw = (dict(batch_sizes=[1, 4, 16], runs=2, iterations=5)
          if which == "batch_size" else dict(runs=2, iterations=5))
    fn = f"{which}_effect"
    ref = getattr(jax_ablations, fn)(mesh=jax_make_mesh({"pop": 2}), **kw)
    got = getattr(ablations, fn)(mesh=object(), device="cpu", **kw)
    assert calls["torch"] == calls["jax"]
    assert calls["torch"] and all(m for _, m in calls["torch"])
    np.testing.assert_array_equal(got.all_losses, ref.all_losses)


def _score(t, lr, bs, n):
    return (float((np.log10(lr) + 2.0) ** 2 + 1e-3 * abs(bs - 100)
                  + 50.0 / max(n, 1) + 1e-4 * t))


class _ShardedFake:
    """Both packages' sharded rung evaluators, faked with one numpy score;
    records each evaluator made and each call's (padded) trial list. A
    flat state is the trial index."""

    def __init__(self, monkeypatch, jax_side):
        self.made, self.calls, self.jax = [], [], jax_side
        for mod in ((jfe, jfd) if jax_side else (fe, fd)):
            monkeypatch.setattr(mod, "make_sharded_rung_evaluator",
                                self.sharded)
        if jax_side:
            monkeypatch.setattr(jfe, "unpack_params", lambda m, fl: fl)
            monkeypatch.setattr(jfd, "unpack_dgm", lambda fl: fl)

    def sharded(self, problem, key, max_iters, mesh, batch_size=100,
                max_batch=None, **kw):
        self.made.append(("sharded", max_iters, max_batch,
                          kw.get("horizon")))
        width = max_batch or batch_size

        def ev(idx, lrs, *rest):
            bss, ns = rest if len(rest) == 2 else ([width] * len(idx),
                                                   rest[0])
            self.calls.append([int(t) for t in idx])
            finals = np.asarray([
                _score(t, lr, max(1, min(int(bs), width)),
                       max(1, min(int(n), max_iters)))
                for t, lr, bs, n in zip(idx, lrs, bss, ns)])
            flat = np.asarray(idx, np.float32)[:, None]
            return finals, ((flat,) if self.jax else torch.from_numpy(flat))
        return ev


FUSED_CASES = {
    "halving mlp": ("halving", "heat", {}, dict(num_samples=9,
                                                max_budget=4500), None),
    "halving dgm": ("halving", "fitzhugh_nagumo", dict(causal_eps=0.0),
                    dict(num_samples=9, max_budget=4500), None),
    "halving fredholm bs": ("halving", "fredholm", dict(k=16),
                            dict(num_samples=6, max_budget=1500), "lr_bs"),
    "tpe-halving mlp": ("tpe-halving", "heat", {},
                        dict(num_samples=12, max_budget=4500, brackets=2),
                        None),
}


@pytest.mark.parametrize("case", sorted(FUSED_CASES))
def test_fused_drivers_with_a_mesh_match_jax(monkeypatch, case):
    """halving_search_fused and tpe_halving_fused with a 2-rank 'pop' mesh
    against the JAX drivers, on one fake sharded evaluator: the same
    evaluators (budget, tile, horizon), the same padded rungs, configs,
    scores, survivors and winner."""
    driver, name, extra, kw, space_kind = FUSED_CASES[case]
    results, fakes = [], []
    for side in ("jax", "torch"):
        jax_side = side == "jax"
        pkg = jsweep if jax_side else sweep
        space = (None if space_kind is None else pkg.SearchSpace(
            {"lrate": pkg.loguniform(1e-4, 1e-1),
             "batch_size": pkg.randint(1, 512)}))
        fn = {"halving": pkg.halving_search_fused,
              "tpe-halving": pkg.tpe_halving_fused}[driver]
        with monkeypatch.context() as mp:
            fakes.append(_ShardedFake(mp, jax_side))
            if jax_side:
                prob = JAX_PROBLEMS[name](**extra)
                results.append(fn(prob, jax.random.key(0), seed=5,
                                  space=space, mesh=jax_make_mesh({"pop": 2}),
                                  **kw))
            else:
                mesh = types.SimpleNamespace(mesh_dim_names=("pop",),
                                             shape=(2,))
                results.append(fn(PROBLEMS[name](**extra), seed=0,
                                  sampler_seed=5, space=space, mesh=mesh,
                                  device="cpu", **kw))
    theirs, ours = results
    assert fakes[1].made == fakes[0].made
    assert fakes[1].calls == fakes[0].calls
    assert all(len(c) % 2 == 0 for c in fakes[1].calls)
    assert ours.configs == theirs.configs
    np.testing.assert_array_equal(ours.scores, theirs.scores)
    np.testing.assert_array_equal(ours.param_indices, theirs.param_indices)
    assert ours.best_index == theirs.best_index
