"""The port's population tier against the JAX package: the population step
math, the population sweeps' drivers and the ablations, and the
population's own contract.

Step math: P = 3 trials stacked from JAX inits, each with its own lr and a
row mask, take K = 10 steps on the same pre-built batches through the
port's ``make_population_step`` and through ``jax.vmap`` of JAX's
``value_and_grad(problem.loss(..., mask))`` followed by
``optax.scale_by_adam(0.9, 0.999, 1e-8)`` times the trial's lr (JAX
parallel/population.py:49-52, 123-147). Losses rtol 1e-4, parameters
atol 1e-5 + 2·lr, as tests/test_torch_trainer.py holds K steps. A
BatchNorm trial is held to the intended taps (``jax.vjp`` with a ones
cotangent, test_torch_stateful.py; ROADMAP queue 3).

Drivers: the same numpy fake ``train_population`` is monkeypatched into
both packages' sweep modules, so configs, scores, ``param_indices`` and
the realised ``n_iters`` must be equal exactly.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from differential_equations_dnn_tpu.equations import (  # noqa: E402
    PROBLEMS as JAX_PROBLEMS,
)
from differential_equations_dnn_tpu.models import DGM as JaxDGM  # noqa: E402
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu.models import (  # noqa: E402
    train_apply as jax_train_apply,
)
from differential_equations_dnn_tpu.models import (  # noqa: E402
    update_state as jax_update_state,
)
from differential_equations_dnn_tpu.sweep import (  # noqa: E402
    ablations as jax_ablations,
)
from differential_equations_dnn_tpu.sweep import (  # noqa: E402
    search as jax_search,
)
from differential_equations_dnn_tpu_torch import api, solve  # noqa: E402
from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.core.prng import (  # noqa: E402
    replica_generator,
    step_generator,
    trial_seed,
)
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    PROBLEMS,
    Heat1D,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    MLP,
    ResNet,
    dgm_params_from_jax,
    dgm_params_to_jax,
    params_from_jax,
    params_to_jax,
    state_to_jax,
)
from differential_equations_dnn_tpu_torch.parallel import (  # noqa: E402
    PopulationConfig,
    make_mesh,
    take_trials,
    train_population,
    trial_model,
)
from differential_equations_dnn_tpu_torch.parallel import (  # noqa: E402
    population as pop,
)
from differential_equations_dnn_tpu_torch.sweep import (  # noqa: E402
    ablations,
    batch_size_effect,
    batchnorm_effect,
    search,
)
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    TrainConfig,
    train,
)
from differential_equations_dnn_tpu.equations import (  # noqa: E402
    heat as jax_heat,
)

P, B, K = 3, 16, 10
LRS = np.array([1e-3, 3e-3, 5e-4], np.float32)
BSS = np.array([B, 9, 3])


def _t(a):
    return torch.tensor(np.asarray(a))


def _intended_heat_taps(monkeypatch):
    """JAX heat's u_t and u_xx by ``jax.vjp`` with a ones cotangent (Jᵀ·1,
    the reference's taps; heat's net has one output column), in place of
    its jvp taps: test-local, the JAX package is not changed."""
    def first(f, x, a):
        y, pull = jax.vjp(f, x)
        return y, pull(jnp.ones_like(y))[0][:, a:a + 1]

    def value_dt(f, x, t_axis=0):
        return first(f, x, t_axis)

    def value_dx_dxx(f, x, x_axis=0):
        y, d = first(f, x, x_axis)
        _, dd = first(lambda z: first(f, z, x_axis)[1], x, x_axis)
        return y, d, dd

    monkeypatch.setattr(jax_heat, "value_dt", value_dt)
    monkeypatch.setattr(jax_heat, "value_dx_dxx", value_dx_dxx)


# ---------------------------------------------------------------------------
# The population step math against JAX
# ---------------------------------------------------------------------------


def _case(name):
    """(JAX problem, JAX model, port problem, port model of a JAX tree,
    tree of a port model)."""
    if name == "fredholm":
        jm = JaxDGM(input_dim=1, output_dim=1, hidden_size=8, num_layers=1,
                    activation="relu", init_scheme="xavier_relu")
        return (JAX_PROBLEMS[name](k=12), jm, PROBLEMS[name](k=12),
                lambda tr: dgm_params_from_jax(tr, "relu", "xavier_relu"),
                dgm_params_to_jax)
    if name == "fitzhugh_nagumo":
        jm = JaxMLP(1, 2, 16, 2, "tanh", fourier_features=4,
                    fourier_scale=0.1)
        return (JAX_PROBLEMS[name](arch="fourier_mlp"), jm,
                PROBLEMS[name](arch="fourier_mlp"),
                lambda tr: params_from_jax(tr, "tanh"), params_to_jax)
    bn = {"heat_pre": "pre", "heat_post": "post"}.get(name)
    D = 1 if name == "simple_ode" else 2
    jm = JaxMLP(D, 1, 16, 2, "tanh", batch_norm=bn)
    if name == "heat_pallas":
        return (JAX_PROBLEMS["heat"](taps="pallas", taps_model=jm), jm,
                PROBLEMS["heat"](taps="pallas"),
                lambda tr: params_from_jax(tr, "tanh"), params_to_jax)
    key = "heat" if bn else name
    return (JAX_PROBLEMS[key](), jm, PROBLEMS[key](),
            lambda tr: params_from_jax(tr, "tanh", batch_norm=bn),
            params_to_jax)


@pytest.mark.parametrize("name", ["simple_ode", "heat", "fitzhugh_nagumo",
                                  "fredholm", "heat_pre", "heat_post",
                                  "heat_pallas"])
def test_population_steps_match_jax(name, monkeypatch):
    """K steps of P trials, each with its own init, lr and mask (bs 16, 9
    and 3 of 16 drawn rows). ``heat_pallas`` takes its streams from kernel
    #3's wrapper under the population's vmap (its vmap rule; the plain
    version here) against ``jax.vmap`` of the JAX kernel (interpret mode).
    FitzHugh–Nagumo's Fourier MLP trains the
    plain masked loss (causal weighting is off under a mask, as in JAX);
    a BatchNorm trial's statistics span all 16 rows and are refreshed after
    each step with the updated parameters. A BatchNorm trial's step starts
    from JAX's state every step, and its losses are held to rtol 1e-3: its
    loss and gradient are ill-conditioned (u_xx through the batch
    statistics; at heat_pre's step 0 both packages' fp32 gradients are
    1e-4 of their max from a float64 one, the port's no further than
    JAX's, and a trial masked to 3 rows averages little of that away), and
    ten free steps carry it into the losses' third digit on both sides
    alike."""
    stateful = name in ("heat_pre", "heat_post")
    if stateful:
        _intended_heat_taps(monkeypatch)
    jprob, jm, prob, from_jax, to_jax = _case(name)
    trees = [jax.tree.map(np.asarray, jm.init(jax.random.key(t)))
             for t in range(P)]
    u = np.random.default_rng(1).uniform(
        size=(K, P, B, prob.n_uniform)).astype(np.float32)
    batches = [{k: torch.stack([prob.batch_from_uniforms(_t(u[j, t]))[k]
                                for t in range(P)])
                for k in prob.batch_from_uniforms(_t(u[j, 0]))}
               for j in range(K)]
    mask = torch.arange(B)[None, :] < _t(BSS)[:, None]

    # The JAX reference.
    adam = optax.scale_by_adam(b1=0.9, b2=0.999, eps=1e-8)
    jp = jax.tree.map(lambda *a: jnp.stack(a), *trees)
    ost = jax.vmap(adam.init)(jp)
    st = (jax.vmap(lambda _: jm.init_state())(jnp.arange(P)) if stateful
          else None)

    def trial(p, s, o, lr, batch, m):
        apply_fn = jax_train_apply(jm, s) if stateful else jm.apply
        loss, g = jax.value_and_grad(
            lambda q: jprob.loss(apply_fn, q, batch, mask=m))(p)
        upd, o = adam.update(g, o)
        p = jax.tree.map(lambda a, b: a - lr * b, p, upd)
        if stateful:
            s = jax_update_state(jm, p, s, jprob.domain_inputs(batch))
        return p, s, o, loss

    jstep = jax.jit(jax.vmap(trial))

    # The port, step by step beside JAX.
    models = [from_jax(tr) for tr in trees]
    split = [pop._split(m) for m in models]
    params = {k: torch.stack([p[k] for p, _ in split]) for k in split[0][0]}
    state = ({k: torch.stack([s[k] for _, s in split]) for k in split[0][1]}
             if stateful else None)
    opt = pop._adam_init(params, P, None)
    step = pop.make_population_step(prob, models[0], params, state, opt,
                                    _t(LRS), mask)
    want, got = [], []
    for b in batches:
        if stateful:
            _load(params, opt, state, jp, ost, st)
        got.append(step(b).numpy())
        jp, st, ost, loss = jstep(jp, st, ost, jnp.asarray(LRS),
                                  {k: v.numpy() for k, v in b.items()},
                                  mask.numpy())
        want.append(np.asarray(loss))
    np.testing.assert_allclose(np.array(got), np.array(want),
                               rtol=1e-3 if stateful else 1e-4)
    for t in range(P):
        m = trial_model(models[0], params, t, state)
        tree = to_jax(m)
        for path, leaf in jax.tree_util.tree_leaves_with_path(tree):
            ref = jp
            for k in path:
                ref = ref[k.key]
            np.testing.assert_allclose(
                leaf, np.asarray(ref[t]), rtol=0, atol=1e-5 + 2 * LRS[t],
                err_msg=f"trial {t} {jax.tree_util.keystr(path)}")
        if stateful:
            got_state = state_to_jax(m)
            for k in ("mean", "var"):
                np.testing.assert_allclose(got_state[k], np.asarray(st[k][t]),
                                           rtol=1e-4, atol=1e-5)


def _load(params, opt, state, jp, ost, st):
    """The port's stacked tensors set to JAX's (MLP layout)."""
    def leaf(tree, name):
        a, b = name.split(".")
        return _t(tree[a][b])

    with torch.no_grad():
        for k in params:
            params[k].copy_(leaf(jp, k))
            opt["mu"][k].copy_(leaf(ost.mu, k))
            opt["nu"][k].copy_(leaf(ost.nu, k))
        opt["count"].copy_(_t(ost.count).float())
        for k in state:
            state[k].copy_(_t(st[k.split(".")[1]]))


# ---------------------------------------------------------------------------
# The population's contract
# ---------------------------------------------------------------------------


def _cfg(iterations=12, max_bs=B, chunk=1000):
    return PopulationConfig(iterations=iterations, max_batch_size=max_bs,
                            chunk_size=chunk)


def _small():
    return MLP(2, 1, 8, 1, "tanh", generator=generator(0))


def test_trial_is_its_standalone_run():
    """A trial at the full batch equals a standalone ``train`` from its
    init (``replica_generator(seed, t)``) on its stream (seeded
    ``trial_seed(seed, t)``) at its lr: losses rtol 1e-4 and parameters
    atol 1e-5 + 2·lr over 12 steps (fp32 reassociation between the vmapped
    step and torch's Adam)."""
    prob, seed, t = Heat1D(), 5, 1
    params, _, losses = train_population(
        prob, _small(), seed, LRS, [B, B, 4], _cfg(), device="cpu")
    model = _small().fresh(generator=replica_generator(seed, t))
    res = train(prob, trial_seed(seed, t),
                TrainConfig(iterations=12, batch_size=B, lrate=float(LRS[t]),
                            verbose=False), model=model, device="cpu")
    np.testing.assert_allclose(losses[:, t], res.loss_history, rtol=1e-4)
    for k, v in model.named_parameters():
        np.testing.assert_allclose(params[k][t].numpy(),
                                   v.detach().numpy(), rtol=0,
                                   atol=1e-5 + 2 * LRS[t])


def test_trials_do_not_depend_on_the_population():
    """Trial t's init and batches depend on (seed, t) alone: the first
    three trials of a population of 5 are those of a population of 3."""
    prob = Heat1D()
    seeds = [trial_seed(9, t) for t in range(5)]
    a = pop.draw_trial_batches(prob, seeds[:3], 4, 3, B,
                               torch.device("cpu"))
    b = pop.draw_trial_batches(prob, seeds, 4, 3, B, torch.device("cpu"))
    for k in a:
        assert torch.equal(a[k], b[k][:, :3])
    lrs = np.array([1e-3, 3e-3, 5e-4, 1e-2, 2e-3], np.float32)
    p3, _, l3 = train_population(prob, _small(), 9, lrs[:3], config=_cfg(6),
                                 device="cpu")
    p5, _, l5 = train_population(prob, _small(), 9, lrs, config=_cfg(6),
                                 device="cpu")
    np.testing.assert_allclose(l5[:, :3], l3, rtol=1e-5)
    for k in p3:
        np.testing.assert_allclose(p5[k][:3].numpy(), p3[k].numpy(),
                                   rtol=1e-5, atol=1e-6)


def test_chunked_equals_uncut():
    prob = Heat1D()
    a = train_population(prob, _small(), 2, LRS, BSS, _cfg(chunk=5),
                         device="cpu")
    b = train_population(prob, _small(), 2, LRS, BSS, _cfg(), device="cpu")
    np.testing.assert_array_equal(a[2], b[2])
    for k in a[0]:
        assert torch.equal(a[0][k], b[0][k])


def test_resume_carries_the_optimizer_state():
    """Survivors re-enter with their parameters and Adam state
    (``take_trials``): the count goes on, and each resumed trial equals
    its chained standalone ``train()`` runs (its init and first stream at
    its batch, then the second population's stream with the Adam state
    carried), losses rtol 1e-4 and parameters atol 1e-5 + 2·lr, as
    :func:`test_trial_is_its_standalone_run`."""
    prob = Heat1D()
    params, opt, _ = train_population(prob, _small(), 3, LRS, BSS,
                                      _cfg(4), device="cpu")
    keep = np.array([2, 0])
    p2, o2, losses = train_population(
        prob, _small(), 4, LRS[keep], BSS[keep], _cfg(3),
        params=take_trials(params, keep), opt_state=take_trials(opt, keep),
        device="cpu")
    assert losses.shape == (3, 2)
    np.testing.assert_array_equal(o2["count"].numpy(), [7.0, 7.0])
    for j, t in enumerate(keep):
        model = _small().fresh(generator=replica_generator(3, t))
        opt_state, curve = None, []
        for seed, (steps, i) in ((3, (4, t)), (4, (3, j))):
            res = train(prob, trial_seed(seed, i),
                        TrainConfig(iterations=steps, batch_size=int(BSS[t]),
                                    lrate=float(LRS[t]), verbose=False),
                        model=model, opt_state=opt_state, device="cpu")
            opt_state = res.opt_state
            curve.append(res.loss_history)
        np.testing.assert_allclose(losses[:, j], curve[1], rtol=1e-4)
        for k, v in model.named_parameters():
            np.testing.assert_allclose(p2[k][j].numpy(), v.detach().numpy(),
                                       rtol=0, atol=1e-5 + 2 * LRS[t])


def test_trial_goes_on_as_a_standalone_run():
    """``trial_model`` and ``trial_opt_state`` hand a trial to ``train()``:
    resumed survivors and the same trials run on standalone from the
    population's state agree, losses rtol 1e-4 and parameters atol 1e-5 +
    2·lr, as :func:`test_trial_is_its_standalone_run`."""
    prob = Heat1D()
    params, opt, _ = train_population(prob, _small(), 3, LRS, BSS,
                                      _cfg(4), device="cpu")
    keep = np.array([1, 2])
    p2, _, losses = train_population(
        prob, _small(), 4, LRS[keep], BSS[keep], _cfg(5),
        params=take_trials(params, keep), opt_state=take_trials(opt, keep),
        device="cpu")
    for j, t in enumerate(keep):
        net = pop.trial_model(_small(), params, t)
        res = train(prob, trial_seed(4, j),
                    TrainConfig(iterations=5, batch_size=int(BSS[t]),
                                lrate=float(LRS[t]), verbose=False),
                    model=net, opt_state=pop.trial_opt_state(net, opt, t),
                    device="cpu")
        np.testing.assert_allclose(losses[:, j], res.loss_history, rtol=1e-4)
        for k, v in net.named_parameters():
            np.testing.assert_allclose(p2[k][j].numpy(), v.detach().numpy(),
                                       rtol=0, atol=1e-5 + 2 * LRS[t])


@pytest.mark.parametrize("name", sorted(PROBLEMS))
def test_trial_draws_are_the_samplers(name):
    """Every trial's block of draws equals the problem's own ``sample``
    calls on its step generators, bit for bit: the uniforms-only path (a
    problem that keeps ``Problem.sample``) and the per-call path alike."""
    prob = PROBLEMS[name]()
    seeds = [trial_seed(4, t) for t in range(3)]
    block = pop.draw_trial_batches(prob, seeds, 7, 2, B, torch.device("cpu"))
    for j in range(2):
        for t, s in enumerate(seeds):
            want = prob.sample(B, step_generator(s, 7 + j))
            for k, v in want.items():
                assert torch.equal(block[k][j, t], v), (k, j, t)


def test_take_trials():
    tree = {"a": torch.arange(12.0).reshape(4, 3),
            "b": [np.arange(4), {"c": torch.ones(4, 2)}], "d": None}
    out = take_trials(tree, np.array([3, 1]))
    assert torch.equal(out["a"], torch.tensor([[9.0, 10, 11], [3, 4, 5]]))
    np.testing.assert_array_equal(out["b"][0], [3, 1])
    assert out["b"][1]["c"].shape == (2, 2) and out["d"] is None


def test_stateful_and_fourier_populations():
    """BatchNorm trials thread their own statistics (returned in
    ``timings["state"]``); a Fourier matrix rides the params untouched
    (its gradient is 0); a ResNet trains too."""
    prob = Heat1D()
    timings = {}
    m = MLP(2, 1, 8, 1, "relu", "pre", generator=generator(0))
    params, _, losses = train_population(prob, m, 1, LRS, BSS, _cfg(5),
                                         timings=timings, device="cpu")
    st = timings["state"]
    assert set(st) == {"bn.mean", "bn.var"} and st["bn.mean"].shape[0] == P
    assert not torch.equal(st["bn.mean"][0], st["bn.mean"][1])
    assert float(st["bn.mean"].abs().max()) > 0
    f = MLP(2, 1, 8, 1, "tanh", None, 3, generator=generator(0))
    p0, _ = pop.init_trials(f, 1, P)
    params, _, _ = train_population(prob, f, 1, LRS, config=_cfg(4),
                                    device="cpu")
    assert torch.equal(params["fourier.b"], p0["fourier.b"])
    assert not torch.equal(params["fc_in.w"], p0["fc_in.w"])
    r = ResNet(hidden_size=4, n_blocks=1, generator=generator(0))
    _, _, losses = train_population(prob, r, 1, LRS, config=_cfg(3),
                                    timings=timings, device="cpu")
    assert np.all(np.isfinite(losses)) and len(timings["state"]) == 8


def test_pallas_taps_population_trains(tmp_path):
    """Kernel #3 with a trial axis: a ``taps="pallas"`` population trains
    through each user path, its streams taken through the wrapper's vmap
    rule. On the CPU that rule
    runs the plain version, which is the Taylor taps' stream math, so the
    population equals the ``taps="taylor"`` one bit for bit; then
    ``solve(engine="scan", ensemble=2, taps="pallas")`` and the CLI's
    ``heat --solve --taps pallas --ensemble 2`` run to a finite MAE."""
    from differential_equations_dnn_tpu_torch import cli

    runs = [train_population(Heat1D(taps=taps), _small(), 4, LRS, BSS,
                             _cfg(5), device="cpu")
            for taps in ("pallas", "taylor")]
    np.testing.assert_array_equal(runs[0][2], runs[1][2])
    for k in runs[0][0]:
        assert torch.equal(runs[0][0][k], runs[1][0][k]), k
    res = solve("heat", engine="scan", ensemble=2, taps="pallas",
                model=_small(), iterations=4, batch_size=B, nodes=5,
                finetune=0, device="cpu")
    assert res.loss_history.shape == (4,) and np.isfinite(res.mae)
    rd = tmp_path / "temp_results"
    cli.main(["heat", "--solve", "--taps", "pallas", "--ensemble", "2",
              "--niters", "4", "--batch-size", "8", "--nnodes", "5",
              "--results-dir", str(rd), "--platform", "cpu"])
    assert np.all(np.isfinite(np.load(rd / "heat_sol_1d_dgm.npy")))


def test_population_refuses_what_it_cannot_run():
    # Since item 14 a population takes a mesh; one without a 'pop' axis
    # is refused (an indivisible one: tests/test_torch_parallel.py).
    with pytest.raises(ValueError, match="'pop' mesh axis"):
        train_population(Heat1D(), _small(), 0, LRS,
                         mesh=make_mesh({"data": 1}, "cpu"), device="cpu")
    with pytest.raises(ValueError, match="batch_sizes"):
        train_population(Heat1D(), _small(), 0, LRS, [1, 2, 99],
                         config=_cfg(2), device="cpu")


def test_population_needs_a_gpu_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_population(Heat1D(), _small(), 0, LRS, config=_cfg(2))


# ---------------------------------------------------------------------------
# solve(engine="scan", ensemble=N)
# ---------------------------------------------------------------------------


def test_scan_ensemble_keeps_the_lowest_residual(monkeypatch):
    seen = []
    real = api._residual

    def spy(problem, model, batch):
        r = real(problem, model, batch)
        seen.append(r)
        return r

    monkeypatch.setattr(api, "_residual", spy)
    res = solve("heat", engine="scan", ensemble=3, iterations=6,
                batch_size=8, nodes=5, device="cpu", seed=2)
    assert res.loss_history.shape == (6,) and len(seen) == 3
    assert res.iters_per_sec > 0
    val = res.problem.validation_sample(4096, generator(3))
    assert api._residual(res.problem, res.params, val) == min(seen)


def test_stateful_scan_ensemble_is_polished_as_one_run(monkeypatch):
    """A BatchNorm population skips the ensemble's polish-and-select (JAX
    api.py:340); its pick is polished as a single run, and its running
    statistics refreshed."""
    monkeypatch.setattr(api, "_polish_and_select", lambda *a: 1 / 0)
    model = MLP(2, 1, 8, 1, "relu", "pre", generator=generator(0))
    res = solve("heat", engine="scan", ensemble=2, finetune=2, iterations=4,
                batch_size=8, nodes=5, device="cpu", model=model)
    assert res.loss_history.shape == (6,)
    assert np.all(np.isfinite(res.solution))
    assert res.params.training


# ---------------------------------------------------------------------------
# The drivers against JAX, with one fake train_population on both sides
# ---------------------------------------------------------------------------


def _fake_train_population(problem, model, key, lrates, batch_sizes=None,
                           config=None, params=None, opt_state=None,
                           **_):
    """A deterministic stand-in: a trial's loss falls with its steps and
    depends on its lr, batch size and carried parameters only."""
    lr = np.asarray(lrates, np.float64)
    bs = (np.full(lr.shape, config.max_batch_size) if batch_sizes is None
          else np.asarray(batch_sizes, np.float64))
    w = (np.zeros(lr.shape) if params is None
         else np.asarray(params["w"], np.float64))
    steps = np.arange(1, config.iterations + 1)[:, None]
    quality = np.abs(np.log10(lr) + 2.5) + np.abs(bs - 100.0) / 500.0
    losses = quality[None, :] + 1.0 / (1.0 + w[None, :] + steps)
    params = {"w": w + config.iterations}
    opt_state = {"count": (np.zeros(lr.shape) if opt_state is None else
                           np.asarray(opt_state["count"]))
                 + config.iterations}
    return params, opt_state, losses.astype(np.float32)


@pytest.fixture
def fake(monkeypatch):
    monkeypatch.setattr(search, "train_population", _fake_train_population)
    monkeypatch.setattr(jax_search, "train_population",
                        _fake_train_population)
    monkeypatch.setattr(ablations, "train_population",
                        _fake_train_population)
    monkeypatch.setattr(jax_ablations, "train_population",
                        _fake_train_population)


def _same(port, ref):
    assert port.configs == ref.configs
    np.testing.assert_array_equal(port.scores, np.asarray(ref.scores))
    if ref.param_indices is None:
        assert port.param_indices is None
    else:
        np.testing.assert_array_equal(port.param_indices, ref.param_indices)
    assert port.best_index == ref.best_index


@pytest.mark.parametrize("driver, kw", [
    ("random_search", dict(num_samples=6, max_iters=40)),
    ("successive_halving", dict(num_samples=9, eta=3, min_budget=10,
                                max_budget=90)),
    ("successive_halving", dict(num_samples=8, eta=2, min_budget=7,
                                max_budget=50, max_batch_size=128)),
    ("tpe_search", dict(num_samples=9, rounds=3, max_iters=30)),
    ("tpe_halving", dict(num_samples=12, brackets=2, eta=3, min_budget=5,
                         max_budget=45)),
], ids=["random", "halving", "halving_eta2", "tpe", "tpe_halving"])
@pytest.mark.parametrize("sampler_seed", [0, 3])
def test_drivers_match_jax(fake, driver, kw, sampler_seed):
    prob, jprob = Heat1D(), JAX_PROBLEMS["heat"]()
    ref = getattr(jax_search, driver)(jprob, jax.random.key(0),
                                      seed=sampler_seed, **kw)
    port = getattr(search, driver)(prob, 0, sampler_seed=sampler_seed,
                                   device="cpu", **kw)
    _same(port, ref)
    np.testing.assert_array_equal(
        np.asarray(port.best_params()["w"]),
        np.asarray(ref.best_params()["w"]))


def test_halving_needs_eta_2():
    with pytest.raises(ValueError, match="eta >= 2"):
        search.successive_halving(Heat1D(), 0, eta=1, device="cpu")


def test_population_drivers_refuse_a_mesh():
    """Since item 14 the drivers take a mesh (tests/test_torch_parallel.py);
    they refuse one without a 'pop' axis, as train_population does."""
    mesh = make_mesh({"data": 1}, "cpu")
    for driver in (search.random_search, search.successive_halving,
                   search.tpe_search, search.tpe_halving):
        with pytest.raises(ValueError, match="'pop' mesh axis"):
            driver(Heat1D(), 0, num_samples=2, max_batch_size=4, mesh=mesh,
                   model=_small(), device="cpu")


@pytest.mark.parametrize("which", ["batch_size", "batchnorm"])
def test_ablations_match_jax(fake, which):
    """Labels, shapes and curves against the JAX ablations, on the fake."""
    if which == "batch_size":
        ref = jax_ablations.batch_size_effect(batch_sizes=[1, 4, 16], runs=2,
                                              iterations=5)
        got = ablations.batch_size_effect(batch_sizes=[1, 4, 16], runs=2,
                                          iterations=5, device="cpu")
        assert got.all_losses.shape == (3, 2, 5)
    else:
        ref = jax_ablations.batchnorm_effect(runs=2, iterations=5)
        got = ablations.batchnorm_effect(runs=2, iterations=5, device="cpu")
        assert got.labels == ["none", "pre", "post"]
    assert got.labels == ref.labels
    np.testing.assert_array_equal(got.all_losses, ref.all_losses)
    np.testing.assert_array_equal(got.mean_losses, ref.mean_losses)
    assert list(got.as_dict()) == got.labels


def test_ablations_train_on_the_cpu():
    """The real populations at a tiny size: finite curves of the right
    shapes (the BatchNorm configs through their stateful path)."""
    a = batch_size_effect(batch_sizes=[1, 2, 8], runs=2, iterations=3,
                          device="cpu")
    assert a.all_losses.shape == (3, 2, 3) and a.labels == ["1", "2", "8"]
    b = batchnorm_effect(runs=2, iterations=3, batch_size=8, hidden_size=8,
                         num_layers=1, device="cpu")
    assert b.mean_losses.shape == (3, 3)
    assert np.all(np.isfinite(a.all_losses)) and np.all(
        np.isfinite(b.all_losses))


def test_population_drivers_train_on_the_cpu():
    """The drivers on the real population at a tiny size: a score is the
    trial's loss at its own n_iters, the result holds the winner's
    parameters, halving's survivors train to the full budget."""
    prob = Heat1D()
    res = search.random_search(prob, 0, num_samples=3, max_iters=4,
                               max_batch_size=8, device="cpu")
    t = res.best_index
    assert res.best_score == res.losses[res.configs[t]["n_iters"] - 1, t]
    assert res.best_params()["fc_in.w"].shape[0] == 1
    res = search.successive_halving(prob, 0, num_samples=4, eta=2,
                                    min_budget=2, max_budget=4,
                                    max_batch_size=8, device="cpu")
    assert sorted(c["n_iters"] for c in res.configs) == [2, 2, 4, 4]
