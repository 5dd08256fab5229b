"""The port's scan trainer (train/trainer.py) against the JAX package's, and
its own contract, mirroring tests/test_trainer.py.

Parity: K identical numpy-built batches go through the port's
``make_train_step`` and through a JAX loop of ``value_and_grad(prob.loss)``
with the JAX trainer's own optax optimizer (``trainer._make_optimizer``),
from the same parameters; the pallas-taps case runs the JAX kernel in
interpret mode. Small sizes: H = 16, L = 2 (DGMs H = 8), B = 16, K = 10.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import optax  # noqa: E402

from differential_equations_dnn_tpu.equations import (  # noqa: E402
    PROBLEMS as JAX_PROBLEMS,
)
from differential_equations_dnn_tpu.models import DGM as JaxDGM  # noqa: E402
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu.train import (  # noqa: E402
    TrainConfig as JaxTrainConfig,
)
from differential_equations_dnn_tpu.train import (  # noqa: E402
    trainer as jtrainer,
)
from differential_equations_dnn_tpu_torch import solve  # noqa: E402
from differential_equations_dnn_tpu_torch.core import (  # noqa: E402
    generator,
    step_generator,
)
from differential_equations_dnn_tpu_torch.core.prng import (  # noqa: E402
    replica_generator,
)
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    PROBLEMS,
    Heat1D,
    SimpleODE,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    taylor_mlp as tm,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    MLP,
    dgm_params_from_jax,
    params_from_jax,
)
from differential_equations_dnn_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
)
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    TrainConfig,
    inject_fault,
    make_train_step,
    opt_state_from_jax,
    train,
)
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    trainer as trainer_mod,
)

H, B, K = 16, 16, 10
LR = 1e-3


# ---------------------------------------------------------------------------
# Against the JAX trainer
# ---------------------------------------------------------------------------


def _case(name, taps=None, seed=0):
    """(JAX problem, JAX model, its params, port problem, port model)."""
    if name in ("fitzhugh_nagumo", "fredholm"):
        act, scheme, O, L = (("tanh", "torch", 2, 2) if name != "fredholm"
                             else ("relu", "xavier_relu", 1, 1))
        jm = JaxDGM(input_dim=1, output_dim=O, hidden_size=8, num_layers=L,
                    activation=act, init_scheme=scheme)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
        kw = {"k": 12} if name == "fredholm" else {}
        return (JAX_PROBLEMS[name](**kw), jm, jp, PROBLEMS[name](**kw),
                dgm_params_from_jax(jp, act, scheme))
    D = 1 if name == "simple_ode" else 2
    jm = JaxMLP(input_dim=D, output_dim=1, hidden_size=H, num_layers=2,
                activation="tanh")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    if taps is None:
        jprob, prob = JAX_PROBLEMS[name](), PROBLEMS[name]()
    else:
        jprob = JAX_PROBLEMS[name](taps=taps, taps_model=jm)
        prob = PROBLEMS[name](taps=taps)
    return jprob, jm, jp, prob, params_from_jax(jp, "tanh")


def _batches(prob, n, seed=0):
    """n port batches built from numpy uniforms, and the same as numpy."""
    u = np.random.default_rng(seed).uniform(
        size=(n, B, prob.n_uniform)).astype(np.float32)
    tb = [prob.batch_from_uniforms(torch.from_numpy(uk)) for uk in u]
    return tb, [{k: v.numpy() for k, v in b.items()} for b in tb]


def _jax_run(jprob, jm, jp, batches, config, state=None):
    """The JAX trainer's step (its loss, gradient and optax optimizer),
    jitted, over the given batches."""
    opt = jtrainer._make_optimizer(config)
    state = opt.init(jp) if state is None else state

    @jax.jit
    def step(params, state, batch):
        loss, g = jax.value_and_grad(
            lambda p: jprob.loss(jm.apply, p, batch))(params)
        upd, state = opt.update(g, state, params)
        return optax.apply_updates(params, upd), state, loss

    losses = []
    for b in batches:
        jp, state, loss = step(jp, state, b)
        losses.append(float(loss))
    return jp, state, np.array(losses)


def _port_run(prob, model, batches, config, opt_state=None):
    opt = trainer_mod.make_optimizer(config, model.parameters())
    if opt_state is not None:
        trainer_mod.load_opt_state(opt, opt_state)
    step = make_train_step(prob, model, opt, B)
    return np.array([float(step(b)) for b in batches])


def _assert_params(model, tree, lr):
    """Parameters to atol 1e-5 + 2·lr: an Adam step on a gradient within
    rounding of zero can move a parameter by up to lr in either direction
    in either implementation."""
    for name, p in model.named_parameters():
        leaf = tree
        for part in name.split("."):
            leaf = leaf[part]
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(leaf),
                                   rtol=0, atol=1e-5 + 2 * lr, err_msg=name)


@pytest.mark.parametrize("name, taps, optimizer, schedule", [
    ("heat", "jvp", "adam", "constant"),
    ("heat", "taylor", "adam", "constant"),
    ("heat", "pallas", "adam", "constant"),
    ("simple_ode", None, "adam", "constant"),
    ("burgers", None, "adam", "constant"),
    ("fitzhugh_nagumo", None, "adam", "constant"),
    ("fredholm", None, "adam", "constant"),
    ("heat", "taylor", "adam", "cosine"),
    ("heat", "taylor", "adam", "exponential"),
    ("heat", "taylor", "adamw", "constant"),
    ("heat", "taylor", "sgd", "constant"),
    ("burgers", None, "adamw", "cosine"),
])
def test_steps_match_jax(name, taps, optimizer, schedule):
    """K steps on identical batches: losses to rtol 1e-4 (fp32
    reassociation, compounded over K updates), parameters to atol 1e-5 +
    2·lr. The schedule's horizon is 2K steps, so a decaying lr falls to
    0.5-0.6 of lrate within the run and a wrong count fails."""
    jprob, jm, jp, prob, model = _case(name, taps)
    tb, nb = _batches(prob, K)
    kw = dict(iterations=2 * K, batch_size=B, lrate=LR, optimizer=optimizer,
              schedule=schedule)
    jp, _, want = _jax_run(jprob, jm, jp, nb, JaxTrainConfig(**kw))
    got = _port_run(prob, model, tb, TrainConfig(**kw))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    _assert_params(model, jp, LR)


def test_resume_across_packages():
    """JAX trains 10 steps; ``params_from_jax`` + ``opt_state_from_jax``
    carry its parameters and Adam state (count, mu, nu) to the port, which
    trains 10 more; against JAX training all 20 on the same batches (losses
    rtol 1e-4, parameters atol 1e-5 + 2·lr)."""
    jprob, jm, jp0, prob, _ = _case("heat", "taylor", seed=3)
    tb, nb = _batches(prob, 2 * K, seed=3)
    cfg = dict(iterations=2 * K, batch_size=B, lrate=LR)
    jp_all, _, want = _jax_run(jprob, jm, jp0, nb, JaxTrainConfig(**cfg))
    jp_half, jstate, _ = _jax_run(jprob, jm, jp0, nb[:K], JaxTrainConfig(**cfg))
    model = params_from_jax(jax.tree.map(np.asarray, jp_half), "tanh")
    opt_state = opt_state_from_jax(jstate, model)
    assert opt_state["param_groups"][0]["count"] == K
    got = _port_run(prob, model, tb[K:], TrainConfig(**cfg), opt_state)
    np.testing.assert_allclose(got, want[K:], rtol=1e-4)
    _assert_params(model, jp_all, LR)


def test_opt_state_from_jax_needs_adam():
    with pytest.raises(ValueError, match="Adam"):
        opt_state_from_jax((optax.EmptyState(),), MLP(2, 1, 4, 1, "tanh"))


def test_optimizers_are_set_up_as_optax():
    """Adam with eps 1e-8 outside the root; AdamW with optax's weight decay
    1e-4, not torch's 1e-2; plain SGD; the schedule on every group."""
    params = [torch.nn.Parameter(torch.zeros(3))]
    adam = trainer_mod.make_optimizer(TrainConfig(), params)
    adamw = trainer_mod.make_optimizer(TrainConfig(optimizer="adamw"), params)
    sgd = trainer_mod.make_optimizer(TrainConfig(optimizer="sgd",
                                                 schedule="cosine"), params)
    assert isinstance(adam, torch.optim.Adam)
    assert adam.param_groups[0]["eps"] == 1e-8
    assert isinstance(adamw, torch.optim.AdamW)
    assert adamw.param_groups[0]["weight_decay"] == 1e-4
    assert isinstance(sgd, torch.optim.SGD)
    assert sgd.param_groups[0]["momentum"] == 0
    assert sgd.param_groups[0]["schedule"] == "cosine"
    assert sgd.param_groups[0]["count"] == 0
    for bad in (dict(optimizer="lion"), dict(schedule="linear")):
        with pytest.raises(ValueError, match="unknown"):
            trainer_mod.make_optimizer(TrainConfig(**bad), params)


# ---------------------------------------------------------------------------
# The trainer's own contract (tests/test_trainer.py)
# ---------------------------------------------------------------------------


def _tiny(seed=0):
    return MLP(1, 1, 8, 1, "tanh", generator=generator(seed))


def _cfg(**kw):
    base = dict(iterations=20, batch_size=8, lrate=LR, verbose=False)
    base.update(kw)
    return TrainConfig(**base)


def _run(cfg, seed=5, **kw):
    return train(SimpleODE(), seed, cfg, model=kw.pop("model", _tiny()),
                 device="cpu", **kw)


def _params(model):
    return [p.detach().clone() for p in model.parameters()]


def test_chunked_equals_uncut():
    """Chunking is invisible, bit for bit: 3 chunks of 7 ≡ 1 chunk of 20."""
    a, b = _run(_cfg(chunk_size=7)), _run(_cfg(chunk_size=20))
    np.testing.assert_array_equal(a.loss_history, b.loss_history)
    assert all(torch.equal(p, q) for p, q in zip(_params(a.params),
                                                 _params(b.params)))


def test_remainder_chunk():
    res = _run(_cfg(iterations=25, chunk_size=10))
    assert res.loss_history.shape == (25,)
    assert np.all(np.isfinite(res.loss_history))


def test_training_is_deterministic_from_its_seed():
    a, b, c = _run(_cfg()), _run(_cfg()), _run(_cfg(), seed=6)
    np.testing.assert_array_equal(a.loss_history, b.loss_history)
    assert not np.array_equal(a.loss_history, c.loss_history)


def test_resume_equals_an_unbroken_run():
    """10 steps, then ``params``/``opt_state``/``start_step`` for 10 more,
    equal 20 unbroken steps bit for bit: the draws are keyed by the absolute
    step and the optimizer's count travels in its state."""
    whole = _run(_cfg(iterations=20))
    first = _run(_cfg(iterations=10))
    second = _run(_cfg(iterations=10), model=first.params,
                  opt_state=first.opt_state, start_step=10)
    np.testing.assert_array_equal(
        np.concatenate([first.loss_history, second.loss_history]),
        whole.loss_history)
    assert all(torch.equal(p, q) for p, q in zip(_params(second.params),
                                                 _params(whole.params)))
    assert second.opt_state["param_groups"][0]["count"] == 20


def test_resume_continues_the_schedule():
    """A resumed cosine run takes the lr of its count, not of step 0."""
    first = _run(_cfg(iterations=10, schedule="cosine"))
    opt = trainer_mod.make_optimizer(_cfg(iterations=10, schedule="cosine"),
                                     first.params.parameters())
    trainer_mod.load_opt_state(opt, first.opt_state)
    trainer_mod._set_lr(opt)
    assert opt.param_groups[0]["lr"] == pytest.approx(LR * 0.1)
    assert first.opt_state["param_groups"][0]["count"] == 10


def test_adaptive_oversampling_is_finite_and_no_worse():
    """Residual-based adaptive collocation (4× candidates, the hardest
    quarter kept) at least nearly matches uniform sampling at an equal
    budget, as tests/test_trainer.py holds it: MAE within 1.5×."""
    prob = Heat1D(taps="taylor")
    maes = {}
    for ov in (0, 4):
        res = train(prob, 0, _cfg(iterations=150, batch_size=16,
                                  adaptive_oversample=ov),
                    model=MLP(2, 1, 16, 2, "tanh", generator=generator(0)),
                    device="cpu")
        assert np.all(np.isfinite(res.loss_history))
        maes[ov] = prob.mae(res.params, nodes=10)
    assert all(np.isfinite(v) for v in maes.values())
    assert maes[4] < maes[0] * 1.5


def test_adaptive_oversampling_keeps_the_hardest_points():
    """The step trains on the batch_size candidates of largest residual."""
    prob, model = SimpleODE(), _tiny()
    opt = trainer_mod.make_optimizer(_cfg(), model.parameters())
    step = make_train_step(prob, model, opt, 4, adaptive_oversample=3)
    assert step.draw_size == 12
    cand = prob.sample(12, generator(1))
    with torch.no_grad():
        r = prob.point_loss(model, cand)
    hardest = torch.topk(r, 4).indices
    want = float(torch.mean(r[hardest]))
    assert float(step(cand)) == pytest.approx(want, rel=1e-6)


def test_metrics_jsonl(tmp_path):
    mf = tmp_path / "metrics.jsonl"
    _run(_cfg(iterations=250, chunk_size=100, metrics_file=str(mf)))
    records = [json.loads(line) for line in mf.read_text().splitlines()]
    assert [r["step"] for r in records] == [100, 200, 250]
    assert all("iters_per_sec" in r and np.isfinite(r["loss"])
               for r in records)


def test_log_every_prints_after_the_chunk(capsys):
    _run(_cfg(iterations=25, chunk_size=10, verbose=True, log_every=10))
    lines = capsys.readouterr().out.splitlines()
    assert [line.split(",")[0] for line in lines] == [
        "Iteration: 0", "Iteration: 10", "Iteration: 20"]


def test_elastic_recovery_from_injected_fault():
    """A failed chunk restores the host snapshot and gives the SAME result
    as an uninterrupted run (step-keyed draws), bit for bit."""
    cfg = _cfg(iterations=30, chunk_size=10)
    clean = _run(cfg)
    with inject_fault(at_dispatch=1):
        recovered = _run(cfg)
    np.testing.assert_array_equal(clean.loss_history, recovered.loss_history)


def test_recovery_exhausts_retries():
    cfg = _cfg(iterations=20, chunk_size=10, max_retries=1)
    with inject_fault(at_dispatch=0):
        trainer_mod._FAULT_QUEUE.extend([1, 2])  # fail three times in all
        with pytest.raises(trainer_mod._InjectedFault):
            _run(cfg)


def test_recovery_disabled():
    with inject_fault(at_dispatch=0):
        with pytest.raises(trainer_mod._InjectedFault):
            _run(_cfg(iterations=10, snapshot_every=0))


def test_no_runtime_error_is_retried():
    """On a GPU no runtime failure is known to be curable by a retry in the
    same process (a CUDA fault poisons the context), so only the injected
    fault is recoverable."""
    assert trainer_mod._RECOVERABLE == ()
    assert not trainer_mod._is_recoverable(RuntimeError("CUDA error"))
    assert trainer_mod._is_recoverable(trainer_mod._InjectedFault())


def test_profile_dir_writes_a_trace(tmp_path):
    _run(_cfg(iterations=3), profile_dir=str(tmp_path / "prof"))
    assert (tmp_path / "prof" / "trace.json").stat().st_size > 0


def test_default_config_and_model(monkeypatch):
    """``config=None`` takes iterations, batch size and lr from the
    problem's defaults (not its schedule); ``model=None`` is the default
    model from ``generator(seed)``."""
    configs = []
    real = trainer_mod.make_optimizer

    def spy(config, params):
        configs.append(config)
        return real(config, params)

    monkeypatch.setattr(trainer_mod, "make_optimizer", spy)
    prob = SimpleODE(defaults=type(SimpleODE().defaults)(
        iterations=3, batch_size=4, lrate=2e-3, schedule="cosine"))
    res = train(prob, 0, device="cpu")
    cfg = configs[0]
    assert (cfg.iterations, cfg.batch_size, cfg.lrate, cfg.schedule) == \
        (3, 4, 2e-3, "constant")
    want = prob.default_model(generator=generator(0))
    assert res.loss_history.shape == (3,)
    assert isinstance(res.params, MLP)
    assert res.params.hidden_size == want.hidden_size
    assert res.compile_time > 0 and res.wall_time > 0


def test_step_generators():
    """Step i's draws depend on (seed, i) alone: reproducible, distinct
    across steps and seeds, and none is the init or a replica generator."""
    draws = {(s, i): torch.rand(4, generator=step_generator(s, i))
             for s in (0, 1) for i in range(3)}
    assert torch.equal(draws[0, 2], torch.rand(4, generator=step_generator(0,
                                                                          2)))
    assert len({tuple(d.tolist()) for d in draws.values()}) == 6
    others = [torch.rand(4, generator=generator(0)),
              torch.rand(4, generator=replica_generator(0, 0))]
    assert not any(torch.equal(draws[0, 0], o) for o in others)


# ---------------------------------------------------------------------------
# solve(engine="scan") and what raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name, kw", [
    ("heat", {"taps": "pallas"}), ("simple_ode", {}),
])
def test_solve_scan_on_cpu(name, kw):
    """The default engine on the CPU: a finite history of the right length,
    a finite solution of the problem's shape; pallas taps go through the
    wrapper of kernel #3 (its plain version here, no launch)."""
    D = 1 if name == "simple_ode" else 2
    tm.heat_fused_streams.launches = 0
    res = solve(name, device="cpu", iterations=12, batch_size=8,
                lrate=3e-3, nodes=5,
                model=MLP(D, 1, 8, 1, "tanh", generator=generator(0)), **kw)
    assert res.loss_history.shape == (12,)
    assert np.all(np.isfinite(res.loss_history))
    assert res.solution.shape == PROBLEMS[name]().solution_shape(5)
    assert np.isfinite(res.mae) and res.device == "cpu"
    assert res.iters_per_sec > 0 and res.compile_time > 0
    assert tm.heat_fused_streams.launches == 0


def test_solve_scan_finetunes():
    res = solve("simple_ode", device="cpu", iterations=5, batch_size=8,
                nodes=5, finetune=3, model=_tiny())
    assert res.loss_history.shape == (8,)


def test_missing_gpu_raises(monkeypatch):
    """``device`` defaults to "cuda" and raises without a GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve("heat", iterations=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train(SimpleODE(), 0, _cfg())


class _Stateful(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.lin = torch.nn.Linear(1, 1)
        self.register_buffer("running_mean", torch.zeros(1))

    def forward(self, x):
        return self.lin(x)


@pytest.mark.parametrize("call, match", [
    (lambda: solve("heat", ensemble=2, device="cpu", iterations=3,
                   batch_size=8, nodes=5), None),
    (lambda: train(SimpleODE(), 0, _cfg(),
                   mesh=make_mesh({"pop": 1}, "cpu"), device="cpu"),
     "'data' mesh axis"),
    (lambda: solve("heat", constraint="hard", taps="taylor", device="cpu"),
     r"Heat1D\(taps='jvp'\)"),
    (lambda: solve("volterra", quadrature="montecarlo", engine="fused",
                   device="cpu"), "engine='scan'"),
    (lambda: train(SimpleODE(), 0, _cfg(), model=_Stateful(),
                   device="cpu"), None),
    (lambda: solve("fredholm", quadrature="halton", engine="fused",
                   device="cpu"), "engine='scan'"),
], ids=["ensemble", "mesh", "hard", "volterra", "stateful", "halton"])
def test_unported_scan_routes_raise(call, match):
    """What the scan engine does not run yet raises, naming its ROADMAP
    item. Volterra's Monte-Carlo and Fredholm's Halton rules run on the
    scan engine alone: the fused route refuses them, naming
    engine='scan'. Hard heat takes the jvp taps only (the JAX package's
    ValueError). Since item 13 an ensemble (a population) and a model with
    buffers train on the scan engine (``match`` None): they run, with a
    finite loss history. Since item 14 ``train`` takes a mesh
    (tests/test_torch_parallel.py): one without a 'data' axis is refused
    with a ValueError."""
    if match is None:
        res = call()
        assert np.all(np.isfinite(res.loss_history))
        return
    with pytest.raises((NotImplementedError, ValueError), match=match):
        call()
