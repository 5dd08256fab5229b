"""The port's hard-constraint trial functions (models/hard.py, the six hard
equations, the five hard specs of kernels/fused_engine.py) against the JAX
package's, on the same numpy inputs and parameters; the JAX chunk runs its
Pallas kernel in interpret mode on the CPU, as the JAX package's own tests
run it. Small sizes: H = 16, L = 2 (a DGM of H = 8, L = 1), B = 8, K = 8."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from differential_equations_dnn_tpu.equations import (  # noqa: E402
    PROBLEMS as JAX_PROBLEMS,
)
from differential_equations_dnn_tpu.kernels import (  # noqa: E402
    fused_engine as jfe,
)
from differential_equations_dnn_tpu.kernels import (  # noqa: E402
    fused_train as jft,
)
from differential_equations_dnn_tpu.models import DGM as JaxDGM  # noqa: E402
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu.models import (  # noqa: E402
    hard as jhard,
)
from differential_equations_dnn_tpu_torch import solve  # noqa: E402
from differential_equations_dnn_tpu_torch.api import (  # noqa: E402
    _fused_route,
)
from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.core.prng import (  # noqa: E402
    replica_generator,
)
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    PROBLEMS,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_engine as fe,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    taylor_mlp,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    MLP,
    Ansatz,
    HardConstraint,
    hard_params_from_jax,
    hard_params_to_jax,
    heat1d_ansatz,
    heat2d_ansatz,
    poisson_ansatz,
    time_ic_ansatz,
    wave1d_ansatz,
)
from differential_equations_dnn_tpu_torch.ops import value_dt  # noqa: E402
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    TrainConfig,
    train,
)

H, L, B, K = 16, 2, 8, 8
LR = 1e-3
HARD = ["simple_ode", "heat", "wave", "poisson", "heat2d", "fitzhugh_nagumo"]
SPECS = sorted(fe.HARD_SPECS)
_DIM = {"simple_ode": 1, "heat2d": 3, "fitzhugh_nagumo": 1}
# The equations whose scan batch takes one draw more than the hard spec (a
# boundary edge, whose terms the trial function zeroes).
_SCAN_U = ("poisson", "heat2d")


def _problems(name):
    return (JAX_PROBLEMS[name](constraint="hard"),
            PROBLEMS[name](constraint="hard"))


def _pair(name, seed=0):
    """The JAX HardConstraint of the equation's own ansatz around a small
    net, its parameters (the raw net's tree), and the port's model holding
    the same parameters (hard_params_from_jax)."""
    jprob, prob = _problems(name)
    jansatz = jprob.default_model().ansatz
    if name == "fitzhugh_nagumo":
        net = JaxDGM(input_dim=1, output_dim=2, hidden_size=8, num_layers=1,
                     activation="tanh", init_scheme="torch")
    else:
        net = JaxMLP(input_dim=_DIM.get(name, 2), output_dim=1, hidden_size=H,
                     num_layers=L, activation="tanh")
    jm = jhard.HardConstraint(net, jansatz)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, jp, hard_params_from_jax(jp, prob.hard_ansatz())


def _uniforms(n, shape, seed=0):
    return np.random.default_rng(seed).uniform(size=shape + (n,)).astype(
        np.float32)


def _batch(prob, u):
    """The port's scan batch from draws u, and the same batch for JAX."""
    batch = prob.batch_from_uniforms(torch.from_numpy(u))
    return batch, {k: jnp.asarray(v.numpy()) for k, v in batch.items()}


def _grads_tree(model, grads):
    """The port's gradients (model.net's parameter order) as the raw net's
    tree, the JAX layout."""
    tree = {}
    for (name, _), g in zip(model.net.named_parameters(), grads):
        layer, leaf = name.split(".")
        tree.setdefault(layer, {})[leaf] = g.numpy()
    return tree


# ---------------------------------------------------------------------------
# (a) The ansätze
# ---------------------------------------------------------------------------

_BUILDERS = [
    (time_ic_ansatz, jhard.time_ic_ansatz, (2.0, 1.0), 1),
    (time_ic_ansatz, jhard.time_ic_ansatz, (0.0, 30.0), 1),
    (heat1d_ansatz, jhard.heat1d_ansatz, (np.pi, 3.0), 2),
    (wave1d_ansatz, jhard.wave1d_ansatz, (np.pi, 2.0), 2),
    (poisson_ansatz, jhard.poisson_ansatz, (np.pi,), 2),
    (heat2d_ansatz, jhard.heat2d_ansatz, (np.pi, 1.0), 3),
]


@pytest.mark.parametrize("port, ref, args, D", _BUILDERS,
                         ids=["time_ic", "time_ic_fhn", "heat1d", "wave1d",
                              "poisson", "heat2d"])
def test_ansatz_matches_jax(port, ref, args, D):
    """Each builder against JAX's on the same points and raw outputs (two
    columns, as FitzHugh–Nagumo's): the same elementwise fp32 operations
    in the same order, rtol 1e-6 / atol 1e-7; the tags equal."""
    rng = np.random.default_rng(D)
    x = (3.0 * rng.uniform(size=(16, D))).astype(np.float32)
    y = rng.normal(size=(16, 2)).astype(np.float32)
    a, ja = port(*args), ref(*args)
    assert isinstance(a, Ansatz) and a.tag == ja._deq_tag
    np.testing.assert_allclose(a(torch.from_numpy(x), torch.from_numpy(y)),
                               np.asarray(ja(jnp.asarray(x), jnp.asarray(y))),
                               rtol=1e-6, atol=1e-7)


def test_sin_lift_warns_off_a_multiple_of_pi():
    """The sin(x) lifts warn where sin(x_max) ≠ 0, as the JAX package's."""
    for builder in (heat1d_ansatz, wave1d_ansatz, heat2d_ansatz):
        with pytest.warns(UserWarning, match="multiple of π"):
            builder(3.0)


# ---------------------------------------------------------------------------
# (b) The constraints hold exactly at init
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", HARD)
def test_constraints_hold_exactly_at_init(name):
    """The JAX package's tests/test_hard_constraints.py:28-79 on the port's
    default models (random init): IC to 1e-6, BC to 1e-5."""
    prob = PROBLEMS[name](constraint="hard")
    model = prob.default_model(generator=generator(0))
    assert isinstance(model, HardConstraint)
    n = 16
    u = torch.rand((n, 1), generator=generator(1))
    zeros, full = torch.zeros((n, 1)), lambda v: torch.full((n, 1), v)
    with torch.no_grad():
        if name in ("simple_ode", "fitzhugh_nagumo"):
            np.testing.assert_allclose(model(zeros).numpy(), prob.y_ic,
                                       atol=1e-6)
        elif name in ("heat", "wave"):
            x, t = prob.x_max * u, prob.t_max * u
            np.testing.assert_allclose(
                model(torch.cat([x, zeros], 1)).numpy(),
                np.sin(x.numpy()), atol=1e-6)
            for xb in (0.0, prob.x_max):
                np.testing.assert_allclose(
                    model(torch.cat([full(xb), t], 1)).numpy(), 0.0,
                    atol=1e-5)
        elif name == "poisson":
            e = prob.x_max * u
            for edge in (torch.cat([zeros, e], 1),
                         torch.cat([full(prob.x_max), e], 1),
                         torch.cat([e, zeros], 1),
                         torch.cat([e, full(prob.x_max)], 1)):
                np.testing.assert_allclose(model(edge).numpy(), 0.0,
                                           atol=1e-5)
        else:
            x = prob.x_max * u
            y = prob.x_max * torch.rand((n, 1), generator=generator(2))
            np.testing.assert_allclose(
                model(torch.cat([x, y, zeros], 1)).numpy(),
                (np.sin(x.numpy()) * np.sin(y.numpy())), atol=1e-6)
    if name == "wave":
        # The velocity IC: ∂u/∂t(x, 0) = 0 exactly (the t² factor).
        x0 = torch.cat([prob.x_max * u, zeros], 1)
        _, vel = value_dt(model, x0, t_axis=1)
        np.testing.assert_allclose(vel.detach().numpy(), 0.0, atol=1e-6)


def test_one_point_and_fresh():
    """A 1-D input is one point (the JAX wrapper's squeeze); ``fresh`` keeps
    the ansatz around a new net; the structural attributes are the net's."""
    model = PROBLEMS["heat"](constraint="hard").default_model(
        generator=generator(0))
    xt = torch.tensor([1.0, 0.5])
    torch.testing.assert_close(model(xt), model(xt[None])[0])
    other = model.fresh(generator(1))
    assert other.ansatz is model.ansatz and other.net is not model.net
    assert (model.input_dim, model.output_dim, model.hidden_size,
            model.num_layers, model.activation) == (2, 1, 128, 3, "tanh")


@pytest.mark.parametrize("name", ["heat", "fitzhugh_nagumo"])
def test_params_round_trip(name):
    """hard_params_from_jax and hard_params_to_jax carry the raw net's tree
    (an MLP's, a DGM's) both ways exactly."""
    _, jp, model = _pair(name)
    back = hard_params_to_jax(model)
    assert jax.tree.structure(back) == jax.tree.structure(jp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jp)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# (c) The scan loss on carried-across parameters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", HARD)
def test_scan_loss_matches_jax(name):
    """Each hard equation's scan loss and its gradients on JAX parameters
    carried across, against JAX ``prob.loss(model.apply, ...)`` on the same
    batch (FitzHugh–Nagumo's DGM, causally weighted, included): the port's
    reverse-mode taps against JAX's jvp taps, fp32 reassociation; loss rtol
    1e-5, gradients rtol 1e-4 / atol 1e-6."""
    jprob, prob = _problems(name)
    jm, jp, model = _pair(name, seed=1)
    batch, batch_j = _batch(prob, _uniforms(prob.n_uniform, (B,), seed=1))
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jprob.loss(jm.apply, p, batch_j))(jp)
    loss = prob.loss(model, batch)
    grads = torch.autograd.grad(loss, list(model.net.parameters()))
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-5)
    ours = _grads_tree(model, grads)
    for path, gj in jax.tree_util.tree_leaves_with_path(grads_j):
        layer, leaf = (k.key for k in path)
        np.testing.assert_allclose(ours[layer][leaf], np.asarray(gj),
                                   rtol=1e-4, atol=1e-6)


# ---------------------------------------------------------------------------
# (d), (e), (f) The hard specs
# ---------------------------------------------------------------------------


def _spec_case(name, seed):
    jm, jp, model = _pair(name, seed)
    jprob, prob = _problems(name)
    jspec, spec = jfe.spec_for(jprob), fe.spec_for(prob)
    assert type(spec).__name__ == type(jspec).__name__
    return jm, jp, model, jspec, spec


@pytest.mark.parametrize("name", SPECS)
def test_hard_step_math_matches_jax(name):
    """One step of each hard spec against JAX ``engine_step_math`` with its
    HARD_SPECS entry on the same raw-net parameters and draws: loss rtol
    1e-5, gradients rtol 1e-4 / atol 1e-6 (the JAX package's own tolerances
    for its hard specs, tests/test_hard_constraints.py:167-194)."""
    jm, jp, model, jspec, spec = _spec_case(name, 2)
    u = _uniforms(spec.n_uniform, (B,), seed=2)
    loss_j, grads_j = jfe.engine_step_math(
        jspec, jft.pack_params(jm.net, jp), jnp.asarray(u), B, L)
    flat = fe.pack_state(spec, model)
    loss, grads = fe.engine_step_math(spec, fe.unpack_state(spec, model, flat),
                                      torch.from_numpy(u), B, L)
    assert spec.kernel_streams == fe._n_rows(jspec.groups)
    np.testing.assert_allclose(loss.numpy(), np.asarray(loss_j), rtol=1e-5)
    for g, gj in zip(grads, grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("name", SPECS)
def test_hard_step_math_matches_autograd(name):
    """Each hard spec's hand-composed ansatz derivatives and backward
    against torch.autograd of the port's own scan loss through the
    HardConstraint at the spec's points (the scan loss's IC and BC terms
    are zero, value and gradient): loss rtol 1e-5, gradients rtol 1e-4 /
    atol 1e-6."""
    _, _, model, _, spec = _spec_case(name, 3)
    prob = spec.p
    u = _uniforms(spec.n_uniform, (B,), seed=3)
    u_scan = np.concatenate([u, u[:, :1]], 1) if name in _SCAN_U else u
    batch = prob.batch_from_uniforms(torch.from_numpy(u_scan))
    loss_a = prob.loss(model, batch)
    grads_a = torch.autograd.grad(loss_a, list(spec.tensors(model)))
    loss, grad = fe.engine_loss_grad(spec, model, fe.pack_state(spec, model),
                                     torch.from_numpy(u))
    torch.testing.assert_close(loss, loss_a.detach(), rtol=1e-5, atol=0)
    torch.testing.assert_close(
        grad, torch.cat([g.reshape(-1) for g in grads_a]), rtol=1e-4,
        atol=1e-6)


@pytest.mark.parametrize("name", ["heat", "wave"])
def test_hard_chunk_matches_jax(name):
    """K = 8 Adam steps of hard heat and wave from step0 = 5 inside a
    20-step cosine horizon, against JAX ``fused_engine_chunk`` (Pallas,
    interpret mode) with its hard spec: losses, parameters and moments to
    rtol 1e-5 / atol 1e-6, as the soft specs' chunks."""
    jm, jp, model, jspec, spec = _spec_case(name, 4)
    u = _uniforms(spec.n_uniform, (K, B), seed=4)
    kw = dict(schedule="cosine", total_steps=20, decay=0.1)
    flat = jft.pack_params(jm.net, jp)
    zeros = tuple(jnp.zeros_like(t) for t in flat)
    pj, mj, vj, lj = jfe.fused_engine_chunk(jspec, jm.net, flat, zeros, zeros,
                                            jnp.asarray(u), 5, LR, **kw)
    p = fe.pack_state(spec, model)
    z = torch.zeros_like(p)
    pt, mt, vt, lt = fe.fused_engine_chunk(spec, model, p, z, z,
                                           torch.from_numpy(u), 5, LR, **kw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-6)
    for ours, theirs in ((pt, pj), (mt, mj), (vt, vj)):
        for a, b in zip(fe.unpack_state(spec, model, ours), theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# (g) solve on both engines
# ---------------------------------------------------------------------------

# The grid rows on which each trial function holds its IC or BC: (axis of
# solution_shape, index).
_ROWS = {"simple_ode": [(0, 0)], "fitzhugh_nagumo": [(0, 0)],
         "heat": [(0, 0), (1, 0), (1, -1)],
         "wave": [(0, 0), (1, 0), (1, -1)],
         "poisson": [(0, 0), (0, -1), (1, 0), (1, -1)],
         "heat2d": [(0, 0), (1, 0), (1, -1), (2, 0), (2, -1)]}


def _check_rows(res, name):
    """The constraint rows of the solution against the ground truth there,
    to 1e-6 (the JAX package's test_hard_constraint_trains_on_fused_engine
    holds them so): fp32 sin against numpy's, and D·N exactly 0."""
    for axis, index in _ROWS[name]:
        np.testing.assert_allclose(np.take(res.solution, index, axis),
                                   np.take(res.exact, index, axis), atol=1e-6)


@pytest.mark.parametrize("name", SPECS)
def test_hard_solve_fused(name):
    """``solve(..., constraint="hard", engine="fused")`` on the CPU trains
    the raw net through the hard spec's plain version: a finite history of
    40 steps, a finite MAE, and the constraints still exact afterwards."""
    res = solve(name, constraint="hard", engine="fused", device="cpu",
                iterations=40, batch_size=8, nodes=8, finetune=0)
    assert res.loss_history.shape == (40,)
    assert np.all(np.isfinite(res.loss_history)) and np.isfinite(res.mae)
    assert isinstance(res.params, HardConstraint)
    _check_rows(res, name)


@pytest.mark.parametrize("name", ["simple_ode", "fitzhugh_nagumo"])
def test_hard_solve_scan(name):
    """The scan trainer takes the wrapper unchanged (Adam, its stateless
    check, the L-BFGS polish): 20 steps and 2 L-BFGS steps train, and the
    IC still holds exactly."""
    res = solve(name, constraint="hard", device="cpu", iterations=20,
                batch_size=8, nodes=8, finetune=2)
    assert res.loss_history.shape == (22,)
    assert np.all(np.isfinite(res.loss_history)) and np.isfinite(res.mae)
    _check_rows(res, name)


def test_hard_scan_trainer_descends():
    """JAX's test_hard_heat_trains on the port's scan trainer: hard heat
    (jvp taps) at lr 1e-3, batch 16, 150 steps lowers its loss."""
    prob = PROBLEMS["heat"](constraint="hard")
    cfg = TrainConfig(iterations=150, batch_size=16, lrate=1e-3,
                      chunk_size=150, verbose=False)
    res = train(prob, 0, cfg, device="cpu")
    assert res.loss_history[-50:].mean() < res.loss_history[:50].mean()
    assert np.isfinite(prob.mae(res.params, 8))


# ---------------------------------------------------------------------------
# (h) The routes
# ---------------------------------------------------------------------------


def test_hard_routes():
    """A HardConstraint is routed first: hard constant-lr heat goes to the
    generic engine, not to the soft heat kernel #1; a plain MLP on a hard
    problem, a HardConstraint on a soft one, a custom ansatz and the same
    builder at other constants are refused (the scan engine trains them)."""
    prob = PROBLEMS["heat"](constraint="hard")
    model = prob.default_model()
    assert _fused_route(prob, model, "constant") == "engine"
    assert fe.supports(prob, model) and fe.supports(prob)
    custom = HardConstraint(model.net, Ansatz(("mine",), lambda x, y: y))
    other = HardConstraint(model.net, heat1d_ansatz(np.pi, 1.0))
    for problem, m in ((prob, model.net), (PROBLEMS["heat"](), model),
                       (prob, custom), (prob, other)):
        assert not fe.supports(problem, m)
        with pytest.raises(ValueError, match="scan"):
            _fused_route(problem, m, "constant")


def test_hard_fitzhugh_nagumo_fused_names_the_scan_engine():
    """fitzhugh_nagumo's hard ansatz wraps its DGM: the fused route raises
    the JAX package's ValueError naming the scan engine and the hard specs,
    not the DGM engine's "needs a DGM"."""
    with pytest.raises(ValueError, match=r"scan engine.*\['heat', 'heat2d'"):
        solve("fitzhugh_nagumo", constraint="hard", engine="fused",
              device="cpu", iterations=10)


@pytest.mark.parametrize("name", ["heat", "heat2d"])
def test_hard_needs_jvp_taps(name):
    """Heat and heat2d with constraint="hard" and Taylor-stream taps raise
    the JAX package's ValueError."""
    with pytest.raises(ValueError, match="taps='jvp'"):
        PROBLEMS[name](constraint="hard", taps="taylor").default_model()


# ---------------------------------------------------------------------------
# (i) evaluate applies the ansatz; (j) packed replicas
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", ["heat", "fitzhugh_nagumo"])
def test_evaluate_applies_the_ansatz(name):
    """``evaluate`` of a hard model is ``ansatz(x, net(x))`` on the grid,
    not the raw net (which differs from it by far more than rounding), and
    ``mlp_forward`` refuses the wrapper rather than evaluate its raw net."""
    prob = PROBLEMS[name](constraint="hard")
    model = prob.default_model(generator=generator(5))
    x = prob.grid_inputs(6)
    with torch.no_grad():
        want = model.ansatz(x, model.net(x)).numpy()
        raw = model.net(x).numpy()
    got = prob.evaluate(model, 6).reshape(want.shape)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert np.abs(got - raw).max() > 1e-2
    with pytest.raises(ValueError, match="HardConstraint"):
        taylor_mlp.mlp_forward(model, x)


def test_hard_packed_replica_equals_its_single_run():
    """At N = 2, replica r of the packed hard-heat driver equals the single
    driver on replica r's init bit for bit (losses and parameters), and
    ``solve(ensemble=2)`` picks one of them."""
    prob = PROBLEMS["heat"](constraint="hard")
    net = MLP(2, 1, H, L, "tanh")
    model = HardConstraint(net, prob.hard_ansatz())
    kw = dict(batch_size=B, lrate=LR, device="cpu")
    res = fe.train_fused_ensemble_packed(prob, 5, 6, 2, model=model, **kw)
    spec = fe.spec_for(prob)
    for r in range(2):
        one = fe.train_fused_result(
            prob, 5, 6, model=model.fresh(replica_generator(5, r)), **kw)
        np.testing.assert_array_equal(res.loss_history[r], one.loss_history)
        assert torch.equal(fe.pack_state(spec, res.params[r]),
                           fe.pack_state(spec, one.params))
    out = solve("heat", constraint="hard", engine="fused", device="cpu",
                ensemble=2, iterations=6, batch_size=B, nodes=6, finetune=0)
    assert isinstance(out.params, HardConstraint)
    assert out.loss_history.shape == (6,)
