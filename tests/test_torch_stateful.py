"""The port's stateful, Fourier-feature and ResNet models against the JAX
package, their derivative taps, the scan trainer's stateful path, and the
fused routes' refusal of them.

Inputs come from numpy seeds and JAX parameters carry across through numpy
(``params_from_jax``, ``resnet_params_from_jax``). Forwards to rtol 1e-5 /
atol 1e-6; K = 10 training steps as tests/test_torch_trainer.py holds them
(losses rtol 1e-4, parameters atol 1e-5 + 2·lr).

The taps of a BatchNorm net are the reference's ``torch.autograd.grad(u, x,
ones)``, Jᵀ·1, on both of the port's routes. The JAX package takes them by
a batched jvp, J·1 (ops/diff.py:17-20 there), which differs for such a net
(ROADMAP queue 3): its BatchNorm references here use ``jax.vjp`` with a
ones cotangent, the taps the JAX docstring intends, and one test shows how
far the JAX taps are from them.
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
from differential_equations_dnn_tpu.equations import (  # noqa: E402
    heat as jax_heat,
)
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu.models import (  # noqa: E402
    ResidualBlock as JaxBlock,
)
from differential_equations_dnn_tpu.models import (  # noqa: E402
    ResNet as JaxResNet,
)
from differential_equations_dnn_tpu.models import (  # noqa: E402
    train_apply as jax_train_apply,
)
from differential_equations_dnn_tpu.models import (  # noqa: E402
    update_state as jax_update_state,
)
from differential_equations_dnn_tpu.ops import diff as jax_diff  # noqa: E402
from differential_equations_dnn_tpu_torch import solve  # noqa: E402
from differential_equations_dnn_tpu_torch.api import (  # noqa: E402
    _fused_route,
)
from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    PROBLEMS,
    FitzHughNagumo,
    Heat1D,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_engine as fe,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_train as ft,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    taylor_mlp as tm,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    MLP,
    HardConstraint,
    ResidualBlock,
    ResNet,
    eval_mode,
    params_from_jax,
    params_to_jax,
    resnet_params_from_jax,
    resnet_params_to_jax,
    state_to_jax,
    update_state,
)
from differential_equations_dnn_tpu_torch.ops import (  # noqa: E402
    coordinate_taps,
)
from differential_equations_dnn_tpu_torch.ops.diff import (  # noqa: E402
    functional_taps,
)
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    TrainConfig,
    make_train_step,
    train,
)
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    trainer as trainer_mod,
)

H, L, B, K = 16, 2, 16, 10
LR = 1e-3
FWD = dict(rtol=1e-5, atol=1e-6)


def _x(n=B, d=2, seed=1):
    return np.random.default_rng(seed).uniform(0, 1, (n, d)).astype(
        np.float32)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _jax_mlp(batch_norm=None, activation="tanh", F=0, D=2, O=1, seed=0):
    jm = JaxMLP(input_dim=D, output_dim=O, hidden_size=H, num_layers=L,
                activation=activation, batch_norm=batch_norm,
                fourier_features=F, fourier_scale=0.5)
    return jm, _np(jm.init(jax.random.key(seed)))


def _moved_state(jm, seed=2):
    """A JAX BN state away from its init (mean 0, var 1), so that an
    eval-mode forward reads it."""
    rng = np.random.default_rng(seed)
    st = jm.init_state()
    return {"mean": rng.normal(0, 0.3, st["mean"].shape).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, st["var"].shape).astype(np.float32)}


def _t(a):
    return torch.tensor(np.asarray(a))


# ---------------------------------------------------------------------------
# Models against JAX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("batch_norm", ["pre", "post"])
@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_bn_mlp_matches_jax(batch_norm, activation):
    """Train-mode and eval-mode forwards and ``update_state`` against the
    JAX model's ``apply`` (train=True / False) and its new state, from the
    same parameters and statistics."""
    jm, jp = _jax_mlp(batch_norm, activation)
    st = _moved_state(jm)
    m = params_from_jax(jp, activation, batch_norm=batch_norm, state=st)
    x = _x()
    y_train, new = jm.apply(jp, x, state=st, train=True)
    y_eval, _ = jm.apply(jp, x, state=st, train=False)
    np.testing.assert_allclose(m(_t(x)).detach().numpy(), y_train, **FWD)
    with eval_mode(m):
        np.testing.assert_allclose(m(_t(x)).detach().numpy(), y_eval, **FWD)
    # The train-mode forward wrote nothing; update_state writes JAX's.
    np.testing.assert_array_equal(m.bn.mean.numpy(), st["mean"])
    update_state(m, _t(x))
    got = state_to_jax(m)
    np.testing.assert_allclose(got["mean"], new["mean"], **FWD)
    np.testing.assert_allclose(got["var"], new["var"], **FWD)


@pytest.mark.parametrize("batch_norm", [None, "pre"])
def test_fourier_mlp_matches_jax(batch_norm):
    """x → [sin 2πxB, cos 2πxB] with the JAX model's own B."""
    jm, jp = _jax_mlp(batch_norm, F=4)
    m = params_from_jax(jp, "tanh", batch_norm=batch_norm)
    x = _x()
    out = jm.apply(jp, x, state=jm.init_state(), train=True)
    want = out[0] if batch_norm else out
    assert m.fourier_features == 4 and not m.plain
    np.testing.assert_allclose(m(_t(x)).detach().numpy(), want, **FWD)
    assert "fourier.b" not in dict(m.named_parameters())


@pytest.mark.parametrize("downsample", [True, False])
@pytest.mark.parametrize("train_mode", [True, False])
def test_residual_block_matches_jax(downsample, train_mode):
    D = 3 if downsample else H
    jb = JaxBlock(D, H, downsample=downsample)
    jp = _np(jb.init(jax.random.key(3)))
    st = jax.tree.map(lambda a: np.asarray(a) + 0.25, jb.init_state())
    b = ResidualBlock(D, H, downsample)
    leaves = {**dict(b.named_parameters()), **dict(b.named_buffers())}
    with torch.no_grad():
        for name, t in leaves.items():
            src = st if name.endswith((".mean", ".var")) else jp
            for part in name.split("."):
                src = src[part]
            t.copy_(_t(src))
    x = _x(d=D)
    want, new = jb.apply(jp, x, state=st, train=train_mode)
    b.train(train_mode)
    np.testing.assert_allclose(b(_t(x)).detach().numpy(), want, **FWD)
    if train_mode:
        got = b.running_stats(_t(x))
        np.testing.assert_allclose(got["fc2.var"].detach().numpy(),
                                   new["fc2"]["var"], **FWD)


@pytest.mark.parametrize("train_mode", [True, False])
def test_resnet_matches_jax(train_mode):
    """The whole ResNet (two stages, the downsample projection, the head)
    in train and eval mode, and its statistics after ``update_state``."""
    jr = JaxResNet(input_dim=2, output_dim=1, hidden_size=8, n_blocks=2)
    jp = _np(jr.init(jax.random.key(4)))
    st = jax.tree.map(lambda a: np.asarray(a) * 1.5 + 0.1, jr.init_state())
    m = resnet_params_from_jax(jp, st)
    x = _x()
    want, new = jr.apply(jp, x, state=st, train=train_mode)
    m.train(train_mode)
    np.testing.assert_allclose(m(_t(x)).detach().numpy(), want, **FWD)
    if train_mode:
        update_state(m, _t(x))
        _, got = resnet_params_to_jax(m)
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(new)):
            np.testing.assert_allclose(a, b, **FWD)


@pytest.mark.parametrize("kind", ["plain", "pre", "post", "fourier",
                                  "resnet"])
def test_params_round_trip(kind):
    """``params_to_jax`` ∘ ``params_from_jax`` is the identity, for every
    leaf (BN γ, β, mean, var and the Fourier matrix too), and the JAX model
    computes the port's forward on the carried tree."""
    x = _x()
    if kind == "resnet":
        m = ResNet(hidden_size=8, n_blocks=2, generator=generator(5))
        update_state(m, _t(x))
        p, s = resnet_params_to_jax(m)
        back = resnet_params_from_jax(p, s)
        jr = JaxResNet(hidden_size=8, n_blocks=2)
        want, _ = jr.apply(p, x, state=s, train=False)
        for a, b in zip(m.state_dict().values(), back.state_dict().values()):
            assert torch.equal(a, b)
        with eval_mode(m):
            np.testing.assert_allclose(m(_t(x)).detach().numpy(), want, **FWD)
        return
    bn = kind if kind in ("pre", "post") else None
    F = 4 if kind == "fourier" else 0
    m = MLP(2, 1, H, L, "tanh", bn, F, 0.5, generator=generator(6))
    update_state(m, _t(x))
    tree, st = params_to_jax(m), state_to_jax(m)
    back = params_from_jax(tree, "tanh", batch_norm=bn, state=st)
    for a, b in zip(m.state_dict().values(), back.state_dict().values()):
        assert torch.equal(a, b)
    jm = JaxMLP(2, 1, H, L, "tanh", batch_norm=bn, fourier_features=F)
    out = jm.apply(tree, x, state=st, train=False) if bn else \
        jm.apply(tree, x)
    want = out[0] if bn else out
    with eval_mode(m):
        np.testing.assert_allclose(m(_t(x)).detach().numpy(), want, **FWD)


def test_bn_tree_needs_its_placement():
    _, jp = _jax_mlp("pre")
    with pytest.raises(ValueError, match="batch_norm"):
        params_from_jax(jp, "tanh")


# ---------------------------------------------------------------------------
# Derivative taps
# ---------------------------------------------------------------------------


def _intended_taps(f, x, first, second):
    """The reference's taps in JAX: ``jax.vjp`` with a one-hot column
    cotangent (Jᵀ·1), nested for the second derivative."""
    def grads(z):
        y, pull = jax.vjp(f, z)
        k = y.shape[1]
        return y, [pull(jnp.zeros_like(y).at[:, c].set(1.0))[0]
                   for c in range(k)]

    def column(gs, a):
        return jnp.concatenate([g[:, a:a + 1] for g in gs], 1)

    y, gs = grads(x)
    seconds = []
    for a in second:
        ca, pull = jax.vjp(lambda z: column(grads(z)[1], a), x)
        seconds.append(column([pull(jnp.zeros_like(ca).at[:, c].set(1.0))[0]
                               for c in range(ca.shape[1])], a))
    return y, [column(gs, a) for a in first], seconds


@pytest.mark.parametrize("batch_norm", ["pre", "post"])
@pytest.mark.parametrize("functional", [False, True])
def test_bn_taps_are_the_intended_ones(batch_norm, functional):
    """u, u_t and u_xx of a train-mode BN MLP (2 → 16×2 → 2, B = 8) on
    either route equal the intended JAX taps (``jax.vjp`` with a ones
    cotangent) to rtol 1e-5 / atol 1e-5 (second derivatives of order 10)."""
    jm, jp = _jax_mlp(batch_norm, D=2, O=2)
    st = jm.init_state()
    m = params_from_jax(jp, "tanh", batch_norm=batch_norm)
    x = _x(8)
    f = lambda z: jm.apply(jp, z, state=st, train=True)[0]  # noqa: E731
    want = _intended_taps(f, x, first=(1,), second=(0,))
    if functional:
        with functional_taps():
            got = coordinate_taps(m, _t(x), first=(1,), second=(0,))
    else:
        got = coordinate_taps(m, _t(x), first=(1,), second=(0,))
    for g, w in zip([got[0], *got[1], *got[2]], [want[0], *want[1],
                                                 *want[2]]):
        np.testing.assert_allclose(g.detach().numpy(), w, rtol=1e-5,
                                   atol=1e-5)


def test_jax_taps_of_a_bn_net_differ_from_the_reference():
    """The JAX package's batched jvp (J·1) of a pre-BN MLP's ∂u/∂t is ≈ 0
    (the first BatchNorm removes a uniform shift of every row), where the
    reference's Jᵀ·1, the port's, is of order 1; for a post-BN MLP the
    other way round (a BN output's rows sum to a constant). Setup of the
    issue's measurement: 2 → 16×2 → 1 tanh, B = 8, ∂u/∂t."""
    x = _x(8)
    for batch_norm, jax_small in (("pre", True), ("post", False)):
        jm, jp = _jax_mlp(batch_norm)
        st = jm.init_state()
        f = lambda z: jm.apply(jp, z, state=st, train=True)[0]  # noqa: E731
        _, jvp_t = jax_diff.value_dt(f, jnp.asarray(x), t_axis=1)
        m = params_from_jax(jp, "tanh", batch_norm=batch_norm)
        _, (port_t,), _ = coordinate_taps(m, _t(x), first=(1,))
        jvp_max = float(jnp.max(jnp.abs(jvp_t)))
        port_max = float(port_t.detach().abs().max())
        small, large = (jvp_max, port_max) if jax_small else (port_max,
                                                              jvp_max)
        assert small < 1e-5, (batch_norm, small)
        assert large > 1e-2, (batch_norm, large)


@pytest.mark.parametrize("model", ["mlp", "fourier", "dgm", "resnet"])
def test_functional_taps_equal_todays_route(model):
    """For nets whose rows are independent the two routes give the same
    numbers (bit for bit here), the first and second derivatives too."""
    g = generator(7)
    if model == "dgm":
        net = PROBLEMS["fitzhugh_nagumo"]().default_model(generator=g)
        x = torch.rand((B, 1), generator=g)
        first, second = (0,), (0,)
    else:
        net = {"mlp": lambda: MLP(2, 2, H, L, "tanh", generator=g),
               "fourier": lambda: MLP(2, 1, H, L, "tanh", None, 4,
                                      generator=g),
               "resnet": lambda: ResNet(hidden_size=8, n_blocks=2,
                                        generator=g).eval()}[model]()
        x = torch.rand((B, 2), generator=g)
        first, second = (1,), (0,)
    a = coordinate_taps(net, x, first=first, second=second)
    with functional_taps():
        b = coordinate_taps(net, x, first=first, second=second)
    for u, v in zip([a[0], *a[1], *a[2]], [b[0], *b[1], *b[2]]):
        np.testing.assert_allclose(u.detach().numpy(), v.detach().numpy(),
                                   rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# The scan trainer's stateful path
# ---------------------------------------------------------------------------


def _intended_heat_taps(monkeypatch):
    """The JAX heat residual on the intended (vjp) taps: test-local, the
    JAX package itself is not changed."""
    def value_dt(f, x, t_axis=0):
        y, (d,), _ = _intended_taps(f, x, (t_axis,), ())
        return y, d

    def value_dx_dxx(f, x, x_axis=0):
        y, (d,), (dd,) = _intended_taps(f, x, (x_axis,), (x_axis,))
        return y, d, dd

    monkeypatch.setattr(jax_heat, "value_dt", value_dt)
    monkeypatch.setattr(jax_heat, "value_dx_dxx", value_dx_dxx)


@pytest.mark.parametrize("batch_norm", ["pre", "post"])
def test_stateful_steps_match_jax(batch_norm, monkeypatch):
    """K = 10 Adam steps of a BN MLP on heat, identical batches: the port's
    ``make_train_step`` against the JAX trainer's step (the loss on
    train-mode statistics, optax Adam, then ``update_state`` on the
    domain batch with the updated parameters; JAX train/trainer.py:
    201-211) on the intended taps. Losses rtol 1e-4, parameters atol 1e-5
    + 2·lr, running statistics rtol 1e-4 / atol 1e-5. tanh, not relu: a
    post-BN net's taps are rounding noise on both sides (the rows of its
    last BatchNorm sum to a constant, so Jᵀ·1 of the linear head is 0), and
    a dead relu unit, which the IC and BC terms do not move, would get
    only that noise, which Adam turns into steps of lr in any direction."""
    _intended_heat_taps(monkeypatch)
    jm, jp = _jax_mlp(batch_norm)
    jprob, prob = JAX_PROBLEMS["heat"](), Heat1D()
    u = np.random.default_rng(0).uniform(size=(K, B, 2)).astype(np.float32)
    tb = [prob.batch_from_uniforms(_t(uk)) for uk in u]
    nb = [{k: v.numpy() for k, v in b.items()} for b in tb]

    opt = optax.adam(LR, b1=0.9, b2=0.999, eps=1e-8)
    jstate, ost = jm.init_state(), opt.init(jp)

    @jax.jit
    def jstep(p, s, o, batch):
        loss, g = jax.value_and_grad(
            lambda q: jprob.loss(jax_train_apply(jm, s), q, batch))(p)
        upd, o = opt.update(g, o, p)
        p = optax.apply_updates(p, upd)
        return p, jax_update_state(jm, p, s, batch["xt"]), o, loss

    want = []
    for b in nb:
        jp2, jstate, ost, loss = jstep(jp, jstate, ost, b)
        jp = jp2
        want.append(float(loss))
    m = params_from_jax(_np(_jax_mlp(batch_norm)[1]), "tanh",
                        batch_norm=batch_norm)
    config = TrainConfig(iterations=K, batch_size=B, lrate=LR)
    step = make_train_step(prob, m, trainer_mod.make_optimizer(
        config, m.parameters()), B)
    got = [float(step(b)) for b in tb]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    tree = params_to_jax(m)
    for layer in tree:
        for leaf in tree[layer]:
            np.testing.assert_allclose(tree[layer][leaf],
                                       np.asarray(jp[layer][leaf]), rtol=0,
                                       atol=1e-5 + 2 * LR,
                                       err_msg=f"{layer}.{leaf}")
    got_state = state_to_jax(m)
    for k in ("mean", "var"):
        np.testing.assert_allclose(got_state[k], np.asarray(jstate[k]),
                                   rtol=1e-4, atol=1e-5)


def test_train_carries_the_running_statistics():
    """``train`` of a BN model returns it with its statistics moved off
    their init, and an eval-mode grid that differs from the train-mode
    forward on the same grid."""
    m = MLP(2, 1, H, L, "relu", "pre", generator=generator(1))
    res = train(Heat1D(), 3, TrainConfig(iterations=30, batch_size=B,
                                         verbose=False), model=m,
                device="cpu")
    assert res.params is m and np.all(np.isfinite(res.loss_history))
    assert float(m.bn.mean.abs().max()) > 1e-3
    assert float((m.bn.var - 1).abs().max()) > 1e-3
    prob = Heat1D()
    grid = prob.evaluate(m, 6)
    with torch.no_grad():
        train_grid = m(prob.grid_inputs(6)).numpy().reshape(6, 6)
    assert np.all(np.isfinite(grid)) and m.training
    assert np.max(np.abs(grid - train_grid)) > 1e-4


def test_stateful_graph_capture_restores_buffers():
    """The scan graph's warm-up step must leave the model's buffers as it
    found them: the capture saves and restores them with the parameters
    (checked here through the step math the capture runs: one step then a
    restore equals no step)."""
    m = MLP(2, 1, H, L, "relu", "post", generator=generator(2))
    before = {k: v.clone() for k, v in m.named_buffers()}
    prob = Heat1D()
    config = TrainConfig(iterations=1, batch_size=B)
    step = make_train_step(prob, m, trainer_mod.make_optimizer(
        config, m.parameters()), B)
    step(prob.sample(B, generator(0)))
    assert any(not torch.equal(before[k], v) for k, v in m.named_buffers())


# ---------------------------------------------------------------------------
# FitzHugh–Nagumo's Fourier-feature arch
# ---------------------------------------------------------------------------


def test_fitzhugh_nagumo_fourier_mlp_is_the_jax_arch():
    """MLP 1 → 128×3 → 2, tanh, 16 features at σ = 0.1 (JAX
    fitzhugh_nagumo.py:50-86), soft and hard; its loss on the JAX model's
    parameters equals the JAX loss."""
    prob = FitzHughNagumo(arch="fourier_mlp")
    net = prob.default_model(generator=generator(0))
    assert isinstance(net, MLP) and (net.input_dim, net.output_dim,
                                     net.hidden_size, net.num_layers,
                                     net.fourier_features) == (1, 2, 128, 3,
                                                               16)
    assert net.fourier_scale == 0.1 and net.activation == "tanh"
    hard = FitzHughNagumo(arch="fourier_mlp",
                          constraint="hard").default_model()
    assert isinstance(hard, HardConstraint) and hard.net.fourier_features
    jprob = JAX_PROBLEMS["fitzhugh_nagumo"](arch="fourier_mlp",
                                            causal_eps=0.0)
    jm = jprob.default_model()
    jp = _np(jm.init(jax.random.key(0)))
    u = np.random.default_rng(3).uniform(size=(B, 1)).astype(np.float32)
    p2 = FitzHughNagumo(arch="fourier_mlp", causal_eps=0.0)
    batch = p2.batch_from_uniforms(_t(u))
    want = float(jprob.loss(jm.apply, jp,
                            {k: v.numpy() for k, v in batch.items()}))
    got = float(p2.loss(params_from_jax(jp, "tanh"), batch))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_fitzhugh_nagumo_fourier_mlp_solves_on_the_scan_engine():
    res = solve("fitzhugh_nagumo", arch="fourier_mlp", iterations=4,
                nodes=6, device="cpu", seed=42)
    assert res.loss_history.shape == (4,)
    assert res.solution.shape == (6, 2) and np.all(np.isfinite(res.solution))


# ---------------------------------------------------------------------------
# The fused routes refuse BatchNorm and Fourier-feature MLPs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["pre", "post", "fourier"])
def test_fused_routes_refuse_bn_and_fourier(kind):
    """Kernel #1 (the heat trainer), #2 (the grid forward), #3 (the heat
    streams) and the MLP engine's spec refuse the model with a ValueError
    before anything launches; solve(engine="fused") raises the JAX
    package's ValueError naming the scan engine."""
    bn = kind if kind != "fourier" else None
    F = 4 if kind == "fourier" else 0
    m = MLP(2, 1, H, L, "tanh", bn, F, generator=generator(0))
    x = torch.rand((5, 2), generator=generator(1))
    with pytest.raises(ValueError, match="plain MLP"):
        tm.mlp_forward(m, x)
    with pytest.raises(ValueError, match="plain"):
        tm.heat_fused_streams(m, x, x, x, x)
    with pytest.raises(ValueError, match="plain tanh MLPs"):
        ft._check_model(m)
    assert not fe.spec_for(Heat1D()).supports_model(m)
    with pytest.raises(ValueError, match="scan"):
        _fused_route(Heat1D(), m)
    with pytest.raises(ValueError, match="scan"):
        solve("heat", engine="fused", model=m, device="cpu", iterations=2)
    with pytest.raises(ValueError, match="scan engine"):
        solve("fitzhugh_nagumo", arch="fourier_mlp", engine="fused",
              device="cpu", iterations=2)


@pytest.mark.parametrize("name", ["heat", "uat", "inverse_heat",
                                  "fitzhugh_nagumo"])
def test_evaluate_takes_kernel_2_for_plain_nets(name, monkeypatch):
    """A plain MLP, the Perceptron and the inverse model's net evaluate
    through kernel #2's wrapper (its plain version on the CPU), a DGM and
    the stateful and Fourier models through their own forward."""
    calls = []
    real = tm.mlp_forward

    def spy(model, x):
        calls.append(type(model).__name__)
        return real(model, x)

    monkeypatch.setattr(tm, "mlp_forward", spy)
    prob = PROBLEMS[name]()
    prob.evaluate(prob.default_model(generator=generator(0)), 5)
    assert len(calls) == (0 if name == "fitzhugh_nagumo" else 1)


@pytest.mark.parametrize("kind", ["pre", "fourier", "resnet"])
def test_evaluate_runs_the_models_own_forward(kind):
    """Problem.evaluate of a stateful model runs its eval mode (the JAX
    package's eval_apply); a Fourier MLP and a ResNet their own forward."""
    prob = Heat1D()
    if kind == "resnet":
        m = ResNet(hidden_size=8, n_blocks=1, generator=generator(0))
    else:
        m = MLP(2, 1, H, L, "tanh", "pre" if kind == "pre" else None,
                4 if kind == "fourier" else 0, generator=generator(0))
    update_state(m, prob.sample(B, generator(1))["xt"])
    grid = prob.evaluate(m, 5)
    with eval_mode(m), torch.no_grad():
        want = m(prob.grid_inputs(5)).numpy().reshape(5, 5)
    np.testing.assert_array_equal(grid, want)
    assert m.training
