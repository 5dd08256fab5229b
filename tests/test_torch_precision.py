"""The fused trainers' bf16 precisions ("default" and "mixed",
core/precision.py) against the JAX package, on the CPU.

XLA on the CPU ignores ``Precision.DEFAULT`` (the JAX package's "default"
equals its "highest" there), so ``tpu_default`` emulates a TPU's DEFAULT
inside the test: ``jax.numpy.dot`` and ``jax.lax.dot_general`` round both
operands to bf16 (round to nearest even) when they are called with
``precision=Precision.DEFAULT`` and then multiply at HIGHEST; products at
HIGHEST (volterra's node sums, inverse_heat's observation rows, the DGM
losses' own products) and products without a precision are left as they
are. The JAX package itself is not touched, and its step math is called
directly, not through its Pallas kernels. Small sizes: H ≤ 32, L ≤ 2, B ≤
16, at most 20 steps.

Tolerance: the port's "default" step against the emulated JAX step, each
tensor to TOL = 1e-4 of its largest entry (both round the same operands, so
only fp32 summation order and the rare bf16 rounding flip of an operand
that the two frameworks compute an ulp apart separate them); and
"default" must differ from "highest" by more than 5·TOL.
"""

import math

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
    fused_dgm as jfd,
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
from differential_equations_dnn_tpu_torch.core import (  # noqa: E402
    generator,
    step_uniforms,
)
from differential_equations_dnn_tpu_torch.core import (  # noqa: E402
    precision as prec,
)
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    PROBLEMS,
    inverse_params_from_jax,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    engine_core,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_dgm as fd,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_engine as fe,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_train as ft,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    DGM,
    MLP,
    dgm_params_from_jax,
    hard_params_from_jax,
    params_from_jax,
)

H, L, B = 32, 2, 16
TOL = 1e-4
LR = 1e-3
_DEFAULT = jax.lax.Precision.DEFAULT


def _emulate(mp):
    """Patches ``jax.numpy.dot`` and ``jax.lax.dot_general`` on the
    MonkeyPatch ``mp``: both operands of a product called at
    Precision.DEFAULT are rounded to bf16, then multiplied at HIGHEST."""
    dot, dot_general = jnp.dot, jax.lax.dot_general

    def bf16(x):
        return jnp.asarray(x).astype(jnp.bfloat16).astype(jnp.float32)

    def emulated_dot(a, b, *args, precision=None, **kw):
        if precision == _DEFAULT:
            a, b, precision = bf16(a), bf16(b), jax.lax.Precision.HIGHEST
        return dot(a, b, *args, precision=precision, **kw)

    def emulated_dot_general(lhs, rhs, dimension_numbers, precision=None,
                             **kw):
        if precision == _DEFAULT:
            lhs, rhs = bf16(lhs), bf16(rhs)
            precision = jax.lax.Precision.HIGHEST
        return dot_general(lhs, rhs, dimension_numbers, precision=precision,
                           **kw)

    mp.setattr(jnp, "dot", emulated_dot)
    mp.setattr(jax.lax, "dot_general", emulated_dot_general)


@pytest.fixture
def tpu_default(monkeypatch):
    """A TPU's Precision.DEFAULT on the CPU (:func:`_emulate`)."""
    _emulate(monkeypatch)


def _jit(fn):
    """fn, jitted through a lambda of its own (so no trace of ``fn`` made
    without the emulation is reused): one XLA program instead of hundreds
    of eager dispatches."""
    return jax.jit(lambda *args: fn(*args))


def _uniforms(n, shape, seed=0):
    return np.random.default_rng(seed).uniform(size=shape + (n,)).astype(
        np.float32)


def _jax_mlp(D, seed):
    jm = JaxMLP(input_dim=D, output_dim=1, hidden_size=H, num_layers=L,
                activation="tanh")
    return jm, jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))


def _flat(grads):
    return np.concatenate([np.asarray(g, np.float32).reshape(-1)
                           for g in grads])


def _assert_default(ours_default, ours_highest, theirs, loss_pair):
    """Each port "default" tensor within TOL of its largest JAX entry; the
    loss to rtol TOL; "default" more than 5·TOL from "highest" over the
    whole gradient."""
    loss_t, loss_j = loss_pair
    np.testing.assert_allclose(np.asarray(loss_t, np.float32).reshape(()),
                               np.asarray(loss_j).reshape(()), rtol=TOL)
    for gt, gj in zip(ours_default, theirs):
        gt, gj = np.asarray(gt).reshape(np.shape(gj)), np.asarray(gj)
        if gj.size:
            np.testing.assert_allclose(gt, gj, rtol=0,
                                       atol=TOL * np.abs(gj).max())
    d, h = _flat(ours_default), _flat(ours_highest)
    assert np.abs(d - h).max() > 5 * TOL * np.abs(h).max()


# ---------------------------------------------------------------------------
# One step of each route's step math at "default"
# ---------------------------------------------------------------------------


def test_heat_step_math_matches_emulated_tpu(tpu_default):
    """Kernel #1's step math (fused_train.fused_step_math) at "default"
    against the JAX fused_step_math at DEFAULT."""
    jm, jp = _jax_mlp(2, 3)
    tm = params_from_jax(jp, "tanh")
    u = _uniforms(2, (B,), seed=3)
    loss_j, grads_j = _jit(lambda p, x: jft.fused_step_math(
        p, x, B, L, precision=_DEFAULT))(jft.pack_params(jm, jp),
                                         jnp.asarray(u))
    params = ft.unpack_params(tm, ft.pack_params(tm))
    ut = torch.from_numpy(u)
    loss_d, grads_d = ft.fused_step_math(params, ut, B, L,
                                         precision="default")
    _, grads_h = ft.fused_step_math(params, ut, B, L)
    _assert_default(grads_d, grads_h, grads_j, (loss_d, loss_j))


def _engine_case(name, seed):
    """(JAX spec, port spec, JAX flat state, port model) at the small
    sizes: a plain MLP, volterra at k = 8, inverse_heat on the JAX
    package's 20 observations, hard heat around its raw net, causal
    advection at c = 50, ε = 5."""
    if name == "hard_heat":
        jprob = JAX_PROBLEMS["heat"](constraint="hard")
        prob = PROBLEMS["heat"](constraint="hard")
        jnet, jp = _jax_mlp(2, seed)
        jm = jhard.HardConstraint(jnet, jprob.default_model().ansatz)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
        model = hard_params_from_jax(jp, prob.hard_ansatz())
        return (jfe.spec_for(jprob), fe.spec_for(prob),
                jft.pack_params(jm.net, jp), model)
    kw = {"advection": dict(c=50.0, causal_eps=5.0),
          "volterra": dict(k=8)}.get(name, {})
    jprob, prob = JAX_PROBLEMS[name](**kw), PROBLEMS[name](**kw)
    if name == "inverse_heat":
        jprob = JAX_PROBLEMS[name](n_obs=20)
        xt, uu = (np.asarray(a) for a in jprob.observations())
        prob = PROBLEMS[name](n_obs=20, obs_data=(xt, uu))
    D = {"heat2d": 3, "volterra": 1}.get(name, 2)
    jnet, jp = _jax_mlp(D, seed)
    jspec = jfe.spec_for(jprob)
    if name == "inverse_heat":
        jm = type(jprob.default_model())(jnet)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
        model = inverse_params_from_jax(jp)
        return jspec, fe.spec_for(prob), jfe._pack_fn(jspec, jm)(jp), model
    return (jspec, fe.spec_for(prob), jft.pack_params(jnet, jp),
            params_from_jax(jp, "tanh"))


@pytest.mark.parametrize("name", ["wave", "heat2d", "volterra",
                                  "inverse_heat", "hard_heat", "advection"])
def test_engine_step_math_matches_emulated_tpu(tpu_default, name):
    """The MLP engine's step math (#6) at "default" against the JAX
    engine_step_math at DEFAULT: two soft specs, volterra (its node sums
    pinned to fp32 in both), inverse_heat (its observation rows pinned to
    fp32, log κ̂'s gradient too), a hard spec and causal advection (its
    ``earlier @ r`` without a precision)."""
    jspec, spec, flat_j, model = _engine_case(name, 4)
    u = _uniforms(spec.n_uniform, (B,), seed=4)
    loss_j, grads_j = _jit(lambda p, x: jfe.engine_step_math(
        jspec, p, x, B, L, precision=_DEFAULT))(flat_j, jnp.asarray(u))
    state = fe.unpack_state(spec, model, fe.pack_state(spec, model))
    ut = torch.from_numpy(u)
    loss_d, grads_d = fe.engine_step_math(spec, state, ut, B, L,
                                          precision="default")
    _, grads_h = fe.engine_step_math(spec, state, ut, B, L)
    _assert_default([g.detach() for g in grads_d],
                    [g.detach() for g in grads_h], grads_j,
                    (loss_d.detach(), loss_j))


@pytest.mark.parametrize("name", ["fitzhugh_nagumo", "fredholm"])
def test_dgm_step_math_matches_emulated_tpu(tpu_default, name):
    """The DGM engine's step math (#7) at "default" against the JAX
    dgm_step_math at DEFAULT: the gate products, x·U and its x-row
    gradients at bf16, the losses' own products at fp32."""
    act, scheme, O = {"fitzhugh_nagumo": ("tanh", "torch", 2),
                      "fredholm": ("relu", "xavier_relu", 1)}[name]
    kw = dict(k=12) if name == "fredholm" else {}
    jprob, prob = JAX_PROBLEMS[name](**kw), PROBLEMS[name](**kw)
    jm = JaxDGM(input_dim=1, output_dim=O, hidden_size=16, num_layers=L,
                activation=act, init_scheme=scheme)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(5)))
    model = dgm_params_from_jax(jp, act, scheme)
    jspec, spec = jfd.spec_for(jprob, B), fd.spec_for(prob, B)
    const = None
    if name == "fredholm":
        jconst = jfd._fredholm_const(jprob, B, jspec.n_groups)
        const = fd.const_for(spec, prob, B)
        base = jspec
        jspec = jfd.spec_with_build(base,
                                    lambda u: base.build(u, const=jconst))
    u = _uniforms(1, (B,), seed=5)
    loss_j, grads_j = _jit(lambda p, x: jfd.dgm_step_math(
        jspec, p, x, B, L, precision=_DEFAULT))(jfd.pack_dgm(jp),
                                                jnp.asarray(u))
    params = fd.unpack_dgm(model, fd.pack_dgm(model))
    ut = torch.from_numpy(u)
    loss_d, grads_d = fd.dgm_step_math(spec, params, ut, B, L, const,
                                       precision="default")
    _, grads_h = fd.dgm_step_math(spec, params, ut, B, L, const)
    _assert_default([g.detach() for g in grads_d],
                    [g.detach() for g in grads_h], grads_j,
                    (loss_d.detach(), loss_j))


def test_matmul_rounds_both_operands():
    """matmul at "default" is the fp32 product of the bf16-rounded
    operands (exact products, fp32 sums), and "highest" the plain one."""
    rng = np.random.default_rng(0)
    a = torch.from_numpy(rng.normal(size=(5, 7)).astype(np.float32))
    b = torch.from_numpy(rng.normal(size=(7, 3)).astype(np.float32))
    want = (a.to(torch.bfloat16).double() @ b.to(torch.bfloat16).double())
    got = prec.matmul(a, b, "default")
    torch.testing.assert_close(got.double(), want, rtol=1e-6, atol=1e-6)
    assert torch.equal(prec.matmul(a, b), a @ b)
    assert not torch.equal(got, a @ b)
    with pytest.raises(ValueError, match="unknown precision"):
        prec.matmul(a, b, "mixed")


# ---------------------------------------------------------------------------
# The mixed schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("K, precision, split, want", [
    (20, "mixed", 0.65, 13), (15000, "mixed", 0.65, 9750),
    (150000, "mixed", 0.65, 97500), (1, "mixed", 0.65, 0),
    (20, "mixed", 0.0, 0), (20, "mixed", 1.0, 0), (20, "default", 0.65, 20),
    (20, "highest", 0.65, 0)])
def test_default_steps(K, precision, split, want):
    """The "default" phase is int(K·split) steps, all K at "default", none
    at "highest"; "mixed" falls back to "highest" (0) where a phase would
    be empty, as the JAX package does."""
    assert prec.default_steps(K, precision, split) == want


def _small_mlp(D, seed=0):
    return MLP(D, 1, 16, 2, "tanh", generator=generator(seed))


_KW = dict(batch_size=8, lrate=LR, device="cpu")


def test_engine_mixed_is_default_then_highest():
    """A "mixed" run of the MLP engine (heat2d, cosine over its whole
    budget) equals a "default" run of its first n1 steps resumed at
    "highest" for the rest on one schedule horizon, bit for bit, and a
    chunked mixed run equals the uncut one."""
    prob, K = PROBLEMS["heat2d"](), 20
    n1 = prec.default_steps(K, "mixed")
    mixed = fe.train_fused_result(prob, 3, K, model=_small_mlp(3),
                                  precision="mixed", schedule="cosine", **_KW)
    chunked = fe.train_fused_result(prob, 3, K, model=_small_mlp(3),
                                    precision="mixed", schedule="cosine",
                                    chunk_size=6, **_KW)
    first = fe.train_fused_result(prob, 3, n1, model=_small_mlp(3),
                                  precision="default", schedule="cosine",
                                  total_steps=K, **_KW)
    spec = fe.spec_for(prob)
    rest = fe.train_fused_result(
        prob, 3, K - n1, model=_small_mlp(3),
        params=fe.pack_state(spec, first.params), opt_state=first.opt_state,
        start_step=n1, precision="highest", schedule="cosine", total_steps=K,
        **_KW)
    want = np.concatenate([first.loss_history, rest.loss_history])
    np.testing.assert_array_equal(mixed.loss_history, want)
    np.testing.assert_array_equal(chunked.loss_history, want)
    for run in (mixed, chunked):
        assert torch.equal(fe.pack_state(spec, run.params),
                           fe.pack_state(spec, rest.params))
        assert torch.equal(run.opt_state["v"], rest.opt_state["v"])


def test_dgm_mixed_is_default_then_highest():
    """The same for the DGM engine (FitzHugh–Nagumo at H = 8, L = 1)."""
    prob, K = PROBLEMS["fitzhugh_nagumo"](), 12
    n1 = prec.default_steps(K, "mixed")

    def model():
        return DGM(1, 2, 8, 1, "tanh", "torch", generator=generator(2))

    kw = dict(batch_size=8, lrate=LR, device="cpu")
    mixed = fd.train_dgm_fused_result(prob, 1, K, model=model(),
                                      precision="mixed", chunk_size=5, **kw)
    first = fd.train_dgm_fused_result(prob, 1, n1, model=model(),
                                      precision="default", total_steps=K,
                                      **kw)
    rest = fd.train_dgm_fused_result(
        prob, 1, K - n1, model=model(), params=fd.pack_dgm(first.params),
        opt_state=first.opt_state, start_step=n1, precision="highest",
        total_steps=K, **kw)
    np.testing.assert_array_equal(
        mixed.loss_history,
        np.concatenate([first.loss_history, rest.loss_history]))
    assert torch.equal(fd.pack_dgm(mixed.params), fd.pack_dgm(rest.params))


def test_mixed_lr_curve_is_the_uncut_one(monkeypatch):
    """A cosine "mixed" run's learning rates equal a "highest" run's, step
    for step: both phases decay over one horizon (the JAX package's
    ``total_steps``)."""
    seen = {}
    real = engine_core.scheduled_lr

    def spy(lrate, t, schedule="constant", horizon=1.0, decay=0.1):
        lr = real(lrate, t, schedule, horizon, decay)
        seen.setdefault(key, []).append((float(t), float(lr)))
        return lr

    monkeypatch.setattr(engine_core, "scheduled_lr", spy)
    prob, K = PROBLEMS["wave"](), 10
    for key in ("mixed", "highest"):
        fe.train_fused_result(prob, 0, K, model=_small_mlp(2),
                              precision=key, schedule="cosine", **_KW)
    # The warm-up step (one per phase) comes first; the K training steps
    # follow.
    assert seen["mixed"][-K:] == seen["highest"][-K:]
    assert [t for t, _ in seen["mixed"][-K:]] == [float(k + 1)
                                                  for k in range(K)]
    lrs = [lr for _, lr in seen["mixed"][-K:]]
    assert lrs[-1] < 0.5 * lrs[0]


def test_heat_mixed_matches_composed_jax(monkeypatch):
    """Kernel #1's "mixed" trainer (12 steps, 7 at "default") against a
    composed JAX reference on the same uniforms and parameters: the JAX
    fused_step_math under the DEFAULT emulation and its _adam_update for
    the first 7 steps, the emulation switched off for the last 5. Losses to
    rtol TOL; parameters to rtol TOL plus 2·lr (an Adam step on a gradient
    within rounding of zero can move a parameter by up to 2·lr either
    way)."""
    K, Bh = 12, 8
    n1 = prec.default_steps(K, "mixed")
    assert n1 == 7
    prob = PROBLEMS["heat"]()
    tm = MLP(2, 1, 16, 2, "tanh", generator=generator(6))
    p0 = ft.pack_params(tm)
    flat = tuple(t.detach().numpy().copy() for t in ft.unpack_params(tm, p0))
    res = ft.train_heat_fused_result(prob, 6, K, batch_size=Bh, lrate=LR,
                                     model=tm, precision="mixed",
                                     device="cpu")
    u = step_uniforms(6, 0, K, Bh, "cpu").numpy()
    m = v = tuple(np.zeros_like(t) for t in flat)
    losses = []

    def step(precision):
        return _jit(lambda p, x: jft.fused_step_math(
            p, x, Bh, 2, prob.x_max, prob.t_max, prob.kappa,
            precision=precision))

    adam = _jit(lambda *args: jft._adam_update(*args))
    with pytest.MonkeyPatch.context() as mp:
        _emulate(mp)
        coarse = step(_DEFAULT)
        for k in range(K):
            if k == n1:
                mp.undo()
                fine = step(jax.lax.Precision.HIGHEST)
            loss, grads = (coarse if k < n1 else fine)(flat,
                                                       jnp.asarray(u[k]))
            new = [adam(*args, LR, jnp.float32(k + 1))
                   for args in zip(flat, m, v, grads)]
            flat, m, v = (tuple(np.asarray(t[i]) for t in new)
                          for i in range(3))
            losses.append(float(loss))
    np.testing.assert_allclose(res.loss_history, losses, rtol=TOL)
    got = ft.pack_params(res.params).numpy()
    np.testing.assert_allclose(got, np.concatenate([t.reshape(-1)
                                                    for t in flat]),
                               rtol=TOL, atol=2 * LR)


@pytest.mark.parametrize("call", [
    lambda: solve("heat", engine="fused", device="cpu", iterations=2,
                  batch_size=8, nodes=5, precision="bf16"),
    lambda: solve("wave", engine="fused", device="cpu", ensemble=2,
                  iterations=2, batch_size=8, nodes=5, precision="fp16"),
    lambda: ft.heat_fused_train_chunk(
        _small_mlp(2), ft.pack_params(_small_mlp(2)),
        torch.zeros(ft.pack_params(_small_mlp(2)).numel()),
        torch.zeros(ft.pack_params(_small_mlp(2)).numel()),
        torch.rand(2, 8, 2), 0, LR, precision="mixed"),
], ids=["solve", "ensemble", "chunk_mixed"])
def test_unknown_precision_raises(call):
    """An unknown precision raises a ValueError before anything trains; a
    chunk takes "highest" or "default" (a "mixed" run is a schedule of
    chunks)."""
    with pytest.raises(ValueError, match="unknown precision"):
        call()


def test_solve_runs_every_precision():
    """solve(..., engine="fused", precision=p) on the CPU for the three
    precisions on heat's kernel route: "highest" is the parent's run, and
    the two bf16 modes train to other, finite losses."""
    kw = dict(engine="fused", device="cpu", iterations=6, batch_size=8,
              nodes=5, seed=1)
    runs = {p: solve("heat", model=_small_mlp(2, 1), precision=p, **kw)
            for p in prec.PRECISIONS}
    for res in runs.values():
        assert np.all(np.isfinite(res.loss_history))
    assert not np.array_equal(runs["default"].loss_history,
                              runs["highest"].loss_history)
    n1 = prec.default_steps(6, "mixed")
    np.testing.assert_array_equal(runs["mixed"].loss_history[:n1],
                                  runs["default"].loss_history[:n1])
    assert math.isfinite(runs["mixed"].mae)
