"""The port's generic fused engine (kernels/fused_engine.py, engine_core.py)
against the JAX package's kernels/fused_engine.py, on the same numpy
uniforms and parameters; the JAX chunk runs its Pallas kernel in interpret
mode on the CPU, as the JAX package's own tests run it. Small sizes: H=16,
L=2, B=16, K=8."""

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
    fused_engine as jfe,
)
from differential_equations_dnn_tpu.kernels import (  # noqa: E402
    fused_train as jft,
)
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu_torch.core import (  # noqa: E402
    generator,
    step_uniforms,
)
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    PROBLEMS,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    engine_core,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_engine as fe,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_train as ft,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    MLP,
    params_from_jax,
)

H, L, B, K = 16, 2, 16, 8
LR = 1e-3
# The specs of a plain MLP D → H×L → 1; volterra, uat and inverse_heat
# (other models, a const operand, an extra tensor) have their own file,
# test_torch_last_specs.py.
LAST_SPECS = ("volterra", "uat", "inverse_heat")
SPEC_NAMES = sorted(set(fe.SPECS) - set(LAST_SPECS))
_DIM = {"simple_ode": 1, "heat2d": 3}


def _pair(name, seed=0, hidden=H):
    """A JAX MLP's parameters and the same parameters as a port MLP."""
    jm = JaxMLP(input_dim=_DIM.get(name, 2), output_dim=1, hidden_size=hidden,
                num_layers=L, activation="tanh")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, jp, params_from_jax(jp, "tanh")


def _uniforms(spec, shape, seed=0):
    return np.random.default_rng(seed).uniform(
        size=shape + (spec.n_uniform,)).astype(np.float32)


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_step_math_matches_jax(name):
    """(a) One step's loss and 6 gradients against JAX engine_step_math on
    the same points: fp32 reassociation of R·B-row sums, loss rtol 1e-5,
    gradients rtol 1e-5 / atol 1e-6 of the tensor's largest entry (at
    least 1e-6: advection's c = 2π gives entries near 10, and the sums'
    order moves their near-zero neighbours by more than 1e-6)."""
    jm, jp, tm = _pair(name)
    jspec = jfe.spec_for(JAX_PROBLEMS[name]())
    spec = fe.spec_for(PROBLEMS[name]())
    u = _uniforms(spec, (B,))
    loss_j, grads_j = jfe.engine_step_math(jspec, jft.pack_params(jm, jp),
                                           jnp.asarray(u), B, L)
    loss_t, grads_t = fe.engine_step_math(
        spec, ft.unpack_params(tm, ft.pack_params(tm)), torch.from_numpy(u),
        B, L)
    assert loss_t.shape == (1, 1)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-5)
    for gt, gj in zip(grads_t, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(gj).max()))


@pytest.mark.parametrize("name", ["heat2d", "wave"])
def test_step_math_matches_jax_at_width_256(name):
    """(a) At H = 256, a width the H100 engine took only after its k-tiled
    redesign: the port's plain step math against JAX engine_step_math (its
    plain form, no Pallas) on B = 8 points, tolerances as at H = 16."""
    jm, jp, tm = _pair(name, seed=5, hidden=256)
    jspec = jfe.spec_for(JAX_PROBLEMS[name]())
    spec = fe.spec_for(PROBLEMS[name]())
    u = _uniforms(spec, (8,), seed=5)
    loss_j, grads_j = jfe.engine_step_math(jspec, jft.pack_params(jm, jp),
                                           jnp.asarray(u), 8, L)
    loss_t, grads_t = fe.engine_step_math(
        spec, ft.unpack_params(tm, ft.pack_params(tm)), torch.from_numpy(u),
        8, L)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-5)
    for gt, gj in zip(grads_t, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(gj).max()))


@pytest.mark.parametrize("name", SPEC_NAMES)
def test_step_math_matches_autograd(name):
    """(b) The hand-derived backward against torch.autograd of the port
    equation's own loss (jvp taps) at the points the spec builds: the
    Taylor algebra and the jvp-over-jvp taps agree to fp32 reassociation
    (loss rtol 1e-5; gradients rtol 1e-4 / atol 1e-6)."""
    _, _, tm = _pair(name, seed=1)
    prob = PROBLEMS[name]()
    spec = fe.spec_for(prob)
    u = torch.from_numpy(_uniforms(spec, (B,), seed=1))
    loss_a = prob.loss(tm, prob.batch_from_uniforms(u))
    grads_a = torch.autograd.grad(loss_a, list(ft._tensors(tm)))
    loss_h, grads_h = fe.engine_step_math(
        spec, ft.unpack_params(tm, ft.pack_params(tm)), u, B, L)
    torch.testing.assert_close(loss_h.reshape(()), loss_a.detach(),
                               rtol=1e-5, atol=0)
    for gh, ga in zip(grads_h, grads_a):
        torch.testing.assert_close(gh, ga, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", ["heat", "wave"])
@pytest.mark.parametrize("schedule", list(engine_core.SCHEDULES))
def test_chunk_matches_jax(name, schedule):
    """(c) K=8 Adam steps from step0=5 inside a 20-step horizon, against
    JAX fused_engine_chunk (Pallas, interpret mode): losses and all
    parameters and moments to rtol 1e-5 / atol 1e-6."""
    jm, jp, tm = _pair(name, seed=2)
    jspec = jfe.spec_for(JAX_PROBLEMS[name]())
    spec = fe.spec_for(PROBLEMS[name]())
    u = _uniforms(spec, (K, B), seed=2)
    kw = dict(schedule=schedule, total_steps=20, decay=0.1)
    flat = jft.pack_params(jm, jp)
    zeros = tuple(jnp.zeros_like(t) for t in flat)
    pj, mj, vj, lj = jfe.fused_engine_chunk(jspec, jm, flat, zeros, zeros,
                                            jnp.asarray(u), 5, LR, **kw)
    p = ft.pack_params(tm)
    z = torch.zeros_like(p)
    pt, mt, vt, lt = fe.fused_engine_chunk(spec, tm, p, z, z,
                                           torch.from_numpy(u), 5, LR, **kw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-6)
    for ours, theirs in ((pt, pj), (mt, mj), (vt, vj)):
        for a, b in zip(ft.unpack_params(tm, ours), theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_chunked_run_is_bit_identical():
    """(d) Two chunks (step0 = 0, 3) equal one chunk of 8, bit for bit,
    under a decaying schedule."""
    _, _, tm = _pair("wave", seed=3)
    spec = fe.spec_for(PROBLEMS["wave"]())
    u = torch.from_numpy(_uniforms(spec, (K, B), seed=3))
    kw = dict(schedule="cosine", total_steps=K)
    p = ft.pack_params(tm)
    z = torch.zeros_like(p)
    p8, m8, v8, l8 = fe.fused_engine_chunk(spec, tm, p, z, z, u, 0, LR, **kw)
    p3, m3, v3, l3 = fe.fused_engine_chunk(spec, tm, p, z, z, u[:3], 0, LR,
                                           **kw)
    p3, m3, v3, l5 = fe.fused_engine_chunk(spec, tm, p3, m3, v3, u[3:], 3, LR,
                                           **kw)
    assert torch.equal(torch.cat([l3, l5]), l8)
    for a, b in ((p3, p8), (m3, m8), (v3, v8)):
        assert torch.equal(a, b)


def test_resumed_training_is_bit_identical():
    """(d) train_fused_result resumed from params, opt_state and
    start_step equals the uncut run bit for bit (the first leg declares
    the full horizon)."""
    prob = PROBLEMS["poisson"]()
    kw = dict(batch_size=8, lrate=LR, device="cpu")

    def model():
        return MLP(2, 1, H, L, "tanh", generator=generator(4))

    full = fe.train_fused_result(prob, 4, 8, model=model(), **kw)
    first = fe.train_fused_result(prob, 4, 4, model=model(), total_steps=8,
                                  chunk_size=3, **kw)
    second = fe.train_fused_result(prob, 4, 4, model=model(),
                                   params=ft.pack_params(first.params),
                                   opt_state=first.opt_state, start_step=4,
                                   **kw)
    np.testing.assert_array_equal(
        np.concatenate([first.loss_history, second.loss_history]),
        full.loss_history)
    assert torch.equal(ft.pack_params(second.params),
                       ft.pack_params(full.params))
    assert torch.equal(second.opt_state["m"], full.opt_state["m"])


@pytest.mark.parametrize("schedule", list(engine_core.SCHEDULES))
def test_scheduled_lr_matches_fp32_formula(schedule):
    """The per-step lr against the JAX kernel's formulas evaluated in numpy
    fp32 (engine_core.py:128-151), before, at and past the horizon."""
    f32 = np.float32
    lr, horizon, decay = 1e-3, 50, 0.1
    for step in (1, 2, 26, 50, 51, 80):
        t = f32(step)
        frac = np.minimum((t - f32(1.0)) / f32(horizon), f32(1.0))
        want = {
            "constant": f32(lr),
            "cosine": f32(lr) * (f32(decay) + f32((1.0 - decay) * 0.5)
                                 * (f32(1.0) + np.cos(f32(math.pi) * frac))),
            "exponential": f32(lr) * np.exp(
                ((t - f32(1.0)) / f32(horizon)) * f32(math.log(decay))),
        }[schedule]
        got = engine_core.scheduled_lr(
            lr, torch.tensor(step, dtype=torch.float32), schedule, horizon,
            decay)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_train_fused_result_trains():
    prob = PROBLEMS["simple_ode"]()
    res = fe.train_fused_result(prob, 0, 200, batch_size=16, lrate=3e-3,
                                device="cpu")
    assert res.loss_history.shape == (200,)
    assert res.loss_history[-20:].mean() < res.loss_history[:20].mean() / 10
    assert res.compile_time > 0 and res.iters_per_sec > 0
    assert set(res.opt_state) == {"m", "v"}


@pytest.mark.parametrize("option, value", [
    ("runtime_bs", 8), ("runtime_steps", 4), ("const", torch.zeros(2)),
])
def test_unported_chunk_options_raise(option, value):
    """The sweep evaluators' runtime options run: a batch
    mask of 8 rows of 16 equals the unmasked chunk on those 8 rows (rtol
    1e-5 / atol 1e-6), and a budget of 4 of 6 steps equals a 4-step chunk
    bit for bit with losses 0 after it. The const operand is ported, and one
    of the wrong shape (heat's spec takes none; volterra's is [k, 2])
    raises a ValueError before anything runs."""
    _, _, tm = _pair("heat")
    spec = fe.spec_for(PROBLEMS["heat"]())
    p = ft.pack_params(tm)
    u = torch.zeros(2, B, 2)
    if option == "const":
        with pytest.raises(ValueError, match="takes no const"):
            fe.fused_engine_chunk(spec, tm, p, p, p, u, 0, LR, const=value)
        prob = PROBLEMS["volterra"](k=8)
        vspec = fe.spec_for(prob)
        model = prob.default_model(generator=generator(0))
        vp = fe.pack_state(vspec, model)
        with pytest.raises(ValueError, match=r"shape \(8, 2\)"):
            fe.fused_engine_chunk(vspec, model, vp, vp, vp,
                                  torch.zeros(2, B, 1), 0, LR, const=value)
        return
    u = torch.from_numpy(_uniforms(spec, (6, B), seed=7))
    z = torch.zeros_like(p)
    got = fe.fused_engine_chunk(spec, tm, p, z, z, u, 0, LR,
                                **{option: value})
    if option == "runtime_bs":
        want = fe.fused_engine_chunk(spec, tm, p, z, z,
                                     u[:, :value].contiguous(), 0, LR)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
        return
    want = fe.fused_engine_chunk(spec, tm, p, z, z, u[:value], 0, LR)
    for a, b in zip(got[:3], want[:3]):
        assert torch.equal(a, b)
    assert torch.equal(got[3][:value], want[3]) and not got[3][value:].any()


def test_chunk_checks_its_inputs():
    _, _, tm = _pair("heat")
    spec = fe.spec_for(PROBLEMS["heat"]())
    p = ft.pack_params(tm)
    with pytest.raises(ValueError, match="divisible"):
        fe.fused_engine_chunk(spec, tm, p, p, p, torch.zeros(1, 24, 2), 0,
                              LR, batch_tile=16)
    with pytest.raises(ValueError, match="unknown schedule"):
        fe.fused_engine_chunk(spec, tm, p, p, p, torch.zeros(1, B, 2), 0, LR,
                              schedule="linear")
    with pytest.raises(ValueError, match="tanh"):
        relu = MLP(2, 1, H, L, "relu")
        fe.fused_engine_chunk(spec, relu, p, p, p, torch.zeros(1, B, 2), 0,
                              LR)
    with pytest.raises(ValueError, match="3 → H×L → 1"):
        fe.engine_loss_grad(fe.spec_for(PROBLEMS["heat2d"]()), tm, p,
                            torch.zeros(B, 4))


def test_state_fits_the_h100_rule():
    """The rule holds the kernels' shared memory per block (which the
    library reports and fused_engine.engine_plan mirrors;
    tests/test_torch_gpu.py checks the two agree) to the H100's 227 KB: the
    k-tiled plan fits heat2d's 11 streams at H = 256 and 512, a plan past
    227 KB raises, and so does a width past MAX_WIDTH. The plain version
    has no such limit: heat2d's 11 streams at H=256 run on the CPU."""
    for width in (128, 256, 512):
        engine_core.check_state_fits(fe.engine_plan(11, width), 11, width)
    with pytest.raises(ValueError, match="shared memory"):
        engine_core.check_state_fits(engine_core.SMEM_LIMIT + 1, 11, 256)
    with pytest.raises(ValueError, match="width"):
        fe.engine_plan(11, fe.MAX_WIDTH + 1)
    wide = MLP(3, 1, 256, 1, "tanh")
    loss, grad = fe.engine_loss_grad(fe.spec_for(PROBLEMS["heat2d"]()), wide,
                                     ft.pack_params(wide), torch.rand(4, 4))
    assert torch.isfinite(loss) and grad.shape == ft.pack_params(wide).shape


def test_step_uniforms_width():
    """(h) The U=2 stream is unchanged: the values the heat route has drawn
    since it was ported, and the default width is 2; other widths give
    [n, B, U] in [0, 1)."""
    u2 = step_uniforms(7, 3, 2, 4, "cpu")
    assert torch.equal(u2, step_uniforms(7, 3, 2, 4, "cpu", n_uniform=2))
    want = torch.tensor([[0.6171877980232239, 0.5851482152938843],
                         [0.016186416149139404, 0.8729951977729797]])
    torch.testing.assert_close(u2[0, :2], want, rtol=0, atol=0)
    for U in (1, 3, 4):
        u = step_uniforms(7, 3, 2, 4, "cpu", n_uniform=U)
        assert u.shape == (2, 4, U) and 0 <= float(u.min())
        assert float(u.max()) < 1
