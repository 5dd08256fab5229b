"""Causal advection (``Advection1D(causal_eps > 0)``) in the port against the
JAX package: the stratum layout, the scan loss and its gradients, the fused
spec's step math, a K = 6 chunk (the JAX chunk runs its Pallas kernel in
interpret mode on the CPU, as the JAX package's own tests run it), packed
replicas, the tie rule and the sampler, on the same numpy inputs. Small
sizes: B = 8 to 16, H = 16, L = 1, ε = 5 and 10."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from differential_equations_dnn_tpu.equations import (  # noqa: E402
    Advection1D as JaxAdvection1D,
)
from differential_equations_dnn_tpu.kernels import (  # noqa: E402
    fused_engine as jfe,
)
from differential_equations_dnn_tpu.kernels import (  # noqa: E402
    fused_train as jft,
)
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu_torch import solve  # noqa: E402
from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    Advection1D,
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
    params_to_jax,
)
from differential_equations_dnn_tpu_torch.ops import (  # noqa: E402
    stride_strata,
)

H, L = 16, 1
LR = 1e-3
C = 50.0  # the JAX package's high-speed smoke case (smoke_tpu.py:59-62)
EPS = (5.0, 10.0)


def _problems(eps):
    return (Advection1D(c=C, causal_eps=eps),
            JaxAdvection1D(c=C, causal_eps=eps))


def _pair(seed=0):
    """A JAX MLP's parameters and the same parameters as a port MLP."""
    jm = JaxMLP(input_dim=2, output_dim=1, hidden_size=H, num_layers=L,
                activation="tanh")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, jp, params_from_jax(jp, "tanh")


def _uniforms(shape, seed=0):
    return np.random.default_rng(seed).uniform(
        size=shape + (2,)).astype(np.float32)


def _assert_grads(ours, theirs, atol=1e-6):
    """Gradients at rtol 1e-4 / atol ``atol`` of the tensor's largest entry
    (at least ``atol``): at c = 50 each entry is a sum of R·B terms far
    larger than itself, and their order moves the near-zero entries."""
    for gt, gj in zip(ours, theirs):
        gj = np.asarray(gj)
        np.testing.assert_allclose(np.asarray(gt), gj, rtol=1e-4,
                                   atol=atol * max(1.0, np.abs(gj).max()))


def _tie_uniforms(B, seed=0):
    """[B, 2] draws in which the rows of strata 2 and 3 get the same fp32
    t: (2 + (1 − 2^−24))·Δt rounds to 3·Δt."""
    u = _uniforms((B,), seed)
    strata = stride_strata(B)[:, 0].numpy().astype(int)
    u[np.where(strata == 2)[0][0], 1] = np.float32(1.0 - 2.0 ** -24)
    u[np.where(strata == 3)[0][0], 1] = 0.0
    return u


# ---------------------------------------------------------------------------
# The stratum layout
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 8, 12, 13, 16, 128, 512, 1000])
def test_coprime_stride_matches_jax(n):
    """The port's own stride equals the JAX package's."""
    assert fe._coprime_stride(n) == jfe._coprime_stride(n)


@pytest.mark.parametrize("B", [8, 13, 16])
def test_causal_build_matches_jax(B):
    """The fused spec's rows from the same draws equal JAX's bit for bit
    (the strata in integers against JAX's float floor), and so do x and
    t; every stratum appears once."""
    prob, jprob = _problems(5.0)
    u = _uniforms((B,), seed=B)
    X, ctx = fe.spec_for(prob).build(torch.from_numpy(u))
    jX, jctx = jfe.spec_for(jprob).build(jnp.asarray(u))
    np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
    np.testing.assert_array_equal(ctx["t"].numpy(), np.asarray(jctx["t"]))
    np.testing.assert_array_equal(ctx["x"].numpy(), np.asarray(jctx["x"]))
    strata = np.floor(ctx["t"].numpy()[:, 0] * B / prob.t_max).astype(int)
    assert sorted(strata) == list(range(B))
    # The scan problem's batch_from_uniforms lays the same points out.
    batch = prob.batch_from_uniforms(torch.from_numpy(u))
    assert torch.equal(batch["xt"], X[:B])


# ---------------------------------------------------------------------------
# The scan loss
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("eps", EPS)
def test_scan_loss_matches_jax(eps):
    """Advection1D(causal_eps).loss and its gradients against the JAX
    package's on one batch: loss rtol 1e-5, gradients rtol 1e-4 / atol
    1e-6 (of the largest entry)."""
    prob, jprob = _problems(eps)
    jm, jp, tm = _pair(seed=1)
    batch = prob.sample(16, generator(3))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jprob.loss(jm.apply, p, jbatch))(jp)
    loss_t = prob.loss(tm, batch)
    grads_t = torch.autograd.grad(loss_t, list(tm.parameters()))
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    names = [n.split(".") for n, _ in tm.named_parameters()]
    _assert_grads([g.numpy() for g in grads_t],
                  [grads_j[a][b] for a, b in names])


def test_scan_loss_weights_only_earlier_points():
    """The causal weights are detached and count strictly earlier points:
    with ε = 0 weights the loss equals the plain mean, and a point tied in
    t with another does not weigh it (the JAX loss on the same batch)."""
    prob, jprob = _problems(10.0)
    jm, jp, tm = _pair(seed=2)
    batch = prob.batch_from_uniforms(torch.from_numpy(_tie_uniforms(8)))
    t = batch["xt"][:, 1]
    assert len(set(t.tolist())) == 7  # one tie
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    np.testing.assert_allclose(float(prob.loss(tm, batch)),
                               float(jprob.loss(jm.apply, jp, jbatch)),
                               rtol=1e-5)
    plain = Advection1D(c=C)
    np.testing.assert_allclose(
        float(Advection1D(c=C, causal_eps=1e-30).loss(tm, batch)),
        float(plain.loss(tm, batch)), rtol=1e-6)


def test_sampler_shuffles_one_point_per_stratum():
    """The scan sampler draws one t per stratum of [0, t_max], in shuffled
    row order, and x over [0, x_max]; the same generator gives the same
    batch."""
    prob = Advection1D(c=C, causal_eps=5.0)
    n = 64
    batch = prob.sample(n, generator(7))
    t = batch["xt"][:, 1]
    strata = torch.floor(t * n / prob.t_max).long()
    assert sorted(strata.tolist()) == list(range(n))
    assert not torch.equal(strata, torch.arange(n))
    assert torch.equal(batch["x0"][:, 1], torch.zeros(n))
    assert torch.equal(batch["xb"][:, 1], t)
    x = batch["xt"][:, 0]
    assert float(x.min()) >= 0.0 and float(x.max()) <= prob.x_max
    again = prob.sample(n, generator(7))
    assert all(torch.equal(batch[k], again[k]) for k in batch)


# ---------------------------------------------------------------------------
# The fused spec
# ---------------------------------------------------------------------------


def _step_math(eps, u, seed):
    prob, jprob = _problems(eps)
    jm, jp, tm = _pair(seed)
    B = u.shape[0]
    loss_j, grads_j = jfe.engine_step_math(
        jfe.spec_for(jprob), jft.pack_params(jm, jp), jnp.asarray(u), B, L)
    loss_t, grads_t = fe.engine_step_math(
        fe.spec_for(prob), ft.unpack_params(tm, ft.pack_params(tm)),
        torch.from_numpy(u), B, L)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-5)
    _assert_grads([g.numpy() for g in grads_t], grads_j, atol=1e-5)


@pytest.mark.parametrize("eps", EPS)
@pytest.mark.parametrize("B", [8, 13, 16])
def test_step_math_matches_jax(eps, B):
    """engine_step_math of the causal spec against JAX engine_step_math on
    the same draws: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-5 of the
    largest entry (at B = 13 JAX's own fp32 w_in gradient lies 1.4e-5 from
    a float64 evaluation of the same step, the port's 6.8e-6, of entries
    up to 2.9)."""
    _step_math(eps, _uniforms((B,), seed=B), seed=B)


@pytest.mark.parametrize("eps", EPS)
def test_step_math_tie_matches_jax(eps):
    """A forced tie (two rows of equal fp32 t, strata 2 and 3) against
    JAX's strict comparison: neither row counts the other."""
    u = _tie_uniforms(16, seed=4)
    X, ctx = fe.spec_for(_problems(eps)[0]).build(torch.from_numpy(u))
    t = ctx["t"][:, 0]
    assert len(set(t.tolist())) == 15
    _step_math(eps, u, seed=4)


def test_step_math_matches_autograd():
    """The plain loss grad (flat) against torch.autograd of the scan
    problem's own causal loss on the spec's points: the hand backward and
    the autograd taps agree to fp32 reassociation (loss rtol 1e-5,
    gradients rtol 1e-4 / atol 1e-6 of the largest entry)."""
    prob = Advection1D(c=C, causal_eps=5.0)
    tm = MLP(2, 1, H, L, "tanh", generator=generator(5))
    u = torch.from_numpy(_uniforms((16,), seed=5))
    loss_a = prob.loss(tm, prob.batch_from_uniforms(u))
    grads_a = torch.autograd.grad(loss_a, list(ft._tensors(tm)))
    spec = fe.spec_for(prob)
    loss_h, grad_h = fe.engine_loss_grad(spec, tm, ft.pack_params(tm), u)
    np.testing.assert_allclose(float(loss_h), float(loss_a), rtol=1e-5)
    _assert_grads(ft.unpack_params(tm, grad_h), grads_a)


def test_kernel_numbers():
    """The causal spec's numbers: x_max, t_max, c, −c, ε, then Δt = t_max/B
    and the stride, 7 of the kernel's 8; the plain spec keeps its 4."""
    spec = fe.spec_for(Advection1D(c=C, causal_eps=5.0))
    assert spec.kernel_id == 15 and spec.causal
    vals = spec.kernel_consts() + spec.batch_consts(128)
    assert vals[4:] == (5.0, 1.0 / 128, fe._coprime_stride(128))
    assert len(vals) == 7
    plain = fe.spec_for(Advection1D())
    assert plain.kernel_id == 4 and not plain.causal
    assert len(plain.kernel_consts() + plain.batch_consts(128)) == 4


@pytest.mark.parametrize("eps", EPS)
def test_chunk_matches_jax(eps):
    """K = 6 Adam steps of the causal spec (cosine schedule) against JAX
    fused_engine_chunk (Pallas, interpret mode) on the same draws: losses,
    parameters and moments to rtol 1e-5 / atol 1e-6 (the JAX package's
    own causal test, test_fused_engine.py:414, at B = 8)."""
    prob, jprob = _problems(eps)
    jm, jp, tm = _pair(seed=6)
    u = _uniforms((6, 8), seed=6)
    kw = dict(schedule="cosine", total_steps=12, decay=0.1)
    flat = jft.pack_params(jm, jp)
    zeros = tuple(jnp.zeros_like(t) for t in flat)
    pj, mj, vj, lj = jfe.fused_engine_chunk(jfe.spec_for(jprob), jm, flat,
                                            zeros, zeros, jnp.asarray(u), 2,
                                            LR, **kw)
    p = ft.pack_params(tm)
    z = torch.zeros_like(p)
    pt, mt, vt, lt = fe.fused_engine_chunk(fe.spec_for(prob), tm, p, z, z,
                                           torch.from_numpy(u), 2, LR, **kw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-6)
    for ours, theirs in ((pt, pj), (mt, mj), (vt, vj)):
        for a, b in zip(ft.unpack_params(tm, ours), theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_packed_chunk_equals_single_runs():
    """Two packed replicas (the plain twin of kernel #5 around the causal
    spec) equal two single chunks on their own states, bit for bit."""
    prob = Advection1D(c=C, causal_eps=5.0)
    spec = fe.spec_for(prob)
    models = [MLP(2, 1, H, L, "tanh", generator=generator(r))
              for r in (8, 9)]
    u = torch.from_numpy(_uniforms((4, 12), seed=8))
    flats = [ft.pack_params(m) for m in models]
    p = engine_core.stack_replicas(flats)
    pp, mp, vp, lp = fe.fused_engine_packed_chunk(
        spec, models[0], p, torch.zeros_like(p), torch.zeros_like(p), u, 0,
        LR, 2)
    for r, flat in enumerate(flats):
        z = torch.zeros_like(flat)
        ps, ms, vs, ls = fe.fused_engine_chunk(spec, models[0], flat, z, z,
                                               u, 0, LR)
        assert torch.equal(lp[r], ls)
        for a, b in ((pp[r], ps), (mp[r], ms), (vp[r], vs)):
            assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The routes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("engine", ["scan", "fused"])
def test_cpu_solve(engine):
    """solve("advection", c=50, causal_eps=5) trains on both engines (the
    plain versions on the CPU): finite losses and MAE, the grid's shape."""
    res = solve("advection", c=C, causal_eps=5.0, engine=engine,
                iterations=4, batch_size=16, nodes=6, device="cpu",
                model=MLP(2, 1, H, L, "tanh", generator=generator(0)))
    assert res.loss_history.shape == (4,)
    assert np.isfinite(res.loss_history).all() and np.isfinite(res.mae)
    assert res.solution.shape == (6, 6)


def test_fused_solve_matches_jax_twin():
    """Three steps of train_fused_result on the CPU equal the JAX pure twin
    loop of the causal spec on the port's own draws (the collocation
    stream differs between packages; the draws are handed over), to rtol
    1e-5."""
    prob, jprob = _problems(5.0)
    jm, jp, tm = _pair(seed=9)
    res = fe.train_fused_result(prob, 3, 3, batch_size=8, lrate=LR,
                                model=tm, schedule="constant", device="cpu")
    from differential_equations_dnn_tpu_torch.core import step_uniforms

    u = step_uniforms(3, 0, 3, 8, n_uniform=2).numpy()
    flat = jft.pack_params(jm, jp)
    zeros = tuple(jnp.zeros_like(t) for t in flat)
    pj, _, _, lj = jfe.fused_engine_chunk(jfe.spec_for(jprob), jm, flat,
                                          zeros, zeros, jnp.asarray(u), 0, LR)
    np.testing.assert_allclose(res.loss_history, np.asarray(lj), rtol=1e-5)
    for a, b in zip(ft.unpack_params(res.params, ft.pack_params(res.params)),
                    pj):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)
    assert params_to_jax(res.params)["fc_out"]["w"].shape == (H, 1)
