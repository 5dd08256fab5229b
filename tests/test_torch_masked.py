"""The sweep mode of the port's fused chunks (kernels/engine_core.py,
fused_engine.py, fused_dgm.py): rows ≥ bs masked out of the loss, steps at
or past the budget gated, the trial's own budget as the lr horizon, and the
packed call's per-slot lr, batch and budget, against the JAX package's
kernels in Pallas interpret mode on the same numpy uniforms and parameters.
FitzHugh–Nagumo's and UAT's masked losses follow the intended behaviour
instead, and the tests show where the JAX package differs. Small sizes:
H = 16, L = 2, B = 16, K = 8 (the DGM: H = 8, B = 8, K = 3); tolerances
rtol 1e-5 / atol 1e-6."""

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
from differential_equations_dnn_tpu.models import DGM as JaxDGM  # noqa: E402
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu.models import (  # noqa: E402
    Perceptron as JaxPerceptron,
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
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    dgm_params_from_jax,
    params_from_jax,
    perceptron_params_from_jax,
)

H, L, B, K = 16, 2, 16, 8
LR = 1e-3
TOL = dict(rtol=1e-5, atol=1e-6)
# equation -> (JAX problem kwargs, port problem kwargs), at small sizes
_KW = {"heat": {}, "volterra": dict(k=8), "advection": dict(c=50.0,
                                                            causal_eps=5.0)}
MLP_CASES = ["heat", "inverse_heat", "volterra", "advection"]


def _problems(name):
    if name == "inverse_heat":
        jprob = JAX_PROBLEMS[name](n_obs=20)
        xt, u = (np.asarray(a) for a in jprob.observations())
        return jprob, PROBLEMS[name](n_obs=20, obs_data=(xt, u))
    kw = _KW.get(name, {})
    return JAX_PROBLEMS[name](**kw), PROBLEMS[name](**kw)


def _mlp_case(name, seed=0):
    """(JAX spec, port spec, JAX model, JAX flat state, port model)."""
    jprob, prob = _problems(name)
    D = 1 if name == "volterra" else 2
    jnet = JaxMLP(input_dim=D, output_dim=1, hidden_size=H, num_layers=L,
                  activation="tanh")
    if name == "inverse_heat":
        jm = type(jprob.default_model())(jnet)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
        model = inverse_params_from_jax(jp)
    else:
        jm = jnet
        jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
        model = params_from_jax(jp, "tanh")
    jspec, spec = jfe.spec_for(jprob), fe.spec_for(prob)
    return jspec, spec, jm, jfe._pack_fn(jspec, jm)(jp), model


def _uniforms(n_uniform, shape, seed=0):
    return np.random.default_rng(seed).uniform(
        size=shape + (n_uniform,)).astype(np.float32)


def _assert_state(spec, model, ours, theirs):
    for a, b in zip(fe.unpack_state(spec, model, ours), theirs):
        np.testing.assert_allclose(a.numpy(), np.asarray(b).reshape(a.shape),
                                   **TOL)


@pytest.mark.parametrize("name", MLP_CASES)
@pytest.mark.parametrize("horizon", ["trial", "fixed"])
def test_masked_chunk_matches_jax(name, horizon):
    """K = 8 steps at runtime_bs = 11 of B = 16 and runtime_steps = 5 under
    a cosine schedule against JAX fused_engine_chunk's run-time mode:
    losses (0 past the budget), parameters and moments to rtol 1e-5 / atol
    1e-6. Causal advection takes the plain masked loss, as in JAX."""
    jspec, spec, jm, flat, model = _mlp_case(name, seed=3)
    u = _uniforms(spec.n_uniform, (K, B), seed=3)
    kw = dict(schedule="cosine", total_steps=20, decay=0.1,
              trial_horizon=horizon == "trial")
    zeros = tuple(jnp.zeros_like(t) for t in flat)
    pj, mj, vj, lj = jfe.fused_engine_chunk(
        jspec, jm, flat, zeros, zeros, jnp.asarray(u), 0, LR,
        runtime_bs=jnp.int32(11), runtime_steps=jnp.int32(5), **kw)
    p = fe.pack_state(spec, model)
    z = torch.zeros_like(p)
    pt, mt, vt, lt = fe.fused_engine_chunk(spec, model, p, z, z,
                                           torch.from_numpy(u), 0, LR,
                                           runtime_bs=11, runtime_steps=5,
                                           **kw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert not lt[5:].any()
    for ours, theirs in ((pt, pj), (mt, mj), (vt, vj)):
        _assert_state(spec, model, ours, theirs)


@pytest.mark.parametrize("mask_rows", [True, False])
def test_masked_packed_chunk_matches_jax(mask_rows):
    """Heat, 4 slots with their own lr, batch and budget (slot 2 pruned:
    budget 0) against JAX fused_engine_packed_chunk's per-slot vectors: every
    slot to rtol 1e-5 / atol 1e-6; the pruned slot returns its input state
    bit for bit with losses 0."""
    jspec, spec, jm, _, _ = _mlp_case("heat")
    n = 4
    cases = [_mlp_case("heat", seed=s) for s in range(n)]
    flats = [c[3] for c in cases]
    models = [c[4] for c in cases]
    u = _uniforms(2, (K, B), seed=4)
    lrs = np.asarray([1e-3, 3e-3, 1e-2, 1e-4], np.float32)
    bss = np.asarray([16, 11, 1, 5], np.int32)
    ns = np.asarray([8, 5, 0, 3], np.int32)
    kw = dict(schedule="exponential", total_steps=12, decay=0.1)
    from differential_equations_dnn_tpu.kernels import engine_core as jec

    jflat = jec.stack_replicas(flats)
    jz = tuple(jnp.zeros_like(t) for t in jflat)
    pj, mj, vj, lj = jfe.fused_engine_packed_chunk(
        jspec, jm, jflat, jz, jz, jnp.asarray(u), 0, 0.0, n,
        lr_vec=jnp.asarray(lrs), bs_vec=jnp.asarray(bss),
        steps_vec=jnp.asarray(ns), mask_rows=mask_rows, **kw)
    p = engine_core.stack_replicas([fe.pack_state(spec, m) for m in models])
    z = torch.zeros_like(p)
    pt, mt, vt, lt = fe.fused_engine_packed_chunk(
        spec, models[0], p, z, z, torch.from_numpy(u), 0, 0.0, n,
        lr_vec=lrs, bs_vec=bss, steps_vec=ns, mask_rows=mask_rows, **kw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    shapes = jfe._shapes_for(jspec, jm)
    per_slot = [jec.unstack_replicas(t, shapes, n) for t in (pj, mj, vj)]
    for r in range(n):
        for ours, theirs in zip((pt, mt, vt), per_slot):
            _assert_state(spec, models[0], ours[r], theirs[r])
    assert torch.equal(pt[2], p[2]) and not lt[2].any() and not mt[2].any()


def _dgm_case(name, seed=0):
    """(JAX problem, port problem, JAX model, JAX flat, port model)."""
    act, scheme, O = (("relu", "xavier_relu", 1) if name == "fredholm"
                      else ("tanh", "torch", 2))
    kw = dict(k=12, quadrature="gauss") if name == "fredholm" else dict(
        causal_eps=0.0)
    jm = JaxDGM(input_dim=1, output_dim=O, hidden_size=8, num_layers=2,
                activation=act, init_scheme=scheme)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return (JAX_PROBLEMS[name](**kw), PROBLEMS[name](**kw), jm,
            jfd.pack_dgm(jp), dgm_params_from_jax(jp, act, scheme))


@pytest.mark.parametrize("horizon", ["trial", "fixed"])
def test_masked_dgm_chunk_matches_jax(horizon):
    """Fredholm (gauss, k = 12) on a 16-row tile at runtime_bs = 11 and
    runtime_steps = 2 of K = 3, cosine: the node groups stay unmasked, as
    in JAX fused_dgm_chunk's run-time mode; rtol 1e-5 / atol 1e-6."""
    jprob, prob, jm, flat, model = _dgm_case("fredholm", seed=5)
    jspec, spec = jfd.spec_for(jprob, B), fd.spec_for(prob, B)
    jconst = jfd._fredholm_const(jprob, B, jspec.n_groups)
    const = fd.const_for(spec, prob, B)
    u = _uniforms(1, (3, B), seed=5)
    kw = dict(schedule="cosine", total_steps=10, decay=0.1,
              trial_horizon=horizon == "trial")
    zeros = tuple(jnp.zeros_like(t) for t in flat)
    pj, mj, vj, lj = jfd.fused_dgm_chunk(
        jspec, jm, flat, zeros, zeros, jnp.asarray(u), 0, LR, const=jconst,
        runtime_bs=jnp.int32(11), runtime_steps=jnp.int32(2), **kw)
    p = fd.pack_dgm(model)
    z = torch.zeros_like(p)
    pt, mt, vt, lt = fd.fused_dgm_chunk(spec, model, p, z, z,
                                        torch.from_numpy(u), 0, LR,
                                        const=const, runtime_bs=11,
                                        runtime_steps=2, **kw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    assert lt[2] == 0.0
    for ours, theirs in ((pt, pj), (mt, mj), (vt, vj)):
        for a, b in zip(fd.unpack_dgm(model, ours), theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_masked_dgm_packed_chunk_matches_jax():
    """Fredholm, 3 slots (budgets 3, 0, 1; batches 16, 4, 9) against JAX
    fused_dgm_packed_chunk's per-slot vectors; the pruned slot comes back
    as it went in."""
    jprob, prob, jm, _, _ = _dgm_case("fredholm")
    cases = [_dgm_case("fredholm", seed=s) for s in range(3)]
    jspec, spec = jfd.spec_for(jprob, B), fd.spec_for(prob, B)
    jconst = jfd._fredholm_const(jprob, B, jspec.n_groups)
    const = fd.const_for(spec, prob, B)
    u = _uniforms(1, (3, B), seed=6)
    lrs = np.asarray([1e-3, 1e-2, 3e-3], np.float32)
    bss = np.asarray([16, 4, 9], np.int32)
    ns = np.asarray([3, 0, 1], np.int32)
    from differential_equations_dnn_tpu.kernels import engine_core as jec

    jflat = jec.stack_replicas([c[3] for c in cases])
    jz = tuple(jnp.zeros_like(t) for t in jflat)
    pj, _, _, lj = jfd.fused_dgm_packed_chunk(
        jspec, jm, jflat, jz, jz, jnp.asarray(u), 0, 0.0, 3, const=jconst,
        lr_vec=jnp.asarray(lrs), bs_vec=jnp.asarray(bss),
        steps_vec=jnp.asarray(ns), mask_rows=True)
    p = engine_core.stack_replicas([fd.pack_dgm(c[4]) for c in cases])
    z = torch.zeros_like(p)
    pt, _, _, lt = fd.fused_dgm_packed_chunk(
        spec, cases[0][4], p, z, z, torch.from_numpy(u), 0, 0.0, 3,
        const=const, lr_vec=lrs, bs_vec=bss, steps_vec=ns, mask_rows=True)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL)
    shapes = [tuple(t.shape) for t in cases[0][3]]
    for r, theirs in enumerate(jec.unstack_replicas(pj, shapes, 3)):
        for a, b in zip(fd.unpack_dgm(cases[0][4], pt[r]), theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)
    assert torch.equal(pt[1], p[1])


def test_fitzhugh_nagumo_masked_loss_is_the_intended_one():
    """FitzHugh–Nagumo (causal_eps = 0) masked at bs = 8 of a 12-row tile:
    the port's step equals its own unmasked step on the first 8 rows (rtol
    1e-5 / atol 1e-6) and JAX's UNMASKED step there (loss rtol 1e-5;
    gradients rtol 1e-4 / atol 1e-6 of the tensor's largest entry: the two
    packages' unmasked steps at causal_eps = 0 already differ by up to
    5e-5 relative in entries that cancel), i.e. a full-width trial trains
    the standalone objective. JAX's masked step instead exceeds it by
    mean((s0 − y_ic)²) over the live rows (its IC term weighted twice,
    fused_dgm.py:363-364)."""
    jprob, prob, jm, flat, model = _dgm_case("fitzhugh_nagumo")
    jspec, spec = jfd.spec_for(jprob, 12), fd.spec_for(prob, 12)
    u = _uniforms(1, (12,))
    bs = 8
    mask, inv_bs = engine_core.batch_mask(12, bs)
    params = fd.unpack_dgm(model, fd.pack_dgm(model))
    loss_t, grads_t = fd.dgm_step_math(spec, params, torch.from_numpy(u), 12,
                                       2, batch_mask=mask, inv_bs=inv_bs)
    loss_u, grads_u = fd.dgm_step_math(spec, params,
                                       torch.from_numpy(u[:bs]), bs, 2)
    torch.testing.assert_close(loss_t, loss_u, **TOL)
    for a, b in zip(grads_t, grads_u):
        torch.testing.assert_close(a, b, **TOL)
    loss_j, grads_j = jfd.dgm_step_math(jspec, flat, jnp.asarray(u[:bs]), bs,
                                        2)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-5)
    for gt, gj in zip(grads_t, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(gj).max()))
    loss_jm, _ = jfd.dgm_step_math(jspec, flat, jnp.asarray(u), 12, 2,
                                   batch_mask=jnp.asarray(mask.numpy()),
                                   inv_bs=jnp.float32(1.0 / bs))
    s0 = model(torch.zeros(bs, 1)).detach()
    ic = float(torch.mean(torch.square(s0 - prob.y_ic)))
    np.testing.assert_allclose(np.asarray(loss_jm).item() - loss_t.item(), ic,
                               rtol=1e-4)
    assert ic > 1e-6


def test_uat_masked_grid_spans_the_live_rows():
    """UAT's masked step at bs = 10 of a 16-row tile equals its unmasked
    step at B = 10 (the grid spans the live rows, rtol 1e-5 / atol 1e-6);
    the JAX spec's masked grid spans the tile, so its loss differs."""
    jprob, prob = JAX_PROBLEMS["uat"](), PROBLEMS["uat"]()
    jm = JaxPerceptron(input_dim=1, output_dim=1, hidden_size=3)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(8)))
    model = perceptron_params_from_jax(jp)
    jspec, spec = jfe.spec_for(jprob), fe.spec_for(prob)
    params = fe.unpack_state(spec, model, fe.pack_state(spec, model))
    u = torch.from_numpy(_uniforms(1, (16,), seed=8))
    mask, inv_bs = engine_core.batch_mask(16, 10)
    loss_m, grads_m = fe.engine_step_math(spec, params, u, 16, 0,
                                          batch_mask=mask, inv_bs=inv_bs)
    loss_u, grads_u = fe.engine_step_math(spec, params, u[:10], 10, 0)
    torch.testing.assert_close(loss_m, loss_u, **TOL)
    for a, b in zip(grads_m, grads_u):
        torch.testing.assert_close(a, b, **TOL)
    flat = jfe._pack_fn(jspec, jm)(jp)
    loss_j, _ = jfe.engine_step_math(jspec, flat, jnp.asarray(u.numpy()), 16,
                                     0, batch_mask=jnp.asarray(mask.numpy()),
                                     inv_bs=jnp.float32(0.1))
    assert abs(np.asarray(loss_j).item() - loss_m.item()) > 1e-4


def test_full_width_mask_and_budget_are_the_plain_chunk():
    """bs = B takes the unmasked loss to fp32 reassociation, and a budget
    of K under a constant schedule is the unmasked chunk bit for bit."""
    _, spec, _, _, model = _mlp_case("heat", seed=9)
    u = torch.from_numpy(_uniforms(2, (K, B), seed=9))
    p = fe.pack_state(spec, model)
    z = torch.zeros_like(p)
    plain = fe.fused_engine_chunk(spec, model, p, z, z, u, 0, LR)
    gated = fe.fused_engine_chunk(spec, model, p, z, z, u, 0, LR,
                                  runtime_steps=K)
    masked = fe.fused_engine_chunk(spec, model, p, z, z, u, 0, LR,
                                   runtime_bs=B)
    for a, b, c in zip(plain, gated, masked):
        assert torch.equal(a, b)
        torch.testing.assert_close(c, a, **TOL)


def test_sweep_vectors_are_checked():
    """A batch outside [1, B] or a negative budget raises before anything
    runs; no vector and no mask is the plain mode."""
    assert engine_core.sweep_vectors(2, LR, B, K) is None
    lrs, bss, ns = engine_core.sweep_vectors(2, LR, B, K, mask_rows=True)
    assert list(bss) == [B, B] and list(ns) == [K, K]
    with pytest.raises(ValueError, match="batch sizes"):
        engine_core.sweep_vectors(2, LR, B, K, bs_vec=[0, 3], mask_rows=True)
    with pytest.raises(ValueError, match="budgets"):
        engine_core.sweep_vectors(2, LR, B, K, steps_vec=[-1, 3])
    with pytest.raises(ValueError, match="holds 3"):
        engine_core.sweep_vectors(2, LR, B, K, lr_vec=[1.0, 2.0, 3.0])
