"""The port's fused heat trainer against the JAX package's
kernels/fused_train.py (Pallas in interpret mode on the CPU), on the same
numpy uniforms and parameters."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from differential_equations_dnn_tpu.kernels import (  # noqa: E402
    fused_train as jft,
)
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu_torch.core import (  # noqa: E402
    generator,
)
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    Heat1D,
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


@pytest.fixture
def nets():
    jm = JaxMLP(input_dim=2, output_dim=1, hidden_size=H, num_layers=L,
                activation="tanh")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(5)))
    return jm, jp, params_from_jax(jp, "tanh")


@pytest.fixture
def uniforms():
    return np.random.default_rng(5).uniform(size=(K, B, 2)).astype(np.float32)


def test_step_math_matches_jax(nets, uniforms):
    """(e) Loss and all 6 gradients against ft.fused_step_math: fp32
    reassociation of 7B-row sums, rtol 1e-5 / atol 1e-6."""
    jm, jp, tm = nets
    loss_j, grads_j = jft.fused_step_math(jft.pack_params(jm, jp),
                                          jnp.asarray(uniforms[0]), B, L)
    p = ft.pack_params(tm)
    loss_t, grads_t = ft.fused_step_math(ft.unpack_params(tm, p),
                                         torch.from_numpy(uniforms[0]), B, L)
    np.testing.assert_allclose(float(loss_t), float(loss_j), rtol=1e-5)
    for gt, gj in zip(grads_t, grads_j):
        np.testing.assert_allclose(gt.numpy(), np.asarray(gj), rtol=1e-5,
                                   atol=1e-6)


def test_hand_backward_matches_autograd(nets, uniforms):
    """(e) The hand-derived backward against torch.autograd of the port's own
    heat loss (Taylor taps) on the same points; fp32 reassociation."""
    _, _, tm = nets
    u = torch.from_numpy(uniforms[1])
    prob = Heat1D(taps="taylor")
    loss_a = prob.loss(tm, prob.batch_from_uniforms(u))
    grads_a = torch.autograd.grad(loss_a, list(ft._tensors(tm)))
    loss_h, grads_h = ft.fused_step_math(
        ft.unpack_params(tm, ft.pack_params(tm)), u, B, L)
    torch.testing.assert_close(loss_h, loss_a.detach(), rtol=1e-5, atol=0)
    for gh, ga in zip(grads_h, grads_a):
        torch.testing.assert_close(gh, ga, rtol=1e-4, atol=1e-6)


def test_adam_update_matches_jax():
    rng = np.random.default_rng(6)
    p, m, g = (rng.normal(size=50).astype(np.float32) for _ in range(3))
    v = rng.uniform(size=50).astype(np.float32)
    for t in (1.0, 7.0, 15000.0):
        want = jft._adam_update(p, m, v, g, 1e-4, jnp.float32(t))
        got = ft.adam_update(*map(torch.from_numpy, (p, m, v, g)), 1e-4,
                             torch.tensor(t, dtype=torch.float32))
        for a, b in zip(got, want):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-9)


def test_train_chunk_matches_jax(nets, uniforms):
    """(f) K=8 Adam steps on the same uniforms and parameters: losses and
    parameters to rtol 1e-5 / atol 1e-6."""
    jm, jp, tm = nets
    flat = jft.pack_params(jm, jp)
    zeros = tuple(jnp.zeros_like(t) for t in flat)
    pj, mj, vj, lj = jft.heat_fused_train_chunk(jm, flat, zeros, zeros,
                                                jnp.asarray(uniforms), 0, LR)
    p = ft.pack_params(tm)
    z = torch.zeros_like(p)
    pt, mt, vt, lt = ft.heat_fused_train_chunk(tm, p, z, z,
                                               torch.from_numpy(uniforms), 0,
                                               LR)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-6)
    for ours, theirs in ((pt, pj), (mt, mj), (vt, vj)):
        for a, b in zip(ft.unpack_params(tm, ours), theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_wide_chunk_plain_matches_jax_step_math():
    """At H = 256 (a width the first CUDA design refused; L = 1, B = 8): two
    steps of heat_fused_train_chunk_plain against a loop of the JAX
    package's fused_step_math and its Adam update on the same numpy
    parameters and uniforms: losses to rtol 1e-5 / atol 1e-6, as at H = 16;
    parameters to rtol 1e-5 plus 2·lr, since among 66 000 parameters an
    Adam step on a gradient within fp32 reassociation of zero can move one
    by up to 2·lr in either implementation (the card's tests hold the
    kernel to its plain version the same way)."""
    Hw, Lw, Bw, Kw = 256, 1, 8, 2
    jm = JaxMLP(input_dim=2, output_dim=1, hidden_size=Hw, num_layers=Lw,
                activation="tanh")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(7)))
    tm = params_from_jax(jp, "tanh")
    u = np.random.default_rng(7).uniform(size=(Kw, Bw, 2)).astype(
        np.float32)
    flat = jft.pack_params(jm, jp)
    m = v = tuple(jnp.zeros_like(t) for t in flat)
    losses = []
    for k in range(Kw):
        loss, grads = jft.fused_step_math(flat, jnp.asarray(u[k]), Bw, Lw)
        new = [jft._adam_update(*args, LR, jnp.float32(k + 1))
               for args in zip(flat, m, v, grads)]
        flat, m, v = (tuple(t[i] for t in new) for i in range(3))
        losses.append(float(loss))
    p = ft.pack_params(tm)
    z = torch.zeros_like(p)
    pt, _, _, lt = ft.heat_fused_train_chunk_plain(tm, p, z, z,
                                                   torch.from_numpy(u), 0, LR)
    np.testing.assert_allclose(lt.numpy(), losses, rtol=1e-5, atol=1e-6)
    for a, b in zip(ft.unpack_params(tm, pt), flat):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                   atol=2 * LR)


def test_chunked_run_is_bit_identical(nets, uniforms):
    """(f) Two chunks (step0 = 0, 4) equal one chunk of 8, bit for bit."""
    _, _, tm = nets
    u = torch.from_numpy(uniforms)
    p = ft.pack_params(tm)
    z = torch.zeros_like(p)
    p8, m8, v8, l8 = ft.heat_fused_train_chunk(tm, p, z, z, u, 0, LR)
    p4, m4, v4, l4 = ft.heat_fused_train_chunk(tm, p, z, z, u[:4], 0, LR)
    p4, m4, v4, l4b = ft.heat_fused_train_chunk(tm, p4, m4, v4, u[4:], 4, LR)
    assert torch.equal(torch.cat([l4, l4b]), l8)
    for a, b in ((p4, p8), (m4, m8), (v4, v8)):
        assert torch.equal(a, b)


def test_pack_unpack_roundtrip(nets):
    _, jp, tm = nets
    p = ft.pack_params(tm)
    assert p.shape == (3 * H + L * H * H + L * H + H + 1,)
    views = ft.unpack_params(tm, p)
    for v, (layer, leaf) in zip(views, [("fc_in", "w"), ("fc_in", "b"),
                                        ("hidden", "w"), ("hidden", "b"),
                                        ("fc_out", "w"), ("fc_out", "b")]):
        np.testing.assert_array_equal(v.numpy(), jp[layer][leaf])
    other = MLP(2, 1, H, L, "tanh", generator=generator(9))
    ft.load_params(other, p)
    assert torch.equal(ft.pack_params(other), p)


def test_batch_tile_must_divide(nets):
    _, _, tm = nets
    p = ft.pack_params(tm)
    with pytest.raises(ValueError, match="divisible"):
        ft.heat_fused_train_chunk(tm, p, p, p, torch.zeros(1, 24, 2), 0, LR,
                                  batch_tile=16)
    out = ft.heat_fused_train_chunk(tm, p, 0 * p, 0 * p,
                                    torch.zeros(1, 24, 2), 0, LR,
                                    batch_tile=8)
    assert out[3].shape == (1,)


def test_rejects_unsupported_models():
    model = MLP(2, 1, 8, 1, "relu")
    p = ft.pack_params(model)
    with pytest.raises(ValueError, match="tanh"):
        ft.heat_fused_train_chunk(model, p, p, p, torch.zeros(1, 8, 2), 0, LR)
