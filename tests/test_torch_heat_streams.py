"""Kernel #3's wrapper (kernels/taylor_mlp.heat_fused_streams) against the
JAX package's ``heat_fused_streams_pallas``, which runs its Pallas kernel in
interpret mode on the CPU, as the JAX package's own tests run it; on the
CPU the port's wrapper takes the plain stream math inside its autograd
Function. Small sizes: H = 16, L = 2 (and L = 0), B = 48 (not a multiple of
the TPU tile)."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from differential_equations_dnn_tpu.equations import (  # noqa: E402
    Heat1D as JaxHeat1D,
)
from differential_equations_dnn_tpu.kernels.taylor_mlp import (  # noqa: E402
    heat_fused_streams_pallas,
)
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu.ops import taylor as jtaylor  # noqa: E402
from differential_equations_dnn_tpu_torch import solve  # noqa: E402
from differential_equations_dnn_tpu_torch.api import (  # noqa: E402
    _fused_route,
)
from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    Heat1D,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_engine as fe,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    taylor_mlp as tm,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    DGM,
    MLP,
    params_from_jax,
)

H, B = 16, 48
NAMES = ("u", "u_x", "u_xx", "u_t", "u0", "ub1", "ub2")


def _nets(activation, L=2, seed=0, hidden=H):
    jm = JaxMLP(input_dim=2, output_dim=1, hidden_size=hidden, num_layers=L,
                activation=activation)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, jp, params_from_jax(jp, activation)


def _batch(seed=0, n=B):
    u = np.random.default_rng(seed).uniform(size=(n, 2)).astype(np.float32)
    x = (math.pi * u[:, :1]).astype(np.float32)
    t = (3.0 * u[:, 1:]).astype(np.float32)
    z = np.zeros_like(x)
    return {"xt": np.concatenate([x, t], 1),
            "x0": np.concatenate([x, z], 1),
            "xb1": np.concatenate([z, t], 1),
            "xb2": np.concatenate([np.full_like(x, math.pi), t], 1)}


def _points(batch, requires_grad=False):
    return [torch.tensor(batch[k], requires_grad=requires_grad)
            for k in ("xt", "x0", "xb1", "xb2")]


@pytest.mark.parametrize("activation, L", [
    ("tanh", 2), ("sigmoid", 2), ("relu", 2), ("tanh", 0),
])
def test_streams_match_jax_pallas(activation, L):
    """All seven streams against the JAX kernel (interpret mode) at B = 48,
    which the JAX side pads to its tile: rtol 1e-5 / atol 1e-5, the JAX
    package's own tolerance for its kernel (fp32 reassociation). At L = 0
    the reference is the JAX package's plain streams (ops.taylor), which its
    kernel is held to: the JAX kernel itself fails at L = 0, handing Pallas
    an empty [0, H, H] hidden stack for its [1, H, H] block."""
    jm, jp, model = _nets(activation, L)
    batch = _batch()
    ref = heat_fused_streams_pallas if L else jtaylor.heat_fused_streams
    want = ref(jm, jp, *(batch[k] for k in ("xt", "x0", "xb1", "xb2")))
    tm.heat_fused_streams.launches = 0
    got = tm.heat_fused_streams(model, *_points(batch))
    assert tm.heat_fused_streams.launches == 0  # the CPU runs no kernel
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == (B, 1)
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "relu"])
def test_wide_streams_plain_match_jax_pallas(activation):
    """At H = 256, a width the first CUDA design refused (L = 1, B = 8):
    heat_fused_streams_plain against the JAX kernel (interpret mode), all
    seven streams to the same rtol 1e-5 / atol 1e-5."""
    jm, jp, model = _nets(activation, L=1, seed=3, hidden=256)
    batch = _batch(3, n=8)
    pts = [batch[k] for k in ("xt", "x0", "xb1", "xb2")]
    want = heat_fused_streams_pallas(jm, jp, *pts)
    with torch.no_grad():
        got = tm.heat_fused_streams_plain(model, *map(torch.from_numpy, pts))
    for name, g, w in zip(NAMES, got, want):
        assert g.shape == (8, 1)
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5, err_msg=name)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid"])
def test_pallas_loss_gradient_matches_jax(activation):
    """The gradient of Heat1D(taps="pallas").loss through the Function's
    rematerialised backward against jax.grad of the JAX package's
    Heat1D(taps="pallas", taps_model=<the small MLP>).loss: rtol 1e-3 /
    atol 1e-5, as the JAX package holds its kernel's gradients
    (tests/test_kernels.py:56-66)."""
    jm, jp, model = _nets(activation, seed=1)
    batch = _batch(1)
    jprob = JaxHeat1D(taps="pallas", taps_model=jm)
    jloss, jgrad = jax.value_and_grad(
        lambda p: jprob.loss(jm.apply, p, batch))(jp)
    b = dict(zip(("xt", "x0", "xb1", "xb2"), _points(batch)))
    loss = Heat1D(taps="pallas").loss(model, b)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(jloss),
                               rtol=1e-5)
    for name, p in model.named_parameters():
        layer, leaf = name.split(".")
        np.testing.assert_allclose(p.grad.numpy(),
                                   np.asarray(jgrad[layer][leaf]),
                                   rtol=1e-3, atol=1e-5, err_msg=name)


def test_point_gradients_match_plain_autograd():
    """Where the points need a gradient too (``needs_input_grad``), the
    Function's backward gives what autograd gives through the plain streams:
    the same math, so to fp32 rounding (rtol 1e-6 / atol 1e-7)."""
    _, _, model = _nets("tanh", seed=2)
    batch = _batch(2)
    ct = [torch.tensor(np.random.default_rng(k).normal(size=(B, 1)),
                       dtype=torch.float32) for k in range(7)]
    grads = []
    for fn in (tm.heat_fused_streams, tm.heat_fused_streams_plain):
        pts = _points(batch, requires_grad=True)
        outs = fn(model, *pts)
        grads.append(torch.autograd.grad(
            outs, pts + list(model.parameters()), ct))
    for g, w in zip(*grads):
        torch.testing.assert_close(g, w, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("model, match", [
    (DGM(1, 1, 8, 1, "tanh", "torch"), "plain MLPs"),
    (MLP(2, 1, 8, 1, "leaky_relu"), "activations"),
    (MLP(2, 1, 8, 1, "identity"), "activations"),
    (MLP(3, 1, 8, 1, "tanh"), "input width"),
])
def test_streams_reject_other_models(model, match):
    """As the TPU kernel (taylor_mlp.py:33-57, 166): a plain MLP 2 → H×L →
    O with tanh, sigmoid or relu, on any device."""
    pts = [torch.zeros(4, 2) for _ in range(4)]
    with pytest.raises(ValueError, match=match):
        tm.heat_fused_streams(model, *pts)


def test_pallas_taps_train_on_scan_only():
    """As in the JAX package (fused_engine.py:1050-1051, api.py:147-150):
    the fused engine has no spec for pallas taps and tells the caller to
    use the scan engine, which trains them."""
    prob = Heat1D(taps="pallas")
    assert fe.spec_for(prob) is None and fe.spec_for(Heat1D()) is not None
    with pytest.raises(ValueError, match="engine='scan'"):
        _fused_route(prob, MLP(2, 1, 8, 1, "tanh"))
    with pytest.raises(ValueError, match="engine='scan'"):
        solve("heat", engine="fused", taps="pallas", device="cpu",
              iterations=2, batch_size=8, nodes=5)


def test_pallas_taps_point_loss_matches_taylor():
    """Heat1D's point_loss with pallas taps equals the Taylor taps' on the
    CPU (the plain version is their stream math)."""
    model = MLP(2, 1, H, 2, "tanh", generator=generator(3))
    b = Heat1D().sample(B, generator(4))
    torch.testing.assert_close(Heat1D(taps="pallas").point_loss(model, b),
                               Heat1D(taps="taylor").point_loss(model, b),
                               rtol=0, atol=0)



# ---------------------------------------------------------------------------
# The trial axis: kernel #3 under torch.func.vmap (a population's trials)
# ---------------------------------------------------------------------------

T = 3


def _trial_nets(activation="tanh", L=2):
    """T JAX inits of one architecture: (JAX model, stacked JAX tree, the
    port's models, their stacked tensors by name)."""
    jm = JaxMLP(input_dim=2, output_dim=1, hidden_size=H, num_layers=L,
                activation=activation)
    trees = [jax.tree.map(np.asarray, jm.init(jax.random.key(10 + t)))
             for t in range(T)]
    models = [params_from_jax(tr, activation) for tr in trees]
    stacked = {k: torch.stack([dict(m.named_parameters())[k].detach()
                               for m in models])
               for k, _ in models[0].named_parameters()}
    jstacked = jax.tree.map(lambda *a: np.stack(a), *trees)
    return jm, jstacked, models, stacked


def _trial_batches():
    """T batches of B points, stacked as [T, B, 2] per set."""
    batches = [_batch(20 + t) for t in range(T)]
    return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


class _Streams(torch.nn.Module):
    """The wrapper as a module, so that functional_call swaps a trial's
    weights in (as the population trainer does)."""

    def __init__(self, model, what="streams"):
        super().__init__()
        self.model, self.what = model, what

    def forward(self, batch):
        if self.what == "loss":
            return Heat1D(taps="pallas").loss(self.model, batch)
        return tm.heat_fused_streams(
            self.model, *(batch[k] for k in ("xt", "x0", "xb1", "xb2")))


def _vmapped(models, stacked, batch, what="streams", in_dims=0):
    mod = _Streams(models[0], what)

    def one(p, b):
        return torch.func.functional_call(
            mod, {f"model.{k}": v for k, v in p.items()}, (b,))

    if what == "loss":
        one = torch.func.grad_and_value(one)
    return torch.func.vmap(one, in_dims=(0, in_dims))(stacked, batch)


@pytest.mark.parametrize("shared", [False, True],
                         ids=["per-trial points", "shared points"])
def test_trial_axis_equals_one_trial_calls(shared):
    """vmap of the wrapper over T trials (the rule's one call of the plain
    version over the stacked trials, on the CPU) equals T one-trial calls
    of each trial's own model: every stream to rtol 1e-6 / atol 1e-6, a
    few fp32 ulps of streams under 2 (the batched and the single products
    sum in another order; 2.7e-7 seen). Points
    shared by all trials (``in_dims`` None) are expanded to each trial."""
    _, _, models, stacked = _trial_nets()
    batch = _trial_batches()
    pts = {k: torch.from_numpy(v[0] if shared else v)
           for k, v in batch.items()}
    tm.heat_fused_streams.launches = 0
    got = _vmapped(models, stacked, pts, in_dims=None if shared else 0)
    assert tm.heat_fused_streams.launches == 0
    for t, model in enumerate(models):
        want = tm.heat_fused_streams(
            model, *(pts[k] if shared else pts[k][t]
                     for k in ("xt", "x0", "xb1", "xb2")))
        for name, g, w in zip(NAMES, got, want):
            assert g.shape == (T, B, 1)
            np.testing.assert_allclose(
                g[t].detach().numpy(), w.detach().numpy(), rtol=1e-6,
                atol=1e-6, err_msg=f"trial {t} {name}")


@pytest.mark.parametrize("activation", ["tanh", "relu"])
def test_trial_axis_matches_jax_vmap(activation):
    """All seven streams of T trials against ``jax.vmap`` of the JAX
    kernel (interpret mode; Pallas gives it a leading batch grid axis):
    rtol 1e-5 / atol 1e-5, the JAX package's tolerance for its kernel."""
    jm, jstacked, models, stacked = _trial_nets(activation)
    batch = _trial_batches()
    want = jax.vmap(lambda p, *pts: heat_fused_streams_pallas(jm, p, *pts))(
        jstacked, *(batch[k] for k in ("xt", "x0", "xb1", "xb2")))
    got = _vmapped(models, stacked,
                   {k: torch.from_numpy(v) for k, v in batch.items()})
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-5, atol=1e-5, err_msg=name)


def test_trial_axis_gradients_match_jax_vmap():
    """``vmap(grad_and_value)`` of Heat1D(taps="pallas").loss over T trials
    (the backward's ``torch.func.vjp`` of the plain stream math, batched)
    against ``jax.vmap(value_and_grad)`` of the JAX package's pallas-taps
    loss: losses rtol 1e-5, gradients rtol 1e-3 / atol 1e-5, as the
    one-net gradient is held (test_pallas_loss_gradient_matches_jax)."""
    jm, jstacked, models, stacked = _trial_nets("tanh")
    batch = _trial_batches()
    jprob = JaxHeat1D(taps="pallas", taps_model=jm)
    jloss, jgrad = jax.vmap(jax.value_and_grad(
        lambda p, b: jprob.loss(jm.apply, p, b)))(jstacked, batch)
    grads, losses = _vmapped(
        models, stacked, {k: torch.from_numpy(v) for k, v in batch.items()},
        what="loss")
    np.testing.assert_allclose(losses.detach().numpy(), np.asarray(jloss),
                               rtol=1e-5)
    for name, g in grads.items():
        layer, leaf = name.split(".")
        np.testing.assert_allclose(g.numpy(), np.asarray(jgrad[layer][leaf]),
                                   rtol=1e-3, atol=1e-5, err_msg=name)
