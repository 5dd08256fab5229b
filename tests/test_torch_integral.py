"""The port's stochastic quadratures (ops/quad.py) and the integral
equations' scan losses (equations/fredholm.py, equations/volterra.py)
against the JAX package, on the same nodes, points and parameters. Small
sizes: k = 12 nodes, B = 8 points, a DGM of width 8 for Fredholm and an MLP
1 → 16×2 → 1 for Volterra."""

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
from differential_equations_dnn_tpu.models import DGM as JaxDGM  # noqa: E402
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu.ops import (  # noqa: E402
    gauss_legendre_nodes as jax_gauss_legendre_nodes,
)
from differential_equations_dnn_tpu.ops import (  # noqa: E402
    halton_nodes as jax_halton_nodes,
)
from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    Fredholm2,
    Volterra2,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    dgm_params_from_jax,
    params_from_jax,
)
from differential_equations_dnn_tpu_torch.ops import (  # noqa: E402
    halton_nodes,
    montecarlo_nodes,
)

K_NODES, B = 12, 8


@pytest.mark.parametrize("offset", [0, 7, (1 << 20) - 1])
@pytest.mark.parametrize("a, b", [(0.0, 1.0), (0.0, math.pi / 2)])
def test_halton_nodes_equal_jax_bit_for_bit(offset, a, b):
    """(a) The same 32-digit integer loop and fp32 sums as the JAX
    package: nodes and weights equal bit for bit, at the first window, a
    shifted one and the last offset Fredholm draws."""
    nodes, weights = halton_nodes(50, a, b, offset=offset)
    jn, jw = jax_halton_nodes(50, a, b, offset=offset)
    assert nodes.dtype == weights.dtype == torch.float32
    assert np.array_equal(nodes.numpy(), np.asarray(jn))
    assert np.array_equal(weights.numpy(), np.asarray(jw))
    # A tensor offset (Fredholm's draw) gives the same window.
    t_nodes, _ = halton_nodes(50, a, b, offset=torch.tensor(offset))
    assert torch.equal(t_nodes, nodes)


def test_montecarlo_nodes_shape_range_weights():
    """(a) Per-point node sets of the batch shape inside [a, b), constant
    weights (b − a)/k, reproducible from the generator."""
    nodes, weights = montecarlo_nodes(generator(3), 50, 0.5, 2.0, (B,))
    assert nodes.shape == (B, 50) and weights.shape == (50,)
    assert nodes.dtype == weights.dtype == torch.float32
    assert float(nodes.min()) >= 0.5 and float(nodes.max()) < 2.0
    assert torch.all(weights == torch.tensor(1.5 / 50))
    again, _ = montecarlo_nodes(generator(3), 50, 0.5, 2.0, (B,))
    assert torch.equal(again, nodes)
    assert not torch.equal(montecarlo_nodes(generator(4), 50, 0.5, 2.0,
                                            (B,))[0], nodes)


@pytest.mark.parametrize("quadrature", ["montecarlo", "halton"])
def test_fredholm_sample_draws_its_nodes(quadrature):
    """The stochastic rules' batches: B points in [0, π/2), k nodes per
    point in range (Halton: one window shared by the batch), constant
    weights; a step's generator decides them."""
    prob = Fredholm2(k=K_NODES, quadrature=quadrature)
    batch = prob.sample(B, generator(5))
    assert batch["x"].shape == (B, 1)
    assert batch["tq"].shape == batch["wq"].shape == (B, K_NODES)
    assert float(batch["tq"].min()) >= 0.0
    assert float(batch["tq"].max()) < prob.upper
    assert torch.all(batch["wq"] == torch.tensor(prob.upper / K_NODES))
    if quadrature == "halton":
        assert torch.equal(batch["tq"][0], batch["tq"][-1])
    assert torch.equal(prob.sample(B, generator(5))["tq"], batch["tq"])


def test_quadrature_names_are_checked():
    with pytest.raises(ValueError, match="unknown quadrature"):
        Fredholm2(quadrature="simpson")
    with pytest.raises(ValueError, match="unknown quadrature"):
        Volterra2(quadrature="halton")


def _fredholm_pair(seed):
    jm = JaxDGM(input_dim=1, output_dim=1, hidden_size=8, num_layers=1,
                activation="relu", init_scheme="xavier_relu")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, jp, dgm_params_from_jax(jp, "relu", "xavier_relu")


def _volterra_pair(seed):
    jm = JaxMLP(input_dim=1, output_dim=1, hidden_size=16, num_layers=2,
                activation="tanh")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, jp, params_from_jax(jp, "tanh")


@pytest.mark.parametrize("name, quadrature", [
    ("fredholm", "montecarlo"), ("fredholm", "halton"),
    ("volterra", "gauss"), ("volterra", "montecarlo"),
])
def test_scan_losses_match_jax(name, quadrature):
    """(b) The loss the scan trainer differentiates, on the same batch
    (the port's own draw, handed to both as numpy) and parameters as the
    JAX problem: equal to rtol 1e-5 (fp32 reassociation of the k-node sums
    and the forward), and its gradient finite."""
    pair = _fredholm_pair if name == "fredholm" else _volterra_pair
    jm, jp, model = pair(seed=1)
    prob = (Fredholm2 if name == "fredholm" else Volterra2)(
        k=K_NODES, quadrature=quadrature)
    jprob = JAX_PROBLEMS[name](k=K_NODES, quadrature=quadrature)
    batch = prob.sample(B, generator(2))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want = float(jprob.loss(jm.apply, jp, jbatch))
    loss = prob.loss(model, batch)
    np.testing.assert_allclose(float(loss.detach()), want, rtol=1e-5)
    grads = torch.autograd.grad(loss, list(model.parameters()))
    assert all(torch.isfinite(g).all() for g in grads)


def test_volterra_gauss_batch_matches_jax_sample():
    """The Gauss-rule batch from the same points equals the JAX package's
    (nodes x·(u + 1)/2 and weights x·w/2 of its fp32 rule) to fp32
    rounding."""
    prob = Volterra2(k=K_NODES)
    u = np.random.default_rng(0).uniform(size=(B, 1)).astype(np.float32)
    batch = prob.batch_from_uniforms(torch.from_numpy(u))
    x = jnp.asarray(batch["x"].numpy())
    nodes, weights = jax_gauss_legendre_nodes(K_NODES, -1.0, 1.0)
    np.testing.assert_allclose(batch["tq"].numpy(),
                               np.asarray(x * (nodes[None, :] + 1.0) * 0.5),
                               rtol=1e-6)
    np.testing.assert_allclose(batch["wq"].numpy(),
                               np.asarray(x * weights[None, :] * 0.5),
                               rtol=1e-6)
