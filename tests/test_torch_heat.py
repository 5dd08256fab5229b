"""The port's derivative taps, Taylor streams and heat problem against the
JAX package, on the same numpy inputs and parameters."""

import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from differential_equations_dnn_tpu.equations import (  # noqa: E402
    Heat1D as JaxHeat1D,
)
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu.ops import diff as jdiff  # noqa: E402
from differential_equations_dnn_tpu.ops import taylor as jtaylor  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    PROBLEMS,
    Heat1D,
    get_problem,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    params_from_jax,
)
from differential_equations_dnn_tpu_torch.ops import (  # noqa: E402
    heat_fused_streams,
    value_dt,
    value_dx_dxx,
)

# fp32 reassociation through two hidden layers; derivatives of order 1.
RTOL, ATOL = 1e-5, 1e-5


@pytest.fixture
def nets():
    jm = JaxMLP(input_dim=2, output_dim=1, hidden_size=16, num_layers=2,
                activation="tanh")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(4)))
    return jm, jp, params_from_jax(jp, "tanh")


@pytest.fixture
def batch():
    u = np.random.default_rng(4).uniform(size=(16, 2)).astype(np.float32)
    x = (math.pi * u[:, :1]).astype(np.float32)
    t = (3.0 * u[:, 1:]).astype(np.float32)
    z = np.zeros_like(x)
    return {"xt": np.concatenate([x, t], 1),
            "x0": np.concatenate([x, z], 1),
            "xb1": np.concatenate([z, t], 1),
            "xb2": np.concatenate([np.full_like(x, math.pi), t], 1)}


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_heat_fused_streams_match_jax(nets, batch):
    """(c) All 7 streams against ops.taylor.heat_fused_streams."""
    jm, jp, tm = nets
    want = jtaylor.heat_fused_streams(jm, jp, batch["xt"], batch["x0"],
                                      batch["xb1"], batch["xb2"])
    b = _t(batch)
    got = heat_fused_streams(tm, b["xt"], b["x0"], b["xb1"], b["xb2"])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


def test_jvp_taps_match_jax(nets, batch):
    """(c) value_dx_dxx and value_dt (torch.func.jvp) against ops.diff."""
    jm, jp, tm = nets
    f = lambda z: jm.apply(jp, z)  # noqa: E731
    xt = batch["xt"]
    want2 = jdiff.value_dx_dxx(f, jnp.asarray(xt), x_axis=0)
    want1 = jdiff.value_dt(f, jnp.asarray(xt), t_axis=1)
    got2 = value_dx_dxx(tm, torch.from_numpy(xt), x_axis=0)
    got1 = value_dt(tm, torch.from_numpy(xt), t_axis=1)
    for g, w in zip(list(got2) + list(got1), list(want2) + list(want1)):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("taps", ["jvp", "taylor"])
def test_point_loss_matches_jax(nets, batch, taps):
    """(d) Heat1D.point_loss for both tap modes; summed squares of order 1."""
    jm, jp, tm = nets
    jprob = JaxHeat1D(taps=taps, taps_model=jm)
    want = np.asarray(jprob.point_loss(jm.apply, jp, batch))
    got = Heat1D(taps=taps).point_loss(tm, _t(batch)).detach().numpy()
    assert got.shape == (16,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_grid_and_exact_match_jax():
    """(d) The 40×40 evaluation grid (linspace in fp32, 1-ulp tolerance) and
    the analytic solution (float64, identical)."""
    jprob, prob = JaxHeat1D(), Heat1D()
    np.testing.assert_allclose(prob.grid_inputs(40).numpy(),
                               np.asarray(jprob.grid_inputs(40)),
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(prob.exact(40), jprob.exact(40))
    assert prob.solution_shape(40) == (40, 40)


def test_sample_builds_the_four_point_sets():
    b = Heat1D().sample(32, generator=torch.Generator().manual_seed(0))
    assert set(b) == {"xt", "x0", "xb1", "xb2"}
    assert torch.all(b["x0"][:, 1] == 0) and torch.all(b["xb1"][:, 0] == 0)
    assert torch.all(b["xb2"][:, 0] == np.float32(math.pi))
    assert float(b["xt"][:, 0].max()) <= math.pi
    assert float(b["xt"][:, 1].max()) <= 3.0


def test_unported_modes_raise():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Heat1D(taps="pallas")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Heat1D(constraint="hard")
    with pytest.raises(ValueError, match="available: \\['heat'\\]"):
        get_problem("wave")
    assert PROBLEMS == {"heat": Heat1D}
