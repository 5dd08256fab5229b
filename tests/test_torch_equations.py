"""The port's six new equations against the JAX package (grids, solution
shapes, exact solutions), JAX parameters carried across for their models,
``solve`` on the CPU for each, and the fused routes that still raise."""

import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from differential_equations_dnn_tpu.equations import (  # noqa: E402
    PROBLEMS as JAX_PROBLEMS,
)
from differential_equations_dnn_tpu_torch import solve  # noqa: E402
from differential_equations_dnn_tpu_torch.api import (  # noqa: E402
    _fused_route,
)
from differential_equations_dnn_tpu_torch.core import (  # noqa: E402
    generator,
)
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    PROBLEMS,
    Heat1D,
    Heat2D,
    Poisson2D,
    SimpleODE,
    Volterra2,
    Wave1D,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_engine as fe,
)
from differential_equations_dnn_tpu_torch.kernels.taylor_mlp import (  # noqa: E402,E501
    mlp_forward,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    MLP,
    HardConstraint,
    params_from_jax,
)

NEW = ["simple_ode", "burgers", "wave", "advection", "poisson", "heat2d"]
_DIM = {"simple_ode": 1, "heat2d": 3}


@pytest.mark.parametrize("name", NEW)
def test_grid_and_exact_match_jax(name):
    """(e) grid_inputs, solution_shape and exact against the JAX problem's
    (fp32 linspace on both sides: rtol 1e-6; exact in float64: 1e-12)."""
    ours, theirs = PROBLEMS[name](), JAX_PROBLEMS[name]()
    nodes = 7
    np.testing.assert_allclose(ours.grid_inputs(nodes).numpy(),
                               np.asarray(theirs.grid_inputs(nodes)),
                               rtol=1e-6, atol=1e-6)
    assert ours.solution_shape(nodes) == theirs.solution_shape(nodes)
    np.testing.assert_allclose(ours.exact(nodes), theirs.exact(nodes),
                               rtol=1e-12, atol=1e-12)
    assert ours.exact(nodes).shape == ours.solution_shape(nodes)
    for field in ("iterations", "batch_size", "lrate", "nodes", "schedule"):
        assert (getattr(ours.defaults, field)
                == getattr(theirs.defaults, field))


@pytest.mark.parametrize("name", NEW)
def test_default_model_matches_jax_shapes(name):
    """(e) The reference network of each equation, and the JAX package's
    parameters of it carried across by params_from_jax (D=1 with H=32,
    L=1 for simple_ode; D=3 for heat2d): the same forward on the same
    points to fp32 reassociation."""
    jm = JAX_PROBLEMS[name]().default_model()
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(3)))
    tm = params_from_jax(jp, "tanh")
    ours = PROBLEMS[name]().default_model(generator=generator(3))
    assert (tm.input_dim, tm.hidden_size, tm.num_layers) == \
        (ours.input_dim, ours.hidden_size, ours.num_layers)
    assert tm.input_dim == _DIM.get(name, 2)
    x = np.random.default_rng(3).uniform(
        size=(9, tm.input_dim)).astype(np.float32)
    np.testing.assert_allclose(tm(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jm.apply(jp, x)), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("name", NEW)
def test_solve_on_cpu_trains(name):
    """(f) ``solve(..., device="cpu")`` on the plain engine: finite history
    of the right length, the loss falls, a finite solution of the right
    shape."""
    model = MLP(_DIM.get(name, 2), 1, 16, 2, "tanh", generator=generator(0))
    res = solve(name, engine="fused", device="cpu", iterations=40,
                batch_size=16, lrate=3e-3, model=model, nodes=6)
    assert res.loss_history.shape == (40,)
    assert np.all(np.isfinite(res.loss_history))
    assert res.loss_history[-5:].mean() < res.loss_history[:5].mean()
    assert res.solution.shape == PROBLEMS[name]().solution_shape(6)
    assert np.isfinite(res.mae)


def test_heat2d_taylor_taps_match_jvp():
    """heat2d's stacked Taylor taps (ops.taylor.mlp_streams) against its
    jvp taps on the same points: fp32 reassociation."""
    model = MLP(3, 1, 16, 2, "tanh", generator=generator(5))
    u = torch.rand((12, 4), generator=generator(6))
    jvp, taylor = Heat2D(), Heat2D(taps="taylor")
    torch.testing.assert_close(
        taylor.point_loss(model, taylor.batch_from_uniforms(u)),
        jvp.point_loss(model, jvp.batch_from_uniforms(u)),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("problem, error, match", [
    (Heat1D(constraint="hard"), ValueError, "HardConstraint.*engine='scan'"),
    (types.SimpleNamespace(name="fredholm", quadrature="montecarlo"),
     ValueError, "DGM.*engine='scan'"),
    (Volterra2(quadrature="montecarlo"), ValueError,
     "volterra.*engine='scan'"),
])
def test_unported_routes_raise(problem, error, match):
    """(g) What the fused route does not run yet raises, naming ROADMAP;
    the stochastic quadratures, which train on the scan engine only (as in
    the JAX package), raise a ValueError naming engine='scan', and so does a
    plain MLP on a hard problem (the JAX package's fused_engine.supports:
    the hard spec trains the problem's HardConstraint)."""
    with pytest.raises(error, match=match):
        _fused_route(problem, MLP(2, 1, 8, 1, "tanh"))


@pytest.mark.parametrize("cls", [SimpleODE, Wave1D, Poisson2D, Heat2D])
def test_hard_constraints_raise(cls):
    """constraint="hard" wraps the default net in the equation's own
    trial function (the JAX package's default_model), and kernel #2 raises
    rather than evaluate the wrapper's raw net in its place
    (Problem.evaluate applies the ansatz after it)."""
    prob = cls(constraint="hard")
    model = prob.default_model(generator=generator(0))
    assert isinstance(model, HardConstraint)
    assert model.ansatz.tag == prob.hard_ansatz().tag
    assert isinstance(model.net, MLP) and model.net.activation == "tanh"
    x = prob.grid_inputs(3)
    with pytest.raises(ValueError, match="HardConstraint"):
        mlp_forward(model, x)


def test_routes():
    """Constant-lr heat keeps the specialised heat kernel; heat with a decay
    schedule and the six new equations take the generic engine."""
    heat = PROBLEMS["heat"]()
    model = heat.default_model()
    assert _fused_route(heat, model, "constant") == "heat"
    assert _fused_route(heat, model, "cosine") == "engine"
    for name in NEW:
        prob = PROBLEMS[name]()
        assert _fused_route(prob, prob.default_model(), "constant") == \
            "engine"
        assert fe.supports(prob)
    with pytest.raises(ValueError, match="3 → H×L → 1"):
        _fused_route(PROBLEMS["heat2d"](), model)


def test_ensemble_raises():
    """A packed ensemble at an unknown precision raises before it trains
    (the bf16 precisions "default" and "mixed" are ported:
    tests/test_torch_precision.py)."""
    with pytest.raises(ValueError, match="unknown precision"):
        solve("wave", engine="fused", device="cpu", ensemble=4,
              precision="fp16")
