"""The slice as a whole: chunk → evaluate → MAE against the JAX package on
the same parameters and uniforms, ``solve`` on the CPU, and what raises."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from differential_equations_dnn_tpu.equations import (  # noqa: E402
    Heat1D as JaxHeat1D,
)
from differential_equations_dnn_tpu.kernels import (  # noqa: E402
    fused_train as jft,
)
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu_torch import (  # noqa: E402
    SolveResult,
    solve,
)
from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    Heat1D,
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


def _small_model(seed=0):
    return MLP(2, 1, 16, 2, "tanh", generator=generator(seed))


def test_slice_matches_jax_end_to_end():
    """(g) The same params and uniforms through chunk → evaluate → MAE on
    both sides; equal MAE to rtol 1e-4 (fp32 reassociation through 8 Adam
    steps and a 10×10 grid forward)."""
    jm = JaxMLP(input_dim=2, output_dim=1, hidden_size=16, num_layers=2,
                activation="tanh")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(7)))
    u = np.random.default_rng(7).uniform(size=(8, 16, 2)).astype(np.float32)

    flat = jft.pack_params(jm, jp)
    zeros = tuple(jnp.zeros_like(t) for t in flat)
    pj, _, _, _ = jft.heat_fused_train_chunk(jm, flat, zeros, zeros,
                                             jnp.asarray(u), 0, 1e-3)
    mae_j = JaxHeat1D().mae(jm.apply, jft.unpack_params(jm, pj), nodes=10)

    tm = params_from_jax(jp, "tanh")
    p = ft.pack_params(tm)
    z = torch.zeros_like(p)
    pt, _, _, _ = ft.heat_fused_train_chunk(tm, p, z, z, torch.from_numpy(u),
                                            0, 1e-3)
    ft.load_params(tm, pt)
    prob = Heat1D()
    mae_t = prob.mae(tm, nodes=10)
    assert prob.evaluate(tm, 10).shape == (10, 10)
    np.testing.assert_allclose(mae_t, mae_j, rtol=1e-4)


def test_solve_on_cpu_cuts_the_loss():
    """(g) The plain path through ``solve`` trains: loss falls 10×."""
    res = solve("heat", engine="fused", device="cpu", iterations=300,
                batch_size=16, lrate=1e-3, model=_small_model(), nodes=10)
    assert isinstance(res, SolveResult)
    assert res.loss_history.shape == (300,)
    assert np.all(np.isfinite(res.loss_history))
    assert res.loss_history[-1] < res.loss_history[0] / 10
    assert res.solution.shape == (10, 10) and np.isfinite(res.mae)
    assert res.device == "cpu" and res.iters_per_sec > 0
    assert res.compile_time > 0 and res.wall_time > 0


def test_solve_is_reproducible_from_its_seed():
    kw = dict(engine="fused", device="cpu", iterations=5, batch_size=8,
              nodes=5)
    a = solve("heat", model=_small_model(3), seed=11, **kw)
    b = solve("heat", model=_small_model(3), seed=11, **kw)
    np.testing.assert_array_equal(a.loss_history, b.loss_history)


@pytest.mark.parametrize("kwargs, error, match", [
    (dict(engine="fused", taps="pallas"), ValueError, "scan"),
    (dict(engine="fused", precision="mixed", mesh=object()),
     ValueError, "SINGLE fused run"),
    (dict(engine="fused", precision="default", mesh=object()),
     ValueError, "SINGLE fused run"),
    (dict(engine="scan", ensemble=2), None, None),
    (dict(engine="turbo"), ValueError, "unknown engine"),
    (dict(engine="fused", model=MLP(2, 1, 8, 1, "relu")), ValueError,
     "tanh"),
])
def test_unported_options_raise(kwargs, error, match):
    """(i) What the slice does not run raises, naming the ROADMAP item.
    Since item 13 a scan-engine ensemble (a population) runs (``error``
    None). Since item 14 ``mesh=`` is ported: a single fused run (one
    kernel) refuses it with the JAX package's ValueError, at every
    precision."""
    if error is None:
        res = solve("heat", device="cpu", iterations=2, batch_size=8,
                    nodes=5, **kwargs)
        assert np.all(np.isfinite(res.solution))
        return
    with pytest.raises(error, match=match):
        solve("heat", device="cpu", iterations=2, batch_size=8, nodes=5,
              **kwargs)


def test_other_equations_raise():
    """Every equation of the JAX package is ported (volterra, uat and
    inverse_heat last); an unknown name still raises, naming what
    exists."""
    with pytest.raises(ValueError, match="available.*'volterra'"):
        solve("volterra2", engine="fused", device="cpu")


def test_heat_with_a_decay_schedule_takes_the_engine(monkeypatch):
    """Heat with ``schedule="cosine"`` trains on the generic engine (the
    heat kernel is constant-lr only); constant-lr heat stays on it."""
    calls = []
    real = fe.fused_engine_chunk

    def spy(*args, **kwargs):
        calls.append(kwargs["schedule"])
        return real(*args, **kwargs)

    monkeypatch.setattr(fe, "fused_engine_chunk", spy)
    res = solve("heat", engine="fused", device="cpu", iterations=6,
                batch_size=8, nodes=5, schedule="cosine",
                model=_small_model())
    assert calls and set(calls) == {"cosine"}
    assert res.loss_history.shape == (6,)
    calls.clear()
    solve("heat", engine="fused", device="cpu", iterations=2, batch_size=8,
          nodes=5, model=_small_model())
    assert not calls


def test_missing_gpu_raises(monkeypatch):
    """(i) ``device`` defaults to "cuda" and raises without a GPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solve("heat", engine="fused", iterations=2)
