"""The port's periphery against the JAX package's, mirroring
tests/test_utils.py and tests/test_viz.py: utils/ (timing, manifests,
``temp_results`` IO, each file readable by the other package), viz.py (the
same MAE from the same arrays), the ``ops`` helpers ``time_jacobian``,
``hessian_diag`` and ``mlp_taps`` on parameters carried from JAX models,
``UniformBox``, and a checkpoint round trip of each tree kind.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from differential_equations_dnn_tpu import ops as jops  # noqa: E402
from differential_equations_dnn_tpu import utils as jutils  # noqa: E402
from differential_equations_dnn_tpu import viz as jviz  # noqa: E402
from differential_equations_dnn_tpu.models import DGM as JaxDGM  # noqa: E402
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu.ops.taylor import (  # noqa: E402
    mlp_taps as jax_mlp_taps,
)
from differential_equations_dnn_tpu_torch import ops, viz  # noqa: E402
from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    FitzHughNagumo,
    Heat1D,
    SimpleODE,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_engine,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    MLP,
    dgm_params_from_jax,
    params_from_jax,
)
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    TrainConfig,
    checkpoint_like,
    opt_state_from_jax,
    restore_checkpoint,
    save_checkpoint,
    train,
)
from differential_equations_dnn_tpu_torch.utils import (  # noqa: E402
    Timer,
    fn_timer,
    load_array,
    parameters_summary,
    results_dir,
    save_array,
)

ATOL = 1e-6


# ---------------------------------------------------------------------------
# utils/
# ---------------------------------------------------------------------------


def test_fn_timer_passthrough(capsys):
    @fn_timer
    def f(a, b=1):
        return a + b

    assert f(2, b=3) == 5
    assert f.__name__ == "f"
    assert "Total time running f" in capsys.readouterr().out


def test_timer_rate():
    with Timer() as t:
        sum(range(1000))
    assert t.elapsed > 0
    assert t.rate(100) > 0


def test_parameters_summary_writes_the_jax_manifest(tmp_path):
    params = {"iterations": 5000, "batch_size": 64, "lrate": 1e-4,
              "equation": "heat", "final_loss": 1.5e-3}
    pms = parameters_summary(params, tmp_path / "port", name="heat_run")
    jutils.parameters_summary(params, tmp_path / "jax", name="heat_run")
    text = pms.read_text()
    assert "iterations" in text and "5000" in text
    ours = json.loads((tmp_path / "port" / "heat_run.json").read_text())
    theirs = json.loads((tmp_path / "jax" / "heat_run.json").read_text())
    assert ours["params"] == theirs["params"] == params
    assert ours["name"] == theirs["name"] == "heat_run"
    # The .pms text differs only in its time stamp line.
    jax_lines = (tmp_path / "jax" / "heat_run.pms").read_text().splitlines()
    assert [l for i, l in enumerate(text.splitlines()) if i != 1] == \
        [l for i, l in enumerate(jax_lines) if i != 1]


def test_artifact_roundtrip_across_packages(tmp_path):
    arr = np.arange(12.0).reshape(3, 4)
    save_array("heat_sol_1d_dgm", arr, directory=tmp_path)
    np.testing.assert_array_equal(
        jutils.load_array("heat_sol_1d_dgm", directory=tmp_path), arr)
    jutils.save_array("heat_sol_exact_1d", arr.T, directory=tmp_path)
    np.testing.assert_array_equal(
        load_array("heat_sol_exact_1d.npy", directory=tmp_path), arr.T)
    # A tensor saves as its values.
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3).requires_grad_()
    path = save_array("t", t, directory=tmp_path / "sub")
    assert path.name == "t.npy"
    np.testing.assert_array_equal(load_array("t", tmp_path / "sub"),
                                  t.detach().numpy())
    assert results_dir(tmp_path / "new").is_dir()


# ---------------------------------------------------------------------------
# viz.py: the JAX package's MAE from the same arrays
# ---------------------------------------------------------------------------


def test_plot_solution_and_loss(tmp_path):
    grid = np.linspace(0, 1, 20)
    exact = 2 * np.exp(-grid)
    approx = exact + 0.01 * np.sin(7 * grid)
    loss = np.geomspace(1, 1e-4, 100)
    _, mae = viz.plot_solution_and_loss(grid, exact, approx, loss, "test",
                                        savepath=tmp_path / "a.pdf")
    _, want = jviz.plot_solution_and_loss(grid, exact, approx, loss, "test")
    assert (tmp_path / "a.pdf").exists()
    assert mae == want


def test_plot_heat(tmp_path):
    exact = np.random.default_rng(0).random((20, 20))
    approx = exact + 0.005 * np.random.default_rng(1).standard_normal(
        (20, 20))
    loss = np.geomspace(1, 1e-5, 500)
    _, mae = viz.plot_heat(exact, approx, loss, n_iters=500,
                           savepath=tmp_path / "h.pdf")
    _, want = jviz.plot_heat(exact, approx, loss, n_iters=500)
    assert (tmp_path / "h.pdf").exists()
    assert mae == want


def test_plot_fitzhugh_nagumo(tmp_path):
    t = np.linspace(0, 30, 50)
    exact = np.stack([np.sin(t), np.cos(t)], axis=1)
    approx = exact + 0.002 * np.cos(3 * t)[:, None]
    loss = np.geomspace(1, 1e-4, 100)
    _, mae = viz.plot_fitzhugh_nagumo(t, exact, approx, loss,
                                      savepath=tmp_path / "f.pdf")
    _, want = jviz.plot_fitzhugh_nagumo(t, exact, approx, loss)
    assert (tmp_path / "f.pdf").exists()
    assert mae == want


def test_plot_ablation(tmp_path):
    curves = {"4": np.geomspace(1, 1e-3, 400), "64": np.geomspace(1, 1e-4, 400)}
    fig = viz.plot_ablation(curves, savepath=tmp_path / "ab.pdf")
    assert (tmp_path / "ab.pdf").exists()
    want = jviz.plot_ablation(curves)
    assert len(fig.axes[0].child_axes) == len(want.axes[0].child_axes) == 1
    # Short curves skip smoothing and the inset's tail without error.
    viz.plot_ablation({"x": np.ones(10)}, savepath=tmp_path / "ab2.pdf",
                      smooth=50)
    assert (tmp_path / "ab2.pdf").exists()


# ---------------------------------------------------------------------------
# ops: the helpers against the JAX package's, on carried parameters
# ---------------------------------------------------------------------------


def _jax_mlp(D=2, O=1, seed=0):
    jm = JaxMLP(input_dim=D, output_dim=O, hidden_size=16, num_layers=2,
                activation="tanh")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, jp, params_from_jax(jp, "tanh")


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


def test_time_jacobian_matches_jax():
    """A DGM 1 → 2 (FitzHugh–Nagumo's layout) at a batch of times: one jvp
    gives both components' time derivatives."""
    jm = JaxDGM(input_dim=1, output_dim=2, hidden_size=8, num_layers=2,
                activation="tanh", init_scheme="torch")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(1)))
    model = dgm_params_from_jax(jp, "tanh", "torch")
    t = np.linspace(0.0, 3.0, 9, dtype=np.float32)[:, None]
    jy, jdy = jops.time_jacobian(lambda z: jm.apply(jp, z), jnp.asarray(t))
    y, dy = ops.time_jacobian(model, torch.from_numpy(t))
    assert dy.shape == (9, 2)
    _close(y, jy)
    _close(dy, jdy)


def test_hessian_diag_matches_jax():
    jm, jp, model = _jax_mlp(D=3)
    x = np.array([0.3, -0.7, 1.1], np.float32)
    want = jops.hessian_diag(lambda z: jm.apply(jp, z[None])[0, 0],
                             jnp.asarray(x))
    got = ops.hessian_diag(lambda z: model(z[None])[0, 0],
                           torch.from_numpy(x))
    assert got.shape == (3,)
    _close(got, want)


def test_hessian_diag_of_a_quadratic():
    a = torch.tensor([1.0, 2.0, 3.0])
    got = ops.hessian_diag(lambda x: torch.sum(a * x * x),
                           torch.tensor([0.5, 0.1, -0.2]))
    np.testing.assert_allclose(got.numpy(), 2 * a.numpy())


@pytest.mark.parametrize("v,w", [((1.0, 0.0), (0.0, 1.0)),
                                 ((0.6, 0.8), (1.0, -1.0))])
def test_mlp_taps_matches_jax(v, w):
    jm, jp, model = _jax_mlp()
    x = np.random.default_rng(3).uniform(0, 2, (11, 2)).astype(np.float32)
    want = jax_mlp_taps(jm, jp, jnp.asarray(x), jnp.asarray(v),
                        jnp.asarray(w))
    got = ops.mlp_taps(model, torch.from_numpy(x), torch.tensor(v), w)
    for g, j in zip(got, want):
        assert g.shape == (11, 1)
        _close(g, j)


def test_mlp_taps_refuses_batchnorm():
    with pytest.raises(ValueError, match="plain MLPs only"):
        ops.mlp_taps(MLP(2, 1, 8, 1, "tanh", batch_norm="pre"),
                     torch.zeros(3, 2), (1.0, 0.0), (0.0, 1.0))


def test_uniform_box_shape_and_bounds():
    box = ops.UniformBox((0.0, -1.0), (np.pi, 3.0))
    assert box.dim == 2
    x = box.sample(generator(0), 4096)
    assert x.shape == (4096, 2) and x.dtype == torch.float32
    lo, hi = torch.tensor([0.0, -1.0]), torch.tensor([np.pi, 3.0])
    assert bool(((x >= lo) & (x < hi)).all())
    # Uniform: the means near the boxes' centres; reproducible by seed.
    np.testing.assert_allclose(x.mean(0).numpy(), [np.pi / 2, 1.0],
                               atol=0.08)
    assert torch.equal(box(generator(0), 4096), x)
    assert not torch.equal(box(generator(1), 4096), x)


# ---------------------------------------------------------------------------
# Checkpoints: each tree kind round-trips onto the named device
# ---------------------------------------------------------------------------


def _assert_tree_equal(a, b):
    if torch.is_tensor(b):
        assert torch.is_tensor(a) and a.device.type == "cpu"
        assert torch.equal(a, b.cpu())
    elif isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _assert_tree_equal(a[k], b[k])
    elif isinstance(b, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_tree_equal(x, y)
    else:
        assert a == b


def test_checkpoint_scan_adam_tree_from_jax(tmp_path):
    """An optax Adam state carried across (opt_state_from_jax) with the
    model's state_dict: saved, restored against checkpoint_like, equal, and
    the resumed train() equals one on the unsaved state."""
    problem = SimpleODE()
    jm = JaxMLP(1, 1, 8, 1, "tanh")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    opt = optax.adam(1e-3)
    jstate = opt.init(jp)
    grads = jax.tree.map(lambda p: np.full_like(p, 0.1), jp)
    for _ in range(3):
        _, jstate = opt.update(grads, jstate, jp)
    model = params_from_jax(jp, "tanh")
    opt_state = opt_state_from_jax(jstate, model)
    tree = {"params": model.state_dict(), "opt_state": opt_state,
            "step": 3, "seed": 5}
    save_checkpoint(tmp_path / "ck", tree)
    config = TrainConfig(iterations=4, batch_size=8, lrate=1e-3,
                         verbose=False)
    like = checkpoint_like(problem, config, model=model)
    back = restore_checkpoint(tmp_path / "ck", like=like, device="cpu")
    _assert_tree_equal(back, tree)
    assert back["opt_state"]["param_groups"][0]["count"] == 3
    runs = []
    for state in (back, tree):
        m = params_from_jax(jp, "tanh")
        m.load_state_dict(state["params"])
        runs.append(train(problem, 5, config, model=m,
                          opt_state=state["opt_state"], start_step=3,
                          device="cpu").loss_history)
    np.testing.assert_array_equal(*runs)


def test_checkpoint_fused_moments(tmp_path):
    """The fused trainers' flat {"m", "v"}: their length is the model's
    parameter count, as checkpoint_like says."""
    problem = SimpleODE()
    res = fused_engine.train_fused_result(problem, 0, 6, batch_size=8,
                                          device="cpu")
    tree = {"params": res.params.state_dict(), "opt_state": res.opt_state,
            "step": 6, "seed": 0}
    save_checkpoint(tmp_path / "ck", tree)
    like = checkpoint_like(problem, TrainConfig(), engine="fused")
    back = restore_checkpoint(tmp_path / "ck", like=like, device="cpu")
    _assert_tree_equal(back, tree)
    with pytest.raises(ValueError, match="opt_state"):
        restore_checkpoint(tmp_path / "ck", device="cpu",
                           like=checkpoint_like(problem, TrainConfig()))


def test_checkpoint_batchnorm_state(tmp_path):
    problem = Heat1D()
    model = MLP(2, 1, 8, 1, "tanh", batch_norm="post",
                generator=generator(0))
    config = TrainConfig(iterations=5, batch_size=8, verbose=False)
    res = train(problem, 0, config, model=model, device="cpu")
    state = {"bn.mean": model.bn.mean, "bn.var": model.bn.var}
    tree = {"params": model.state_dict(), "opt_state": res.opt_state,
            "state": state, "step": 5, "seed": 0}
    save_checkpoint(tmp_path / "ck", tree)
    like = checkpoint_like(problem, config, model=model)
    assert set(like["state"]) == {"bn.mean", "bn.var"}
    back = restore_checkpoint(tmp_path / "ck", like=like, device="cpu")
    _assert_tree_equal(back, tree)
    with pytest.raises(ValueError, match="was expected"):
        wrong = checkpoint_like(problem, config, model=MLP(
            2, 1, 4, 1, "tanh", batch_norm="post"))
        restore_checkpoint(tmp_path / "ck", like=wrong, device="cpu")


def test_checkpoint_restore_needs_a_gpu_unless_asked(tmp_path, monkeypatch):
    save_checkpoint(tmp_path / "ck", {"step": 1, "seed": 0})
    with pytest.raises(FileExistsError):
        save_checkpoint(tmp_path / "ck", {"step": 2}, force=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        restore_checkpoint(tmp_path / "ck")
    assert restore_checkpoint(tmp_path / "ck", device="cpu")["step"] == 1


def test_checkpoint_like_touches_no_model_state():
    """checkpoint_like builds on the CPU: meta tensors of the model's
    shapes, the model's own parameters left as they were."""
    model = FitzHughNagumo().default_model(generator(0))
    before = {k: v.clone() for k, v in model.state_dict().items()}
    like = checkpoint_like(FitzHughNagumo(), TrainConfig(), model=model)
    assert all(t.device.type == "meta" for t in like["params"].values())
    assert {k: v.shape for k, v in like["params"].items()} == \
        {k: v.shape for k, v in before.items()}
    assert all(torch.equal(v, model.state_dict()[k])
               for k, v in before.items())
    assert "state" not in like
