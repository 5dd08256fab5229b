"""The port's CLI (differential_equations_dnn_tpu_torch/cli.py) against the
JAX package's, mirroring tests/test_cli.py at tiny budgets on the CPU
(``--platform cpu``): the reference's flag surface through the one entry
point, the ``temp_results/`` layout, the sweep and ablation subcommands,
and beyond it the parser flag for flag against the JAX parser, a port
``--plot`` of a JAX ``--solve``'s arrays, bit-for-bit resume on both
engines, and the refusal to run without a GPU unless asked for the CPU.
"""

import json
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from differential_equations_dnn_tpu.cli import (  # noqa: E402
    ARTIFACTS as JAX_ARTIFACTS,
)
from differential_equations_dnn_tpu.cli import (  # noqa: E402
    build_parser as jax_build_parser,
)
from differential_equations_dnn_tpu.cli import main as jax_main  # noqa: E402
from differential_equations_dnn_tpu_torch import cli  # noqa: E402
from differential_equations_dnn_tpu_torch.cli import (  # noqa: E402
    ARTIFACTS,
    build_parser,
)

CPU = ["--platform", "cpu"]


def main(argv):
    """The port's CLI on the CPU."""
    return cli.main(list(argv) + CPU)


def test_simple_ode_solve_and_plot(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rd = str(tmp_path / "temp_results")
    main(["simple-ode", "--solve", "--niters", "300", "--batch-size", "32",
          "--nnodes", "10", "--lrate", "1e-3", "--results-dir", rd])
    sol, loss, exact, _ = ARTIFACTS["simple_ode"]
    y = np.load(Path(rd) / f"{sol}.npy")
    assert y.shape == (10,)
    assert np.load(Path(rd) / f"{loss}.npy").shape == (300,)
    # Manifest written alongside.
    assert (Path(rd) / "simple_ode_run.pms").exists()
    # Plot phase reloads artifacts (the reference's resume split).
    main(["simple-ode", "--plot", "--savefig", "--nnodes", "10",
          "--results-dir", rd])
    assert (tmp_path / "figs/simple_ode_solution.pdf").exists()


def test_heat_solve_writes_reference_layout(tmp_path):
    rd = str(tmp_path / "temp_results")
    main(["heat", "--solve", "--niters", "50", "--batch-size", "16",
          "--nnodes", "8", "--results-dir", rd])
    assert (Path(rd) / "heat_sol_1d_dgm.npy").exists()
    assert (Path(rd) / "heat_sol_1d_dgm_loss.npy").exists()
    assert (Path(rd) / "heat_sol_exact_1d.npy").exists()
    assert np.load(Path(rd) / "heat_sol_1d_dgm.npy").shape == (8, 8)


def test_fredholm_gauss_flag(tmp_path):
    rd = str(tmp_path / "temp_results")
    main(["fredholm", "--solve", "--niters", "50", "--batch-size", "8",
          "--nnodes", "10", "--quadrature", "gauss", "--quad-nodes", "8",
          "--results-dir", rd])
    assert (Path(rd) / "fredholm_approx.npy").exists()


def test_checkpoint_flag(tmp_path):
    rd = str(tmp_path / "temp_results")
    ck = str(tmp_path / "ckpt")
    main(["simple-ode", "--solve", "--niters", "50", "--batch-size", "8",
          "--nnodes", "5", "--checkpoint", ck, "--results-dir", rd])
    assert any(Path(ck).iterdir())


def test_sweep_subcommand(tmp_path):
    rd = str(tmp_path / "temp_results")
    main(["sweep", "--equation", "simple_ode", "--num-samples", "3",
          "--max-iters", "100", "--max-batch-size", "32",
          "--results-dir", rd, "--seed", "1"])
    data = json.loads((Path(rd) / "sweep_simple_ode.json").read_text())
    assert "best_config" in data and len(data["configs"]) == 3


def test_sweep_asha_fused_subcommand(tmp_path):
    """--scheduler asha-fused / tpe-asha-fused run the in-kernel halving
    schedulers end to end through the CLI (tiny budgets, the kernels'
    plain versions)."""
    for sched in ("asha-fused", "tpe-asha-fused"):
        rd = str(tmp_path / f"tr_{sched}")
        main(["sweep", "--equation", "simple_ode", "--scheduler", sched,
              "--num-samples", "4", "--max-iters", "24", "--min-budget", "6",
              "--eta", "2", "--brackets", "2", "--max-batch-size", "8",
              "--results-dir", rd, "--seed", "1"])
        data = json.loads((Path(rd) / "sweep_simple_ode.json").read_text())
        assert len(data["configs"]) == 4
        assert data["best_config"]["n_iters"] == 24  # winner fully trained


def test_sweep_tpe_fused_concurrent_subcommand(tmp_path):
    """--scheduler tpe-fused --concurrent q: rounds of q proposals, each
    round one packed launch (the reference's max_concurrent=5 role)."""
    rd = str(tmp_path / "tr_conc")
    main(["sweep", "--equation", "simple_ode", "--scheduler", "tpe-fused",
          "--num-samples", "5", "--concurrent", "2", "--max-iters", "24",
          "--max-batch-size", "8", "--results-dir", rd, "--seed", "1"])
    data = json.loads((Path(rd) / "sweep_simple_ode.json").read_text())
    assert len(data["configs"]) == 5
    assert "best_config" in data


def test_ablation_batchnorm_subcommand(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    rd = str(tmp_path / "temp_results")
    main(["ablation-batchnorm", "--runs", "1", "--niters", "10",
          "--results-dir", rd])
    assert (Path(rd) / "relu_heat_loss_nobn.npy").exists()
    assert (Path(rd) / "relu_heat_loss_bn_pre.npy").exists()
    assert (Path(rd) / "relu_heat_loss_bn_post.npy").exists()


def test_parser_rejects_unknown_equation():
    with pytest.raises(SystemExit):
        build_parser().parse_args(["wave-equation", "--solve"])


def test_no_action_prints_hint(capsys):
    main(["simple-ode"])
    assert "Nothing to do" in capsys.readouterr().out


def test_checkpoint_restore_roundtrip(tmp_path):
    rd = str(tmp_path / "temp_results")
    ck = str(tmp_path / "ckpt")
    main(["simple-ode", "--solve", "--niters", "100", "--batch-size", "8",
          "--nnodes", "5", "--checkpoint", ck, "--results-dir", rd])
    main(["simple-ode", "--solve", "--niters", "50", "--batch-size", "8",
          "--nnodes", "5", "--restore", ck, "--results-dir", rd])
    # loss history from the resumed run exists and is the requested length
    loss = np.load(Path(rd) / "test_simple_ode_nn_loss.npy")
    assert loss.shape == (50,)


def test_restore_is_bit_identical(tmp_path):
    """--checkpoint/--restore resumes exactly: params, Adam moments and
    count, step and seed round-trip, and the step-keyed collocation stream
    makes the resumed run bit for bit an uninterrupted one."""
    rd_a = str(tmp_path / "a")
    rd_b = str(tmp_path / "b")
    ck = str(tmp_path / "ckpt")
    main(["simple-ode", "--solve", "--niters", "150", "--batch-size", "8",
          "--nnodes", "5", "--seed", "3", "--results-dir", rd_a])
    main(["simple-ode", "--solve", "--niters", "100", "--batch-size", "8",
          "--nnodes", "5", "--seed", "3", "--checkpoint", ck,
          "--results-dir", rd_b])
    main(["simple-ode", "--solve", "--niters", "50", "--batch-size", "8",
          "--nnodes", "5", "--seed", "3", "--restore", ck,
          "--results-dir", rd_b])
    sol_a = np.load(Path(rd_a) / "test_simple_ode_nn_sol.npy")
    sol_b = np.load(Path(rd_b) / "test_simple_ode_nn_sol.npy")
    np.testing.assert_array_equal(sol_a, sol_b)


def test_restore_overrides_mismatched_seed(tmp_path, capsys):
    ck = str(tmp_path / "ckpt")
    rd = str(tmp_path / "temp_results")
    main(["simple-ode", "--solve", "--niters", "30", "--batch-size", "8",
          "--nnodes", "5", "--seed", "7", "--checkpoint", ck,
          "--results-dir", rd])
    main(["simple-ode", "--solve", "--niters", "10", "--batch-size", "8",
          "--nnodes", "5", "--seed", "0", "--restore", ck,
          "--results-dir", rd])
    assert "using it instead" in capsys.readouterr().out


def test_fredholm_parity_flag(tmp_path):
    """--parity forces the reference-exact protocol: Monte-Carlo k=50
    quadrature and lr 1e-4 with a constant schedule (fredholm.py:142-144);
    the default is Gauss-Legendre and the tuned lr 3e-3 cosine."""
    rd = str(tmp_path / "temp_results")
    main(["fredholm", "--solve", "--niters", "30", "--batch-size", "8",
          "--nnodes", "10", "--parity", "--results-dir", rd])
    assert (Path(rd) / "fredholm_approx.npy").exists()
    manifest = json.loads((Path(rd) / "fredholm_run.json").read_text())
    assert manifest["params"]["lrate"] == pytest.approx(1e-4)
    assert manifest["params"]["schedule"] == "constant"
    parser = build_parser()
    args = parser.parse_args(["fredholm", "--solve"])
    assert args.quadrature == "gauss"
    assert args.lrate is None  # sentinel: resolved after --parity remap
    # A user-set --lrate survives --parity, even one equal to the tuned
    # default 3e-3, which a compare-by-value check could not tell apart.
    rd2 = str(tmp_path / "temp_results2")
    main(["fredholm", "--solve", "--niters", "30", "--batch-size", "8",
          "--nnodes", "10", "--parity", "--lrate", "3e-3",
          "--results-dir", rd2])
    manifest2 = json.loads((Path(rd2) / "fredholm_run.json").read_text())
    assert manifest2["params"]["lrate"] == pytest.approx(3e-3)


def test_sweep_grid_equation_default_cap(tmp_path):
    """Sweeping a fixed-grid equation with the default --max-batch-size 512
    clamps to the sampler's capacity instead of failing."""
    rd = str(tmp_path / "temp_results")
    main(["sweep", "--equation", "uat", "--num-samples", "2",
          "--max-iters", "30", "--results-dir", rd, "--seed", "1"])
    data = json.loads((Path(rd) / "sweep_uat.json").read_text())
    assert all(c["batch_size"] <= 50 for c in data["configs"])


def test_sweep_tpe_subcommand(tmp_path):
    rd = str(tmp_path / "temp_results")
    main(["sweep", "--equation", "simple_ode", "--scheduler", "tpe",
          "--num-samples", "4", "--max-iters", "60", "--max-batch-size", "16",
          "--results-dir", rd, "--seed", "1"])
    data = json.loads((Path(rd) / "sweep_simple_ode.json").read_text())
    assert len(data["configs"]) >= 4
    assert np.isfinite(data["best_score"])


def test_bn_model_checkpoint_roundtrip(tmp_path):
    """BatchNorm running statistics ride the checkpoint (``state``)."""
    from differential_equations_dnn_tpu_torch.equations import Heat1D
    from differential_equations_dnn_tpu_torch.models import MLP
    from differential_equations_dnn_tpu_torch.train import (
        TrainConfig,
        checkpoint_like,
        restore_checkpoint,
        save_checkpoint,
        train,
    )

    problem = Heat1D()
    model = MLP(2, 1, 8, 1, activation="tanh", batch_norm="pre")
    config = TrainConfig(iterations=10, batch_size=8, verbose=False)
    result = train(problem, 0, config, model=model, device="cpu")
    ck = tmp_path / "bn_ckpt"
    state = {"bn.mean": model.bn.mean, "bn.var": model.bn.var}
    save_checkpoint(ck, {"params": result.params.state_dict(),
                         "opt_state": result.opt_state, "state": state,
                         "step": 10, "seed": 0})
    like = checkpoint_like(problem, config, model=model)
    ckpt = restore_checkpoint(ck, like=like, device="cpu")
    np.testing.assert_array_equal(ckpt["state"]["bn.mean"].numpy(),
                                  model.bn.mean.numpy())
    assert not torch.equal(model.bn.mean, torch.zeros_like(model.bn.mean))


def test_ensemble_flag(tmp_path):
    rd = str(tmp_path / "temp_results")
    main(["simple-ode", "--solve", "--niters", "60", "--batch-size", "8",
          "--nnodes", "5", "--ensemble", "3", "--results-dir", rd])
    assert np.load(Path(rd) / "test_simple_ode_nn_loss.npy").shape == (60,)


def test_export_flag(tmp_path):
    from differential_equations_dnn_tpu_torch.serving import load_solution

    rd = str(tmp_path / "temp_results")
    ex = str(tmp_path / "sol.pt2")
    main(["simple-ode", "--solve", "--niters", "50", "--batch-size", "8",
          "--nnodes", "5", "--export", ex, "--results-dir", rd])
    fn = load_solution(ex, device="cpu")
    assert fn(np.zeros((3, 1), np.float32)).shape == (3, 1)


def test_heat_taps_flag(tmp_path):
    rd = str(tmp_path / "temp_results")
    main(["heat", "--solve", "--niters", "40", "--batch-size", "16",
          "--nnodes", "8", "--taps", "taylor", "--results-dir", rd])
    assert np.load(Path(rd) / "heat_sol_1d_dgm_loss.npy").shape == (40,)


def test_heat2d_cli(tmp_path):
    rd = str(tmp_path / "temp_results")
    main(["heat2d", "--solve", "--plot", "--niters", "40", "--batch-size",
          "32", "--nnodes", "6", "--results-dir", rd])
    assert np.load(Path(rd) / "heat_sol_2d_dgm.npy").shape == (6, 6, 6)


def test_export_inverse_heat(tmp_path):
    """--export on inverse_heat, whose model wraps the net and κ̂."""
    from differential_equations_dnn_tpu_torch.serving import load_solution

    rd = str(tmp_path / "temp_results")
    ex = str(tmp_path / "inv.pt2")
    main(["inverse-heat", "--solve", "--niters", "40", "--batch-size", "8",
          "--nnodes", "5", "--export", ex, "--results-dir", rd])
    fn = load_solution(ex, device="cpu")
    assert fn(np.zeros((2, 2), np.float32)).shape == (2, 1)


def test_fused_engine_restore_bit_identical(tmp_path):
    """The fused engine checkpoints and resumes exactly like the scan
    engine: Adam moments, absolute-step bias correction and per-step-keyed
    collocation draws make the resumed run bit for bit the uncut one."""
    rd_a = str(tmp_path / "a")
    rd_b = str(tmp_path / "b")
    ck = str(tmp_path / "ckpt")
    base = ["heat", "--solve", "--engine", "fused", "--batch-size", "16",
            "--nnodes", "5", "--seed", "3"]
    main(base + ["--niters", "100", "--results-dir", rd_a])
    main(base + ["--niters", "60", "--checkpoint", ck, "--results-dir", rd_b])
    main(base + ["--niters", "40", "--restore", ck, "--results-dir", rd_b])
    sol_a = np.load(Path(rd_a) / "heat_sol_1d_dgm.npy")
    sol_b = np.load(Path(rd_b) / "heat_sol_1d_dgm.npy")
    np.testing.assert_array_equal(sol_a, sol_b)


def test_poisson_cli(tmp_path):
    rd = str(tmp_path / "temp_results")
    main(["poisson", "--solve", "--plot", "--niters", "40", "--batch-size",
          "32", "--nnodes", "6", "--results-dir", rd])
    assert np.load(Path(rd) / "poisson_sol_dgm.npy").shape == (6, 6)


def test_volterra_cli_quadrature_flag(tmp_path):
    rd = str(tmp_path / "temp_results")
    main(["volterra", "--solve", "--plot", "--niters", "40", "--batch-size",
          "16", "--nnodes", "8", "--quadrature", "montecarlo",
          "--quad-nodes", "12", "--results-dir", rd])
    assert np.load(Path(rd) / "volterra_approx.npy").shape == (8,)


# ---------------------------------------------------------------------------
# Beyond tests/test_cli.py
# ---------------------------------------------------------------------------


def _flags(parser):
    """{subcommand: {option strings: (dest, choices, default, nargs,
    action type)}} of a parser; --platform and help texts aside, the two
    packages' must agree (in any order: the packages register their
    equations in different orders)."""
    sub = next(a for a in parser._actions
               if isinstance(a, type(parser._subparsers._group_actions[0])))
    out = {}
    for name, p in sub.choices.items():
        out[name] = {tuple(a.option_strings): (
            a.dest, sorted(a.choices) if a.choices else None,
            None if a.dest == "platform" else a.default,
            a.nargs, type(a).__name__) for a in p._actions}
    return out


def test_parser_matches_the_jax_parser():
    """The same subcommands, and in each the same option strings with the
    same destinations, choices, defaults and actions (--platform defaults
    to cuda here, to no JAX platform there)."""
    ours, theirs = _flags(build_parser()), _flags(jax_build_parser())
    assert sorted(ours) == sorted(theirs)
    assert len(ours) == 15
    for name in ours:
        assert ours[name] == theirs[name], name
    assert build_parser().parse_args(["heat"]).taps == "taylor"
    assert build_parser().parse_args(["heat"]).platform == "cuda"


def test_artifacts_equal_the_jax_clis():
    assert ARTIFACTS == JAX_ARTIFACTS


def _mae_line(text):
    return re.findall(r"DGM MAE: (\S+)", text)[-1]


@pytest.mark.parametrize("equation,shape", [("simple-ode", (6,)),
                                            ("heat", (6, 6))])
def test_plot_of_a_jax_solve_gives_the_jax_mae(tmp_path, monkeypatch, capsys,
                                               equation, shape):
    """A JAX --solve's arrays: the port's --plot reads them (same names and
    shapes as its own --solve writes) and prints the JAX --plot's MAE."""
    monkeypatch.chdir(tmp_path)
    rd = str(tmp_path / "jax")
    jax_main([equation, "--solve", "--niters", "30", "--batch-size", "8",
              "--nnodes", "6", "--results-dir", rd])
    jax_main([equation, "--plot", "--niters", "30", "--results-dir", rd])
    want = _mae_line(capsys.readouterr().out)
    main([equation, "--plot", "--savefig", "--niters", "30",
          "--results-dir", rd])
    assert _mae_line(capsys.readouterr().out) == want
    name = equation.replace("-", "_")
    assert (tmp_path / ARTIFACTS[name][3]).exists()
    ours = str(tmp_path / "port")
    main([equation, "--solve", "--niters", "30", "--batch-size", "8",
          "--nnodes", "6", "--results-dir", ours])
    for artifact in ARTIFACTS[name][:3]:
        a = np.load(Path(rd) / f"{artifact}.npy")
        b = np.load(Path(ours) / f"{artifact}.npy")
        assert a.shape == b.shape and a.dtype == b.dtype, artifact
    assert np.load(Path(ours) / f"{ARTIFACTS[name][0]}.npy").shape == shape
    jax_keys = json.loads((Path(rd) / f"{name}_run.json").read_text())
    our_keys = json.loads((Path(ours) / f"{name}_run.json").read_text())
    assert set(our_keys["params"]) == set(jax_keys["params"])


@pytest.mark.parametrize("engine,first,second", [
    ("scan", 60, 40), ("scan", 300, 700), ("fused", 60, 40),
    ("fused", 300, 700)])
def test_resume_is_bit_for_bit(tmp_path, engine, first, second):
    """--checkpoint after ``first`` steps and --restore for ``second`` more
    give an uncut run's solution and the tail of its loss history, bit for
    bit, on either engine."""
    base = ["heat", "--solve", "--engine", engine, "--batch-size", "4",
            "--nnodes", "5", "--seed", "2"]
    ck = str(tmp_path / "ck")
    main(base + ["--niters", str(first + second), "--results-dir",
                 str(tmp_path / "a")])
    main(base + ["--niters", str(first), "--checkpoint", ck,
                 "--results-dir", str(tmp_path / "b")])
    main(base + ["--niters", str(second), "--restore", ck,
                 "--results-dir", str(tmp_path / "b")])
    for name in ("heat_sol_1d_dgm", "heat_sol_1d_dgm_loss"):
        a = np.load(tmp_path / "a" / f"{name}.npy")
        b = np.load(tmp_path / "b" / f"{name}.npy")
        np.testing.assert_array_equal(a[-len(b):] if a.ndim == 1 else a, b)


def test_heat_fused_driver_resumes_from_a_flat_state():
    """train_heat_fused_result takes params, opt_state and start_step as
    the other fused drivers do: 20 steps, then 15 from the flat state,
    equal the uncut 35."""
    from differential_equations_dnn_tpu_torch.equations import Heat1D
    from differential_equations_dnn_tpu_torch.kernels import fused_train as ft

    problem = Heat1D()
    kw = dict(batch_size=4, lrate=1e-3, device="cpu")
    whole = ft.train_heat_fused_result(problem, 7, 35, **kw)
    first = ft.train_heat_fused_result(problem, 7, 20, **kw)
    second = ft.train_heat_fused_result(
        problem, 7, 15, params=ft.pack_params(first.params),
        opt_state=first.opt_state, start_step=20, **kw)
    np.testing.assert_array_equal(second.loss_history,
                                  whole.loss_history[20:])
    assert torch.equal(ft.pack_params(second.params),
                       ft.pack_params(whole.params))


def test_no_gpu_exits_unless_asked_for_the_cpu(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rd = str(tmp_path / "temp_results")
    argv = ["simple-ode", "--solve", "--niters", "5", "--results-dir", rd]
    with pytest.raises(SystemExit) as exc:
        cli.main(argv)
    assert exc.value.code not in (0, None)
    assert "--platform cpu" in str(exc.value.code)
    assert not Path(rd).exists()
    cli.main(argv + CPU)
    assert (Path(rd) / "test_simple_ode_nn_sol.npy").exists()


def test_plot_without_matplotlib(tmp_path, monkeypatch, capsys):
    """Without matplotlib --plot still prints the MAE (no figure is drawn)
    and --savefig exits naming matplotlib."""
    import sys

    import differential_equations_dnn_tpu_torch as pkg

    rd = str(tmp_path / "temp_results")
    main(["simple-ode", "--solve", "--niters", "20", "--nnodes", "6",
          "--results-dir", rd])
    main(["simple-ode", "--plot", "--results-dir", rd])
    want = _mae_line(capsys.readouterr().out)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.delitem(sys.modules, "differential_equations_dnn_tpu_torch.viz",
                        raising=False)
    monkeypatch.delattr(pkg, "viz", raising=False)
    main(["simple-ode", "--plot", "--results-dir", rd])
    out = capsys.readouterr().out
    assert "no figure drawn" in out and _mae_line(out) == want
    with pytest.raises(SystemExit, match="matplotlib"):
        main(["simple-ode", "--plot", "--savefig", "--results-dir", rd])
    with pytest.raises(SystemExit, match="matplotlib"):
        main(["ablation-batchnorm", "--savefig", "--runs", "1", "--niters",
              "2", "--results-dir", rd])


def test_fused_engine_with_mesh_exits(tmp_path):
    with pytest.raises(SystemExit, match="--mesh"):
        main(["heat", "--solve", "--engine", "fused", "--mesh", "2",
              "--niters", "5", "--results-dir", str(tmp_path)])


def test_a_jax_checkpoint_carried_into_the_port_resumes(tmp_path):
    """A JAX CLI checkpoint (orbax) carried across with params_from_jax and
    opt_state_from_jax into a port checkpoint: the port's --restore resumes
    it, and its run equals the port's train() from the same state."""
    from differential_equations_dnn_tpu.equations import (
        SimpleODE as JaxSimpleODE,
    )
    from differential_equations_dnn_tpu.train import (
        TrainConfig as JaxTrainConfig,
    )
    from differential_equations_dnn_tpu.train import (
        checkpoint_like as jax_like,
    )
    from differential_equations_dnn_tpu.train import restore_checkpoint as jr

    from differential_equations_dnn_tpu_torch.equations import SimpleODE
    from differential_equations_dnn_tpu_torch.models import params_from_jax
    from differential_equations_dnn_tpu_torch.train import (
        TrainConfig,
        opt_state_from_jax,
        save_checkpoint,
        train,
    )

    jck = str(tmp_path / "jax_ck")
    jax_main(["simple-ode", "--solve", "--niters", "20", "--batch-size", "8",
              "--nnodes", "5", "--seed", "4", "--checkpoint", jck,
              "--results-dir", str(tmp_path / "j")])
    tree = jr(jck, like=jax_like(JaxSimpleODE(), JaxTrainConfig(
        iterations=20, batch_size=8), seed=4))
    model = params_from_jax(tree["params"], "tanh")
    opt_state = opt_state_from_jax(tree["opt_state"], model)
    ck = str(tmp_path / "ck")
    save_checkpoint(ck, {"params": model.state_dict(),
                         "opt_state": opt_state,
                         "step": int(tree["step"]),
                         "seed": int(tree["seed"])})
    rd = tmp_path / "p"
    main(["simple-ode", "--solve", "--niters", "15", "--batch-size", "8",
          "--nnodes", "5", "--restore", ck, "--results-dir", str(rd)])
    want = train(SimpleODE(), 4, TrainConfig(iterations=15, batch_size=8,
                                             lrate=1e-4, verbose=False),
                 model=params_from_jax(tree["params"], "tanh"),
                 opt_state=opt_state, start_step=20, device="cpu")
    np.testing.assert_array_equal(
        np.load(rd / "test_simple_ode_nn_loss.npy"), want.loss_history)
