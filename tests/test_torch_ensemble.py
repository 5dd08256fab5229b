"""The port's packed-replica path (kernels/engine_core.py run_fused_packed,
fused_engine_packed_chunk, fused_dgm_packed_chunk, the two ensemble
drivers), the ensemble branch of solve and train/finetune.py, against the
JAX package on the same numpy uniforms and parameters. The JAX packed chunks
run their Pallas kernel in interpret mode on the CPU, as the JAX package's
own tests run it. Small sizes: H=8, L=2, B=8, K=3, N=3."""

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
    engine_core as jec,
)
from differential_equations_dnn_tpu.kernels import (  # noqa: E402
    fused_dgm as jfd,
)
from differential_equations_dnn_tpu.kernels import (  # noqa: E402
    fused_engine as jfe,
)
from differential_equations_dnn_tpu.kernels import (  # noqa: E402
    fused_train as jft,
)
from differential_equations_dnn_tpu.models import DGM as JaxDGM  # noqa: E402
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu.train import (  # noqa: E402
    finetune_lbfgs as jax_finetune_lbfgs,
)
from differential_equations_dnn_tpu_torch import api, solve  # noqa: E402
from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.core.prng import (  # noqa: E402
    replica_generator,
)
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    PROBLEMS,
    FitzHughNagumo,
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
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_train as ft,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    DGM,
    MLP,
    dgm_params_from_jax,
    params_from_jax,
)
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    finetune_lbfgs,
)

H, L, B, K, N = 8, 2, 8, 3, 3
LR = 1e-3
STEP0 = 4
SCHED = dict(schedule="cosine", total_steps=10, decay=0.1)
_DIM = {"heat2d": 3}
# case -> (equation, problem kwargs, gate activation, init scheme, outputs)
_DGM = {
    "fn_causal": ("fitzhugh_nagumo", dict(causal_eps=5.0), "tanh", "torch",
                  2),
    "fn_eps0": ("fitzhugh_nagumo", dict(causal_eps=0.0), "tanh", "torch", 2),
    "fredholm": ("fredholm", dict(k=12), "relu", "xavier_relu", 1),
}


def _uniforms(shape, U, seed=0):
    return np.random.default_rng(seed).uniform(
        size=shape + (U,)).astype(np.float32)


def _zeros(stacked):
    return tuple(jnp.zeros_like(t) for t in stacked)


def _mlp_replicas(name):
    """N JAX MLPs' parameters and the same parameters as port MLPs."""
    jm = JaxMLP(input_dim=_DIM.get(name, 2), output_dim=1, hidden_size=H,
                num_layers=L, activation="tanh")
    jps = [jax.tree.map(np.asarray, jm.init(jax.random.key(r)))
           for r in range(N)]
    return jm, jps, [params_from_jax(jp, "tanh") for jp in jps]


def _dgm_replicas(case):
    _, _, act, scheme, O = _DGM[case]
    jm = JaxDGM(input_dim=1, output_dim=O, hidden_size=H, num_layers=L,
                activation=act, init_scheme=scheme)
    jps = [jax.tree.map(np.asarray, jm.init(jax.random.key(10 + r)))
           for r in range(N)]
    return jm, jps, [dgm_params_from_jax(jp, act, scheme) for jp in jps]


def _assert_replicas(ours, theirs, unpack):
    """Port [N, n] rows against JAX per-replica tuples: rtol 1e-5 / atol
    1e-6 (fp32 reassociation of the B-row sums over K Adam steps)."""
    for row, jt in zip(ours, theirs):
        for a, b in zip(unpack(row), jt):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


# ---------------------------------------------------------------------------
# The packed chunks against JAX (Pallas interpret mode)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rep_tile", [None, 3])
@pytest.mark.parametrize("name", ["wave", "heat2d"])
def test_engine_packed_chunk_matches_jax(name, rep_tile):
    """K=3 Adam steps of N=3 MLP replicas from step 4 under a cosine
    schedule against JAX fused_engine_packed_chunk on the same uniforms and
    stack_replicas of the same parameters: losses [N, K] to rtol 1e-5;
    parameters and moments to rtol 1e-5 / atol 1e-6."""
    jm, jps, tms = _mlp_replicas(name)
    jspec = jfe.spec_for(JAX_PROBLEMS[name]())
    spec = fe.spec_for(PROBLEMS[name]())
    u = _uniforms((K, B), spec.n_uniform, seed=1)
    flat = jec.stack_replicas([jft.pack_params(jm, jp) for jp in jps])
    pj, mj, vj, lj = jfe.fused_engine_packed_chunk(
        jspec, jm, flat, _zeros(flat), _zeros(flat), jnp.asarray(u), STEP0,
        LR, N, rep_tile=rep_tile, **SCHED)
    p = engine_core.stack_replicas([ft.pack_params(tm) for tm in tms])
    z = torch.zeros_like(p)
    pt, mt, vt, lt = fe.fused_engine_packed_chunk(
        spec, tms[0], p, z, z, torch.from_numpy(u), STEP0, LR, N, rep_tile,
        **SCHED)
    assert lt.shape == (N, K) and pt.shape == p.shape
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    shapes = jfe._shapes_for(jspec, jm)
    for ours, theirs in ((pt, pj), (mt, mj), (vt, vj)):
        _assert_replicas(ours, jec.unstack_replicas(theirs, shapes, N),
                         lambda row: ft.unpack_params(tms[0], row))


@pytest.mark.parametrize("rep_tile", [None, 3])
@pytest.mark.parametrize("case", sorted(_DGM))
def test_dgm_packed_chunk_matches_jax(case, rep_tile):
    """The same for N=3 DGM replicas against JAX fused_dgm_packed_chunk:
    FitzHugh–Nagumo causal and with causal_eps=0, and Fredholm (k=12, R=3)
    with its const shared by the replicas."""
    eq, kw, *_ = _DGM[case]
    jprob, prob = JAX_PROBLEMS[eq](**kw), PROBLEMS[eq](**kw)
    jm, jps, tms = _dgm_replicas(case)
    jspec, spec = jfd.spec_for(jprob, B), fd.spec_for(prob, B)
    jconst = const = None
    if eq == "fredholm":
        jconst = jfd._fredholm_const(jprob, B, jspec.n_groups)
        const = fd.const_for(spec, prob, B)
    u = _uniforms((K, B), 1, seed=2)
    flat = jec.stack_replicas([jfd.pack_dgm(jp) for jp in jps])
    pj, mj, vj, lj = jfd.fused_dgm_packed_chunk(
        jspec, jm, flat, _zeros(flat), _zeros(flat), jnp.asarray(u), STEP0,
        LR, N, rep_tile=rep_tile, const=jconst, **SCHED)
    p = engine_core.stack_replicas([fd.pack_dgm(tm) for tm in tms])
    z = torch.zeros_like(p)
    pt, mt, vt, lt = fd.fused_dgm_packed_chunk(
        spec, tms[0], p, z, z, torch.from_numpy(u), STEP0, LR, N, rep_tile,
        const=const, **SCHED)
    assert lt.shape == (N, K)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5)
    shapes = fd.param_shapes(tms[0])
    for ours, theirs in ((pt, pj), (mt, mj), (vt, vj)):
        _assert_replicas(ours, jec.unstack_replicas(theirs, shapes, N),
                         lambda row: fd.unpack_dgm(tms[0], row))


# ---------------------------------------------------------------------------
# The layout, the limits and what raises
# ---------------------------------------------------------------------------


def test_stack_replicas_layout():
    """The port's packed state is [N, n], replica-major, as the JAX fold of
    one flat tensor per replica; unstack inverts it (views)."""
    flats = [torch.arange(5.0) + 10 * r for r in range(N)]
    packed = engine_core.stack_replicas(flats)
    want = jec.stack_replicas([(jnp.asarray(f.numpy()),) for f in flats])[0]
    np.testing.assert_array_equal(packed.numpy(), np.asarray(want))
    assert packed.shape == (N, 5)
    for a, b in zip(engine_core.unstack_replicas(packed, (5,), N), flats):
        assert torch.equal(a, b)
    mats = [torch.rand(4, 2) for _ in range(N)]
    packed = engine_core.stack_replicas(mats)
    assert packed.shape == (N * 4, 2)
    for a, b in zip(engine_core.unstack_replicas(packed, (4, 2), N), mats):
        assert torch.equal(a, b)


def test_packed_limits():
    """N·R within the grid's y/z extent (65 535), N copies of the scratch in
    free memory, rep_tile dividing N: each raises before any launch."""
    engine_core.check_replicas(16, 3, 1 << 20, 16 << 20)
    engine_core.check_replicas(65_535 // 11, 11)
    with pytest.raises(ValueError, match="65535"):
        engine_core.check_replicas(65_535 // 11 + 1, 11)
    with pytest.raises(ValueError, match="free"):
        engine_core.check_replicas(16, 3, 1 << 20, (16 << 20) - 1)
    with pytest.raises(ValueError, match="at least 1"):
        engine_core.check_replicas(0, 3)
    _, _, tms = _mlp_replicas("wave")
    spec = fe.spec_for(PROBLEMS["wave"]())
    p = engine_core.stack_replicas([ft.pack_params(tm) for tm in tms])
    with pytest.raises(ValueError, match="rep_tile"):
        fe.fused_engine_packed_chunk(spec, tms[0], p, p, p,
                                     torch.zeros(1, B, 2), 0, LR, N, 2)


@pytest.mark.parametrize("option, value", [
    ("lr_vec", torch.tensor([1e-3, 3e-3, 1e-2])),
    ("bs_vec", torch.tensor([8, 5, 1])),
    ("steps_vec", torch.tensor([3, 0, 2])), ("mask_rows", True),
])
def test_packed_sweep_mode_raises(option, value):
    """The per-slot sweep vectors run: each slot of the packed
    DGM chunk (FitzHugh–Nagumo at causal_eps = 0: a masked loss is the
    plain one) equals the single chunk at its own lr and budget bit for bit
    (a budget of 0: the slot as it went in, losses 0); a batch vector alone
    masks nothing, and mask_rows alone masks at B (the unmasked loss to
    rtol 1e-5 / atol 1e-6)."""
    _, _, tms = _dgm_replicas("fn_eps0")
    spec = fd.spec_for(FitzHughNagumo(causal_eps=0.0))
    p = engine_core.stack_replicas([fd.pack_dgm(tm) for tm in tms])
    z = torch.zeros_like(p)
    u = torch.from_numpy(np.random.default_rng(3).uniform(
        size=(K, B, 1)).astype(np.float32))
    got = fd.fused_dgm_packed_chunk(spec, tms[0], p, z, z, u, 0, LR, N,
                                    **{option: value})
    for r in range(N):
        kw = {}
        lr = float(value[r]) if option == "lr_vec" else LR
        if option == "steps_vec":
            kw["runtime_steps"] = int(value[r])
        want = fd.fused_dgm_chunk(spec, tms[0], p[r], z[r], z[r], u, 0, lr,
                                  **kw)
        for a, b in zip(got, want):
            if option == "mask_rows":
                torch.testing.assert_close(a[r], b, rtol=1e-5, atol=1e-6)
            else:
                assert torch.equal(a[r], b)
    if option == "steps_vec":
        assert torch.equal(got[0][1], p[1]) and not got[3][1].any()


def test_replica_generators():
    """Replica r's init depends on (seed, r) alone: reproducible, distinct
    across r and seeds, and none is the single run's generator(seed)."""
    draws = {(s, r): torch.rand(4, generator=replica_generator(s, r))
             for s in (0, 1) for r in range(3)}
    assert torch.equal(draws[0, 1],
                       torch.rand(4, generator=replica_generator(0, 1)))
    assert len({tuple(d.tolist()) for d in draws.values()}) == 6
    single = torch.rand(4, generator=generator(0))
    assert not any(torch.equal(single, d) for d in draws.values())


# ---------------------------------------------------------------------------
# The ensemble drivers
# ---------------------------------------------------------------------------

_DRIVERS = {
    "wave": (fe.train_fused_ensemble_packed, fe.train_fused_result,
             lambda: MLP(2, 1, H, L, "tanh"), ft.pack_params),
    "fredholm": (fd.train_dgm_fused_ensemble_packed,
                 fd.train_dgm_fused_result,
                 lambda: DGM(1, 1, H, 1, "relu", "xavier_relu"),
                 fd.pack_dgm),
}


@pytest.mark.parametrize("name", sorted(_DRIVERS))
def test_ensemble_replica_equals_its_single_run(name):
    """Replica r of the packed driver equals the single-replica driver on
    replica r's init (``replica_generator(seed, r)``), on the same
    collocation stream and schedule, bit for bit: losses and parameters."""
    packed, single, model, pack = _DRIVERS[name]
    prob = PROBLEMS[name]()
    kw = dict(batch_size=B, lrate=LR, device="cpu")
    res = packed(prob, 5, 6, N, model=model(), **kw)
    assert res.loss_history.shape == (N, 6) and len(res.params) == N
    assert res.compile_time > 0 and res.iters_per_sec > 0
    for r in range(N):
        one = single(prob, 5, 6, model=model().fresh(replica_generator(5, r)),
                     **kw)
        np.testing.assert_array_equal(res.loss_history[r], one.loss_history)
        assert torch.equal(pack(res.params[r]), pack(one.params))


@pytest.mark.parametrize("name", sorted(_DRIVERS))
def test_ensemble_chunked_run_is_bit_identical(name):
    """Chunks of 2 steps equal one uncut 5-step chunk, bit for bit."""
    packed, _, model, pack = _DRIVERS[name]
    prob = PROBLEMS[name]()
    kw = dict(batch_size=B, lrate=LR, device="cpu", model=model())
    uncut = packed(prob, 2, 5, N, **kw)
    cut = packed(prob, 2, 5, N, chunk_size=2, **kw)
    np.testing.assert_array_equal(cut.loss_history, uncut.loss_history)
    for a, b in zip(cut.params, uncut.params):
        assert torch.equal(pack(a), pack(b))
    assert torch.equal(cut.opt_state["v"], uncut.opt_state["v"])


# ---------------------------------------------------------------------------
# solve's ensemble branch and the polish
# ---------------------------------------------------------------------------


def test_solve_ensemble_picks_the_lowest_validation_residual():
    """``solve(..., ensemble=3)`` keeps the replica whose plain mean residual
    on validation_sample(4096) from seed + 1 is lowest, and reports
    population steps per second."""
    prob = PROBLEMS["wave"]()
    kw = dict(batch_size=B, lrate=LR, device="cpu")
    res = solve("wave", engine="fused", iterations=6, nodes=5, seed=3,
                ensemble=N, model=MLP(2, 1, H, L, "tanh"), **kw)
    ens = fe.train_fused_ensemble_packed(prob, 3, 6, N,
                                         model=MLP(2, 1, H, L, "tanh"), **kw)
    val = prob.validation_sample(4096, generator(4))
    with torch.no_grad():
        resid = [float(torch.mean(prob.point_loss(m, val)))
                 for m in ens.params]
    pick = int(np.argmin(resid))
    assert torch.equal(ft.pack_params(res.params),
                       ft.pack_params(ens.params[pick]))
    np.testing.assert_array_equal(res.loss_history, ens.loss_history[pick])
    assert res.iters_per_sec == pytest.approx(6 / res.wall_time)
    assert np.isfinite(res.mae) and res.solution.shape == (5, 5)


def test_solve_ensemble_skips_non_finite_residuals(monkeypatch):
    """A replica whose residual is not finite is never picked."""
    seen = iter([float("nan"), 0.7, 0.5])
    monkeypatch.setattr(api, "_residual", lambda *a: next(seen))
    res = solve("wave", engine="fused", device="cpu", iterations=2,
                batch_size=B, nodes=5, ensemble=N,
                model=MLP(2, 1, H, L, "tanh"))
    ens = fe.train_fused_ensemble_packed(
        PROBLEMS["wave"](), 0, 2, N, batch_size=B, device="cpu",
        lrate=PROBLEMS["wave"]().defaults.lrate,
        model=MLP(2, 1, H, L, "tanh"))
    assert torch.equal(ft.pack_params(res.params),
                       ft.pack_params(ens.params[2]))


def test_solve_polishes_the_ensemble_and_single_runs():
    """FitzHugh–Nagumo with causal_eps=0: the polished pick's history is
    its Adam steps then one loss per L-BFGS step; a single run's
    ``finetune`` appends its L-BFGS steps too, and polishing lowers the
    training loss."""
    model = DGM(1, 2, H, 1, "tanh", generator=generator(0))
    res = solve("fitzhugh_nagumo", engine="fused", device="cpu",
                causal_eps=0.0, ensemble=N, finetune=4, iterations=5,
                batch_size=B, nodes=6, model=model)
    assert res.loss_history.shape == (9,)
    assert np.all(np.isfinite(res.loss_history)) and np.isfinite(res.mae)
    one = solve("heat", engine="fused", device="cpu", iterations=3,
                batch_size=B, nodes=5, finetune=6,
                model=MLP(2, 1, H, L, "tanh", generator=generator(1)))
    assert one.loss_history.shape == (9,)
    assert one.loss_history[-1] < one.loss_history[3]


def test_finetune_lbfgs_against_optax():
    """20 L-BFGS steps from the same parameters on the same numpy batch
    (heat, 256 points): torch.optim.LBFGS set up like optax.lbfgs()'s
    defaults and optax both fall below a tenth of the starting loss, and the
    port ends within 2× of JAX's final loss."""
    jm = JaxMLP(input_dim=2, output_dim=1, hidden_size=H, num_layers=L,
                activation="tanh")
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(0)))
    u = _uniforms((256,), 2, seed=5)
    prob, jprob = PROBLEMS["heat"](), JAX_PROBLEMS["heat"]()
    batch = prob.batch_from_uniforms(torch.from_numpy(u))
    jbatch = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(type(prob), "validation_sample",
                   lambda self, n, generator=None, device=None: batch)
        mp.setattr(type(jprob), "validation_sample",
                   lambda self, key, n: jbatch)
        jparams, jl = jax_finetune_lbfgs(jprob, jp, jax.random.key(1),
                                         steps=20, batch_size=256, model=jm)
        tm, tl = finetune_lbfgs(prob, params_from_jax(jp, "tanh"), steps=20,
                                batch_size=256)
    assert tl.shape == (20,) and np.all(np.isfinite(tl))
    np.testing.assert_allclose(tl[0], jl[0], rtol=1e-5)
    final = float(prob.loss(tm, batch))
    final_j = float(jprob.loss(jm.apply, jparams, jbatch))
    assert final < tl[0] / 10 and final_j < float(jl[0]) / 10
    assert final <= 2 * final_j


def test_finetune_line_search_has_its_evaluations(monkeypatch):
    """Each L-BFGS iteration's strong-Wolfe search may evaluate the loss 20
    times, as optax's zoom line search may. (With torch's default for
    ``max_iter=1`` it would get none, and from a trained network, where the
    first trial step overshoots, the polish would stay where it started.)"""
    import torch.optim.lbfgs as lbfgs

    budgets = []
    real = lbfgs._strong_wolfe

    def spy(*args, max_ls=25, **kwargs):
        budgets.append(max_ls)
        return real(*args, max_ls=max_ls, **kwargs)

    monkeypatch.setattr(lbfgs, "_strong_wolfe", spy)
    _, losses = finetune_lbfgs(PROBLEMS["heat"](),
                               MLP(2, 1, H, L, "tanh", generator=generator(2)),
                               steps=3, batch_size=64, generator=generator(3))
    assert budgets == [20, 20, 20] and losses[-1] < losses[0]
