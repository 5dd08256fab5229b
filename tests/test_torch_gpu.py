"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import ctypes
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from differential_equations_dnn_tpu_torch import solve  # noqa: E402
from differential_equations_dnn_tpu_torch.core import (  # noqa: E402
    generator,
    step_uniforms,
)
from differential_equations_dnn_tpu_torch.core.prng import (  # noqa: E402
    replica_generator,
)
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    PROBLEMS,
    Heat1D,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    build,
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
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    taylor_mlp,
)
from differential_equations_dnn_tpu_torch.models import MLP, ResNet  # noqa: E402
from differential_equations_dnn_tpu_torch.ops import (  # noqa: E402
    stride_strata,
)
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    TrainConfig,
    inject_fault,
    train,
)
from differential_equations_dnn_tpu_torch.train import (  # noqa: E402
    trainer,
)

pytestmark = pytest.mark.gpu

# The step-math runs of a 300-step fused solve: its steps and the warm-up's
# GRAPH_STEPS (the warm-up captures the CUDA graph its chunks replay and
# replays it once, so that compile_time holds both and iters_per_sec
# neither).
RUNS_300 = 300 + fe.GRAPH_STEPS


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("activation", ["tanh", "relu", "sigmoid"])
def test_mlp_forward_kernel_matches_plain(cuda, activation):
    """At the evaluation grids' row counts (1 600, heat2d's 13 824) and a
    large one (2^18: 64-row tiles, persistent CTAs), at ragged N = 1, 25,
    77 (a last tile of a few rows), for L = 0 and 3 at H = 128: fp32
    reassociation of 128-term dot products, outputs of order 1."""
    for L in (0, 3):
        model = MLP(2, 1, 128, L, activation, generator=generator(L),
                    device=cuda)
        for n in (1, 25, 77, 1600, 13824, 1 << 18):
            x = torch.rand((n, 2), generator=generator(n)).to(cuda)
            with torch.no_grad():
                got = taylor_mlp.mlp_forward(model, x)
                want = taylor_mlp.mlp_forward_plain(model, x)
            torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("D, H, L, O, tiles", [
    (2, 128, 3, 1, {(16, 1), (32, 1), (64, 2)}),
    (3, 50, 1, 2, {(16, 1), (32, 1), (64, 1)}),
    (1, 260, 0, 3, {(16, 1), (32, 1)}),
    (3, 256, 2, 2, {(16, 1), (16, 2), (16, 4), (16, 8), (32, 8)}),
    (2, 1312, 1, 1, {(8, 1), (8, 4), (8, 8)}),
])
def test_mlp_forward_tiles_agree_bit_for_bit(cuda, D, H, L, O, tiles):
    """The first n rows of N = 40 000 (persistent CTAs) through the planned
    launch at n = 1, 25, 77, 1 601, 8 001, 13 825: the plan takes each
    (rows per CTA tile, CTAs per cluster) of ``tiles`` on the H100's 132
    SMs, and every n gives the same bits as N (each output is one
    k-ascending chain in any tile, and a staging race, or a cluster's
    ragged last group, would show as a difference); N against the plain
    version. H = 50 takes 4-byte cp.async copies, H = 260 per-row bulk
    copies, and neither is a multiple of the 32- or 64-row k-tile, so
    neither takes a cluster; H = 256 and 260 take two or three 128-column
    passes, H = 1 312 eleven at 8 rows per CTA."""
    model = MLP(D, O, H, L, "tanh", generator=generator(H), device=cuda)
    x = torch.rand((40_000, D), generator=generator(D)).to(cuda)
    with torch.no_grad():
        want = taylor_mlp.mlp_forward(model, x)
        torch.testing.assert_close(
            want, taylor_mlp.mlp_forward_plain(model, x), rtol=1e-5,
            atol=1e-5)
        seen = set()
        for n in (1, 25, 77, 1601, 8001, 13825, 40_000):
            plan = taylor_mlp.mlp_forward_plan(n, D, H, O)
            seen.add((plan["rows"], plan["cluster"]))
            got = taylor_mlp.mlp_forward(model, x[:n])
            assert torch.equal(got, want[:n]), n
    assert seen == tiles


def test_train_chunk_kernel_matches_plain(cuda):
    """At the main path's shapes (H=128, L=3, B=64). Losses to fp32
    reassociation; parameters to rtol 1e-4 plus 2·lr (a gradient within
    rounding of zero can move a parameter by up to 2·lr). The kernel's own
    chunked run is bit-identical to the uncut one."""
    model = Heat1D().default_model(generator=generator(0), device=cuda)
    p = ft.pack_params(model)
    z = torch.zeros_like(p)
    u = step_uniforms(0, 0, 20, 64, cuda)
    pk, mk, vk, lk = ft.heat_fused_train_chunk(model, p, z, z, u, 0, 1e-4)
    pp, _, _, lp = ft.heat_fused_train_chunk_plain(model, p, z, z, u, 0, 1e-4)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=2e-4)
    p2, m2, v2, l2 = ft.heat_fused_train_chunk(model, p, z, z, u[:7], 0, 1e-4)
    p2, m2, v2, l2b = ft.heat_fused_train_chunk(model, p2, m2, v2, u[7:], 7,
                                                1e-4)
    assert torch.equal(torch.cat([l2, l2b]), lk) and torch.equal(p2, pk)
    assert torch.equal(m2, mk) and torch.equal(v2, vk)


def test_loss_grad_kernel_matches_plain(cuda):
    """One step's loss and gradient at B=64; each gradient tensor to 1e-5 of
    its largest entry (fp32 reassociation of the 448-row sums)."""
    model = Heat1D().default_model(generator=generator(2), device=cuda)
    p = ft.pack_params(model)
    u = step_uniforms(2, 0, 1, 64, cuda)[0]
    loss_k, grad_k = ft.heat_loss_grad(model, p, u)
    loss_p, grad_p = ft.heat_loss_grad_plain(model, p, u)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    for gk, gp in zip(ft.unpack_params(model, grad_k),
                      ft.unpack_params(model, grad_p)):
        torch.testing.assert_close(gk, gp, rtol=1e-4,
                                   atol=1e-5 * float(gp.abs().max()))


def test_wrappers_check_their_inputs(cuda):
    model = Heat1D().default_model(generator=generator(0), device=cuda)
    p = ft.pack_params(model)
    u = step_uniforms(0, 0, 2, 64, cuda)
    with pytest.raises(ValueError, match="float32"):
        ft.heat_fused_train_chunk(model, p.double(), p, p, u, 0, 1e-4)
    with pytest.raises(ValueError, match="shape"):
        ft.heat_fused_train_chunk(model, p[:-1].contiguous(), p, p, u, 0,
                                  1e-4)
    with pytest.raises(ValueError, match="contiguous"):
        taylor_mlp.mlp_forward(model, torch.zeros((2, 8), device=cuda)[:, ::4])


def test_solve_goes_through_both_kernels(cuda):
    """A short ``solve`` on the card launches both kernels and trains."""
    taylor_mlp.mlp_forward.launches = 0
    ft.heat_fused_train_chunk.launches = 0
    res = solve("heat", engine="fused", iterations=500, lrate=1e-3)
    assert taylor_mlp.mlp_forward.launches == 1
    assert ft.heat_fused_train_chunk.launches >= 1
    assert res.loss_history[-1] < res.loss_history[0] / 10
    assert res.device == torch.cuda.get_device_name(0)


@pytest.mark.parametrize("name", sorted(fe.SPECS))
def test_engine_kernels_match_plain(cuda, name):
    """Each spec at its equation's default shapes: one step's loss to rtol
    1e-5 and each gradient tensor to 1e-5 of its largest entry (fp32
    reassociation of R·B-row sums); 20 Adam steps from step0=100 under a
    decaying schedule, losses to rtol 1e-4 and parameters to rtol 1e-4
    plus 2·lr (a gradient within rounding of zero can move a parameter by
    up to 2·lr). The kernel's chunked run equals its uncut run bit for
    bit."""
    prob = PROBLEMS[name]()
    spec = fe.spec_for(prob)
    model = prob.default_model(generator=generator(0), device=cuda)
    p = fe.pack_state(spec, model)
    u = step_uniforms(0, 100, 20, prob.defaults.batch_size, cuda,
                      spec.n_uniform)
    loss_k, grad_k = fe.engine_loss_grad(spec, model, p, u[0])
    loss_p, grad_p = fe.engine_loss_grad_plain(spec, model, p, u[0])
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    for gk, gp in zip(fe.unpack_state(spec, model, grad_k),
                      fe.unpack_state(spec, model, grad_p)):
        if gp.numel():  # uat's hidden stack has none
            torch.testing.assert_close(gk, gp, rtol=1e-4,
                                       atol=1e-5 * float(gp.abs().max()))
    lr = prob.defaults.lrate
    kw = dict(schedule="exponential" if name == "burgers" else "cosine",
              total_steps=500)
    z = torch.zeros_like(p)
    pk, mk, vk, lk = fe.fused_engine_chunk(spec, model, p, z, z, u, 100, lr,
                                           **kw)
    pp, _, _, lp = fe.fused_engine_chunk_plain(spec, model, p, z, z, u, 100,
                                               lr, **kw)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=2 * lr)
    p2, m2, v2, l2 = fe.fused_engine_chunk(spec, model, p, z, z, u[:7], 100,
                                           lr, **kw)
    p2, m2, v2, l2b = fe.fused_engine_chunk(spec, model, p2, m2, v2, u[7:],
                                            107, lr, **kw)
    assert torch.equal(torch.cat([l2, l2b]), lk) and torch.equal(p2, pk)
    assert torch.equal(m2, mk) and torch.equal(v2, vk)


@pytest.mark.parametrize("name, schedule, route", [
    ("heat", "constant", "heat"), ("heat", "cosine", "engine"),
    ("wave", None, "engine"),
])
def test_solve_routes_launch_their_kernels(cuda, name, schedule, route):
    """A short ``solve`` per route launches that route's kernels, and only
    those, and trains."""
    counters = (taylor_mlp.mlp_forward, ft.heat_fused_train_chunk,
                fe.fused_engine_chunk, fe.engine_loss_grad)
    for fn in counters:
        fn.launches = 0
    fe.fused_engine_chunk.step_math_runs = 0
    res = solve(name, engine="fused", iterations=300, lrate=1e-3,
                schedule=schedule)
    assert taylor_mlp.mlp_forward.launches == 1
    heat, engine = (ft.heat_fused_train_chunk.launches,
                    fe.fused_engine_chunk.launches)
    assert (heat > 0, engine > 0) == (route == "heat", route == "engine")
    # The step math runs inside the training kernel, once per step
    # (warm-up + 300); the one-step kernel is not on the path.
    runs = fe.fused_engine_chunk.step_math_runs
    assert runs == (RUNS_300 if route == "engine" else 0)
    assert fe.engine_loss_grad.launches == 0
    assert res.loss_history[-1] < res.loss_history[0]


def test_engine_smem_rule(cuda):
    """The library's shared memory per block is fused_engine.engine_plan's
    for every spec at H = 128, 256 and 512, the same at every width and
    within the H100's 227 KB; an unknown spec gets -1. So heat2d's 11
    streams at H = 256, which the first design refused, train: its chunk
    runs and lowers the loss; past MAX_WIDTH the plan names the width."""
    lib = build.library()
    for name in fe.SPECS:
        spec = fe.spec_for(PROBLEMS[name]())
        R = spec.kernel_streams
        for H in (128, 256, 512):
            need = lib.engine_smem_bytes(spec.kernel_id, H)
            assert need == fe.engine_plan(R, H, spec.weight_groups) <= \
                engine_core.SMEM_LIMIT
    assert lib.engine_smem_bytes(99, 128) == -1
    spec = fe.spec_for(PROBLEMS["heat2d"]())
    wide = MLP(3, 1, 256, 3, "tanh", generator=generator(0), device=cuda)
    p = ft.pack_params(wide)
    z = torch.zeros_like(p)
    u = step_uniforms(0, 0, 60, 256, cuda, spec.n_uniform)
    _, _, _, losses = fe.fused_engine_chunk(spec, wide, p, z, z, u, 0, 1e-3)
    assert torch.isfinite(losses).all() and losses[-1] < losses[0]
    with pytest.raises(ValueError, match=f"width {fe.MAX_WIDTH + 1}"):
        fe.engine_plan(11, fe.MAX_WIDTH + 1)


@pytest.mark.parametrize("name", ["fitzhugh_nagumo", "fredholm"])
def test_dgm_kernels_match_plain(cuda, name):
    """The DGM kernels at each equation's default shapes (FitzHugh–Nagumo:
    R·B = 3·100, H = 128, L = 4; Fredholm: R·B = 3·32, H = 32, L = 1, its
    const): one step's loss to rtol 1e-5 and each gradient tensor to 1e-5
    of its largest entry (fp32 reassociation); 20 Adam steps from step 100
    over a 200-step cosine horizon (lr 0.55-0.45 of constant, so a kernel
    that ignored the schedule fails), losses to rtol 1e-4 and parameters
    to rtol 1e-4 plus 2·lr (a gradient within rounding of zero can move a
    parameter by up to 2·lr). The kernel's chunked run equals its uncut
    run bit for bit."""
    prob = PROBLEMS[name]()
    B = prob.defaults.batch_size
    spec = fd.spec_for(prob, B)
    const = fd.const_for(spec, prob, B, cuda)
    model = prob.default_model(generator=generator(0), device=cuda)
    p = fd.pack_dgm(model)
    u = step_uniforms(0, 100, 20, B, cuda, spec.n_uniform)
    loss_k, grad_k = fd.dgm_loss_grad(spec, model, p, u[0], const)
    loss_p, grad_p = fd.dgm_loss_grad_plain(spec, model, p, u[0], const)
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    for gk, gp in zip(fd.unpack_dgm(model, grad_k),
                      fd.unpack_dgm(model, grad_p)):
        torch.testing.assert_close(gk, gp, rtol=1e-4,
                                   atol=1e-5 * float(gp.abs().max()))
    lr = prob.defaults.lrate
    kw = dict(const=const, schedule="cosine", total_steps=200)
    z = torch.zeros_like(p)
    pk, mk, vk, lk = fd.fused_dgm_chunk(spec, model, p, z, z, u, 100, lr,
                                        **kw)
    pp, _, _, lp = fd.fused_dgm_chunk_plain(spec, model, p, z, z, u, 100, lr,
                                            **kw)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=2 * lr)
    p2, m2, v2, l2 = fd.fused_dgm_chunk(spec, model, p, z, z, u[:7], 100, lr,
                                        **kw)
    p2, m2, v2, l2b = fd.fused_dgm_chunk(spec, model, p2, m2, v2, u[7:], 107,
                                         lr, **kw)
    assert torch.equal(torch.cat([l2, l2b]), lk) and torch.equal(p2, pk)
    assert torch.equal(m2, mk) and torch.equal(v2, vk)


def test_dgm_stream_limit(cuda):
    """Fredholm's R = 1 + ⌈k/B⌉ is a run-time layout: k = 50 at B = 2 (R =
    26) runs; at B = 1 (R = 51) the wrapper rejects it with the kernel's
    limit, before launching."""
    lib = build.library()
    assert lib.dgm_max_streams() == 32
    prob = PROBLEMS["fredholm"]()
    model = prob.default_model(generator=generator(0), device=cuda)
    p = fd.pack_dgm(model)
    for B, ok in ((2, True), (1, False)):
        spec = fd.spec_for(prob, B)
        const = fd.const_for(spec, prob, B, cuda)
        u = torch.rand((B, 1), device=cuda)
        if ok:
            loss_k, grad_k = fd.dgm_loss_grad(spec, model, p, u, const)
            loss_p, grad_p = fd.dgm_loss_grad_plain(spec, model, p, u, const)
            torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
            torch.testing.assert_close(grad_k, grad_p, rtol=1e-4,
                                       atol=1e-5 * float(grad_p.abs().max()))
        else:
            with pytest.raises(ValueError, match="at most 32"):
                fd.dgm_loss_grad(spec, model, p, u, const)


@pytest.mark.parametrize("name", ["fitzhugh_nagumo", "fredholm"])
def test_solve_dgm_launches_its_kernel(cuda, name):
    """A short ``solve`` on the DGM route launches the DGM training kernel
    (its step math once per step: warm-up + 300), not the MLP kernels, and
    trains."""
    counters = (taylor_mlp.mlp_forward, ft.heat_fused_train_chunk,
                fe.fused_engine_chunk, fd.fused_dgm_chunk, fd.dgm_loss_grad)
    for fn in counters:
        fn.launches = 0
    fd.fused_dgm_chunk.step_math_runs = 0
    res = solve(name, engine="fused", iterations=300, lrate=1e-3)
    assert fd.fused_dgm_chunk.launches == 2
    assert fd.fused_dgm_chunk.step_math_runs == RUNS_300
    assert (taylor_mlp.mlp_forward.launches, ft.heat_fused_train_chunk.launches,
            fe.fused_engine_chunk.launches, fd.dgm_loss_grad.launches) == \
        (0, 0, 0, 0)
    assert res.loss_history[-20:].mean() < res.loss_history[:20].mean()
    assert res.solution.shape == PROBLEMS[name]().solution_shape(
        PROBLEMS[name]().defaults.nodes)


def _packed_case(name, cuda, n_replicas):
    """(chunk, plain chunk, single chunk, state, uniforms, kwargs) at NAME's
    default shapes: N replicas from replica_generator(0, r), 10 steps from
    step 100 over a 200-step cosine horizon."""
    prob = PROBLEMS[name]()
    B = prob.defaults.batch_size
    if name in ("fitzhugh_nagumo", "fredholm"):
        spec = fd.spec_for(prob, B)
        models = [prob.default_model(generator=replica_generator(0, r),
                                     device=cuda) for r in range(n_replicas)]
        p = engine_core.stack_replicas([fd.pack_dgm(m) for m in models])
        kw = dict(const=fd.const_for(spec, prob, B, cuda))
        chunks = (fd.fused_dgm_packed_chunk, fd.fused_dgm_packed_chunk_plain,
                  fd.fused_dgm_chunk)
    else:
        spec = fe.spec_for(prob)
        models = [prob.default_model(generator=replica_generator(0, r),
                                     device=cuda) for r in range(n_replicas)]
        p = engine_core.stack_replicas([ft.pack_params(m) for m in models])
        kw = {}
        chunks = (fe.fused_engine_packed_chunk,
                  fe.fused_engine_packed_chunk_plain, fe.fused_engine_chunk)
    u = step_uniforms(0, 100, 10, B, cuda, spec.n_uniform)
    kw.update(schedule="cosine", total_steps=200)
    return spec, models[0], chunks, p, u, kw


@pytest.mark.parametrize("name, n_replicas", [
    ("wave", 4), ("heat2d", 2), ("fitzhugh_nagumo", 3), ("fredholm", 4),
])
def test_packed_kernels_match_plain_and_single(cuda, name, n_replicas):
    """Kernel #5 at each engine's default shapes: the packed kernel against
    the packed plain version (losses rtol 1e-4; parameters rtol 1e-4 plus
    2·lr, as for the single chunks), and each packed replica equals the
    single-replica kernel on that replica's state, bit for bit (every
    replica runs the single-replica code on its own copy)."""
    spec, model, (packed, plain, single), p, u, kw = _packed_case(
        name, cuda, n_replicas)
    lr = PROBLEMS[name]().defaults.lrate
    z = torch.zeros_like(p)
    pk, mk, vk, lk = packed(spec, model, p, z, z, u, 100, lr, n_replicas,
                            **kw)
    pp, _, _, lp = plain(spec, model, p, z, z, u, 100, lr, n_replicas, **kw)
    assert lk.shape == (n_replicas, 10)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=2 * lr)
    for r in range(n_replicas):
        p1, m1, v1, l1 = single(spec, model, p[r].contiguous(), z[r].clone(),
                                z[r].clone(), u, 100, lr, **kw)
        assert torch.equal(l1, lk[r]) and torch.equal(p1, pk[r])
        assert torch.equal(m1, mk[r]) and torch.equal(v1, vk[r])


@pytest.mark.parametrize("name, route", [("wave", "engine"),
                                         ("fredholm", "dgm")])
def test_solve_ensemble_launches_the_packed_kernel(cuda, name, route):
    """A short ensemble ``solve`` launches its packed kernel once per chunk
    (warm-up + one chunk), with N step-math runs per step, and no
    single-replica trainer."""
    packed = (fd.fused_dgm_packed_chunk if route == "dgm"
              else fe.fused_engine_packed_chunk)
    counters = (packed, fe.fused_engine_chunk, fd.fused_dgm_chunk,
                ft.heat_fused_train_chunk)
    for fn in counters:
        fn.launches = 0
    packed.step_math_runs = 0
    res = solve(name, engine="fused", iterations=300, ensemble=4)
    assert packed.launches == 2 and packed.step_math_runs == 4 * RUNS_300
    assert (fe.fused_engine_chunk.launches, fd.fused_dgm_chunk.launches,
            ft.heat_fused_train_chunk.launches) == (0, 0, 0)
    assert res.loss_history.shape == (300,)
    assert res.loss_history[-20:].mean() < res.loss_history[:20].mean()


# ---------------------------------------------------------------------------
# Kernel #3 (csrc/heat_streams.cu) and the scan trainer
# ---------------------------------------------------------------------------


def _stream_case(cuda, activation, B, H=128, L=3, seed=0):
    model = MLP(2, 1, H, L, activation, generator=generator(seed),
                device=cuda)
    batch = Heat1D().sample(B, generator(seed + 1), cuda)
    return model, batch


@pytest.mark.parametrize("activation, B, L", [
    ("tanh", 64, 3), ("tanh", 1000, 3), ("sigmoid", 1000, 3),
    ("relu", 1000, 3), ("tanh", 77, 0),
])
def test_heat_streams_kernel_matches_plain(cuda, activation, B, L):
    """Kernel #3 at heat's shape (B = 64, H = 128, L = 3), at a ragged
    B = 1000 for each activation, and at L = 0: all seven streams to rtol
    1e-5 / atol 1e-5, the JAX package's tolerance for its kernel against
    the plain streams (fp32 reassociation of 128-term dot products)."""
    model, b = _stream_case(cuda, activation, B, L=L)
    taylor_mlp.heat_fused_streams.launches = 0
    with torch.no_grad():
        got = taylor_mlp.heat_fused_streams(model, b["xt"], b["x0"],
                                            b["xb1"], b["xb2"])
        want = taylor_mlp.heat_fused_streams_plain(model, b["xt"], b["x0"],
                                                   b["xb1"], b["xb2"])
    assert taylor_mlp.heat_fused_streams.launches == 1
    for g, w in zip(got, want):
        assert g.shape == (B, 1)
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_heat_streams_gradient_matches_taylor(cuda):
    """The gradient of Heat1D(taps="pallas").loss through the kernel's
    Function (rematerialised plain backward) against autograd through
    Heat1D(taps="taylor").loss on the same batch: rtol 1e-4 / atol 1e-6
    (the two forwards differ by fp32 reassociation)."""
    model, b = _stream_case(cuda, "tanh", 64)
    params = list(model.parameters())
    lp = Heat1D(taps="pallas").loss(model, b)
    gp = torch.autograd.grad(lp, params)
    lt = Heat1D(taps="taylor").loss(model, b)
    gt = torch.autograd.grad(lt, params)
    torch.testing.assert_close(lp, lt, rtol=1e-5, atol=0)
    for a, c in zip(gp, gt):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("activation", ["tanh", "sigmoid", "relu"])
@pytest.mark.parametrize("H", [256, 512])
def test_heat_streams_smem_rule(cuda, H, activation):
    """Past the first design's H = 191 (two whole 7-stream buffers and one
    layer's W per block): the cluster-split kernel at H = 256 and 512
    against the plain version at the H = 128 test's tolerance; the library
    plans the launch as the Python mirror does."""
    lib = build.library()
    plan = taylor_mlp.heat_streams_plan(H, 1)
    out = (ctypes.c_int * 6)()
    build.check(lib.heat_streams_plan(H, 1, out), "heat_streams_plan")
    assert tuple(out) == (plan["cluster"], plan["points"], plan["k_tile"],
                          plan["threads"], plan["stages"], plan["smem"])
    model, b = _stream_case(cuda, activation, 64, H=H, L=3)
    taylor_mlp.heat_fused_streams.launches = 0
    with torch.no_grad():
        got = taylor_mlp.heat_fused_streams(model, b["xt"], b["x0"],
                                            b["xb1"], b["xb2"])
        want = taylor_mlp.heat_fused_streams_plain(model, b["xt"], b["x0"],
                                                   b["xb1"], b["xb2"])
    assert taylor_mlp.heat_fused_streams.launches == 1
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=1e-5, atol=1e-5)


def test_heat_streams_refuse_past_limit(cuda):
    """Past the plan's widest H (3 264) the wrapper raises ValueError
    naming it before launching, with no fallback to the plain version."""
    model, b = _stream_case(cuda, "tanh", 16, H=3265, L=0)
    taylor_mlp.heat_fused_streams.launches = 0
    with pytest.raises(ValueError, match="H = 3264"):
        taylor_mlp.heat_fused_streams(model, b["xt"], b["x0"], b["xb1"],
                                      b["xb2"])
    assert taylor_mlp.heat_fused_streams.launches == 0


@pytest.mark.parametrize("name, kw", [
    ("heat", {"taps": "pallas"}), ("heat", {}), ("simple_ode", {}),
])
def test_scan_losses_match_cpu(cuda, name, kw):
    """The first 20 scan steps on the card against the same seed on the
    CPU (the same host draws, the same initial weights): losses to rtol
    1e-4 (fp32 reassociation, compounded over 20 Adam steps)."""
    prob = PROBLEMS[name](**kw)
    cfg = TrainConfig(iterations=20, batch_size=prob.defaults.batch_size,
                      lrate=1e-3, verbose=False)
    runs = [train(prob, 0, cfg, device=dev).loss_history
            for dev in (cuda, torch.device("cpu"))]
    np.testing.assert_allclose(runs[0], runs[1], rtol=1e-4)


def test_scan_solve_goes_through_the_streams_kernel(cuda):
    """``solve("heat", taps="pallas")`` on the scan engine launches kernel
    #3 once per step plus the two warm-ups (train's and the CUDA graph
    capture's: 256 of the 300 steps replay the graph), #2 once, no fused
    trainer, and trains."""
    counters = (taylor_mlp.mlp_forward, taylor_mlp.heat_fused_streams,
                ft.heat_fused_train_chunk, fe.fused_engine_chunk)
    for fn in counters:
        fn.launches = 0
    res = solve("heat", taps="pallas", iterations=300, lrate=1e-3)
    assert taylor_mlp.heat_fused_streams.launches == 302
    assert taylor_mlp.mlp_forward.launches == 1
    assert (ft.heat_fused_train_chunk.launches,
            fe.fused_engine_chunk.launches) == (0, 0)
    assert res.loss_history.shape == (300,)
    assert res.loss_history[-20:].mean() < res.loss_history[:20].mean()


# ---------------------------------------------------------------------------
# Widths: kernels #2, #1 and #3 take any width the trainers train, up to
# their stated limits, past which they raise before launching
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("H", [256, 1024])
def test_mlp_forward_wide_matches_plain(cuda, H):
    """Past the 211 of a whole staged W: H = 256 (two 128-column passes)
    and 1 024 (eight) against the plain version, at the H = 128 test's
    tolerance, at the heat grid, a ragged N and heat2d's grid."""
    model = MLP(2, 1, H, 3, "tanh", generator=generator(0), device=cuda)
    for n in (1600, 77, 13824):
        x = torch.rand((n, 2), generator=generator(n)).to(cuda)
        with torch.no_grad():
            got = taylor_mlp.mlp_forward(model, x)
            want = taylor_mlp.mlp_forward_plain(model, x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("N, D, H, rows, stages, cluster", [
    (25, 1, 32, 16, 4, 1), (1600, 2, 128, 16, 4, 1), (8000, 2, 256, 32, 4, 8),
    (13824, 3, 128, 64, 3, 2), (13824, 3, 256, 32, 4, 8),
    (1 << 20, 2, 128, 64, 3, 2), (1600, 2, 1024, 16, 3, 8),
    (1600, 2, 1303, 16, 2, 1), (1600, 2, 1304, 8, 6, 1),
    (1 << 20, 3119, 2, 8, 2, 1), (1 << 20, 2, 3119, 8, 2, 1),
])
def test_mlp_forward_plan(cuda, N, D, H, rows, stages, cluster):
    """The library's plan on the H100's 132 SMs. Rows per CTA tile from N:
    64 where every SM gets a 64-row tile (N ≥ 8 385) and two such CTAs
    share an SM (not at H = 256), else 32 where each gets one of those
    (N ≥ 4 193), else 16; fewer where two k-major buffers of max(D, H) ×
    rows floats and a ring of at least 2 W k-tiles (of 32 rows at 64 and 8
    rows per CTA, 64 at 32 and 16) and its two 8-byte barriers a tile would
    pass a block's 227 KB (16 rows to width 1 303, 8 to MAX_MLP_WIDTH). The
    ring is as deep as fits, up to 3 k-tiles at 64 rows, 6 at 8 and 4 else.
    A CTA has one warp more than its compute warps, the one that fills the
    ring. Clusters of 8 CTAs from H = 256 and of 2 at 64-row tiles share
    each W tile's copy, where every tile goes by bulk copies (H a multiple
    of the k-tile, the output layer in one pass), and never more CTAs than
    row tiles. The output width counts for nothing else."""
    plan = taylor_mlp.mlp_forward_plan(N, D, H, 1)
    assert (plan["rows"], plan["stages"], plan["cluster"]) == (
        rows, stages, cluster)
    assert plan["threads"] == 32 + {64: 128, 32: 256, 16: 128, 8: 128}[rows]
    k_tile = {64: 32, 32: 64, 16: 64, 8: 32}[rows]
    assert plan["smem"] == 16 * stages + 4 * (2 * max(D, H) * rows
                                              + stages * k_tile * 128)
    assert plan["smem"] <= engine_core.SMEM_LIMIT
    assert taylor_mlp.mlp_forward_plan(N, D, H, 64) == dict(plan, cluster=1)
    assert taylor_mlp.mlp_forward_plan(3, D, H, 1)["cluster"] == 1  # 1 tile


def test_mlp_forward_refuses_past_limit(cuda):
    """Past MAX_MLP_WIDTH the wrapper raises a ValueError naming it before
    any launch (L = 0 keeps the model small); the library plans
    MAX_MLP_WIDTH, of D or H, and refuses one more."""
    M = taylor_mlp.MAX_MLP_WIDTH
    model = MLP(2, 1, M + 1, 0, "tanh", generator=generator(0), device=cuda)
    taylor_mlp.mlp_forward.launches = 0
    with pytest.raises(ValueError, match=f"widest it takes is "
                                         f"{taylor_mlp.MAX_MLP_WIDTH}"):
        taylor_mlp.mlp_forward(model, torch.zeros((4, 2), device=cuda))
    assert taylor_mlp.mlp_forward.launches == 0
    lib, out = build.library(), (ctypes.c_int * 5)()
    for width in (M, M + 1):
        for D, H in ((2, width), (width, 2)):
            code = lib.mlp_forward_plan(4, D, H, 1, out)
            assert (code == 0) == (width == M), (D, H)


def test_scan_heat_solve_evaluates_wide_model(cuda):
    """``solve("heat", model=MLP(2, 1, 256, 3))`` trains on the scan engine
    and evaluates its grid through kernel #2 with no CUDA error."""
    taylor_mlp.mlp_forward.launches = 0
    res = solve("heat", model=MLP(2, 1, 256, 3, activation="tanh"),
                iterations=50)
    assert taylor_mlp.mlp_forward.launches == 1
    assert np.isfinite(res.mae)


def test_heat_fused_chunk_wide_matches_plain(cuda):
    """At H = 256, which the first design refused (its backward staged a
    whole H × H weight per block): 53 steps (a graph replay and 3 steps
    from C) against the plain version, at the H = 128 test's tolerances;
    the library's shared memory per block is the Python plan's."""
    assert build.library().heat_train_smem_bytes() == \
        ft.heat_train_plan(256)["smem"]
    model = MLP(2, 1, 256, 3, "tanh", generator=generator(0), device=cuda)
    p = ft.pack_params(model)
    z = torch.zeros_like(p)
    u = step_uniforms(0, 0, 53, 64, cuda)
    pk, _, _, lk = ft.heat_fused_train_chunk(model, p, z, z, u, 0, 1e-4)
    pp, _, _, lp = ft.heat_fused_train_chunk_plain(model, p, z, z, u, 0, 1e-4)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=2e-4)


def test_heat_fused_chunk_refuses_past_limit(cuda):
    """Past MAX_HEAT_WIDTH the wrapper raises ValueError naming it before
    launching (L = 0 keeps the model small)."""
    H = ft.MAX_HEAT_WIDTH + 1
    model = MLP(2, 1, H, 0, "tanh", generator=generator(0), device=cuda)
    p = ft.pack_params(model)
    u = step_uniforms(0, 0, 2, 64, cuda)
    ft.heat_fused_train_chunk.launches = 0
    with pytest.raises(ValueError, match=f"past the {ft.MAX_HEAT_WIDTH}"):
        ft.heat_fused_train_chunk(model, p, p, p, u, 0, 1e-4)
    assert ft.heat_fused_train_chunk.launches == 0


@pytest.mark.parametrize("K", [1, 7, 50, 53, 120])
def test_heat_graph_boundaries_equal_single_steps(cuda, K):
    """Heat's default model, K steps in one call (⌊K/50⌋ graph replays, K
    mod 50 steps launched from C) equal the same steps run one call per
    step, bit for bit; so does the run cut at 53; and a second shape's call
    between them does not disturb the cached graph."""
    model = Heat1D().default_model(generator=generator(0), device=cuda)
    p = ft.pack_params(model)
    z = torch.zeros_like(p)
    u = step_uniforms(0, 100, K, 64, cuda)
    state, ref = (p, z, z), []
    for k in range(K):
        *state, loss = ft.heat_fused_train_chunk(model, *state, u[k:k + 1],
                                                 100 + k, 1e-4)
        ref.append(loss)
    pk, mk, vk, lk = ft.heat_fused_train_chunk(model, p, z, z, u, 100, 1e-4)
    assert torch.equal(lk, torch.cat(ref))
    assert all(torch.equal(a, b) for a, b in zip((pk, mk, vk), state))
    if K > 53:
        p2, m2, v2, l2 = ft.heat_fused_train_chunk(model, p, z, z, u[:53],
                                                   100, 1e-4)
        p2, m2, v2, l2b = ft.heat_fused_train_chunk(model, p2, m2, v2,
                                                    u[53:], 153, 1e-4)
        assert torch.equal(torch.cat([l2, l2b]), lk)
        assert torch.equal(p2, pk) and torch.equal(m2, mk)
        assert torch.equal(v2, vk)


def test_heat_graph_is_captured_once_per_shape(cuda):
    """Two calls of one shape with different step0 and lr replay one
    captured graph (the cache cleared first, as in a fresh process)."""
    from differential_equations_dnn_tpu_torch.kernels import graphs

    model = Heat1D().default_model(generator=generator(0), device=cuda)
    p = ft.pack_params(model)
    z = torch.zeros_like(p)
    u = step_uniforms(0, 0, 60, 64, cuda)
    graphs.clear_graphs()
    builds = graphs.graph_stats["builds"]
    for step0, lr in ((0, 1e-4), (500, 3e-4)):
        state, ref = (p, z, z), []
        for k in range(60):
            *state, loss = ft.heat_fused_train_chunk(
                model, *state, u[k:k + 1], step0 + k, lr)
            ref.append(loss)
        out = ft.heat_fused_train_chunk(model, p, z, z, u, step0, lr)
        assert torch.equal(out[3], torch.cat(ref))
        assert all(torch.equal(a, b) for a, b in zip(out[:3], state))
    assert graphs.graph_stats["builds"] == builds + 1
    assert graphs.graph_stats["engines"][-1] == "heat"


# ---------------------------------------------------------------------------
# The DGM engine's graph replay (kernels #7 and #5)
# ---------------------------------------------------------------------------


def _dgm_case(cuda, name, n_replicas, K, step0=100):
    """NAME's default shapes: N replicas from replica_generator(0, r) (one:
    generator(0)), K uniforms from step0, a cosine schedule over 300."""
    prob = PROBLEMS[name]()
    B = prob.defaults.batch_size
    spec = fd.spec_for(prob, B)
    gens = ([generator(0)] if n_replicas is None else
            [replica_generator(0, r) for r in range(n_replicas)])
    models = [prob.default_model(generator=g, device=cuda) for g in gens]
    p = engine_core.stack_replicas([fd.pack_dgm(m) for m in models])
    u = step_uniforms(0, step0, K, B, cuda, spec.n_uniform)
    kw = dict(const=fd.const_for(spec, prob, B, cuda), schedule="cosine",
              total_steps=300)
    return spec, models[0], p, u, prob.defaults.lrate, kw


@pytest.mark.parametrize("name", ["fitzhugh_nagumo", "fredholm"])
def test_dgm_graph_chunk_matches_plain(cuda, name):
    """53 steps (one 50-step graph replay and 3 steps from C) against the
    plain version: losses rtol 1e-4, parameters rtol 1e-4 plus 2·lr, as
    the eager chunk's test."""
    spec, model, p, u, lr, kw = _dgm_case(cuda, name, None, 53)
    p, z = p[0], torch.zeros_like(p[0])
    pk, _, _, lk = fd.fused_dgm_chunk(spec, model, p, z, z, u, 100, lr, **kw)
    pp, _, _, lp = fd.fused_dgm_chunk_plain(spec, model, p, z, z, u, 100, lr,
                                            **kw)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=2 * lr)


@pytest.mark.parametrize("K", [1, 7, 50, 53, 120])
def test_dgm_graph_boundaries_equal_single_steps(cuda, K):
    """K steps in one call (⌊K/50⌋ graph replays, K mod 50 steps from C)
    equal the same steps run one call per step (no graph), bit for bit; so
    does the run cut at 53."""
    spec, model, p, u, lr, kw = _dgm_case(cuda, "fitzhugh_nagumo", None, K)
    state = (p[0], torch.zeros_like(p[0]), torch.zeros_like(p[0]))
    ref = []
    for k in range(K):
        *state, loss = fd.fused_dgm_chunk(spec, model, *state, u[k:k + 1],
                                          100 + k, lr, **kw)
        ref.append(loss)
    z = torch.zeros_like(p[0])
    pk, mk, vk, lk = fd.fused_dgm_chunk(spec, model, p[0], z, z, u, 100, lr,
                                        **kw)
    assert torch.equal(lk, torch.cat(ref))
    assert all(torch.equal(a, b) for a, b in zip((pk, mk, vk), state))
    if K > 53:
        p2, m2, v2, l2 = fd.fused_dgm_chunk(spec, model, p[0], z, z, u[:53],
                                            100, lr, **kw)
        p2, m2, v2, l2b = fd.fused_dgm_chunk(spec, model, p2, m2, v2, u[53:],
                                             153, lr, **kw)
        assert torch.equal(torch.cat([l2, l2b]), lk)
        assert torch.equal(p2, pk) and torch.equal(m2, mk)
        assert torch.equal(v2, vk)


@pytest.mark.parametrize("n_replicas", [1, 4, 16])
def test_dgm_packed_graph_equals_single(cuda, n_replicas):
    """FitzHugh–Nagumo × N over 53 steps (the packed graph at N): every
    replica equals the single chunk on its state bit for bit."""
    spec, model, p, u, lr, kw = _dgm_case(cuda, "fitzhugh_nagumo",
                                          n_replicas, 53)
    z = torch.zeros_like(p)
    pk, mk, vk, lk = fd.fused_dgm_packed_chunk(spec, model, p, z, z, u, 100,
                                               lr, n_replicas, **kw)
    for r in range(n_replicas):
        p1, m1, v1, l1 = fd.fused_dgm_chunk(spec, model, p[r].contiguous(),
                                            z[r].clone(), z[r].clone(), u,
                                            100, lr, **kw)
        assert torch.equal(l1, lk[r]) and torch.equal(p1, pk[r])
        assert torch.equal(m1, mk[r]) and torch.equal(v1, vk[r])


def test_dgm_graph_is_captured_once_per_shape(cuda):
    """Two calls in a row with fresh tensors replay one captured graph and
    give the same result, which a graph captured anew (the cache cleared,
    as in a fresh process) gives too; the step-math runs count every
    step."""
    spec, model, p, u, lr, kw = _dgm_case(cuda, "fitzhugh_nagumo", None, 60)
    fd.clear_graphs()
    builds = fd.graph_stats["builds"]
    fd.fused_dgm_chunk.step_math_runs = 0
    outs = []
    for _ in range(2):
        fresh = p[0].clone()
        z = torch.zeros_like(fresh)
        outs.append(fd.fused_dgm_chunk(spec, model, fresh, z, z.clone(),
                                       u.clone(), 100, lr, **kw))
    assert fd.graph_stats["builds"] == builds + 1
    assert fd.fused_dgm_chunk.step_math_runs == 120
    fd.clear_graphs()
    z = torch.zeros_like(p[0])
    outs.append(fd.fused_dgm_chunk(spec, model, p[0], z, z, u, 100, lr, **kw))
    assert fd.graph_stats["builds"] == builds + 2
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


# ---------------------------------------------------------------------------
# The MLP engine's graph replay (kernels #6 and #4/#5 at the MLP layout)
# ---------------------------------------------------------------------------


def _engine_case(cuda, name, n_replicas, K, step0=100, hidden=None):
    """NAME's default shapes (hidden: the width of a tanh MLP of the default
    depth instead): N replicas from replica_generator(0, r) (one:
    generator(0)), K uniforms from step0, a cosine schedule over 300."""
    prob = PROBLEMS[name]()
    spec = fe.spec_for(prob)
    gens = ([generator(0)] if n_replicas is None else
            [replica_generator(0, r) for r in range(n_replicas)])
    if hidden is None:
        models = [prob.default_model(generator=g, device=cuda) for g in gens]
    else:
        L = prob.default_model().num_layers
        models = [MLP(spec.input_dim, 1, hidden, L, "tanh", generator=g,
                      device=cuda) for g in gens]
    p = engine_core.stack_replicas([ft.pack_params(m) for m in models])
    u = step_uniforms(0, step0, K, prob.defaults.batch_size, cuda,
                      spec.n_uniform)
    kw = dict(schedule="cosine", total_steps=300)
    return spec, models[0], p, u, prob.defaults.lrate, kw


def _single_steps(spec, model, state, u, step0, lr, kw):
    """The K steps of u run one call per step (no graph), and their
    losses."""
    losses = []
    for k in range(u.shape[0]):
        *state, loss = fe.fused_engine_chunk(spec, model, *state, u[k:k + 1],
                                             step0 + k, lr, **kw)
        losses.append(loss)
    return state, torch.cat(losses)


@pytest.mark.parametrize("K", [1, 7, 50, 53, 120])
def test_engine_graph_boundaries_equal_single_steps(cuda, K):
    """heat2d, K steps in one call (⌊K/50⌋ graph replays, K mod 50 steps
    launched from C) equal the same steps run one call per step, bit for
    bit; so does the run cut at 53."""
    spec, model, p, u, lr, kw = _engine_case(cuda, "heat2d", None, K)
    z = torch.zeros_like(p[0])
    state, ref = _single_steps(spec, model, (p[0], z, z), u, 100, lr, kw)
    pk, mk, vk, lk = fe.fused_engine_chunk(spec, model, p[0], z, z, u, 100,
                                           lr, **kw)
    assert torch.equal(lk, ref)
    assert all(torch.equal(a, b) for a, b in zip((pk, mk, vk), state))
    if K > 53:
        p2, m2, v2, l2 = fe.fused_engine_chunk(spec, model, p[0], z, z,
                                               u[:53], 100, lr, **kw)
        p2, m2, v2, l2b = fe.fused_engine_chunk(spec, model, p2, m2, v2,
                                                u[53:], 153, lr, **kw)
        assert torch.equal(torch.cat([l2, l2b]), lk)
        assert torch.equal(p2, pk) and torch.equal(m2, mk)
        assert torch.equal(v2, vk)


@pytest.mark.parametrize("n_replicas", [1, 4, 8])
def test_engine_packed_graph_equals_single(cuda, n_replicas):
    """wave × N over 53 steps (the packed graph at N; heat2d's odd n puts
    odd replicas' weights off 16-byte alignment, wave's too): every replica
    equals the single chunk on its state bit for bit."""
    spec, model, p, u, lr, kw = _engine_case(cuda, "wave", n_replicas, 53)
    z = torch.zeros_like(p)
    pk, mk, vk, lk = fe.fused_engine_packed_chunk(spec, model, p, z, z, u,
                                                  100, lr, n_replicas, **kw)
    for r in range(n_replicas):
        p1, m1, v1, l1 = fe.fused_engine_chunk(spec, model, p[r].contiguous(),
                                               z[r].clone(), z[r].clone(), u,
                                               100, lr, **kw)
        assert torch.equal(l1, lk[r]) and torch.equal(p1, pk[r])
        assert torch.equal(m1, mk[r]) and torch.equal(v1, vk[r])


def test_engine_graph_replays_each_calls_values(cuda):
    """Two calls of one shape with different step0, lr and schedule replay
    one captured graph, and each equals its own steps run one call per step
    (no graph): the argument block never serves a stale value."""
    spec, model, p, u, _, _ = _engine_case(cuda, "heat2d", None, 53)
    z = torch.zeros_like(p[0])
    fe.clear_graphs()
    builds = fe.graph_stats["builds"]
    for step0, lr, kw in ((100, 1e-3, dict(schedule="cosine",
                                           total_steps=300)),
                          (7, 3e-4, dict(schedule="exponential",
                                         total_steps=90, decay=0.3))):
        state, ref = _single_steps(spec, model, (p[0], z, z), u, step0, lr,
                                   kw)
        out = fe.fused_engine_chunk(spec, model, p[0], z, z, u, step0, lr,
                                    **kw)
        assert torch.equal(out[3], ref)
        assert all(torch.equal(a, b) for a, b in zip(out[:3], state))
    assert fe.graph_stats["builds"] == builds + 1


@pytest.mark.parametrize("name", ["heat2d", "simple_ode"])
@pytest.mark.parametrize("hidden", [256, 512])
def test_engine_wide_chunks_match_plain(cuda, name, hidden):
    """53 steps (a graph replay and 3 steps from C) at H = 256 and 512,
    widths the first design refused for heat2d: against the plain version,
    losses rtol 1e-4 and parameters rtol 1e-4 plus 2·lr, as at H = 128."""
    spec, model, p, u, lr, kw = _engine_case(cuda, name, None, 53,
                                             hidden=hidden)
    z = torch.zeros_like(p[0])
    pk, _, _, lk = fe.fused_engine_chunk(spec, model, p[0], z, z, u, 100, lr,
                                         **kw)
    pp, _, _, lp = fe.fused_engine_chunk_plain(spec, model, p[0], z, z, u,
                                               100, lr, **kw)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=2 * lr)


def test_engine_graph_is_captured_once_per_shape(cuda):
    """Two calls in a row with fresh tensors replay one captured graph and
    give the same result, which a graph captured anew (the cache cleared,
    as in a fresh process) gives too; the step-math runs count every
    step."""
    spec, model, p, u, lr, kw = _engine_case(cuda, "wave", None, 60)
    fe.clear_graphs()
    builds = fe.graph_stats["builds"]
    fe.fused_engine_chunk.step_math_runs = 0
    outs = []
    for _ in range(2):
        fresh = p[0].clone()
        z = torch.zeros_like(fresh)
        outs.append(fe.fused_engine_chunk(spec, model, fresh, z, z.clone(),
                                          u.clone(), 100, lr, **kw))
    assert fe.graph_stats["builds"] == builds + 1
    assert fe.graph_stats["engines"][-1] == "engine"
    assert fe.fused_engine_chunk.step_math_runs == 120
    fe.clear_graphs()
    z = torch.zeros_like(p[0])
    outs.append(fe.fused_engine_chunk(spec, model, p[0], z, z, u, 100, lr,
                                      **kw))
    assert fe.graph_stats["builds"] == builds + 2
    for out in outs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(out, outs[0]))


# ---------------------------------------------------------------------------
# volterra (folded groups, const), uat (L = 0, H = 3), inverse_heat (extra
# tensor, const)
# ---------------------------------------------------------------------------

LAST_SPECS = ["volterra", "uat", "inverse_heat"]


@pytest.mark.parametrize("name", LAST_SPECS)
def test_last_specs_packed_and_cut_equal_single(cuda, name):
    """At the equation's default shapes, 53 steps (a graph replay and 3
    steps from C): a packed chunk of N = 2 replicas equals the single chunk
    on each replica's state bit for bit, and the single chunk cut at step
    25 equals the uncut one bit for bit (the const operand and, for
    inverse_heat, log κ̂'s Adam step ride both)."""
    prob = PROBLEMS[name]()
    spec = fe.spec_for(prob)
    B, lr = prob.defaults.batch_size, prob.defaults.lrate
    models = [prob.default_model(generator=replica_generator(0, r),
                                 device=cuda) for r in range(2)]
    p = engine_core.stack_replicas([fe.pack_state(spec, m) for m in models])
    z = torch.zeros_like(p)
    u = step_uniforms(0, 100, 53, B, cuda, spec.n_uniform)
    kw = dict(schedule="cosine", total_steps=300)
    pk, mk, vk, lk = fe.fused_engine_packed_chunk(spec, models[0], p, z, z,
                                                  u, 100, lr, 2, **kw)
    for r in range(2):
        p1, m1, v1, l1 = fe.fused_engine_chunk(spec, models[0],
                                               p[r].contiguous(),
                                               z[r].clone(), z[r].clone(), u,
                                               100, lr, **kw)
        assert torch.equal(l1, lk[r]) and torch.equal(p1, pk[r])
        assert torch.equal(m1, mk[r]) and torch.equal(v1, vk[r])
    a = fe.fused_engine_chunk(spec, models[0], p[0].contiguous(), z[0],
                              z[0], u[:25], 100, lr, **kw)
    b = fe.fused_engine_chunk(spec, models[0], *a[:3], u[25:], 125, lr, **kw)
    assert torch.equal(torch.cat([a[3], b[3]]), lk[0])
    assert all(torch.equal(x, y) for x, y in zip(b[:3], (pk[0], mk[0],
                                                          vk[0])))


def test_last_specs_plans(cuda):
    """Volterra's 51 groups fold into one stream: the library plans the
    R = 1 layer tiles and weight gradients of FOLD_GROUPS thread groups
    (step_plan(1, 8)), within the H100's 227 KB, whatever k is; uat's
    Perceptron trains at L = 0 and H = 3 with a flat state of the input
    and output layers alone; inverse_heat's state ends in log κ̂."""
    lib = build.library()
    for k in (8, 50, 400):
        spec = fe.spec_for(PROBLEMS["volterra"](k=k))
        assert spec.kernel_streams == 1 and spec.fold == k + 1
        assert spec.weight_groups == fe.FOLD_GROUPS
        assert lib.engine_smem_bytes(spec.kernel_id, 64) == \
            fe.engine_plan(1, 64, fe.FOLD_GROUPS) <= engine_core.SMEM_LIMIT
    prob = PROBLEMS["uat"]()
    spec = fe.spec_for(prob)
    model = prob.default_model(generator=generator(0), device=cuda)
    assert fe.state_size(spec, model) == 3 + 3 + 3 + 1
    prob = PROBLEMS["inverse_heat"]()
    spec = fe.spec_for(prob)
    model = prob.default_model(generator=generator(0), device=cuda)
    flat = fe.pack_state(spec, model)
    assert float(flat[-1]) == float(model.log_kappa.detach())


def test_mlp_forward_takes_perceptron_and_inverse_model(cuda):
    """Kernel #2 on uat's Perceptron (L = 0, H = 3: rows not 16-byte
    aligned) at its 50-point grid and a ragged 77, and on inverse_heat's
    net at its 40 × 40 grid, against ``model(x)``: fp32 reassociation of
    H-term dot products, outputs of order 1."""
    for name, n in (("uat", 50), ("uat", 77), ("inverse_heat", 40)):
        prob = PROBLEMS[name]()
        model = prob.default_model(generator=generator(3), device=cuda)
        x = prob.grid_inputs(n, device=cuda)
        taylor_mlp.mlp_forward.launches = 0
        with torch.no_grad():
            got = taylor_mlp.mlp_forward(model, x)
            torch.testing.assert_close(got, model(x), rtol=1e-5, atol=1e-5)
        assert taylor_mlp.mlp_forward.launches == 1


@pytest.mark.parametrize("name", LAST_SPECS)
def test_solve_last_specs_launch_the_engine(cuda, name):
    """A short fused ``solve`` of each new equation launches the MLP engine
    (one step-math run per step and the warm-up) and kernel #2 once, and
    trains; inverse_heat's κ̂ moves from its initial 0.5."""
    for fn in (taylor_mlp.mlp_forward, fe.fused_engine_chunk):
        fn.launches = 0
    fe.fused_engine_chunk.step_math_runs = 0
    res = solve(name, engine="fused", iterations=300)
    assert taylor_mlp.mlp_forward.launches == 1
    assert fe.fused_engine_chunk.step_math_runs == RUNS_300
    assert np.all(np.isfinite(res.loss_history))
    assert res.loss_history[-20:].mean() < res.loss_history[:20].mean()
    if name == "inverse_heat":
        assert float(res.params.kappa()) != 0.5


# ---------------------------------------------------------------------------
# The hard-constraint specs (fused_engine.HARD_SPECS)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(fe.HARD_SPECS))
def test_hard_specs_match_plain(cuda, name):
    """Each hard spec at its equation's default shapes, with the tolerances
    of the soft specs: one step's loss to rtol 1e-5 and each gradient
    tensor to 1e-5 of its largest entry; a 50-step chunk (one graph replay)
    from step0 = 100 under a cosine schedule over 200 steps, losses to rtol
    1e-4 and parameters to rtol 1e-4 plus 2·lr."""
    prob = PROBLEMS[name](constraint="hard")
    spec = fe.spec_for(prob)
    model = prob.default_model(generator=generator(0), device=cuda)
    p = fe.pack_state(spec, model)
    u = step_uniforms(0, 100, 50, prob.defaults.batch_size, cuda,
                      spec.n_uniform)
    loss_k, grad_k = fe.engine_loss_grad(spec, model, p, u[0])
    loss_p, grad_p = fe.engine_loss_grad_plain(spec, model, p, u[0])
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    for gk, gp in zip(fe.unpack_state(spec, model, grad_k),
                      fe.unpack_state(spec, model, grad_p)):
        torch.testing.assert_close(gk, gp, rtol=1e-4,
                                   atol=1e-5 * float(gp.abs().max()))
    lr = prob.defaults.lrate
    kw = dict(schedule="cosine", total_steps=200)
    z = torch.zeros_like(p)
    pk, _, _, lk = fe.fused_engine_chunk(spec, model, p, z, z, u, 100, lr,
                                         **kw)
    pp, _, _, lp = fe.fused_engine_chunk_plain(spec, model, p, z, z, u, 100,
                                               lr, **kw)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=2 * lr)


def test_hard_packed_equals_single(cuda):
    """Hard heat's packed chunk of N = 4 replicas (50 steps: one graph
    replay): every replica equals the single chunk on its state bit for
    bit, and the packed plain version within the soft specs' tolerances."""
    prob = PROBLEMS["heat"](constraint="hard")
    spec = fe.spec_for(prob)
    B, lr = prob.defaults.batch_size, prob.defaults.lrate
    models = [prob.default_model(generator=replica_generator(0, r),
                                 device=cuda) for r in range(4)]
    p = engine_core.stack_replicas([fe.pack_state(spec, m) for m in models])
    z = torch.zeros_like(p)
    u = step_uniforms(0, 100, 50, B, cuda, spec.n_uniform)
    kw = dict(schedule="cosine", total_steps=200)
    pk, mk, vk, lk = fe.fused_engine_packed_chunk(spec, models[0], p, z, z,
                                                  u, 100, lr, 4, **kw)
    for r in range(4):
        p1, m1, v1, l1 = fe.fused_engine_chunk(spec, models[0],
                                               p[r].contiguous(),
                                               z[r].clone(), z[r].clone(), u,
                                               100, lr, **kw)
        assert torch.equal(l1, lk[r]) and torch.equal(p1, pk[r])
        assert torch.equal(m1, mk[r]) and torch.equal(v1, vk[r])
    pp, _, _, lp = fe.fused_engine_packed_chunk_plain(spec, models[0], p, z,
                                                      z, u, 100, lr, 4, **kw)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=2 * lr)


@pytest.mark.parametrize("name", sorted(fe.HARD_SPECS))
def test_solve_hard_launches_the_engine(cuda, name):
    """A short hard fused ``solve`` trains on the generic engine (hard heat
    at a constant lr too, never on the soft heat kernel #1), evaluates its
    raw net through #2 once, and holds its trial function's constraint on
    the grid to 1e-6: x = 0 for heat, wave and poisson, t = 0 for heat2d
    and simple_ode."""
    for fn in (taylor_mlp.mlp_forward, fe.fused_engine_chunk,
               ft.heat_fused_train_chunk):
        fn.launches = 0
    fe.fused_engine_chunk.step_math_runs = 0
    res = solve(name, constraint="hard", engine="fused", iterations=300,
                schedule="constant")
    assert taylor_mlp.mlp_forward.launches == 1
    assert fe.fused_engine_chunk.step_math_runs == RUNS_300
    assert ft.heat_fused_train_chunk.launches == 0
    assert np.all(np.isfinite(res.loss_history))
    want = np.take(res.exact, 0, axis=1 if name in ("heat", "wave") else 0)
    got = np.take(res.solution, 0, axis=1 if name in ("heat", "wave") else 0)
    np.testing.assert_allclose(got, want, atol=1e-6)


# ---------------------------------------------------------------------------
# Causal advection's cross-point loss kernel (kernel id 15)
# ---------------------------------------------------------------------------

CAUSAL = dict(c=50.0, causal_eps=5.0)


def _causal_uniforms(B, tie, device, steps=1):
    """Draws of ``steps`` steps at batch B; with ``tie``, the rows of strata
    2 and 3 of every step get the same fp32 t ((2 + 1 − 2^-24)·Δt rounds to
    3·Δt)."""
    u = step_uniforms(0, 100, steps, B, None, 2)
    if tie:
        strata = stride_strata(B)[:, 0].long()
        u[:, int((strata == 2).nonzero()[0]), 1] = 1.0 - 2.0 ** -24
        u[:, int((strata == 3).nonzero()[0]), 1] = 0.0
    return u.to(device)


@pytest.mark.parametrize("B, tie", [(128, False), (100, False), (128, True)])
def test_causal_loss_kernel_matches_plain(cuda, B, tie):
    """The causal spec at c = 50, ε = 5: one step's loss to rtol 1e-5 and
    each gradient tensor to 1e-5 of its largest entry (fp32 reassociation,
    and the B-term weight sums in another order); at B = 128, at B = 100
    (not a multiple of the 32 lanes), and with two rows of equal t, which
    the kernel's strict comparison must not count, as the plain version's
    does not. A 50-step chunk (one graph replay) to rtol 1e-4 / parameters
    rtol 1e-4 plus 2·lr, cut at 25 bit for bit with the uncut chunk."""
    prob = PROBLEMS["advection"](**CAUSAL)
    spec = fe.spec_for(prob)
    model = prob.default_model(generator=generator(0), device=cuda)
    p = fe.pack_state(spec, model)
    u = _causal_uniforms(B, tie, cuda, steps=50)
    if tie:
        t = spec.build(u[0].cpu())[1]["t"][:, 0]
        assert len(set(t.tolist())) == B - 1
    loss_k, grad_k = fe.engine_loss_grad(spec, model, p, u[0])
    loss_p, grad_p = fe.engine_loss_grad_plain(spec, model, p, u[0])
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)
    for gk, gp in zip(fe.unpack_state(spec, model, grad_k),
                      fe.unpack_state(spec, model, grad_p)):
        torch.testing.assert_close(gk, gp, rtol=1e-4,
                                   atol=1e-5 * float(gp.abs().max()))
    lr = prob.defaults.lrate
    kw = dict(schedule="cosine", total_steps=200)
    z = torch.zeros_like(p)
    pk, mk, vk, lk = fe.fused_engine_chunk(spec, model, p, z, z, u, 100, lr,
                                           **kw)
    pp, _, _, lp = fe.fused_engine_chunk_plain(spec, model, p, z, z, u, 100,
                                               lr, **kw)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=2 * lr)
    p2, m2, v2, l2 = fe.fused_engine_chunk(spec, model, p, z, z, u[:25], 100,
                                           lr, **kw)
    p2, m2, v2, l2b = fe.fused_engine_chunk(spec, model, p2, m2, v2, u[25:],
                                            125, lr, **kw)
    assert torch.equal(torch.cat([l2, l2b]), lk) and torch.equal(p2, pk)
    assert torch.equal(m2, mk) and torch.equal(v2, vk)


def test_causal_packed_equals_single(cuda):
    """The causal spec packed at N = 2 (50 steps: one graph replay): each
    replica equals the single chunk on its state bit for bit, and the
    packed plain version within the single chunk's tolerances."""
    prob = PROBLEMS["advection"](**CAUSAL)
    spec = fe.spec_for(prob)
    B, lr = prob.defaults.batch_size, prob.defaults.lrate
    models = [prob.default_model(generator=replica_generator(0, r),
                                 device=cuda) for r in range(2)]
    p = engine_core.stack_replicas([fe.pack_state(spec, m) for m in models])
    z = torch.zeros_like(p)
    u = _causal_uniforms(B, False, cuda, steps=50)
    kw = dict(schedule="cosine", total_steps=200)
    pk, mk, vk, lk = fe.fused_engine_packed_chunk(spec, models[0], p, z, z,
                                                  u, 100, lr, 2, **kw)
    for r in range(2):
        p1, m1, v1, l1 = fe.fused_engine_chunk(spec, models[0],
                                               p[r].contiguous(),
                                               z[r].clone(), z[r].clone(), u,
                                               100, lr, **kw)
        assert torch.equal(l1, lk[r]) and torch.equal(p1, pk[r])
        assert torch.equal(m1, mk[r]) and torch.equal(v1, vk[r])
    pp, _, _, lp = fe.fused_engine_packed_chunk_plain(spec, models[0], p, z,
                                                      z, u, 100, lr, 2, **kw)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=2 * lr)


def test_causal_batch_limit(cuda):
    """Past CAUSAL_MAX_BATCH points (the loss kernel's shared memory) both
    entry points raise a ValueError naming it, before any launch; the
    limit itself runs."""
    prob = PROBLEMS["advection"](**CAUSAL)
    spec = fe.spec_for(prob)
    model = MLP(2, 1, 16, 1, "tanh", generator=generator(0), device=cuda)
    p = fe.pack_state(spec, model)
    fe.engine_loss_grad.launches = 0
    fe.fused_engine_chunk.launches = 0
    B = fe.CAUSAL_MAX_BATCH
    u = torch.rand((1, B + 1, 2), generator=generator(1)).to(cuda)
    with pytest.raises(ValueError, match=str(B)):
        fe.engine_loss_grad(spec, model, p, u[0])
    with pytest.raises(ValueError, match=str(B)):
        fe.fused_engine_chunk(spec, model, p, p, p, u, 0, 1e-3)
    assert (fe.engine_loss_grad.launches,
            fe.fused_engine_chunk.launches) == (0, 0)
    loss_k, _ = fe.engine_loss_grad(spec, model, p, u[0, :B])
    loss_p, _ = fe.engine_loss_grad_plain(spec, model, p, u[0, :B])
    torch.testing.assert_close(loss_k, loss_p, rtol=1e-5, atol=0)


@pytest.mark.parametrize("ensemble", [None, 2])
def test_solve_causal_launches_the_engine(cuda, ensemble):
    """A short causal fused ``solve`` runs the causal spec's step math once
    per step and in the warm-up inside #4, or inside #5 for 2 replicas, and
    evaluates through #2 once."""
    for fn in (taylor_mlp.mlp_forward, fe.fused_engine_chunk,
               fe.fused_engine_packed_chunk):
        fn.launches = 0
    fe.fused_engine_chunk.step_math_runs = 0
    fe.fused_engine_packed_chunk.step_math_runs = 0
    res = solve("advection", engine="fused", iterations=300,
                ensemble=ensemble, **CAUSAL)
    assert taylor_mlp.mlp_forward.launches == 1
    if ensemble:
        assert fe.fused_engine_packed_chunk.step_math_runs == 2 * RUNS_300
        assert fe.fused_engine_chunk.launches == 0
    else:
        assert fe.fused_engine_chunk.step_math_runs == RUNS_300
    assert np.all(np.isfinite(res.loss_history))


# ---------------------------------------------------------------------------
# The scan trainer's CUDA graphs
# ---------------------------------------------------------------------------

SCAN_CASES = {
    "heat_jvp": ("heat", {}, {}),
    "heat_pallas": ("heat", {"taps": "pallas"}, {}),
    "simple_ode": ("simple_ode", {}, {}),
    "causal_advection": ("advection", CAUSAL, {}),
    "volterra_mc": ("volterra", {"quadrature": "montecarlo"}, {}),
    "fredholm_mc": ("fredholm", {"quadrature": "montecarlo"}, {}),
    "oversample": ("simple_ode", {}, {"adaptive_oversample": 2}),
}


def _scan_run(name, kw, cfg_kw, device, **train_kw):
    prob = PROBLEMS[name](**kw)
    d = prob.defaults
    cfg = TrainConfig(**{**dict(iterations=300, batch_size=d.batch_size,
                                lrate=d.lrate, schedule=d.schedule,
                                verbose=False), **cfg_kw})
    res = train(prob, 0, cfg, device=device, **train_kw)
    return res, [t.detach().cpu() for t in res.params.parameters()]


@pytest.mark.parametrize("case", sorted(SCAN_CASES))
def test_scan_graph_equals_eager(cuda, case):
    """300 scan steps (one 256-step CUDA graph replay, then 44 eager steps)
    against the same 300 steps all eager under the same optimizer settings
    (capturable Adam, the lr a device tensor; chunks of 100 steps, shorter
    than a graph): losses and parameters bit for bit; one capture and one
    replay."""
    name, kw, cfg_kw = SCAN_CASES[case]
    before = dict(trainer.graph_stats)
    graphed, pg = _scan_run(name, kw, cfg_kw, cuda)
    assert trainer.graph_stats["captures"] == before["captures"] + 1
    assert trainer.graph_stats["replays"] == before["replays"] + 1
    eager, pe = _scan_run(name, kw, {**cfg_kw, "chunk_size": 100}, cuda)
    assert trainer.graph_stats["replays"] == before["replays"] + 1
    np.testing.assert_array_equal(graphed.loss_history, eager.loss_history)
    assert all(torch.equal(a, b) for a, b in zip(pg, pe))
    assert graphed.opt_state["param_groups"][0]["count"] == 300


def test_scan_graph_chunked_and_resumed_equal_uncut(cuda):
    """Under graphs, chunks of 300 steps (a replay and 44 eager steps each)
    equal one uncut run of 600 (two replays, 88 eager steps), and so does
    a run of 300 resumed for 300 more from its model, opt_state and
    start_step, bit for bit (constant lr: a config's schedule spans its own
    iterations)."""
    uncut, pu = _scan_run("heat", {}, dict(iterations=600), cuda)
    chunked, pc = _scan_run("heat", {}, dict(iterations=600, chunk_size=300),
                            cuda)
    np.testing.assert_array_equal(chunked.loss_history, uncut.loss_history)
    assert all(torch.equal(a, b) for a, b in zip(pc, pu))
    first, _ = _scan_run("heat", {}, {}, cuda)
    second, ps = _scan_run("heat", {}, {}, cuda, model=first.params,
                           opt_state=first.opt_state, start_step=300)
    np.testing.assert_array_equal(
        np.concatenate([first.loss_history, second.loss_history]),
        uncut.loss_history)
    assert all(torch.equal(a, b) for a, b in zip(ps, pu))


def test_scan_graph_recovers_from_a_fault(cuda):
    """A fault injected at the second chunk of a graphed run restores the
    host snapshot, captures anew and retries: the result equals the
    unbroken run bit for bit."""
    base = dict(iterations=600, chunk_size=300)
    clean, pc = _scan_run("simple_ode", {}, base, cuda)
    before = trainer.graph_stats["captures"]
    with inject_fault(1):
        faulty, pf = _scan_run("simple_ode", {}, base, cuda)
    assert trainer.graph_stats["captures"] == before + 2
    np.testing.assert_array_equal(faulty.loss_history, clean.loss_history)
    assert all(torch.equal(a, b) for a, b in zip(pf, pc))


def test_scan_graph_refuses_an_uncapturable_step(cuda):
    """A loss that reads a number back to the host mid-step cannot be
    captured: ``train`` raises, naming the capture, and does not fall back
    to eager steps."""

    class _HostSync(PROBLEMS["simple_ode"]):
        def loss(self, model, batch):
            loss = super().loss(model, batch)
            if float(loss.detach()) < 0:  # a host read: illegal under capture
                raise AssertionError
            return loss

    prob = _HostSync()
    cfg = TrainConfig(iterations=256, batch_size=8, verbose=False)
    with pytest.raises(RuntimeError, match="cannot be captured"):
        train(prob, 0, cfg, device=cuda)


# ---------------------------------------------------------------------------
# The "default" precision: the bf16 tensor-core instances (#1, #4-#7)
# ---------------------------------------------------------------------------

# Tensor by tensor (w_in, b_in, w_h, ...: the small input and output
# tensors too, which a norm of the whole flat gradient would hardly see),
# by relative L2 norms. Both the kernel and the plain version round the same
# operands to bf16, but they compute the operands of later products an fp32
# ulp apart, and such an operand can round to the next bf16 value (a 2^-8
# change). One step: each tensor's gradient within BF16_STEP_TOL of the
# plain version's and at least BF16_SEPARATION times as far from the
# kernel's own "highest" (on the H100: at most 1.04e-3, inverse_heat's
# b_in; at least 8.6 times, FitzHugh–Nagumo's Wh).
BF16_STEP_TOL = 2e-3
BF16_SEPARATION = 4
# 50 steps: each tensor's update p_K − p_0, where Adam carries the flips
# forward: within BF16_CHUNK_TOL of the plain version's and at least
# BF16_CHUNK_SEPARATION times as far from "highest" (on the H100: at most
# 1.05e-2 from the plain version, causal advection's w_in; at least 2.66
# times as far from "highest", FitzHugh–Nagumo's Uh). A tensor of fewer than
# BF16_CHUNK_ENTRIES entries (the output bias, O ≤ 2 entries; inverse_heat's
# κ̂) is held by the one-step check alone: Adam moves each entry by about lr
# a step whatever its gradient, so its 50-step update hardly depends on the
# precision.
BF16_CHUNK_TOL = 2e-2
BF16_CHUNK_SEPARATION = 2
BF16_CHUNK_ENTRIES = 8


def _rel(a, b):
    """|a − b| / |b|; 0 where both are zero."""
    diff, ref = float((a - b).norm()), float(b.norm())
    return diff / ref if ref else (0.0 if diff == 0 else math.inf)


def _check_by_tensor(split, got, plain, highest, tol, separation,
                     min_entries=1):
    """Each tensor of split(flat) of at least min_entries entries: within
    tol of the plain version's and at least ``separation`` times as far
    from the kernel's own "highest"."""
    got, plain, highest = split(got), split(plain), split(highest)
    readings = {i: (_rel(got[i], plain[i]), _rel(got[i], highest[i]))
                for i in range(len(got)) if got[i].numel() >= min_entries}
    print("relative L2 by tensor, against the plain version / against "
          "\"highest\": " + ", ".join(f"{i}: {m:.3g} / {h:.3g}"
                                      for i, (m, h) in readings.items()))
    assert readings and all(m <= tol and separation * m < h
                            for m, h in readings.values()), readings


def _assert_bf16_step(kernel, plain, split):
    """kernel(precision), plain(precision) -> (loss, flat gradient);
    split(flat) -> the trainable tensors."""
    (lkd, gkd), (lkh, gkh) = kernel("default"), kernel("highest")
    lpd, gpd = plain("default")
    torch.testing.assert_close(lkd, lpd, rtol=1e-3, atol=0)
    _check_by_tensor(split, gkd, gpd, gkh, BF16_STEP_TOL, BF16_SEPARATION)


def _assert_bf16_chunk(p0, kernel, plain, split):
    """kernel(precision), plain(precision) -> (p, m, v, losses): finite
    losses, and each tensor's update of BF16_CHUNK_ENTRIES entries or more
    within
    BF16_CHUNK_TOL of the plain version's and BF16_CHUNK_SEPARATION times
    as far from the kernel's own "highest" run."""
    pk, _, _, lk = kernel("default")
    ph = kernel("highest")[0]
    pp = plain("default")[0]
    assert torch.isfinite(lk).all()
    _check_by_tensor(split, pk - p0, pp - p0, ph - p0, BF16_CHUNK_TOL,
                     BF16_CHUNK_SEPARATION, BF16_CHUNK_ENTRIES)


@pytest.mark.parametrize("H", [128, 40, 100])
def test_bf16_heat_kernel_matches_plain(cuda, H):
    """Kernel #1 at "default" (B = 64, L = 3): one step and a 50-step
    chunk against the plain version at "default" (tolerances above), at
    heat's width and at widths whose mma tiles are partial."""
    model = MLP(2, 1, H, 3, "tanh", generator=generator(1), device=cuda)
    p = ft.pack_params(model)
    u = step_uniforms(0, 0, 50, 64, cuda)
    split = lambda flat: ft.unpack_params(model, flat)  # noqa: E731
    _assert_bf16_step(
        lambda pr: ft.heat_loss_grad(model, p, u[0], precision=pr),
        lambda pr: ft.heat_loss_grad_plain(model, p, u[0], precision=pr),
        split)
    z = torch.zeros_like(p)
    _assert_bf16_chunk(
        p, lambda pr: ft.heat_fused_train_chunk(model, p, z, z, u, 0, 1e-4,
                                                precision=pr),
        lambda pr: ft.heat_fused_train_chunk_plain(model, p, z, z, u, 0,
                                                   1e-4, precision=pr),
        split)


# (equation, its arguments, hidden width or None for the default model,
# batch or None for the default, whether to check a 50-step chunk).
BF16_ENGINE_CASES = {
    "heat2d": ("heat2d", {}, None, None, True),
    "heat2d-H40": ("heat2d", {}, 40, None, True),
    "heat2d-H100": ("heat2d", {}, 100, None, True),
    "wave": ("wave", {}, None, None, True),
    "volterra": ("volterra", {}, None, None, True),
    "uat": ("uat", {}, None, None, False),
    "inverse_heat": ("inverse_heat", {}, None, None, False),
    "causal-B128": ("advection", CAUSAL, None, 128, True),
    # At B = 100 the 50-step chunk is chaotic: on the H100 the kernel's
    # update lay 0.45 (w_in) from the plain version's and 0.26 from its own
    # "highest", and the plain chunk moves about as far under a one-ulp
    # change of its start; its chunk is held bit for bit by
    # test_bf16_chunks_are_bit_identical, its products by the one step.
    "causal-B100": ("advection", CAUSAL, None, 100, False),
    **{f"hard-{n}": (n, {"constraint": "hard"}, None, None, True)
       for n in sorted(fe.HARD_SPECS)}}


@pytest.mark.parametrize("case", sorted(BF16_ENGINE_CASES))
def test_bf16_engine_kernels_match_plain(cuda, case):
    """#6 and #4 at "default" at the spec's default shapes (heat2d also at
    widths of partial mma tiles; causal advection also at B = 100, not a
    multiple of the 32 lanes; every hard spec): one step, and but for uat
    and inverse_heat a 50-step chunk, against the plain versions at
    "default"."""
    name, args, hidden, batch, chunk = BF16_ENGINE_CASES[case]
    prob = PROBLEMS[name](**args)
    spec = fe.spec_for(prob)
    d = prob.defaults
    B = batch or d.batch_size
    model = (prob.default_model(generator=generator(1), device=cuda)
             if hidden is None else
             MLP(spec.input_dim, 1, hidden, 3, "tanh", generator=generator(1),
                 device=cuda))
    const = spec.make_const(B, cuda)
    p = fe.pack_state(spec, model)
    u = step_uniforms(0, 100, 50, B, cuda, spec.n_uniform)
    split = lambda flat: fe.unpack_state(spec, model, flat)  # noqa: E731
    _assert_bf16_step(
        lambda pr: fe.engine_loss_grad(spec, model, p, u[0], const,
                                       precision=pr),
        lambda pr: fe.engine_loss_grad_plain(spec, model, p, u[0], const,
                                             precision=pr), split)
    if chunk:
        z = torch.zeros_like(p)
        kw = dict(schedule=d.schedule, total_steps=200, const=const)
        _assert_bf16_chunk(
            p, lambda pr: fe.fused_engine_chunk(spec, model, p, z, z, u, 100,
                                                d.lrate, precision=pr, **kw),
            lambda pr: fe.fused_engine_chunk_plain(
                spec, model, p, z, z, u, 100, d.lrate, precision=pr, **kw),
            split)


@pytest.mark.parametrize("name", ["fitzhugh_nagumo", "fredholm"])
def test_bf16_dgm_kernels_match_plain(cuda, name):
    """#7 and #4 at the DGM layout at "default": one step and a 50-step
    cosine chunk against the plain versions at "default"."""
    prob = PROBLEMS[name]()
    d = prob.defaults
    spec = fd.spec_for(prob, d.batch_size)
    const = fd.const_for(spec, prob, d.batch_size, cuda)
    model = prob.default_model(generator=generator(1), device=cuda)
    p = fd.pack_dgm(model)
    u = step_uniforms(0, 100, 50, d.batch_size, cuda, spec.n_uniform)
    split = lambda flat: fd.unpack_dgm(model, flat)  # noqa: E731
    _assert_bf16_step(
        lambda pr: fd.dgm_loss_grad(spec, model, p, u[0], const,
                                    precision=pr),
        lambda pr: fd.dgm_loss_grad_plain(spec, model, p, u[0], const,
                                          precision=pr), split)
    z = torch.zeros_like(p)
    kw = dict(const=const, schedule="cosine", total_steps=200)
    _assert_bf16_chunk(
        p, lambda pr: fd.fused_dgm_chunk(spec, model, p, z, z, u, 100,
                                         d.lrate, precision=pr, **kw),
        lambda pr: fd.fused_dgm_chunk_plain(spec, model, p, z, z, u, 100,
                                            d.lrate, precision=pr, **kw),
        split)


def _bf16_chunks(run, state, u, step0):
    """run(state, u, step0) over u: uncut (graph replays and the steps left
    over), cut at 53, and one call per step (no graph)."""
    uncut = run(state, u, step0)
    a = run(state, u[:53], step0)
    cut = run(a[:3], u[53:], step0 + 53)
    single, losses = state, []
    for k in range(u.shape[0]):
        *single, loss = run(single, u[k:k + 1], step0 + k)
        losses.append(loss)
    return uncut, (cut[:3], torch.cat([a[3], cut[3]], -1)), (
        single, torch.cat(losses, -1))


@pytest.mark.parametrize("route", ["heat", "heat2d", "causal-B100",
                                   "fitzhugh_nagumo"])
def test_bf16_chunks_are_bit_identical(cuda, route):
    """At "default" a 120-step chunk (two graph replays and 20 steps
    launched from C) equals the run cut at 53 and the 120 steps run one
    call per step, bit for bit (causal advection at B = 100, not a multiple
    of the 32 lanes)."""
    if route == "heat":
        model = Heat1D().default_model(generator=generator(0), device=cuda)
        p = ft.pack_params(model)
        u = step_uniforms(0, 100, 120, 64, cuda)

        def run(state, uu, step0):
            return ft.heat_fused_train_chunk(model, *state, uu, step0, 1e-4,
                                             precision="default")
    elif route == "heat2d":
        spec, model, pp, u, lr, kw = _engine_case(cuda, "heat2d", None, 120)
        p = pp[0]

        def run(state, uu, step0):
            return fe.fused_engine_chunk(spec, model, *state, uu, step0, lr,
                                         precision="default", **kw)
    elif route == "causal-B100":
        prob = PROBLEMS["advection"](**CAUSAL)
        spec = fe.spec_for(prob)
        model = prob.default_model(generator=generator(0), device=cuda)
        p = fe.pack_state(spec, model)
        u = step_uniforms(0, 100, 120, 100, cuda, spec.n_uniform)

        def run(state, uu, step0):
            return fe.fused_engine_chunk(spec, model, *state, uu, step0,
                                         prob.defaults.lrate,
                                         precision="default",
                                         schedule="cosine", total_steps=300)
    else:
        prob = PROBLEMS[route]()
        d = prob.defaults
        spec = fd.spec_for(prob, d.batch_size)
        model = prob.default_model(generator=generator(0), device=cuda)
        p = fd.pack_dgm(model)
        u = step_uniforms(0, 100, 120, d.batch_size, cuda, 1)

        def run(state, uu, step0):
            return fd.fused_dgm_chunk(spec, model, *state, uu, step0,
                                      d.lrate, precision="default",
                                      schedule="cosine", total_steps=300)
    z = torch.zeros_like(p)
    uncut, cut, single = _bf16_chunks(run, (p, z, z), u, 100)
    for state, losses in (cut, single):
        assert torch.equal(losses, uncut[3])
        assert all(torch.equal(a, b) for a, b in zip(state, uncut[:3]))


@pytest.mark.parametrize("name, n_replicas", [("wave", 4),
                                              ("fitzhugh_nagumo", 4)])
def test_bf16_packed_equals_single(cuda, name, n_replicas):
    """At "default" packed replica r (#5) equals the single chunk on its
    state bit for bit (53 steps: a graph replay and three steps from C)."""
    if name in fe.SPECS:
        spec, model, p, u, lr, kw = _engine_case(cuda, name, n_replicas, 53)
        packed, single = fe.fused_engine_packed_chunk, fe.fused_engine_chunk
    else:
        prob = PROBLEMS[name]()
        d = prob.defaults
        spec = fd.spec_for(prob, d.batch_size)
        models = [prob.default_model(generator=replica_generator(0, r),
                                     device=cuda) for r in range(n_replicas)]
        p = engine_core.stack_replicas([fd.pack_dgm(m) for m in models])
        model, lr = models[0], d.lrate
        u = step_uniforms(0, 100, 53, d.batch_size, cuda, 1)
        kw = dict(schedule="cosine", total_steps=300)
        packed, single = fd.fused_dgm_packed_chunk, fd.fused_dgm_chunk
    z = torch.zeros_like(p)
    pk, mk, vk, lk = packed(spec, model, p, z, z, u, 100, lr, n_replicas,
                            precision="default", **kw)
    for r in range(n_replicas):
        p1, m1, v1, l1 = single(spec, model, p[r].contiguous(), z[r].clone(),
                                z[r].clone(), u, 100, lr,
                                precision="default", **kw)
        assert torch.equal(l1, lk[r]) and torch.equal(p1, pk[r])
        assert torch.equal(m1, mk[r]) and torch.equal(v1, vk[r])


@pytest.mark.parametrize("route", ["heat", "heat2d", "fitzhugh_nagumo"])
def test_bf16_mixed_is_default_then_highest(cuda, route):
    """A "mixed" run of 200 steps (130 at "default": the first chunk two
    graph replays and 30 steps from C) equals its chunks run by hand, the
    first 130 steps at "default" and the rest at "highest" on the same
    state, bit for bit; its first 130 losses equal a "default" run's."""
    K = 200
    n1 = int(K * 0.65)
    kw = dict(batch_size=64, lrate=1e-3, device=cuda)
    if route == "heat":
        prob = Heat1D()

        def train(precision):
            model = prob.default_model(generator=generator(0))
            return model, ft.train_heat_fused_result(
                prob, 0, K, model=model, precision=precision, **kw)

        def chunk(model, state, u, step0, precision):
            return ft.heat_fused_train_chunk(model, *state, u, step0, 1e-3,
                                             precision=precision)
        pack = ft.pack_params
        n_u = 2
    elif route == "heat2d":
        prob = PROBLEMS["heat2d"]()
        spec = fe.spec_for(prob)

        def train(precision):
            model = prob.default_model(generator=generator(0))
            return model, fe.train_fused_result(
                prob, 0, K, model=model, precision=precision,
                schedule="cosine", **kw)

        def chunk(model, state, u, step0, precision):
            return fe.fused_engine_chunk(spec, model, *state, u, step0, 1e-3,
                                         precision=precision,
                                         schedule="cosine", total_steps=K,
                                         const=None)
        pack = ft.pack_params
        n_u = spec.n_uniform
    else:
        prob = PROBLEMS[route]()
        spec = fd.spec_for(prob, 64)

        def train(precision):
            model = prob.default_model(generator=generator(0))
            return model, fd.train_dgm_fused_result(
                prob, 0, K, model=model, precision=precision, **kw)

        def chunk(model, state, u, step0, precision):
            return fd.fused_dgm_chunk(spec, model, *state, u, step0, 1e-3,
                                      precision=precision,
                                      schedule=prob.defaults.schedule,
                                      total_steps=K)
        pack = fd.pack_dgm
        n_u = 1
    fresh = prob.default_model(generator=generator(0), device=cuda)
    p = pack(fresh)
    z = torch.zeros_like(p)
    u = step_uniforms(0, 0, K, 64, cuda, n_u)
    a = chunk(fresh, (p, z, z), u[:n1], 0, "default")
    b = chunk(fresh, a[:3], u[n1:], n1, "highest")
    model, mixed = train("mixed")
    _, default = train("default")
    np.testing.assert_array_equal(mixed.loss_history,
                                  torch.cat([a[3], b[3]]).cpu().numpy())
    np.testing.assert_array_equal(mixed.loss_history[:n1],
                                  default.loss_history[:n1])
    assert torch.equal(pack(model), b[0])


# ---------------------------------------------------------------------------
# The sweep mode: run-time batch mask, step budget and trial horizon
# of #4, the per-slot vectors of #5, the masked losses of #6 and #7
# ---------------------------------------------------------------------------

# (route, equation, problem arguments, tile, bs, budget): the masked chunks
# of chip_smoke.py's phase 3 at its shapes (tile 512: the sweeps' largest,
# at other kernel instances than tile 64), and uat's grid and causal
# advection's plain masked loss.
MASKED_CASES = [
    ("engine", "heat", {}, 64, 37, 30),
    ("engine", "heat", {}, 512, 485, 30),
    ("engine", "inverse_heat", {}, 128, 77, 50),
    ("engine", "volterra", {}, 64, 41, 40),
    ("engine", "uat", {}, 50, 30, 50),
    ("engine", "advection", dict(c=50.0, causal_eps=5.0), 128, 70, 40),
    ("dgm", "fitzhugh_nagumo", dict(causal_eps=0.0), 256, 150, 30),
    ("dgm", "fredholm", dict(k=16), 64, 37, 30),
    ("dgm", "fredholm", dict(k=16), 512, 370, 30),
]


def _case_id(cases):
    """The cases' test ids: the equation, and the tile after it where an
    earlier case has the same equation."""
    def case_id(case):
        first = next(c for c in cases if c[1] == case[1])
        return case[1] if case is first else f"{case[1]}-{case[3]}"
    return case_id


def _sweep_case(cuda, route, name, extra, tile, n_replicas=None):
    """NAME at a tile of TILE rows: N replicas from replica_generator(0, r)
    (one: generator(1)), 50 uniforms from step 100, a cosine schedule over
    200; the wrappers (single, single plain, packed, packed plain) and the
    packing."""
    prob = PROBLEMS[name](**extra)
    gens = ([generator(1)] if n_replicas is None else
            [replica_generator(0, r) for r in range(n_replicas)])
    models = [prob.default_model(generator=g, device=cuda) for g in gens]
    if route == "engine":
        spec = fe.spec_for(prob)
        const = spec.make_const(tile, cuda)
        pack = lambda m: fe.pack_state(spec, m)  # noqa: E731
        fns = (fe.fused_engine_chunk, fe.fused_engine_chunk_plain,
               fe.fused_engine_packed_chunk,
               fe.fused_engine_packed_chunk_plain)
    else:
        spec = fd.spec_for(prob, tile)
        const = fd.const_for(spec, prob, tile, cuda)
        pack = fd.pack_dgm
        fns = (fd.fused_dgm_chunk, fd.fused_dgm_chunk_plain,
               fd.fused_dgm_packed_chunk, fd.fused_dgm_packed_chunk_plain)
    p = engine_core.stack_replicas([pack(m) for m in models])
    u = step_uniforms(0, 100, 50, tile, cuda, spec.n_uniform)
    kw = dict(schedule="cosine", total_steps=200, const=const)
    return spec, models[0], p, u, prob.defaults.lrate, kw, fns


@pytest.mark.parametrize("case", MASKED_CASES,
                         ids=_case_id(MASKED_CASES))
@pytest.mark.parametrize("horizon", ["trial", "fixed"])
def test_masked_chunk_matches_plain(cuda, case, horizon):
    """The masked and gated chunk (bs rows of the tile, budget of 50
    steps) against its plain version: losses rtol 1e-4 up to the budget
    and 0 after it in both, parameters rtol 1e-4 plus 2·lr."""
    route, name, extra, tile, bs, budget = case
    spec, model, p, u, lr, kw, fns = _sweep_case(cuda, route, name, extra,
                                                 tile)
    p, z = p[0], torch.zeros_like(p[0])
    kw.update(runtime_bs=bs, runtime_steps=budget,
              trial_horizon=horizon == "trial")
    pk, _, _, lk = fns[0](spec, model, p, z, z, u, 100, lr, **kw)
    pp, _, _, lp = fns[1](spec, model, p, z, z, u, 100, lr, **kw)
    torch.testing.assert_close(lk[:budget], lp[:budget], rtol=1e-4, atol=0)
    assert not lk[budget:].any() and not lp[budget:].any()
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=2 * lr)


@pytest.mark.parametrize("case", [c for c in MASKED_CASES
                                  if c[1] not in ("advection", "uat")],
                         ids=_case_id(MASKED_CASES))
def test_full_mask_and_budget_are_the_plain_mode(cuda, case):
    """A mask of the whole tile and a budget of every step (constant lr)
    give the unmasked chunk bit for bit on the card: the sweep mode's
    scale 1/bs is 1/B and every row's weight 1."""
    route, name, extra, tile, _, _ = case
    spec, model, p, u, lr, kw, fns = _sweep_case(cuda, route, name, extra,
                                                 tile)
    p, z = p[0], torch.zeros_like(p[0])
    kw["schedule"] = "constant"
    plain = fns[0](spec, model, p, z, z, u, 100, lr, **kw)
    swept = fns[0](spec, model, p, z, z, u, 100, lr, runtime_bs=tile,
                   runtime_steps=u.shape[0], **kw)
    for a, b in zip(plain, swept):
        assert torch.equal(a, b)


# (route, equation, problem arguments, tile, lr, bs (None: no mask),
# budgets): slots of budget 0 pruned. Heat at tile 512 with 5 slots is a
# q = 5 TPE round's call, FitzHugh–Nagumo at tile 100 with 9 unmasked
# slots its halving rungs' (chip_smoke.py's phase 3).
PER_SLOT_CASES = [
    ("engine", "heat", {}, 64, (1e-3, 3e-3, 1e-2, 1e-4), (64, 37, 1, 20),
     (50, 30, 0, 7)),
    ("engine", "heat", {}, 512, (1e-3, 3e-4, 3e-3, 1e-2, 1e-4),
     (485, 429, 348, 300, 1), (50, 30, 45, 7, 0)),
    ("dgm", "fitzhugh_nagumo", dict(causal_eps=0.0), 256, (1e-4, 1e-3, 3e-3),
     (256, 100, 17), (50, 0, 23)),
    ("dgm", "fitzhugh_nagumo", dict(causal_eps=0.0), 100,
     (1e-4, 3e-4, 1e-3, 3e-3, 1e-2, 2e-4, 5e-4, 2e-3, 5e-3), None,
     (50, 0, 0, 50, 0, 0, 30, 0, 0)),
    ("dgm", "fredholm", dict(k=16), 64, (3e-3, 1e-3, 1e-2), (64, 37, 9),
     (50, 0, 23)),
]


@pytest.mark.parametrize("case", PER_SLOT_CASES,
                         ids=_case_id(PER_SLOT_CASES))
def test_per_slot_packed_matches_single_and_plain(cuda, case):
    """The packed call's per-slot lr, batch and budget: every slot bit for
    bit the single chunk of its values, masked unless bs is None (a pruned
    slot its input, its losses 0), all against the plain version as the
    masked chunk."""
    route, name, extra, tile, lrs, bss, ns = case
    N = len(lrs)
    spec, model, p, u, _, kw, fns = _sweep_case(cuda, route, name, extra,
                                                tile, N)
    z = torch.zeros_like(p)
    vec = dict(lr_vec=np.asarray(lrs, np.float32),
               bs_vec=None if bss is None else np.asarray(bss),
               steps_vec=np.asarray(ns), mask_rows=bss is not None)
    pk, mk, vk, lk = fns[2](spec, model, p, z, z, u, 100, 0.0, N, **kw,
                            **vec)
    pp, _, _, lp = fns[3](spec, model, p, z, z, u, 100, 0.0, N, **kw, **vec)
    torch.testing.assert_close(lk, lp, rtol=1e-4, atol=0)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=2 * max(lrs))
    for r in range(N):
        one = fns[0](spec, model, p[r].contiguous(), z[r].clone(),
                     z[r].clone(), u, 100, float(np.float32(lrs[r])),
                     runtime_bs=None if bss is None else bss[r],
                     runtime_steps=ns[r], **kw)
        for a, b in zip(one, (pk[r], mk[r], vk[r], lk[r])):
            assert torch.equal(a, b)
    for pruned in (r for r in range(N) if ns[r] == 0):
        assert torch.equal(pk[pruned], p[pruned]) and not lk[pruned].any()


def test_sweep_calls_replay_the_shapes_graph(cuda):
    """The sweep mode captures a graph of its own beside the shape's plain
    one, once: a later sweep call of other values replays it. A call runs
    only to its largest budget rounded up to a whole graph of GRAPH_STEPS:
    budgets of at most 7 of 120 steps enqueue one graph's 50 steps per
    replica."""
    spec, model, p, u, lr, kw, fns = _sweep_case(cuda, "engine", "heat", {},
                                                 64, 3)
    z = torch.zeros_like(p)
    u = step_uniforms(0, 100, 120, 64, cuda, 2)
    fns[2](spec, model, p, z, z, u, 100, lr, 3, **kw)
    builds = fe.graph_stats["builds"]
    fns[2](spec, model, p, z, z, u, 100, lr, 3, steps_vec=[60, 60, 60],
           **kw)
    assert fe.graph_stats["builds"] == builds + 1
    runs = fe.fused_engine_packed_chunk.step_math_runs
    fns[2](spec, model, p, z, z, u, 100, lr, 3, steps_vec=[120, 60, 0],
           **kw)
    assert fe.graph_stats["builds"] == builds + 1
    assert fe.fused_engine_packed_chunk.step_math_runs - runs == 3 * 120
    fns[2](spec, model, p, z, z, u, 100, lr, 3, steps_vec=[7, 3, 0], **kw)
    assert (fe.fused_engine_packed_chunk.step_math_runs - runs
            == 3 * (120 + fe.GRAPH_STEPS))


def test_sweep_drivers_on_the_card(cuda):
    """The three drivers through the card's kernels at a small budget:
    finite best scores, and halving's winner equal to a standalone run of
    the full budget bit for bit (restart equals promotion)."""
    from differential_equations_dnn_tpu_torch import sweep

    heat = PROBLEMS["heat"]()
    space = sweep.SearchSpace({"batch_size": sweep.randint(1, 200),
                               "n_iters": sweep.randint(100, 300),
                               "lrate": sweep.loguniform(1e-4, 1e-2)})
    res = sweep.tpe_search_fused(heat, num_samples=5, space=space, q=3)
    assert np.isfinite(res.best_score)
    res = sweep.halving_search_fused(heat, num_samples=9, min_budget=100,
                                     max_budget=900)
    cfg, t = res.best_config, res.best_index
    tile = next(x for x in sweep.BUCKET_TILES if x >= cfg["batch_size"])
    ev = fe.make_sweep_evaluator(heat, 0, 900, max_batch=tile,
                                 schedule="constant", horizon="fixed")
    losses, p = ev(t, cfg["lrate"], cfg["batch_size"], 900)
    pos = int(np.where(res.param_indices == t)[0][0])
    assert losses[-1] == res.best_score and torch.equal(p, res.params[pos])
    res = sweep.tpe_halving_fused(heat, num_samples=6, min_budget=100,
                                  max_budget=300, brackets=2)
    assert np.isfinite(res.best_score)


# ---------------------------------------------------------------------------
# The population tier (parallel/population.py; chip_smoke.py's population
# phase, cases (a)-(f), at smaller sizes)
# ---------------------------------------------------------------------------


def _pop_standalone(prob, model, segments, lr, bs):
    """A trial run alone as chained ``train()`` calls, one per population
    it trained in: ``segments`` [(population seed, trial index, steps)],
    the first also giving its init; each on the trial's stream in that
    population, at its lr and batch bs, the Adam state carried. Returns
    (its init, the trained model, the loss history)."""
    from differential_equations_dnn_tpu_torch.core.prng import trial_seed

    seed0, t0, _ = segments[0]
    net = model.fresh(generator=replica_generator(seed0, t0), device="cuda")
    init = {k: v.detach().clone() for k, v in net.named_parameters()}
    opt_state, losses = None, []
    for seed, t, steps in segments:
        res = trainer.train(prob, trial_seed(seed, t), trainer.TrainConfig(
            iterations=steps, batch_size=bs, lrate=lr, verbose=False),
            model=net, opt_state=opt_state)
        opt_state = res.opt_state
        losses.append(res.loss_history)
    return init, net, np.concatenate(losses)


def _assert_winner_params(params, init, net, rtol=1e-2):
    """A population winner's parameters (a stack of 1) against its
    standalone run's: per tensor, the largest gap at most ``rtol`` of the
    largest distance the standalone run moved the tensor."""
    for k, v in net.named_parameters():
        moved = float((v.detach() - init[k]).abs().max())
        gap = float((params[k][0] - v.detach()).abs().max())
        assert gap <= rtol * moved, (k, gap, moved)


def test_population_graph_equals_eager(cuda, monkeypatch):
    """A run of whole graph blocks replayed against the same steps run
    eagerly (GRAPH_STEPS raised above the run's length): bit for bit,
    losses, parameters, Adam state and BatchNorm statistics, for a plain
    and a pre-BN MLP."""
    from differential_equations_dnn_tpu_torch.parallel import (
        PopulationConfig,
        population,
        train_population,
    )

    G = population.GRAPH_STEPS
    lrs = np.array([1e-3, 3e-3, 1e-4, 2e-3], np.float32)
    for bn in (None, "pre"):
        model = MLP(2, 1, 32, 2, "tanh", bn, generator=generator(0))
        runs = []
        for graph_steps in (G, 4 * G):
            monkeypatch.setattr(population, "GRAPH_STEPS", graph_steps)
            captures = population.graph_stats["captures"]
            timings = {}
            out = train_population(
                Heat1D(), model, 3, lrs, [64, 17, 5, 40],
                PopulationConfig(iterations=2 * G, max_batch_size=64),
                timings=timings)
            assert (population.graph_stats["captures"] - captures
                    == (graph_steps == G))
            runs.append((out, timings["state"]))
        (pa, oa, la), sa = runs[0]
        (pb, ob, lb), sb = runs[1]
        np.testing.assert_array_equal(la, lb)
        for tree_a, tree_b in ((pa, pb), (oa["mu"], ob["mu"]),
                               (oa["nu"], ob["nu"]), (sa or {}, sb or {})):
            for k in tree_a:
                assert torch.equal(tree_a[k], tree_b[k]), k


def test_population_step_that_cannot_be_captured_raises(cuda):
    """A loss that waits for the card (a synchronize; a host read of a
    number would already fail under vmap) cannot be captured: the
    population raises, naming the cause, and does not fall back."""
    from differential_equations_dnn_tpu_torch.parallel import (
        PopulationConfig,
        population,
        train_population,
    )

    class Syncing(Heat1D):
        def loss(self, model, batch, mask=None):
            torch.cuda.synchronize()  # waits for the card: illegal in capture
            return super().loss(model, batch, mask)

    with pytest.raises(RuntimeError, match="cannot be captured"):
        train_population(Syncing(), MLP(2, 1, 8, 1, "tanh"), 0,
                         [1e-3, 1e-3], config=PopulationConfig(
                             iterations=population.GRAPH_STEPS,
                             max_batch_size=16,
                             chunk_size=population.GRAPH_STEPS))


def test_population_trial_equals_standalone_train(cuda):
    """(a) at a smaller size: batch_size_effect's unmasked trial against a
    standalone train() of its init, stream and lr, to fp32 reassociation
    (losses rtol 1e-3 over 300 steps)."""
    from differential_equations_dnn_tpu_torch.sweep import batch_size_effect

    heat = Heat1D()
    res = batch_size_effect(heat, seed=1, batch_sizes=[1, 8, 64], runs=2,
                            iterations=300)
    assert res.all_losses.shape == (3, 2, 300)
    assert np.all(np.isfinite(res.all_losses))
    _, _, want = _pop_standalone(heat, heat.default_model(), [(1, 4, 300)],
                                 1e-4, 64)
    np.testing.assert_allclose(res.all_losses[2, 0], want, rtol=1e-3)


def test_batchnorm_population_and_train(cuda):
    """(b): the three BatchNorm populations finite; a pre-BN train() moves
    its statistics, and its eval-mode grid differs from the train-mode
    forward."""
    from differential_equations_dnn_tpu_torch.sweep import batchnorm_effect

    heat = Heat1D()
    res = batchnorm_effect(heat, seed=0, runs=2, iterations=200,
                           hidden_size=32, num_layers=2)
    assert res.labels == ["none", "pre", "post"]
    assert np.all(np.isfinite(res.all_losses))
    m = MLP(2, 1, 32, 2, "relu", "pre", generator=generator(0), device=cuda)
    trainer.train(heat, 0, trainer.TrainConfig(iterations=300, batch_size=64,
                                               verbose=False), model=m)
    assert float(m.bn.mean.abs().max()) > 1e-3
    grid = heat.evaluate(m, 10)
    with torch.no_grad():
        raw = m(heat.grid_inputs(10, cuda)).cpu().numpy().reshape(10, 10)
    assert np.all(np.isfinite(grid)) and np.max(np.abs(grid - raw)) > 1e-4


def test_scan_ensemble_and_fourier_solves(cuda):
    """(c), (d) short: a scan-engine ensemble picks a finite replica, its
    grid through kernel #2 once; FitzHugh–Nagumo's fourier_mlp solves on
    the scan trainer without a kernel."""
    taylor_mlp.mlp_forward.launches = 0
    res = solve("heat", engine="scan", ensemble=4, iterations=600, seed=0)
    assert np.isfinite(res.mae) and taylor_mlp.mlp_forward.launches == 1
    assert res.loss_history.shape == (600,)
    res = solve("fitzhugh_nagumo", arch="fourier_mlp", iterations=600,
                seed=42)
    assert np.isfinite(res.mae) and taylor_mlp.mlp_forward.launches == 1


def test_population_sweeps_on_the_card(cuda):
    """(e) short: the winners of random search and of halving (two rungs,
    the survivors carried by ``take_trials`` at the rung's seed
    ``fold_seed(seed, spent)``) against their chained standalone runs:
    the score to rtol 1e-3, the returned ``best_params()`` within 1e-2 of
    the distance each tensor moved; TPE's winner finite."""
    from differential_equations_dnn_tpu_torch.core.prng import fold_seed
    from differential_equations_dnn_tpu_torch.sweep import search

    heat = Heat1D()
    res = search.random_search(heat, 2, num_samples=4, max_iters=300)
    t, cfg = res.best_index, res.best_config
    init, net, want = _pop_standalone(heat, heat.default_model(),
                                      [(2, t, 300)], cfg["lrate"],
                                      cfg["batch_size"])
    n = cfg["n_iters"]
    np.testing.assert_allclose(res.best_score, want[n - 1], rtol=1e-3)
    _assert_winner_params(res.best_params(), init, net)
    res = search.successive_halving(heat, 2, num_samples=4, eta=2,
                                    min_budget=100, max_budget=200)
    assert sorted(c["n_iters"] for c in res.configs) == [100, 100, 200, 200]
    t, cfg = res.best_index, res.best_config
    j = int(np.flatnonzero(res.param_indices == t)[0])
    init, net, want = _pop_standalone(
        heat, heat.default_model(),
        [(fold_seed(2, 0), t, 100), (fold_seed(2, 100), j, 100)],
        cfg["lrate"], cfg["batch_size"])
    np.testing.assert_allclose(res.best_score, want[-1], rtol=1e-3)
    _assert_winner_params(res.best_params(), init, net)
    res = search.tpe_search(heat, 2, num_samples=4, rounds=2, max_iters=200)
    assert np.isfinite(res.best_score)
    assert res.best_params()["fc_in.w"].shape[0] == 1


def test_scan_ensemble_is_reproducible_across_processes(cuda, tmp_path):
    """``solve("heat", engine="scan", ensemble=8)`` at seed 0 (1 024
    steps) gives the same loss history and MAE in two fresh processes,
    bit for bit."""
    import json
    import subprocess
    import sys
    from pathlib import Path

    code = ("import json, sys; from differential_equations_dnn_tpu_torch "
            "import solve; r = solve('heat', engine='scan', ensemble=8, "
            "iterations=1024, seed=0); json.dump({'mae': r.mae, 'losses': "
            "r.loss_history.tolist()}, open(sys.argv[1], 'w'))")
    runs = []
    for i in range(2):
        out = tmp_path / f"run{i}.json"
        subprocess.run([sys.executable, "-c", code, str(out)], check=True,
                       cwd=str(Path(__file__).resolve().parents[1]),
                       timeout=600)
        runs.append(json.loads(out.read_text()))
    assert runs[0] == runs[1]


def test_resnet_trains_on_the_scan_engine(cuda):
    """(f) short: a ResNet's loss falls, its eval-mode grid is finite."""
    heat = Heat1D()
    net = ResNet(generator=generator(0), device=cuda)
    res = trainer.train(heat, 0, trainer.TrainConfig(
        iterations=512, batch_size=64, verbose=False), model=net)
    assert res.loss_history[-50:].mean() < res.loss_history[:50].mean()
    assert np.all(np.isfinite(heat.evaluate(net, 10)))


# ---------------------------------------------------------------------------
# The periphery on the card: the CLI's resume and serving
# ---------------------------------------------------------------------------


def test_cli_fused_heat_resume_is_bit_for_bit(cuda, tmp_path):
    """heat --solve --engine fused on #1, cut at 130 steps (not a multiple
    of the 50-step graph) and resumed for 170: the uncut run's solution
    and the tail of its losses, bit for bit."""
    from differential_equations_dnn_tpu_torch import cli

    base = ["heat", "--solve", "--engine", "fused", "--nnodes", "12",
            "--seed", "1"]
    ck = str(tmp_path / "ck")
    ft.heat_fused_train_chunk.launches = 0
    cli.main(base + ["--niters", "300", "--results-dir", str(tmp_path / "a")])
    cli.main(base + ["--niters", "130", "--checkpoint", ck,
                     "--results-dir", str(tmp_path / "b")])
    cli.main(base + ["--niters", "170", "--restore", ck,
                     "--results-dir", str(tmp_path / "b")])
    assert ft.heat_fused_train_chunk.launches > 0
    for name, tail in (("heat_sol_1d_dgm", None), ("heat_sol_1d_dgm_loss",
                                                   170)):
        a = np.load(tmp_path / "a" / f"{name}.npy")
        b = np.load(tmp_path / "b" / f"{name}.npy")
        np.testing.assert_array_equal(a[-tail:] if tail else a, b)


def test_exported_heat_solution_serves_on_the_card(cuda, tmp_path):
    """A trained heat net exported (from a CPU copy) and loaded on cuda
    answers on the card within 1e-5 of #2's grid, at n = 1, 17 and the
    whole 1 600-point grid."""
    from differential_equations_dnn_tpu_torch import (
        export_solution,
        load_solution,
    )

    problem = Heat1D()
    res = ft.train_heat_fused_result(problem, 0, 200)
    model = res.params
    grid = problem.evaluate(model, 40).reshape(-1)  # kernel #2
    x = problem.grid_inputs(40, device=cuda)
    fn = load_solution(export_solution(model, 2, path=tmp_path / "h.pt2"),
                       device="cuda")
    assert next(model.parameters()).is_cuda
    for n in (1, 17, x.shape[0]):
        y = fn(x[:n])
        assert y.is_cuda and y.shape == (n, 1)
        np.testing.assert_allclose(y.cpu().numpy().reshape(-1), grid[:n],
                                   atol=1e-5, rtol=0)
