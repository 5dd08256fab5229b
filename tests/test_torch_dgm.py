"""The port's DGM route (models/dgm.py, equations/fitzhugh_nagumo.py,
equations/fredholm.py, kernels/fused_dgm.py) against the JAX package, on
the same numpy uniforms and parameters; the JAX chunk runs its Pallas
kernel in interpret mode on the CPU, as the JAX package's own tests run it.
Small sizes: H=8, L=2, B=8, K=3, Fredholm at k=12 (R = 1 + ⌈12/8⌉ = 3)."""

import types

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
    fused_dgm as jfd,
)
from differential_equations_dnn_tpu.models import DGM as JaxDGM  # noqa: E402
from differential_equations_dnn_tpu.ops import (  # noqa: E402
    gauss_legendre_nodes as jax_gauss_legendre_nodes,
)
from differential_equations_dnn_tpu_torch import solve  # noqa: E402
from differential_equations_dnn_tpu_torch.api import (  # noqa: E402
    _fused_route,
)
from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    PROBLEMS,
    FitzHughNagumo,
    Fredholm2,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_dgm as fd,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    DGM,
    MLP,
    dgm_params_from_jax,
    dgm_params_to_jax,
)
from differential_equations_dnn_tpu_torch.ops import (  # noqa: E402
    GridSubsample,
    gauss_legendre_nodes,
)
from differential_equations_dnn_tpu_torch.parallel import (  # noqa: E402
    make_mesh,
)

H, L, B, K = 8, 2, 8, 3
LR = 1e-3
SPECS = ["fitzhugh_nagumo", "fredholm"]
_ACT = {"fitzhugh_nagumo": ("tanh", "torch", 2),
        "fredholm": ("relu", "xavier_relu", 1)}


def _problems(name):
    if name == "fredholm":
        return JAX_PROBLEMS[name](k=12), PROBLEMS[name](k=12)
    return JAX_PROBLEMS[name](), PROBLEMS[name]()


def _pair(name, seed=0):
    """A JAX DGM's parameters and the same parameters as a port DGM."""
    act, scheme, O = _ACT[name]
    jm = JaxDGM(input_dim=1, output_dim=O, hidden_size=H, num_layers=L,
                activation=act, init_scheme=scheme)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, jp, dgm_params_from_jax(jp, act, scheme)


def _specs(name):
    """(JAX spec bound to its const, port spec, JAX const, port const)."""
    jprob, prob = _problems(name)
    jspec, spec = jfd.spec_for(jprob, B), fd.spec_for(prob, B)
    jconst = const = None
    if name == "fredholm":
        jconst = jfd._fredholm_const(jprob, B, jspec.n_groups)
        const = fd.const_for(spec, prob, B)
        base = jspec
        jspec = jfd.spec_with_build(base,
                                    lambda u: base.build(u, const=jconst))
    return jspec, spec, jconst, const


def _uniforms(shape, seed=0):
    return np.random.default_rng(seed).uniform(
        size=shape + (1,)).astype(np.float32)


# ---------------------------------------------------------------------------
# The model
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scheme", ["torch", "xavier_relu"])
def test_dgm_init_shapes_and_bounds(scheme):
    """Both reference inits: the JAX layout's shapes, and every tensor
    inside its distribution's bound (nn.Linear defaults, or xavier with
    relu gain and zero gate biases)."""
    D, O = 1, 2
    model = DGM(D, O, 16, 3, "tanh", scheme, generator=generator(0))
    shapes = {name: tuple(p.shape) for name, p in model.named_parameters()}
    assert shapes == {
        "s_in.w": (D, 16), "s_in.b": (16,), "layers.Wzgr": (3, 16, 48),
        "layers.Uzgr": (3, D, 48), "layers.bzgr": (3, 48),
        "layers.Wh": (3, 16, 16), "layers.Uh": (3, D, 16),
        "layers.bh": (3, 16), "s_out.w": (16, O), "s_out.b": (O,)}
    gain = np.sqrt(2.0)
    bounds = {
        "torch": {"s_in.w": 1.0, "s_in.b": 1.0, "layers.Wzgr": 0.25,
                  "layers.Uzgr": 1.0, "layers.bzgr": 0.25, "layers.Wh": 0.25,
                  "layers.Uh": 1.0, "layers.bh": 0.25, "s_out.w": 0.25,
                  "s_out.b": 0.25},
        "xavier_relu": {"s_in.w": np.sqrt(6 / 17), "s_in.b": 1.0,
                        "layers.Wzgr": gain * np.sqrt(6 / 32),
                        "layers.Uzgr": gain * np.sqrt(6 / 17),
                        "layers.bzgr": 0.0,
                        "layers.Wh": gain * np.sqrt(6 / 32),
                        "layers.Uh": gain * np.sqrt(6 / 17),
                        "layers.bh": 0.0, "s_out.w": np.sqrt(6 / 18),
                        "s_out.b": 0.25},
    }[scheme]
    for name, p in model.named_parameters():
        top = float(p.detach().abs().max())
        assert top <= bounds[name] + 1e-7, name
        if bounds[name] > 0 and p.numel() >= 16:
            assert top > bounds[name] / 2, name  # drawn, not zero
    with pytest.raises(ValueError, match="init_scheme"):
        DGM(init_scheme="orthogonal")


@pytest.mark.parametrize("name", SPECS)
def test_dgm_params_from_jax_round_trip(name):
    """JAX parameters carried across: the port's forward equals
    ``models.dgm.DGM.apply`` to fp32 reassociation, and the reverse trip
    returns the same arrays bit for bit."""
    jm, jp, tm = _pair(name, seed=3)
    x = np.random.default_rng(3).uniform(size=(11, 1)).astype(np.float32)
    with torch.no_grad():
        ours = tm(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(ours, np.asarray(jm.apply(jp, x)), rtol=1e-5,
                               atol=1e-6)
    back = dgm_params_to_jax(tm)
    for module in jp:
        for leaf in jp[module]:
            np.testing.assert_array_equal(back[module][leaf],
                                          jp[module][leaf])
    flat = fd.pack_dgm(tm)
    for a, b in zip(fd.unpack_dgm(tm, flat), jfd.pack_dgm(jp)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


# ---------------------------------------------------------------------------
# The equations
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SPECS)
def test_equation_matches_jax(name):
    """grid_inputs, solution_shape, exact and defaults against the JAX
    problem's (fp32 linspace: 1e-6; exact in float64: 1e-12)."""
    theirs, ours = JAX_PROBLEMS[name](), PROBLEMS[name]()
    nodes = 9
    np.testing.assert_allclose(ours.grid_inputs(nodes).numpy(),
                               np.asarray(theirs.grid_inputs(nodes)),
                               rtol=1e-6, atol=1e-6)
    assert ours.solution_shape(nodes) == theirs.solution_shape(nodes)
    np.testing.assert_allclose(ours.exact(nodes), theirs.exact(nodes),
                               rtol=1e-12, atol=1e-12)
    for field in ("iterations", "batch_size", "lrate", "nodes", "schedule"):
        assert (getattr(ours.defaults, field)
                == getattr(theirs.defaults, field))
    m = ours.default_model(generator=generator(0))
    jm = theirs.default_model()
    assert (m.input_dim, m.output_dim, m.hidden_size, m.num_layers,
            m.activation, m.init_scheme) == (
        jm.input_dim, jm.output_dim, jm.hidden_size, jm.num_layers,
        jm.activation, jm.init_scheme)


def test_quadrature_and_sampler_match_jax():
    """Gauss–Legendre nodes and weights as the JAX package's (fp32), and
    the grid subsampler draws distinct points of the 200-point grid."""
    for k in (5, 50):
        ours = gauss_legendre_nodes(k, 0.0, np.pi / 2)
        theirs = jax_gauss_legendre_nodes(k, 0.0, np.pi / 2)
        for a, b in zip(ours, theirs):
            assert a.dtype == torch.float32
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    t = GridSubsample(0.0, 30.0, 200).sample(100, generator(1))
    grid = torch.linspace(0.0, 30.0, 200)
    assert t.shape == (100, 1) and len(set(t[:, 0].tolist())) == 100
    assert torch.isin(t, grid).all()
    with pytest.raises(ValueError, match="without replacement"):
        GridSubsample(0.0, 30.0, 200).sample(201)


@pytest.mark.parametrize("causal_eps", [5.0, 0.0])
def test_fitzhugh_nagumo_samples(causal_eps):
    """Causal sampling is stratified (one point per slice, shuffled);
    otherwise the reference's grid subsample; the validation batch is
    off-grid; the spec's rows equal the JAX spec's on the same draws."""
    prob = FitzHughNagumo(causal_eps=causal_eps)
    batch = prob.sample(100, generator(2))
    t = batch["t"][:, 0]
    assert batch["t0"].shape == (100, 1) and float(batch["t0"].abs().max()) \
        == 0.0
    if causal_eps:
        slots = torch.sort(torch.floor(t / (prob.t_max / 100))).values
        assert torch.equal(slots, torch.arange(100, dtype=t.dtype))
    else:
        assert len(set(t.tolist())) == 100
    assert prob.validation_sample(64, generator(3))["t"].shape == (64, 1)
    u = _uniforms((B,), seed=4)
    jspec = jfd.spec_for(JAX_PROBLEMS["fitzhugh_nagumo"](
        causal_eps=causal_eps))
    X, _ = fd.spec_for(prob).build(torch.from_numpy(u))
    np.testing.assert_allclose(X.numpy(), np.asarray(jspec.build(
        jnp.asarray(u))[0]), rtol=1e-6, atol=0)


def test_fredholm_const_matches_jax():
    """The const operand: each node group's (nodes, weights), zero-padded
    past k, as the JAX package builds it; R = 1 + ⌈k/B⌉."""
    jprob, prob = _problems("fredholm")
    spec = fd.spec_for(prob, B)
    assert spec.n_groups == 3 and fd._layout(spec) == (3, 0b111)
    const = fd.const_for(spec, prob, B)
    np.testing.assert_array_equal(
        const.numpy(), np.asarray(jfd._fredholm_const(jprob, B, 3)))
    assert fd.spec_for(Fredholm2(), 32).n_groups == 3
    assert fd.spec_for(Fredholm2(), 1).n_groups == 51
    assert fd._layout(fd.spec_for(FitzHughNagumo())) == (3, 0b101)


# ---------------------------------------------------------------------------
# The step math and the K-step chunk
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SPECS)
def test_dgm_step_math_matches_jax(name):
    """One step's loss and 10 gradients against JAX dgm_step_math on the
    same points: fp32 reassociation, loss rtol 1e-5, gradients rtol 1e-5 /
    atol 1e-6 of the tensor's largest entry (at least 1e-6)."""
    jm, jp, tm = _pair(name)
    jspec, spec, _, const = _specs(name)
    u = _uniforms((B,))
    loss_j, grads_j = jfd.dgm_step_math(jspec, jfd.pack_dgm(jp),
                                        jnp.asarray(u), B, L)
    loss_t, grads_t = fd.dgm_step_math(
        spec, fd.unpack_dgm(tm, fd.pack_dgm(tm)), torch.from_numpy(u), B, L,
        const)
    assert loss_t.shape == (1, 1)
    np.testing.assert_allclose(loss_t.numpy(), np.asarray(loss_j), rtol=1e-5)
    for gt, gj in zip(grads_t, grads_j):
        gj = np.asarray(gj)
        np.testing.assert_allclose(gt.numpy(), gj, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(gj).max()))


@pytest.mark.parametrize("name, causal_eps", [
    ("fitzhugh_nagumo", 5.0), ("fitzhugh_nagumo", 0.0), ("fredholm", None),
])
def test_dgm_step_math_matches_autograd(name, causal_eps):
    """The hand-derived backward against torch.autograd of the port
    equation's own loss (jvp taps; FitzHugh–Nagumo's causal weighting; the
    Fredholm integral as one batched forward over the nodes) at the points
    the spec builds: loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6."""
    _, _, tm = _pair(name, seed=1)
    prob = (FitzHughNagumo(causal_eps=causal_eps) if causal_eps is not None
            else PROBLEMS[name](k=12))
    spec = fd.spec_for(prob, B)
    u = torch.from_numpy(_uniforms((B,), seed=1))
    loss_a = prob.loss(tm, prob.batch_from_uniforms(u))
    grads_a = torch.autograd.grad(loss_a, list(fd._tensors(tm)))
    loss_h, grads_h = fd.dgm_step_math(
        spec, fd.unpack_dgm(tm, fd.pack_dgm(tm)), u, B, L,
        fd.const_for(spec, prob, B))
    torch.testing.assert_close(loss_h.reshape(()), loss_a.detach(),
                               rtol=1e-5, atol=0)
    for gh, ga in zip(grads_h, grads_a):
        torch.testing.assert_close(gh, ga, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("name", SPECS)
@pytest.mark.parametrize("schedule", ["constant", "cosine"])
def test_dgm_chunk_matches_jax(name, schedule):
    """K=3 Adam steps from step0=4 inside a 10-step horizon against JAX
    fused_dgm_chunk (Pallas, interpret mode; Fredholm with its const):
    losses and all parameters and moments to rtol 1e-5 / atol 1e-6."""
    jm, jp, tm = _pair(name, seed=2)
    jspec, spec, jconst, const = _specs(name)
    if name == "fredholm":
        jspec = jspec._spec  # the chunk binds the const itself
    u = _uniforms((K, B), seed=2)
    kw = dict(schedule=schedule, total_steps=10, decay=0.1)
    flat = jfd.pack_dgm(jp)
    zeros = tuple(jnp.zeros_like(t) for t in flat)
    pj, mj, vj, lj = jfd.fused_dgm_chunk(jspec, jm, flat, zeros, zeros,
                                         jnp.asarray(u), 4, LR, const=jconst,
                                         **kw)
    p = fd.pack_dgm(tm)
    z = torch.zeros_like(p)
    pt, mt, vt, lt = fd.fused_dgm_chunk(spec, tm, p, z, z,
                                        torch.from_numpy(u), 4, LR,
                                        const=const, **kw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-6)
    for ours, theirs in ((pt, pj), (mt, mj), (vt, vj)):
        for a, b in zip(fd.unpack_dgm(tm, ours), theirs):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                       atol=1e-6)


def test_dgm_slice_matches_jax_end_to_end():
    """The same params and uniforms through chunk → evaluate → MAE on both
    sides (FitzHugh–Nagumo): equal MAE to rtol 1e-4."""
    jm, jp, tm = _pair("fitzhugh_nagumo", seed=7)
    jspec, spec, _, _ = _specs("fitzhugh_nagumo")
    u = _uniforms((K, B), seed=7)
    flat = jfd.pack_dgm(jp)
    zeros = tuple(jnp.zeros_like(t) for t in flat)
    pj, _, _, _ = jfd.fused_dgm_chunk(jspec, jm, flat, zeros, zeros,
                                      jnp.asarray(u), 0, LR)
    jprob, prob = _problems("fitzhugh_nagumo")
    mae_j = jprob.mae(jm.apply, jfd.unpack_dgm(pj), nodes=10)
    p = fd.pack_dgm(tm)
    z = torch.zeros_like(p)
    pt, _, _, _ = fd.fused_dgm_chunk(spec, tm, p, z, z, torch.from_numpy(u),
                                     0, LR)
    fd.load_dgm(tm, pt)
    assert prob.evaluate(tm, 10).shape == (10, 2)
    np.testing.assert_allclose(prob.mae(tm, nodes=10), mae_j, rtol=1e-4)


def test_dgm_chunked_run_is_bit_identical():
    """Two chunks (step0 = 0, 2) equal one chunk of 5, bit for bit, under a
    decaying schedule with Fredholm's const; and train_dgm_fused_result
    resumed from params, opt_state and start_step equals the uncut run."""
    _, _, tm = _pair("fredholm", seed=3)
    _, spec, _, const = _specs("fredholm")
    u = torch.from_numpy(_uniforms((5, B), seed=3))
    kw = dict(const=const, schedule="cosine", total_steps=5)
    p = fd.pack_dgm(tm)
    z = torch.zeros_like(p)
    p5, m5, v5, l5 = fd.fused_dgm_chunk(spec, tm, p, z, z, u, 0, LR, **kw)
    p2, m2, v2, l2 = fd.fused_dgm_chunk(spec, tm, p, z, z, u[:2], 0, LR,
                                        **kw)
    p2, m2, v2, l3 = fd.fused_dgm_chunk(spec, tm, p2, m2, v2, u[2:], 2, LR,
                                        **kw)
    assert torch.equal(torch.cat([l2, l3]), l5)
    for a, b in ((p2, p5), (m2, m5), (v2, v5)):
        assert torch.equal(a, b)

    prob = FitzHughNagumo()
    run = dict(batch_size=B, lrate=LR, device="cpu")

    def model():
        return DGM(1, 2, H, L, "tanh", generator=generator(4))

    full = fd.train_dgm_fused_result(prob, 4, 6, model=model(), **run)
    first = fd.train_dgm_fused_result(prob, 4, 3, model=model(),
                                      total_steps=6, chunk_size=2, **run)
    second = fd.train_dgm_fused_result(prob, 4, 3, model=model(),
                                       params=fd.pack_dgm(first.params),
                                       opt_state=first.opt_state,
                                       start_step=3, **run)
    np.testing.assert_array_equal(
        np.concatenate([first.loss_history, second.loss_history]),
        full.loss_history)
    assert torch.equal(fd.pack_dgm(second.params), fd.pack_dgm(full.params))


# ---------------------------------------------------------------------------
# solve and what raises
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", SPECS)
def test_solve_dgm_on_cpu(name):
    """``solve(..., device="cpu")`` on the plain DGM engine: a finite
    history of the right length, a finite solution of the problem's
    shape (Fredholm at its default k = 50: R = 1 + ⌈50/8⌉ = 8)."""
    act, scheme, O = _ACT[name]
    model = DGM(1, O, H, 1, act, scheme, generator=generator(0))
    res = solve(name, engine="fused", device="cpu", iterations=6,
                batch_size=B, lrate=3e-3, model=model, nodes=7)
    assert res.loss_history.shape == (6,)
    assert np.all(np.isfinite(res.loss_history))
    assert res.solution.shape == PROBLEMS[name]().solution_shape(7)
    assert np.all(np.isfinite(res.solution)) and np.isfinite(res.mae)
    assert _fused_route(PROBLEMS[name](), model, "constant", B) == "dgm"


@pytest.mark.parametrize("call, error, match", [
    (lambda: FitzHughNagumo(arch="fourier_mlp"), None, None),
    (lambda: solve("fitzhugh_nagumo", constraint="hard", engine="fused",
                   device="cpu", iterations=10), ValueError, "scan engine"),
    (lambda: solve("fredholm", quadrature="montecarlo", engine="fused",
                   device="cpu"), ValueError, "engine='scan'"),
    (lambda: solve("fredholm", quadrature="halton", engine="fused",
                   device="cpu"), ValueError, "engine='scan'"),
    (lambda: solve("fitzhugh_nagumo", engine="scan", device="cpu",
                   causal_eps=0.0, iterations=2, batch_size=8, nodes=5,
                   finetune=1), None, None),
    (lambda: solve("fredholm", engine="fused", device="cpu", finetune=5,
                   precision="bf16"), ValueError, "unknown precision"),
    (lambda: solve("fredholm", engine="fused", device="cpu", ensemble=4,
                   mesh=make_mesh({"data": 1}, "cpu")), ValueError,
     "'pop' mesh axis"),
    (lambda: _fused_route(types.SimpleNamespace(name="fitzhugh_nagumo",
                                                arch="fourier_mlp"),
                          MLP(1, 2, 8, 1, "tanh")), ValueError,
     "scan engine"),
], ids=["fourier_mlp", "hard", "montecarlo", "halton", "causal_eps0",
        "finetune", "ensemble", "route_fourier"])
def test_dgm_unported_routes_raise(call, error, match):
    """What the DGM slice does not run raises, naming its ROADMAP item;
    Fredholm's stochastic quadratures and FitzHugh–Nagumo's hard trial
    function train on the scan engine, and the fused route refuses them
    with the JAX package's ValueError naming the scan engine. Since item
    13 the fourier_mlp arch builds (``error`` None), its fused route
    raises that ValueError, and FitzHugh–Nagumo with causal_eps=0 on the
    scan engine trains its automatic 16-replica population (here 2 steps,
    one L-BFGS step). Since item 14 a fused ensemble takes a mesh: one
    without a 'pop' axis is refused with the JAX package's ValueError."""
    if error is None:
        out = call()
        if hasattr(out, "loss_history"):
            assert np.all(np.isfinite(out.loss_history))
        return
    with pytest.raises(error, match=match):
        call()


def test_dgm_route_checks_its_model():
    """The DGM engine takes a DGM with the spec's gates and widths; a
    Fredholm spec without its const, or a CPU run of a wrong model,
    raises."""
    fn = FitzHughNagumo()
    assert fd.supports(fn) and fd.supports(Fredholm2(), batch_size=32)
    assert not fd.supports(fn, DGM(1, 1, 8, 1, "tanh"))
    assert not fd.supports(PROBLEMS["heat"]())
    with pytest.raises(ValueError, match="DGM"):
        _fused_route(fn, MLP(1, 2, 8, 1, "tanh"))
    with pytest.raises(ValueError, match="DGM"):
        _fused_route(fn, DGM(1, 2, 8, 1, "relu"))
    _, spec, _, _ = _specs("fredholm")
    _, _, tm = _pair("fredholm")
    p = fd.pack_dgm(tm)
    with pytest.raises(ValueError, match="const"):
        fd.dgm_loss_grad(spec, tm, p, torch.zeros(B, 1))
    with pytest.raises(ValueError, match="tanh"):
        fd.dgm_loss_grad(fd.spec_for(fn), tm, p, torch.zeros(B, 1))
    res = solve("fitzhugh_nagumo", engine="fused", device="cpu",
                causal_eps=0.0, ensemble=0, finetune=0, iterations=2,
                batch_size=B, nodes=5,
                model=DGM(1, 2, H, 1, "tanh", generator=generator(0)))
    assert res.loss_history.shape == (2,)
