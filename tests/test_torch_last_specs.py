"""The port's last three fused-engine specs (kernels/fused_engine.py:
VolterraSpec, UATSpec, InverseHeatSpec) and their equations, models and
solves against the JAX package, on the same numpy uniforms, observations
and parameters; the JAX chunk runs its Pallas kernel in interpret mode on
the CPU, as the JAX package's own tests run it. Small sizes: volterra k =
8, B = 16, H = 16, L = 2; uat H = 3, B = 16; inverse_heat n_obs = 20, B =
16, H = 16, L = 2; K = 8 steps."""

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
    fused_engine as jfe,
)
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu.models import (  # noqa: E402
    Perceptron as JaxPerceptron,
)
from differential_equations_dnn_tpu_torch import solve  # noqa: E402
from differential_equations_dnn_tpu_torch.api import (  # noqa: E402
    _fused_route,
)
from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    NOT_PORTED,
    PROBLEMS,
    inverse_params_from_jax,
    inverse_params_to_jax,
)
from differential_equations_dnn_tpu_torch.equations.inverse_heat import (  # noqa: E402,E501
    _InverseModel,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    engine_core,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_engine as fe,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    taylor_mlp,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    MLP,
    Perceptron,
    params_from_jax,
    perceptron_params_from_jax,
    perceptron_params_to_jax,
)

B, K, LR = 16, 8, 1e-3
NAMES = ["volterra", "uat", "inverse_heat"]
N_OBS = 20


def _problems(name):
    """(JAX problem, port problem) at the small sizes; inverse_heat's port
    problem holds the JAX package's observations."""
    if name == "volterra":
        return JAX_PROBLEMS[name](k=8), PROBLEMS[name](k=8)
    if name == "inverse_heat":
        jprob = JAX_PROBLEMS[name](n_obs=N_OBS)
        xt, u = (np.asarray(a) for a in jprob.observations())
        return jprob, PROBLEMS[name](n_obs=N_OBS, obs_data=(xt, u))
    return JAX_PROBLEMS[name](), PROBLEMS[name]()


def _models(name, seed=0):
    """(JAX model, its parameters as numpy, the same port model)."""
    if name == "uat":
        jm = JaxPerceptron(input_dim=1, output_dim=1, hidden_size=3)
        jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
        return jm, jp, perceptron_params_from_jax(jp)
    D = 2 if name == "inverse_heat" else 1
    jnet = JaxMLP(input_dim=D, output_dim=1, hidden_size=16, num_layers=2,
                  activation="tanh")
    if name == "volterra":
        jp = jax.tree.map(np.asarray, jnet.init(jax.random.key(seed)))
        return jnet, jp, params_from_jax(jp, "tanh")
    jm = type(JAX_PROBLEMS[name]().default_model())(jnet)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, jp, inverse_params_from_jax(jp)


def _case(name, seed=0):
    jprob, prob = _problems(name)
    jm, jp, model = _models(name, seed)
    jspec, spec = jfe.spec_for(jprob), fe.spec_for(prob)
    flat = jfe._pack_fn(jspec, jm)(jp)
    return jprob, prob, jspec, spec, jm, flat, model


def _uniforms(spec, shape, seed=0):
    return np.random.default_rng(seed).uniform(
        size=shape + (spec.n_uniform,)).astype(np.float32)


def _state_pairs(spec, model, ours, theirs):
    """(port tensor, JAX tensor) of each state tensor: uat's JAX state
    carries zero hidden tensors (1, H, H) and (1, H) that the port's L = 0
    state leaves out."""
    for t, j in zip(fe.unpack_state(spec, model, ours), theirs):
        j = np.asarray(j)
        if t.numel() == 0:
            assert not np.any(j), "a carried hidden tensor left zero"
            continue
        yield t.detach().numpy().reshape(j.shape), j


@pytest.mark.parametrize("name", NAMES)
def test_step_math_matches_jax(name):
    """(c) One step's loss and every gradient (log κ̂'s too) against JAX
    engine_step_math on the same points: loss rtol 1e-5, gradients rtol
    1e-5 / atol 1e-6 of the tensor's largest entry (at least 1e-6), fp32
    reassociation of the row sums."""
    _, _, jspec, spec, jm, flat, model = _case(name)
    L = spec.dims(model)[2]
    u = _uniforms(spec, (B,))
    loss_j, grads_j = jfe.engine_step_math(jspec, flat, jnp.asarray(u), B, L)
    loss_t, grads_t = fe.engine_step_math(
        spec, fe.unpack_state(spec, model, fe.pack_state(spec, model)),
        torch.from_numpy(u), B, L)
    assert loss_t.shape == (1, 1)
    assert len(grads_t) == 6 + len(spec.extra_shapes)
    np.testing.assert_allclose(loss_t.detach().numpy(), np.asarray(loss_j),
                               rtol=1e-5)
    flat_g = torch.cat([g.reshape(-1) for g in grads_t])
    for gt, gj in _state_pairs(spec, model, flat_g, grads_j):
        np.testing.assert_allclose(gt, gj, rtol=1e-5,
                                   atol=1e-6 * max(1.0, np.abs(gj).max()))


@pytest.mark.parametrize("name", NAMES)
def test_step_math_matches_autograd(name):
    """(d) The hand-derived backward against torch.autograd of the port
    problem's own loss at the points the spec builds (volterra: the Gauss
    nodes t = x·(u + 1)/2 in the problem's form; inverse_heat: the same
    observation rows): loss rtol 1e-5, gradients rtol 1e-4 / atol 1e-6."""
    _, prob, _, spec, _, _, model = _case(name, seed=1)
    u = torch.from_numpy(_uniforms(spec, (B,), seed=1))
    loss_a = prob.loss(model, prob.batch_from_uniforms(u))
    tensors = [t for t in spec.tensors(model) if t.numel()]
    grads_a = torch.autograd.grad(loss_a, tensors)
    loss_h, grads_h = fe.engine_step_math(
        spec, fe.unpack_state(spec, model, fe.pack_state(spec, model)), u, B,
        spec.dims(model)[2])
    torch.testing.assert_close(loss_h.reshape(()), loss_a.detach(),
                               rtol=1e-5, atol=0)
    grads_h = [g for g in grads_h if g.numel()]
    for gh, ga in zip(grads_h, grads_a):
        torch.testing.assert_close(gh, ga.reshape(gh.shape), rtol=1e-4,
                                   atol=1e-6)


@pytest.mark.parametrize("name", NAMES)
def test_chunk_matches_jax(name):
    """(e) K = 8 Adam steps from step0 = 5 in a 20-step cosine horizon
    against JAX fused_engine_chunk (Pallas, interpret mode; its const built
    by the spec, the port's by its own spec from the same data): losses and
    every parameter and moment, κ̂'s included, to rtol 1e-5 / atol 1e-6."""
    _, _, jspec, spec, jm, flat, model = _case(name, seed=2)
    u = _uniforms(spec, (K, B), seed=2)
    kw = dict(schedule="cosine", total_steps=20, decay=0.1)
    zeros = tuple(jnp.zeros_like(t) for t in flat)
    pj, mj, vj, lj = jfe.fused_engine_chunk(jspec, jm, flat, zeros, zeros,
                                            jnp.asarray(u), 5, LR, **kw)
    p = fe.pack_state(spec, model)
    z = torch.zeros_like(p)
    pt, mt, vt, lt = fe.fused_engine_chunk(spec, model, p, z, z,
                                           torch.from_numpy(u), 5, LR, **kw)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-6)
    for ours, theirs in ((pt, pj), (mt, mj), (vt, vj)):
        for a, b in _state_pairs(spec, model, ours, theirs):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


def test_uat_state_leaves_out_the_hidden_tensors():
    """(f) uat's Perceptron trains as the L = 0 layout: the port's flat
    state is fc1 and fc2 alone (D·H + H + H + 1 floats), and the JAX
    chunk's carried hidden tensors stay exactly zero through the steps
    (checked beside every chunk comparison), so leaving them out changes no
    number; loading the state back round-trips the Perceptron."""
    _, prob, jspec, spec, jm, flat, model = _case("uat")
    assert fe.state_shapes(spec, model) == [(1, 3), (3,), (0, 3, 3), (0, 3),
                                            (3, 1), (1,)]
    assert fe.state_size(spec, model) == 3 + 3 + 3 + 1
    u = _uniforms(spec, (K, B), seed=3)
    zeros = tuple(jnp.zeros_like(t) for t in flat)
    pj, _, _, _ = jfe.fused_engine_chunk(jspec, jm, flat, zeros, zeros,
                                         jnp.asarray(u), 0, LR)
    assert not np.any(np.asarray(pj[2])) and not np.any(np.asarray(pj[3]))
    p = fe.pack_state(spec, model)
    fresh = prob.default_model(generator=generator(9))
    fe.load_state(spec, fresh, p)
    assert torch.equal(fe.pack_state(spec, fresh), p)


def test_inverse_state_carries_log_kappa():
    """inverse_heat's state is the net's six tensors, then log κ̂ (one
    float), which loads back into the model's 0-d parameter."""
    _, prob, _, spec, _, _, model = _case("inverse_heat")
    p = fe.pack_state(spec, model)
    assert p.shape == (fe.state_size(spec, model),)
    assert float(p[-1]) == pytest.approx(np.log(0.5))
    p[-1] = 0.25
    fe.load_state(spec, model, p)
    assert model.log_kappa.shape == ()
    assert float(model.log_kappa.detach()) == 0.25


@pytest.mark.parametrize("name", NAMES)
def test_packed_plain_equals_single(name):
    """The packed plain chunk at N = 2 (one const shared by the replicas)
    equals the single plain chunk on each replica's state, bit for bit."""
    _, prob, _, spec, _, _, model = _case(name, seed=4)
    other = model.fresh(generator=generator(5))
    p = engine_core.stack_replicas([fe.pack_state(spec, m)
                                    for m in (model, other)])
    z = torch.zeros_like(p)
    u = torch.from_numpy(_uniforms(spec, (3, B), seed=4))
    pk, mk, vk, lk = fe.fused_engine_packed_chunk(spec, model, p, z, z, u, 0,
                                                  LR, 2)
    for r in range(2):
        p1, m1, v1, l1 = fe.fused_engine_chunk(spec, model, p[r], z[r], z[r],
                                               u, 0, LR)
        assert torch.equal(l1, lk[r]) and torch.equal(p1, pk[r])
        assert torch.equal(m1, mk[r]) and torch.equal(v1, vk[r])


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("engine", ["fused", "scan"])
def test_solve_on_cpu(name, engine):
    """(g) A short solve on each engine: a finite history of the right
    length, a finite solution of the problem's shape; the fused one takes
    the generic engine."""
    _, prob, _, spec, _, _, model = _case(name, seed=6)
    res = solve(prob, engine=engine, device="cpu", iterations=4,
                batch_size=B, nodes=7, lrate=LR, model=model)
    assert res.loss_history.shape == (4,)
    assert np.all(np.isfinite(res.loss_history))
    assert res.solution.shape == prob.solution_shape(7)
    assert np.all(np.isfinite(res.solution)) and np.isfinite(res.mae)
    if engine == "fused":
        assert _fused_route(prob, model, "constant", B) == "engine"
    if name == "inverse_heat":
        assert np.isfinite(prob.kappa_error(res.params))


def test_fused_route_checks_the_models():
    """Each new spec takes its own model and names it otherwise; volterra's
    Monte-Carlo rule has no fused spec and names engine='scan'."""
    with pytest.raises(ValueError, match="Perceptron"):
        _fused_route(PROBLEMS["uat"](), MLP(1, 1, 3, 1, "tanh"))
    with pytest.raises(ValueError, match="_InverseModel"):
        _fused_route(PROBLEMS["inverse_heat"](), MLP(2, 1, 8, 1, "tanh"))
    with pytest.raises(ValueError, match="engine='scan'"):
        _fused_route(PROBLEMS["volterra"](quadrature="montecarlo"),
                     MLP(1, 1, 8, 1, "tanh"))
    assert NOT_PORTED == {}


def test_models_load_jax_parameters():
    """(h) The Perceptron and _InverseModel hold the JAX parameters and
    give the JAX forward (and kernel #2's plain version, on the CPU), to
    rtol 1e-6; the parameters round-trip."""
    x = np.random.default_rng(0).uniform(size=(13, 1)).astype(np.float32)
    jm = JaxPerceptron(1, 1, 3)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(7)))
    model = perceptron_params_from_jax(jp)
    assert isinstance(model, Perceptron)
    with torch.no_grad():
        got = taylor_mlp.mlp_forward(model, torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(jp, x)),
                               rtol=1e-6, atol=1e-7)
    back = perceptron_params_to_jax(model)
    assert all(np.array_equal(back[a][b], jp[a][b])
               for a in ("fc1", "fc2") for b in ("w", "b"))

    jm = JAX_PROBLEMS["inverse_heat"]().default_model()
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(8)))
    model = inverse_params_from_jax(jp)
    assert isinstance(model, _InverseModel)
    xt = np.random.default_rng(1).uniform(size=(13, 2)).astype(np.float32)
    with torch.no_grad():
        got = model(torch.from_numpy(xt))
    np.testing.assert_allclose(got.numpy(), np.asarray(jm.apply(jp, xt)),
                               rtol=1e-5, atol=1e-6)
    assert float(model.kappa()) == pytest.approx(0.5)
    back = inverse_params_to_jax(model)
    assert np.array_equal(back["log_kappa"], jp["log_kappa"])


def test_observations_from_seed_and_from_data():
    """inverse_heat draws its dataset from obs_seed (fixed: the same twice,
    another seed another set, the solution plus small noise) or takes one
    given as numpy; picking rows past the table gives zeros, as the JAX
    one-hot selection does."""
    prob = PROBLEMS["inverse_heat"](n_obs=N_OBS)
    xt, u = prob.observations()
    assert xt.shape == (N_OBS, 2) and u.shape == (N_OBS, 1)
    assert torch.equal(prob.observations()[0], xt)
    other = PROBLEMS["inverse_heat"](n_obs=N_OBS, obs_seed=1).observations()
    assert not torch.equal(other[0], xt)
    clean = torch.sin(xt[:, :1]) * torch.exp(-xt[:, 1:])
    assert float((u - clean).abs().max()) < 0.05
    _, given = _problems("inverse_heat")
    jxt, _ = JAX_PROBLEMS["inverse_heat"](n_obs=N_OBS).observations()
    assert np.array_equal(given.observations()[0].numpy(), np.asarray(jxt))
    with pytest.raises(ValueError, match="obs_data"):
        PROBLEMS["inverse_heat"](n_obs=5, obs_data=(np.asarray(jxt), u))
    from differential_equations_dnn_tpu_torch.equations.inverse_heat import (
        pick_rows,
    )

    table = torch.arange(6.0).reshape(3, 2) + 1.0
    rows = pick_rows(table, torch.tensor([[0.0], [0.5], [0.99], [1.0]]))
    assert torch.equal(rows, torch.tensor([[1.0, 2.0], [3.0, 4.0],
                                           [5.0, 6.0], [0.0, 0.0]]))


def test_train_fused_result_resumes_bit_for_bit():
    """inverse_heat on the plain engine: 6 steps equal 4 then 2 resumed
    from the first run's state, bit for bit (log κ̂'s moments ride the
    state); κ̂ moves."""
    _, prob, _, spec, _, _, model = _case("inverse_heat", seed=10)
    start = fe.pack_state(spec, model)
    full = fe.train_fused_result(prob, 0, 6, batch_size=B, lrate=LR,
                                 model=model.fresh(), params=start,
                                 total_steps=6, device="cpu")
    first = fe.train_fused_result(prob, 0, 4, batch_size=B, lrate=LR,
                                  model=model.fresh(), params=start,
                                  total_steps=6, device="cpu")
    rest = fe.train_fused_result(prob, 0, 2, batch_size=B, lrate=LR,
                                 model=first.params,
                                 params=fe.pack_state(spec, first.params),
                                 opt_state=first.opt_state, start_step=4,
                                 total_steps=6, device="cpu")
    assert np.array_equal(np.concatenate([first.loss_history,
                                          rest.loss_history]),
                          full.loss_history)
    assert torch.equal(fe.pack_state(spec, rest.params),
                       fe.pack_state(spec, full.params))
    assert float(full.params.log_kappa.detach()) != pytest.approx(
        np.log(0.5))
