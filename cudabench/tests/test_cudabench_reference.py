"""The plain reference agrees with the port's plain versions on the CPU:
the draws, the initial weights, the MLP and DGM forwards, the heat and
FitzHugh–Nagumo losses and gradients, and the first steps of every entry
the cells drive. The tests import both; the reference imports nothing of
the port."""

import numpy as np
import pytest
import torch

from checks import first_steps
from differential_equations_dnn_tpu_torch import solve
from differential_equations_dnn_tpu_torch.core import prng as port_prng
from differential_equations_dnn_tpu_torch.equations import (
    Heat1D,
    get_problem,
)
from differential_equations_dnn_tpu_torch.kernels import (
    fused_dgm,
    fused_train,
)
from differential_equations_dnn_tpu_torch.parallel import population
from differential_equations_dnn_tpu_torch.sweep import ablations
import harness
from reference import draws, nets, pinn, prng

SEEDS = [0, 12345, 2 ** 31 + 7, 3_000_000_019]
CPU = torch.device("cpu")
HEAT = harness.load_cell("heat1d.fused.solve")
FHN = harness.load_cell("fhn.fused.ensemble16")
SCAN = harness.load_cell("heat1d.scan.solve")
POP = harness.load_cell("heat1d.population.batch_sizes")
FHN_PROBLEM = get_problem("fitzhugh_nagumo", causal_eps=0.0)


def _close(a, b, rtol):
    a, b = torch.as_tensor(a).double(), torch.as_tensor(b).double()
    assert float((a - b).norm() / b.norm()) < rtol


@pytest.mark.parametrize("seed", SEEDS)
def test_draws_equal_the_ports(seed):
    assert torch.equal(prng.step_uniforms(seed, 5, 3, 64),
                       port_prng.step_uniforms(seed, 5, 3, 64))
    assert torch.equal(prng.step_uniforms(seed, 0, 2, 100, 1),
                       port_prng.step_uniforms(seed, 0, 2, 100,
                                               n_uniform=1))
    assert prng.trial_seed(seed, 54) == port_prng.trial_seed(seed, 54)
    for ref, port in ((prng.step_generator(seed, 9),
                       port_prng.step_generator(seed, 9)),
                      (prng.replica_generator(seed, 15),
                       port_prng.replica_generator(seed, 15))):
        assert torch.equal(torch.rand(8, generator=ref),
                           torch.rand(8, generator=port))


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_scan_and_population_batches(seed):
    from differential_equations_dnn_tpu_torch.train.trainer import (
        draw_batches,
    )

    prob = Heat1D()
    block = draw_batches(prob, seed, 0, 3, 64, CPU)
    ref = draws.batches(SCAN.mix, SCAN.cfg, seed, 0, 64, 3, CPU)
    for k in range(3):
        assert torch.equal(block["xt"][k], ref[k])
    seeds = [port_prng.trial_seed(seed, t) for t in (0, 17)]
    pop = population.draw_trial_batches(prob, seeds, 0, 3, 1024, CPU)
    for i, t in enumerate((0, 17)):
        ref = draws.batches(POP.mix, POP.cfg, seed, t, 32, 3, CPU)
        for k in range(3):
            assert torch.equal(pop["xt"][k, i, :32], ref[k])


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_initial_weights_and_forward(seed):
    model = Heat1D().default_model(generator=port_prng.generator(seed))
    p = draws.initial(HEAT.mix, HEAT.cfg, seed, 0, CPU)
    for k, v in model.named_parameters():
        assert torch.equal(v.detach(), p[k]), k
    x = torch.rand(50, 2)
    assert torch.allclose(nets.forward(HEAT.cfg, p, x), model(x),
                          rtol=0, atol=1e-6)
    dgm = fused_train.replica_models(FHN_PROBLEM, None, seed, 3, CPU)[2]
    q = draws.initial(FHN.mix, FHN.cfg, seed, 2, CPU)
    for k, v in dgm.named_parameters():
        assert torch.equal(v.detach(), q[k]), k
    t = torch.rand(40, 1) * 30
    assert torch.allclose(nets.forward(FHN.cfg, q, t), dgm(t), rtol=0,
                          atol=1e-6)


def _ref_grad(cfg, p, pts):
    leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
    value = pinn.loss(cfg, leaves, pts)
    grads = torch.autograd.grad(value, list(leaves.values()))
    return value.detach(), torch.cat([g.reshape(-1) for g in grads])


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_heat_loss_and_gradient(seed):
    model = Heat1D().default_model(generator=port_prng.generator(seed))
    u = prng.step_uniforms(seed, 0, 1, 64)[0]
    loss, grad = fused_train.heat_loss_grad_plain(
        model, fused_train.pack_params(model), u)
    want, want_grad = _ref_grad(HEAT.cfg, dict(
        (k, v.detach()) for k, v in model.named_parameters()),
        pinn.points(HEAT.cfg, u))
    _close(loss, want, 1e-5)
    _close(grad, want_grad, 1e-5)


@pytest.mark.parametrize("seed", SEEDS[:2])
def test_dgm_loss_and_gradient(seed):
    spec = fused_dgm.spec_for(FHN_PROBLEM, 100)
    model = fused_train.replica_models(FHN_PROBLEM, None, seed, 1, CPU)[0]
    u = prng.step_uniforms(seed, 0, 1, 100, 1)[0]
    loss, grad = fused_dgm.dgm_loss_grad_plain(
        spec, model, fused_dgm.pack_dgm(model), u)
    want, want_grad = _ref_grad(FHN.cfg, dict(
        (k, v.detach()) for k, v in model.named_parameters()),
        pinn.points(FHN.cfg, u))
    _close(loss, want, 1e-5)
    _close(grad, want_grad, 1e-4)


def _gap(cell, seed, losses, rows):
    want = first_steps.reference_losses(cell.mix, cell.cfg, seed, rows, CPU)
    return first_steps.gap(losses, want)


@pytest.mark.parametrize("engine", ["fused", "scan"])
def test_solves_first_steps(engine):
    cell = HEAT if engine == "fused" else SCAN
    res = solve("heat", engine=engine, iterations=3, seed=SEEDS[2],
                device="cpu")
    assert _gap(cell, SEEDS[2], res.loss_history[None], [64]) < 1e-5


def test_dgm_ensemble_first_steps():
    res = fused_dgm.train_dgm_fused_ensemble_packed(
        FHN_PROBLEM, SEEDS[3], 3, 3, device="cpu")
    assert _gap(FHN, SEEDS[3], res.loss_history, [100] * 3) < 1e-5


def test_population_first_steps():
    res = ablations.batch_size_effect(seed=SEEDS[1], batch_sizes=[1, 8, 64],
                                      runs=2, iterations=3, device="cpu")
    losses = res.all_losses.reshape(6, 3)
    mix = dict(POP.mix, net_rows=[[1, 2], [8, 2], [64, 2]])
    want = first_steps.reference_losses(mix, POP.cfg, SEEDS[1],
                                        [1, 1, 8, 8, 64, 64], CPU)
    assert first_steps.gap(losses, want) < 1e-4


@pytest.mark.parametrize("cell", [HEAT, SCAN, POP], ids=["fused", "scan",
                                                         "population"])
def test_batches_from_a_later_step(cell):
    whole = draws.batches(cell.mix, cell.cfg, SEEDS[2], 3, 8, 6, CPU)
    later = draws.batches(cell.mix, cell.cfg, SEEDS[2], 3, 8, 2, CPU,
                          start=4)
    for a, b in zip(whole[4:], later):
        assert torch.equal(a, b)


def test_reference_run_returns_the_state_after_its_steps():
    rows = [100, 100]
    losses, params = first_steps.reference_run(FHN.mix, FHN.cfg, SEEDS[1],
                                               rows, CPU, steps=4)
    again, _ = first_steps.reference_run(FHN.mix, FHN.cfg, SEEDS[1], rows,
                                         CPU, steps=5)
    for net, p in enumerate(params):
        pts = draws.batches(FHN.mix, FHN.cfg, SEEDS[1], net, 100, 5, CPU)
        assert float(pinn.loss(FHN.cfg, p, pts[4])) == pytest.approx(
            again[net, 4], rel=1e-6)
    assert np.array_equal(losses, again[:, :4])
