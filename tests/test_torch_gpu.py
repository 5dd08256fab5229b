"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here needs a CUDA device and skips without one. The file imports
no JAX, so it runs on a machine that has only PyTorch:

    python -m pytest --noconftest -p no:cacheprovider -m gpu tests/test_torch_gpu.py
"""

import pytest

torch = pytest.importorskip("torch")

from differential_equations_dnn_tpu_torch import solve  # noqa: E402
from differential_equations_dnn_tpu_torch.core import (  # noqa: E402
    generator,
    step_uniforms,
)
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    Heat1D,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    fused_train as ft,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    taylor_mlp,
)
from differential_equations_dnn_tpu_torch.models import MLP  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("activation", ["tanh", "relu", "sigmoid"])
def test_mlp_forward_kernel_matches_plain(cuda, activation):
    """At the evaluation-grid shape (1600 rows, H=128, L=3) and a ragged N;
    fp32 reassociation of 128-term dot products, outputs of order 1."""
    model = MLP(2, 1, 128, 3, activation, generator=generator(0), device=cuda)
    for n in (1600, 77):
        x = torch.rand((n, 2), generator=generator(n)).to(cuda)
        with torch.no_grad():
            got = taylor_mlp.mlp_forward(model, x)
            want = taylor_mlp.mlp_forward_plain(model, x)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


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
