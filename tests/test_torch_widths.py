"""The widths the port's kernels take on the card, from the Python mirrors
of their shared-memory formulas (the checks a wrapper makes before it
loads the library): kernel #1 (csrc/heat_train.cu) refuses a width it
cannot hold, kernel #2 (csrc/mlp_forward.cu) plans a tile for any width
the trainers train, and the MLP engine (csrc/engine_train.cu, kernels #4,
#5, #6) stages every operand in k-tiles, so its plan is the same at every
width up to its stated limit. No card is needed: the checks run before any
launch."""

import pytest

torch = pytest.importorskip("torch")

from differential_equations_dnn_tpu_torch.core import generator  # noqa: E402
from differential_equations_dnn_tpu_torch.core.prng import (  # noqa: E402
    step_uniforms,
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
from differential_equations_dnn_tpu_torch.kernels.engine_core import (  # noqa: E402,E501
    SMEM_LIMIT,
)
from differential_equations_dnn_tpu_torch.models import MLP  # noqa: E402

CUDA = torch.device("cuda")


def test_smem_limit_is_the_h100s():
    assert SMEM_LIMIT == 232_448


@pytest.mark.parametrize("H", [128, 221])
def test_heat_kernel_takes_width(H):
    """bwd_data_smem(H, H) = (H(H+1) + 7(H + 1 024))·4 B fits up to H =
    221 (231 108 B)."""
    assert ft.heat_smem_bytes(H) <= SMEM_LIMIT
    ft._check_model(MLP(2, 1, H, 1, "tanh"), CUDA)


@pytest.mark.parametrize("H", [222, 256])
def test_heat_kernel_refuses_width(H):
    """From H = 222 (232 912 B) the check names the limit and the widest
    width, for a CUDA device, without loading the library."""
    assert ft.heat_smem_bytes(H) > SMEM_LIMIT
    with pytest.raises(ValueError, match=r"227 KB.*H = 221"):
        ft._check_model(MLP(2, 1, H, 1, "tanh"), CUDA)


def test_heat_width_limit_is_the_cards_only():
    """On the CPU the plain version takes H = 256: two steps train."""
    model = MLP(2, 1, 256, 1, "tanh", generator=generator(0))
    p = ft.pack_params(model)
    z = torch.zeros_like(p)
    u = step_uniforms(0, 0, 2, 8, torch.device("cpu"))
    before = ft.heat_fused_train_chunk.launches
    _, _, _, losses = ft.heat_fused_train_chunk(model, p, z, z, u, 0, 1e-3)
    assert losses.shape == (2,) and torch.isfinite(losses).all()
    assert ft.heat_fused_train_chunk.launches == before


@pytest.mark.parametrize("H", [32, 128, 212, 256, 512, 1024])
def test_mlp_forward_plans_width(H):
    """Two activation tiles of rows·(H + 1) floats and a 64 × 128 W tile
    fit a block at every width up to 1 024 and beyond; 32 rows up to
    H = 779, as the kernel's H = 128 run always took."""
    rows, need = taylor_mlp.mlp_forward_plan(2, H, 1)
    assert rows in (32, 16, 8) and need <= SMEM_LIMIT
    assert need == 4 * (64 * 128 + 2 * rows * (H + 1))
    assert rows == (32 if H <= 779 else 16)


def test_mlp_forward_width_limit():
    """Past 8-row tiles (width 3 120) no plan fits; the widest is 3 119."""
    assert taylor_mlp.mlp_forward_plan(2, 3119, 1)[0] == 8
    assert taylor_mlp.mlp_forward_plan(2, 3120, 1) == (0, None)
    assert taylor_mlp._widest() == 3119


ENGINE_STREAMS = (3, 5, 7, 9, 11)  # simple_ode, advection, heat, wave, heat2d


@pytest.mark.parametrize("R", ENGINE_STREAMS)
@pytest.mark.parametrize("H", [128, 256, 512])
def test_engine_plan_takes_width(R, H):
    """The MLP engine's shared memory per block fits the H100 at every
    stream count and width the JAX engine trains, and does not grow with H:
    its largest kernel at R = 11 is the 32 × 16 weight-gradient tile (four
    16-row chunks of 11 streams, 186 624 B)."""
    need = fe.engine_plan(R, H)
    assert 0 < need <= SMEM_LIMIT
    assert need == fe.engine_plan(R, 32) == fe.engine_plan(R, 4096)
    assert fe.engine_plan(11, H) == 186_624


@pytest.mark.parametrize("R", ENGINE_STREAMS)
def test_engine_plan_width_limit(R):
    """Past MAX_WIDTH (65 535 k-tiles of 16 along the grid's y extent) the
    plan raises a ValueError that names the width."""
    assert fe.MAX_WIDTH == 65_535 * 16
    fe.engine_plan(R, fe.MAX_WIDTH)
    with pytest.raises(ValueError, match=f"width {fe.MAX_WIDTH + 1}"):
        fe.engine_plan(R, fe.MAX_WIDTH + 1)
