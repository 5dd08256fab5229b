"""The widths the port's kernels take on the card, from the Python mirrors
of their shared-memory formulas (the checks a wrapper makes before it
loads the library): kernel #1 (csrc/heat_train.cu) and the MLP engine
(csrc/engine_train.cu, kernels #4, #5, #6) stage every operand in k-tiles,
so their plans are the same at every width up to their stated limit;
kernel #2 (csrc/mlp_forward.cu) takes any width the trainers train (its
plan lives in the library alone; the card's tests check it); kernel #3
(csrc/heat_streams.cu) spreads a point tile over a thread block cluster,
so its shared memory grows with H and not with H². Past
each stated limit a ValueError names it. No card is needed: the checks run
before any launch."""

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


@pytest.mark.parametrize("H", [128, 221, 222, 256, 512])
def test_heat_kernel_takes_width(H):
    """Every operand is staged in k-tiles, so the plan's shared memory per
    block is the same at every width: the 16 × 16 weight-gradient tile of
    the 7 streams (119 552 B) is the largest. H = 222 and 256, which the
    first design refused, pass the check for a CUDA device."""
    plan = ft.heat_train_plan(H)
    assert plan == ft.heat_train_plan(32) == ft.heat_train_plan(4096)
    assert plan["smem"] == max(plan["layer"], plan["weight_grad"])
    assert plan["smem"] == 119_552 <= SMEM_LIMIT
    assert plan["limit"] == fe.MAX_WIDTH
    ft._check_model(MLP(2, 1, H, 1, "tanh"), CUDA)


@pytest.mark.parametrize("extra", [1, 16])
def test_heat_kernel_refuses_width(extra):
    """Past its stated limit (the weight gradient's 16-row k-tiles along
    the grid's y extent, the MLP engine's MAX_WIDTH) the check names the
    limit, for a CUDA device, without loading the library (L = 0 keeps the
    model small)."""
    H = ft.MAX_HEAT_WIDTH + extra
    ft.heat_train_plan(ft.MAX_HEAT_WIDTH)
    with pytest.raises(ValueError, match=f"width {H} is past the "
                                         f"{ft.MAX_HEAT_WIDTH}"):
        ft._check_model(MLP(2, 1, H, 0, "tanh"), CUDA)


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


@pytest.mark.parametrize("H", [32, 128, 212, 256, 512, 1024, 1303, 1304,
                               3119])
def test_mlp_forward_plans_width(H):
    """The kernel's narrowest tile, 8 rows (two k-major activation buffers
    of width × 8 floats, a ring of two 32 × 128 W k-tiles and their 8-byte
    barriers), fits a block's 227 KB at every width the trainers train and
    to 3 119, of D or H, so the wrapper takes it; the library plans wider
    tiles where they fit (16 rows to 1 303)."""
    assert 2 * 16 + 4 * (2 * H * 8 + 2 * 32 * 128) <= SMEM_LIMIT
    taylor_mlp.check_mlp_width(2, H)
    taylor_mlp.check_mlp_width(H, 2)


def test_mlp_forward_width_limit():
    """Past 8-row tiles with a 2-deep ring of 32-row k-tiles (width 3 120,
    of D or H) no tile fits; the widest is 3 119, as before the redesign,
    and the ValueError names it."""
    assert taylor_mlp.MAX_MLP_WIDTH == 3119
    assert 2 * 16 + 4 * (2 * 3120 * 8 + 2 * 32 * 128) > SMEM_LIMIT
    for D, H in ((2, 3120), (3120, 2)):
        with pytest.raises(ValueError, match="widest it takes is 3119"):
            taylor_mlp.check_mlp_width(D, H)


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


@pytest.mark.parametrize("H, cluster, points, stages", [
    (128, 8, 8, 8), (191, 8, 8, 8), (192, 8, 8, 8), (256, 8, 8, 8),
    (512, 8, 4, 8), (3119, 8, 1, 3), (32, 2, 8, 8), (16, 1, 8, 8),
])
def test_heat_streams_plan_takes_width(H, cluster, points, stages):
    """Kernel #3 at heat's width and past the first design's H = 191: a
    cluster of 8 CTAs from H = 113, 8 points per cluster while they fit,
    one at kernel #2's limit 3 119. The shared memory is two buffers of the
    7 streams of the points at width H and a ring of 8 (where they fit,
    else 3) 32-row k-tiles of the W slice, within a block's 227 KB."""
    plan = taylor_mlp.heat_streams_plan(H, 1)
    assert (plan["cluster"], plan["points"], plan["stages"]) == \
        (cluster, points, stages)
    assert (plan["k_tile"], plan["threads"]) == (32, 128)
    ld = -(-H // 32) * 32 + 4
    assert plan["smem"] == 4 * (2 * 7 * points * ld + stages * 32
                                * (128 // points)) <= SMEM_LIMIT


def test_heat_streams_plan_width_limit():
    """The widest plan is H = 3 264 (one point per cluster), past kernel
    #2's 3 119; past it a ValueError names the limit, before any launch."""
    assert taylor_mlp._widest_streams() == 3264
    assert taylor_mlp.heat_streams_plan(3264)["points"] == 1
    with pytest.raises(ValueError, match="widest it takes is H = 3264"):
        taylor_mlp.heat_streams_plan(3265)


def test_heat_streams_wrapper_refuses_past_limit():
    """The kernel's launch checks the plan before it checks the tensors or
    loads the library: past the limit it raises and launches nothing (the
    check needs only the widths, so CPU tensors show it here)."""
    model = MLP(2, 1, 3265, 0, "tanh", generator=generator(0))
    pts = [torch.zeros((1, 4, 2)) for _ in range(4)]
    weights = tuple(w[None] for w in (model.fc_in.w, model.fc_in.b,
                                      model.hidden.w, model.hidden.b,
                                      model.fc_out.w, model.fc_out.b))
    before = taylor_mlp.heat_fused_streams.launches
    with pytest.raises(ValueError, match="widest it takes is H = 3264"):
        taylor_mlp._launch_heat_streams(("tanh", 3265, 0, 1), pts, weights)
    assert taylor_mlp.heat_fused_streams.launches == before


def test_heat_streams_wrapper_refuses_too_many_trials():
    """Past gridDim.y's 65 535 trials a launch raises a ValueError naming
    the limit, before it checks the tensors or loads the library."""
    T = taylor_mlp.MAX_STREAM_TRIALS + 1
    pts = [torch.zeros((T, 1, 2)) for _ in range(4)]
    weights = (torch.zeros((T, 2, 4)), torch.zeros((T, 4)),
               torch.zeros((T, 0, 4, 4)), torch.zeros((T, 0, 4)),
               torch.zeros((T, 4, 1)), torch.zeros((T, 1)))
    before = taylor_mlp.heat_fused_streams.launches
    with pytest.raises(ValueError, match="at most 65535 trials"):
        taylor_mlp._launch_heat_streams(("tanh", 4, 0, 1), pts, weights)
    assert taylor_mlp.heat_fused_streams.launches == before
