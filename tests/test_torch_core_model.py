"""The port's core, MLP and MLP-forward kernel against the JAX package.

Inputs come from numpy seeds; JAX parameters carry across through numpy
(``params_from_jax``). The JAX Pallas kernel runs in interpret mode on the
CPU, as the JAX package's own tests run it.
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from differential_equations_dnn_tpu.kernels.taylor_mlp import (  # noqa: E402
    mlp_forward_pallas,
)
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu_torch.core import (  # noqa: E402
    calculate_gain,
    generator,
    kaiming_uniform,
    step_uniforms,
    torch_linear_default,
    xavier_uniform,
)
from differential_equations_dnn_tpu_torch.kernels import (  # noqa: E402
    taylor_mlp,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    MLP,
    params_from_jax,
    params_to_jax,
)

ACTS = ["tanh", "relu", "sigmoid"]


def _jax_pair(activation, seed=0, H=16, L=2):
    jm = JaxMLP(input_dim=2, output_dim=1, hidden_size=H, num_layers=L,
                activation=activation)
    jp = jax.tree.map(np.asarray, jm.init(jax.random.key(seed)))
    return jm, jp, params_from_jax(jp, activation)


@pytest.mark.parametrize("activation", ACTS)
def test_mlp_forward_matches_jax(activation):
    """(a) Same parameters, same points: fp32 reassociation only (atol 1e-6
    on outputs of order 1)."""
    jm, jp, tm = _jax_pair(activation)
    x = np.random.default_rng(0).uniform(-1, 1, (33, 2)).astype(np.float32)
    want = np.asarray(jm.apply(jp, x))
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("activation", ACTS)
def test_mlp_forward_plain_matches_pallas(activation):
    """(b) The kernel's plain version against the Pallas kernel, N=100 with
    tile 64 (a ragged last tile); fp32 reassociation tolerance."""
    jm, jp, tm = _jax_pair(activation, seed=1)
    x = np.random.default_rng(1).uniform(0, 3, (100, 2)).astype(np.float32)
    want = np.asarray(mlp_forward_pallas(jm, jp, x, tile_b=64))
    with torch.no_grad():
        got = taylor_mlp.mlp_forward(tm, torch.from_numpy(x)).numpy()
    assert got.shape == (100, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("activation", ACTS)
def test_mlp_forward_plain_matches_apply_without_hidden_layers(activation):
    """(c) L = 0, which the port's kernel takes: the plain version (what
    ``mlp_forward`` runs for a CPU tensor) against JAX's ``model.apply``,
    not against ``mlp_forward_pallas``, which fails for an empty hidden
    stack (ROADMAP queue 3). N = 77 points; fp32 reassociation of 16-term
    dot products, atol 1e-6."""
    jm, jp, tm = _jax_pair(activation, seed=3, L=0)
    assert tm.num_layers == 0 and jp["hidden"]["w"].shape == (0, 16, 16)
    x = np.random.default_rng(3).uniform(0, 3, (77, 2)).astype(np.float32)
    want = np.asarray(jm.apply(jp, x))
    with torch.no_grad():
        got = taylor_mlp.mlp_forward(tm, torch.from_numpy(x)).numpy()
    assert got.shape == (77, 1)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_params_roundtrip_through_numpy():
    jm, jp, tm = _jax_pair("tanh", seed=2)
    back = params_to_jax(tm)
    assert sorted(back) == sorted(jp)
    for layer in jp:
        for leaf in jp[layer]:
            np.testing.assert_array_equal(back[layer][leaf], jp[layer][leaf])
    assert [n for n, _ in tm.named_parameters()] == [
        "fc_in.w", "fc_in.b", "hidden.w", "hidden.b", "fc_out.w", "fc_out.b"]


def test_init_bounds_match_jax_package():
    """The same bounds as the JAX initializers (core/init.py:41-67)."""
    g = generator(0)
    w = xavier_uniform((64, 32), 5.0 / 3.0, generator=g)
    assert float(w.abs().max()) <= 5.0 / 3.0 * np.sqrt(6.0 / 96)
    assert float(w.abs().max()) > 0.9 * 5.0 / 3.0 * np.sqrt(6.0 / 96)
    w = kaiming_uniform((50, 20), "relu", generator=g)
    assert float(w.abs().max()) <= np.sqrt(2.0) * np.sqrt(3.0 / 50)
    w, b = torch_linear_default((25, 10), generator=g)
    assert float(b.abs().max()) <= 0.2 and b.shape == (10,)
    assert calculate_gain("tanh") == 5.0 / 3.0
    with pytest.raises(ValueError):
        calculate_gain("swish")
    a = MLP(2, 1, 16, 2, "tanh", generator=generator(3))
    b = MLP(2, 1, 16, 2, "tanh", generator=generator(3))
    for pa, pb in zip(a.parameters(), b.parameters()):
        assert torch.equal(pa, pb)


def test_mlp_rejects_unported_variants():
    """Since item 13 the BatchNorm and Fourier-feature MLPs are ported:
    they build (no bias but fc_out's under BatchNorm; the Fourier matrix a
    frozen buffer), and an unknown placement raises the JAX ValueError."""
    bn = MLP(batch_norm="pre")
    assert bn.stateful and bn.fc_in.b is None and bn.fc_out.b is not None
    ff = MLP(fourier_features=8)
    assert ff.fc_in.w.shape[0] == 16 and not ff.plain
    with pytest.raises(ValueError, match="batch_norm"):
        MLP(batch_norm="middle")
    assert MLP(activation="swish").activation == "relu"


def test_step_uniforms_do_not_depend_on_chunking():
    whole = step_uniforms(7, 0, 8, 16)
    parts = torch.cat([step_uniforms(7, 0, 3, 16), step_uniforms(7, 3, 5, 16)])
    assert torch.equal(whole, parts)
    assert whole.shape == (8, 16, 2) and whole.dtype == torch.float32
    assert float(whole.min()) >= 0.0 and float(whole.max()) < 1.0
    big = step_uniforms(0, 0, 64, 256)
    assert abs(float(big.mean()) - 0.5) < 0.01
    assert not torch.equal(step_uniforms(8, 0, 8, 16), whole)


def test_mlp_forward_takes_plain_version_on_cpu():
    m = MLP(activation="leaky_relu", generator=generator(5))
    x = torch.rand((4, 2), generator=generator(6))
    before = taylor_mlp.mlp_forward.launches
    assert torch.equal(taylor_mlp.mlp_forward(m, x), m(x))
    assert taylor_mlp.mlp_forward.launches == before


def test_package_imports_without_jax():
    """(h) The port never imports jax."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import differential_equations_dnn_tpu_torch as p; "
            "assert 'differential_equations_dnn_tpu' not in sys.modules; "
            "print(p.solve.__name__)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=Path(__file__).resolve().parents[1],
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "solve"
