"""The port's serving (differential_equations_dnn_tpu_torch/serving.py)
against the JAX package's, mirroring tests/test_serving.py.

Five model kinds (a plain MLP, a DGM, a BatchNorm MLP in eval mode on
moved running statistics, the hard-constraint heat net and inverse_heat's
net with its κ̂) are built in the JAX package, their parameters carried
into the port (``params_from_jax`` and its siblings); the port's
``load_solution(export_solution(...))`` must answer as the JAX package's
``load_solution(export_solution(model.apply, params, ...))`` on the same
queries, at n = 1, 3 and 17 (the batch dimension is dynamic). A fresh
interpreter in which the port cannot be imported serves the artifact too.
"""

import json
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from differential_equations_dnn_tpu.equations import (  # noqa: E402
    PROBLEMS as JAX_PROBLEMS,
)
from differential_equations_dnn_tpu.models import DGM as JaxDGM  # noqa: E402
from differential_equations_dnn_tpu.models import MLP as JaxMLP  # noqa: E402
from differential_equations_dnn_tpu.models import (  # noqa: E402
    hard as jhard,
)
from differential_equations_dnn_tpu.models.stateful import (  # noqa: E402
    eval_apply,
)
from differential_equations_dnn_tpu.serving import (  # noqa: E402
    export_solution as jax_export_solution,
)
from differential_equations_dnn_tpu.serving import (  # noqa: E402
    load_solution as jax_load_solution,
)
from differential_equations_dnn_tpu_torch import (  # noqa: E402
    export_solution,
    load_solution,
)
from differential_equations_dnn_tpu_torch.equations import (  # noqa: E402
    Heat1D,
    inverse_params_from_jax,
)
from differential_equations_dnn_tpu_torch.models import (  # noqa: E402
    dgm_params_from_jax,
    hard_params_from_jax,
    params_from_jax,
)

KINDS = ["mlp", "dgm", "batchnorm", "hard_heat", "inverse_heat"]
SIZES = (1, 3, 17)
TOL = dict(atol=1e-6, rtol=1e-6)


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _case(kind, seed=0):
    """(the JAX apply_fn, its parameters, the port model with them, d)."""
    key = jax.random.key(seed)
    if kind == "dgm":
        jm = JaxDGM(input_dim=1, output_dim=2, hidden_size=8, num_layers=2,
                    activation="tanh", init_scheme="torch")
        jp = _np(jm.init(key))
        return jm.apply, jp, dgm_params_from_jax(jp, "tanh", "torch"), 1
    net = JaxMLP(input_dim=2, output_dim=1, hidden_size=16, num_layers=2,
                 activation="tanh", batch_norm=("pre" if kind == "batchnorm"
                                                else None))
    if kind == "mlp":
        jp = _np(net.init(key))
        return net.apply, jp, params_from_jax(jp, "tanh"), 2
    if kind == "batchnorm":
        jp = _np(net.init(key))
        rng = np.random.default_rng(2)
        st = net.init_state()
        st = {"mean": rng.normal(0, 0.3, st["mean"].shape).astype(np.float32),
              "var": rng.uniform(0.5, 2.0, st["var"].shape).astype(
                  np.float32)}
        model = params_from_jax(jp, "tanh", batch_norm="pre", state=st)
        return eval_apply(net, st), jp, model, 2
    if kind == "hard_heat":
        jm = jhard.HardConstraint(
            net, JAX_PROBLEMS["heat"](constraint="hard").default_model()
            .ansatz)
        jp = _np(jm.init(key))
        model = hard_params_from_jax(
            jp, Heat1D(constraint="hard").hard_ansatz())
        return jm.apply, jp, model, 2
    jm = type(JAX_PROBLEMS["inverse_heat"]().default_model())(net)
    jp = _np(jm.init(key))
    return jm.apply, jp, inverse_params_from_jax(jp), 2


def _queries(n, d, seed=1):
    return np.random.default_rng(seed + n).uniform(0.0, 3.0, (n, d)).astype(
        np.float32)


@pytest.mark.parametrize("kind", KINDS)
def test_exported_solution_matches_the_jax_export(kind, tmp_path):
    apply_fn, jp, model, d = _case(kind)
    model.train()  # the export takes the eval-mode forward by itself
    path = tmp_path / f"{kind}.pt2"
    blob = export_solution(model, input_dim=d, path=path)
    assert path.read_bytes() == blob
    assert model.training
    ours = load_solution(path, device="cpu")
    theirs = jax_load_solution(bytes(jax_export_solution(apply_fn, jp,
                                                         input_dim=d)))
    for n in SIZES:
        x = _queries(n, d)
        got = ours(x)
        assert got.shape == (n, 2 if kind == "dgm" else 1)
        np.testing.assert_allclose(got.numpy(), np.asarray(theirs(x)),
                                   **TOL)


def test_export_names_no_device_and_leaves_the_model(tmp_path):
    """The artifact comes from a CPU copy; the model keeps its parameters'
    requires_grad and its mode, and a query's dtype is float32."""
    _, _, model, d = _case("hard_heat")
    before = [p.clone() for p in model.parameters()]
    fn = load_solution(export_solution(model, d), device="cpu")
    assert all(p.requires_grad for p in model.parameters())
    assert all(torch.equal(a, b) for a, b in zip(before, model.parameters()))
    out = fn([[0.5, 0.1]])
    assert out.dtype == torch.float32 and out.device.type == "cpu"


def test_load_solution_needs_a_gpu_unless_asked_for_the_cpu(monkeypatch):
    _, _, model, d = _case("mlp")
    blob = export_solution(model, d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_solution(blob)


CHILD = """
import json
import sys

# Poison the port: loading and serving the artifact must need only torch.
sys.modules["differential_equations_dnn_tpu_torch"] = None
sys.modules["differential_equations_dnn_tpu"] = None
sys.modules["jax"] = None

import io
import numpy as np
import torch

program = torch.export.load(io.BytesIO(open(sys.argv[1], "rb").read()))
fn = program.module()
out = {}
for n in (1, 3, 17):   # the batch dimension is dynamic
    x = np.linspace(0.0, 1.0, 2 * n).reshape(n, 2).astype("float32")
    with torch.no_grad():
        out[str(n)] = fn(torch.from_numpy(x)).tolist()
print(json.dumps(out))
"""


def test_export_serves_cross_process_without_the_port(tmp_path):
    """A fresh interpreter (``python -I``) in which neither package nor JAX
    can be imported loads the artifact and serves three batch sizes, each
    equal to the in-process model."""
    _, _, model, d = _case("hard_heat")
    path = tmp_path / "hard_heat.pt2"
    export_solution(model, d, path=path)
    script = tmp_path / "serve_child.py"
    script.write_text(CHILD)
    out = subprocess.run([sys.executable, "-I", str(script), str(path)],
                         capture_output=True, text=True, timeout=240,
                         cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    got = json.loads([l for l in out.stdout.splitlines()
                      if l.startswith("{")][-1])
    model.eval()
    for n in (1, 3, 17):
        x = np.linspace(0.0, 1.0, 2 * n).reshape(n, 2).astype("float32")
        with torch.no_grad():
            want = model(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(np.asarray(got[str(n)]), want, **TOL)
