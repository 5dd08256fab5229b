"""Serving: export a trained solution as a portable artifact.

Counterpart of the JAX package's serving.py. The reference's only
"deployment" story is saving solution grids to ``.npy`` (heat.py:220-225).
Here a trained network itself is exportable:

* ``export_solution`` runs ``torch.export.export`` on the model's
  eval-mode forward (a stateful model on its running statistics, as the
  JAX package's ``eval_apply``) and serialises the program with the trained
  weights in it: an artifact that any PyTorch runtime (a GPU server, a CPU
  box) loads with ``torch.export.load``, without this package installed;
* ``load_solution`` restores it to a callable on a device.

The batch dimension is a ``torch.export.Dim``, so one artifact serves any
query size, n = 1 included. The export traces a CPU copy of the model, so
the artifact names no device; ``load_solution`` moves the program (its
weights and the constants its forward creates, such as a hard-constraint
ansatz's) to the device it is asked for.

The artifact runs plain torch ops, not the MLP-forward kernel (#2) that
``Problem.evaluate`` launches: the kernels are a ctypes library of this
package, which an exported program cannot carry, and the JAX package's
artifact likewise holds ``model.apply`` outside any Pallas kernel.
"""

import copy
import io
from pathlib import Path

import torch

from differential_equations_dnn_tpu_torch.kernels.build import resolve_device


def export_solution(model, input_dim: int, path: str | Path | None = None,
                    dtype=torch.float32) -> bytes:
    """Serialise ``x -> model(x)`` in eval mode, weights included, to bytes.

    Args:
      model: the trained ``nn.Module`` (left as it is: a CPU copy is
        exported).
      input_dim: coordinate dimension d; callers pass [n, d] queries where
        n is dynamic (any batch size).
      path: optional file to write the serialised bytes to.
      dtype: the queries' dtype.

    Returns the serialised ``bytes``."""
    net = copy.deepcopy(model).cpu().eval()
    for p in net.parameters():
        p.requires_grad_(False)
    example = torch.zeros((2, input_dim), dtype=dtype)
    n = torch.export.Dim("n")
    program = torch.export.export(net, (example,),
                                  dynamic_shapes=({0: n},))
    buf = io.BytesIO()
    torch.export.save(program, buf)
    blob = buf.getvalue()
    if path is not None:
        Path(path).parent.mkdir(parents=True, exist_ok=True)
        Path(path).write_bytes(blob)
    return blob


def load_solution(source: bytes | str | Path, device="cuda"):
    """Load an exported solution onto ``device`` (default "cuda", which
    raises without a GPU; pass "cpu" for the CPU); returns ``fn(x: [n, d])
    -> [n, out]``, which takes a tensor or an array and answers with a
    tensor on ``device``."""
    from torch.export.passes import move_to_device_pass

    device = resolve_device(device)
    if not isinstance(source, bytes):
        source = Path(source).read_bytes()
    program = torch.export.load(io.BytesIO(source))
    if device.type != "cpu":
        program = move_to_device_pass(program, device)
    module = program.module()

    def solution(x):
        x = torch.as_tensor(x, dtype=torch.float32, device=device)
        with torch.no_grad():
            return module(x)

    return solution
