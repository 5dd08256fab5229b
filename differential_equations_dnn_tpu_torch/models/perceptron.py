"""The one-hidden-layer perceptron of the universal-approximation demo, as an
``nn.Module``.

Counterpart of the JAX package's models/perceptron.py (reference:
demo_universal_approx_theorem.py:26-37): Linear(D → H) · tanh · Linear(H →
O) with torch-default init. Parameters keep the JAX package's names and
layout so that they load 1:1: ``fc1.w [D,H]``, ``fc1.b [H]``, ``fc2.w
[H,O]``, ``fc2.b [O]``, with ``y = x @ w + b``. The draws match the JAX
package's in distribution, not in bits.
"""

import numpy as np
import torch
from torch import nn

from differential_equations_dnn_tpu_torch.core.init import (
    torch_linear_default,
)
from differential_equations_dnn_tpu_torch.core.precision import dense
from differential_equations_dnn_tpu_torch.models.mlp import _Affine


class Perceptron(nn.Module):
    def __init__(self, input_dim: int = 1, output_dim: int = 1,
                 hidden_size: int = 3, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.input_dim, self.output_dim = input_dim, output_dim
        self.hidden_size = hidden_size
        # Draw order as in the JAX init: fc1's weight and bias, then fc2's.
        w1, b1 = torch_linear_default((input_dim, hidden_size),
                                      generator=generator, dtype=dtype)
        w2, b2 = torch_linear_default((hidden_size, output_dim),
                                      generator=generator, dtype=dtype)
        self.fc1 = _Affine(w1, b1)
        self.fc2 = _Affine(w2, b2)
        self.to(device)

    def fresh(self, generator=None, device=None) -> "Perceptron":
        """A new Perceptron of this architecture, initialised from
        ``generator`` (an ensemble's replica)."""
        return Perceptron(self.input_dim, self.output_dim, self.hidden_size,
                          generator=generator, device=device)

    def forward(self, x):
        h = torch.tanh(dense(x, self.fc1.w, self.fc1.b))
        return dense(h, self.fc2.w, self.fc2.b)


def perceptron_params_from_jax(tree, device=None) -> Perceptron:
    """A Perceptron holding the JAX package's Perceptron parameters, given
    as a nested dict of numpy arrays (``{"fc1": {"w", "b"}, "fc2": ...}``)."""
    w1, w2 = np.asarray(tree["fc1"]["w"]), np.asarray(tree["fc2"]["w"])
    model = Perceptron(w1.shape[0], w2.shape[1], w1.shape[1])
    with torch.no_grad():
        for name, p in model.named_parameters():
            layer, leaf = name.split(".")
            p.copy_(torch.tensor(np.asarray(tree[layer][leaf], np.float32)))
    return model.to(device)


def perceptron_params_to_jax(model: Perceptron) -> dict:
    """The reverse of :func:`perceptron_params_from_jax`."""
    tree = {}
    for name, p in model.named_parameters():
        layer, leaf = name.split(".")
        tree.setdefault(layer, {})[leaf] = p.detach().cpu().numpy()
    return tree
