"""The plain feed-forward MLP, as an ``nn.Module``.

Parameters keep the JAX package's names and layout (models/mlp.py:103-140)
so that they load 1:1: ``fc_in.w [D,H]``, ``fc_in.b [H]``, ``hidden.w
[L,H,H]``, ``hidden.b [L,H]``, ``fc_out.w [H,O]``, ``fc_out.b [O]``, with
``y = x @ w + b``. Init matches the JAX package's draws in distribution
(xavier with activation gain for tanh/sigmoid, gain 1 on the output layer;
kaiming for relu/leaky_relu; ``nn.Linear``-default biases), not in bits.
"""

import numpy as np
import torch
from torch import nn

from differential_equations_dnn_tpu_torch.core.activations import (
    ACTIVATIONS,
    get_activation,
)
from differential_equations_dnn_tpu_torch.core.init import (
    calculate_gain,
    kaiming_uniform,
    torch_linear_default,
    xavier_uniform,
)
from differential_equations_dnn_tpu_torch.core.precision import dense

_NOT_PORTED = ("{} is not ported yet (ROADMAP.md queue 1, item 13: "
               "BatchNorm and Fourier-feature MLPs)")


class _Affine(nn.Module):
    """``w`` and ``b`` of one layer, or of a stack of layers."""

    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


class MLP(nn.Module):
    def __init__(self, input_dim: int = 2, output_dim: int = 1,
                 hidden_size: int = 50, num_layers: int = 1,
                 activation: str = "relu", batch_norm: str | None = None,
                 fourier_features: int = 0, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        if batch_norm is not None:
            raise NotImplementedError(_NOT_PORTED.format("batch_norm"))
        if fourier_features:
            raise NotImplementedError(_NOT_PORTED.format("fourier_features"))
        get_activation(activation)  # warns on an unknown name
        self.input_dim, self.output_dim = input_dim, output_dim
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.activation = activation if activation in ACTIVATIONS else "relu"

        D, H, L, O = input_dim, hidden_size, num_layers, output_dim
        g = generator

        def weight(shape, is_output=False):
            if self.activation in ("relu", "leaky_relu"):
                return kaiming_uniform(shape, self.activation, generator=g,
                                       dtype=dtype)
            gain = 1.0 if is_output else calculate_gain(self.activation)
            return xavier_uniform(shape, gain, generator=g, dtype=dtype)

        def bias(fan_in, fan_out):
            return torch_linear_default((fan_in, fan_out), generator=g,
                                        dtype=dtype)[1]

        # Draw order as in the JAX init: weights, then biases.
        w_in = weight((D, H))
        w_hid = torch.stack([weight((H, H)) for _ in range(L)]) if L else \
            torch.zeros((0, H, H), dtype=dtype)
        w_out = weight((H, O), is_output=True)
        b_in = bias(D, H)
        b_hid = torch.stack([bias(H, H) for _ in range(L)]) if L else \
            torch.zeros((0, H), dtype=dtype)
        b_out = bias(H, O)
        self.fc_in = _Affine(w_in, b_in)
        self.hidden = _Affine(w_hid, b_hid)
        self.fc_out = _Affine(w_out, b_out)
        self.to(device)

    def fresh(self, generator=None, device=None) -> "MLP":
        """A new MLP of this architecture, initialised from ``generator``
        (an ensemble's replica, as the JAX package's ``model.init(key)``)."""
        return MLP(self.input_dim, self.output_dim, self.hidden_size,
                   self.num_layers, self.activation, generator=generator,
                   device=device)

    def forward(self, x):
        act = get_activation(self.activation)
        h = act(dense(x, self.fc_in.w, self.fc_in.b))
        for l in range(self.num_layers):
            h = act(dense(h, self.hidden.w[l], self.hidden.b[l]))
        return dense(h, self.fc_out.w, self.fc_out.b)


def params_from_jax(tree, activation: str = "tanh", device=None) -> MLP:
    """An MLP holding the JAX package's MLP parameters, given as a nested
    dict of numpy arrays (``{"fc_in": {"w", "b"}, "hidden": ..., "fc_out":
    ...}``)."""
    w_in = np.asarray(tree["fc_in"]["w"])
    w_hid = np.asarray(tree["hidden"]["w"])
    w_out = np.asarray(tree["fc_out"]["w"])
    model = MLP(input_dim=w_in.shape[0], output_dim=w_out.shape[1],
                hidden_size=w_in.shape[1], num_layers=w_hid.shape[0],
                activation=activation)
    with torch.no_grad():
        for name, p in model.named_parameters():
            layer, leaf = name.split(".")
            p.copy_(torch.tensor(np.asarray(tree[layer][leaf], np.float32)))
    return model.to(device)


def params_to_jax(model: MLP) -> dict:
    """The reverse of :func:`params_from_jax`: a nested dict of numpy
    arrays in the JAX package's MLP layout."""
    tree = {}
    for name, p in model.named_parameters():
        layer, leaf = name.split(".")
        tree.setdefault(layer, {})[leaf] = p.detach().cpu().numpy()
    return tree
