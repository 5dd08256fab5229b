"""The DGM (Deep Galerkin Method) gate network, as an ``nn.Module``.

Counterpart of the JAX package's models/dgm.py. Each layer computes

    Z, G, R = σ(s·Wzgr + x·Uzgr + bzgr)      (the three gates, fused)
    H       = σ((s ⊙ R)·Wh + x·Uh + bh)
    s'      = (1 − G) ⊙ H + Z ⊙ s

Parameters keep the JAX package's names and layout so that they load 1:1:
``s_in.{w [D,H], b [H]}``; ``layers.{Wzgr [L,H,3H], Uzgr [L,D,3H], bzgr
[L,3H], Wh [L,H,H], Uh [L,D,H], bh [L,H]}``; ``s_out.{w [H,O], b [O]}``.
``init_scheme`` selects the reference init: ``"torch"`` (nn.Linear
defaults; the reference's dgm_net.py) or ``"xavier_relu"`` (xavier with
relu gain on the gate matrices, zero gate biases; neural_networks.py). The
draws match the JAX package's in distribution, not in bits.
"""

import numpy as np
import torch
from torch import nn

from differential_equations_dnn_tpu_torch.core.activations import (
    get_activation,
)
from differential_equations_dnn_tpu_torch.core.init import (
    calculate_gain,
    torch_linear_default,
    xavier_uniform,
)
from differential_equations_dnn_tpu_torch.core.precision import dense
from differential_equations_dnn_tpu_torch.models.mlp import _Affine

INIT_SCHEMES = ("torch", "xavier_relu")
_GATES = ("Wzgr", "Uzgr", "bzgr", "Wh", "Uh", "bh")


def dgm_cell(x, s, layer, act):
    """One gate-layer update; ``layer`` maps the names of :data:`_GATES` to
    one layer's tensors."""
    H = s.shape[-1]
    zgr = act(dense(s, layer["Wzgr"]) + dense(x, layer["Uzgr"])
              + layer["bzgr"])
    z, g, r = zgr[..., :H], zgr[..., H:2 * H], zgr[..., 2 * H:]
    h = act(dense(s * r, layer["Wh"]) + dense(x, layer["Uh"]) + layer["bh"])
    return (1.0 - g) * h + z * s


class _Gates(nn.Module):
    """The stacked gate tensors of all layers."""

    def __init__(self, tensors):
        super().__init__()
        for name in _GATES:
            setattr(self, name, nn.Parameter(tensors[name]))


class DGM(nn.Module):
    def __init__(self, input_dim: int = 1, output_dim: int = 1,
                 hidden_size: int = 50, num_layers: int = 1,
                 activation: str = "tanh", init_scheme: str = "torch", *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        if init_scheme not in INIT_SCHEMES:
            raise ValueError(f"unknown init_scheme {init_scheme!r}")
        get_activation(activation)  # warns on an unknown name
        self.input_dim, self.output_dim = input_dim, output_dim
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.activation, self.init_scheme = activation, init_scheme

        D, H, L, O = input_dim, hidden_size, num_layers, output_dim
        g = generator
        xavier = init_scheme == "xavier_relu"

        def gate_weight(shape):
            if xavier:
                return xavier_uniform(shape, calculate_gain("relu"),
                                      generator=g, dtype=dtype)
            return torch_linear_default(shape, with_bias=False, generator=g,
                                        dtype=dtype)[0]

        def gate_bias():
            if xavier:
                return torch.zeros(H, dtype=dtype)
            return torch_linear_default((H, H), generator=g,
                                        dtype=dtype)[1]

        def layer():
            w = [gate_weight((H, H)) for _ in range(3)]
            u = [gate_weight((D, H)) for _ in range(3)]
            return {"Wzgr": torch.cat(w, 1), "Uzgr": torch.cat(u, 1),
                    "bzgr": torch.cat([gate_bias() for _ in range(3)]),
                    "Wh": gate_weight((H, H)), "Uh": gate_weight((D, H)),
                    "bh": gate_bias()}

        w_in, b_in = torch_linear_default((D, H), generator=g, dtype=dtype)
        layers = [layer() for _ in range(L)]
        w_out, b_out = torch_linear_default((H, O), generator=g, dtype=dtype)
        if xavier:  # xavier input/output weights, torch-default biases
            w_in = xavier_uniform((D, H), 1.0, generator=g, dtype=dtype)
            w_out = xavier_uniform((H, O), 1.0, generator=g, dtype=dtype)
        self.s_in = _Affine(w_in, b_in)
        self.layers = _Gates({name: torch.stack([t[name] for t in layers])
                              for name in _GATES})
        self.s_out = _Affine(w_out, b_out)
        self.to(device)

    def fresh(self, generator=None, device=None) -> "DGM":
        """A new DGM of this architecture, initialised from ``generator``
        (an ensemble's replica, as the JAX package's ``model.init(key)``)."""
        return DGM(self.input_dim, self.output_dim, self.hidden_size,
                   self.num_layers, self.activation, self.init_scheme,
                   generator=generator, device=device)

    def forward(self, x):
        act = get_activation(self.activation)
        s = act(dense(x, self.s_in.w, self.s_in.b))
        for l in range(self.num_layers):
            s = dgm_cell(x, s, {name: getattr(self.layers, name)[l]
                                for name in _GATES}, act)
        return dense(s, self.s_out.w, self.s_out.b)


def dgm_params_from_jax(tree, activation: str = "tanh",
                        init_scheme: str = "torch", device=None) -> DGM:
    """A DGM holding the JAX package's DGM parameters, given as a nested
    dict of numpy arrays (``{"s_in": {"w", "b"}, "layers": {...}, "s_out":
    {"w", "b"}}``)."""
    w_in = np.asarray(tree["s_in"]["w"])
    w_out = np.asarray(tree["s_out"]["w"])
    model = DGM(input_dim=w_in.shape[0], output_dim=w_out.shape[1],
                hidden_size=w_in.shape[1],
                num_layers=np.asarray(tree["layers"]["Wh"]).shape[0],
                activation=activation, init_scheme=init_scheme)
    with torch.no_grad():
        for name, p in model.named_parameters():
            module, leaf = name.split(".")
            p.copy_(torch.tensor(np.asarray(tree[module][leaf], np.float32)))
    return model.to(device)


def dgm_params_to_jax(model: DGM) -> dict:
    """The reverse of :func:`dgm_params_from_jax`: a nested dict of numpy
    arrays in the JAX package's DGM layout."""
    tree = {}
    for name, p in model.named_parameters():
        module, leaf = name.split(".")
        tree.setdefault(module, {})[leaf] = p.detach().cpu().numpy()
    return tree
