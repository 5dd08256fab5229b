"""The feed-forward MLP, as an ``nn.Module``: plain, with BatchNorm before
or after each activation, and with random Fourier features.

Parameters keep the JAX package's names and layout (models/mlp.py:103-140)
so that they load 1:1: ``fc_in.w [D,H]``, ``fc_in.b [H]``, ``hidden.w
[L,H,H]``, ``hidden.b [L,H]``, ``fc_out.w [H,O]``, ``fc_out.b [O]``, with
``y = x @ w + b``. Init matches the JAX package's draws in distribution
(xavier with activation gain for tanh/sigmoid, gain 1 on the output layer;
kaiming for relu/leaky_relu; ``nn.Linear``-default biases), not in bits.

``batch_norm="pre" | "post"`` (the reference's ``MLP(batch_norm=True)``
and ``MLPBNPre``, ``MLPBNPost``): the Linear layers lose their biases but
``fc_out``'s, and each of the L + 1 layers has its own (γ, β) (``bn.gamma``,
``bn.beta`` [L+1, H]) and running statistics (buffers ``bn.mean``,
``bn.var``; momentum 0.1, eps 1e-5, the running variance from the
unbiased estimate), as the JAX package keeps them (the reference reuses
one BatchNorm1d over every layer). The model is stateful
(models/stateful.py): a train-mode forward normalises by the batch and
writes no buffer; ``running_stats`` gives the statistics one train-mode
forward would leave.

``fourier_features = F > 0`` maps x to [sin 2πxB, cos 2πxB], 2F columns,
with B [D, F] ~ N(0, fourier_scale²) frozen: the buffer ``fourier.b``.
"""

import math

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
from differential_equations_dnn_tpu_torch.models.stateful import (
    bn_eval,
    bn_train,
    bn_update,
)

BN_EPS = 1e-5
BN_MOMENTUM = 0.1


class _Affine(nn.Module):
    """``w`` and ``b`` of one layer, or of a stack of layers (``b`` may be
    absent)."""

    def __init__(self, w, b=None):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b) if b is not None else None


class _BatchNorm(nn.Module):
    """(γ, β) and the running statistics of the L + 1 layers, [L+1, H]."""

    def __init__(self, n, H, dtype):
        super().__init__()
        self.gamma = nn.Parameter(torch.ones((n, H), dtype=dtype))
        self.beta = nn.Parameter(torch.zeros((n, H), dtype=dtype))
        self.register_buffer("mean", torch.zeros((n, H), dtype=dtype))
        self.register_buffer("var", torch.ones((n, H), dtype=dtype))


class _Fourier(nn.Module):
    def __init__(self, b):
        super().__init__()
        self.register_buffer("b", b)


class MLP(nn.Module):
    def __init__(self, input_dim: int = 2, output_dim: int = 1,
                 hidden_size: int = 50, num_layers: int = 1,
                 activation: str = "relu", batch_norm: str | None = None,
                 fourier_features: int = 0, fourier_scale: float = 1.0, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        if batch_norm not in (None, "pre", "post"):
            raise ValueError(f"batch_norm must be None|'pre'|'post', got "
                             f"{batch_norm!r}")
        get_activation(activation)  # warns on an unknown name
        self.input_dim, self.output_dim = input_dim, output_dim
        self.hidden_size, self.num_layers = hidden_size, num_layers
        self.activation = activation if activation in ACTIVATIONS else "relu"
        self.batch_norm = batch_norm
        self.fourier_features = int(fourier_features)
        self.fourier_scale = float(fourier_scale)

        D, H, L, O = input_dim, hidden_size, num_layers, output_dim
        E = 2 * self.fourier_features if self.fourier_features else D
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

        # Draw order as in the JAX init: weights, then biases (fc_out's
        # alone with BatchNorm), then the Fourier matrix.
        w_in = weight((E, H))
        w_hid = torch.stack([weight((H, H)) for _ in range(L)]) if L else \
            torch.zeros((0, H, H), dtype=dtype)
        w_out = weight((H, O), is_output=True)
        if batch_norm is None:
            b_in = bias(E, H)
            b_hid = torch.stack([bias(H, H) for _ in range(L)]) if L else \
                torch.zeros((0, H), dtype=dtype)
        else:
            b_in = b_hid = None
        b_out = bias(H, O)
        self.fc_in = _Affine(w_in, b_in)
        self.hidden = _Affine(w_hid, b_hid)
        self.fc_out = _Affine(w_out, b_out)
        if batch_norm is not None:
            self.bn = _BatchNorm(L + 1, H, dtype)
        if self.fourier_features:
            b = torch.randn((D, self.fourier_features), generator=g,
                            dtype=dtype)
            self.fourier = _Fourier(self.fourier_scale * b)
        self.to(device)

    @property
    def stateful(self) -> bool:
        return self.batch_norm is not None

    @property
    def plain(self) -> bool:
        """No BatchNorm and no Fourier features: the layout the fused
        kernels (#1, #2, #3 and the MLP engine) take."""
        return self.batch_norm is None and not self.fourier_features

    def fresh(self, generator=None, device=None) -> "MLP":
        """A new MLP of this architecture, initialised from ``generator``
        (an ensemble's replica, as the JAX package's ``model.init(key)``)."""
        return MLP(self.input_dim, self.output_dim, self.hidden_size,
                   self.num_layers, self.activation, self.batch_norm,
                   self.fourier_features, self.fourier_scale,
                   generator=generator, device=device)

    def forward(self, x):
        return self._forward(x, self.training)[0]

    def running_stats(self, x) -> dict:
        """The running statistics one train-mode forward on ``x`` leaves,
        by buffer name (no buffer is written)."""
        _, stats = self._forward(x, True)
        means, vars_ = zip(*stats)
        mean, var = bn_update(self.bn.mean, self.bn.var,
                              torch.stack(means), torch.stack(vars_),
                              x.shape[0], BN_MOMENTUM)
        return {"bn.mean": mean, "bn.var": var}

    def _forward(self, x, train):
        act = get_activation(self.activation)
        if self.fourier_features:
            proj = (2.0 * math.pi) * (x @ self.fourier.b.detach())
            x = torch.cat([torch.sin(proj), torch.cos(proj)], -1)
        if self.batch_norm is None:
            h = act(dense(x, self.fc_in.w, self.fc_in.b))
            for l in range(self.num_layers):
                h = act(dense(h, self.hidden.w[l], self.hidden.b[l]))
            return dense(h, self.fc_out.w, self.fc_out.b), []

        bn, stats = self.bn, []

        def norm(z, i):
            if train:
                out, batch_stats = bn_train(z, bn.gamma[i], bn.beta[i],
                                            BN_EPS)
                stats.append(batch_stats)
                return out
            return bn_eval(z, bn.gamma[i], bn.beta[i], bn.mean[i],
                           bn.var[i], BN_EPS)

        def layer(h, w, i):
            if self.batch_norm == "pre":
                return act(norm(h @ w, i))
            return norm(act(h @ w), i)

        h = layer(x, self.fc_in.w, 0)
        for l in range(self.num_layers):
            h = layer(h, self.hidden.w[l], l + 1)
        return dense(h, self.fc_out.w, self.fc_out.b), stats


def params_from_jax(tree, activation: str = "tanh", device=None,
                    batch_norm: str | None = None, state=None) -> MLP:
    """An MLP holding the JAX package's MLP parameters, given as a nested
    dict of numpy arrays (``{"fc_in": {"w", "b"}, "hidden": ..., "fc_out":
    ..., "bn": {"gamma", "beta"}, "fourier": {"b"}}``). A BatchNorm tree
    needs ``batch_norm`` ("pre" or "post": the tree cannot tell) and takes
    its running statistics from ``state`` (``{"mean", "var"}``, the JAX
    model's state), or keeps the init's."""
    if "bn" in tree and batch_norm is None:
        raise ValueError("a BatchNorm tree needs batch_norm='pre' or "
                         "'post'")
    w_in = np.asarray(tree["fc_in"]["w"])
    w_hid = np.asarray(tree["hidden"]["w"])
    w_out = np.asarray(tree["fc_out"]["w"])
    fourier = tree.get("fourier")
    b = None if fourier is None else np.asarray(fourier["b"])
    model = MLP(input_dim=w_in.shape[0] if b is None else b.shape[0],
                output_dim=w_out.shape[1], hidden_size=w_in.shape[1],
                num_layers=w_hid.shape[0], activation=activation,
                batch_norm=batch_norm if "bn" in tree else None,
                fourier_features=0 if b is None else b.shape[1])
    leaves = {**dict(model.named_parameters()),
              **({"fourier.b": model.fourier.b} if b is not None else {})}
    with torch.no_grad():
        for name, p in leaves.items():
            layer, leaf = name.split(".")
            p.copy_(torch.tensor(np.asarray(tree[layer][leaf], np.float32)))
        if state is not None and model.stateful:
            model.bn.mean.copy_(torch.tensor(np.asarray(state["mean"],
                                                        np.float32)))
            model.bn.var.copy_(torch.tensor(np.asarray(state["var"],
                                                       np.float32)))
    return model.to(device)


def params_to_jax(model: MLP) -> dict:
    """The reverse of :func:`params_from_jax`: a nested dict of numpy
    arrays in the JAX package's MLP layout (the running statistics are
    :func:`state_to_jax`'s)."""
    tree = {}
    leaves = list(model.named_parameters())
    if getattr(model, "fourier_features", 0):
        leaves.append(("fourier.b", model.fourier.b))
    for name, p in leaves:
        layer, leaf = name.split(".")
        tree.setdefault(layer, {})[leaf] = p.detach().cpu().numpy()
    return tree


def state_to_jax(model: MLP):
    """A BatchNorm MLP's running statistics as the JAX model's state
    (``{"mean", "var"}`` [L+1, H]); None for a stateless MLP."""
    if not model.stateful:
        return None
    return {"mean": model.bn.mean.cpu().numpy(),
            "var": model.bn.var.cpu().numpy()}
