"""The fully connected ResNet, as an ``nn.Module``.

Counterpart of the JAX package's models/resnet.py (the reference's
``ResidualBlock`` → ``ResNetLayer`` → ``ResNet``, neural_networks.py:
273-364: two stages of ``n_blocks`` blocks, each block two bias-free
Linear layers with BatchNorm and relu and a residual, a final Linear
head). BatchNorm is sized by the feature dimension (the reference's
constant 100 is a shape bug) and keeps running statistics as the MLP's
does (models/stateful.py): buffers ``fc1.mean``/``fc1.var`` and
``fc2.mean``/``fc2.var`` per block, written by ``update_state`` alone.
A block whose width changes projects its residual by a bias-free
``down.w``. Parameters keep the JAX names (``stage1.0.fc1.w``, ...,
``fc_out.w``, ``fc_out.b``; weights ``[fan_in, fan_out]``) so that
:func:`resnet_params_from_jax` loads the JAX package's nested lists.
"""

import numpy as np
import torch
from torch import nn

from differential_equations_dnn_tpu_torch.core.init import (
    torch_linear_default,
)
from differential_equations_dnn_tpu_torch.core.precision import dense
from differential_equations_dnn_tpu_torch.models.mlp import (
    BN_EPS,
    BN_MOMENTUM,
)
from differential_equations_dnn_tpu_torch.models.stateful import (
    bn_eval,
    bn_train,
    bn_update,
)


class _BNLinear(nn.Module):
    """A bias-free Linear ``w`` followed by BatchNorm (γ, β, running
    statistics)."""

    def __init__(self, fan_in, fan_out, generator, dtype):
        super().__init__()
        self.w = nn.Parameter(torch_linear_default(
            (fan_in, fan_out), with_bias=False, generator=generator,
            dtype=dtype)[0])
        self.gamma = nn.Parameter(torch.ones((fan_out,), dtype=dtype))
        self.beta = nn.Parameter(torch.zeros((fan_out,), dtype=dtype))
        self.register_buffer("mean", torch.zeros((fan_out,), dtype=dtype))
        self.register_buffer("var", torch.ones((fan_out,), dtype=dtype))

    def forward(self, x, train, stats):
        z = x @ self.w
        if train:
            out, batch_stats = bn_train(z, self.gamma, self.beta, BN_EPS)
            stats.append((self, batch_stats, z.shape[0]))
            return out
        return bn_eval(z, self.gamma, self.beta, self.mean, self.var, BN_EPS)


class _Weight(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = nn.Parameter(w)


class ResidualBlock(nn.Module):
    def __init__(self, input_dim: int, output_dim: int,
                 downsample: bool = False, *, generator=None, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.input_dim, self.output_dim = input_dim, output_dim
        self.downsample = downsample
        g = generator
        self.fc1 = _BNLinear(input_dim, output_dim, g, dtype)
        self.fc2 = _BNLinear(output_dim, output_dim, g, dtype)
        if downsample:
            self.down = _Weight(torch_linear_default(
                (input_dim, output_dim), with_bias=False, generator=g,
                dtype=dtype)[0])
        self.to(device)

    stateful = True

    def forward(self, x):
        return self._forward(x, self.training, [])

    def running_stats(self, x) -> dict:
        return _running_stats(self, self._forward, x)

    def _forward(self, x, train, stats):
        out = torch.relu(self.fc1(x, train, stats))
        out = torch.relu(self.fc2(out, train, stats))
        residual = dense(x, self.down.w) if self.downsample else x
        return torch.relu(out + residual)


class ResNet(nn.Module):
    """Two stages of ``n_blocks`` residual blocks and a Linear head
    (reference defaults: hidden 32, 3 blocks per stage,
    neural_networks.py:340-357)."""

    def __init__(self, input_dim: int = 2, output_dim: int = 1,
                 hidden_size: int = 32, n_blocks: int = 3, *,
                 generator=None, device=None, dtype=torch.float32):
        super().__init__()
        self.input_dim, self.output_dim = input_dim, output_dim
        self.hidden_size, self.n_blocks = hidden_size, n_blocks
        g = generator

        def stage(in_dim):
            blocks = [ResidualBlock(in_dim, hidden_size,
                                    downsample=in_dim != hidden_size,
                                    generator=g, dtype=dtype)]
            blocks += [ResidualBlock(hidden_size, hidden_size, generator=g,
                                     dtype=dtype)
                       for _ in range(n_blocks - 1)]
            return nn.ModuleList(blocks)

        self.stage1 = stage(input_dim)
        self.stage2 = stage(hidden_size)
        w, b = torch_linear_default((hidden_size, output_dim), generator=g,
                                    dtype=dtype)
        self.fc_out = _Head(w, b)
        self.to(device)

    stateful = True

    def fresh(self, generator=None, device=None) -> "ResNet":
        return ResNet(self.input_dim, self.output_dim, self.hidden_size,
                      self.n_blocks, generator=generator, device=device)

    def forward(self, x):
        return self._forward(x, self.training, [])

    def running_stats(self, x) -> dict:
        return _running_stats(self, self._forward, x)

    def _forward(self, x, train, stats):
        out = x
        for block in (*self.stage1, *self.stage2):
            out = block._forward(out, train, stats)
        return dense(out, self.fc_out.w, self.fc_out.b)


class _Head(nn.Module):
    def __init__(self, w, b):
        super().__init__()
        self.w = nn.Parameter(w)
        self.b = nn.Parameter(b)


def _running_stats(model, forward, x) -> dict:
    """The running statistics one train-mode forward on ``x`` leaves, by
    buffer name."""
    stats = []
    forward(x, True, stats)
    names = {id(m): name for name, m in model.named_modules()}
    out = {}
    for layer, (mean, var), n in stats:
        prefix = names[id(layer)]
        out[f"{prefix}.mean"], out[f"{prefix}.var"] = bn_update(
            layer.mean, layer.var, mean, var, n, BN_MOMENTUM)
    return out


def resnet_params_from_jax(tree, state=None, device=None) -> ResNet:
    """A ResNet holding the JAX package's ResNet parameters (``{"stage1":
    [block, ...], "stage2": [...], "fc_out": {"w", "b"}}``, each block
    ``{"fc1": {"w", "gamma", "beta"}, "fc2": ..., "down": {"w"}}``) and,
    from ``state`` (the JAX model's state), its running statistics."""
    w_in = np.asarray(tree["stage1"][0]["fc1"]["w"])
    w_out = np.asarray(tree["fc_out"]["w"])
    model = ResNet(input_dim=w_in.shape[0], output_dim=w_out.shape[1],
                   hidden_size=w_in.shape[1],
                   n_blocks=len(tree["stage1"]))
    leaves = {**dict(model.named_parameters()), **dict(model.named_buffers())}
    with torch.no_grad():
        for name, p in leaves.items():
            src = tree
            is_state = name.endswith((".mean", ".var"))
            if is_state:
                if state is None:
                    continue
                src = state
            for part in name.split("."):
                src = src[int(part)] if part.isdigit() else src[part]
            p.copy_(torch.tensor(np.asarray(src, np.float32)))
    return model.to(device)


def resnet_params_to_jax(model: ResNet):
    """The reverse of :func:`resnet_params_from_jax`: (params, state) as
    the JAX package's nested lists and dicts of numpy arrays."""
    params = {"stage1": [{} for _ in model.stage1],
              "stage2": [{} for _ in model.stage2]}
    state = {"stage1": [{} for _ in model.stage1],
             "stage2": [{} for _ in model.stage2]}
    for tree, items in ((params, model.named_parameters()),
                        (state, model.named_buffers())):
        for name, p in items:
            parts = name.split(".")
            node = tree
            for part in parts[:-1]:
                node = (node[int(part)] if part.isdigit()
                        else node.setdefault(part, {}))
            node[parts[-1]] = p.detach().cpu().numpy()
    return params, state
