"""Inverse problem: identify the heat equation's diffusivity κ from data.

Counterpart of the JAX package's equations/inverse_heat.py. Given noisy
observations of u on a sparse space-time set, learn BOTH the solution
network AND the unknown coefficient κ by minimising

    L = mean (u_t − κ̂·u_xx)²  +  λ·mean (u_θ(x_i) − u_obs_i)²

with κ̂ = exp(log κ̂) a trainable scalar of the model (:class:`_InverseModel`
holds the MLP and ``log_kappa``), so every trainer takes it as one more
parameter. Ground truth: the analytic solution sin(x)·e^{−κ*t}.

The observations are a fixed synthetic dataset drawn from ``obs_seed``. The
JAX package draws them with its own generator, whose stream the port does
not reproduce; ``obs_data`` hands the problem a dataset given as numpy
arrays instead (the tests pass the JAX package's). A step's observation
rows are picked by ``floor(u·n_obs)`` of a uniform draw, as the fused
engine's spec picks them, which matches the JAX scan path's integer draw in
distribution.
"""

import math
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from differential_equations_dnn_tpu_torch.equations.base import (
    Problem,
    TrainDefaults,
    grid_2d,
)
from differential_equations_dnn_tpu_torch.models import (
    MLP,
    params_from_jax,
    params_to_jax,
)
from differential_equations_dnn_tpu_torch.ops import value_dt, value_dx_dxx


class _InverseModel(nn.Module):
    """The solution MLP ``net`` and the trainable ``log_kappa`` (a 0-d
    parameter) in one module; the forward is the net's."""

    def __init__(self, net: MLP, kappa_init: float = 0.5):
        super().__init__()
        self.net = net
        self.kappa_init = kappa_init
        device = next(net.parameters()).device
        self.log_kappa = nn.Parameter(torch.tensor(
            math.log(kappa_init), dtype=torch.float32, device=device))

    def fresh(self, generator=None, device=None) -> "_InverseModel":
        """A new model of this architecture: the net initialised from
        ``generator``, κ̂ at ``kappa_init``."""
        return _InverseModel(self.net.fresh(generator, device),
                             self.kappa_init)

    def kappa(self):
        return torch.exp(self.log_kappa)

    def forward(self, x):
        return self.net(x)


def inverse_params_from_jax(tree, device=None) -> _InverseModel:
    """An ``_InverseModel`` holding the JAX package's parameters, given as
    ``{"net": <MLP tree>, "log_kappa": scalar}`` of numpy arrays."""
    model = _InverseModel(params_from_jax(tree["net"], "tanh"))
    with torch.no_grad():
        model.log_kappa.copy_(torch.tensor(
            np.asarray(tree["log_kappa"], np.float32)))
    return model.to(device)


def inverse_params_to_jax(model: _InverseModel) -> dict:
    """The reverse of :func:`inverse_params_from_jax`."""
    return {"net": params_to_jax(model.net),
            "log_kappa": model.log_kappa.detach().cpu().numpy()}


@dataclass(frozen=True)
class InverseHeat1D(Problem):
    name: str = "inverse_heat"
    kappa_true: float = 1.0
    kappa_init: float = 0.5
    x_max: float = math.pi
    t_max: float = 3.0
    n_obs: int = 200          # observation points
    noise: float = 0.01       # observation noise std
    data_weight: float = 10.0
    obs_seed: int = 0         # observations are a fixed synthetic dataset
    defaults: TrainDefaults = field(
        default_factory=lambda: TrainDefaults(iterations=15000,
                                              batch_size=128, lrate=1e-3,
                                              nodes=40))
    # A dataset given as numpy arrays, (xt [n_obs, 2], u [n_obs, 1]), in
    # place of the one drawn from obs_seed.
    obs_data: tuple | None = field(default=None, compare=False, repr=False)
    n_uniform = 3  # x, t, the observation row

    def __post_init__(self):
        if self.obs_data is not None:
            xt, u = (np.asarray(a) for a in self.obs_data)
            if xt.shape != (self.n_obs, 2) or u.shape != (self.n_obs, 1):
                raise ValueError(
                    f"obs_data must be arrays of shapes ({self.n_obs}, 2) "
                    f"and ({self.n_obs}, 1) (got {xt.shape}, {u.shape})")

    def default_model(self, generator=None, device=None):
        return _InverseModel(
            MLP(input_dim=2, output_dim=1, hidden_size=128, num_layers=3,
                activation="tanh", generator=generator, device=device),
            kappa_init=self.kappa_init)

    def observations(self, device=None):
        """The dataset: (xt [n_obs, 2], u [n_obs, 1]) float32 tensors."""
        if self.obs_data is not None:
            xt, u = (torch.tensor(np.asarray(a, np.float32))
                     for a in self.obs_data)
        else:
            g = torch.Generator().manual_seed(int(self.obs_seed))
            x = self.x_max * torch.rand((self.n_obs, 1), generator=g)
            t = self.t_max * torch.rand((self.n_obs, 1), generator=g)
            u = torch.sin(x) * torch.exp(-self.kappa_true * t)
            u = u + self.noise * torch.randn(u.shape, generator=g)
            xt = torch.cat([x, t], 1)
        return xt.to(device), u.to(device)

    def batch_from_uniforms(self, u):
        """The batch built from ``[B, 3]`` draws, as the fused spec builds
        it: (x, t) from the first two, the observation row floor(u·n_obs)
        from the third."""
        x = self.x_max * u[:, :1]
        t = self.t_max * u[:, 1:2]
        obs = torch.cat(self.observations(u.device), 1)
        obs_xt, obs_u = pick_rows(obs, u[:, 2:3]).split([2, 1], 1)
        return {"xt": torch.cat([x, t], 1), "obs_x": obs_xt, "obs_u": obs_u}

    def point_loss(self, model, batch):
        """Per-point residual and weighted data misfit; κ̂ is the model's
        own parameter, so their batch mean is the full inverse loss."""
        _, _, u_xx = value_dx_dxx(model, batch["xt"], x_axis=0)
        _, u_t = value_dt(model, batch["xt"], t_axis=1)
        r = torch.square(u_t - model.kappa() * u_xx)[:, 0]
        d = torch.square(model(batch["obs_x"]) - batch["obs_u"])[:, 0]
        return r + self.data_weight * d

    def grid_inputs(self, nodes, device=None):
        return grid_2d(self.x_max, self.t_max, nodes, device)

    def solution_shape(self, nodes):
        return (nodes, nodes)

    def exact(self, nodes):
        t = np.linspace(0.0, self.t_max, nodes)
        x = np.linspace(0.0, self.x_max, nodes)
        return np.sin(x)[None, :] * np.exp(-self.kappa_true * t)[:, None]

    def kappa_error(self, model) -> float:
        """|κ̂ − κ*|, the inverse problem's acceptance metric."""
        return float(abs(float(model.kappa().detach()) - self.kappa_true))


def pick_rows(table, u):
    """Row floor(u·n) of ``table [n, c]`` for each ``u [B, 1]`` draw,
    computed in fp32 as the JAX package's one-hot selection computes it
    (a row past the table, which fp32 rounding of u·n can give, is
    zeros)."""
    n = table.shape[0]
    sel = torch.floor(u[:, 0] * n)
    idx = sel.clamp(max=n - 1).long()
    return table[idx] * (sel < n).to(table.dtype)[:, None]
