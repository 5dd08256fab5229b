"""Viscous Burgers equation:  u_t + u·u_x = ν·u_xx  on x ∈ [0, 1],
t ∈ [0, 1], with the exact travelling wave

    u*(x, t) = c − a·tanh( a·(x − c·t − x₀) / (2ν) ),

whose initial and Dirichlet boundary values are taken from u* itself. The
advection term u·u_x couples the value and first-derivative streams.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.equations.base import (
    Problem,
    TrainDefaults,
    grid_2d,
)
from differential_equations_dnn_tpu_torch.models import MLP
from differential_equations_dnn_tpu_torch.ops import coordinate_taps


@dataclass(frozen=True)
class Burgers(Problem):
    name: str = "burgers"
    nu: float = 0.05         # viscosity
    wave_amp: float = 0.4    # a
    wave_speed: float = 0.6  # c
    x0: float = 0.3          # initial front position
    x_max: float = 1.0
    t_max: float = 1.0
    defaults: TrainDefaults = field(
        default_factory=lambda: TrainDefaults(iterations=15000, batch_size=128,
                                              lrate=1e-3, nodes=40))

    def default_model(self, generator=None, device=None):
        return MLP(input_dim=2, output_dim=1, hidden_size=128, num_layers=3,
                   activation="tanh", generator=generator, device=device)

    def _exact_fn(self, x, t):
        a, c, nu = self.wave_amp, self.wave_speed, self.nu
        return c - a * torch.tanh(a * (x - c * t - self.x0) / (2.0 * nu))

    def batch_from_uniforms(self, u):
        x = self.x_max * u[:, :1]
        t = self.t_max * u[:, 1:2]
        zeros = torch.zeros_like(x)
        return {
            "xt": torch.cat([x, t], 1),
            "x0t": torch.cat([x, zeros], 1),                  # IC points
            "b0": torch.cat([zeros, t], 1),                   # x = 0
            "b1": torch.cat([torch.full_like(x, self.x_max), t], 1),
        }

    def point_loss(self, model, batch):
        u, (u_x, u_t), (u_xx,) = coordinate_taps(model, batch["xt"],
                                                 first=(0, 1), second=(0,))
        r_domain = u_t + u * u_x - self.nu * u_xx
        res = [model(batch[k]) - self._exact_fn(batch[k][:, :1],
                                                batch[k][:, 1:])
               for k in ("x0t", "b0", "b1")]
        return (torch.square(r_domain)
                + sum(torch.square(r) for r in res))[:, 0]

    def grid_inputs(self, nodes, device=None):
        return grid_2d(self.x_max, self.t_max, nodes, device)

    def solution_shape(self, nodes):
        return (nodes, nodes)

    def exact(self, nodes):
        t = np.linspace(0.0, self.t_max, nodes)
        x = np.linspace(0.0, self.x_max, nodes)
        xx, tt = np.meshgrid(x, t)  # rows = time (matches grid_inputs)
        a, c, nu = self.wave_amp, self.wave_speed, self.nu
        return c - a * np.tanh(a * (xx - c * tt - self.x0) / (2.0 * nu))
