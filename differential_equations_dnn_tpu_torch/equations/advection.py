"""1-D linear advection:  u_t + c·u_x = 0  on x ∈ [0, 2π], t ∈ [0, 1],
u(x, 0) = sin x,  inflow u(0, t) = sin(−c·t);  exact u = sin(x − c·t).

Two first-order taps (u_x, u_t) and no second derivatives. Causal residual
weighting (``causal_eps > 0``) is not ported (ROADMAP.md queue 1, item
10e): the default ``causal_eps = 0`` is the reference configuration.
"""

import math
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

CAUSAL_TODO = ("advection with causal_eps > 0 is not ported yet (ROADMAP.md "
               "queue 1, item 10e: causal advection's [B, B] weighting)")


@dataclass(frozen=True)
class Advection1D(Problem):
    name: str = "advection"
    c: float = 2.0 * math.pi  # one full transit over t_max
    x_max: float = 2.0 * math.pi
    t_max: float = 1.0
    causal_eps: float = 0.0   # causal residual weighting (0 = off)
    defaults: TrainDefaults = field(
        default_factory=lambda: TrainDefaults(iterations=15000,
                                              batch_size=128, lrate=1e-3,
                                              nodes=40, schedule="cosine"))

    def default_model(self, generator=None, device=None):
        return MLP(input_dim=2, output_dim=1, hidden_size=128, num_layers=3,
                   activation="tanh", generator=generator, device=device)

    def batch_from_uniforms(self, u):
        if self.causal_eps > 0.0:
            raise NotImplementedError(CAUSAL_TODO)
        x = self.x_max * u[:, :1]
        t = self.t_max * u[:, 1:2]
        zeros = torch.zeros_like(x)
        return {
            "xt": torch.cat([x, t], 1),      # interior
            "x0": torch.cat([x, zeros], 1),  # t = 0 face
            "xb": torch.cat([zeros, t], 1),  # inflow x = 0
        }

    def point_loss(self, model, batch):
        _, (u_t, u_x), _ = coordinate_taps(model, batch["xt"], first=(1, 0))
        r = u_t + self.c * u_x
        r0 = model(batch["x0"]) - torch.sin(batch["x0"][:, :1])
        rb = model(batch["xb"]) - torch.sin(-self.c * batch["xb"][:, 1:2])
        return (torch.square(r) + torch.square(r0) + torch.square(rb))[:, 0]

    def grid_inputs(self, nodes, device=None):
        return grid_2d(self.x_max, self.t_max, nodes, device)

    def solution_shape(self, nodes):
        return (nodes, nodes)

    def exact(self, nodes):
        t = np.linspace(0.0, self.t_max, nodes)
        x = np.linspace(0.0, self.x_max, nodes)
        return np.sin(x[None, :] - self.c * t[:, None])
