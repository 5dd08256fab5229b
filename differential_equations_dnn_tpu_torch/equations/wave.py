"""1-D wave equation:  u_tt = c²·u_xx  on x ∈ [0, π], t ∈ [0, 2],
u(x, 0) = sin x,  u_t(x, 0) = 0,  u(0, t) = u(π, t) = 0;
exact u = sin x · cos(c t).

u_xx and u_tt are second-order taps on the interior batch; the velocity IC
is a first-order time tap on the t=0 face.
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
from differential_equations_dnn_tpu_torch.models import (
    MLP,
    HardConstraint,
    wave1d_ansatz,
)
from differential_equations_dnn_tpu_torch.ops import coordinate_taps, value_dt


@dataclass(frozen=True)
class Wave1D(Problem):
    name: str = "wave"
    c: float = 1.0
    x_max: float = math.pi
    t_max: float = 2.0
    velocity_weight: float = 1.0  # weight of the u_t(x,0)=0 term
    defaults: TrainDefaults = field(
        default_factory=lambda: TrainDefaults(iterations=15000, batch_size=128,
                                              lrate=1e-3, nodes=40,
                                              schedule="cosine"))
    # "soft" = the reference's weighted loss terms; "hard" = the Lagaris
    # trial function (models/hard.py), which satisfies IC and BC exactly.
    constraint: str = "soft"

    def hard_ansatz(self):
        return wave1d_ansatz(self.x_max, self.t_max)

    def default_model(self, generator=None, device=None):
        net = MLP(input_dim=2, output_dim=1, hidden_size=128, num_layers=3,
                  activation="tanh", generator=generator, device=device)
        if self.constraint == "hard":
            return HardConstraint(net, self.hard_ansatz())
        return net

    def batch_from_uniforms(self, u):
        x = self.x_max * u[:, :1]
        t = self.t_max * u[:, 1:2]
        zeros = torch.zeros_like(x)
        return {
            "xt": torch.cat([x, t], 1),        # interior
            "x0": torch.cat([x, zeros], 1),    # t = 0 face
            "xb1": torch.cat([zeros, t], 1),   # x = 0 boundary
            "xb2": torch.cat([torch.full_like(x, self.x_max), t], 1),
        }

    def point_loss(self, model, batch):
        _, _, (u_xx, u_tt) = coordinate_taps(model, batch["xt"],
                                             second=(0, 1))
        r_domain = u_tt - (self.c ** 2) * u_xx
        u0, u0_t = value_dt(model, batch["x0"], t_axis=1)
        r_pos = u0 - torch.sin(batch["x0"][:, :1])
        return (torch.square(r_domain) + torch.square(r_pos)
                + self.velocity_weight * torch.square(u0_t)
                + torch.square(model(batch["xb1"]))
                + torch.square(model(batch["xb2"])))[:, 0]

    def grid_inputs(self, nodes, device=None):
        return grid_2d(self.x_max, self.t_max, nodes, device)

    def solution_shape(self, nodes):
        return (nodes, nodes)

    def exact(self, nodes):
        t = np.linspace(0.0, self.t_max, nodes)
        x = np.linspace(0.0, self.x_max, nodes)
        return np.sin(x)[None, :] * np.cos(self.c * t)[:, None]
