"""2-D heat equation:  u_t = κ·(u_xx + u_yy)  on (x, y) ∈ [0, π]²,
t ∈ [0, 1], u(x, y, 0) = sin x · sin y, u = 0 on the boundary;
exact u = sin x · sin y · e^{−2κt}.

``taps="jvp"`` takes the Laplacian as two second-order jvp taps;
``taps="taylor"`` evaluates value + (x, xx) + (y, yy) + t + the five
constraint forwards as 11 stacked streams (ops.taylor.mlp_streams), one
matmul per layer.
"""

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.equations.base import (
    Problem,
    TrainDefaults,
)
from differential_equations_dnn_tpu_torch.models import (
    MLP,
    HardConstraint,
    heat2d_ansatz,
)
from differential_equations_dnn_tpu_torch.ops import (
    coordinate_taps,
    mlp_streams,
)

_FACES = ("b_x0", "b_x1", "b_y0", "b_y1")


@dataclass(frozen=True)
class Heat2D(Problem):
    name: str = "heat2d"
    kappa: float = 1.0
    x_max: float = math.pi
    t_max: float = 1.0
    taps: str = "jvp"  # "jvp" (any model) or "taylor" (plain MLPs)
    defaults: TrainDefaults = field(
        default_factory=lambda: TrainDefaults(iterations=20000, batch_size=256,
                                              lrate=1e-3, nodes=24,
                                              schedule="cosine"))
    constraint: str = "soft"  # "hard" = Lagaris trial function (jvp taps)
    n_uniform = 4

    def __post_init__(self):
        if self.taps not in ("jvp", "taylor"):
            raise ValueError(f"unknown taps mode {self.taps!r}")

    def hard_ansatz(self):
        return heat2d_ansatz(self.x_max, self.t_max)

    def default_model(self, generator=None, device=None):
        net = MLP(input_dim=3, output_dim=1, hidden_size=128, num_layers=3,
                  activation="tanh", generator=generator, device=device)
        if self.constraint == "hard":
            if self.taps != "jvp":
                raise ValueError("constraint='hard' wraps the model — use "
                                 "Heat2D(taps='jvp')")
            return HardConstraint(net, self.hard_ansatz())
        return net

    def batch_from_uniforms(self, u):
        x = self.x_max * u[:, :1]
        y = self.x_max * u[:, 1:2]
        t = self.t_max * u[:, 2:3]
        edge = self.x_max * u[:, 3:4]  # one point per boundary face
        zeros = torch.zeros_like(x)
        xmax = torch.full_like(x, self.x_max)
        return {
            "xt": torch.cat([x, y, t], 1),
            "x0": torch.cat([x, y, zeros], 1),
            "b_x0": torch.cat([zeros, edge, t], 1),
            "b_x1": torch.cat([xmax, edge, t], 1),
            "b_y0": torch.cat([edge, zeros, t], 1),
            "b_y1": torch.cat([edge, xmax, t], 1),
        }

    def point_loss(self, model, batch):
        if self.taps == "taylor":
            _, (u_xx, u_yy), _, (u_t,), (u0, *faces) = mlp_streams(
                model, batch["xt"],
                second_dirs=([1.0, 0.0, 0.0], [0.0, 1.0, 0.0]),
                first_dirs=([0.0, 0.0, 1.0],),
                constraints=tuple(batch[k] for k in ("x0",) + _FACES))
        else:
            _, (u_t,), (u_xx, u_yy) = coordinate_taps(
                model, batch["xt"], first=(2,), second=(0, 1))
            u0 = model(batch["x0"])
            faces = [model(batch[k]) for k in _FACES]
        r_init = u0 - (torch.sin(batch["x0"][:, :1])
                       * torch.sin(batch["x0"][:, 1:2]))
        r_domain = u_t - self.kappa * (u_xx + u_yy)
        return (torch.square(r_domain) + torch.square(r_init)
                + sum(torch.square(b) for b in faces))[:, 0]

    def grid_inputs(self, nodes, device=None):
        t = torch.linspace(0.0, self.t_max, nodes, device=device)
        x = torch.linspace(0.0, self.x_max, nodes, device=device)
        tt, xx, yy = torch.meshgrid(t, x, x, indexing="ij")
        return torch.stack([xx.reshape(-1), yy.reshape(-1), tt.reshape(-1)],
                           1)

    def solution_shape(self, nodes):
        return (nodes, nodes, nodes)

    def exact(self, nodes):
        t = np.linspace(0.0, self.t_max, nodes)
        x = np.linspace(0.0, self.x_max, nodes)
        field_xy = np.sin(x)[:, None] * np.sin(x)[None, :]
        return field_xy[None] * np.exp(-2.0 * self.kappa * t)[:, None, None]
