"""2-D Poisson equation:  −Δu = f  on (x, y) ∈ [0, π]², u = 0 on the
boundary, f = 2·sin x·sin y;  exact u = sin x · sin y.

The Laplacian is two second-order taps on the interior batch; each of the
four boundary faces contributes one forward.
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
    poisson_ansatz,
)
from differential_equations_dnn_tpu_torch.ops import coordinate_taps

_FACES = ("b_x0", "b_x1", "b_y0", "b_y1")


@dataclass(frozen=True)
class Poisson2D(Problem):
    name: str = "poisson"
    x_max: float = math.pi
    defaults: TrainDefaults = field(
        default_factory=lambda: TrainDefaults(iterations=10000, batch_size=256,
                                              lrate=1e-3, nodes=40,
                                              schedule="cosine"))
    # "soft" = the reference's weighted loss terms; "hard" = the Lagaris
    # trial function (models/hard.py), which satisfies IC and BC exactly.
    constraint: str = "soft"
    n_uniform = 3

    def hard_ansatz(self):
        return poisson_ansatz(self.x_max)

    def default_model(self, generator=None, device=None):
        net = MLP(input_dim=2, output_dim=1, hidden_size=128, num_layers=3,
                  activation="tanh", generator=generator, device=device)
        if self.constraint == "hard":
            return HardConstraint(net, self.hard_ansatz())
        return net

    def source(self, xy):
        return 2.0 * torch.sin(xy[:, :1]) * torch.sin(xy[:, 1:2])

    def batch_from_uniforms(self, u):
        x, y, edge = (self.x_max * u[:, i:i + 1] for i in range(3))
        zeros = torch.zeros_like(x)
        xmax = torch.full_like(x, self.x_max)
        return {
            "xy": torch.cat([x, y], 1),                    # interior
            "b_x0": torch.cat([zeros, edge], 1),
            "b_x1": torch.cat([xmax, edge], 1),
            "b_y0": torch.cat([edge, zeros], 1),
            "b_y1": torch.cat([edge, xmax], 1),
        }

    def domain_inputs(self, batch):
        return batch["xy"]

    def point_loss(self, model, batch):
        _, _, (u_xx, u_yy) = coordinate_taps(model, batch["xy"],
                                             second=(0, 1))
        r_domain = -(u_xx + u_yy) - self.source(batch["xy"])
        r_b = sum(torch.square(model(batch[k])) for k in _FACES)
        return (torch.square(r_domain) + r_b)[:, 0]

    def grid_inputs(self, nodes, device=None):
        x = torch.linspace(0.0, self.x_max, nodes, device=device)
        xx, yy = torch.meshgrid(x, x, indexing="ij")
        return torch.stack([xx.reshape(-1), yy.reshape(-1)], 1)

    def solution_shape(self, nodes):
        return (nodes, nodes)

    def exact(self, nodes):
        x = np.linspace(0.0, self.x_max, nodes)
        return np.sin(x)[:, None] * np.sin(x)[None, :]
