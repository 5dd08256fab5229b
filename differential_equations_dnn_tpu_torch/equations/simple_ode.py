"""First-order linear ODE:  dy/dt = −y,  y(0) = 2,  t ∈ [0, 1].

Reference: simple_ode.py — loss :41-63 (mean((dy/dt + y)² + (y0 − y_ic)²)),
sampling t ~ 1.01·U[0,1) :92, exact solution 2e^{−t} :35-38, defaults 5000
iters / batch 64 / lr 1e-4 / 25-node grid :136-138, MLP 1→32→1 :167.
"""

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
    time_ic_ansatz,
)
from differential_equations_dnn_tpu_torch.ops import value_dt


@dataclass(frozen=True)
class SimpleODE(Problem):
    name: str = "simple_ode"
    y_ic: float = 2.0
    t_max: float = 1.0
    sample_scale: float = 1.01  # reference samples t ~ 1.01·U[0,1)
    defaults: TrainDefaults = field(
        default_factory=lambda: TrainDefaults(iterations=5000, batch_size=64,
                                              nodes=25))
    # "soft" = the reference's weighted loss terms; "hard" = the Lagaris
    # trial function (models/hard.py), which satisfies IC and BC exactly.
    constraint: str = "soft"
    n_uniform = 1

    def hard_ansatz(self):
        return time_ic_ansatz(self.y_ic, self.t_max)

    def default_model(self, generator=None, device=None):
        net = MLP(input_dim=1, output_dim=1, hidden_size=32, num_layers=1,
                  activation="tanh", generator=generator, device=device)
        if self.constraint == "hard":
            return HardConstraint(net, self.hard_ansatz())
        return net

    def batch_from_uniforms(self, u):
        t = (self.sample_scale * self.t_max) * u[:, :1]
        return {"t": t, "t0": torch.zeros_like(t)}

    def point_loss(self, model, batch):
        y, dydt = value_dt(model, batch["t"], t_axis=0)
        y0 = model(batch["t0"])
        return (torch.square(dydt + y) + torch.square(y0 - self.y_ic))[:, 0]

    def grid_inputs(self, nodes, device=None):
        return torch.linspace(0.0, self.t_max, nodes, device=device)[:, None]

    def exact(self, nodes):
        t = np.linspace(0.0, self.t_max, nodes)
        return self.y_ic * np.exp(-t)
