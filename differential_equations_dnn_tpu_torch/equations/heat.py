"""1-D heat equation:  u_t = κ·u_xx  on (x, t) ∈ [0, π] × [0, 3],
u(x, 0) = sin x,  u(0, t) = u(π, t) = 0.

Reference: heat.py — loss :50-95 (domain residual + IC + two Dirichlet BC
terms, mean of the SUM of all four terms), sampling x~π·U, t~3·U :125-126,
exact sin(x)·e^{−κt} :36-47, defaults 15000 iters / batch 64 / lr 1e-4 /
40×40 grid :176-178, MLP 2→128×3→1 :181-184. Input layout is [x, t].
"""

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.equations.base import (
    Problem,
    TrainDefaults,
)
from differential_equations_dnn_tpu_torch.models import MLP
from differential_equations_dnn_tpu_torch.ops import (
    heat_fused_streams,
    value_dt,
    value_dx_dxx,
)


@dataclass(frozen=True)
class Heat1D(Problem):
    name: str = "heat"
    kappa: float = 1.0
    x_max: float = math.pi
    t_max: float = 3.0
    # Derivative taps: "jvp" (torch.func.jvp over any model) or "taylor"
    # (stacked Taylor streams, ops.taylor; plain MLPs).
    taps: str = "jvp"
    defaults: TrainDefaults = field(
        default_factory=lambda: TrainDefaults(iterations=15000, batch_size=64,
                                              nodes=40))
    constraint: str = "soft"

    def __post_init__(self):
        if self.constraint != "soft":
            raise NotImplementedError(
                f"constraint={self.constraint!r} is not ported yet "
                f"(ROADMAP.md queue 1, item 10: models/hard.py)")
        if self.taps == "pallas":
            raise NotImplementedError(
                "taps='pallas' is not ported yet (ROADMAP.md queue 2: "
                "kernel #3, taylor_mlp._heat_kernel)")
        if self.taps not in ("jvp", "taylor"):
            raise ValueError(f"unknown taps mode {self.taps!r}")

    def default_model(self, generator=None, device=None):
        return MLP(input_dim=2, output_dim=1, hidden_size=128, num_layers=3,
                   activation="tanh", generator=generator, device=device)

    def sample(self, n, generator=None, device=None):
        u = torch.rand((n, 2), generator=generator).to(device)
        return self.batch_from_uniforms(u)

    def batch_from_uniforms(self, u):
        """The collocation batch built from ``[B, 2]`` U[0,1) draws, as the
        fused kernels build it."""
        x = self.x_max * u[:, :1]
        t = self.t_max * u[:, 1:]
        zeros = torch.zeros_like(x)
        return {
            "xt": torch.cat([x, t], 1),                       # interior
            "x0": torch.cat([x, zeros], 1),                   # t = 0 (IC)
            "xb1": torch.cat([zeros, t], 1),                  # x = 0
            "xb2": torch.cat([torch.full_like(x, self.x_max), t], 1),
        }

    def point_loss(self, model, batch):
        if self.taps == "jvp":
            _, _, u_xx = value_dx_dxx(model, batch["xt"], x_axis=0)
            _, u_t = value_dt(model, batch["xt"], t_axis=1)
            u0 = model(batch["x0"])
            ub1 = model(batch["xb1"])
            ub2 = model(batch["xb2"])
        else:
            _, _, u_xx, u_t, u0, ub1, ub2 = heat_fused_streams(
                model, batch["xt"], batch["x0"], batch["xb1"], batch["xb2"])
        r_domain = u_t - self.kappa * u_xx
        r_init = u0 - torch.sin(batch["x0"][:, :1])
        return (r_domain ** 2 + r_init ** 2 + ub1 ** 2 + ub2 ** 2)[:, 0]

    def grid_inputs(self, nodes, device=None):
        # Grid rows = time, cols = space (heat.py:152-166: sol[i_t, j_x]).
        t = torch.linspace(0.0, self.t_max, nodes, device=device)
        x = torch.linspace(0.0, self.x_max, nodes, device=device)
        tt, xx = torch.meshgrid(t, x, indexing="ij")
        return torch.stack([xx.reshape(-1), tt.reshape(-1)], 1)

    def solution_shape(self, nodes):
        return (nodes, nodes)

    def exact(self, nodes):
        t = np.linspace(0.0, self.t_max, nodes)
        x = np.linspace(0.0, self.x_max, nodes)
        return np.sin(x)[None, :] * np.exp(-self.kappa * t)[:, None]
