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
    grid_2d,
)
from differential_equations_dnn_tpu_torch.kernels import taylor_mlp
from differential_equations_dnn_tpu_torch.models import (
    MLP,
    HardConstraint,
    heat1d_ansatz,
    is_stateful,
)
from differential_equations_dnn_tpu_torch.ops import (
    coordinate_taps,
    heat_fused_streams,
)


@dataclass(frozen=True)
class Heat1D(Problem):
    name: str = "heat"
    kappa: float = 1.0
    x_max: float = math.pi
    t_max: float = 3.0
    # Derivative taps: "jvp" (autodiff taps over any model, ops.diff), "taylor"
    # (stacked Taylor streams, ops.taylor; plain MLPs) or "pallas" (the
    # same streams from the heat-streams kernel, kernels.taylor_mlp; plain
    # MLPs). The port's point_loss takes the module itself, so the JAX
    # package's taps_model field has no counterpart.
    taps: str = "jvp"
    defaults: TrainDefaults = field(
        default_factory=lambda: TrainDefaults(iterations=15000, batch_size=64,
                                              nodes=40))
    # "soft" = the reference's weighted loss terms; "hard" = the Lagaris
    # trial function (models/hard.py), which satisfies IC and BC exactly
    # (jvp taps).
    constraint: str = "soft"

    def __post_init__(self):
        if self.taps not in ("jvp", "taylor", "pallas"):
            raise ValueError(f"unknown taps mode {self.taps!r}")

    def hard_ansatz(self):
        return heat1d_ansatz(self.x_max, self.t_max)

    def default_model(self, generator=None, device=None):
        net = MLP(input_dim=2, output_dim=1, hidden_size=128, num_layers=3,
                  activation="tanh", generator=generator, device=device)
        if self.constraint == "hard":
            if self.taps != "jvp":
                raise ValueError("constraint='hard' wraps the model, so the "
                                 "fused Taylor-stream taps cannot read its "
                                 "MLP structure — use Heat1D(taps='jvp')")
            return HardConstraint(net, self.hard_ansatz())
        return net

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
            _, (u_t,), (u_xx,) = coordinate_taps(model, batch["xt"],
                                                 first=(1,), second=(0,))
            sets = (batch["x0"], batch["xb1"], batch["xb2"])
            if is_stateful(model):
                # Batch statistics couple the rows: one forward per set,
                # as the JAX package (and the reference) call the net.
                u0, ub1, ub2 = (model(x) for x in sets)
            else:
                # The three sets in one forward (rows independent).
                u0, ub1, ub2 = model(torch.cat(sets)).chunk(3)
        else:
            streams = (taylor_mlp.heat_fused_streams if self.taps == "pallas"
                       else heat_fused_streams)
            _, _, u_xx, u_t, u0, ub1, ub2 = streams(
                model, batch["xt"], batch["x0"], batch["xb1"], batch["xb2"])
        r_domain = u_t - self.kappa * u_xx
        r_init = u0 - torch.sin(batch["x0"][:, :1])
        return (r_domain ** 2 + r_init ** 2 + ub1 ** 2 + ub2 ** 2)[:, 0]

    def grid_inputs(self, nodes, device=None):
        # Grid rows = time, cols = space (heat.py:152-166: sol[i_t, j_x]).
        return grid_2d(self.x_max, self.t_max, nodes, device)

    def solution_shape(self, nodes):
        return (nodes, nodes)

    def exact(self, nodes):
        t = np.linspace(0.0, self.t_max, nodes)
        x = np.linspace(0.0, self.x_max, nodes)
        return np.sin(x)[None, :] * np.exp(-self.kappa * t)[:, None]
