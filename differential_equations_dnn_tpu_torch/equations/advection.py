"""1-D linear advection:  u_t + c·u_x = 0  on x ∈ [0, 2π], t ∈ [0, 1],
u(x, 0) = sin x,  inflow u(0, t) = sin(−c·t);  exact u = sin(x − c·t).

Two first-order taps (u_x, u_t) and no second derivatives. ``causal_eps >
0`` weights the interior residual at time t by exp(−ε·Δt·Σ_{t_j < t} r_j)
(Wang, Sankaran & Perdikaris 2022, as fitzhugh_nagumo does), with t drawn
one point per time stratum: at c ≳ 4π the plain loss settles on a damped
wrong branch, and the weighting marches the profile forward in time.
"""

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.equations.base import (
    Problem,
    TrainDefaults,
    causal_weights,
    grid_2d,
)
from differential_equations_dnn_tpu_torch.models import MLP
from differential_equations_dnn_tpu_torch.ops import (
    coordinate_taps,
    stride_strata,
)


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

    def sample(self, n, generator=None, device=None):
        if self.causal_eps <= 0.0:
            return super().sample(n, generator, device)
        # Stratified-uniform t in shuffled row order: the causal loss is
        # permutation-invariant (comparison-mask cumsum).
        x = self.x_max * torch.rand((n, 1), generator=generator)
        u = torch.rand((n, 1), generator=generator)
        t = (torch.arange(n, dtype=u.dtype)[:, None] + u) * (self.t_max / n)
        t = t[torch.randperm(n, generator=generator)]
        return self._batch(x.to(device), t.to(device))

    def batch_from_uniforms(self, u):
        """The batch as the fused spec builds it from ``[B, 2]`` draws:
        when causal, row i's t in stratum (i·m) mod B (ops.stride_strata),
        else t_max·u."""
        x = self.x_max * u[:, :1]
        if self.causal_eps > 0.0:
            B = u.shape[0]
            t = (stride_strata(B, u.device) + u[:, 1:2]) * (self.t_max / B)
        else:
            t = self.t_max * u[:, 1:2]
        return self._batch(x, t)

    @staticmethod
    def _batch(x, t):
        zeros = torch.zeros_like(x)
        return {
            "xt": torch.cat([x, t], 1),      # interior
            "x0": torch.cat([x, zeros], 1),  # t = 0 face
            "xb": torch.cat([zeros, t], 1),  # inflow x = 0
        }

    def _residuals(self, model, batch):
        """The interior, IC and inflow residuals, each [B, 1]."""
        _, (u_t, u_x), _ = coordinate_taps(model, batch["xt"], first=(1, 0))
        r = u_t + self.c * u_x
        r0 = model(batch["x0"]) - torch.sin(batch["x0"][:, :1])
        rb = model(batch["xb"]) - torch.sin(-self.c * batch["xb"][:, 1:2])
        return r, r0, rb

    def point_loss(self, model, batch):
        r, r0, rb = self._residuals(model, batch)
        return (torch.square(r) + torch.square(r0) + torch.square(rb))[:, 0]

    def loss(self, model, batch, mask=None):
        """Causal-weighted loss (``causal_eps > 0``): mean_i(w_i·r_i) +
        mean(IC + inflow), w_i = exp(−ε·Δt·Σ_{t_j < t_i} r_j) without
        gradient, Δt = t_max/B (``equations.base.causal_weights``; over
        the global batch on a sharded ``data`` axis). Under a row mask (a
        population trial) the plain masked loss, as in the JAX package
        (advection.py:94-101): causal weighting is a single-run
        protocol."""
        if self.causal_eps <= 0.0 or mask is not None:
            return super().loss(model, batch, mask)
        r, r0, rb = self._residuals(model, batch)
        res = torch.square(r)[:, 0]
        icbc = (torch.square(r0) + torch.square(rb))[:, 0]
        wgt = causal_weights(res, batch["xt"][:, 1], self.t_max,
                             self.causal_eps)
        return torch.mean(wgt * res) + torch.mean(icbc)

    def grid_inputs(self, nodes, device=None):
        return grid_2d(self.x_max, self.t_max, nodes, device)

    def solution_shape(self, nodes):
        return (nodes, nodes)

    def exact(self, nodes):
        t = np.linspace(0.0, self.t_max, nodes)
        x = np.linspace(0.0, self.x_max, nodes)
        return np.sin(x[None, :] - self.c * t[:, None])
