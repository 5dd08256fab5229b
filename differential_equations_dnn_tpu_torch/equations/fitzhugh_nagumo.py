"""FitzHugh–Nagumo system on t ∈ [0, 30]:

    dy/dt = y − y³/3 − w + I_ext
    dw/dt = (y + α − β·w) / τ          I_ext=0.5, α=0.7, β=0.8, τ=2.5

Reference: fitzhugh_nagumo.py — loss :53-97 (two residual means plus the IC
mean, summed), 200-point grid subsampled without replacement :124-131,
scipy odeint ground truth :231, defaults 150 000 iters / batch 100 / lr
1e-4 / 50-node grid, DGM 1→2 hidden 128 × 4 layers :211-214, y(0) = w(0) =
0. Training is causal by default (``causal_eps = 5``, Wang, Sankaran &
Perdikaris 2022): the residual at t_i is weighted by exp(−ε·Δt·Σ_{j<i} ℓ_j).

``constraint="hard"`` wraps the DGM in the trial function y = y_ic +
(t/t_max)·N(t) (models/hard.py), which holds the IC exactly; it trains on
the scan trainer, as in the JAX package. ``arch="fourier_mlp"`` (the JAX
package's recommended arch, beyond the reference) is a Fourier-feature MLP
1 → 128×3 → 2, tanh, 16 features at σ = 0.1, and trains on the scan
trainer only.
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.equations.base import (
    Problem,
    TrainDefaults,
    causal_weights,
)
from differential_equations_dnn_tpu_torch.models import (
    DGM,
    MLP,
    HardConstraint,
    time_ic_ansatz,
)
from differential_equations_dnn_tpu_torch.ops import GridSubsample, value_dt


def fzn_rhs(s, _t, i_ext=0.5, alpha=0.7, beta=0.8, tau=2.5):
    """The classical right-hand side, for the odeint ground truth."""
    y, w = s
    return np.array([y - y**3 / 3.0 - w + i_ext, (y + alpha - beta * w) / tau])


@dataclass(frozen=True)
class FitzHughNagumo(Problem):
    name: str = "fitzhugh_nagumo"
    i_ext: float = 0.5
    alpha: float = 0.7
    beta: float = 0.8
    tau: float = 2.5
    t_max: float = 30.0
    grid_points: int = 200
    y_ic: float = 0.0
    arch: str = "dgm"
    defaults: TrainDefaults = field(
        default_factory=lambda: TrainDefaults(iterations=150_000,
                                              batch_size=100, nodes=50))
    constraint: str = "soft"
    causal_eps: float = 5.0  # causal residual weighting (0 = off)
    n_uniform = 1

    def __post_init__(self):
        if self.arch not in ("dgm", "fourier_mlp"):
            raise ValueError(f"unknown arch {self.arch!r} (dgm | fourier_mlp)")

    def hard_ansatz(self):
        return time_ic_ansatz(self.y_ic, self.t_max)

    def default_model(self, generator=None, device=None):
        if self.arch == "fourier_mlp":
            net = MLP(input_dim=1, output_dim=2, hidden_size=128,
                      num_layers=3, activation="tanh", fourier_features=16,
                      fourier_scale=0.1, generator=generator, device=device)
        else:
            net = DGM(input_dim=1, output_dim=2, hidden_size=128,
                      num_layers=4, activation="tanh", init_scheme="torch",
                      generator=generator, device=device)
        if self.constraint == "hard":
            return HardConstraint(net, self.hard_ansatz())
        return net

    @property
    def max_sample_size(self):
        # Subsampling without replacement caps the reference's batch size.
        return self.grid_points

    def sample(self, n, generator=None, device=None):
        if self.causal_eps > 0.0:
            # Stratified-uniform in shuffled row order: the causal loss is
            # permutation-invariant (comparison-mask cumsum).
            u = torch.rand((n, 1), generator=generator)
            t = (torch.arange(n, dtype=u.dtype)[:, None] + u) * (self.t_max
                                                                 / n)
            t = t[torch.randperm(n, generator=generator)].to(device)
            return {"t": t, "t0": torch.zeros_like(t)}
        t = GridSubsample(0.0, self.t_max, self.grid_points).sample(
            n, generator, device)
        return {"t": t, "t0": torch.zeros_like(t)}

    def batch_from_uniforms(self, u):
        """The collocation batch as the fused DGM spec builds it from ``[B,
        1]`` draws: stratified and time-sorted when causal, else t_max·u."""
        if self.causal_eps > 0.0:
            B = u.shape[0]
            i = torch.arange(B, dtype=u.dtype, device=u.device)[:, None]
            t = (i + u[:, :1]) * (self.t_max / B)
        else:
            t = self.t_max * u[:, :1]
        return {"t": t, "t0": torch.zeros_like(t)}

    def validation_sample(self, n, generator=None, device=None):
        # Dense off-grid points (a grid-trained net can oscillate between
        # its training points).
        t = self.t_max * torch.rand((n, 1), generator=generator)
        t = t.to(device)
        return {"t": t, "t0": torch.zeros_like(t)}

    def _residuals(self, model, batch):
        """Per-point residual energy ℓ_i = r_y² + r_w² [B] and IC energy
        [B]."""
        s, dsdt = value_dt(model, batch["t"], t_axis=0)
        y, w = s[:, :1], s[:, 1:]
        dy, dw = dsdt[:, :1], dsdt[:, 1:]
        r_y = dy + (y**3 / 3.0 + w - self.i_ext - y)
        r_w = dw + (self.beta * w - self.alpha - y) / self.tau
        s0 = model(batch["t0"])
        ic = torch.mean(torch.square(s0 - self.y_ic), 1)
        return torch.square(r_y)[:, 0] + torch.square(r_w)[:, 0], ic

    def point_loss(self, model, batch):
        res, ic = self._residuals(model, batch)
        return res + ic

    def loss(self, model, batch, mask=None):
        """Causal-weighted residual loss (``causal_eps > 0``): mean_i(w_i·ℓ_i)
        + mse(IC), w_i = exp(−ε·Δt·Σ_{t_j < t_i} ℓ_j) without gradient
        (``equations.base.causal_weights``; over the global batch on a
        sharded ``data`` axis). Under a row mask (a population trial) the
        plain masked loss, as in the JAX package
        (fitzhugh_nagumo.py:151-161)."""
        if self.causal_eps <= 0.0 or mask is not None:
            return super().loss(model, batch, mask)
        res, ic = self._residuals(model, batch)
        wgt = causal_weights(res, batch["t"][:, 0], self.t_max,
                             self.causal_eps)
        return torch.mean(wgt * res) + torch.mean(ic)

    def grid_inputs(self, nodes, device=None):
        return torch.linspace(0.0, self.t_max, nodes, device=device)[:, None]

    def solution_shape(self, nodes):
        return (nodes, 2)

    def exact(self, nodes):
        from scipy.integrate import odeint  # only the ground truth needs it

        t = np.linspace(0.0, self.t_max, nodes)
        args = (self.i_ext, self.alpha, self.beta, self.tau)
        return odeint(fzn_rhs, [self.y_ic, self.y_ic], t, args=args)
