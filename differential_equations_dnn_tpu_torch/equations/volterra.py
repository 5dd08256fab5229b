"""Volterra integral equation of the second kind:

    y(x) = x + ∫₀ˣ (t − x)·y(t) dt   on x ∈ [0, π],   exact y = sin(x)

(the integral form of y'' + y = 0, y(0) = 0, y'(0) = 1). Counterpart of
the JAX package's equations/volterra.py. The upper limit is the collocation
point itself, so the nodes move with x: the k-node Gauss–Legendre rule on
(−1, 1) maps to t = x·(u + 1)/2 with weights x·w/2 (``quadrature="gauss"``),
or t = x·U fresh per point and step with weights x/k
(``"montecarlo"``, scan engine only). Every node and collocation point goes
through one batched forward.
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
    gauss_legendre_nodes,
    montecarlo_nodes,
)

QUADRATURES = ("gauss", "montecarlo")


@dataclass(frozen=True)
class Volterra2(Problem):
    name: str = "volterra"
    upper: float = math.pi
    k: int = 50                      # quadrature nodes per collocation point
    quadrature: str = "gauss"        # "gauss" | "montecarlo"
    defaults: TrainDefaults = field(
        default_factory=lambda: TrainDefaults(iterations=3000, batch_size=64,
                                              lrate=1e-3, nodes=50,
                                              schedule="cosine"))
    n_uniform = 1

    def __post_init__(self):
        if self.quadrature not in QUADRATURES:
            raise ValueError(f"unknown quadrature {self.quadrature!r} "
                             f"({' | '.join(QUADRATURES)})")

    def default_model(self, generator=None, device=None):
        return MLP(input_dim=1, output_dim=1, hidden_size=64, num_layers=2,
                   activation="tanh", generator=generator, device=device)

    def sample(self, n, generator=None, device=None):
        """One collocation batch; the Monte-Carlo rule draws its [n, k]
        node fractions from ``generator`` after the points."""
        if self.quadrature == "gauss":
            return super().sample(n, generator, device)
        x = self.upper * torch.rand((n, 1), generator=generator)
        frac, _ = montecarlo_nodes(generator, self.k, batch_shape=(n,))
        batch = {"x": x, "tq": x * frac,
                 "wq": (x / self.k).expand(n, self.k)}
        return {key: v.to(device) for key, v in batch.items()}

    def batch_from_uniforms(self, u):
        """The Gauss-rule batch as the fused engine's spec builds it from
        ``[B, 1]`` draws."""
        x = self.upper * u[:, :1]
        nodes, weights = gauss_legendre_nodes(self.k, -1.0, 1.0,
                                              device=u.device)
        tq = x * (nodes[None, :] + 1.0) * 0.5        # [n, k], t ∈ (0, x)
        wq = x * weights[None, :] * 0.5              # dt = (x/2)·du
        return {"x": x, "tq": tq, "wq": wq}

    def point_loss(self, model, batch):
        x, tq, wq = batch["x"], batch["tq"], batch["wq"]
        n, k = tq.shape
        # One forward over all collocation and quadrature points.
        y_nodes = model(tq.reshape(n * k, 1)).reshape(n, k)
        integral = torch.sum((tq - x) * y_nodes * wq, 1, keepdim=True)
        yhat = model(x)
        return torch.square(yhat - x - integral)[:, 0]

    def grid_inputs(self, nodes, device=None):
        return torch.linspace(0.0, self.upper, nodes, device=device)[:, None]

    def exact(self, nodes):
        return np.sin(np.linspace(0.0, self.upper, nodes))
