"""Fredholm integral equation of the second kind:

    y(x) = sin(x) + ∫₀^{π/2} sin(x)·cos(t)·y(t) dt,   exact y = 2·sin(x).

Reference: fredholm.py — loss :47-74 (k = 50 quadrature draws), DGM
variant A with hidden 32 :173, exact 2·sin(t) :40-44. The integral is
taken in one batched forward over all nodes: with a k-node Gauss–Legendre
rule (the default), fresh uniform Monte-Carlo nodes per collocation point
and step (``quadrature="montecarlo"``, the reference-parity mode, matching
its ``rand_like`` draws, fredholm.py:66) or a Halton window drawn per step
(``"halton"``). Defaults are the JAX package's tuned ones (3000 iters /
batch 32 / lr 3e-3 cosine / 50-node grid). The stochastic modes train on
the scan engine only, as in the JAX package.
"""

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.equations.base import (
    Problem,
    TrainDefaults,
)
from differential_equations_dnn_tpu_torch.models import DGM
from differential_equations_dnn_tpu_torch.ops import (
    gauss_legendre_nodes,
    halton_nodes,
    montecarlo_nodes,
)

QUADRATURES = ("gauss", "montecarlo", "halton")


@dataclass(frozen=True)
class Fredholm2(Problem):
    name: str = "fredholm"
    upper: float = math.pi / 2.0
    k: int = 50                      # quadrature nodes
    quadrature: str = "gauss"        # "gauss" | "montecarlo" | "halton"
    defaults: TrainDefaults = field(
        default_factory=lambda: TrainDefaults(iterations=3000, batch_size=32,
                                              lrate=3e-3, nodes=50,
                                              schedule="cosine"))
    n_uniform = 1

    def __post_init__(self):
        if self.quadrature not in QUADRATURES:
            raise ValueError(f"unknown quadrature {self.quadrature!r} "
                             f"({' | '.join(QUADRATURES)})")

    def default_model(self, generator=None, device=None):
        # DGM variant A, hidden 32, relu gates (fredholm.py:173).
        return DGM(input_dim=1, output_dim=1, hidden_size=32, num_layers=1,
                   activation="relu", init_scheme="xavier_relu",
                   generator=generator, device=device)

    def sample(self, n, generator=None, device=None):
        """One collocation batch; the stochastic rules draw their nodes from
        ``generator`` after the points: Monte-Carlo nodes per point, or
        one Halton window whose offset is a draw in [0, 2^20)."""
        if self.quadrature == "gauss":
            return super().sample(n, generator, device)
        x = self.upper * torch.rand((n, 1), generator=generator)
        if self.quadrature == "halton":
            offset = torch.randint(0, 1 << 20, (), generator=generator)
            nodes, weights = halton_nodes(self.k, 0.0, self.upper,
                                          offset=offset)
            tq = nodes[None, :].expand(n, self.k)
        else:
            tq, weights = montecarlo_nodes(generator, self.k, 0.0,
                                           self.upper, (n,))
        batch = {"x": x, "tq": tq, "wq": weights[None, :].expand(n, self.k)}
        return {key: v.to(device) for key, v in batch.items()}

    def batch_from_uniforms(self, u):
        """The Gauss-rule batch as the fused DGM spec builds it from ``[B,
        1]`` draws."""
        x = self.upper * u[:, :1]
        n = x.shape[0]
        nodes, weights = gauss_legendre_nodes(self.k, 0.0, self.upper,
                                              device=u.device)
        return {"x": x, "tq": nodes[None, :].expand(n, self.k),
                "wq": weights[None, :].expand(n, self.k)}

    def point_loss(self, model, batch):
        x, tq, wq = batch["x"], batch["tq"], batch["wq"]
        n, k = tq.shape
        # One forward over all collocation and quadrature points.
        y_nodes = model(tq.reshape(n * k, 1)).reshape(n, k)
        integral = torch.sum(torch.cos(tq) * y_nodes * wq, 1, keepdim=True)
        integral = torch.sin(x) * integral
        yhat = model(x)
        return torch.square(yhat - torch.sin(x) - integral)[:, 0]

    def grid_inputs(self, nodes, device=None):
        return torch.linspace(0.0, self.upper, nodes, device=device)[:, None]

    def exact(self, nodes):
        t = np.linspace(0.0, self.upper, nodes)
        return 2.0 * np.sin(t)
