"""Fredholm integral equation of the second kind:

    y(x) = sin(x) + ∫₀^{π/2} sin(x)·cos(t)·y(t) dt,   exact y = 2·sin(x).

Reference: fredholm.py — loss :47-74 (k = 50 quadrature draws), DGM
variant A with hidden 32 :173, exact 2·sin(t) :40-44. The integral is
taken with a k-node Gauss–Legendre rule in one batched forward over all
nodes; defaults are the JAX package's tuned ones (3000 iters / batch 32 /
lr 3e-3 cosine / 50-node grid). The Monte-Carlo and Halton rules are not
ported.
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
from differential_equations_dnn_tpu_torch.ops import gauss_legendre_nodes

QUADRATURE_TODO = ("quadrature={!r} is not ported yet (ROADMAP.md queue 1, "
                   "item 11: the DGM engine's Monte-Carlo and Halton "
                   "quadrature)")


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
        if self.quadrature in ("montecarlo", "halton"):
            raise NotImplementedError(QUADRATURE_TODO.format(self.quadrature))
        if self.quadrature != "gauss":
            raise ValueError(f"unknown quadrature {self.quadrature!r} "
                             f"(gauss | montecarlo | halton)")

    def default_model(self, generator=None, device=None):
        # DGM variant A, hidden 32, relu gates (fredholm.py:173).
        return DGM(input_dim=1, output_dim=1, hidden_size=32, num_layers=1,
                   activation="relu", init_scheme="xavier_relu",
                   generator=generator, device=device)

    def batch_from_uniforms(self, u):
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
