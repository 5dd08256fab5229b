"""Universal-approximation-theorem demo: fit f(x) = sin(3x) on [−1, 1].

Reference: demo_universal_approx_theorem.py — Perceptron 1→3→1 :26-37,
full-batch MSE on a fixed 50-point grid :50-73, 100k iters, lr 1e-4
:46-47. Counterpart of the JAX package's equations/uat.py. Not a
differential equation but a supervised fit on the same Problem and trainer
paths. The batch IS the grid: ``sample`` ignores its ``n`` and returns the
``n_points`` grid, built as the fused engine's spec builds it
(x_b = low + (high − low)·b/(B − 1) in fp32).
"""

from dataclasses import dataclass, field

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.equations.base import (
    Problem,
    TrainDefaults,
)
from differential_equations_dnn_tpu_torch.models import Perceptron


@dataclass(frozen=True)
class SineFit(Problem):
    name: str = "uat"
    freq: float = 3.0
    low: float = -1.0
    high: float = 1.0
    n_points: int = 50
    defaults: TrainDefaults = field(
        default_factory=lambda: TrainDefaults(iterations=100_000,
                                              batch_size=50, nodes=50))
    n_uniform = 1  # read for their shape only: the grid is fixed

    def default_model(self, generator=None, device=None):
        return Perceptron(input_dim=1, output_dim=1, hidden_size=3,
                          generator=generator, device=device)

    @property
    def max_sample_size(self):
        return self.n_points

    def sample(self, n, generator=None, device=None):
        # Full-batch training on the fixed grid (reference :50): n is
        # ignored by design.
        return self.batch_from_uniforms(torch.zeros((self.n_points, 1),
                                                    device=device))

    def batch_from_uniforms(self, u):
        """The grid of ``B = u.shape[0]`` points the fused spec builds; the
        draws' values are not read."""
        B = u.shape[0]
        i = torch.arange(B, dtype=torch.float32, device=u.device)[:, None]
        x = self.low + (self.high - self.low) * i / max(B - 1, 1)
        return {"x": x, "y": torch.sin(self.freq * x)}

    def point_loss(self, model, batch):
        return torch.square(model(batch["x"]) - batch["y"])[:, 0]

    def grid_inputs(self, nodes, device=None):
        return torch.linspace(self.low, self.high, nodes,
                              device=device)[:, None]

    def exact(self, nodes):
        return np.sin(self.freq * np.linspace(self.low, self.high, nodes))
