"""Problem protocol: what the trainers and ``solve`` consume.

A Problem bundles, for one differential equation:

* ``default_model()``      — the reference's network for this equation
* ``sample(n)``            — one batch of collocation points
* ``point_loss(model, batch)`` — per-point summed squared residuals
* ``grid_inputs(nodes)``   — flattened evaluation-grid inputs [M, d]
* ``solution_shape(nodes)``— shape the evaluated grid reshapes to
* ``exact(nodes)``         — the analytic ground truth (numpy, float64)
* ``defaults``             — reference iteration budget / batch size / lr

``evaluate`` runs the whole grid through the MLP-forward kernel
(kernels.taylor_mlp.mlp_forward) and ``mae`` is the reference's acceptance
metric (sklearn.mean_absolute_error, heat.py:232).
"""

from dataclasses import dataclass

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.train.metrics import (
    mean_absolute_error,
)


@dataclass(frozen=True)
class TrainDefaults:
    iterations: int
    batch_size: int
    lrate: float = 1e-4
    nodes: int = 40
    schedule: str = "constant"


@dataclass(frozen=True)
class Problem:
    name: str = "problem"

    def default_model(self, generator=None, device=None):
        raise NotImplementedError

    def sample(self, n, generator=None, device=None):
        raise NotImplementedError

    def point_loss(self, model, batch):
        """Per-collocation-point summed squared residuals, shape [B]."""
        raise NotImplementedError

    def loss(self, model, batch):
        """Scalar training loss: the mean of ``point_loss``."""
        return torch.mean(self.point_loss(model, batch))

    def grid_inputs(self, nodes, device=None):
        raise NotImplementedError

    def solution_shape(self, nodes):
        return (nodes,)

    def exact(self, nodes):
        raise NotImplementedError

    def evaluate(self, model, nodes):
        """The trained net on the problem's grid, as a numpy array of
        ``solution_shape(nodes)``: one kernel launch over the whole grid."""
        from differential_equations_dnn_tpu_torch.kernels.taylor_mlp import (
            mlp_forward,
        )

        device = model.fc_in.w.device
        with torch.no_grad():
            y = mlp_forward(model, self.grid_inputs(nodes, device=device))
        return y.cpu().numpy().reshape(self.solution_shape(nodes))

    def mae(self, model, nodes):
        """Mean absolute error against the ground truth."""
        return mean_absolute_error(self.exact(nodes),
                                   self.evaluate(model, nodes))
