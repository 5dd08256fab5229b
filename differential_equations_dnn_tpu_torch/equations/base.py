"""Problem protocol: what the trainers and ``solve`` consume.

A Problem bundles, for one differential equation:

* ``default_model()``      — the reference's network for this equation
* ``sample(n)``            — one batch of collocation points, built by
                             ``batch_from_uniforms`` from U[0,1) draws
* ``point_loss(model, batch)`` — per-point summed squared residuals
* ``loss(model, batch, mask)`` — their (masked) mean, the training loss
* ``domain_inputs(batch)`` — the interior points, on which a stateful
                             model's running statistics are refreshed
* ``grid_inputs(nodes)``   — flattened evaluation-grid inputs [M, d]
* ``solution_shape(nodes)``— shape the evaluated grid reshapes to
* ``exact(nodes)``         — the analytic ground truth (numpy, float64)
* ``defaults``             — reference iteration budget / batch size / lr

``evaluate`` runs the whole grid through the MLP-forward kernel
(kernels.taylor_mlp.mlp_forward) for a plain MLP, or through the model's
own forward (a DGM, a Fourier-feature MLP; a stateful model in eval mode),
then a hard-constraint model's ansatz; ``mae`` is the reference's acceptance
metric (sklearn.mean_absolute_error, heat.py:232).
"""

from dataclasses import dataclass

import torch

from differential_equations_dnn_tpu_torch.core.rows import all_rows
from differential_equations_dnn_tpu_torch.train.metrics import (
    mean_absolute_error,
)


def causal_weights(res, t, t_max, eps):
    """The causal weights w_i = exp(−ε·Δt·Σ_{t_j < t_i} ℓ_j) of the rows'
    residual energies ``res`` [B] at times ``t`` [B], without gradient,
    Δt = t_max / B (Wang, Sankaran & Perdikaris 2022). On a sharded
    ``data`` axis (core/rows.py) the sum runs over every rank's rows and B
    is the global batch's count: ``[B_local, B_global]`` comparisons for
    this rank's rows."""
    res_all, t_all = all_rows(res.detach()), all_rows(t)
    earlier = (t_all[None, :] < t[:, None]).to(res.dtype)   # [B, B]
    cum = (earlier @ res_all) * (t_max / res_all.shape[0])
    return torch.exp(-eps * cum).detach()


def grid_2d(x_max, t_max, nodes, device=None):
    """The [nodes², 2] grid of (x, t) rows, time-major (rows = time, cols =
    space), as the JAX package's PDE problems evaluate it."""
    t = torch.linspace(0.0, t_max, nodes, device=device)
    x = torch.linspace(0.0, x_max, nodes, device=device)
    tt, xx = torch.meshgrid(t, x, indexing="ij")
    return torch.stack([xx.reshape(-1), tt.reshape(-1)], 1)


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
    n_uniform = 2  # U[0,1) draws per collocation point

    def default_model(self, generator=None, device=None):
        raise NotImplementedError

    def sample(self, n, generator=None, device=None):
        """One collocation batch: ``n_uniform`` U[0,1) draws per point."""
        u = torch.rand((n, self.n_uniform), generator=generator)
        return self.batch_from_uniforms(u.to(device))

    def validation_sample(self, n, generator=None, device=None):
        """A collocation batch for validation (replica selection, the
        L-BFGS polish). Defaults to :meth:`sample`; a problem that trains
        on a fixed grid overrides it with dense off-grid points, since a
        net can zero its residual on the grid and oscillate between grid
        points (JAX base.py:52-58)."""
        return self.sample(n, generator, device)

    @property
    def max_sample_size(self):
        """The largest per-step collocation batch ``sample`` can produce, or
        None if unbounded (JAX base.py:60-66). Fixed-grid problems
        (FitzHugh–Nagumo's grid, the UAT demo's) override it; the sweeps
        clamp their batch-size space to it."""
        return None

    def batch_from_uniforms(self, u):
        """The collocation batch built from ``[B, n_uniform]`` draws, as
        the fused engine's spec builds it."""
        raise NotImplementedError

    def domain_inputs(self, batch):
        """The interior collocation inputs of a training batch [B, d] (JAX
        base.py:68-79): where the trainers refresh a stateful model's
        running statistics. The samplers name them "xt" (PDEs), "t" (ODEs)
        or "x" (function fits); other layouts override this."""
        for name in ("xt", "t", "x"):
            if name in batch:
                return batch[name]
        return next(iter(batch.values()))

    def point_loss(self, model, batch):
        """Per-collocation-point summed squared residuals, shape [B]."""
        raise NotImplementedError

    def loss(self, model, batch, mask=None):
        """Scalar training loss: the mean of ``point_loss``, or under a
        row ``mask`` [B] (a population trial's batch size within its
        drawn rows) Σ r·mask / Σ mask (JAX base.py:91-97)."""
        r = self.point_loss(model, batch)
        if mask is None:
            return torch.mean(r)
        mask = mask.to(r.dtype)
        return torch.sum(r * mask) / torch.sum(mask)

    def grid_inputs(self, nodes, device=None):
        raise NotImplementedError

    def solution_shape(self, nodes):
        return (nodes,)

    def exact(self, nodes):
        raise NotImplementedError

    def evaluate(self, model, nodes):
        """The trained net on the problem's grid, as a numpy array of
        ``solution_shape(nodes)``. A plain MLP (the Perceptron and the
        inverse model's net too) runs as one launch of kernel #2 over the
        whole grid; any other net through its own forward (the JAX
        package's ``model.apply``, outside any kernel): a DGM, a
        Fourier-feature MLP, and a stateful model (a BatchNorm MLP, a
        ResNet) in eval mode, on its running statistics. A HardConstraint
        runs its raw net so, then its ansatz as plain tensor ops."""
        from differential_equations_dnn_tpu_torch.kernels.taylor_mlp import (
            mlp_forward,
        )
        from differential_equations_dnn_tpu_torch.models import (
            DGM,
            HardConstraint,
            eval_mode,
            is_stateful,
        )

        device = next(model.parameters()).device
        with torch.no_grad():
            x = self.grid_inputs(nodes, device=device)
            net = model.net if isinstance(model, HardConstraint) else model
            if not (isinstance(net, DGM) or is_stateful(net)
                    or not getattr(net, "plain", True)):
                y = mlp_forward(net, x)
            else:
                with eval_mode(net):
                    y = net(x)
            if net is not model:
                y = model.ansatz(x, y)
        return y.cpu().numpy().reshape(self.solution_shape(nodes))

    def mae(self, model, nodes):
        """Mean absolute error against the ground truth."""
        return mean_absolute_error(self.exact(nodes),
                                   self.evaluate(model, nodes))
