"""Hard-constraint trial functions (Lagaris et al. 1998), as an ``nn.Module``.

Counterpart of the JAX package's models/hard.py. ``u(x) = A(x) + D(x)·N(x)``
where ``A`` satisfies the problem's IC/BC and ``D`` vanishes on the
constraint set, so the constraints hold exactly (to fp precision) for every
parameter value and only the domain residual drives training.

``HardConstraint(net, ansatz)`` wraps any model: ``forward(x) = ansatz(x,
net(x))``. It trains on the scan trainer with any derivative taps that
differentiate the module (``taps="jvp"`` for heat and heat2d), and, for the
five builders below at a problem's own constants, on the generic fused
engine, whose hard specs train the raw ``net`` and compose the analytic
ansatz derivatives in their losses (kernels.fused_engine.HARD_SPECS). Each
builder returns an :class:`Ansatz` whose ``tag`` (builder name, numeric
arguments) lets the fused engine refuse any other ansatz.
"""

import math
import warnings
from dataclasses import dataclass
from typing import Callable

import torch
from torch import nn

from differential_equations_dnn_tpu_torch.models.dgm import (
    DGM,
    dgm_params_from_jax,
    dgm_params_to_jax,
)
from differential_equations_dnn_tpu_torch.models.mlp import (
    params_from_jax,
    params_to_jax,
)


def _check_sin_lift(x_max: float, who: str):
    """The sin(x)-based lifts satisfy the homogeneous Dirichlet condition at
    ``x = x_max`` only when ``sin(x_max) = 0`` (x_max a multiple of π, as in
    every reference domain). D still vanishes there, so the net cannot
    correct a nonzero sin(x_max): warn rather than silently violate the
    advertised exact BC."""
    if abs(math.sin(x_max)) > 1e-9:
        warnings.warn(
            f"{who}: the sin(x) lift is exact only for x_max a multiple of "
            f"π (got x_max={x_max!r}, sin(x_max)={math.sin(x_max):.3g}); the "
            f"boundary condition u(x_max, ·)=0 will be violated by exactly "
            f"that amount", stacklevel=3)


@dataclass(frozen=True)
class Ansatz:
    """A trial function ``fn(x [n, D], y_raw [n, O]) -> y [n, O]`` and its
    identity ``tag``: (builder name, numeric arguments)."""
    tag: tuple
    fn: Callable

    def __call__(self, x, y_raw):
        return self.fn(x, y_raw)


class HardConstraint(nn.Module):
    """``forward(x) = ansatz(x, net(x))``; a 1-D ``x`` is one point."""

    def __init__(self, net: nn.Module, ansatz: Ansatz):
        super().__init__()
        self.net = net
        self.ansatz = ansatz

    # The wrapped net's structure, which the fused engine's hard specs read
    # (they train the raw net).
    @property
    def input_dim(self):
        return self.net.input_dim

    @property
    def output_dim(self):
        return self.net.output_dim

    @property
    def hidden_size(self):
        return self.net.hidden_size

    @property
    def num_layers(self):
        return self.net.num_layers

    @property
    def activation(self):
        return self.net.activation

    def fresh(self, generator=None, device=None) -> "HardConstraint":
        """The same ansatz around a new net of this architecture."""
        return HardConstraint(self.net.fresh(generator, device), self.ansatz)

    def forward(self, x):
        squeeze = x.ndim == 1
        if squeeze:
            x = x[None, :]
        y = self.ansatz(x, self.net(x))
        return y[0] if squeeze else y


def hard_params_from_jax(tree, ansatz: Ansatz, activation: str = "tanh",
                         device=None) -> HardConstraint:
    """A HardConstraint holding the JAX package's wrapper parameters: the
    raw net's tree (the JAX ``HardConstraint.init`` is ``net.init``), an
    MLP's or a DGM's, as a nested dict of numpy arrays."""
    net = (dgm_params_from_jax(tree, activation) if "s_in" in tree
           else params_from_jax(tree, activation))
    return HardConstraint(net, ansatz).to(device)


def hard_params_to_jax(model: HardConstraint) -> dict:
    """The reverse of :func:`hard_params_from_jax`: the raw net's tree."""
    if isinstance(model.net, DGM):
        return dgm_params_to_jax(model.net)
    return params_to_jax(model.net)


def time_ic_ansatz(y_ic: float, t_scale: float = 1.0) -> Ansatz:
    """1-D time problems with ``y(0) = y_ic``: y = y_ic + (t/t_scale)·N(t)
    (normalised by the domain length so the trial function's output scale
    matches the bare net's)."""
    def ansatz(x, y_raw):
        return y_ic + (x[:, :1] / t_scale) * y_raw

    return Ansatz(("time_ic", y_ic, t_scale), ansatz)


def heat1d_ansatz(x_max: float, t_max: float = 1.0) -> Ansatz:
    """u(x,0)=sin x, u(0,t)=u(x_max,t)=0: u = sin(x) + D·N with D =
    t·x·(x_max−x) normalised to ≤ 1 (the raw factor peaks at about
    t_max·x_max²/4, which would rescale the net's output and detune the
    reference lr)."""
    _check_sin_lift(x_max, "heat1d_ansatz")
    scale = t_max * (x_max / 2.0) ** 2

    def ansatz(xt, y_raw):
        x, t = xt[:, :1], xt[:, 1:2]
        return torch.sin(x) + (t * x * (x_max - x) / scale) * y_raw

    return Ansatz(("heat1d", x_max, t_max), ansatz)


def wave1d_ansatz(x_max: float, t_max: float = 1.0) -> Ansatz:
    """u(x,0)=sin x, u_t(x,0)=0, u(0,t)=u(x_max,t)=0: u = sin(x) + D·N with
    D = t²·x·(x_max−x) normalised to ≤ 1; the t² factor holds both the
    position and the velocity initial condition."""
    _check_sin_lift(x_max, "wave1d_ansatz")
    scale = t_max ** 2 * (x_max / 2.0) ** 2

    def ansatz(xt, y_raw):
        x, t = xt[:, :1], xt[:, 1:2]
        return torch.sin(x) + (t * t * x * (x_max - x) / scale) * y_raw

    return Ansatz(("wave1d", x_max, t_max), ansatz)


def poisson_ansatz(x_max: float) -> Ansatz:
    """u = 0 on ∂[0,x_max]²: u = D·N with D = x(x_max−x)y(x_max−y)
    normalised to ≤ 1."""
    scale = (x_max / 2.0) ** 4

    def ansatz(xy, y_raw):
        x, y = xy[:, :1], xy[:, 1:2]
        return (x * (x_max - x) * y * (x_max - y) / scale) * y_raw

    return Ansatz(("poisson", x_max), ansatz)


def heat2d_ansatz(x_max: float, t_max: float = 1.0) -> Ansatz:
    """u(x,y,0)=sin x·sin y, u=0 on the spatial boundary: u = sin(x)sin(y)
    + D·N with D = t·x(x_max−x)y(x_max−y) normalised to ≤ 1."""
    _check_sin_lift(x_max, "heat2d_ansatz")
    scale = t_max * (x_max / 2.0) ** 4

    def ansatz(xyt, y_raw):
        x, y, t = xyt[:, :1], xyt[:, 1:2], xyt[:, 2:3]
        return (torch.sin(x) * torch.sin(y)
                + (t * x * (x_max - x) * y * (x_max - y) / scale) * y_raw)

    return Ansatz(("heat2d", x_max, t_max), ansatz)
