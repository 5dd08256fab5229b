"""The physics losses of the benchmark's equations, written plainly with
autograd derivatives, and the Adam steps that follow a program's first
training steps.

Heat (the reference's heat.py:50-95): u_t = κ·u_xx on [0, π] × [0, 3],
u(x, 0) = sin x, u(0, t) = u(π, t) = 0; a point's loss is the sum of the
squared residual, initial and two boundary terms, and the loss is the
mean over the batch (over its first ``bs`` rows when a trial is masked).

FitzHugh–Nagumo (fitzhugh_nagumo.py:53-97, without causal weighting):
dy/dt = y − y³/3 − w + I, dw/dt = (y + α − β·w)/τ on [0, 30], y(0) =
w(0) = 0; a point's loss is r_y² + r_w² + the mean over both components
of the squared initial values.
"""

import math

import torch

from reference import nets

B1, B2, EPS = 0.9, 0.999, 1e-8


def heat_batch(u, x_max=math.pi, t_max=3.0):
    """The collocation points (x, t) of ``[B, 2]`` U[0, 1) draws."""
    return torch.stack([x_max * u[:, 0], t_max * u[:, 1]], 1)


def heat_point_loss(cfg, p, xt, x_max=math.pi, kappa=1.0):
    xt = xt.detach().requires_grad_(True)
    u = nets.forward(cfg, p, xt)
    du = torch.autograd.grad(u.sum(), xt, create_graph=True)[0]
    u_t = du[:, 1:2]
    u_xx = torch.autograd.grad(du[:, 0].sum(), xt, create_graph=True)[0]
    u_xx = u_xx[:, 0:1]
    x, t = xt[:, 0:1].detach(), xt[:, 1:2].detach()
    zero = torch.zeros_like(x)
    u0 = nets.forward(cfg, p, torch.cat([x, zero], 1))
    ub1 = nets.forward(cfg, p, torch.cat([zero, t], 1))
    ub2 = nets.forward(cfg, p, torch.cat([torch.full_like(x, x_max), t], 1))
    r = u_t - kappa * u_xx
    r0 = u0 - torch.sin(x)
    return (r * r + r0 * r0 + ub1 * ub1 + ub2 * ub2)[:, 0]


def fhn_point_loss(cfg, p, t, i_ext=0.5, alpha=0.7, beta=0.8, tau=2.5,
                   y_ic=0.0):
    t = t.detach().requires_grad_(True)
    s = nets.forward(cfg, p, t)
    y, w = s[:, 0:1], s[:, 1:2]
    dy = torch.autograd.grad(y.sum(), t, create_graph=True)[0]
    dw = torch.autograd.grad(w.sum(), t, create_graph=True)[0]
    r_y = dy + (y ** 3 / 3.0 + w - i_ext - y)
    r_w = dw + (beta * w - alpha - y) / tau
    s0 = nets.forward(cfg, p, torch.zeros_like(t))
    ic = torch.mean((s0 - y_ic) ** 2, 1, keepdim=True)
    return (r_y ** 2 + r_w ** 2 + ic)[:, 0]


POINT_LOSSES = {"heat": heat_point_loss, "fitzhugh_nagumo": fhn_point_loss}


def loss(cfg, p, points):
    """The mean point loss of ``cfg``'s equation over ``points``."""
    return torch.mean(POINT_LOSSES[cfg["equation"]](cfg, p, points))


def follow(cfg, p, points, lrate, steps=3):
    """Adam steps (torch's defaults, eps 1e-8) from parameters ``p`` on the
    batches ``points[k]``: the loss of each step before its update, as a
    list of floats. ``p`` is not changed."""
    return adam_steps(cfg, p, points, lrate, steps)[0]


def adam_steps(cfg, p, points, lrate, steps):
    """:func:`follow`'s losses and the parameters after its ``steps``."""
    p = {k: v.detach().clone() for k, v in p.items()}
    m = {k: torch.zeros_like(v) for k, v in p.items()}
    v2 = {k: torch.zeros_like(v) for k, v in p.items()}
    out = []
    for k in range(steps):
        leaves = {n: t.requires_grad_(True) for n, t in p.items()}
        value = loss(cfg, leaves, points[k])
        grads = torch.autograd.grad(value, list(leaves.values()))
        out.append(float(value.detach()))
        c1, c2 = 1.0 - B1 ** (k + 1), 1.0 - B2 ** (k + 1)
        with torch.no_grad():
            for (n, t), g in zip(leaves.items(), grads):
                m[n] = B1 * m[n] + (1.0 - B1) * g
                v2[n] = B2 * v2[n] + (1.0 - B2) * g * g
                p[n] = t.detach() - lrate * (m[n] / c1) / (
                    torch.sqrt(v2[n] / c2) + EPS)
    return out, p


T_MAX = {"heat": 3.0, "fitzhugh_nagumo": 30.0}


def points(cfg, u):
    """The collocation points of ``cfg``'s equation from ``[B, U]``
    U[0, 1) draws: heat's (π·u₀, 3·u₁), FitzHugh–Nagumo's 30·u (the
    uniform time draws of its training without causal weighting)."""
    if cfg["equation"] == "heat":
        return heat_batch(u)
    return T_MAX[cfg["equation"]] * u[:, :1]
