"""Derivative taps for physics residuals, in forward mode (``torch.func.jvp``).

``f`` is a batched function ``[B, d] -> [B, k]`` whose rows are independent
(a plain MLP); the tangent is a coordinate direction broadcast over the
batch, so one jvp gives the directional derivative at every point.
"""

import torch
from torch.func import jvp


def dirderiv(f, x, v):
    """(f(x), ∂f/∂v) — one jvp."""
    return jvp(f, (x,), (v,))


def dirderiv2(f, x, v):
    """(f(x), ∂f/∂v, ∂²f/∂v²) — jvp over jvp along the same direction."""

    def first(z):
        return jvp(f, (z,), (v,))

    (y, dy), (_, d2y) = jvp(first, (x,), (v,))
    return y, dy, d2y


def coord_direction(x, axis):
    """Unit tangent along coordinate ``axis`` of the last dimension,
    broadcast to ``x``'s shape."""
    v = torch.zeros_like(x)
    v[..., axis] = 1.0
    return v


def value_dt(f, x, t_axis=0):
    """(f(x), ∂f/∂t) with ``t_axis`` the time coordinate of ``x``."""
    return dirderiv(f, x, coord_direction(x, t_axis))


def value_dx_dxx(f, x, x_axis=0):
    """(f(x), ∂f/∂x, ∂²f/∂x²) along spatial coordinate ``x_axis``."""
    return dirderiv2(f, x, coord_direction(x, x_axis))
