"""Derivative taps for physics residuals: coordinate derivatives of a net.

``f`` is a batched function ``[B, d] -> [B, k]`` whose rows are independent
(a plain MLP or a DGM). The JAX package takes these taps in forward mode
(``jax.jvp`` along a coordinate tangent, jvp over jvp for the second
derivative). Here they come from reverse mode: because rows are
independent, the gradient of ``f(x)[:, c].sum()`` with respect to ``x`` is
each row's own gradient, whose column ``a`` is ∂f_c/∂x_a; differentiating
that column again gives ∂²f_c/∂x_a². The numbers are the same to fp32
reassociation; ``torch.func.jvp``, the forward-mode counterpart, pays its
transform layers on every op, and the scan trainer's step, bound by the
host's work per op, paid for it (PERF.md). One forward and one
first-order gradient serve every tap of a residual at one set of points.

Every tap builds its graph (``create_graph=True``) so that the training loss
differentiates through it, and does so even under ``torch.no_grad()``.
"""

import torch


def _grads(y, x):
    """Row-wise ∂y[:, c]/∂x, [B, d], for each of ``y``'s k columns (zeros
    where a column does not depend on ``x``)."""
    return [torch.autograd.grad(y[:, c].sum(), x, create_graph=True,
                                allow_unused=True, materialize_grads=True)[0]
            for c in range(y.shape[1])]


def _column(grads, a):
    """Coordinate ``a`` of each column's gradient: [B, k]."""
    cols = [g[:, a:a + 1] for g in grads]
    return cols[0] if len(cols) == 1 else torch.cat(cols, 1)


def _leaf(x):
    """``x`` itself if it is already differentiable, else a leaf copy."""
    return x if x.requires_grad else x.detach().requires_grad_(True)


def coordinate_taps(f, x, first=(), second=()):
    """(f(x), [∂f/∂x_a for a in first], [∂²f/∂x_a² for a in second]) along
    coordinate axes of the last dimension, all from one forward."""
    with torch.enable_grad():
        x = _leaf(x)
        y = f(x)
        grads = _grads(y, x)
        return (y, [_column(grads, a) for a in first],
                [_column(_grads(_column(grads, a), x), a) for a in second])


def value_dt(f, x, t_axis=0):
    """(f(x), ∂f/∂t) with ``t_axis`` the time coordinate of ``x``."""
    y, (dy,), _ = coordinate_taps(f, x, first=(t_axis,))
    return y, dy


def value_dx_dxx(f, x, x_axis=0):
    """(f(x), ∂f/∂x, ∂²f/∂x²) along spatial coordinate ``x_axis``."""
    y, (dy,), (ddy,) = coordinate_taps(f, x, first=(x_axis,),
                                       second=(x_axis,))
    return y, dy, ddy
