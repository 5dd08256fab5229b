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

``torch.autograd.grad`` cannot run under ``torch.func`` transforms, which
the population trainer (parallel/population.py) steps its trials with.
Inside :func:`functional_taps` the same taps come from ``torch.func.vjp``
with a one-hot column cotangent, nested for the second derivative: Jᵀ·1
again, so the numbers are today's route's to fp32 reassociation, for
plain nets (rows independent) and for BatchNorm nets alike, whose rows
are coupled through the batch statistics. There the taps are the
reference's ``torch.autograd.grad(u, x, ones)``; the JAX package's batched
jvp (J·1) differs (ROADMAP queue 3).

``time_jacobian``, ``dirderiv2`` and ``hessian_diag`` are the JAX
package's general helpers in forward mode (``torch.func.jvp``), which
compose with ``torch.func.vmap``; no residual of the port uses them.
"""

import contextlib
import contextvars

import torch

_FUNCTIONAL = contextvars.ContextVar("functional_taps", default=False)


@contextlib.contextmanager
def functional_taps():
    """Take every tap in the block through ``torch.func`` (the route that
    runs under ``torch.func.vmap`` and ``torch.func.grad``)."""
    token = _FUNCTIONAL.set(True)
    try:
        yield
    finally:
        _FUNCTIONAL.reset(token)


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
    if _FUNCTIONAL.get():
        return _func_taps(f, x, first, second)
    with torch.enable_grad():
        x = _leaf(x)
        y = f(x)
        grads = _grads(y, x)
        return (y, [_column(grads, a) for a in first],
                [_column(_grads(_column(grads, a), x), a) for a in second])


def _onehot(y, c):
    """The cotangent that picks column ``c`` of ``y [B, k]``."""
    if y.shape[1] == 1:
        return torch.ones_like(y)
    lane = torch.arange(y.shape[1], device=y.device)
    return (lane == c).to(y.dtype).expand_as(y)


def _func_taps(f, x, first, second):
    """:func:`coordinate_taps` through ``torch.func.vjp``: one forward for
    the value and the first derivatives, and one more per second-derivative
    axis (the first derivatives' own vjp)."""
    from torch.func import vjp

    def grads(z):
        y, pull = vjp(f, z)
        return y, [pull(_onehot(y, c))[0] for c in range(y.shape[1])]

    if not second:
        y, gs = grads(x)
        return y, [_column(gs, a) for a in first], []
    seconds = []
    for a in second:
        def column_a(z, a=a):
            y, gs = grads(z)
            return _column(gs, a), (y, gs)

        ca, pull, (y, gs) = vjp(column_a, x, has_aux=True)
        seconds.append(_column([pull(_onehot(ca, c))[0]
                                for c in range(ca.shape[1])], a))
    return y, [_column(gs, a) for a in first], seconds


def value_dt(f, x, t_axis=0):
    """(f(x), ∂f/∂t) with ``t_axis`` the time coordinate of ``x``."""
    y, (dy,), _ = coordinate_taps(f, x, first=(t_axis,))
    return y, dy


def value_dx_dxx(f, x, x_axis=0):
    """(f(x), ∂f/∂x, ∂²f/∂x²) along spatial coordinate ``x_axis``."""
    y, (dy,), (ddy,) = coordinate_taps(f, x, first=(x_axis,),
                                       second=(x_axis,))
    return y, dy, ddy


def time_jacobian(f, t):
    """For systems y: R -> R^k (e.g. FitzHugh–Nagumo): one jvp along t gives
    the time derivative of every output component at once, replacing the
    reference's per-component reverse taps (fitzhugh_nagumo.py:74-84).

    Returns (y, dy/dt), each of ``f(t)``'s shape."""
    from torch.func import jvp

    return jvp(f, (t,), (torch.ones_like(t),))


def dirderiv2(f, x, v):
    """(f(x), ∂f/∂v, ∂²f/∂v²): value and first and second directional
    derivatives along ``v`` in one jvp over jvp (forward over forward)."""
    from torch.func import jvp

    def first(z):
        return jvp(f, (z,), (v,))

    (y, dy), (_, d2y) = jvp(first, (x,), (v,))
    return y, dy, d2y


def hessian_diag(f, x):
    """Diagonal of the Hessian of a scalar-output ``f`` at ``x`` (shape
    [d]): :func:`dirderiv2` along each coordinate axis, vmapped over the
    axes."""
    from torch.func import vmap

    eye = torch.eye(x.shape[-1], dtype=x.dtype, device=x.device)
    return vmap(lambda v: dirderiv2(f, x, v)[2])(eye)
