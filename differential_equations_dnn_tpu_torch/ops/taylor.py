"""Stacked Taylor propagation: all derivative streams in ONE matmul per layer.

The value stream and its tangent streams are stacked into one ``[S·B, H]``
operand per layer; the pointwise Taylor rules of the activation run between
layers:

    linear  z_s = a_s @ W        (+ b for value streams only)
    tanh    a0  = tanh(z0),          d = 1 − a0²      (value)
            a1  = d·z1                                 (∂/∂v)
            a2  = d·z2 − 2·a0·d·z1²                    (∂²/∂v²)
            a3  = d·z3                                 (∂/∂w)

This is exact forward-mode algebra, so it matches ``ops.diff`` up to
reassociation, and it is differentiable by autograd. Plain MLPs only.
"""

import torch

from differential_equations_dnn_tpu_torch.core.precision import dense

_TAYLOR_ACTS = ("tanh", "relu", "sigmoid", "identity")


def _act_state(name, z0):
    """(a, a', a'') of the activation at z0."""
    if name == "tanh":
        a0 = torch.tanh(z0)
        d = 1.0 - a0 * a0
        return a0, d, -2.0 * a0 * d
    if name == "sigmoid":
        a0 = 1.0 / (1.0 + torch.exp(-z0))
        d = a0 * (1.0 - a0)
        return a0, d, d * (1.0 - 2.0 * a0)
    if name == "relu":
        g = (z0 > 0).to(z0.dtype)
        return torch.clamp_min(z0, 0.0), g, torch.zeros_like(z0)
    if name == "identity":
        return z0, torch.ones_like(z0), torch.zeros_like(z0)
    raise ValueError(f"activation {name!r} not supported by stacked Taylor "
                     f"propagation (supported: {_TAYLOR_ACTS})")


def _direction(v, x):
    """The direction ``v`` (a sequence of floats) as a row per point of
    ``x``, filled in place on ``x``'s device: no host-to-device copy, which
    would make every training step wait for the device."""
    row = torch.zeros_like(x)
    for i, c in enumerate(v):
        if c:
            row[:, i] = c
    return row


def mlp_streams(model, x, second_dirs=(), first_dirs=(), constraints=()):
    """Stacked-stream evaluation of a plain MLP.

    One matmul chain per layer computes, simultaneously:
      * u(x)                                    — value at ``x`` [B, D]
      * (∂_v u, ∂²_v u) for each v in ``second_dirs``   ([D] each)
      * ∂_w u for each w in ``first_dirs``              ([D] each)
      * u(c) for each constraint input c in ``constraints`` ([B, D] each)

    Row layout: [value | (tan_i, sec_i)·len(second) | tan_j·len(first) |
    constraints]. Returns (u, seconds, firsts_of_seconds, firsts,
    constraint_values), each entry [B, out_dim]. A BatchNorm or
    Fourier-feature MLP raises a ValueError: the streams follow the plain
    layers only.
    """
    if not getattr(model, "plain", True):
        raise ValueError("Taylor streams take a plain MLP (no BatchNorm, "
                         "no Fourier features); use the jvp taps")
    name = model.activation
    B = x.shape[0]
    ns, nf, nc = len(second_dirs), len(first_dirs), len(constraints)

    rows = [x]
    for v in second_dirs:
        rows.append(_direction(v, x))
        rows.append(torch.zeros_like(x))
    for w in first_dirs:
        rows.append(_direction(w, x))
    rows.extend(constraints)
    stacked = torch.cat(rows, 0)

    def act_all(z):
        a0, d, dd = _act_state(name, z[:B])
        out = [a0]
        for i in range(ns):
            z1 = z[(1 + 2 * i) * B:(2 + 2 * i) * B]
            z2 = z[(2 + 2 * i) * B:(3 + 2 * i) * B]
            out.append(d * z1)
            out.append(d * z2 + dd * (z1 * z1))
        base = 1 + 2 * ns
        for j in range(nf):
            out.append(d * z[(base + j) * B:(base + j + 1) * B])
        if nc:
            out.append(_act_state(name, z[(base + nf) * B:])[0])
        return torch.cat(out, 0)

    # Value rows (the point and the constraints) get the bias; tangents
    # do not, since a constant has zero derivative.
    bias_mask = torch.cat([
        torch.ones((B, 1), dtype=x.dtype, device=x.device),
        torch.zeros(((2 * ns + nf) * B, 1), dtype=x.dtype, device=x.device),
        torch.ones((nc * B, 1), dtype=x.dtype, device=x.device),
    ], 0)

    def layer(a, w, b):
        return dense(a, w, bias_mask * b)

    a = act_all(layer(stacked, model.fc_in.w, model.fc_in.b))
    for l in range(model.num_layers):
        a = act_all(layer(a, model.hidden.w[l], model.hidden.b[l]))
    out = layer(a, model.fc_out.w, model.fc_out.b)

    blocks = [out[k * B:(k + 1) * B] for k in range(1 + 2 * ns + nf + nc)]
    u = blocks[0]
    firsts_of_seconds = [blocks[1 + 2 * i] for i in range(ns)]
    seconds = [blocks[2 + 2 * i] for i in range(ns)]
    firsts = [blocks[1 + 2 * ns + j] for j in range(nf)]
    cons = [blocks[1 + 2 * ns + nf + k] for k in range(nc)]
    return u, seconds, firsts_of_seconds, firsts, cons


def mlp_taps(model, x, v, w):
    """u, ∂_v u, ∂²_v u and ∂_w u of a plain MLP at a batch of points, from
    one :func:`mlp_streams` chain (the JAX package's ``mlp_taps``).

    ``x`` is [B, D], ``v`` (the second-order direction, e.g. e_x) and ``w``
    (an independent first-order one, e.g. e_t) are [D]. Returns (u, du_v,
    d2u_vv, du_w), each [B, out_dim]. A BatchNorm MLP raises a ValueError,
    as in the JAX package."""
    if getattr(model, "batch_norm", None) is not None:
        raise ValueError("mlp_taps supports plain MLPs only")
    u, (d2u_vv,), (du_v,), (du_w,), _ = mlp_streams(
        model, x, second_dirs=([float(c) for c in v],),
        first_dirs=([float(c) for c in w],))
    return u, du_v, d2u_vv, du_w


def heat_fused_streams(model, xt, x0, xb1, xb2):
    """The heat step's 7 network evaluations in one stacked chain: interior
    value, x-, xx- and t-tangents, and the IC and two boundary forwards.

    Returns (u, u_x, u_xx, u_t, u0, ub1, ub2), each [B, 1]."""
    u, (u_xx,), (u_x,), (u_t,), (u0, ub1, ub2) = mlp_streams(
        model, xt,
        second_dirs=([1.0, 0.0],),
        first_dirs=([0.0, 1.0],),
        constraints=(x0, xb1, xb2),
    )
    return u, u_x, u_xx, u_t, u0, ub1, ub2
