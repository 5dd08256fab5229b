"""The MLP-forward kernel (csrc/mlp_forward.cu), the heat-streams kernel
(csrc/heat_streams.cu), and their plain versions.

Counterparts of the JAX package's kernels/taylor_mlp.py:
``mlp_forward_pallas`` (``Problem.evaluate`` runs the evaluation grid
through :func:`mlp_forward`) and ``heat_fused_streams_pallas``
(``Heat1D(taps="pallas")`` takes its 7 streams from
:func:`heat_fused_streams` in every training step).
"""

import ctypes
import functools
import types

import torch

from differential_equations_dnn_tpu_torch.kernels import build
from differential_equations_dnn_tpu_torch.kernels.engine_core import (
    SMEM_LIMIT,
)
from differential_equations_dnn_tpu_torch.models import (
    MLP,
    HardConstraint,
    Perceptron,
)
from differential_equations_dnn_tpu_torch.ops import taylor

_ACT_KIND = {"tanh": 0, "relu": 1, "sigmoid": 2}

# The widest max(D, H) csrc/mlp_forward.cu takes: its narrowest tile, 8
# rows, holds two k-major activation buffers of width × 8 floats, a ring of
# 2 W k-tiles of 32 × 128 floats and two 8-byte barriers a k-tile within a
# block's 227 KB: 3 119. The library plans everything else
# (:func:`mlp_forward_plan`); a GPU test holds it to this limit.
MAX_MLP_WIDTH = (SMEM_LIMIT - 2 * 16 - 4 * 2 * 32 * 128) // (4 * 2 * 8)


def check_mlp_width(D, H):
    """Raise a ValueError naming MAX_MLP_WIDTH if max(D, H) passes it."""
    width = max(D, H)
    if width > MAX_MLP_WIDTH:
        raise ValueError(
            f"mlp_forward at width {width} needs more than the {SMEM_LIMIT} "
            f"bytes of shared memory an H100 block may take (two 8-row "
            f"activation buffers and the weight ring); the widest it takes "
            f"is {MAX_MLP_WIDTH}")


def mlp_forward_plan(N, D, H, O=1):
    """The library's launch of csrc/mlp_forward.cu at N rows and widths D →
    H → O on the current card (``mlp_forward_plan``; needs the card): CTA
    tiles of ``rows`` rows (64, 32, 16 or 8, from N, the card's SMs and
    the width), ``threads`` per CTA, a ring of ``stages`` W k-tiles,
    ``smem`` bytes of shared memory and a ``cluster`` of CTAs that share
    each W tile's copy. Past MAX_MLP_WIDTH a ValueError names the limit."""
    check_mlp_width(D, H)
    out = (ctypes.c_int * 5)()
    build.check(build.library().mlp_forward_plan(N, D, H, O, out),
                "mlp_forward_plan")
    return dict(zip(("rows", "threads", "stages", "smem", "cluster"), out))


def mlp_forward_plain(model, x):
    """The plain PyTorch version: the same products, biases and activation."""
    return model(x)


def _mlp_view(model):
    """The model as the kernel reads it: (activation, D, H, L, O, the six
    named tensors). A plain MLP; a Perceptron is one at L = 0 (its hidden
    stack empty); an inverse-problem model is its solution net."""
    if isinstance(model, Perceptron):
        D, H, O = model.input_dim, model.hidden_size, model.output_dim
        w1 = model.fc1.w
        return ("tanh", D, H, 0, O, [
            ("fc1.w", w1, (D, H)), ("fc1.b", model.fc1.b, (H,)),
            ("hidden.w", w1.new_zeros((0, H, H)), (0, H, H)),
            ("hidden.b", w1.new_zeros((0, H)), (0, H)),
            ("fc2.w", model.fc2.w, (H, O)), ("fc2.b", model.fc2.b, (O,))])
    net = getattr(model, "net", model)
    if not isinstance(net, MLP):
        raise ValueError(f"mlp_forward takes an MLP, a Perceptron or a "
                         f"model around an MLP (got {type(model).__name__})")
    D, H, L, O = net.input_dim, net.hidden_size, net.num_layers, \
        net.output_dim
    return (net.activation, D, H, L, O, [
        ("fc_in.w", net.fc_in.w, (D, H)), ("fc_in.b", net.fc_in.b, (H,)),
        ("hidden.w", net.hidden.w, (L, H, H)),
        ("hidden.b", net.hidden.b, (L, H)),
        ("fc_out.w", net.fc_out.w, (H, O)),
        ("fc_out.b", net.fc_out.b, (O,))])


def _check_plain(net):
    """A ValueError for a BatchNorm or Fourier-feature MLP: another
    network than the plain layers the kernels compute (on either device,
    before any launch)."""
    if not getattr(net, "plain", True):
        raise ValueError("the MLP kernels take a plain MLP (no BatchNorm, "
                         "no Fourier features); evaluate this one through "
                         "its own forward, as Problem.evaluate does")


def mlp_forward(model, x):
    """``model(x)`` for a plain MLP with a tanh, relu or sigmoid activation
    (or a Perceptron, or a model whose ``net`` is such an MLP): ``x [N,
    D]`` → ``[N, O]``, one kernel launch for any N.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``mlp_forward.launches`` counts the launches). A HardConstraint raises
    a ValueError on either device: its ``net`` is an MLP, but the model's
    function is the ansatz around it, which the kernel must not drop."""
    if isinstance(model, HardConstraint):
        raise ValueError("mlp_forward evaluates an MLP, not a "
                         "HardConstraint's ansatz around one: pass "
                         "model.net and apply model.ansatz to the result, "
                         "as Problem.evaluate does")
    _check_plain(getattr(model, "net", model))
    if x.device.type == "cpu":
        return mlp_forward_plain(model, x)
    activation, D, H, L, O, weights = _mlp_view(model)
    kind = _ACT_KIND.get(activation)
    if kind is None:
        raise ValueError(f"mlp_forward supports {sorted(_ACT_KIND)} "
                         f"activations, not {activation!r}")
    n, d = x.shape
    if d != D:
        raise ValueError(f"x has {d} columns, the model takes {D}")
    check_mlp_width(D, H)
    build.require_cuda_f32("x", x)
    for name, t, shape in weights:
        build.require_cuda_f32(name, t, shape)
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    y = torch.empty((n, O), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        code = lib.mlp_forward(x.data_ptr(), *(t.data_ptr() for _, t, _ in
                                               weights),
                               y.data_ptr(), n, D, H, L, O, kind,
                               build.stream_ptr(x.device))
    build.check(code, "mlp_forward")
    mlp_forward.launches += 1
    return y


mlp_forward.launches = 0


# ---------------------------------------------------------------------------
# The heat step's 7 streams (kernel #3)
# ---------------------------------------------------------------------------

_STREAM_WEIGHTS = ("fc_in.w", "fc_in.b", "hidden.w", "hidden.b", "fc_out.w",
                   "fc_out.b")


def heat_fused_streams_plain(model, xt, x0, xb1, xb2):
    """The plain version: ``ops.taylor.heat_fused_streams``, the same
    products, value-stream biases and Taylor rules. Returns (u, u_x, u_xx,
    u_t, u0, ub1, ub2), each [B, O]."""
    return taylor.heat_fused_streams(model, xt, x0, xb1, xb2)


def _with_weights(model, weights):
    """A stand-in for ``model`` that ``ops.taylor.mlp_streams`` reads,
    holding the given six tensors in place of the module's parameters."""
    w_in, b_in, w_hid, b_hid, w_out, b_out = weights
    return types.SimpleNamespace(
        activation=model.activation, num_layers=model.num_layers,
        fc_in=types.SimpleNamespace(w=w_in, b=b_in),
        hidden=types.SimpleNamespace(w=w_hid, b=b_hid),
        fc_out=types.SimpleNamespace(w=w_out, b=b_out))


def _check_streams_model(model):
    """The kernel takes a plain MLP 2 → H×L → O with a tanh, sigmoid or
    relu activation, as the TPU kernel does (taylor_mlp.py:33-57, 166)."""
    if not isinstance(model, MLP) or not model.plain:
        raise ValueError(f"heat_fused_streams supports plain MLPs only "
                         f"(no BatchNorm, no Fourier features; got "
                         f"{type(model).__name__})")
    if model.activation not in _ACT_KIND:
        raise ValueError(f"heat_fused_streams supports {sorted(_ACT_KIND)} "
                         f"activations, not {model.activation!r}")
    if model.input_dim != 2:
        raise ValueError(f"heat_fused_streams takes (x, t) inputs: the "
                         f"model's input width is {model.input_dim}, not 2")


# csrc/heat_streams.cu's plan: threads per CTA, rows of a W k-tile, ring
# depths (the deeper where it fits), the portable cluster size and the
# columns per CTA it aims for.
_STREAM_THREADS, _STREAM_K_TILE, _STREAM_STAGES = 128, 32, (8, 3)
_MAX_CLUSTER, _SLICE_COLS = 8, 16


def _streams_fit(H):
    """The plan at width H, or None if no points-per-cluster count fits."""
    C = min(_MAX_CLUSTER, max(1, -(-H // _SLICE_COLS)))
    ld = -(-max(2, H) // 32) * 32 + 4
    for P in (8, 4, 2, 1):
        lanes = _STREAM_THREADS // P
        for stages in _STREAM_STAGES:
            need = 4 * (2 * 7 * P * ld + stages * _STREAM_K_TILE * lanes)
            if need <= SMEM_LIMIT:
                return {"cluster": C, "points": P, "k_tile": _STREAM_K_TILE,
                        "threads": _STREAM_THREADS, "stages": stages,
                        "smem": need}
    return None


@functools.cache
def _widest_streams():
    """The widest H that :func:`heat_streams_plan` fits (3 264)."""
    H = 1
    while _streams_fit(H + 1) is not None:
        H += 1
    return H


def heat_streams_plan(H, O=1):
    """The launch of csrc/heat_streams.cu at hidden width H, as the library
    plans it (``heat_streams_plan``): a thread block cluster of ``cluster``
    CTAs (8 from H = 113) takes ``points`` points, each CTA a column slice
    of every layer; its shared memory holds
    two buffers of the 7 streams of those points at width H (a layer's
    input and its output, which every CTA of the cluster stores into) and
    a ring of ``stages`` ``k_tile``-row tiles of its W slice, so it grows
    with H and not with H². The output width O is not staged whole and does
    not count. Past the widest H that fits a block's 227 KB with one point
    per cluster, a ValueError names that limit."""
    plan = _streams_fit(H)
    if plan is None:
        raise ValueError(
            f"the heat-streams kernel at hidden width {H} needs more than "
            f"the {SMEM_LIMIT} bytes of shared memory an H100 block may "
            f"take; the widest it takes is H = {_widest_streams()}")
    return plan


# The most trials one launch of csrc/heat_streams.cu takes (gridDim.y).
MAX_STREAM_TRIALS = 65535


def _launch_heat_streams(spec, points, weights):
    """One launch of csrc/heat_streams.cu over T trials: ``points`` are
    four [T, B, 2] tensors and ``weights`` the six [T, ...] tensors of T
    nets of one architecture ``spec``; returns the streams as [T, 7, B,
    O]. Past MAX_STREAM_TRIALS a ValueError names the limit before
    anything launches."""
    activation, H, L, O = spec
    T, B = points[0].shape[:2]
    if T > MAX_STREAM_TRIALS:
        raise ValueError(f"the heat-streams kernel takes at most "
                         f"{MAX_STREAM_TRIALS} trials a launch (the grid's "
                         f"y dimension), not {T}")
    heat_streams_plan(H, O)
    shapes = ((2, H), (H,), (L, H, H), (L, H), (H, O), (O,))
    for name, t in zip(("xt", "x0", "xb1", "xb2"), points):
        build.require_cuda_f32(name, t, (T, B, 2))
    for name, t, shape in zip(_STREAM_WEIGHTS, weights, shapes):
        build.require_cuda_f32(name, t, (T,) + shape)
    device = points[0].device
    for name, t in zip(("x0", "xb1", "xb2") + _STREAM_WEIGHTS,
                       points[1:] + weights):
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, xt on {device}")
    lib = build.library()
    out = torch.empty((T, 7, B, O), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        code = lib.heat_streams(*(t.data_ptr() for t in points + weights),
                                out.data_ptr(), T, B, H, L, O,
                                _ACT_KIND[activation],
                                build.stream_ptr(device))
    build.check(code, "heat_streams")
    heat_fused_streams.launches += 1
    return out


def _plain_streams(spec, points, weights):
    """The plain version on one net's tensors, as a tuple of 7 [B, O]."""
    net = _with_weights(types.SimpleNamespace(activation=spec[0],
                                              num_layers=spec[2]), weights)
    return heat_fused_streams_plain(net, *points)


def _trial_streams(spec, points, weights):
    """The 7 streams of T nets at once (points [T, B, 2], weights [T, ...]):
    one kernel launch for CUDA tensors, the plain version vmapped over the
    trials for CPU tensors. Returns 7 tensors [T, B, O]."""
    if points[0].device.type == "cpu":
        return torch.func.vmap(
            lambda *ts: _plain_streams(spec, ts[:4], ts[4:]))(
                *points, *weights)
    return tuple(_launch_heat_streams(
        spec, tuple(points), tuple(weights)).unbind(1))


class _HeatStreams(torch.autograd.Function):
    """Forward: the kernel (CUDA tensors) or the plain version (CPU
    tensors), one net at a time. Under ``torch.func.vmap`` (a population's
    trials, as ``jax.vmap`` gives the TPU kernel a leading grid axis) the
    :meth:`vmap` rule stacks the trials, expanding any input shared by all
    of them, and computes them in one launch. Backward, as the JAX
    package's custom VJP (taylor_mlp.py:171-187): the VJP of the plain
    stream math on the saved inputs and weights by ``torch.func.vjp``,
    torch ops as the JAX backward is XLA outside any Pallas kernel; it
    composes with ``torch.func`` (``grad_and_value`` inside ``vmap``) as
    with ordinary autograd."""

    @staticmethod
    def forward(spec, xt, x0, xb1, xb2, *weights):
        points = (xt, x0, xb1, xb2)
        if xt.device.type == "cpu":
            return _plain_streams(spec, points, weights)
        out = _launch_heat_streams(
            spec, tuple(t.unsqueeze(0) for t in points),
            tuple(w.unsqueeze(0) for w in weights))
        return tuple(out[0].unbind(0))

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.spec = inputs[0]
        ctx.save_for_backward(*inputs[1:])

    @staticmethod
    def backward(ctx, *cotangents):
        saved = ctx.saved_tensors
        needs = [i for i, need in enumerate(ctx.needs_input_grad[1:])
                 if need]

        def streams(*chosen):
            args = list(saved)
            for i, t in zip(needs, chosen):
                args[i] = t
            return _plain_streams(ctx.spec, args[:4], args[4:])

        _, pull = torch.func.vjp(streams, *(saved[i] for i in needs))
        grads = dict(zip(needs, pull(tuple(cotangents))))
        return (None,) + tuple(grads.get(i) for i in range(len(saved)))

    @staticmethod
    def vmap(info, in_dims, spec, *tensors):
        stacked = [t.movedim(d, 0) if d is not None
                   else t.expand(info.batch_size, *t.shape)
                   for t, d in zip(tensors, in_dims[1:])]
        stacked = [t.contiguous() for t in stacked]
        return _trial_streams(spec, stacked[:4], stacked[4:]), (0,) * 7


def heat_fused_streams(model, xt, x0, xb1, xb2):
    """(u, u_x, u_xx, u_t, u0, ub1, ub2), each [B, O], of a plain MLP 2 →
    H×L → O (tanh, sigmoid or relu) at the interior points ``xt`` and the
    constraint points ``x0``, ``xb1``, ``xb2`` (each [B, 2]): one kernel
    launch, differentiable in the points and the weights. Under
    ``torch.func.vmap`` over trials (the population trainer's
    ``functional_call`` of stacked weights) all trials take one launch.

    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``heat_fused_streams.launches`` counts the launches). Raises
    ValueError, on any device, for another model or activation."""
    _check_streams_model(model)
    weights = (model.fc_in.w, model.fc_in.b, model.hidden.w, model.hidden.b,
               model.fc_out.w, model.fc_out.b)
    spec = (model.activation, model.hidden_size, model.num_layers,
            model.output_dim)
    return _HeatStreams.apply(spec, xt, x0, xb1, xb2, *weights)


heat_fused_streams.launches = 0
