"""The fused heat trainer: K Adam steps per kernel call (csrc/heat_train.cu).

Counterpart of the JAX package's kernels/fused_train.py. Each step:

* builds the 7-stream stacked input ``[7B, 2]`` from ``[B, 2]`` uniforms
  (interior value, x/xx/t Taylor tangents, IC and two BC forwards);
* pushes it through the tanh MLP with the Taylor activation rules;
* computes the heat loss and its gradient with the hand-derived backward;
* applies Adam with torch-default hyperparameters and bias correction by the
  absolute step ``t = step0 + k + 1``.

``fused_step_math`` and ``adam_update`` are the plain PyTorch version of
that step; the CPU tests hold them against the JAX package, and
``chip_smoke.py`` holds the CUDA kernel against them on the card.

Parameters and both Adam moments are each ONE flat fp32 buffer in the order
(w_in, b_in, w_hid, b_hid, w_out, b_out); ``unpack_params`` gives views.
Only ``precision="highest"`` (exact fp32) is ported.
"""

import math
import time

import torch

from differential_equations_dnn_tpu_torch.core.prng import (
    generator,
    step_uniforms,
)
from differential_equations_dnn_tpu_torch.kernels import build
from differential_equations_dnn_tpu_torch.models import MLP
from differential_equations_dnn_tpu_torch.train.trainer import TrainResult

_B1, _B2, _EPS = 0.9, 0.999, 1e-8
_PRECISION_TODO = ("precision={!r} is not ported yet (ROADMAP.md queue 1, "
                   "Slice A, next: bf16 tensor-core precision modes)")


# ---------------------------------------------------------------------------
# The plain step math
# ---------------------------------------------------------------------------


def _stack_inputs(u, x_max, t_max):
    """u: [B, 2] uniforms in [0,1) → the 7-stream stacked input [7B, 2]."""
    x = x_max * u[:, :1]
    t = t_max * u[:, 1:]
    zero = torch.zeros_like(x)
    one = torch.ones_like(x)
    rows = [
        torch.cat([x, t], 1),                            # interior value
        torch.cat([one, zero], 1),                       # x-tangent
        torch.cat([zero, zero], 1),                      # xx-tangent
        torch.cat([zero, one], 1),                       # t-tangent
        torch.cat([x, zero], 1),                         # IC points (x, 0)
        torch.cat([zero, t], 1),                         # boundary x=0
        torch.cat([torch.full_like(x, x_max), t], 1),    # boundary x=x_max
    ]
    return torch.cat(rows, 0), x


def _bias_mask(B, like):
    """Value streams (interior + 3 constraints) get the bias; tangents not."""
    return torch.cat([like.new_ones((B, 1)), like.new_zeros((3 * B, 1)),
                      like.new_ones((3 * B, 1))], 0)


def _act_fwd(z, B):
    """tanh on value streams, Taylor rules on the tangent streams."""
    z0, z1, z2, z3, zc = z[:B], z[B:2 * B], z[2 * B:3 * B], z[3 * B:4 * B], \
        z[4 * B:]
    a0 = torch.tanh(z0)
    d = 1.0 - a0 * a0
    return torch.cat([a0, d * z1, d * z2 - 2.0 * a0 * d * (z1 * z1), d * z3,
                      torch.tanh(zc)], 0)


def _act_bwd(z, g, B):
    """VJP of _act_fwd: grads w.r.t. the streams a → grads w.r.t. z.

    With a0=tanh(z0), d=1−a0², d' = −2 a0 d:
      dz0 = d·g0 + d'(z1 g1 + z2 g2 + z3 g3) − 2 z1² d (d − 2 a0²) g2
      dz1 = d·g1 − 4 a0 d z1 g2,  dz2 = d·g2,  dz3 = d·g3
      dzc = (1 − tanh²(zc))·gc
    """
    z0, z1, z2, z3, zc = z[:B], z[B:2 * B], z[2 * B:3 * B], z[3 * B:4 * B], \
        z[4 * B:]
    g0, g1, g2, g3, gc = g[:B], g[B:2 * B], g[2 * B:3 * B], g[3 * B:4 * B], \
        g[4 * B:]
    a0 = torch.tanh(z0)
    d = 1.0 - a0 * a0
    dp = -2.0 * a0 * d
    dz0 = (d * g0 + dp * (z1 * g1 + z2 * g2 + z3 * g3)
           - 2.0 * (z1 * z1) * d * (d - 2.0 * a0 * a0) * g2)
    dz1 = d * g1 - 4.0 * a0 * d * z1 * g2
    ac = torch.tanh(zc)
    return torch.cat([dz0, dz1, d * g2, d * g3, (1.0 - ac * ac) * gc], 0)


def fused_step_math(params, u, B, L, x_max=math.pi, t_max=3.0, kappa=1.0):
    """One training step's loss and parameter gradients, in plain PyTorch.
    ``params`` = (w_in, b_in, w_hid [L,H,H], b_hid [L,H], w_out, b_out);
    ``u`` = [B, 2] uniforms. Returns (loss, grads_tuple)."""
    w_in, b_in, w_hid, b_hid, w_out, b_out = params
    X, x_interior = _stack_inputs(u, x_max, t_max)
    mask = _bias_mask(B, X)

    zs = [X @ w_in + mask * b_in]
    a = _act_fwd(zs[0], B)
    for l in range(L):
        zs.append(a @ w_hid[l] + mask * b_hid[l])
        a = _act_fwd(zs[-1], B)
    out = a @ w_out + mask * b_out

    u_xx = out[2 * B:3 * B]
    u_t = out[3 * B:4 * B]
    u0 = out[4 * B:5 * B]
    ub1 = out[5 * B:6 * B]
    ub2 = out[6 * B:]
    r = u_t - kappa * u_xx
    r0 = u0 - torch.sin(x_interior)
    loss = torch.mean(r * r + r0 * r0 + ub1 * ub1 + ub2 * ub2)

    s = 2.0 / B
    zeros = torch.zeros_like(r)
    G = torch.cat([zeros, zeros, -kappa * s * r, s * r, s * r0, s * ub1,
                   s * ub2], 0)

    d_w_out = _act_fwd(zs[L], B).T @ G
    d_b_out = torch.sum(mask * G, 0)
    g = G @ w_out.T
    d_w_hid, d_b_hid = [], []
    for l in range(L - 1, -1, -1):
        dz = _act_bwd(zs[l + 1], g, B)
        d_w_hid.append(_act_fwd(zs[l], B).T @ dz)
        d_b_hid.append(torch.sum(mask * dz, 0))
        g = dz @ w_hid[l].T
    d_w_hid = torch.stack(d_w_hid[::-1]) if L else torch.zeros_like(w_hid)
    d_b_hid = torch.stack(d_b_hid[::-1]) if L else torch.zeros_like(b_hid)
    dz = _act_bwd(zs[0], g, B)
    d_w_in = X.T @ dz
    d_b_in = torch.sum(mask * dz, 0)
    return loss, (d_w_in, d_b_in, d_w_hid, d_b_hid, d_w_out, d_b_out)


def adam_update(p, m, v, g, lr, t):
    """Adam with torch defaults; ``t`` is the 1-indexed global step as an
    fp32 tensor."""
    m = _B1 * m + (1.0 - _B1) * g
    v = _B2 * v + (1.0 - _B2) * (g * g)
    c1 = 1.0 - torch.exp(t * math.log(_B1))
    c2 = 1.0 - torch.exp(t * math.log(_B2))
    p = p - lr * (m / c1) / (torch.sqrt(v / c2) + _EPS)
    return p, m, v


# ---------------------------------------------------------------------------
# Flat parameter buffers
# ---------------------------------------------------------------------------


def param_shapes(model):
    D, H, L, O = (model.input_dim, model.hidden_size, model.num_layers,
                  model.output_dim)
    return [(D, H), (H,), (L, H, H), (L, H), (H, O), (O,)]


def pack_params(model) -> torch.Tensor:
    """The model's parameters as one flat fp32 buffer (a copy)."""
    return torch.cat([t.detach().reshape(-1) for t in _tensors(model)])


def unpack_params(model, flat):
    """Views of the six tensors inside a flat buffer."""
    out, at = [], 0
    for shape in param_shapes(model):
        n = math.prod(shape)
        out.append(flat[at:at + n].view(shape))
        at += n
    return tuple(out)


def load_params(model, flat) -> None:
    """Copy a flat buffer into the model's parameters."""
    with torch.no_grad():
        for dst, src in zip(_tensors(model), unpack_params(model, flat)):
            dst.copy_(src)


def _tensors(model):
    return (model.fc_in.w, model.fc_in.b, model.hidden.w, model.hidden.b,
            model.fc_out.w, model.fc_out.b)


def _check_model(model):
    if not isinstance(model, MLP) or model.activation != "tanh" \
            or model.input_dim != 2 or model.output_dim != 1:
        raise ValueError("the fused heat kernel trains plain tanh MLPs "
                         "2 → H×L → 1 only")


def _check_state(model, tensors):
    """Device, dtype, shape and contiguity of the flat state and uniforms."""
    n = sum(math.prod(s) for s in param_shapes(model))
    device = tensors["uniforms"].device
    for name, t in tensors.items():
        build.require_cuda_f32(name, t, None if name == "uniforms" else (n,))
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, uniforms on {device}")


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------


def heat_loss_grad_plain(model, params, u, x_max=math.pi, t_max=3.0,
                         kappa=1.0):
    """Plain version of :func:`heat_loss_grad`."""
    loss, grads = fused_step_math(unpack_params(model, params), u,
                                  u.shape[0], model.num_layers, x_max, t_max,
                                  kappa)
    return loss, torch.cat([g.reshape(-1) for g in grads])


def heat_loss_grad(model, params, u, x_max=math.pi, t_max=3.0, kappa=1.0):
    """One step's loss and flat gradient at flat ``params`` on ``[B, 2]``
    uniforms: the forward and backward launches of the training kernel
    without the Adam update. A CPU tensor takes the plain version."""
    _check_model(model)
    if u.device.type == "cpu":
        return heat_loss_grad_plain(model, params, u, x_max, t_max, kappa)
    _check_state(model, {"params": params, "uniforms": u})
    B, H, L = u.shape[0], model.hidden_size, model.num_layers
    lib = build.library()
    scratch = torch.empty(lib.heat_scratch_floats(B, H, L), device=u.device)
    grad = torch.empty_like(params)
    loss = torch.empty((), device=u.device)
    with torch.cuda.device(u.device):
        code = lib.heat_grad(params.data_ptr(), u.data_ptr(),
                             scratch.data_ptr(), grad.data_ptr(),
                             loss.data_ptr(), B, H, L, float(x_max),
                             float(t_max), float(kappa),
                             build.stream_ptr(u.device))
    build.check(code, "heat_grad")
    heat_loss_grad.launches += 1
    return loss, grad


heat_loss_grad.launches = 0


def heat_fused_train_chunk_plain(model, params, m, v, uniforms, step0,
                                 lrate, x_max=math.pi, t_max=3.0, kappa=1.0):
    """Plain version of :func:`heat_fused_train_chunk`."""
    K, B, _ = uniforms.shape
    losses = []
    for k in range(K):
        loss, g = heat_loss_grad_plain(model, params, uniforms[k], x_max,
                                       t_max, kappa)
        t = torch.tensor(step0 + k + 1, dtype=torch.float32,
                         device=params.device)
        params, m, v = adam_update(params, m, v, g, lrate, t)
        losses.append(loss)
    return params, m, v, torch.stack(losses)


def heat_fused_train_chunk(model, params, m, v, uniforms, step0, lrate,
                           x_max=math.pi, t_max=3.0, kappa=1.0,
                           batch_tile: int | None = None):
    """Run ``K = uniforms.shape[0]`` Adam steps. ``params``/``m``/``v`` are
    flat fp32 buffers; ``uniforms`` is [K, B, 2] of U[0,1) draws; ``step0``
    is the absolute index of the chunk's first step.

    ``batch_tile`` must divide B. Averaging equal tiles' gradients IS the
    full-batch gradient, so the kernel always computes the whole batch.

    Returns new (params, m, v, losses[K]); the inputs are left unchanged.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``heat_fused_train_chunk.launches`` counts the launches)."""
    _check_model(model)
    K, B, _ = uniforms.shape
    batch_tile = batch_tile or B
    if B % batch_tile:
        raise ValueError(f"batch {B} not divisible by batch_tile {batch_tile}")
    if uniforms.device.type == "cpu":
        return heat_fused_train_chunk_plain(model, params, m, v, uniforms,
                                            step0, lrate, x_max, t_max, kappa)
    _check_state(model, {"params": params, "m": m, "v": v,
                         "uniforms": uniforms})
    H, L = model.hidden_size, model.num_layers
    p, m, v = params.clone(), m.clone(), v.clone()
    lib = build.library()
    scratch = torch.empty(lib.heat_scratch_floats(B, H, L),
                          device=uniforms.device)
    losses = torch.empty(K, device=uniforms.device)
    with torch.cuda.device(uniforms.device):
        code = lib.heat_train(p.data_ptr(), m.data_ptr(), v.data_ptr(),
                              uniforms.data_ptr(), scratch.data_ptr(),
                              losses.data_ptr(), K, B, H, L,
                              float(x_max), float(t_max), float(kappa),
                              float(lrate), int(step0),
                              build.stream_ptr(uniforms.device))
    build.check(code, "heat_train")
    heat_fused_train_chunk.launches += 1
    return p, m, v, losses


heat_fused_train_chunk.launches = 0


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; raises if it names CUDA and there is
    no GPU (the CPU runs only when a caller asks for it)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; the port runs on "
                           "the GPU (pass device='cpu' to run the plain "
                           "PyTorch versions)")
    return device


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_heat_fused_result(problem, seed, iterations, batch_size=64,
                            lrate=1e-4, chunk_size=25_000, model=None,
                            precision="highest", device="cuda"):
    """Train the heat equation with the fused kernel; returns a TrainResult.

    ``model`` (default: ``problem.default_model()`` initialised from
    ``seed``) is trained in place and returned as ``params``. Step ``i``
    draws its collocation points from ``(seed, i)`` alone, so the chunk
    layout cannot change the run.

    ``compile_time`` is the kernel build plus one warm-up step on copies of
    the state; ``wall_time`` and ``iters_per_sec`` cover the training steps
    only, ending in ``torch.cuda.synchronize()``."""
    if precision in ("default", "mixed"):
        raise NotImplementedError(_PRECISION_TODO.format(precision))
    if precision != "highest":
        raise ValueError(f"unknown precision {precision!r}")
    device = resolve_device(device)
    if model is None:
        model = problem.default_model(generator=generator(seed))
    model.to(device)
    _check_model(model)
    kw = dict(x_max=problem.x_max, t_max=problem.t_max, kappa=problem.kappa)
    p = pack_params(model)
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)

    t0 = time.perf_counter()
    heat_fused_train_chunk(model, p, m, v,
                           step_uniforms(seed, 0, 1, batch_size, device), 0,
                           lrate, **kw)
    _sync(device)
    compile_time = time.perf_counter() - t0

    chunk = max(1, min(chunk_size, iterations))
    losses = []
    done = 0
    t0 = time.perf_counter()
    while done < iterations:
        k = min(chunk, iterations - done)
        u = step_uniforms(seed, done, k, batch_size, device)
        p, m, v, chunk_losses = heat_fused_train_chunk(model, p, m, v, u,
                                                       done, lrate, **kw)
        losses.append(chunk_losses)
        done += k
    _sync(device)
    wall = time.perf_counter() - t0
    load_params(model, p)
    return TrainResult(
        params=model,
        opt_state={"m": m, "v": v},
        loss_history=torch.cat(losses).cpu().numpy(),
        wall_time=wall,
        iters_per_sec=iterations / wall if wall else float("inf"),
        compile_time=compile_time,
    )
