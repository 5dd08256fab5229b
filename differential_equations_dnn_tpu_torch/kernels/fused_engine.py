"""The generic fused engine: K Adam steps of any stream spec per kernel call
(csrc/engine_train.cu).

Counterpart of the JAX package's kernels/fused_engine.py. A **stream spec**
describes one equation's training step:

* ``groups`` — the stream layout: each group is one network-input block of
  B rows (an interior batch, an IC face, a boundary edge, ...) carrying a
  value stream, ``n_second`` (first, second)-derivative Taylor pairs and
  ``n_first`` first-only tangents;
* ``build(u)`` — the stacked input rows ``[R·B, D]`` from the step's
  ``[B, n_uniform]`` uniforms, plus the columns the loss needs;
* ``loss(outs, ctx)`` — the equation's residual loss over the R stream
  outputs, as a ``[1, 1]`` value.

``engine_step_math`` is the plain PyTorch version of one step: the
group-generic Taylor forward, the loss cotangent from ``torch.func.vjp`` of
the spec's loss, and the hand-derived backward. In the CUDA kernel the same
step runs with ``build`` and the loss cotangent written out by hand for each
spec (selected by ``kernel_id``, with ``kernel_consts`` as its numbers).

A spec may also declare (with the defaults of :class:`_Spec`):

* ``extra_shapes`` — extra trainable tensors appended to the flat state
  after the six MLP tensors (inverse_heat's log κ̂); the loss reads them as
  ``ctx["extras"]`` and their gradient comes through the same vjp;
* ``make_const(B)`` / ``const_shape(B)`` — the const operand the step reads
  (volterra's nodes, inverse_heat's observations), one buffer per call
  shared by every replica; ``build_with_const`` hands it to ``build``;
* ``dims`` / ``tensors`` / ``supports_model`` — the model's engine view: a
  plain tanh MLP by default, uat's Perceptron at L = 0 (no hidden tensors
  in the flat state), inverse_heat's net and κ̂;
* ``fold`` — value-only groups the kernels lay out as one stream of
  ``fold``·B rows (volterra's 1 + k), so that they tile R = 1 rows.

Ported specs: simple_ode, heat, burgers, wave, advection (causal too:
its ``[B, B]`` weighting in a cross-point loss kernel), poisson, heat2d, volterra (Gauss rule), uat and inverse_heat, and the
hard-constraint specs of simple_ode, heat, heat2d, wave and poisson
(``HARD_SPECS``: the raw net of a models.hard.HardConstraint, interior rows
only, the ansatz derivatives composed in the loss), as single runs
(``fused_engine_chunk``, ``train_fused_result``) and as packed-replica
ensembles (``fused_engine_packed_chunk``, ``train_fused_ensemble_packed``),
each at ``precision`` "highest" (exact fp32) or "default" (the products the
JAX step math gives ``precision`` take bf16 operands and accumulate in fp32;
products it pins to HIGHEST or leaves without one, such as volterra's node
sums, inverse_heat's observation rows and causal advection's ``earlier @
r``, stay fp32), and the trainers at "mixed" too (core/precision.py).
The sweep mode (``runtime_bs``, ``runtime_steps``, ``trial_horizon``;
per-slot values in a packed call) serves the sweep evaluators
(``make_lr_evaluator``, ``make_sweep_evaluator``,
``make_packed_rung_evaluator``, ``lr_sweep``; sweep/search.py).

On the card a chunk replays a CUDA graph of GRAPH_STEPS training steps,
captured on the first call of its shape and cached (kernels/graphs.py), as
the DGM engine's chunks do; the steps left over run as the same launches.
The kernels stage every operand in k-tiles, so they take any hidden width
up to MAX_WIDTH (:func:`engine_plan`).
"""

import ctypes
import math
from dataclasses import dataclass

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.core.precision import (
    check_precision,
    default_steps,
    matmul,
)
from differential_equations_dnn_tpu_torch.core.prng import (
    generator,
    replica_generator,
    step_uniforms,
)
from differential_equations_dnn_tpu_torch.equations.inverse_heat import (
    _InverseModel,
    pick_rows,
)
from differential_equations_dnn_tpu_torch.kernels import build
from differential_equations_dnn_tpu_torch.kernels import engine_core
from differential_equations_dnn_tpu_torch.kernels import graphs
from differential_equations_dnn_tpu_torch.kernels.graphs import (  # noqa: F401
    GRAPH_STEPS,
    clear_graphs,
)
from differential_equations_dnn_tpu_torch.kernels.engine_core import (
    check_batch_tile,
)
from differential_equations_dnn_tpu_torch.kernels.fused_train import (
    CHUNK_PRECISIONS,
    count_launch,
    replica_models,
    train_ensemble,
    train_in_chunks,
)
from differential_equations_dnn_tpu_torch.models import (
    MLP,
    HardConstraint,
    Perceptron,
)
from differential_equations_dnn_tpu_torch.ops.sampling import (
    coprime_stride as _coprime_stride,
)
from differential_equations_dnn_tpu_torch.ops.sampling import stride_strata
from differential_equations_dnn_tpu_torch.utils import trace

_N_CONSTS = 8  # floats of kernel_consts the CUDA specs read
# The most groups a spec may fold (csrc/engine_train.cu kMaxFold: a point's
# outputs in 48 KB of shared memory), and the thread groups over which the
# weight gradients take a folded spec's groups (kFoldGroups).
MAX_FOLD = 48 * 1024 // 4
FOLD_GROUPS = 8
# The largest batch of causal advection's loss kernel (csrc/engine_train.cu
# kCausalMaxBatch): six floats a point in 48 KB of shared memory.
CAUSAL_MAX_BATCH = 48 * 1024 // (6 * 4)

# The widest hidden width the plan holds (csrc/stream_layer.cuh).
MAX_WIDTH = engine_core.MAX_WIDTH

# ---------------------------------------------------------------------------
# Stream layout: groups of (value + Taylor pairs + first-only tangents)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Group:
    """One network-input block of B rows in the stacked operand. Row order
    within the group: value, then (first, second) per Taylor pair, then the
    first-only tangents."""
    n_second: int = 0
    n_first: int = 0

    @property
    def n_rows(self):
        return 1 + 2 * self.n_second + self.n_first


def _n_rows(groups):
    return sum(g.n_rows for g in groups)


def _bias_mask(groups, B, like):
    """Value streams receive the bias; tangent streams do not."""
    parts = []
    for g in groups:
        parts.append(like.new_ones((B, 1)))
        parts.append(like.new_zeros(((g.n_rows - 1) * B, 1)))
    return torch.cat(parts, 0)


def _act_fwd(groups, z, B):
    """tanh on value streams, Taylor rules on tangents (per group state)."""
    outs = []
    off = 0
    for g in groups:
        a0 = torch.tanh(z[off * B:(off + 1) * B])
        d = 1.0 - a0 * a0
        outs.append(a0)
        cur = off + 1
        for _ in range(g.n_second):
            z1 = z[cur * B:(cur + 1) * B]
            z2 = z[(cur + 1) * B:(cur + 2) * B]
            outs.append(d * z1)
            outs.append(d * z2 - 2.0 * a0 * d * (z1 * z1))
            cur += 2
        for _ in range(g.n_first):
            outs.append(d * z[cur * B:(cur + 1) * B])
            cur += 1
        off += g.n_rows
    return torch.cat(outs, 0)


def _act_bwd(groups, z, gr, B):
    """VJP of :func:`_act_fwd`. With a0 = tanh(z0), d = 1 − a0²,
    d' = −2·a0·d, the per-group rules are

      dz0 = d·g0 + d'·Σ(z_t·g_t over all tangents)
                 − Σ_pairs 2·z1²·d·(d − 2a0²)·g2
      dz1 = d·g1 − 4·a0·d·z1·g2          (pair firsts)
      dz2 = d·g2                          (pair seconds)
      dzf = d·gf                          (first-only tangents)
    """
    outs = []
    off = 0
    for g in groups:
        z0 = z[off * B:(off + 1) * B]
        g0 = gr[off * B:(off + 1) * B]
        a0 = torch.tanh(z0)
        d = 1.0 - a0 * a0
        dp = -2.0 * a0 * d
        dz0 = d * g0
        tail = []
        cur = off + 1
        for _ in range(g.n_second):
            z1 = z[cur * B:(cur + 1) * B]
            z2 = z[(cur + 1) * B:(cur + 2) * B]
            g1 = gr[cur * B:(cur + 1) * B]
            g2 = gr[(cur + 1) * B:(cur + 2) * B]
            dz0 = (dz0 + dp * (z1 * g1 + z2 * g2)
                   - 2.0 * (z1 * z1) * d * (d - 2.0 * a0 * a0) * g2)
            tail.append(d * g1 - 4.0 * a0 * d * z1 * g2)
            tail.append(d * g2)
            cur += 2
        for _ in range(g.n_first):
            zf = z[cur * B:(cur + 1) * B]
            gf = gr[cur * B:(cur + 1) * B]
            dz0 = dz0 + dp * (zf * gf)
            tail.append(d * gf)
            cur += 1
        outs.append(dz0)
        outs.extend(tail)
        off += g.n_rows
    return torch.cat(outs, 0)


# ---------------------------------------------------------------------------
# Generic step math (the plain version of the kernel's step)
# ---------------------------------------------------------------------------


def engine_step_math(spec, params, u, B, L, const=None,
                     precision="highest", batch_mask=None, inv_bs=None):
    """One training step's loss ``[1, 1]`` and parameter gradients for any
    stream spec. ``params`` = (w_in, b_in, w_hid, b_hid, w_out, b_out) and
    the spec's extra tensors; ``u`` = [B, spec.n_uniform] U[0,1) draws;
    ``const`` = the spec's const operand (None: built by ``make_const``);
    ``precision`` ("highest" | "default") that of the layer products, the
    ones the JAX step math gives it (the spec's loss keeps its own fp32
    products); ``batch_mask`` [B, 1] and ``inv_bs`` the sweep mode's row
    mask (:func:`_smean`). Returns (loss, grads_tuple), the extras'
    gradients last."""
    groups = spec.groups
    w_in, b_in, w_hid, b_hid, w_out, b_out = params[:6]
    extras = tuple(params[6:])

    def mm(a, b):
        return matmul(a, b, precision)

    if const is None:
        const = spec.make_const(B, u.device)
    if spec.build_with_const:
        X, ctx = spec.build(u, const)
    elif spec.masked_build:
        X, ctx = spec.build(u, batch_mask)
    else:
        X, ctx = spec.build(u)
    if const is not None:
        ctx = {**ctx, "const": const}
    if batch_mask is not None:
        ctx = {**ctx, "mask": batch_mask, "inv_bs": inv_bs}
    mask = _bias_mask(groups, B, X)

    zs = [mm(X, w_in) + mask * b_in]
    a = _act_fwd(groups, zs[0], B)
    for l in range(L):
        zs.append(mm(a, w_hid[l]) + mask * b_hid[l])
        a = _act_fwd(groups, zs[-1], B)
    out = mm(a, w_out) + mask * b_out

    outs = tuple(out[k * B:(k + 1) * B] for k in range(_n_rows(groups)))
    # The cotangent w.r.t. the stream outputs, from autodiff of the spec's
    # small elementwise loss (the kernel writes it out by hand per spec).
    # Extra trainable tensors ride the same vjp: they enter the loss only.
    if extras:
        loss, vjp_fn = torch.func.vjp(
            lambda o, e: spec.loss(o, {**ctx, "extras": e}), outs, extras)
        gouts, gextras = vjp_fn(torch.ones_like(loss))
    else:
        loss, vjp_fn = torch.func.vjp(lambda *o: spec.loss(o, ctx), *outs)
        gouts, gextras = vjp_fn(torch.ones_like(loss)), ()
    G = torch.cat(gouts, 0)

    d_w_out = mm(_act_fwd(groups, zs[L], B).T, G)
    d_b_out = torch.sum(mask * G, 0)
    g = mm(G, w_out.T)
    d_w_hid, d_b_hid = [], []
    for l in range(L - 1, -1, -1):
        dz = _act_bwd(groups, zs[l + 1], g, B)
        d_w_hid.append(mm(_act_fwd(groups, zs[l], B).T, dz))
        d_b_hid.append(torch.sum(mask * dz, 0))
        g = mm(dz, w_hid[l].T)
    d_w_hid = torch.stack(d_w_hid[::-1]) if L else torch.zeros_like(w_hid)
    d_b_hid = torch.stack(d_b_hid[::-1]) if L else torch.zeros_like(b_hid)
    dz = _act_bwd(groups, zs[0], g, B)
    d_w_in = mm(X.T, dz)
    d_b_in = torch.sum(mask * dz, 0)
    return loss, (d_w_in, d_b_in, d_w_hid, d_b_hid, d_w_out,
                  d_b_out) + tuple(gextras)


# ---------------------------------------------------------------------------
# Equation specs
# ---------------------------------------------------------------------------


def _cat(*cols):
    return torch.cat(cols, 1)


class _Spec:
    """What a spec declares unless it says otherwise: the engine view of a
    plain tanh MLP D → H×L → 1 (L ≥ 1) as the six state tensors, no extra
    trainable tensor, no const operand, and one kernel stream per row of
    its groups."""
    extra_shapes = ()
    build_with_const = False
    masked_build = False  # build(u, batch_mask): uat's grid over bs rows
    causal = False  # a cross-point loss (causal advection's weighting)
    fold = 1  # groups laid out as one value stream (volterra: 1 + k)
    model_text = "a plain tanh MLP {D} → H×L → 1 (L ≥ 1)"

    @property
    def kernel_streams(self):
        """The streams the CUDA kernels tile (R, or 1 when folded)."""
        return _n_rows(self.groups)

    @property
    def weight_groups(self):
        """The thread groups of the weight gradients' blocks (one per
        stream; a folded spec's groups FOLD_GROUPS at a time)."""
        return FOLD_GROUPS if self.fold > 1 else self.kernel_streams

    def const_shape(self, B):
        return None

    def make_const(self, B, device=None):
        return None

    def batch_consts(self, B):
        """The numbers of the kernel's spec that depend on the batch size,
        after ``kernel_consts()``."""
        return ()

    def supports_model(self, model):
        # A plain MLP: BatchNorm and Fourier features are other networks,
        # which the engine's streams do not compute.
        return (isinstance(model, MLP) and model.plain
                and model.activation == "tanh"
                and model.input_dim == self.input_dim
                and model.output_dim == 1 and model.num_layers >= 1)

    def dims(self, model):
        """(D, H, L) of the model's engine view."""
        return model.input_dim, model.hidden_size, model.num_layers

    def tensors(self, model):
        """The trainable tensors in flat-state order."""
        return (model.fc_in.w, model.fc_in.b, model.hidden.w, model.hidden.b,
                model.fc_out.w, model.fc_out.b)


def _ksum(q):
    """[B, C] → [1, 1] sum."""
    return torch.sum(torch.sum(q, 0, keepdim=True), 1, keepdim=True)


def _smean(q, ctx=None):
    """Batch mean of a pointwise [B, 1] quantity as a [1, 1] value; under
    the sweep mode's batch mask (``ctx["mask"]`` [B, 1], ``ctx["inv_bs"]``)
    the masked sum over the bs live rows times 1/bs."""
    mask = None if ctx is None else ctx.get("mask")
    if mask is not None:
        return _ksum(q * mask) * ctx["inv_bs"]
    return _ksum(q) * (1.0 / (q.shape[0] * q.shape[1]))


@dataclass(frozen=True)
class SimpleODESpec(_Spec):
    """dy/dt = −y, y(0) = y_ic (equations.simple_ode)."""
    p: object
    n_uniform: int = 1
    input_dim = 1
    kernel_id = 0
    groups = (Group(n_first=1), Group())  # interior (v, t'), t=0 face

    def kernel_consts(self):
        return (self.p.sample_scale * self.p.t_max, self.p.y_ic)

    def build(self, u):
        t = (self.p.sample_scale * self.p.t_max) * u[:, :1]
        X = torch.cat([t, torch.ones_like(t), torch.zeros_like(t)], 0)
        return X, {}

    def loss(self, outs, ctx):
        y, dydt, y0 = outs
        return _smean(torch.square(dydt + y)
                      + torch.square(y0 - self.p.y_ic), ctx)


@dataclass(frozen=True)
class HeatSpec(_Spec):
    """u_t = κ·u_xx (equations.heat)."""
    p: object
    n_uniform: int = 2
    input_dim = 2
    kernel_id = 1
    groups = (Group(n_second=1, n_first=1),  # interior: v, (x', x''), t'
              Group(), Group(), Group())     # IC, x=0, x=x_max

    def kernel_consts(self):
        return (self.p.x_max, self.p.t_max, self.p.kappa)

    def build(self, u):
        x = self.p.x_max * u[:, :1]
        t = self.p.t_max * u[:, 1:2]
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        xmax = torch.full_like(x, self.p.x_max)
        X = torch.cat([
            _cat(x, t), _cat(one, zero), _cat(zero, zero), _cat(zero, one),
            _cat(x, zero), _cat(zero, t), _cat(xmax, t),
        ], 0)
        return X, {"x": x}

    def loss(self, outs, ctx):
        u_, u_x, u_xx, u_t, u0, ub1, ub2 = outs
        r = u_t - self.p.kappa * u_xx
        r0 = u0 - torch.sin(ctx["x"])
        return _smean(torch.square(r) + torch.square(r0)
                      + torch.square(ub1) + torch.square(ub2), ctx)


@dataclass(frozen=True)
class AdvectionSpec(_Spec):
    """u_t + c·u_x = 0 (equations.advection): first-order transport, R = 5.
    With ``causal_eps > 0`` row i's t lies in stratum (i·m) mod B
    (ops.stride_strata: every prefix of rows spreads over [0, t_max]), and
    the loss weights the interior residual energies r by exp(−ε·cum),
    cum = Δt·Σ_{t_j < t_i} r_j (strict: equal t do not count), without
    gradient: the JAX package's [B, B] comparison-mask product. The kernel
    is its own (kernel id 15): a loss kernel across the batch."""
    p: object
    n_uniform: int = 2
    input_dim = 2
    groups = (Group(n_first=2),    # interior: v, x-tangent, t-tangent
              Group(), Group())    # t=0 face, inflow x=0

    @property
    def causal(self):
        return self.p.causal_eps > 0.0

    @property
    def kernel_id(self):
        return 15 if self.causal else 4

    def kernel_consts(self):
        p = self.p
        return ((p.x_max, p.t_max, p.c, -p.c)
                + ((p.causal_eps,) if self.causal else ()))

    def batch_consts(self, B):
        if not self.causal:
            return ()
        return (self.p.t_max / B, _coprime_stride(B))

    def build(self, u):
        x = self.p.x_max * u[:, :1]
        if self.causal:
            B = u.shape[0]
            t = (stride_strata(B, u.device) + u[:, 1:2]) * (self.p.t_max / B)
        else:
            t = self.p.t_max * u[:, 1:2]
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        X = torch.cat([
            _cat(x, t), _cat(one, zero), _cat(zero, one),
            _cat(x, zero), _cat(zero, t),
        ], 0)
        return X, {"x": x, "t": t}

    def loss(self, outs, ctx):
        u_, u_x, u_t, u0, ub = outs
        r = torch.square(u_t + self.p.c * u_x)
        icbc = (torch.square(u0 - torch.sin(ctx["x"]))
                + torch.square(ub - torch.sin(-self.p.c * ctx["t"])))
        if not self.causal or ctx.get("mask") is not None:
            # Under a batch mask the plain loss, as the JAX spec's masked
            # branch: the causal weighting is a single-run protocol.
            return _smean(r + icbc, ctx)
        t = ctx["t"]                                    # [B, 1]
        earlier = (t.T < t).to(r.dtype)                 # [B, B]
        cum = (earlier @ r.detach()) * (self.p.t_max / r.shape[0])
        wgt = torch.exp(-self.p.causal_eps * cum).detach()
        return _smean(wgt * r, ctx) + _smean(icbc, ctx)


@dataclass(frozen=True)
class BurgersSpec(_Spec):
    """u_t + u·u_x = ν·u_xx (equations.burgers): the value stream itself
    enters the domain residual."""
    p: object
    n_uniform: int = 2
    input_dim = 2
    kernel_id = 2
    groups = (Group(n_second=1, n_first=1), Group(), Group(), Group())

    def kernel_consts(self):
        p = self.p
        return (p.x_max, p.t_max, p.nu, p.wave_amp, p.wave_speed, p.x0,
                2.0 * p.nu)

    def build(self, u):
        x = self.p.x_max * u[:, :1]
        t = self.p.t_max * u[:, 1:2]
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        xmax = torch.full_like(x, self.p.x_max)
        X = torch.cat([
            _cat(x, t), _cat(one, zero), _cat(zero, zero), _cat(zero, one),
            _cat(x, zero), _cat(zero, t), _cat(xmax, t),
        ], 0)
        return X, {"x": x, "t": t}

    def loss(self, outs, ctx):
        u_, u_x, u_xx, u_t, u_ic, ub0, ub1 = outs
        x, t = ctx["x"], ctx["t"]
        zero = torch.zeros_like(x)
        xmax = torch.full_like(x, self.p.x_max)
        r = u_t + u_ * u_x - self.p.nu * u_xx
        r_ic = u_ic - self.p._exact_fn(x, zero)
        r_b0 = ub0 - self.p._exact_fn(zero, t)
        r_b1 = ub1 - self.p._exact_fn(xmax, t)
        return _smean(torch.square(r) + torch.square(r_ic)
                      + torch.square(r_b0) + torch.square(r_b1), ctx)


@dataclass(frozen=True)
class WaveSpec(_Spec):
    """u_tt = c²·u_xx with a velocity IC (equations.wave): the t=0 face
    carries its own first-order time tangent."""
    p: object
    n_uniform: int = 2
    input_dim = 2
    kernel_id = 3
    groups = (Group(n_second=2),            # interior: v, (x',x''), (t',t'')
              Group(n_first=1),             # t=0 face: v, t' (velocity IC)
              Group(), Group())             # x=0, x=x_max

    def kernel_consts(self):
        return (self.p.x_max, self.p.t_max, self.p.c ** 2,
                self.p.velocity_weight)

    def build(self, u):
        x = self.p.x_max * u[:, :1]
        t = self.p.t_max * u[:, 1:2]
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        xmax = torch.full_like(x, self.p.x_max)
        X = torch.cat([
            _cat(x, t), _cat(one, zero), _cat(zero, zero),
            _cat(zero, one), _cat(zero, zero),
            _cat(x, zero), _cat(zero, one),
            _cat(zero, t), _cat(xmax, t),
        ], 0)
        return X, {"x": x}

    def loss(self, outs, ctx):
        u_, u_x, u_xx, u_t, u_tt, u0, u0_t, ub1, ub2 = outs
        r = u_tt - (self.p.c ** 2) * u_xx
        r_pos = u0 - torch.sin(ctx["x"])
        return _smean(torch.square(r) + torch.square(r_pos)
                      + self.p.velocity_weight * torch.square(u0_t)
                      + torch.square(ub1) + torch.square(ub2), ctx)


@dataclass(frozen=True)
class PoissonSpec(_Spec):
    """−Δu = f, elliptic BVP (equations.poisson): no time axis."""
    p: object
    n_uniform: int = 3
    input_dim = 2
    kernel_id = 5
    groups = (Group(n_second=2),                       # interior Laplacian
              Group(), Group(), Group(), Group())      # 4 boundary faces

    def kernel_consts(self):
        return (self.p.x_max,)

    def build(self, u):
        x = self.p.x_max * u[:, :1]
        y = self.p.x_max * u[:, 1:2]
        e = self.p.x_max * u[:, 2:3]
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        xmax = torch.full_like(x, self.p.x_max)
        X = torch.cat([
            _cat(x, y), _cat(one, zero), _cat(zero, zero),
            _cat(zero, one), _cat(zero, zero),
            _cat(zero, e), _cat(xmax, e), _cat(e, zero), _cat(e, xmax),
        ], 0)
        return X, {"x": x, "y": y}

    def loss(self, outs, ctx):
        u_, u_x, u_xx, u_y, u_yy, b1, b2, b3, b4 = outs
        src = 2.0 * torch.sin(ctx["x"]) * torch.sin(ctx["y"])
        r = -(u_xx + u_yy) - src
        return _smean(torch.square(r) + torch.square(b1) + torch.square(b2)
                      + torch.square(b3) + torch.square(b4), ctx)


@dataclass(frozen=True)
class Heat2DSpec(_Spec):
    """u_t = κ·(u_xx + u_yy) (equations.heat2d): 11 streams, D = 3."""
    p: object
    n_uniform: int = 4
    input_dim = 3
    kernel_id = 6
    groups = (Group(n_second=2, n_first=1),            # interior
              Group(),                                 # t=0 face
              Group(), Group(), Group(), Group())      # 4 boundary faces

    def kernel_consts(self):
        return (self.p.x_max, self.p.t_max, self.p.kappa)

    def build(self, u):
        x = self.p.x_max * u[:, :1]
        y = self.p.x_max * u[:, 1:2]
        t = self.p.t_max * u[:, 2:3]
        e = self.p.x_max * u[:, 3:4]
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        xmax = torch.full_like(x, self.p.x_max)
        X = torch.cat([
            _cat(x, y, t),
            _cat(one, zero, zero), _cat(zero, zero, zero),
            _cat(zero, one, zero), _cat(zero, zero, zero),
            _cat(zero, zero, one),
            _cat(x, y, zero),
            _cat(zero, e, t), _cat(xmax, e, t),
            _cat(e, zero, t), _cat(e, xmax, t),
        ], 0)
        return X, {"x": x, "y": y}

    def loss(self, outs, ctx):
        u_, u_x, u_xx, u_y, u_yy, u_t, u0, b1, b2, b3, b4 = outs
        r = u_t - self.p.kappa * (u_xx + u_yy)
        r0 = u0 - torch.sin(ctx["x"]) * torch.sin(ctx["y"])
        return _smean(torch.square(r) + torch.square(r0) + torch.square(b1)
                      + torch.square(b2) + torch.square(b3)
                      + torch.square(b4), ctx)


@dataclass(frozen=True)
class VolterraSpec(_Spec):
    """Volterra II integral equation with the rescaled k-node Gauss rule
    (equations.volterra): 1 + k value-only groups, the collocation batch x
    and one group per node at x·c_j. The const operand ``[k, 2]`` holds c_j
    and (c_j − 1)·w_j, computed on the host in double as the JAX package's
    ``VolterraSpec._nodes``; the loss sums each point's nodes directly (the
    JAX kernel's selection matrix existed because Mosaic cannot gather)."""
    p: object
    n_uniform: int = 1
    input_dim = 1
    kernel_id = 7
    build_with_const = True
    kernel_streams = 1

    @property
    def groups(self):
        return tuple(Group() for _ in range(1 + self.p.k))

    @property
    def fold(self):
        return 1 + self.p.k

    def kernel_consts(self):
        return (self.p.upper,)

    def const_shape(self, B):
        return (self.p.k, 2)

    def make_const(self, B, device=None):
        u, w = np.polynomial.legendre.leggauss(self.p.k)
        c = (u + 1.0) * 0.5
        coef = (c - 1.0) * (w * 0.5)
        return torch.tensor(np.stack([c, coef], 1), dtype=torch.float32,
                            device=device)

    def build(self, u, const):
        x = self.p.upper * u[:, :1]
        nodes = (x * const[None, :, 0]).T.reshape(-1, 1)  # row j·B + b
        return torch.cat([x, nodes], 0), {"x": x}

    def loss(self, outs, ctx):
        x = ctx["x"]
        # ∫₀ˣ (t − x)·y(t) dt ≈ Σ_j (x·c_j − x)·y_j·(x·w_j)
        #                   = x²·Σ_j (c_j − 1)·w_j·y_j.
        acc = torch.sum(torch.cat(outs[1:], 1) * ctx["const"][None, :, 1],
                        1, keepdim=True)
        r = outs[0] - x - (x * x) * acc
        return _smean(torch.square(r), ctx)


@dataclass(frozen=True)
class UATSpec(_Spec):
    """Universal-approximation demo (equations.uat): full-batch MSE fit of
    sin(freq·x) on the B-point grid x_b = low + (high − low)·b/(B − 1),
    one value-only group; the draws are read for their shape only. Under a
    batch mask the grid spans the bs live rows, b/(bs − 1), so a trial of
    batch bs fits the whole interval (the JAX spec's grid spans the tile,
    fused_engine.py:908-915 of the JAX package). Trains
    the reference's Perceptron 1 → H → 1 as the engine's L = 0 layout, its
    flat state the input and output layers alone (the JAX kernel carries
    zero hidden tensors, which Adam leaves at zero)."""
    p: object
    n_uniform: int = 1
    input_dim = 1
    kernel_id = 8
    groups = (Group(),)
    masked_build = True
    model_text = "a Perceptron 1 → H → 1"

    def kernel_consts(self):
        return (self.p.low, self.p.high - self.p.low, self.p.freq)

    def build(self, u, batch_mask=None):
        B = u.shape[0]
        i = torch.arange(B, dtype=torch.float32, device=u.device)[:, None]
        if batch_mask is None:
            span = max(B - 1, 1)
        else:  # the bs live rows, as an fp32 value
            span = torch.clamp_min(torch.sum(batch_mask) - 1.0, 1.0)
        x = self.p.low + (self.p.high - self.p.low) * i / span
        return x, {"x": x}

    def loss(self, outs, ctx):
        return _smean(torch.square(outs[0]
                                   - torch.sin(self.p.freq * ctx["x"])), ctx)

    def supports_model(self, model):
        return (isinstance(model, Perceptron) and model.input_dim == 1
                and model.output_dim == 1)

    def dims(self, model):
        return model.input_dim, model.hidden_size, 0

    def tensors(self, model):
        H, w = model.hidden_size, model.fc1.w
        return (w, model.fc1.b, w.new_zeros((0, H, H)), w.new_zeros((0, H)),
                model.fc2.w, model.fc2.b)


@dataclass(frozen=True)
class InverseHeatSpec(_Spec):
    """Inverse heat problem (equations.inverse_heat): the solution MLP and
    log κ̂, an extra [1, 1] state tensor Adam-updated with the rest, its
    gradient through the loss vjp (the residual u_t − exp(log κ̂)·u_xx).
    Streams: interior value + (x', x'') pair + t' tangent, and one value
    group for the observation rows, picked from the const ``[n_obs, 3]``
    (x, t, u_obs) by floor(u·n_obs) of the third draw."""
    p: object
    n_uniform: int = 3
    input_dim = 2
    kernel_id = 9
    groups = (Group(n_second=1, n_first=1),  # interior: v, (x', x''), t'
              Group())                       # observation rows
    extra_shapes = ((1, 1),)                 # log κ̂
    build_with_const = True
    model_text = "an _InverseModel of a plain tanh MLP {D} → H×L → 1 (L ≥ 1)"

    def kernel_consts(self):
        p = self.p
        return (p.x_max, p.t_max, p.data_weight, p.n_obs)

    def const_shape(self, B):
        return (self.p.n_obs, 3)

    def make_const(self, B, device=None):
        return torch.cat(self.p.observations(device), 1)

    def build(self, u, const):
        x = self.p.x_max * u[:, :1]
        t = self.p.t_max * u[:, 1:2]
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        obs = pick_rows(const, u[:, 2:3])
        X = torch.cat([
            _cat(x, t), _cat(one, zero), _cat(zero, zero), _cat(zero, one),
            obs[:, :2],
        ], 0)
        return X, {"obs_u": obs[:, 2:3]}

    def loss(self, outs, ctx):
        u_, u_x, u_xx, u_t, y_obs = outs
        kappa = torch.exp(ctx["extras"][0])  # [1, 1]
        r = u_t - kappa * u_xx
        d = y_obs - ctx["obs_u"]
        return _smean(torch.square(r)
                      + self.p.data_weight * torch.square(d), ctx)

    def supports_model(self, model):
        return (isinstance(model, _InverseModel)
                and super().supports_model(model.net))

    def dims(self, model):
        return super().dims(model.net)

    def tensors(self, model):
        return super().tensors(model.net) + (model.log_kappa,)


# ---------------------------------------------------------------------------
# Hard-constraint specs (models/hard.py): interior rows only
# ---------------------------------------------------------------------------


class _HardSpec(_Spec):
    """A hard-constraint spec trains the raw net N of the problem's
    HardConstraint u = A + D·N (its default ansatz, compared by tag) and
    composes the analytic derivatives of A and D with N's streams in its
    loss: the constraints hold exactly, so only the interior group remains.
    The flat state is the raw net's six tensors; ``scale`` (D's
    normalisation, computed in double as models/hard.py does) is one of the
    kernel's numbers."""
    model_text = ("a HardConstraint of the problem's own ansatz around a "
                  "plain tanh MLP {D} → H×L → 1 (L ≥ 1)")

    def supports_model(self, model):
        return (isinstance(model, HardConstraint)
                and getattr(model.ansatz, "tag", None)
                == self.p.hard_ansatz().tag
                and super().supports_model(model.net))

    def dims(self, model):
        return super().dims(model.net)

    def tensors(self, model):
        return super().tensors(model.net)


@dataclass(frozen=True)
class HardSimpleODESpec(_HardSpec):
    """simple_ode with y = y_ic + (t/t_max)·N (time_ic_ansatz): R = 2
    streams against the soft spec's 3. Residual y' + y with y' = N/t_max +
    (t/t_max)·N_t."""
    p: object
    n_uniform: int = 1
    input_dim = 1
    kernel_id = 10
    groups = (Group(n_first=1),)   # N, N_t

    def kernel_consts(self):
        p = self.p
        return (p.sample_scale * p.t_max, p.t_max, p.y_ic)

    def build(self, u):
        t = (self.p.sample_scale * self.p.t_max) * u[:, :1]
        return torch.cat([t, torch.ones_like(t)], 0), {"t": t}

    def loss(self, outs, ctx):
        n, n_t = outs
        p = self.p
        t = ctx["t"]
        y = p.y_ic + (t / p.t_max) * n
        dydt = n / p.t_max + (t / p.t_max) * n_t
        return _smean(torch.square(dydt + y), ctx)


@dataclass(frozen=True)
class HardHeatSpec(_HardSpec):
    """Heat with u = sin(x) + D·N, D = t·x·(x_max−x)/scale
    (heat1d_ansatz): R = 4 streams against the soft spec's 7, with

        u_t  = D_t·N + D·N_t
        u_xx = −sin(x) + D_xx·N + 2·D_x·N_x + D·N_xx."""
    p: object
    n_uniform: int = 2
    input_dim = 2
    kernel_id = 11
    groups = (Group(n_second=1, n_first=1),)   # N, (N_x, N_xx), N_t

    @property
    def scale(self):
        return self.p.t_max * (self.p.x_max / 2.0) ** 2

    def kernel_consts(self):
        p = self.p
        return (p.x_max, p.t_max, p.kappa, self.scale)

    def build(self, u):
        x = self.p.x_max * u[:, :1]
        t = self.p.t_max * u[:, 1:2]
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        X = torch.cat([
            _cat(x, t), _cat(one, zero), _cat(zero, zero), _cat(zero, one),
        ], 0)
        return X, {"x": x, "t": t}

    def loss(self, outs, ctx):
        n, n_x, n_xx, n_t = outs
        p, scale = self.p, self.scale
        x, t = ctx["x"], ctx["t"]
        g = x * (p.x_max - x)
        D = t * g / scale
        D_t = g / scale
        D_x = t * (p.x_max - 2.0 * x) / scale
        D_xx = -2.0 * t / scale
        u_t = D_t * n + D * n_t
        u_xx = -torch.sin(x) + D_xx * n + 2.0 * D_x * n_x + D * n_xx
        return _smean(torch.square(u_t - p.kappa * u_xx), ctx)


@dataclass(frozen=True)
class HardHeat2DSpec(_HardSpec):
    """2-D heat with u = sin(x)sin(y) + D·N, D = t·x(x_max−x)·y(x_max−y)
    /scale (heat2d_ansatz): R = 6 streams against the soft spec's 11, and 3
    draws per point against 4 (no boundary-face sampling)."""
    p: object
    n_uniform: int = 3
    input_dim = 3
    kernel_id = 12
    groups = (Group(n_second=2, n_first=1),)  # N, (N_x,N_xx), (N_y,N_yy), N_t

    @property
    def scale(self):
        return self.p.t_max * (self.p.x_max / 2.0) ** 4

    def kernel_consts(self):
        p = self.p
        return (p.x_max, p.t_max, p.kappa, self.scale)

    def build(self, u):
        x = self.p.x_max * u[:, :1]
        y = self.p.x_max * u[:, 1:2]
        t = self.p.t_max * u[:, 2:3]
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        X = torch.cat([
            _cat(x, y, t),
            _cat(one, zero, zero), _cat(zero, zero, zero),
            _cat(zero, one, zero), _cat(zero, zero, zero),
            _cat(zero, zero, one),
        ], 0)
        return X, {"x": x, "y": y, "t": t}

    def loss(self, outs, ctx):
        n, n_x, n_xx, n_y, n_yy, n_t = outs
        p, scale = self.p, self.scale
        x, y, t = ctx["x"], ctx["y"], ctx["t"]
        gx = x * (p.x_max - x)
        gy = y * (p.x_max - y)
        D = t * gx * gy / scale
        D_t = gx * gy / scale
        D_x = t * (p.x_max - 2.0 * x) * gy / scale
        D_xx = -2.0 * t * gy / scale
        D_y = t * gx * (p.x_max - 2.0 * y) / scale
        D_yy = -2.0 * t * gx / scale
        A = torch.sin(x) * torch.sin(y)
        u_t = D_t * n + D * n_t
        u_xx = -A + D_xx * n + 2.0 * D_x * n_x + D * n_xx
        u_yy = -A + D_yy * n + 2.0 * D_y * n_y + D * n_yy
        return _smean(torch.square(u_t - p.kappa * (u_xx + u_yy)), ctx)


@dataclass(frozen=True)
class HardWaveSpec(_HardSpec):
    """Wave with u = sin(x) + D·N, D = t²·x·(x_max−x)/scale
    (wave1d_ansatz; the t² factor holds position and velocity ICs): R = 5
    streams against the soft spec's 9."""
    p: object
    n_uniform: int = 2
    input_dim = 2
    kernel_id = 13
    groups = (Group(n_second=2),)   # N, (N_x, N_xx), (N_t, N_tt)

    @property
    def scale(self):
        return self.p.t_max ** 2 * (self.p.x_max / 2.0) ** 2

    def kernel_consts(self):
        p = self.p
        return (p.x_max, p.t_max, p.c ** 2, self.scale)

    def build(self, u):
        x = self.p.x_max * u[:, :1]
        t = self.p.t_max * u[:, 1:2]
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        X = torch.cat([
            _cat(x, t), _cat(one, zero), _cat(zero, zero),
            _cat(zero, one), _cat(zero, zero),
        ], 0)
        return X, {"x": x, "t": t}

    def loss(self, outs, ctx):
        n, n_x, n_xx, n_t, n_tt = outs
        p, scale = self.p, self.scale
        x, t = ctx["x"], ctx["t"]
        g = x * (p.x_max - x)
        D = t * t * g / scale
        D_t = 2.0 * t * g / scale
        D_tt = 2.0 * g / scale
        D_x = t * t * (p.x_max - 2.0 * x) / scale
        D_xx = -2.0 * t * t / scale
        u_tt = D_tt * n + 2.0 * D_t * n_t + D * n_tt
        u_xx = -torch.sin(x) + D_xx * n + 2.0 * D_x * n_x + D * n_xx
        return _smean(torch.square(u_tt - (p.c ** 2) * u_xx), ctx)


@dataclass(frozen=True)
class HardPoissonSpec(_HardSpec):
    """Poisson with u = D·N, D = x(x_max−x)·y(x_max−y)/scale
    (poisson_ansatz): R = 5 streams against the soft spec's 9, and 2 draws
    per point against 3."""
    p: object
    n_uniform: int = 2
    input_dim = 2
    kernel_id = 14
    groups = (Group(n_second=2),)   # N, (N_x, N_xx), (N_y, N_yy)

    @property
    def scale(self):
        return (self.p.x_max / 2.0) ** 4

    def kernel_consts(self):
        return (self.p.x_max, self.scale)

    def build(self, u):
        x = self.p.x_max * u[:, :1]
        y = self.p.x_max * u[:, 1:2]
        zero = torch.zeros_like(x)
        one = torch.ones_like(x)
        X = torch.cat([
            _cat(x, y), _cat(one, zero), _cat(zero, zero),
            _cat(zero, one), _cat(zero, zero),
        ], 0)
        return X, {"x": x, "y": y}

    def loss(self, outs, ctx):
        n, n_x, n_xx, n_y, n_yy = outs
        p, scale = self.p, self.scale
        x, y = ctx["x"], ctx["y"]
        gx = x * (p.x_max - x)
        gy = y * (p.x_max - y)
        D = gx * gy / scale
        D_x = (p.x_max - 2.0 * x) * gy / scale
        D_xx = -2.0 * gy / scale
        D_y = gx * (p.x_max - 2.0 * y) / scale
        D_yy = -2.0 * gx / scale
        u_xx = D_xx * n + 2.0 * D_x * n_x + D * n_xx
        u_yy = D_yy * n + 2.0 * D_y * n_y + D * n_yy
        src = 2.0 * torch.sin(x) * torch.sin(y)
        return _smean(torch.square(-(u_xx + u_yy) - src), ctx)


SPECS = {
    "simple_ode": SimpleODESpec,
    "heat": HeatSpec,
    "burgers": BurgersSpec,
    "wave": WaveSpec,
    "advection": AdvectionSpec,
    "poisson": PoissonSpec,
    "heat2d": Heat2DSpec,
    "volterra": VolterraSpec,
    "uat": UATSpec,
    "inverse_heat": InverseHeatSpec,
}

HARD_SPECS = {
    "simple_ode": HardSimpleODESpec,
    "heat": HardHeatSpec,
    "heat2d": HardHeat2DSpec,
    "wave": HardWaveSpec,
    "poisson": HardPoissonSpec,
}


def spec_for(problem):
    """The stream spec for ``problem``, or None if the port has no fused
    engine spec for it (a hard problem takes its HARD_SPECS entry, none for
    fitzhugh_nagumo; the DGM equations train on kernels.fused_dgm; heat with
    ``taps="pallas"`` and volterra's Monte-Carlo rule, which draws fresh
    nodes per step, train on the scan trainer, as in the JAX package)."""
    if getattr(problem, "constraint", "soft") == "hard":
        cls = HARD_SPECS.get(problem.name)
        return cls(problem) if cls else None
    if getattr(problem, "taps", "jvp") == "pallas":
        return None
    if problem.name == "volterra" and problem.quadrature != "gauss":
        return None
    cls = SPECS.get(problem.name)
    return cls(problem) if cls else None


# ---------------------------------------------------------------------------
# The flat state: the six MLP tensors, then the spec's extras
# ---------------------------------------------------------------------------


def state_shapes(spec, model):
    """The shapes of the flat state's tensors (an absent hidden stack, at
    L = 0, has zero size)."""
    D, H, L = spec.dims(model)
    return ([(D, H), (H,), (L, H, H), (L, H), (H, 1), (1,)]
            + [tuple(s) for s in spec.extra_shapes])


def state_size(spec, model) -> int:
    return sum(math.prod(s) for s in state_shapes(spec, model))


def pack_state(spec, model) -> torch.Tensor:
    """The model's trainable tensors as one flat fp32 buffer (a copy); for
    a plain MLP, ``fused_train.pack_params``."""
    return torch.cat([t.detach().reshape(-1) for t in spec.tensors(model)])


def unpack_state(spec, model, flat):
    """Views of the state's tensors inside a flat buffer."""
    out, at = [], 0
    for shape in state_shapes(spec, model):
        n = math.prod(shape)
        out.append(flat[at:at + n].view(shape))
        at += n
    return tuple(out)


def load_state(spec, model, flat) -> None:
    """Copy a flat buffer into the model's trainable tensors."""
    with torch.no_grad():
        for dst, src in zip(spec.tensors(model),
                            unpack_state(spec, model, flat)):
            if dst.numel():
                dst.copy_(src.reshape(dst.shape))


def supports(problem, model=None) -> bool:
    """True if (problem, model) can train on the generic fused engine: a
    HardConstraint only on a hard problem and with the problem's own ansatz
    (a custom one trains on the scan engine), a hard problem only with
    one."""
    spec = spec_for(problem)
    if spec is None:
        return False
    return spec.supports_model(model or problem.default_model())


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------


def _check_model(spec, model):
    if not spec.supports_model(model):
        raise ValueError(f"the fused engine trains "
                         f"{spec.model_text.format(D=spec.input_dim)} for "
                         f"{spec.p.name!r} (got {type(model).__name__})")


def engine_plan(R, H, groups=None):
    """Bytes of shared memory per block that the largest kernel of
    csrc/engine_train.cu takes at R streams (``spec.kernel_streams``: 1
    for a folded spec), ``groups`` weight-gradient thread groups
    (``spec.weight_groups``; default R) and hidden width H, as the library
    plans it (``engine_smem_bytes``): the layer kernel's ring of k-tiles of
    its R·BB operand rows and of the weight beside the tile's running sums,
    or a weight-gradient tile. Every operand is staged in k-tiles, so the
    plan is the same at every width; past MAX_WIDTH it raises a ValueError
    that names the width."""
    if H > MAX_WIDTH:
        raise ValueError(
            f"hidden width {H} is past the {MAX_WIDTH} the fused engine's "
            f"weight gradient tiles along the grid's y extent")
    layer, weight = engine_core.step_plan(R, groups)
    return max(layer, weight)


def _resolve_const(spec, const, B, device):
    """``const``, or the spec's own one where it is None, checked against
    the spec's shape."""
    if const is None:
        const = spec.make_const(B, device)
    engine_core.check_const(const, spec.const_shape(B),
                            f"the {spec.p.name!r} spec")
    return const


def _check_inputs(spec, model, tensors, const, lib, n_replicas=None):
    """Device, dtype, shape and contiguity of the flat state (``[N, n]``
    for N packed replicas), uniforms and const, the uniforms' width, the
    rows a folded spec lays out, and the width and shared memory the
    kernels' plan holds."""
    R, (_, H, _) = spec.kernel_streams, spec.dims(model)
    engine_plan(R, H, spec.weight_groups)
    n = state_size(spec, model)
    shape = (n,) if n_replicas is None else (n_replicas, n)
    uniforms = tensors["uniforms"]
    for name, t in {**tensors, "const": const}.items():
        if t is None:
            continue
        build.require_cuda_f32(name, t, None if name in ("uniforms", "const")
                               else shape)
        if t.device != uniforms.device:
            raise ValueError(f"{name} is on {t.device}, uniforms on "
                             f"{uniforms.device}")
    U = uniforms.shape[-1]
    if U != spec.n_uniform:
        raise ValueError(f"uniforms have {U} columns, the {spec.p.name!r} "
                         f"spec draws {spec.n_uniform}")
    if spec.fold > MAX_FOLD:
        raise ValueError(f"the {spec.p.name!r} spec folds {spec.fold} "
                         f"groups; the fused engine's loss kernel holds at "
                         f"most {MAX_FOLD}")
    if spec.causal and uniforms.shape[-2] > CAUSAL_MAX_BATCH:
        raise ValueError(f"causal advection's loss kernel holds a batch of "
                         f"at most {CAUSAL_MAX_BATCH} points in shared "
                         f"memory (got {uniforms.shape[-2]})")
    engine_core.check_state_fits(lib.engine_smem_bytes(spec.kernel_id, H),
                                 R, H)


def _consts(spec, B):
    vals = [float(c) for c in spec.kernel_consts() + spec.batch_consts(B)]
    return (ctypes.c_float * _N_CONSTS)(*vals, *[0.0] * (_N_CONSTS -
                                                         len(vals)))


def engine_loss_grad_plain(spec, model, params, u, const=None,
                           precision="highest", batch_mask=None,
                           inv_bs=None):
    """Plain version of :func:`engine_loss_grad` (with the sweep mode's
    ``batch_mask`` [B, 1] and ``inv_bs``, the masked loss)."""
    loss, grads = engine_step_math(spec, unpack_state(spec, model, params), u,
                                   u.shape[0], spec.dims(model)[2], const,
                                   precision, batch_mask, inv_bs)
    return loss.reshape(()), torch.cat([g.reshape(-1) for g in grads])


def engine_loss_grad(spec, model, params, u, const=None,
                     precision="highest"):
    """One step's loss and flat gradient at flat ``params`` on ``[B,
    spec.n_uniform]`` uniforms (``const``: the spec's const operand, None
    for its own) at ``precision`` ("highest" | "default"): the step-math
    launches of the training kernel without the Adam update. A CPU tensor
    takes the plain version; a CUDA tensor launches the kernel
    (``engine_loss_grad.launches`` counts the launches, ``.bf16_launches``
    those at "default"; the training kernel's own step-math runs are
    counted by :func:`fused_engine_chunk`)."""
    check_precision(precision, CHUNK_PRECISIONS)
    _check_model(spec, model)
    const = _resolve_const(spec, const, u.shape[0], u.device)
    if u.device.type == "cpu":
        return engine_loss_grad_plain(spec, model, params, u, const,
                                      precision)
    lib = build.library()
    _check_inputs(spec, model, {"params": params, "uniforms": u}, const, lib)
    B, (_, H, L) = u.shape[0], spec.dims(model)
    scratch = torch.empty(
        lib.engine_scratch_floats(spec.kernel_id, B, H, L, spec.fold),
        device=u.device)
    grad = torch.empty_like(params)
    loss = torch.empty((), device=u.device)
    args = graphs.args_block(lib.engine_args_bytes(), u.device)
    with torch.cuda.device(u.device):
        code = lib.engine_grad(spec.kernel_id, _consts(spec, B),
                               _ptr(const), params.data_ptr(), u.data_ptr(),
                               scratch.data_ptr(), grad.data_ptr(),
                               loss.data_ptr(), args.data_ptr(), B, H, L,
                               spec.fold, int(precision == "default"),
                               build.stream_ptr(u.device))
    build.check(code, "engine_grad")
    count_launch(engine_loss_grad, precision)
    return loss, grad


engine_loss_grad.launches = 0
engine_loss_grad.bf16_launches = 0


def _ptr(t):
    return 0 if t is None else t.data_ptr()


def fused_engine_chunk_plain(spec, model, params, m, v, uniforms, step0,
                             lrate, *, schedule="constant", total_steps=1,
                             decay=0.1, batch_tile=None, const=None,
                             precision="highest", runtime_bs=None,
                             runtime_steps=None, trial_horizon=True):
    """Plain version of :func:`fused_engine_chunk`."""
    const = _resolve_const(spec, const, uniforms.shape[1], uniforms.device)

    def step_math(p, u, precision, *masked):
        return engine_loss_grad_plain(spec, model, p, u, const, precision,
                                      *masked)

    return engine_core.run_fused_chunk(
        step_math, params, m, v, uniforms, step0, lrate, schedule=schedule,
        total_steps=total_steps, decay=decay, batch_tile=batch_tile,
        precision=precision, runtime_bs=runtime_bs,
        runtime_steps=runtime_steps, trial_horizon=trial_horizon)


def pad_losses(losses, K):
    """``[N, k]`` losses of a call run to k ≤ K steps as ``[N, K]``, the
    steps it did not run 0."""
    if losses.shape[1] == K:
        return losses
    return torch.cat([losses, losses.new_zeros((losses.shape[0],
                                                K - losses.shape[1]))], 1)


def sweep_args(sweep, n_replicas, K, device):
    """The sweep mode's device vectors for a training call (``sweep``:
    ``engine_core.sweep_vectors``' host (lr, bs or None, n_steps), or None)
    and the steps the call must run: every budget's step, rounded up to a
    whole CUDA graph (the steps past the budgets are no-ops). Returns
    (tensors to keep alive, the C arguments lr_vec, bs_vec, steps_vec,
    trial_horizon are built from, steps to run)."""
    if sweep is None:
        return (), (None, None, None), K
    lrs, bss, ns = sweep
    run = min(K, -(-int(ns.max()) // GRAPH_STEPS) * GRAPH_STEPS)
    tensors = (torch.tensor(lrs, device=device),
               None if bss is None else torch.tensor(bss, device=device),
               torch.tensor(ns, device=device))
    return tensors, tuple(_ptr(t) for t in tensors), run


def _train_packed(spec, model, params, m, v, uniforms, step0, lrate,
                  n_replicas, schedule, total_steps, decay, const,
                  precision, sweep=None, trial_horizon=True):
    """One ``engine_train_packed`` call on CUDA ``[N, n]`` state, shared by
    both chunk wrappers (a single run is N = 1). The launches run on the
    shape's side stream (graphs.StepGraph.run); a call of at least
    GRAPH_STEPS steps first captures the shape's graph if it is not cached.
    The const operand's pointer reaches the kernels through the argument
    block each call writes, so the graph never holds it; ``precision``
    ("highest" | "default") picks the kernels' instances, and each has its
    own graph. ``sweep`` (``engine_core.sweep_vectors``; None outside the
    sweep mode) rides the argument block too, read by the launches of a
    graph of its own: the call then runs only to its largest budget
    (:func:`sweep_args`) and the losses past a slot's budget are 0.
    Returns the new (params, m, v, losses [N, K]) and the replica-steps
    whose step math it enqueued."""
    lib = build.library()
    _check_inputs(spec, model, {"params": params, "m": m, "v": v,
                                "uniforms": uniforms}, const, lib, n_replicas)
    K, B, _ = uniforms.shape
    _, H, L = spec.dims(model)
    F = spec.fold
    device = uniforms.device
    floats = lib.engine_scratch_floats(spec.kernel_id, B, H, L, F)
    consts = _consts(spec, B)
    bf16 = int(precision == "default")
    # The spec's numbers are kernel arguments of the captured graph, the
    # precision picks its kernel instances, and a graph of the sweep mode
    # reads its fields (a graph outside it does not).
    key = ("engine", spec.kernel_id, tuple(consts), B, H, L, F, n_replicas,
           precision, sweep is not None, GRAPH_STEPS, device)
    if not graphs.cached(key):
        engine_core.check_replicas(n_replicas, spec.kernel_streams,
                                   4 * floats,
                                   torch.cuda.mem_get_info(device)[0])
    entry = graphs.step_graph(key, lambda: graphs.StepGraph(
        "engine", device, n_replicas, floats, lib.engine_args_bytes(),
        lib.engine_graph_free))
    p, m, v = params.clone(), m.clone(), v.clone()
    runs = ctypes.c_int(0)
    entry.sweep, vecs, run = sweep_args(sweep, n_replicas, K, device)
    losses = (torch.empty if sweep is None else torch.zeros)(
        (n_replicas, run), device=device)
    if run >= GRAPH_STEPS and entry.exec is None:
        with torch.cuda.device(device):
            entry.capture(lambda args, scratch, out: lib.engine_graph_build(
                spec.kernel_id, consts, B, H, L, F, n_replicas, bf16,
                GRAPH_STEPS, int(sweep is not None), args, scratch, out),
                "engine_graph_build")
    code = entry.run(lambda stream, side0, side1: lib.engine_train_packed(
        spec.kernel_id, consts, _ptr(const), p.data_ptr(), m.data_ptr(),
        v.data_ptr(), uniforms.data_ptr(), entry.scratch.data_ptr(),
        losses.data_ptr(), entry.args.data_ptr(), entry.exec, GRAPH_STEPS,
        n_replicas, run, B, H, L, F, bf16, float(lrate), int(step0),
        *engine_core.schedule_args(schedule, total_steps, decay), *vecs,
        int(trial_horizon), ctypes.byref(runs), stream, side0, side1),
        device)
    build.check(code, "engine_train_packed")
    return (p, m, v, pad_losses(losses, K)), runs.value


def fused_engine_chunk(spec, model, params, m, v, uniforms, step0, lrate, *,
                       schedule="constant", total_steps=1, decay=0.1,
                       batch_tile=None, runtime_bs=None, runtime_steps=None,
                       trial_horizon=True, const=None, precision="highest"):
    """Run ``K = uniforms.shape[0]`` Adam steps of ``spec``'s equation at
    ``precision`` ("highest" | "default").
    ``params``/``m``/``v`` are flat fp32 buffers (:func:`pack_state`);
    ``uniforms`` is [K, B, spec.n_uniform]; ``step0`` is the absolute index
    of the chunk's first step. ``schedule`` ("constant" | "cosine" |
    "exponential") sets the learning rate of step t = step0 + k + 1 over
    the horizon ``total_steps``, decaying to ``lrate · decay``. ``const``
    is the spec's const operand (``spec.make_const``; None: the spec's own),
    a ValueError if its shape is not the spec's.

    The sweep mode (JAX ``run_fused_chunk``'s run-time scalars):
    ``runtime_bs`` masks rows ≥ bs out of the loss (the mean runs over the
    bs live rows), ``runtime_steps`` makes the steps k ≥ n_steps leave the
    state alone with loss 0, and with ``trial_horizon`` a decaying
    schedule runs over max(n_steps, 1) steps, not ``total_steps``.

    Returns new (params, m, v, losses[K]); the inputs are left unchanged.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``fused_engine_chunk.launches`` counts the launches, ``.bf16_launches``
    those at "default", and ``fused_engine_chunk.step_math_runs`` the steps
    whose step math the kernel enqueued, as it reports them)."""
    check_precision(precision, CHUNK_PRECISIONS)
    _check_model(spec, model)
    engine_core.check_schedule(schedule)
    K, B, _ = uniforms.shape
    check_batch_tile(B, batch_tile)
    const = _resolve_const(spec, const, B, uniforms.device)
    runtime = runtime_bs is not None or runtime_steps is not None
    sweep = engine_core.sweep_vectors(
        1, lrate, B, K, None, None if runtime_bs is None else [runtime_bs],
        [K if runtime_steps is None else runtime_steps] if runtime else None,
        runtime_bs is not None)
    if uniforms.device.type == "cpu":
        return fused_engine_chunk_plain(
            spec, model, params, m, v, uniforms, step0, lrate,
            schedule=schedule, total_steps=total_steps, decay=decay,
            const=const, precision=precision, runtime_bs=runtime_bs,
            runtime_steps=runtime_steps, trial_horizon=trial_horizon)
    (p, m, v, losses), runs = _train_packed(
        spec, model, params[None], m[None], v[None], uniforms, step0, lrate,
        1, schedule, total_steps, decay, const, precision, sweep,
        trial_horizon)
    count_launch(fused_engine_chunk, precision, runs, sweep is not None,
                 (B, 1))
    return p[0], m[0], v[0], losses[0]


fused_engine_chunk.launches = 0
fused_engine_chunk.bf16_launches = 0
fused_engine_chunk.step_math_runs = 0
fused_engine_chunk.bf16_step_math_runs = 0
fused_engine_chunk.sweep_launches = 0
fused_engine_chunk.sweep_shapes = {}


def fused_engine_packed_chunk_plain(spec, model, params, m, v, uniforms,
                                    step0, lrate, n_replicas, rep_tile=None,
                                    *, schedule="constant", total_steps=1,
                                    decay=0.1, const=None, lr_vec=None,
                                    bs_vec=None, steps_vec=None,
                                    mask_rows=False, trial_horizon=True,
                                    precision="highest"):
    """Plain version of :func:`fused_engine_packed_chunk`."""
    const = _resolve_const(spec, const, uniforms.shape[1], uniforms.device)

    def step_math(p, u, const, precision, *masked):
        return engine_loss_grad_plain(spec, model, p, u, const, precision,
                                      *masked)

    return engine_core.run_fused_packed(
        step_math, params, m, v, uniforms, step0, lrate, n_replicas,
        rep_tile=rep_tile, schedule=schedule, total_steps=total_steps,
        decay=decay, const=const, lr_vec=lr_vec, bs_vec=bs_vec,
        steps_vec=steps_vec, mask_rows=mask_rows,
        trial_horizon=trial_horizon, precision=precision)


def fused_engine_packed_chunk(spec, model, params, m, v, uniforms, step0,
                              lrate, n_replicas, rep_tile=None, *,
                              schedule="constant", total_steps=1, decay=0.1,
                              const=None, lr_vec=None, bs_vec=None,
                              steps_vec=None, mask_rows=False,
                              trial_horizon=True, precision="highest"):
    """Packed-replica twin of :func:`fused_engine_chunk` (kernel #5 around
    #6): one call advances ``n_replicas`` independent runs by ``K =
    uniforms.shape[0]`` Adam steps each. ``params``/``m``/``v`` are ``[N,
    n]`` (``engine_core.stack_replicas``); every replica reads the same
    ``uniforms [K, B, U]``, const operand and lr schedule. ``rep_tile``
    must divide N (every launch covers all N replicas on the H100).

    ``lr_vec``, ``bs_vec`` and ``steps_vec`` ([N] each, host or device;
    the JAX package's packed sweep mode) give slot r its own lr, its own
    batch (rows ≥ bs[r] masked out of its loss, with ``mask_rows``) and its
    own step budget (0: a pruned slot, returned as it came with losses 0);
    with ``trial_horizon`` a decaying schedule runs over the slot's own
    budget. The call then runs only to the largest budget, rounded up to
    a whole graph of GRAPH_STEPS.

    Returns new (params, m, v, losses [N, K]); the inputs are left
    unchanged. ``precision`` is "highest" or "default", as for the single
    chunk. A CPU tensor takes the plain version; a CUDA tensor launches
    ``engine_train_packed`` once (``.launches``, ``.bf16_launches`` at
    "default"; ``.step_math_runs`` counts the replica-steps whose step math
    it enqueued)."""
    check_precision(precision, CHUNK_PRECISIONS)
    _check_model(spec, model)
    engine_core.check_schedule(schedule)
    engine_core.check_rep_tile(n_replicas, rep_tile)
    engine_core.check_replicas(n_replicas, spec.kernel_streams)
    K, B, _ = uniforms.shape
    const = _resolve_const(spec, const, B, uniforms.device)
    sweep = engine_core.sweep_vectors(n_replicas, lrate, B, K, lr_vec,
                                      bs_vec, steps_vec, mask_rows)
    if uniforms.device.type == "cpu":
        return fused_engine_packed_chunk_plain(
            spec, model, params, m, v, uniforms, step0, lrate, n_replicas,
            schedule=schedule, total_steps=total_steps, decay=decay,
            const=const, lr_vec=lr_vec, bs_vec=bs_vec, steps_vec=steps_vec,
            mask_rows=mask_rows, trial_horizon=trial_horizon,
            precision=precision)
    out, runs = _train_packed(spec, model, params, m, v, uniforms, step0,
                              lrate, n_replicas, schedule, total_steps, decay,
                              const, precision, sweep, trial_horizon)
    count_launch(fused_engine_packed_chunk, precision, runs,
                 sweep is not None, (B, n_replicas))
    return out


fused_engine_packed_chunk.launches = 0
fused_engine_packed_chunk.bf16_launches = 0
fused_engine_packed_chunk.step_math_runs = 0
fused_engine_packed_chunk.bf16_step_math_runs = 0
fused_engine_packed_chunk.sweep_launches = 0
fused_engine_packed_chunk.sweep_shapes = {}


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------


def train_fused_result(problem, seed, iterations, batch_size=64, lrate=1e-4,
                       chunk_size=25_000, model=None, params=None,
                       opt_state=None, start_step: int = 0,
                       precision: str = "highest",
                       schedule: str | None = None, decay: float = 0.1,
                       total_steps: int | None = None, device="cuda"):
    """Train any spec-registered equation with the generic fused kernel;
    returns a TrainResult whose ``params`` is the trained model (timings as
    in ``fused_train.train_in_chunks``).

    ``model`` (default: ``problem.default_model()`` initialised from
    ``seed``) is trained in place. ``params`` (a flat buffer,
    :func:`pack_state`) replaces its parameters first; ``opt_state`` ({"m",
    "v"} of an earlier result) and ``start_step`` resume a run: step ``i``
    draws its collocation points from ``(seed, i)`` alone, so a resumed or
    chunked run equals the uncut run bit for bit. ``schedule`` (None = the
    problem's default) decays over ``total_steps`` (default ``start_step +
    iterations``); a run that will be resumed must pass its full planned
    budget here, and both phases of a "mixed" run share it. ``precision``
    is "highest", "default" or "mixed" (the first ``int(iterations·0.65)``
    steps at "default", then "highest"; 0.65 is
    ``core.precision.MIXED_SPLIT``).
    The spec's const operand is built once, on the device."""
    spec = spec_for(problem)
    if spec is None:
        raise ValueError(f"no fused-engine spec for equation "
                         f"{problem.name!r} (available: {sorted(SPECS)})")
    n_default = default_steps(iterations, precision)
    with trace.span("train.setup", trainer="engine"):
        device = build.resolve_device(device)
        if model is None:
            model = problem.default_model(generator=generator(seed))
        model.to(device)
        _check_model(spec, model)
        kw = dict(schedule=schedule or problem.defaults.schedule,
                  total_steps=total_steps or start_step + iterations,
                  decay=decay, const=spec.make_const(batch_size, device))
        p = (pack_state(spec, model) if params is None
             else params.to(device).clone())
        if opt_state is None:
            m, v = torch.zeros_like(p), torch.zeros_like(p)
        else:
            m = opt_state["m"].to(device).clone()
            v = opt_state["v"].to(device).clone()

    def run_chunk(p, m, v, u, step0, precision):
        return fused_engine_chunk(spec, model, p, m, v, u, step0, lrate,
                                  precision=precision, **kw)

    def draw(start, n):
        return step_uniforms(seed, start, n, batch_size, device,
                             spec.n_uniform)

    def load(model, p):
        load_state(spec, model, p)

    return train_in_chunks(model, run_chunk, draw, p, m, v, iterations,
                           chunk_size, device, start_step, load=load,
                           n_default=n_default, trainer="engine")


def train_fused_ensemble_packed(problem, seed, iterations, n_replicas,
                                batch_size=64, lrate=1e-4, model=None,
                                precision: str = "highest",
                                schedule: str | None = None,
                                decay: float = 0.1, chunk_size=25_000,
                                device="cuda", first: int = 0):
    """Train ``n_replicas`` independently initialised replicas, packed:
    every chunk is one :func:`fused_engine_packed_chunk` call that advances
    all of them. Replica r is ``model``'s architecture (default: the
    problem's) drawn from ``replica_generator(seed, r)``; all replicas share
    the collocation stream ``step_uniforms(seed, ...)``, the const operand
    and the schedule (None = the problem's default) over ``iterations``
    steps. So replica r equals ``train_fused_result`` of that init, and a
    chunked run equals an uncut one.

    Returns a TrainResult whose ``params`` is the list of N trained models,
    ``opt_state`` the ``[N, n]`` moments and ``loss_history`` ``[N,
    iterations]``; ``compile_time``, ``wall_time`` and ``iters_per_sec``
    (population steps per second) as ``fused_train.train_in_chunks``
    reports them. ``precision`` as for :func:`train_fused_result`, every
    replica on the same schedule. ``first`` numbers the replicas from
    ``first`` (a rank's share of a sharded ensemble)."""
    spec = spec_for(problem)
    if spec is None:
        raise ValueError(f"no fused-engine spec for equation "
                         f"{problem.name!r} (available: {sorted(SPECS)})")
    n_default = default_steps(iterations, precision)
    with trace.span("train.setup", trainer="engine"):
        device = build.resolve_device(device)
        models = replica_models(problem, model, seed, n_replicas, device,
                                first)
        _check_model(spec, models[0])
        kw = dict(schedule=schedule or problem.defaults.schedule,
                  total_steps=iterations, decay=decay,
                  const=spec.make_const(batch_size, device))
        p = engine_core.stack_replicas([pack_state(spec, m) for m in models])

    def run_chunk(p, m, v, u, step0, precision):
        return fused_engine_packed_chunk(spec, models[0], p, m, v, u, step0,
                                         lrate, n_replicas,
                                         precision=precision, **kw)

    def draw(start, n):
        return step_uniforms(seed, start, n, batch_size, device,
                             spec.n_uniform)

    def load(models, p):
        for model, row in zip(models, p):
            load_state(spec, model, row)

    return train_in_chunks(models, run_chunk, draw, p, torch.zeros_like(p),
                           torch.zeros_like(p), iterations, chunk_size,
                           device, load=load, n_default=n_default,
                           trainer="engine")


def train_fused_ensemble(problem, seed, iterations, n_replicas, mesh=None,
                         batch_size=64, lrate=1e-4, model=None,
                         precision: str = "highest",
                         schedule: str | None = None, decay: float = 0.1,
                         timings: dict | None = None, chunk_size=25_000,
                         device="cuda"):
    """``n_replicas`` independently initialised replicas (JAX
    ``train_fused_ensemble``), sharded over ``mesh``'s ``pop`` axis: each
    rank trains its replicas as one packed run
    (:func:`train_fused_ensemble_packed`, kernel #5) and the ranks gather
    them. ``mesh=None`` trains them one after another, each a whole run on
    kernel #4 (:func:`train_fused_result`). Replica r is drawn from
    ``replica_generator(seed, r)`` and trains on the shared stream
    ``step_uniforms(seed, ...)``, so it is the same run on every path and
    at every rank count (``fused_train.train_ensemble``). A mesh without a
    ``pop`` axis, or a count the axis does not divide, raises.

    Returns (the N trained models, losses ``[N, iterations]`` numpy), on
    every rank; ``timings`` receives ``compile_time`` and ``run_time``.
    ``precision`` as for :func:`train_fused_result` ("mixed" runs its two
    phases)."""
    kw = dict(batch_size=batch_size, lrate=lrate, precision=precision,
              schedule=schedule, decay=decay, chunk_size=chunk_size)

    def single(replica, device):
        return train_fused_result(problem, seed, iterations, model=replica,
                                  device=device, **kw)

    def packed(n, first, device):
        return train_fused_ensemble_packed(problem, seed, iterations, n,
                                           model=model, device=device,
                                           first=first, **kw)

    spec = spec_for(problem)
    if spec is None:
        raise ValueError(f"no fused-engine spec for equation "
                         f"{problem.name!r} (available: {sorted(SPECS)})")
    return train_ensemble(problem, model, seed, n_replicas, mesh, device,
                          single, packed, lambda m: pack_state(spec, m),
                          lambda m, row: load_state(spec, m, row), timings)


# ---------------------------------------------------------------------------
# The sweep evaluators (sweep/search.py's fused tier)
# ---------------------------------------------------------------------------


def _sweep_spec(problem, model):
    """The spec and model of a sweep evaluator (``model`` None: the
    problem's default architecture), checked."""
    spec = spec_for(problem)
    if spec is None:
        raise ValueError(f"no fused-engine spec for {problem.name!r}")
    arch = model or problem.default_model()
    _check_model(spec, arch)
    return spec, arch


def trial_state(problem, model, seed, trial_indices, state, device):
    """The flat states of trials ``trial_indices`` of a sweep seeded
    ``seed``, ``[len, n]``: trial t is ``model``'s architecture (None: the
    problem's) drawn from ``replica_generator(seed, t)``, the JAX
    evaluators' ``model.init(fold_in(init_key, t))``; ``state(model)`` packs
    it."""
    models = [problem.default_model(generator=replica_generator(seed, int(t)),
                                    device=device) if model is None
              else model.fresh(generator=replica_generator(seed, int(t)),
                               device=device)
              for t in trial_indices]
    return torch.stack([state(m) for m in models])


def check_horizon(horizon):
    if horizon not in ("trial", "fixed"):
        raise ValueError(f"horizon must be 'trial' or 'fixed' ({horizon!r})")


def check_single_phase(precision):
    """The sweep evaluators train at one precision, as in the JAX package:
    a "mixed" run's phase split is fixed per call, a trial's budget is
    not."""
    check_precision(precision)
    if precision == "mixed":
        raise ValueError("the sweep evaluator is single-phase (the mixed "
                         "schedule's phase split is compile-time, the trial "
                         "budget is runtime); use 'highest' or 'default'")


def padded_horizon(max_iters):
    """The evaluators' stream length: ``max_iters`` rounded up to a
    multiple of 1 000, as the JAX package pads it (the trials clamp to
    ``max_iters`` itself)."""
    return -(-int(max_iters) // 1000) * 1000


def live_steps(n_iters, max_iters):
    """The steps a call of budgets ``n_iters`` runs: the largest, rounded
    up to a whole CUDA graph of GRAPH_STEPS, at most ``max_iters``."""
    return min(max_iters, -(-int(np.max(n_iters)) // GRAPH_STEPS)
               * GRAPH_STEPS)


def make_lr_evaluator(problem, seed, iterations, batch_size=64, model=None,
                      precision="highest", schedule=None, decay=0.1,
                      device="cuda"):
    """``eval_fn(trial_index, lrate) -> (losses [iterations] numpy, flat
    state)``: each call trains trial ``trial_index``'s fresh network
    (:func:`trial_state`) for the full ``iterations`` at ``lrate`` through
    the same kernels and CUDA graph (the lr rides the argument block). The
    collocation stream ``step_uniforms(seed, 0, iterations, batch_size)``
    is shared by every trial. ``precision`` "mixed" runs its two phases as
    :func:`train_fused_result` does."""
    spec, arch = _sweep_spec(problem, model)
    device = build.resolve_device(device)
    schedule = schedule or problem.defaults.schedule
    n_default = default_steps(iterations, precision)
    uniforms = step_uniforms(seed, 0, iterations, batch_size, device,
                             spec.n_uniform)
    kw = dict(schedule=schedule, total_steps=iterations, decay=decay,
              const=spec.make_const(batch_size, device))

    def eval_fn(trial_index: int, lrate: float):
        p = trial_state(problem, model, seed, [trial_index],
                        lambda m: pack_state(spec, m), device)[0]
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        losses = []
        for lo, hi, prec in ((0, n_default, "default"),
                             (n_default, iterations, "highest")):
            if hi > lo:
                p, m, v, part = fused_engine_chunk(
                    spec, arch, p, m, v, uniforms[lo:hi], lo, float(lrate),
                    precision=prec, **kw)
                losses.append(part)
        return torch.cat(losses).cpu().numpy(), p

    return eval_fn


def _sweep_prologue(problem, seed, max_iters, max_batch, model, precision,
                    schedule, device):
    """What the sweep evaluators share (JAX ``_sweep_prologue``): the spec
    and model checks, "mixed" refused, the stream padded to a multiple of
    1 000 steps and drawn at ``max_batch`` rows from ``seed``. Returns
    (spec, model, schedule, user_max, padded_max, uniforms, const,
    device)."""
    spec, arch = _sweep_spec(problem, model)
    check_single_phase(precision)
    device = build.resolve_device(device)
    schedule = schedule or problem.defaults.schedule
    padded = padded_horizon(max_iters)
    uniforms = step_uniforms(seed, 0, padded, max_batch, device,
                             spec.n_uniform)
    return (spec, arch, schedule, int(max_iters), padded, uniforms,
            spec.make_const(max_batch, device), device)


def make_sweep_evaluator(problem, seed, max_iters, max_batch=512, model=None,
                         precision="highest", schedule=None, decay=0.1,
                         horizon="trial", device="cuda"):
    """The full reference space on one tile of ``max_batch`` rows:
    ``eval_fn(trial_index, lrate, batch_size, n_iters) -> (losses
    [n_iters] numpy, flat state)``. The batch masks rows ≥ batch_size out
    of the loss and the budget stops the trial at n_iters (the kernels'
    sweep mode), so the result is the n_iters-step state; the call runs
    only to its budget rounded up to a graph of GRAPH_STEPS. ``horizon``
    "trial" decays a schedule over the trial's own n_iters, "fixed" over
    ``max_iters`` for every trial (the halving schedulers': a promoted
    trial's rerun replays its earlier rung exactly). Trials clamp
    batch_size to [1, max_batch] and n_iters to [1, max_iters]."""
    check_horizon(horizon)
    spec, arch, schedule, user_max, padded, uniforms, const, device = \
        _sweep_prologue(problem, seed, max_iters, max_batch, model,
                        precision, schedule, device)

    def eval_fn(trial_index: int, lrate: float, batch_size: int,
                n_iters: int):
        bs = max(1, min(int(batch_size), max_batch))
        n = max(1, min(int(n_iters), user_max))
        p = trial_state(problem, model, seed, [trial_index],
                        lambda m: pack_state(spec, m), device)[0]
        zeros = torch.zeros_like(p)
        p, _, _, losses = fused_engine_chunk(
            spec, arch, p, zeros, zeros, uniforms[:live_steps(n, padded)],
            0, float(lrate), schedule=schedule, total_steps=user_max,
            decay=decay, runtime_bs=bs, runtime_steps=n,
            trial_horizon=horizon == "trial", const=const,
            precision=precision)
        return losses[:n].cpu().numpy(), p

    return eval_fn


def make_packed_rung_evaluator(problem, seed, max_iters, n_slots,
                               max_batch=512, model=None,
                               precision="highest", schedule=None, decay=0.1,
                               horizon="fixed", rep_tile=None, device="cuda"):
    """A vector of ``n_slots`` trials as one packed call (kernel #5 around
    #6 in its sweep mode): ``eval_fn(trial_indices, lrates, batch_sizes,
    n_iters) -> (final_losses [n_slots] numpy, flat states [n_slots, n])``.
    Slot i trains trial ``trial_indices[i]`` at its own lr, batch and
    budget (0: pruned, +inf as its final loss, its blocks returning at
    entry); the trials, the stream and the schedule are
    :func:`make_sweep_evaluator`'s, so slot i equals that evaluator's
    trial."""
    run = _packed_rung(problem, seed, max_iters, max_batch, model, precision,
                       schedule, decay, horizon, rep_tile, device)

    def eval_fn(trial_indices, lrates, batch_sizes, n_iters):
        if len(trial_indices) != n_slots:
            raise ValueError(f"expected {n_slots} slots "
                             f"(got {len(trial_indices)})")
        return run(trial_indices, lrates, batch_sizes, n_iters)

    return eval_fn


def _packed_rung(problem, seed, max_iters, max_batch, model, precision,
                 schedule, decay, horizon, rep_tile, device):
    """:func:`make_packed_rung_evaluator`'s call for any number of slots
    (``len(trial_indices)``), on one stream and const operand."""
    check_horizon(horizon)
    spec, arch, schedule, user_max, padded, uniforms, const, device = \
        _sweep_prologue(problem, seed, max_iters, max_batch, model,
                        precision, schedule, device)

    def run(trial_indices, lrates, batch_sizes, n_iters):
        n_slots = len(trial_indices)
        ns = np.clip(np.asarray(n_iters, np.int64), 0, user_max)
        bss = np.clip(np.asarray(batch_sizes, np.int64), 1, max_batch)
        p = trial_state(problem, model, seed, trial_indices,
                        lambda m: pack_state(spec, m), device)
        zeros = torch.zeros_like(p)
        p, _, _, losses = fused_engine_packed_chunk(
            spec, arch, p, zeros, zeros, uniforms[:live_steps(ns, padded)],
            0, 0.0, n_slots, rep_tile, schedule=schedule,
            total_steps=user_max, decay=decay, const=const,
            lr_vec=np.asarray(lrates, np.float32), bs_vec=bss, steps_vec=ns,
            mask_rows=True, trial_horizon=horizon == "trial",
            precision=precision)
        losses = losses.cpu().numpy()
        finals = np.where(ns > 0, losses[np.arange(n_slots),
                                         np.maximum(ns - 1, 0)], np.inf)
        return finals, p

    return run


def sharded_rungs(mesh, device, max_iters, make_run):
    """A sharded rung evaluator (both engines'): ``mesh`` (or an ``{axis:
    size}`` dict made into one on ``device``) must have a ``pop`` axis;
    then ``make_run(rank_device)`` gives ``run(trial_indices, lrates,
    batch_sizes, n_iters) -> (finals, flat states)``, one rank's slots as
    one packed call. Each rank runs its share of the ``pop`` axis, every
    budget clamped to [1, max_iters] as JAX clamps it, and the ranks
    gather the finals and states."""
    from differential_equations_dnn_tpu_torch.parallel import mesh as pm
    from differential_equations_dnn_tpu_torch.parallel.sharding import (
        gather_rows,
        shard_range,
    )

    mesh = pm.as_mesh(mesh, device)
    n_shards = pm.require_axis(mesh, "pop", "sharded rung evaluation")
    run = make_run(pm.mesh_device(mesh))

    def eval_fn(trial_indices, lrates, batch_sizes, n_iters):
        P = len(trial_indices)
        if P % n_shards:
            raise ValueError(f"{P} trials not divisible by the 'pop' axis "
                             f"({n_shards} shards) — pad by repeating "
                             f"trials")
        lo, hi = shard_range(P, mesh, "pop")
        ns = np.clip(np.asarray(n_iters, np.int64), 1, int(max_iters))
        finals, p = run(np.asarray(trial_indices)[lo:hi],
                        np.asarray(lrates)[lo:hi],
                        np.asarray(batch_sizes)[lo:hi], ns[lo:hi])
        return gather_rows((np.asarray(finals, np.float64), p), mesh, "pop")

    return eval_fn


def make_sharded_rung_evaluator(problem, seed, max_iters, mesh,
                                max_batch=512, model=None,
                                precision="highest", schedule=None,
                                decay=0.1, horizon="trial", device="cuda"):
    """A rung of P trials sharded over ``mesh``'s ``pop`` axis (JAX
    ``make_sharded_rung_evaluator``): ``eval_fn(trial_indices, lrates,
    batch_sizes, n_iters) -> (final_losses [P] numpy, flat states [P,
    n])``, on every rank. Each rank trains its P / n slots as one packed
    call in the kernels' sweep mode (kernel #5 around #6, with
    :func:`make_packed_rung_evaluator`'s trials, stream and schedule), so
    slot i is the same run at every rank count. P must be a multiple of
    the axis' size: pad by repeating trials (a duplicate costs its own
    budget). Budgets clamp to [1, max_iters]; ``horizon`` as in
    :func:`make_sweep_evaluator`."""
    return sharded_rungs(mesh, device, max_iters, lambda dev: _packed_rung(
        problem, seed, max_iters, max_batch, model, precision, schedule,
        decay, horizon, None, dev))


def lr_sweep(problem, seed, lrates, iterations, batch_size=64, model=None,
             precision="highest", schedule=None, decay=0.1, device="cuda"):
    """A full-budget learning-rate sweep through :func:`make_lr_evaluator`:
    trial t trains at ``lrates[t]``. Returns (final losses [N] numpy, the
    trained flat states ``[N, n]``)."""
    eval_fn = make_lr_evaluator(problem, seed, iterations,
                                batch_size=batch_size, model=model,
                                precision=precision, schedule=schedule,
                                decay=decay, device=device)
    finals, states = [], []
    for t, lr in enumerate(np.asarray(lrates, np.float64)):
        losses, p = eval_fn(t, float(lr))
        finals.append(float(losses[-1]))
        states.append(p)
    return np.asarray(finals), torch.stack(states)
