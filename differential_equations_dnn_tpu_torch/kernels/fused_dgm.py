"""The fused DGM engine: K Adam steps of a DGM equation per kernel call
(csrc/dgm_train.cu).

Counterpart of the JAX package's kernels/fused_dgm.py. The forward runs as
stacked value / first-order-tangent streams through the gate recurrence

    Z,G,R = act(s·Wzgr + x·Uzgr + b)   (fused 3-gate matmul)
    H     = act((s⊙R)·Wh + x·Uh + bh)
    s'    = (1−G)⊙H + Z⊙s

with the stream rules (per group: one value row-block and ``n_first``
tangent blocks)

    act:  v → σ(v),  t_k → σ'(v)·t_k
    mul:  v → a_v·b_v,  t_k → a_v·b_tk + a_tk·b_v

for σ ∈ {tanh, relu}, and a hand-derived backward. ``dgm_step_math`` is the
plain PyTorch version of one step: the loss cotangent comes from
``torch.func.vjp`` of the spec's loss; in the CUDA kernel it is written out
by hand for each spec.

Specs: fitzhugh_nagumo (value + time tangent + the t=0 IC rows, with the
causal weighting) and fredholm (value rows only: collocation points plus
⌈k/B⌉ groups of Gauss–Legendre nodes, whose positions and weights arrive as
the const operand). Single runs (``fused_dgm_chunk``,
``train_dgm_fused_result``) and packed-replica ensembles
(``fused_dgm_packed_chunk``, ``train_dgm_fused_ensemble_packed``) run at
``precision`` "highest" (exact fp32) or "default" (the products the JAX
step math gives ``precision``, x·U and the x-row gradients among them,
take bf16 operands and accumulate in fp32; the loss's own products stay
fp32), and the trainers at "mixed" too (core/precision.py). The sweep
mode (a row mask over collocation rows, a step budget, a trial's own lr
horizon; per-slot values in a packed call) serves the sweep evaluators
(``make_trial_evaluator``, ``make_sweep_evaluator``,
``make_packed_rung_evaluator``; sweep/search.py).

On the card a chunk replays a CUDA graph of GRAPH_STEPS training steps,
captured on the first call of its shape and cached (kernels/graphs.py:
``clear_graphs``), on a side stream ordered after and
before the caller's stream by events; the steps left over run as the same
launches.
"""

import ctypes
import dataclasses
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
    step_uniforms,
)
from differential_equations_dnn_tpu_torch.kernels import build
from differential_equations_dnn_tpu_torch.kernels import engine_core
from differential_equations_dnn_tpu_torch.kernels import fused_engine
from differential_equations_dnn_tpu_torch.kernels import graphs
from differential_equations_dnn_tpu_torch.kernels.graphs import (  # noqa: F401
    GRAPH_STEPS,
    clear_graphs,
)
from differential_equations_dnn_tpu_torch.kernels.fused_engine import (
    Group,
    _bias_mask,
    _n_rows,
    _smean,
    pad_losses,
    sweep_args,
)
from differential_equations_dnn_tpu_torch.kernels.fused_train import (
    CHUNK_PRECISIONS,
    count_launch,
    replica_models,
    train_ensemble,
    train_in_chunks,
)
from differential_equations_dnn_tpu_torch.kernels.taylor_mlp import _ACT_KIND
from differential_equations_dnn_tpu_torch.models import DGM
from differential_equations_dnn_tpu_torch.ops import gauss_legendre_nodes
from differential_equations_dnn_tpu_torch.utils import trace

_N_CONSTS = 8  # floats of kernel_consts the CUDA specs read

# ---------------------------------------------------------------------------
# Flat parameter buffers
# ---------------------------------------------------------------------------


def param_shapes(model):
    """The ten tensors' shapes, in the flat order of the JAX package's
    ``pack_dgm``."""
    D, H, L, O = (model.input_dim, model.hidden_size, model.num_layers,
                  model.output_dim)
    return [(D, H), (H,), (L, H, 3 * H), (L, D, 3 * H), (L, 3 * H),
            (L, H, H), (L, D, H), (L, H), (H, O), (O,)]


def _tensors(model):
    return (model.s_in.w, model.s_in.b, model.layers.Wzgr, model.layers.Uzgr,
            model.layers.bzgr, model.layers.Wh, model.layers.Uh,
            model.layers.bh, model.s_out.w, model.s_out.b)


def pack_dgm(model) -> torch.Tensor:
    """The model's parameters as one flat fp32 buffer (a copy)."""
    return torch.cat([t.detach().reshape(-1) for t in _tensors(model)])


def unpack_dgm(model, flat):
    """Views of the ten tensors inside a flat buffer."""
    out, at = [], 0
    for shape in param_shapes(model):
        n = math.prod(shape)
        out.append(flat[at:at + n].view(shape))
        at += n
    return tuple(out)


def load_dgm(model, flat) -> None:
    """Copy a flat buffer into the model's parameters."""
    with torch.no_grad():
        for dst, src in zip(_tensors(model), unpack_dgm(model, flat)):
            dst.copy_(src)


# ---------------------------------------------------------------------------
# Stream algebra: activation + product, forward and VJP
# ---------------------------------------------------------------------------


def _act(z, act):
    """(σ(z), σ'(z), σ''(z) or None) on value rows."""
    if act == "tanh":
        a = torch.tanh(z)
        d = 1.0 - a * a
        return a, d, -2.0 * a * d
    return torch.clamp_min(z, 0.0), torch.where(z > 0.0, 1.0, 0.0), None


def _act_fwd(groups, z, B, act):
    outs = []
    off = 0
    for g in groups:
        a, d, _ = _act(z[off * B:(off + 1) * B], act)
        outs.append(a)
        for k in range(g.n_first):
            outs.append(d * z[(off + 1 + k) * B:(off + 2 + k) * B])
        off += g.n_rows
    return torch.cat(outs, 0)


def _act_bwd(groups, z, u, B, act):
    """VJP of :func:`_act_fwd`: with d = σ'(z_v), d' = σ''(z_v),

        dz_v  = d·u_v + d'·Σ_k z_tk·u_tk      (d' = −2σd for tanh, 0 for relu)
        dz_tk = d·u_tk
    """
    outs = []
    off = 0
    for g in groups:
        _, d, dp = _act(z[off * B:(off + 1) * B], act)
        dzv = d * u[off * B:(off + 1) * B]
        tail = []
        for k in range(g.n_first):
            zt = z[(off + 1 + k) * B:(off + 2 + k) * B]
            ut = u[(off + 1 + k) * B:(off + 2 + k) * B]
            if dp is not None:
                dzv = dzv + dp * (zt * ut)
            tail.append(d * ut)
        outs.append(dzv)
        outs.extend(tail)
        off += g.n_rows
    return torch.cat(outs, 0)


def _mul_fwd(groups, a, b, B):
    """Stream product c = a ⊙ b: c_v = a_v·b_v, c_tk = a_v·b_tk + a_tk·b_v."""
    outs = []
    off = 0
    for g in groups:
        av = a[off * B:(off + 1) * B]
        bv = b[off * B:(off + 1) * B]
        outs.append(av * bv)
        for k in range(g.n_first):
            at = a[(off + 1 + k) * B:(off + 2 + k) * B]
            bt = b[(off + 1 + k) * B:(off + 2 + k) * B]
            outs.append(av * bt + at * bv)
        off += g.n_rows
    return torch.cat(outs, 0)


def _mul_bwd(groups, u, b, B):
    """VJP of :func:`_mul_fwd` w.r.t. its first operand (symmetric: call
    with the operands swapped for the second):

        da_v  = u_v·b_v + Σ_k u_tk·b_tk
        da_tk = u_tk·b_v
    """
    outs = []
    off = 0
    for g in groups:
        uv = u[off * B:(off + 1) * B]
        bv = b[off * B:(off + 1) * B]
        dav = uv * bv
        tail = []
        for k in range(g.n_first):
            ut = u[(off + 1 + k) * B:(off + 2 + k) * B]
            bt = b[(off + 1 + k) * B:(off + 2 + k) * B]
            dav = dav + ut * bt
            tail.append(ut * bv)
        outs.append(dav)
        outs.extend(tail)
        off += g.n_rows
    return torch.cat(outs, 0)


# ---------------------------------------------------------------------------
# The step math (the plain version of the kernel's step)
# ---------------------------------------------------------------------------


def dgm_step_math(spec, params, u, B, L, const=None, precision="highest",
                  batch_mask=None, inv_bs=None):
    """One training step's loss ``[1, 1]`` and parameter gradients for a
    DGM stream spec. ``params`` = the ten tensors of :func:`unpack_dgm`;
    ``u`` = [B, spec.n_uniform] U[0,1) draws; ``const`` = the spec's const
    operand (Fredholm's nodes and weights); ``precision`` ("highest" |
    "default") that of the products the JAX step math gives it;
    ``batch_mask`` [B, 1] and ``inv_bs`` the sweep mode's row mask (the
    spec's masked loss). Returns (loss, grads_tuple)."""
    groups = spec.groups
    act = spec.act
    w_in, b_in, Wzgr, Uzgr, bzgr, Wh, Uh, bh, w_out, b_out = params

    def mm(a, b):
        return matmul(a, b, precision)

    X, ctx = spec.build(u, const)
    if batch_mask is not None:
        ctx = {**ctx, "mask": batch_mask, "inv_bs": inv_bs}
    mask = _bias_mask(groups, B, X)
    H = w_in.shape[1]

    # ---- forward, saving layer-input states + pre-activations ----
    s_in_pre = mm(X, w_in) + mask * b_in
    s = _act_fwd(groups, s_in_pre, B, act)
    states = [s]
    zgr_pres, h_pres = [], []
    for l in range(L):
        zgr_pre = mm(s, Wzgr[l]) + mm(X, Uzgr[l]) + mask * bzgr[l]
        zgr = _act_fwd(groups, zgr_pre, B, act)
        z, g, r = zgr[:, :H], zgr[:, H:2 * H], zgr[:, 2 * H:]
        sr = _mul_fwd(groups, s, r, B)
        h_pre = mm(sr, Wh[l]) + mm(X, Uh[l]) + mask * bh[l]
        h = _act_fwd(groups, h_pre, B, act)
        om = mask - g  # one-minus-G under stream semantics (linear)
        s = _mul_fwd(groups, om, h, B) + _mul_fwd(groups, z, s, B)
        zgr_pres.append(zgr_pre)
        h_pres.append(h_pre)
        states.append(s)
    out = mm(s, w_out) + mask * b_out

    outs = tuple(out[k * B:(k + 1) * B] for k in range(_n_rows(groups)))
    # The cotangent w.r.t. the stream outputs, from autodiff of the spec's
    # small loss (the kernel writes it out by hand per spec).
    loss, vjp_fn = torch.func.vjp(lambda *o: spec.loss(o, ctx), *outs)
    G = torch.cat(vjp_fn(torch.ones_like(loss)), 0)

    # ---- hand backward through the gate recurrence ----
    d_w_out = mm(states[L].T, G)
    d_b_out = torch.sum(mask * G, 0)
    ds = mm(G, w_out.T)
    d_Wzgr, d_Uzgr, d_bzgr, d_Wh, d_Uh, d_bh = [], [], [], [], [], []
    for l in range(L - 1, -1, -1):
        s_prev, zgr_pre, h_pre = states[l], zgr_pres[l], h_pres[l]
        zgr = _act_fwd(groups, zgr_pre, B, act)
        z, g, r = zgr[:, :H], zgr[:, H:2 * H], zgr[:, 2 * H:]
        h = _act_fwd(groups, h_pre, B, act)
        om = mask - g
        sr = _mul_fwd(groups, s_prev, r, B)

        # s' = om⊙h + z⊙s_prev
        d_om = _mul_bwd(groups, ds, h, B)
        dh = _mul_bwd(groups, ds, om, B)
        dz = _mul_bwd(groups, ds, s_prev, B)
        ds_prev = _mul_bwd(groups, ds, z, B)
        dg = -d_om
        # h = act(h_pre);  h_pre = sr·Wh + X·Uh + bh
        dh_pre = _act_bwd(groups, h_pre, dh, B, act)
        d_Wh.append(mm(sr.T, dh_pre))
        d_Uh.append(mm(X.T, dh_pre))
        d_bh.append(torch.sum(mask * dh_pre, 0))
        dsr = mm(dh_pre, Wh[l].T)
        # sr = s_prev ⊙ r
        ds_prev = ds_prev + _mul_bwd(groups, dsr, r, B)
        dr = _mul_bwd(groups, dsr, s_prev, B)
        # zgr = act(zgr_pre);  zgr_pre = s_prev·Wzgr + X·Uzgr + bzgr
        dzgr = torch.cat([dz, dg, dr], 1)
        dzgr_pre = _act_bwd(groups, zgr_pre, dzgr, B, act)
        d_Wzgr.append(mm(s_prev.T, dzgr_pre))
        d_Uzgr.append(mm(X.T, dzgr_pre))
        d_bzgr.append(torch.sum(mask * dzgr_pre, 0))
        ds = ds_prev + mm(dzgr_pre, Wzgr[l].T)

    # s_0 = act(X·w_in + b_in)
    dz0 = _act_bwd(groups, s_in_pre, ds, B, act)
    d_w_in = mm(X.T, dz0)
    d_b_in = torch.sum(mask * dz0, 0)

    def stack(gs):
        return torch.stack(gs[::-1])

    return loss, (d_w_in, d_b_in, stack(d_Wzgr), stack(d_Uzgr),
                  stack(d_bzgr), stack(d_Wh), stack(d_Uh), stack(d_bh),
                  d_w_out, d_b_out)


# ---------------------------------------------------------------------------
# Equation specs
# ---------------------------------------------------------------------------


def _ksum(q):
    return torch.sum(torch.sum(q, 0, keepdim=True), 1, keepdim=True)


@dataclass(frozen=True)
class FNDGMSpec:
    """FitzHugh–Nagumo, DGM arch (equations.fitzhugh_nagumo). Streams: the
    value at t with its time tangent, and the t=0 IC rows.

    With ``p.causal_eps > 0`` (the default) collocation is stratified
    (t_i = (i + u_i)·t_max/B, time-sorted) and the residual at t_i is
    weighted by exp(−ε·Δt·Σ_{j<i} ℓ_j), the weights held constant for the
    gradient (the JAX kernel's strictly-lower-triangular matmul).

    Under the sweep mode's batch mask (rows ≥ bs out) the loss is the
    plain one over the bs live rows, Σ r²·mask/bs + Σ (s0 − y_ic)²·mask/
    (2·bs) (both components summed), which at bs = B is the unmasked loss.
    The JAX spec's masked branch scales the IC sum by 1/bs
    (fused_dgm.py:363-364 of the JAX package), twice its unmasked weight;
    the port trains the intended loss."""
    p: object
    n_uniform: int = 1
    act: str = "tanh"
    kernel_id = 0
    output_dim = 2
    groups = (Group(n_first=1), Group())

    def kernel_consts(self, B):
        p = self.p
        return (p.t_max, p.t_max / B, p.causal_eps, p.i_ext, p.alpha, p.beta,
                p.tau, p.y_ic)

    def build(self, u, const=None):
        X = self.p.batch_from_uniforms(u)["t"]
        return torch.cat([X, torch.ones_like(X), torch.zeros_like(X)], 0), {}

    def loss(self, outs, ctx):
        sv, dsdt, s0 = outs
        p = self.p
        rev = torch.flip(sv, (1,))  # the sibling component
        col = torch.arange(2, device=sv.device)
        f_y = sv ** 3 / 3.0 + rev - p.i_ext - sv          # col 0 (y, w=rev)
        f_w = (p.beta * sv - p.alpha - rev) / p.tau       # col 1 (w, y=rev)
        r = dsdt + torch.where(col == 0, f_y, f_w)
        r2 = torch.square(r)
        mask = ctx.get("mask")
        if mask is not None:
            inv_bs = ctx["inv_bs"]
            return (_ksum(r2 * mask) * inv_bs
                    + _ksum(torch.square(s0 - p.y_ic) * mask)
                    * (0.5 * inv_bs))
        ic = _smean(torch.square(s0 - p.y_ic))
        if p.causal_eps <= 0.0:
            # mean(r_y²)+mean(r_w²)+mean((s0−ic)²) = 2·mean_full(r²) + ...
            return 2.0 * _smean(r2) + ic
        B = r2.shape[0]
        ell = torch.sum(r2.detach(), 1, keepdim=True)
        cum = (torch.cumsum(ell, 0) - ell) * (p.t_max / B)  # Σ_{j<i} ℓ_j
        wgt = torch.exp(-p.causal_eps * cum)
        return 2.0 * _smean(wgt * r2) + ic


@dataclass(frozen=True)
class FredholmDGMSpec:
    """Fredholm II, DGM variant-A arch (equations.fredholm). Value-only
    streams: the collocation points, then ⌈k/B⌉ groups of Gauss–Legendre
    nodes. The const operand ``[2·(n_groups−1), B, 1]`` holds each node
    group's (nodes, weights), zero-padded past k."""
    p: object
    n_groups: int
    act: str = "relu"
    n_uniform: int = 1
    kernel_id = 1
    output_dim = 1

    @property
    def n_const(self):
        return 2 * (self.n_groups - 1)

    @property
    def groups(self):
        return tuple(Group() for _ in range(self.n_groups))

    def kernel_consts(self, B):
        return (self.p.upper,)

    def build(self, u, const=None):
        x = self.p.upper * u[:, :1]
        parts = [x] + [const[2 * j] for j in range(self.n_groups - 1)]
        return torch.cat(parts, 0), {"x": x, "const": const}

    def loss(self, outs, ctx):
        x, const = ctx["x"], ctx["const"]
        y_x = outs[0]
        # integral ≈ Σ_j w_j·cos(t_j)·y(t_j): one value shared by all rows.
        integral = y_x.new_zeros((1, 1))
        for j in range(self.n_groups - 1):
            t_j, w_j = const[2 * j], const[2 * j + 1]
            integral = integral + _ksum(w_j * torch.cos(t_j) * outs[1 + j])
        r = y_x - torch.sin(x) * (1.0 + integral)
        # A batch mask takes collocation rows only: the node groups are
        # the quadrature's, not the batch's.
        return _smean(torch.square(r), ctx)


def spec_for(problem, batch_size=None):
    """The DGM stream spec for ``problem``, or None."""
    if problem.name == "fitzhugh_nagumo" and getattr(problem, "arch",
                                                     "dgm") == "dgm":
        return FNDGMSpec(problem)
    if problem.name == "fredholm" and problem.quadrature == "gauss":
        n_node_groups = -(-problem.k // batch_size) if batch_size else 1
        return FredholmDGMSpec(problem, n_groups=1 + n_node_groups)
    return None


def _fredholm_const(problem, batch_size, n_groups, device=None):
    """[2·(n_groups−1), B, 1] stacked (nodes, weights), zero-padded."""
    nodes, weights = (t.numpy() for t in gauss_legendre_nodes(
        problem.k, 0.0, problem.upper))
    cols = []
    for j in range(n_groups - 1):
        n_j = np.zeros((batch_size,), np.float32)
        w_j = np.zeros((batch_size,), np.float32)
        chunk = slice(j * batch_size, min((j + 1) * batch_size, problem.k))
        size = chunk.stop - chunk.start
        n_j[:size] = nodes[chunk]
        w_j[:size] = weights[chunk]
        cols.extend([n_j, w_j])
    return torch.tensor(np.stack(cols, 0)[:, :, None], device=device)


def const_for(spec, problem, batch_size, device=None):
    """The spec's const operand at ``batch_size`` (None for a spec without
    one)."""
    if isinstance(spec, FredholmDGMSpec):
        return _fredholm_const(problem, batch_size, spec.n_groups, device)
    return None


def supports_model(spec, model) -> bool:
    """A DGM 1 → H×L → spec.output_dim with the spec's gate activation."""
    return (isinstance(model, DGM) and model.activation == spec.act
            and model.input_dim == 1 and model.output_dim == spec.output_dim)


def supports(problem, model=None, batch_size=None) -> bool:
    """True if (problem, model) can train on the fused DGM engine."""
    spec = spec_for(problem, batch_size or 32)
    if spec is None:
        return False
    return supports_model(spec, model or problem.default_model())


# ---------------------------------------------------------------------------
# The kernel wrappers
# ---------------------------------------------------------------------------


def _layout(spec):
    """(R, value mask): bit s is set for each value row of the layout."""
    mask, off = 0, 0
    for g in spec.groups:
        mask |= 1 << off
        off += g.n_rows
    return off, mask


def _check_model(spec, model):
    if not supports_model(spec, model):
        raise ValueError(f"the fused DGM engine trains DGMs 1 → H×L → "
                         f"{spec.output_dim} with {spec.act!r} gates for "
                         f"{spec.p.name!r}")


def _check_inputs(spec, model, tensors, const, lib, n_replicas=None):
    """Device, dtype, shape and contiguity of the flat state (``[N, n]``
    for N packed replicas), uniforms and const, the uniforms' width, and
    the stream count the kernel holds."""
    n = sum(math.prod(s) for s in param_shapes(model))
    shape = (n,) if n_replicas is None else (n_replicas, n)
    uniforms = tensors["uniforms"]
    B, U = uniforms.shape[-2:]
    for name, t in tensors.items():
        build.require_cuda_f32(name, t, None if name == "uniforms" else shape)
        if t.device != uniforms.device:
            raise ValueError(f"{name} is on {t.device}, uniforms on "
                             f"{uniforms.device}")
    if U != spec.n_uniform:
        raise ValueError(f"uniforms have {U} columns, the {spec.p.name!r} "
                         f"spec draws {spec.n_uniform}")
    R, _ = _layout(spec)
    if R > lib.dgm_max_streams():
        raise ValueError(
            f"{spec.p.name!r} at batch {B} stacks {R} stream rows per point; "
            f"the DGM kernel holds at most {lib.dgm_max_streams()} (raise "
            f"batch_size or lower the node count)")
    if const is not None:
        build.require_cuda_f32("const", const)
        if const.device != uniforms.device:
            raise ValueError(f"const is on {const.device}, uniforms on "
                             f"{uniforms.device}")


def _check_const(spec, const, B):
    """The spec's const operand: [n_const, B, 1], or None for a spec
    without one."""
    n_const = getattr(spec, "n_const", 0)
    if n_const == 0:
        if const is not None:
            raise ValueError(f"the {spec.p.name!r} spec takes no const")
        return
    if const is None or tuple(const.shape) != (n_const, B, 1):
        got = None if const is None else tuple(const.shape)
        raise ValueError(f"the {spec.p.name!r} spec needs its const operand "
                         f"of shape {(n_const, B, 1)} (got {got}; see "
                         f"const_for)")


def _call_args(spec, model, B, const):
    """The spec-describing arguments every C entry point takes."""
    vals = [float(c) for c in spec.kernel_consts(B)]
    consts = (ctypes.c_float * _N_CONSTS)(*vals,
                                          *[0.0] * (_N_CONSTS - len(vals)))
    R, mask = _layout(spec)
    return dict(consts=consts, const=const.data_ptr() if const is not None
                else None, R=R, mask=mask, act=_ACT_KIND[spec.act],
                H=model.hidden_size, L=model.num_layers, O=spec.output_dim)


def dgm_loss_grad_plain(spec, model, params, u, const=None,
                        precision="highest", batch_mask=None, inv_bs=None):
    """Plain version of :func:`dgm_loss_grad` (with the sweep mode's
    ``batch_mask`` [B, 1] and ``inv_bs``, the masked loss)."""
    loss, grads = dgm_step_math(spec, unpack_dgm(model, params), u,
                                u.shape[0], model.num_layers, const,
                                precision, batch_mask, inv_bs)
    return loss.reshape(()), torch.cat([g.reshape(-1) for g in grads])


def dgm_loss_grad(spec, model, params, u, const=None, precision="highest"):
    """One step's loss and flat gradient at flat ``params`` on ``[B,
    spec.n_uniform]`` uniforms (``const``: the spec's const operand) at
    ``precision`` ("highest" | "default"): the step-math launches of the
    training kernel without the Adam update. A CPU tensor takes the plain
    version; a CUDA tensor launches the kernel (``dgm_loss_grad.launches``
    counts the launches, ``.bf16_launches`` those at "default"; the training
    kernel's own step-math runs are counted by :func:`fused_dgm_chunk`)."""
    check_precision(precision, CHUNK_PRECISIONS)
    _check_model(spec, model)
    _check_const(spec, const, u.shape[0])
    if u.device.type == "cpu":
        return dgm_loss_grad_plain(spec, model, params, u, const, precision)
    lib = build.library()
    _check_inputs(spec, model, {"params": params, "uniforms": u}, const, lib)
    B = u.shape[0]
    a = _call_args(spec, model, B, const)
    scratch = torch.empty(lib.dgm_scratch_floats(a["R"], B, a["H"], a["L"],
                                                 a["O"]), device=u.device)
    grad = torch.empty_like(params)
    loss = torch.empty((), device=u.device)
    args = graphs.args_block(lib.dgm_args_bytes(), u.device)
    with torch.cuda.device(u.device):
        code = lib.dgm_grad(spec.kernel_id, a["consts"], a["const"],
                            params.data_ptr(), u.data_ptr(),
                            scratch.data_ptr(), grad.data_ptr(),
                            loss.data_ptr(), args.data_ptr(), a["R"], B,
                            a["H"], a["L"], a["O"], a["act"], a["mask"],
                            int(precision == "default"),
                            build.stream_ptr(u.device))
    build.check(code, "dgm_grad")
    count_launch(dgm_loss_grad, precision)
    return loss, grad


dgm_loss_grad.launches = 0
dgm_loss_grad.bf16_launches = 0


def fused_dgm_chunk_plain(spec, model, params, m, v, uniforms, step0, lrate,
                          *, const=None, schedule="constant", total_steps=1,
                          decay=0.1, precision="highest", runtime_steps=None,
                          runtime_bs=None, trial_horizon=True):
    """Plain version of :func:`fused_dgm_chunk`."""

    def step_math(p, u, precision, *masked):
        return dgm_loss_grad_plain(spec, model, p, u, const, precision,
                                   *masked)

    return engine_core.run_fused_chunk(
        step_math, params, m, v, uniforms, step0, lrate, schedule=schedule,
        total_steps=total_steps, decay=decay, precision=precision,
        runtime_bs=runtime_bs, runtime_steps=runtime_steps,
        trial_horizon=trial_horizon)


def _train_packed(spec, model, params, m, v, uniforms, step0, lrate,
                  n_replicas, const, schedule, total_steps, decay,
                  precision, sweep=None, trial_horizon=True):
    """One ``dgm_train_packed`` call on CUDA ``[N, n]`` state, shared by
    both chunk wrappers (a single run is N = 1). The launches run on the
    shape's side stream (graphs.StepGraph.run); a call of at least
    GRAPH_STEPS steps first captures the shape's graph if it is not cached;
    ``precision`` ("highest" | "default") picks the kernels' instances, and
    each has its own graph; ``sweep`` as for ``fused_engine._train_packed``.
    Returns the new (params, m, v, losses [N, K]) and the replica-steps
    whose step math it enqueued."""
    lib = build.library()
    _check_inputs(spec, model, {"params": params, "m": m, "v": v,
                                "uniforms": uniforms}, const, lib, n_replicas)
    K, B, _ = uniforms.shape
    device = uniforms.device
    a = _call_args(spec, model, B, const)
    floats = lib.dgm_scratch_floats(a["R"], B, a["H"], a["L"], a["O"])
    bf16 = int(precision == "default")
    key = ("dgm", spec.kernel_id, a["R"], B, a["H"], a["L"], a["O"],
           n_replicas, a["act"], a["mask"], precision, sweep is not None,
           GRAPH_STEPS, device)
    if not graphs.cached(key):
        engine_core.check_replicas(n_replicas, a["R"], 4 * floats,
                                   torch.cuda.mem_get_info(device)[0])
    entry = graphs.step_graph(key, lambda: graphs.StepGraph(
        "dgm", device, n_replicas, floats, lib.dgm_args_bytes(),
        lib.dgm_graph_free))
    p, m, v = params.clone(), m.clone(), v.clone()
    runs = ctypes.c_int(0)
    entry.sweep, vecs, run = sweep_args(sweep, n_replicas, K, device)
    losses = (torch.empty if sweep is None else torch.zeros)(
        (n_replicas, run), device=device)
    if run >= GRAPH_STEPS and entry.exec is None:
        with torch.cuda.device(device):
            entry.capture(lambda args, scratch, out: lib.dgm_graph_build(
                spec.kernel_id, a["R"], B, a["H"], a["L"], a["O"], a["act"],
                a["mask"], n_replicas, bf16, GRAPH_STEPS,
                int(sweep is not None), args, scratch, out),
                "dgm_graph_build")
    code = entry.run(lambda stream, side0, side1: lib.dgm_train_packed(
        spec.kernel_id, a["consts"], a["const"], p.data_ptr(), m.data_ptr(),
        v.data_ptr(), uniforms.data_ptr(), entry.scratch.data_ptr(),
        losses.data_ptr(), entry.args.data_ptr(), entry.exec, GRAPH_STEPS,
        n_replicas, run, a["R"], B, a["H"], a["L"], a["O"], a["act"],
        a["mask"], bf16, float(lrate), int(step0),
        *engine_core.schedule_args(schedule, total_steps, decay), *vecs,
        int(trial_horizon), ctypes.byref(runs), stream, side0, side1),
        device)
    build.check(code, "dgm_train_packed")
    return (p, m, v, pad_losses(losses, K)), runs.value


def fused_dgm_chunk(spec, model, params, m, v, uniforms, step0, lrate, *,
                    const=None, schedule="constant", total_steps=1,
                    decay=0.1, precision="highest", runtime_steps=None,
                    runtime_bs=None, trial_horizon=True):
    """Run ``K = uniforms.shape[0]`` Adam steps of ``spec``'s equation at
    ``precision`` ("highest" | "default").
    ``params``/``m``/``v`` are flat fp32 buffers (:func:`pack_dgm` order);
    ``uniforms`` is [K, B, spec.n_uniform]; ``const`` the spec's const
    operand (:func:`const_for`); ``step0`` the absolute index of the
    chunk's first step. ``schedule`` ("constant" | "cosine" |
    "exponential") sets the learning rate of step t = step0 + k + 1 over
    the horizon ``total_steps``, decaying to ``lrate · decay``.
    ``runtime_steps``, ``runtime_bs`` and ``trial_horizon``: the sweep mode,
    as for ``fused_engine.fused_engine_chunk`` (the batch mask takes
    collocation rows only; FitzHugh–Nagumo's masked loss is the plain one).

    Returns new (params, m, v, losses[K]); the inputs are left unchanged.
    A CPU tensor takes the plain version; a CUDA tensor launches the kernel
    (``fused_dgm_chunk.launches`` counts the launches, ``.bf16_launches``
    those at "default", and ``fused_dgm_chunk.step_math_runs`` the steps
    whose step math the kernel enqueued, as it reports them)."""
    check_precision(precision, CHUNK_PRECISIONS)
    _check_model(spec, model)
    engine_core.check_schedule(schedule)
    K, B, _ = uniforms.shape
    _check_const(spec, const, B)
    runtime = runtime_bs is not None or runtime_steps is not None
    sweep = engine_core.sweep_vectors(
        1, lrate, B, K, None, None if runtime_bs is None else [runtime_bs],
        [K if runtime_steps is None else runtime_steps] if runtime else None,
        runtime_bs is not None)
    if uniforms.device.type == "cpu":
        return fused_dgm_chunk_plain(
            spec, model, params, m, v, uniforms, step0, lrate, const=const,
            schedule=schedule, total_steps=total_steps, decay=decay,
            precision=precision, runtime_steps=runtime_steps,
            runtime_bs=runtime_bs, trial_horizon=trial_horizon)
    (p, m, v, losses), runs = _train_packed(
        spec, model, params[None], m[None], v[None], uniforms, step0, lrate,
        1, const, schedule, total_steps, decay, precision, sweep,
        trial_horizon)
    count_launch(fused_dgm_chunk, precision, runs, sweep is not None, (B, 1))
    return p[0], m[0], v[0], losses[0]


fused_dgm_chunk.launches = 0
fused_dgm_chunk.bf16_launches = 0
fused_dgm_chunk.step_math_runs = 0
fused_dgm_chunk.bf16_step_math_runs = 0
fused_dgm_chunk.sweep_launches = 0
fused_dgm_chunk.sweep_shapes = {}


def fused_dgm_packed_chunk_plain(spec, model, params, m, v, uniforms, step0,
                                 lrate, n_replicas, rep_tile=None, *,
                                 const=None, schedule="constant",
                                 total_steps=1, decay=0.1, lr_vec=None,
                                 bs_vec=None, steps_vec=None,
                                 mask_rows=False, trial_horizon=True,
                                 precision="highest"):
    """Plain version of :func:`fused_dgm_packed_chunk`."""

    def step_math(p, u, c, precision, *masked):
        return dgm_loss_grad_plain(spec, model, p, u, c, precision, *masked)

    return engine_core.run_fused_packed(
        step_math, params, m, v, uniforms, step0, lrate, n_replicas,
        rep_tile=rep_tile, schedule=schedule, total_steps=total_steps,
        decay=decay, const=const, lr_vec=lr_vec, bs_vec=bs_vec,
        steps_vec=steps_vec, mask_rows=mask_rows,
        trial_horizon=trial_horizon, precision=precision)


def fused_dgm_packed_chunk(spec, model, params, m, v, uniforms, step0, lrate,
                           n_replicas, rep_tile=None, *, const=None,
                           schedule="constant", total_steps=1, decay=0.1,
                           lr_vec=None, bs_vec=None, steps_vec=None,
                           mask_rows=False, trial_horizon=True,
                           precision="highest"):
    """Packed-replica twin of :func:`fused_dgm_chunk` (kernel #5 around
    #7): one call advances ``n_replicas`` independent DGM runs by ``K =
    uniforms.shape[0]`` Adam steps each. ``params``/``m``/``v`` are ``[N,
    n]`` (``engine_core.stack_replicas`` of :func:`pack_dgm` buffers); every
    replica reads the same ``uniforms [K, B, 1]``, ``const`` (Fredholm's
    nodes and weights) and lr schedule. ``rep_tile`` must divide N (every
    launch covers all N replicas on the H100).

    The per-slot sweep vectors (``lr_vec``, ``bs_vec``, ``steps_vec``,
    ``mask_rows``, ``trial_horizon``) as for
    ``fused_engine.fused_engine_packed_chunk``.

    Returns new (params, m, v, losses [N, K]); the inputs are left
    unchanged. ``precision`` is "highest" or "default", as for the single
    chunk. A CPU tensor takes the plain version; a CUDA tensor launches
    ``dgm_train_packed`` once (``.launches``, ``.bf16_launches`` at
    "default"; ``.step_math_runs`` counts the replica-steps whose step math
    it enqueued)."""
    check_precision(precision, CHUNK_PRECISIONS)
    _check_model(spec, model)
    engine_core.check_schedule(schedule)
    engine_core.check_rep_tile(n_replicas, rep_tile)
    K, B, _ = uniforms.shape
    _check_const(spec, const, B)
    engine_core.check_replicas(n_replicas, _layout(spec)[0])
    sweep = engine_core.sweep_vectors(n_replicas, lrate, B, K, lr_vec,
                                      bs_vec, steps_vec, mask_rows)
    if uniforms.device.type == "cpu":
        return fused_dgm_packed_chunk_plain(
            spec, model, params, m, v, uniforms, step0, lrate, n_replicas,
            const=const, schedule=schedule, total_steps=total_steps,
            decay=decay, lr_vec=lr_vec, bs_vec=bs_vec, steps_vec=steps_vec,
            mask_rows=mask_rows, trial_horizon=trial_horizon,
            precision=precision)
    out, runs = _train_packed(spec, model, params, m, v, uniforms, step0,
                              lrate, n_replicas, const, schedule, total_steps,
                              decay, precision, sweep, trial_horizon)
    count_launch(fused_dgm_packed_chunk, precision, runs,
                 sweep is not None, (B, n_replicas))
    return out


fused_dgm_packed_chunk.launches = 0
fused_dgm_packed_chunk.bf16_launches = 0
fused_dgm_packed_chunk.step_math_runs = 0
fused_dgm_packed_chunk.bf16_step_math_runs = 0
fused_dgm_packed_chunk.sweep_launches = 0
fused_dgm_packed_chunk.sweep_shapes = {}


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------


def train_dgm_fused_result(problem, seed, iterations, batch_size=100,
                           lrate=1e-4, chunk_size=25_000, model=None,
                           params=None, opt_state=None, start_step: int = 0,
                           precision: str = "highest",
                           schedule: str | None = None, decay: float = 0.1,
                           total_steps: int | None = None, device="cuda"):
    """Train a DGM-spec'd equation with the fused kernel; returns a
    TrainResult whose ``params`` is the trained model (timings as in
    ``fused_train.train_in_chunks``).

    ``model`` (default: ``problem.default_model()`` initialised from
    ``seed``) is trained in place. ``params`` (a flat buffer) replaces its
    parameters first; ``opt_state`` ({"m", "v"} of an earlier result) and
    ``start_step`` resume a run: step ``i`` draws its collocation points
    from ``(seed, i)`` alone, so a resumed or chunked run equals the uncut
    run bit for bit. ``schedule`` (None = the problem's default) decays
    over ``total_steps`` (default ``start_step + iterations``), both phases
    of a "mixed" run on the one curve. ``precision`` is "highest",
    "default" or "mixed" (the first ``int(iterations·0.65)`` steps at
    "default", then "highest"; 0.65 is ``core.precision.MIXED_SPLIT``)."""
    spec = spec_for(problem, batch_size)
    if spec is None:
        raise ValueError(f"no fused DGM spec for equation {problem.name!r} "
                         f"(fitzhugh_nagumo dgm arch | fredholm gauss)")
    n_default = default_steps(iterations, precision)
    with trace.span("train.setup", trainer="dgm"):
        device = build.resolve_device(device)
        if model is None:
            model = problem.default_model(generator=generator(seed))
        model.to(device)
        _check_model(spec, model)
        kw = dict(const=const_for(spec, problem, batch_size, device),
                  schedule=schedule or problem.defaults.schedule,
                  total_steps=total_steps or start_step + iterations,
                  decay=decay)
        p = pack_dgm(model) if params is None else params.to(device).clone()
        if opt_state is None:
            m, v = torch.zeros_like(p), torch.zeros_like(p)
        else:
            m = opt_state["m"].to(device).clone()
            v = opt_state["v"].to(device).clone()

    def run_chunk(p, m, v, u, step0, precision):
        return fused_dgm_chunk(spec, model, p, m, v, u, step0, lrate,
                               precision=precision, **kw)

    def draw(start, n):
        return step_uniforms(seed, start, n, batch_size, device,
                             spec.n_uniform)

    return train_in_chunks(model, run_chunk, draw, p, m, v, iterations,
                           chunk_size, device, start_step, load=load_dgm,
                           n_default=n_default, trainer="dgm")


def train_dgm_fused_ensemble_packed(problem, seed, iterations, n_replicas,
                                    batch_size=100, lrate=1e-4, model=None,
                                    precision: str = "highest",
                                    schedule: str | None = None,
                                    decay: float = 0.1, chunk_size=25_000,
                                    device="cuda", first: int = 0):
    """Train ``n_replicas`` independently initialised DGM replicas, packed:
    every chunk is one :func:`fused_dgm_packed_chunk` call that advances all
    of them. Replica r is ``model``'s architecture (default: the problem's)
    drawn from ``replica_generator(seed, r)``; all replicas share the
    collocation stream ``step_uniforms(seed, ...)``, Fredholm's const and
    the schedule (None = the problem's default) over ``iterations`` steps.
    So replica r equals ``train_dgm_fused_result`` of that init, and a
    chunked run equals an uncut one.

    Returns a TrainResult whose ``params`` is the list of N trained models,
    ``opt_state`` the ``[N, n]`` moments and ``loss_history`` ``[N,
    iterations]``; ``compile_time``, ``wall_time`` and ``iters_per_sec``
    (population steps per second) as ``fused_train.train_in_chunks``
    reports them. ``precision`` as for :func:`train_dgm_fused_result`,
    every replica on the same schedule. ``first`` numbers the replicas
    from ``first`` (a rank's share of a sharded ensemble)."""
    spec = spec_for(problem, batch_size)
    if spec is None:
        raise ValueError(f"no fused DGM spec for equation {problem.name!r} "
                         f"(fitzhugh_nagumo dgm arch | fredholm gauss)")
    n_default = default_steps(iterations, precision)
    with trace.span("train.setup", trainer="dgm"):
        device = build.resolve_device(device)
        models = replica_models(problem, model, seed, n_replicas, device,
                                first)
        _check_model(spec, models[0])
        kw = dict(const=const_for(spec, problem, batch_size, device),
                  schedule=schedule or problem.defaults.schedule,
                  total_steps=iterations, decay=decay)
        p = engine_core.stack_replicas([pack_dgm(m) for m in models])

    def run_chunk(p, m, v, u, step0, precision):
        return fused_dgm_packed_chunk(spec, models[0], p, m, v, u, step0,
                                      lrate, n_replicas, precision=precision,
                                      **kw)

    def draw(start, n):
        return step_uniforms(seed, start, n, batch_size, device,
                             spec.n_uniform)

    def load(models, p):
        for model, row in zip(models, p):
            load_dgm(model, row)

    return train_in_chunks(models, run_chunk, draw, p, torch.zeros_like(p),
                           torch.zeros_like(p), iterations, chunk_size,
                           device, load=load, n_default=n_default,
                           trainer="dgm")

def train_dgm_fused_ensemble(problem, seed, iterations, n_replicas,
                             mesh=None, batch_size=100, lrate=1e-4,
                             model=None, precision: str = "highest",
                             schedule: str | None = None, decay: float = 0.1,
                             timings: dict | None = None, chunk_size=25_000,
                             device="cuda"):
    """DGM counterpart of ``fused_engine.train_fused_ensemble`` (JAX
    ``train_dgm_fused_ensemble``): the replicas sharded over ``mesh``'s
    ``pop`` axis, each rank's as one packed run
    (:func:`train_dgm_fused_ensemble_packed`, kernel #5 around #7), or
    with ``mesh=None`` one after another on kernel #4
    (:func:`train_dgm_fused_result`); Fredholm's const operand on every
    path. Returns (the N trained models, losses ``[N, iterations]``
    numpy), on every rank; ``timings`` receives ``compile_time`` and
    ``run_time``."""
    kw = dict(batch_size=batch_size, lrate=lrate, precision=precision,
              schedule=schedule, decay=decay, chunk_size=chunk_size)

    def single(replica, device):
        return train_dgm_fused_result(problem, seed, iterations,
                                      model=replica, device=device, **kw)

    def packed(n, first, device):
        return train_dgm_fused_ensemble_packed(problem, seed, iterations, n,
                                               model=model, device=device,
                                               first=first, **kw)

    if spec_for(problem, batch_size) is None:
        raise ValueError(f"no fused DGM spec for equation {problem.name!r} "
                         f"(fitzhugh_nagumo dgm arch | fredholm gauss)")
    return train_ensemble(problem, model, seed, n_replicas, mesh, device,
                          single, packed, pack_dgm, load_dgm, timings)


# ---------------------------------------------------------------------------
# The sweep evaluators (sweep/search.py's fused tier)
# ---------------------------------------------------------------------------


def _sweep_spec(problem, model, batch_size):
    """The spec and model of a DGM sweep evaluator at ``batch_size`` rows
    (``model`` None: the problem's default architecture), checked."""
    spec = spec_for(problem, batch_size)
    if spec is None:
        raise ValueError(f"no fused DGM spec for {problem.name!r}")
    arch = model or problem.default_model()
    _check_model(spec, arch)
    return spec, arch


def _trial_states(problem, model, seed, trial_indices, device):
    return fused_engine.trial_state(problem, model, seed, trial_indices,
                                    pack_dgm, device)


def make_trial_evaluator(problem, seed, iterations, batch_size=100,
                         lrate=1e-4, model=None, precision="highest",
                         schedule=None, decay=0.1, device="cuda"):
    """``eval_fn(trial_index, lr=None) -> (losses [iterations] numpy, flat
    params)``: each call trains trial ``trial_index``'s fresh DGM
    (``fused_engine.trial_state``) for the full budget at ``lr`` (None:
    ``lrate``) through the same kernels and CUDA graph; the collocation
    stream ``step_uniforms(seed, 0, iterations, batch_size)`` and
    Fredholm's nodes are shared by every trial. "mixed" runs its two
    phases as :func:`train_dgm_fused_result` does."""
    spec, arch = _sweep_spec(problem, model, batch_size)
    device = build.resolve_device(device)
    schedule = schedule or problem.defaults.schedule
    n_default = default_steps(iterations, precision)
    uniforms = step_uniforms(seed, 0, iterations, batch_size, device,
                             spec.n_uniform)
    kw = dict(const=const_for(spec, problem, batch_size, device),
              schedule=schedule, total_steps=iterations, decay=decay)

    def eval_fn(trial_index: int, lr: float | None = None):
        p = _trial_states(problem, model, seed, [trial_index], device)[0]
        m, v = torch.zeros_like(p), torch.zeros_like(p)
        losses = []
        for lo, hi, prec in ((0, n_default, "default"),
                             (n_default, iterations, "highest")):
            if hi > lo:
                p, m, v, part = fused_dgm_chunk(
                    spec, arch, p, m, v, uniforms[lo:hi], lo,
                    float(lrate if lr is None else lr), precision=prec, **kw)
                losses.append(part)
        return torch.cat(losses).cpu().numpy(), p

    return eval_fn


def _sweep_problem(problem, max_batch):
    """The problem a batch-size sweep trains (``max_batch`` not None), as
    the JAX evaluators take it: FitzHugh–Nagumo at ``causal_eps=0`` (its
    causal build sorts the rows by time, so a row prefix would train a
    short trial on early times only), and Fredholm only if its k nodes fit
    one tile."""
    if max_batch is None:
        return problem
    if problem.name == "fitzhugh_nagumo" and problem.causal_eps > 0.0:
        return dataclasses.replace(problem, causal_eps=0.0)
    if problem.name == "fredholm" and problem.k > max_batch:
        raise ValueError(f"runtime-batch sweeps need the {problem.k} "
                         f"quadrature nodes to fit one max_batch tile (got "
                         f"max_batch={max_batch}); raise max_batch or lower "
                         f"k")
    return problem


def _sweep_prologue(problem, seed, max_iters, batch_size, model, precision,
                    schedule, device):
    """What the DGM sweep evaluators share (JAX ``_sweep_prologue``): the
    checks, "mixed" refused, the stream padded to a multiple of 1 000
    steps. Returns (spec, model, schedule, const, user_max, padded_max,
    uniforms, device)."""
    spec, arch = _sweep_spec(problem, model, batch_size)
    fused_engine.check_single_phase(precision)
    device = build.resolve_device(device)
    schedule = schedule or problem.defaults.schedule
    padded = fused_engine.padded_horizon(max_iters)
    uniforms = step_uniforms(seed, 0, padded, batch_size, device,
                             spec.n_uniform)
    return (spec, arch, schedule, const_for(spec, problem, batch_size, device),
            int(max_iters), padded, uniforms, device)


def make_sweep_evaluator(problem, seed, max_iters, batch_size=100,
                         max_batch=None, model=None, precision="highest",
                         schedule=None, decay=0.1, horizon="trial",
                         device="cuda"):
    """A DGM sweep on one tile. ``max_batch`` None: the {lrate, n_iters}
    space at ``batch_size`` rows, ``eval_fn(trial_index, lrate, n_iters)``;
    ``max_batch=M``: the full reference space on an M-row tile,
    ``eval_fn(trial_index, lrate, batch_size, n_iters)``, collocation rows
    ≥ batch_size masked out of the loss (Fredholm's nodes never; a
    FitzHugh–Nagumo sweep trains at ``causal_eps=0``:
    :func:`_sweep_problem`). Each returns (losses [n_iters] numpy, flat params), the n_iters-step
    state; ``horizon`` as in ``fused_engine.make_sweep_evaluator``."""
    fused_engine.check_horizon(horizon)
    problem = _sweep_problem(problem, max_batch)
    if max_batch is not None:
        batch_size = int(max_batch)
    spec, arch, schedule, const, user_max, padded, uniforms, device = \
        _sweep_prologue(problem, seed, max_iters, batch_size, model,
                        precision, schedule, device)

    def run(trial_index, lrate, bs, n_iters):
        n = max(1, min(int(n_iters), user_max))
        p = _trial_states(problem, model, seed, [trial_index], device)[0]
        zeros = torch.zeros_like(p)
        p, _, _, losses = fused_dgm_chunk(
            spec, arch, p, zeros, zeros,
            uniforms[:fused_engine.live_steps(n, padded)], 0, float(lrate),
            const=const, schedule=schedule, total_steps=user_max,
            decay=decay, precision=precision, runtime_steps=n,
            runtime_bs=bs, trial_horizon=horizon == "trial")
        return losses[:n].cpu().numpy(), p

    if max_batch is None:
        def eval_fn(trial_index: int, lrate: float, n_iters: int):
            return run(trial_index, lrate, None, n_iters)

        return eval_fn

    def eval_fn_bs(trial_index: int, lrate: float, bs: int, n_iters: int):
        return run(trial_index, lrate, max(1, min(int(bs), batch_size)),
                   n_iters)

    return eval_fn_bs


def make_packed_rung_evaluator(problem, seed, max_iters, n_slots,
                               batch_size=100, max_batch=None, model=None,
                               precision="highest", schedule=None, decay=0.1,
                               horizon="fixed", rep_tile=None, device="cuda"):
    """A vector of ``n_slots`` DGM trials as one packed call (kernel #5
    around #7 in its sweep mode): ``eval_fn(trial_indices, lrates,
    batch_sizes, n_iters) -> (final_losses [n_slots] numpy, flat params
    [n_slots, n])``, slot i at its own lr and budget (0: pruned, +inf) and,
    with ``max_batch``, its own batch (otherwise batch_sizes are clamped
    and not used); slot i equals :func:`make_sweep_evaluator`'s trial."""
    run = _packed_rung(problem, seed, max_iters, batch_size, max_batch,
                       model, precision, schedule, decay, horizon, rep_tile,
                       device)

    def eval_fn(trial_indices, lrates, batch_sizes, n_iters):
        if len(trial_indices) != n_slots:
            raise ValueError(f"expected {n_slots} slots "
                             f"(got {len(trial_indices)})")
        return run(trial_indices, lrates, batch_sizes, n_iters)

    return eval_fn


def _packed_rung(problem, seed, max_iters, batch_size, max_batch, model,
                 precision, schedule, decay, horizon, rep_tile, device):
    """:func:`make_packed_rung_evaluator`'s call for any number of slots
    (``len(trial_indices)``), on one stream and const operand."""
    fused_engine.check_horizon(horizon)
    problem = _sweep_problem(problem, max_batch)
    mask_rows = max_batch is not None
    if mask_rows:
        batch_size = int(max_batch)
    spec, arch, schedule, const, user_max, padded, uniforms, device = \
        _sweep_prologue(problem, seed, max_iters, batch_size, model,
                        precision, schedule, device)

    def run(trial_indices, lrates, batch_sizes, n_iters):
        n_slots = len(trial_indices)
        ns = np.clip(np.asarray(n_iters, np.int64), 0, user_max)
        bss = np.clip(np.asarray(batch_sizes, np.int64), 1, batch_size)
        p = _trial_states(problem, model, seed, trial_indices, device)
        zeros = torch.zeros_like(p)
        p, _, _, losses = fused_dgm_packed_chunk(
            spec, arch, p, zeros, zeros,
            uniforms[:fused_engine.live_steps(ns, padded)], 0, 0.0, n_slots,
            rep_tile, const=const, schedule=schedule, total_steps=user_max,
            decay=decay, lr_vec=np.asarray(lrates, np.float32),
            bs_vec=bss if mask_rows else None, steps_vec=ns,
            mask_rows=mask_rows, trial_horizon=horizon == "trial",
            precision=precision)
        losses = losses.cpu().numpy()
        finals = np.where(ns > 0, losses[np.arange(n_slots),
                                         np.maximum(ns - 1, 0)], np.inf)
        return finals, p

    return run


def make_sharded_rung_evaluator(problem, seed, max_iters, mesh,
                                batch_size=100, max_batch=None, model=None,
                                precision="highest", schedule=None,
                                decay=0.1, horizon="trial", device="cuda"):
    """DGM counterpart of ``fused_engine.make_sharded_rung_evaluator`` (JAX
    ``make_sharded_rung_evaluator``): ``eval_fn(trial_indices, lrates,
    batch_sizes, n_iters) -> (final_losses [P] numpy, flat params [P,
    n])`` on every rank, each rank's P / n slots as one packed call
    (kernel #5 around #7 in its sweep mode) with
    :func:`make_packed_rung_evaluator`'s trials, stream and const operand.
    ``max_batch`` None: every trial at ``batch_size`` rows (batch_sizes
    not used); ``max_batch=M``: each masks rows ≥ its own batch size on an
    M-row tile. P must be a multiple of the ``pop`` axis' size; budgets
    clamp to [1, max_iters]."""
    return fused_engine.sharded_rungs(
        mesh, device, max_iters, lambda dev: _packed_rung(
            problem, seed, max_iters, batch_size, max_batch, model,
            precision, schedule, decay, horizon, None, dev))
