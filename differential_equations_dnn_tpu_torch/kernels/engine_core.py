"""The generic K-step Adam loop of the fused engines, in plain PyTorch.

Counterpart of the JAX package's kernels/engine_core.py
(``fused_adam_kernel`` around a pluggable ``step_math``). The CUDA version
of the loop is ``engine_train_packed`` in csrc/engine_train.cu, reached
through ``fused_engine.fused_engine_chunk`` (one replica) and
``fused_engine_packed_chunk``; this module holds what both share:

* the per-step learning rate of the three schedules, computed in fp32 from
  the absolute step ``t = step0 + k + 1`` with the JAX kernel's formulas,
  and the plain Adam update (:func:`adam_update`) every fused trainer's
  plain version applies;
* :func:`run_fused_chunk`, the plain loop the kernel is held against;
* :func:`check_state_fits`, the H100 rule that replaces the JAX package's
  VMEM rule (``_check_state_fits``);
* the packed-replica layout (:func:`stack_replicas`,
  :func:`unstack_replicas`), :func:`run_fused_packed`, the plain twin of
  the packed kernel (#5, ``fused_packed_adam_kernel``), and
  :func:`check_replicas`, the limits of a packed launch;
* the sweep mode of both loops (the JAX kernels' run-time scalars and
  per-slot vectors): rows ≥ bs masked out of the loss, steps at or past
  the budget doing nothing, and the trial's own budget as a decaying
  schedule's horizon (:func:`sweep_vectors` checks a call's values);
* :func:`check_const`, the checks of the const operand a step math may
  read (one buffer per call, shared by every replica).

The flat state is the six MLP tensors followed by a spec's extra trainable
tensors (``fused_engine.pack_state``): the plain loops update it as one
buffer, so an extra tensor takes the same Adam step as the rest.

The TPU kernel splits a large batch into T gradient-accumulation tiles;
equal tiles average to the full-batch gradient, so the port always computes
the whole batch and only checks that ``batch_tile`` divides it.
"""

import math

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.core.precision import (
    check_precision,
)

_B1, _B2, _EPS = 0.9, 0.999, 1e-8
SCHEDULES = ("constant", "cosine", "exponential")

# Shared memory one block may take on an H100 (232 448 bytes).
SMEM_LIMIT = 227 * 1024
# The largest grid y or z extent; a packed launch puts N·R there.
MAX_GRID_YZ = 65_535

# csrc/stream_layer.cuh's plan, shared by the MLP engine and the heat kernel:
# the layer kernel's tiles (batch points × columns), its k-tile and ring
# depth, and the weight gradient's tiles (k × m, rows per chunk, ring depth;
# one thread group per stream).
LAYER_TILES = ((8, 64), (8, 32), (2, 32))
# At R = 1 (uat's one value stream, volterra's folded groups) the tiles
# take 4 times the rows, so that a block has a thread per staged row.
LAYER_TILES_R1 = ((32, 64), (32, 32), (8, 32))
K_TILE, STAGES = 32, 3
WG_TILES = ((32, 16), (16, 16))
WG_ROWS, WG_STAGES = 16, 4
# The widest hidden width the plan holds: the weight gradient's k-tiles (16
# rows at the smallest) along the grid's y extent.
MAX_WIDTH = MAX_GRID_YZ * 16


def step_plan(R, groups=None):
    """(layer, weight_grad): the bytes of shared memory per block of the
    largest layer tile (its ring of k-tiles of the R·BB operand rows and of
    the weight, beside the tile's running sums) at R streams and of the
    largest weight-gradient tile at ``groups`` thread groups (default R:
    one per stream), as ``dednn::step_smem_bytes`` plans them; the same at
    every width."""
    G = R if groups is None else groups
    tiles = LAYER_TILES_R1 if R == 1 else LAYER_TILES
    layer = max(4 * (STAGES * (R * bb * (K_TILE + 4)
                               + max(K_TILE * (bn + 4), bn * (K_TILE + 4)))
                     + R * bb * (bn + 4))
                for bb, bn in tiles)
    weight = max(4 * (WG_STAGES * G * WG_ROWS * ((bk + 4) + (bm + 4) + 1)
                      + (G + 1) * (bk * bm + 2 * bm))
                 for bk, bm in WG_TILES)
    return layer, weight

def check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r} "
                         f"({' | '.join(SCHEDULES)})")


def scheduled_lr(lrate, t, schedule="constant", horizon=1.0, decay=0.1):
    """The learning rate of step ``t`` (a 1-indexed fp32 tensor), as the JAX
    kernel computes it (engine_core.py:128-151): cosine decays from lrate to
    lrate·decay over ``horizon`` steps and then holds; exponential reaches
    lrate·decay at ``horizon``. ``lrate`` is a float or, for a CUDA graph
    (which cannot copy a host number in), an fp32 tensor on t's device."""
    lr = (lrate if torch.is_tensor(lrate)
          else torch.tensor(lrate, dtype=torch.float32, device=t.device))
    horizon = float(horizon)
    if schedule == "cosine":
        frac = torch.clamp_max((t - 1.0) / horizon, 1.0)
        return lr * (decay + (1.0 - decay) * 0.5
                     * (1.0 + torch.cos(math.pi * frac)))
    if schedule == "exponential":
        return lr * torch.exp(((t - 1.0) / horizon) * math.log(decay))
    check_schedule(schedule)
    return lr


def schedule_args(schedule, total_steps, decay):
    """The schedule as the C entry points take it: kind, horizon, decay,
    (1 − decay)/2 and log(decay), each rounded from double."""
    return (SCHEDULES.index(schedule), float(total_steps), float(decay),
            (1.0 - decay) * 0.5, math.log(decay) if decay > 0 else -math.inf)


def check_state_fits(need: int, R: int, H: int) -> None:
    """Reject a plan whose kernels cannot be staged on one SM.

    The Adam state lives in device memory (L2-resident at these sizes) and
    never limits the model; what could is the shared memory a kernel
    stages per block: ``need`` bytes, as csrc/engine_train.cu reports it
    (``engine_smem_bytes``; ``fused_engine.engine_plan`` mirrors it),
    against the 227 KB a block may take on an H100. The kernels stage every
    operand in k-tiles, so ``need`` depends on R and the tiles, not on H;
    the widest width is ``fused_engine.MAX_WIDTH``. The plain version has
    no such limit."""
    if need > SMEM_LIMIT:
        raise ValueError(
            f"hidden width {H} with {R} streams needs {need} bytes of shared "
            f"memory per block in the fused engine's backward (the H100 "
            f"allows {SMEM_LIMIT}); use a smaller hidden size")


def check_const(const, shape, what: str) -> None:
    """``const`` must have ``shape`` (None: the step math takes no const
    operand, and ``const`` must be None too); raises a ValueError naming
    ``what`` before anything launches."""
    if shape is None:
        if const is not None:
            raise ValueError(f"{what} takes no const operand")
        return
    got = None if const is None else tuple(const.shape)
    if got != tuple(shape):
        raise ValueError(f"{what} needs its const operand of shape "
                         f"{tuple(shape)} (got {got})")


def adam_update(p, m, v, g, lr, t):
    """Adam with torch defaults; ``t`` is the 1-indexed global step as an
    fp32 tensor."""
    m = _B1 * m + (1.0 - _B1) * g
    v = _B2 * v + (1.0 - _B2) * (g * g)
    c1 = 1.0 - torch.exp(t * math.log(_B1))
    c2 = 1.0 - torch.exp(t * math.log(_B2))
    p = p - lr * (m / c1) / (torch.sqrt(v / c2) + _EPS)
    return p, m, v


def check_batch_tile(B: int, batch_tile: int | None) -> None:
    """``batch_tile`` (None: the whole batch) must divide B."""
    if batch_tile is not None and B % batch_tile:
        raise ValueError(f"batch {B} not divisible by batch_tile {batch_tile}")


def batch_mask(B, bs, device=None):
    """The sweep mode's row mask ``[B, 1]`` (rows < bs are 1) and 1/bs,
    an fp32 division as the kernels take it."""
    rows = torch.arange(B, device=device)[:, None]
    mask = (rows < int(bs)).to(torch.float32)
    return mask, 1.0 / torch.tensor(float(bs), device=device)


def run_fused_chunk(step_math, params, m, v, uniforms, step0, lrate, *,
                    schedule="constant", total_steps=1, decay=0.1,
                    batch_tile=None, precision="highest", runtime_bs=None,
                    runtime_steps=None, trial_horizon=True):
    """Run ``K = uniforms.shape[0]`` Adam steps with ``step_math(params,
    u, precision) -> (loss, flat_grad)`` on flat fp32 buffers, every step at
    ``precision`` ("highest" | "default"). The schedule's horizon is
    ``total_steps`` whatever the precision, so the two phases of a "mixed"
    run share one lr curve. Returns new (params, m, v, losses[K]); the
    inputs are left unchanged.

    The sweep mode (JAX ``fused_adam_kernel``'s run-time scalars):
    ``runtime_bs`` masks rows ≥ bs out of the loss, calling
    ``step_math(params, u, precision, mask01 [B, 1], inv_bs)``;
    ``runtime_steps`` makes the chunk's steps k ≥ n_steps leave params, m
    and v alone with loss 0; with ``trial_horizon`` (and either of the
    two) a decaying schedule's horizon is max(n_steps, 1), else
    ``total_steps``."""
    K, B, _ = uniforms.shape
    check_schedule(schedule)
    check_batch_tile(B, batch_tile)
    check_precision(precision, ("highest", "default"))
    has_runtime = runtime_bs is not None or runtime_steps is not None
    n_steps = K if runtime_steps is None else int(runtime_steps)
    if has_runtime and trial_horizon and schedule != "constant":
        total_steps = max(n_steps, 1)
    masked = () if runtime_bs is None else batch_mask(B, runtime_bs,
                                                      params.device)
    losses = []
    for k in range(K):
        if k >= n_steps:
            losses.append(params.new_zeros(()))
            continue
        loss, g = step_math(params, uniforms[k], precision, *masked)
        t = torch.tensor(step0 + k + 1, dtype=torch.float32,
                         device=params.device)
        lr = scheduled_lr(lrate, t, schedule, total_steps, decay)
        params, m, v = adam_update(params, m, v, g, lr, t)
        losses.append(loss.reshape(()))
    return params, m, v, torch.stack(losses)


# ---------------------------------------------------------------------------
# Packed replicas (kernel #5)
# ---------------------------------------------------------------------------


def _lead(shape):
    """The per-replica extent of the leading dim in the packed layout: the
    replica axis is folded into the leading dim, [N, *s] stored as [N·s0,
    s1, ...], and a 1-D tensor becomes [N, s0] (JAX engine_core.py:170)."""
    return shape[0] if len(shape) >= 2 else 1


def stack_replicas(flats):
    """N per-replica tensors of one shape s in the packed layout [N·_lead(s),
    *s[1:]]. The port keeps p, m and v as one flat buffer per replica, so
    its packed state is ``[N, n_params]``, replica-major."""
    return torch.cat([f.reshape((_lead(f.shape),) + tuple(f.shape[1:]))
                      if f.dim() >= 2 else f[None] for f in flats], 0)


def unstack_replicas(packed, shape, n):
    """Inverse of :func:`stack_replicas`: the N per-replica tensors of
    ``shape`` (views)."""
    lead = _lead(shape)
    return [packed[r * lead:(r + 1) * lead].reshape(shape) for r in range(n)]


def check_replicas(n_replicas, R, scratch_bytes=0, free_bytes=None):
    """The limits of a packed launch on the H100: N ≥ 1, N·R within the
    grid's y/z extent (the bound of a packed call since the engines' first
    design, which indexed replica × stream there; the kernels now index the
    replica alone), and, where ``free_bytes`` is given, N copies of the
    per-replica scratch in free device memory. Raises before anything is
    launched."""
    if n_replicas < 1:
        raise ValueError(f"n_replicas must be at least 1 (got {n_replicas})")
    if n_replicas * R > MAX_GRID_YZ:
        raise ValueError(
            f"{n_replicas} replicas × {R} streams exceed the grid's "
            f"{MAX_GRID_YZ} blocks along y/z; use at most "
            f"{MAX_GRID_YZ // R} replicas per call")
    need = n_replicas * scratch_bytes
    if free_bytes is not None and need > free_bytes:
        raise ValueError(
            f"{n_replicas} replicas need {need} bytes of scratch; the device "
            f"has {free_bytes} free; train fewer replicas per call")


def check_rep_tile(n_replicas, rep_tile):
    """``rep_tile`` (None: all) must divide N, as in the JAX package. On the
    H100 every launch covers all N replicas: the TPU's replica tile existed
    only to bound the VMEM grant."""
    if rep_tile is not None and n_replicas % rep_tile:
        raise ValueError(f"n_replicas {n_replicas} not divisible by "
                         f"rep_tile {rep_tile}")


def sweep_vectors(n_replicas, lrate, B, K, lr_vec=None, bs_vec=None,
                  steps_vec=None, mask_rows=False):
    """The packed sweep mode's per-slot values as host numpy vectors of N
    (JAX ``run_fused_packed``'s defaults: lrate, B and K), or None outside
    it (all three vectors None and no ``mask_rows``). ``mask_rows`` without
    ``bs_vec`` masks at B. Each bs must lie in [1, B] and each budget be
    at least 0 (a budget past K gates no step of the call)."""
    if (lr_vec is None and bs_vec is None and steps_vec is None
            and not mask_rows):
        return None

    def vec(x, default, dtype):
        if x is None:
            return np.full(n_replicas, default, dtype)
        x = x.detach().cpu().numpy() if torch.is_tensor(x) else x
        x = np.asarray(x).astype(dtype).reshape(-1)
        if x.shape != (n_replicas,):
            raise ValueError(f"a per-slot vector holds {x.shape[0]} values "
                             f"for {n_replicas} replicas")
        return x

    lrs = vec(lr_vec, lrate, np.float32)
    bss = vec(bs_vec, B, np.int32)
    ns = vec(steps_vec, K, np.int32)
    if mask_rows and (bss.min() < 1 or bss.max() > B):
        raise ValueError(f"per-slot batch sizes must lie in [1, {B}] "
                         f"(got {bss.min()} .. {bss.max()})")
    if ns.min() < 0:
        raise ValueError(f"per-slot step budgets must be at least 0 "
                         f"(got {ns.min()})")
    return lrs, (bss if mask_rows else None), ns


def run_fused_packed(step_math, params, m, v, uniforms, step0, lrate,
                     n_replicas, *, rep_tile=None, schedule="constant",
                     total_steps=1, decay=0.1, const=None, lr_vec=None,
                     bs_vec=None, steps_vec=None, mask_rows=False,
                     trial_horizon=True, precision="highest"):
    """Plain twin of the packed kernel (JAX ``run_fused_packed``): ``K =
    uniforms.shape[0]`` Adam steps for each of ``n_replicas`` independent
    runs at ``precision``, with ``step_math(p, u, const, precision) ->
    (loss, flat_grad)``. ``params``,
    ``m`` and ``v`` are ``[N, n]`` (:func:`stack_replicas`); all replicas
    share ``uniforms [K, B, U]``, ``const`` and the lr schedule. Returns new
    (params, m, v, losses [N, K]); the inputs are left unchanged.

    ``rep_tile`` must divide N; on the H100 every launch covers all N
    replicas (the TPU tiled them to fit VMEM). ``lr_vec``, ``bs_vec`` and
    ``steps_vec`` ([N] each; :func:`sweep_vectors`) switch on the packed
    sweep mode: slot r trains at its own lr, masks rows ≥ bs[r] out of its
    loss (``mask_rows``, with ``step_math(p, u, const, precision, mask01,
    inv_bs)``) and stops at its own budget (0: a pruned slot, which
    returns its input state and losses of 0); with ``trial_horizon`` a
    decaying schedule runs over the slot's own budget."""
    check_rep_tile(n_replicas, rep_tile)
    if params.shape[0] != n_replicas:
        raise ValueError(f"params hold {params.shape[0]} replicas, "
                         f"n_replicas is {n_replicas}")
    K, B, _ = uniforms.shape
    sweep = sweep_vectors(n_replicas, lrate, B, K, lr_vec, bs_vec,
                          steps_vec, mask_rows)

    def one_step_math(p, u, precision, *masked):
        return step_math(p, u, const, precision, *masked)

    def run(r):
        kw = {}
        lr = lrate
        if sweep is not None:
            lrs, bss, ns = sweep
            lr = torch.tensor(lrs[r], device=params.device)
            kw = dict(runtime_bs=None if bss is None else int(bss[r]),
                      runtime_steps=int(ns[r]), trial_horizon=trial_horizon)
        return run_fused_chunk(one_step_math, params[r], m[r], v[r],
                               uniforms, step0, lr, schedule=schedule,
                               total_steps=total_steps, decay=decay,
                               precision=precision, **kw)

    # The replicas are independent: each is the single-replica loop.
    return tuple(torch.stack(t) for t in zip(*map(run, range(n_replicas))))
