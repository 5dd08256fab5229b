"""The generic K-step Adam loop of the fused engines, in plain PyTorch.

Counterpart of the JAX package's kernels/engine_core.py
(``fused_adam_kernel`` around a pluggable ``step_math``). The CUDA version
of the loop is ``engine_train`` in csrc/engine_train.cu, reached through
``fused_engine.fused_engine_chunk``; this module holds what both share:

* the per-step learning rate of the three schedules, computed in fp32 from
  the absolute step ``t = step0 + k + 1`` with the JAX kernel's formulas;
* :func:`run_fused_chunk`, the plain loop the kernel is held against;
* :func:`check_state_fits`, the H100 rule that replaces the JAX package's
  VMEM rule (``_check_state_fits``).

The TPU kernel splits a large batch into T gradient-accumulation tiles;
equal tiles average to the full-batch gradient, so the port always computes
the whole batch and only checks that ``batch_tile`` divides it.
"""

import math

import torch

from differential_equations_dnn_tpu_torch.kernels.fused_train import (
    adam_update,
    check_batch_tile,
)

SCHEDULES = ("constant", "cosine", "exponential")

# Shared memory one block may take on an H100 (232 448 bytes).
SMEM_LIMIT = 227 * 1024

_TODO = {
    "runtime_bs": "queue 1, item 13: the sweep evaluators' runtime masks",
    "runtime_steps": "queue 1, item 13: the sweep evaluators' runtime masks",
    "const": "queue 1, item 10b: volterra's const operand",
}


def not_ported(option: str) -> NotImplementedError:
    return NotImplementedError(f"{option} is not ported yet (ROADMAP.md "
                               f"{_TODO[option]})")


def check_schedule(schedule: str) -> None:
    if schedule not in SCHEDULES:
        raise ValueError(f"unknown schedule {schedule!r} "
                         f"({' | '.join(SCHEDULES)})")


def scheduled_lr(lrate, t, schedule="constant", horizon=1.0, decay=0.1):
    """The learning rate of step ``t`` (a 1-indexed fp32 tensor), as the JAX
    kernel computes it (engine_core.py:128-151): cosine decays from lrate to
    lrate·decay over ``horizon`` steps and then holds; exponential reaches
    lrate·decay at ``horizon``."""
    lr = torch.tensor(lrate, dtype=torch.float32, device=t.device)
    horizon = float(horizon)
    if schedule == "cosine":
        frac = torch.clamp_max((t - 1.0) / horizon, 1.0)
        return lr * (decay + (1.0 - decay) * 0.5
                     * (1.0 + torch.cos(math.pi * frac)))
    if schedule == "exponential":
        return lr * torch.exp(((t - 1.0) / horizon) * math.log(decay))
    check_schedule(schedule)
    return lr


def check_state_fits(need: int, R: int, H: int) -> None:
    """Reject widths whose layer kernels cannot be staged on one SM.

    The Adam state lives in device memory (L2-resident at these sizes) and
    never limits the model; what does is the shared memory a layer kernel
    stages per block: ``need`` bytes, as csrc/engine_train.cu reports it
    (``engine_smem_bytes``), against the 227 KB a block may take on an
    H100. The plain version has no such limit."""
    if need > SMEM_LIMIT:
        raise ValueError(
            f"hidden width {H} with {R} streams needs {need} bytes of shared "
            f"memory per block in the fused engine's backward (the H100 "
            f"allows {SMEM_LIMIT}); use a smaller hidden size")


def run_fused_chunk(step_math, params, m, v, uniforms, step0, lrate, *,
                    schedule="constant", total_steps=1, decay=0.1,
                    batch_tile=None):
    """Run ``K = uniforms.shape[0]`` Adam steps with ``step_math(params,
    u) -> (loss, flat_grad)`` on flat fp32 buffers. Returns new (params, m,
    v, losses[K]); the inputs are left unchanged."""
    K, B, _ = uniforms.shape
    check_schedule(schedule)
    check_batch_tile(B, batch_tile)
    losses = []
    for k in range(K):
        loss, g = step_math(params, uniforms[k])
        t = torch.tensor(step0 + k + 1, dtype=torch.float32,
                         device=params.device)
        lr = scheduled_lr(lrate, t, schedule, total_steps, decay)
        params, m, v = adam_update(params, m, v, g, lr, t)
        losses.append(loss.reshape(()))
    return params, m, v, torch.stack(losses)
