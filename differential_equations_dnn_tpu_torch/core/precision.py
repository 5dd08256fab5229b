"""Matmul precision policy and the product helpers used by the models and by
the fused trainers' plain step math.

The physics residuals take second derivatives through small networks, so
matmul rounding shows up directly in the PDE residual. The port therefore
runs strict IEEE fp32 by default: TF32 is off for matmuls and for cuDNN.
Importing this module sets that policy for the process; it is the
counterpart of the JAX package pinning ``lax.Precision.HIGHEST``.

The fused trainers take three precisions, as the JAX package's do
(``api.solve``'s ``precision``):

* ``"highest"`` — every product in exact fp32;
* ``"default"`` — every product that the JAX step math gives ``precision``
  takes bf16 inputs (each operand rounded to nearest even) and accumulates
  in fp32, as a TPU's ``Precision.DEFAULT`` does; products the JAX step
  math pins to ``HIGHEST`` stay fp32;
* ``"mixed"`` — a schedule: the first ``int(K·split)`` of K steps at
  ``"default"``, the rest at ``"highest"`` (:func:`default_steps`).
"""

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

PRECISIONS = ("highest", "default", "mixed")
# The share of a "mixed" run's steps at "default" (the JAX package's
# mixed_split).
MIXED_SPLIT = 0.65


def dense(x, w, b=None):
    """y = x @ w (+ b), with ``w`` stored ``[fan_in, fan_out]``."""
    y = x @ w
    if b is not None:
        y = y + b
    return y


def check_precision(precision: str, modes=PRECISIONS) -> None:
    """A ValueError for a precision outside ``modes``."""
    if precision not in modes:
        raise ValueError(f"unknown precision {precision!r} "
                         f"({' | '.join(modes)})")


def bf16_round(x):
    """``x`` rounded to bf16 (nearest even) and back to fp32: the value a
    ``"default"`` product sees."""
    return x.to(torch.bfloat16).to(x.dtype)


def matmul(a, b, precision="highest"):
    """``a @ b`` at ``precision`` ("highest" | "default"). At "default"
    both operands are rounded to bf16 and multiplied in fp32 with TF32 off:
    a product of two bf16 values is exact in fp32, so only the summation
    order differs from the card's tensor cores."""
    check_precision(precision, ("highest", "default"))
    if precision == "default":
        a, b = bf16_round(a), bf16_round(b)
    return a @ b


def default_steps(iterations: int, precision: str,
                  split: float = MIXED_SPLIT) -> int:
    """The number of a run's first steps that train at "default" (the rest
    train at "highest"): all of them at "default", none at "highest", and
    ``int(iterations·split)`` at "mixed", which falls back to "highest"
    (0) where that leaves either phase empty, as the JAX package does."""
    check_precision(precision)
    if precision == "highest":
        return 0
    if precision == "default":
        return iterations
    n1 = int(iterations * split)
    return n1 if 0 < n1 < iterations else 0
