"""Weight initializers drawn from an explicit ``torch.Generator``.

The bounds are those of the JAX package (and of torch.nn.init): xavier
uniform with an activation gain for tanh/sigmoid nets, kaiming uniform for
relu nets, and the ``nn.Linear`` default U(±1/sqrt(fan_in)) for biases.

Weights are stored ``[fan_in, fan_out]`` (``y = x @ W + b``), so
``fan_in = shape[0]`` — the layout of the JAX package, so that parameters
carry across 1:1. Draws happen on the CPU and are moved afterwards, so a
seed gives the same weights on every device.
"""

import math

import torch

_GAINS = {
    "linear": 1.0,
    "sigmoid": 1.0,
    "tanh": 5.0 / 3.0,
    "relu": math.sqrt(2.0),
    "leaky_relu": math.sqrt(2.0 / (1.0 + 0.01**2)),
    "identity": 1.0,
}


def calculate_gain(nonlinearity: str, param: float | None = None) -> float:
    """Gain factor per nonlinearity (same table as torch.nn.init.calculate_gain)."""
    if nonlinearity == "leaky_relu" and param is not None:
        return math.sqrt(2.0 / (1.0 + param**2))
    try:
        return _GAINS[nonlinearity]
    except KeyError:
        raise ValueError(f"Unsupported nonlinearity for gain: {nonlinearity!r}")


def _uniform(shape, bound, generator, dtype):
    return torch.empty(shape, dtype=dtype).uniform_(-bound, bound,
                                                    generator=generator)


def xavier_uniform(shape, gain: float = 1.0, *, generator=None,
                   dtype=torch.float32):
    """Glorot/Xavier uniform: U(-a, a), a = gain * sqrt(6 / (fan_in + fan_out))."""
    fan_in, fan_out = shape[-2], shape[-1]
    return _uniform(shape, gain * math.sqrt(6.0 / (fan_in + fan_out)),
                    generator, dtype)


def kaiming_uniform(shape, nonlinearity: str = "relu", *, generator=None,
                    dtype=torch.float32):
    """He/Kaiming uniform with fan_in mode: U(-b, b), b = gain * sqrt(3 / fan_in)."""
    bound = calculate_gain(nonlinearity) * math.sqrt(3.0 / shape[-2])
    return _uniform(shape, bound, generator, dtype)


def torch_linear_default(shape, with_bias: bool = True, *, generator=None,
                         dtype=torch.float32):
    """torch.nn.Linear default init for a ``[fan_in, fan_out]`` weight: both
    weight and bias U(-1/sqrt(fan_in), 1/sqrt(fan_in)). Returns (W, b) or
    (W, None)."""
    bound = 1.0 / math.sqrt(shape[0])
    w = _uniform(shape, bound, generator, dtype)
    b = _uniform((shape[1],), bound, generator, dtype) if with_bias else None
    return w, b
