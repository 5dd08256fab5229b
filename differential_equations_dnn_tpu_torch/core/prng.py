"""Explicit, step-keyed randomness.

Weights are drawn from a seeded CPU ``torch.Generator`` (``generator(seed)``).
Collocation draws are keyed by the absolute step index, as the JAX package
keys them with ``fold_in(run_key, i)`` (kernels/fused_train.py:508-516): the
``[B, 2]`` uniforms of step ``i`` depend only on ``(seed, i)``, never on how
a run is cut into chunks or resumed.

The draws come from a counter-based integer hash evaluated with tensor ops,
so one seed gives bit-identical uniforms on the CPU and on the GPU. The
stream is NOT JAX's threefry: the same seed gives other numbers than the
JAX package. Tests that compare the two hand both the same numpy uniforms.
"""

import torch

_M32 = 0xFFFFFFFF
_DRAW_DOMAIN = 0x5EED0001  # separates the draw stream from the init stream


def generator(seed: int) -> torch.Generator:
    """A CPU generator for weight initialisation."""
    return torch.Generator().manual_seed(int(seed))


def _mix32(x):
    """lowbias32 (C. Wellons) on int64 tensors holding uint32 values. The
    products wrap modulo 2^64, whose low 32 bits are the uint32 product."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def step_uniforms(seed: int, start: int, n: int, batch_size: int,
                  device=None) -> torch.Tensor:
    """U[0, 1) draws of shape ``[n, batch_size, 2]`` for the steps
    ``start .. start + n - 1``; float32 with 24 random bits each."""
    key = int(_mix32(torch.tensor(((seed ^ (seed >> 32)) ^ _DRAW_DOMAIN)
                                  & _M32)))
    steps = torch.arange(start, start + n, dtype=torch.int64, device=device)
    step_key = _mix32((steps * 0x9E3779B9 + key) & _M32)[:, None]
    lane = torch.arange(2 * batch_size, dtype=torch.int64, device=device)
    h = _mix32((lane * 0x85EBCA6B) & _M32 ^ step_key)
    h = _mix32((h + step_key) & _M32)
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u.reshape(n, batch_size, 2)
