"""Collocation samplers.

Counterpart of the JAX package's ops/sampling.py. FitzHugh–Nagumo draws
from ``GridSubsample`` when its causal weighting is off; ``UniformBox`` is
the general box sampler (the equations build their batches from the
step-keyed uniforms of core/prng.py instead).
``stride_strata`` is the stratum layout of causal advection's fused spec
(the JAX package's kernels/fused_engine.py, ``AdvectionSpec.build``).
"""

import math
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class UniformBox:
    """Uniform sampling over an axis-aligned box ∏ [low_i, high_i).

    Covers the reference's per-equation sampling: t ~ 1.01·U[0,1)
    (simple_ode.py:92), (x, t) ~ U[0,π)×U[0,3) (heat.py:125-126),
    t ~ (π/2)·U (fredholm.py:100). The draws come from an explicit
    ``torch.Generator`` (a CPU one, as ``core.prng.generator`` makes), in
    the JAX package's argument order ``sample(key, n)``."""

    lows: tuple
    highs: tuple

    @property
    def dim(self):
        return len(self.lows)

    def sample(self, generator, n, device=None):
        """[n, dim] float32 points, drawn on the CPU, put on ``device``."""
        lows = torch.tensor(self.lows, dtype=torch.float32)
        highs = torch.tensor(self.highs, dtype=torch.float32)
        u = torch.rand((n, self.dim), generator=generator)
        return (lows + u * (highs - lows)).to(device)

    __call__ = sample


@dataclass(frozen=True)
class GridSubsample:
    """Uniform subsample *without replacement* from a fixed grid — the
    FitzHugh–Nagumo sampling scheme (200-point linspace + multinomial,
    reference fitzhugh_nagumo.py:124-131)."""

    low: float
    high: float
    num_points: int

    def sample(self, n, generator=None, device=None):
        if n > self.num_points:
            raise ValueError(f"cannot draw {n} of {self.num_points} grid "
                             f"points without replacement")
        grid = torch.linspace(self.low, self.high, self.num_points)
        idx = torch.randperm(self.num_points, generator=generator)[:n]
        return grid[idx][:, None].to(device)

    __call__ = sample


def coprime_stride(n: int) -> int:
    """The odd stride nearest golden-ratio·n that is coprime with n: the
    lattice i·m mod n, whose prefixes cover 0 .. n−1 near-uniformly."""
    m = max(1, int(round(n * 0.6180339887)))
    while math.gcd(m, n) != 1:
        m += 1
    return m


def stride_strata(n, device=None):
    """The stratum of each of n rows, (i·m) mod n with m =
    :func:`coprime_stride` (n), as a float32 ``[n, 1]`` column: every
    stratum once, in a row order whose every prefix spreads over the
    domain. Integer arithmetic; the JAX package computes the same values
    in fp32 with a floor, exact below 2^24."""
    i = torch.arange(n, dtype=torch.int64, device=device)
    return ((i * coprime_stride(n)) % n).to(torch.float32)[:, None]
