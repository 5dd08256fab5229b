"""Collocation samplers.

Counterpart of the JAX package's ops/sampling.py. Only ``GridSubsample``
is ported: FitzHugh–Nagumo draws from it when its causal weighting is off.
"""

from dataclasses import dataclass

import torch


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
