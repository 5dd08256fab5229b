"""Quadrature rules for the integral equations.

Counterpart of the JAX package's ops/quad.py: the Gauss–Legendre rule
(computed on the host with numpy, returned as float32 tensors as the JAX
package returns float32 arrays) and the weighted sum. The Monte-Carlo and
Halton node sets are not ported (ROADMAP.md queue 1, item 11).
"""

import numpy as np
import torch


def gauss_legendre_nodes(k, a=0.0, b=1.0, device=None):
    """Gauss–Legendre rule on [a, b]; exact for polynomials of degree 2k−1.
    Returns (nodes [k], weights [k]) as float32 tensors."""
    x, w = np.polynomial.legendre.leggauss(k)
    nodes = 0.5 * (b - a) * (x + 1.0) + a
    weights = 0.5 * (b - a) * w
    return (torch.tensor(nodes, dtype=torch.float32, device=device),
            torch.tensor(weights, dtype=torch.float32, device=device))


def integrate(values, weights):
    """Σ_i w_i · f_i along the last axis. ``values``: [..., k]; ``weights``:
    [k] or broadcastable."""
    return torch.sum(values * weights, dim=-1)
