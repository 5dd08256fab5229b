"""Quadrature rules for the integral equations.

Counterpart of the JAX package's ops/quad.py: the Gauss–Legendre rule
(computed on the host with numpy, returned as float32 tensors as the JAX
package returns float32 arrays), the Monte-Carlo rule (fresh nodes from an
explicit ``torch.Generator``), the Halton rule (quasi-Monte-Carlo, the same
integer digit loop and fp32 sums as the JAX package, so the same nodes bit
for bit) and the weighted sum.
"""

import numpy as np
import torch


def montecarlo_nodes(generator, k, a=0.0, b=1.0, batch_shape=(),
                     device=None):
    """Uniform Monte-Carlo nodes on [a, b] with constant weights (b−a)/k.

    ``batch_shape`` prepends per-sample axes so that each collocation point
    gets its own node set (the reference draws fresh nodes per batch
    element, fredholm.py:66). The draws come from ``generator`` on the CPU
    and are moved to ``device``. Returns (nodes [*batch_shape, k], weights
    [k]) as float32 tensors."""
    u = torch.rand((*batch_shape, k), generator=generator)
    nodes = a + (b - a) * u
    weights = torch.full((k,), (b - a) / k)
    return nodes.to(device), weights.to(device)


def halton_nodes(k, a=0.0, b=1.0, base=2, offset=0, device=None):
    """Quasi-Monte-Carlo nodes: the base-``base`` Halton (van der Corput)
    sequence from index ``offset + 1`` mapped to [a, b], with constant
    weights (b−a)/k. Indices wrap as uint32, and 32 digits are summed in
    fp32 in digit order, as in the JAX package (ops/quad.py:40-66), so the
    nodes equal its nodes bit for bit. ``offset`` (an int or a 0-d integer
    tensor) shifts the window so that successive steps see fresh nodes."""
    idx = (torch.arange(1, k + 1, dtype=torch.int64, device=device)
           + torch.as_tensor(offset, dtype=torch.int64, device=device))
    idx = idx & 0xFFFFFFFF
    result = torch.zeros((k,), dtype=torch.float32, device=device)
    denom = torch.ones((k,), dtype=torch.float32, device=device)
    for _ in range(32):
        denom = denom * base
        result = result + (idx % base).to(torch.float32) / denom
        idx = idx // base
    nodes = a + (b - a) * result
    weights = torch.full((k,), (b - a) / k, device=device)
    return nodes, weights


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
