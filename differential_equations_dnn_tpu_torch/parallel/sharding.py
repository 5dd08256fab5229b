"""Rows, replicas and reductions over a mesh's axes.

Counterpart of the JAX package's parallel/sharding.py. JAX places global
arrays (``shard_batch``, ``replicate``) and lets XLA insert the gradient
``psum`` that ``constrain_batch`` implies inside a jit. Here each rank holds
its own tensors, so the module gives the operations the drivers make
themselves:

* :func:`shard_batch` — this rank's rows of a batch every rank drew whole
  (the data-parallel trainer's ``constrain_batch``);
* :func:`mean_over` — the mean of tensors over an axis, in place: the
  gradient mean over ``data``;
* :func:`replicate` — a tree broadcast from the mesh's first rank;
* :func:`gather_rows` — a tree's shards joined along an axis, so every rank
  holds the global result (the population and ensemble drivers).

A leading dimension that the axis does not divide raises a ``ValueError``.
"""

import numpy as np
import torch
import torch.distributed as dist

from differential_equations_dnn_tpu_torch.parallel.mesh import (
    axis_group,
    axis_rank,
    mesh_device,
    require_axis,
)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    if tree is None:
        return None
    return fn(tree)


def shard_range(n: int, mesh, axis: str = "data") -> tuple[int, int]:
    """This rank's rows [lo, hi) of ``n`` split evenly over ``axis``."""
    size = require_axis(mesh, axis, "sharding")
    if n % size:
        raise ValueError(f"a leading dimension of {n} does not divide "
                         f"evenly over the '{axis}' mesh axis ({size} "
                         f"shards)")
    per = n // size
    lo = axis_rank(mesh, axis) * per
    return lo, lo + per


def shard_batch(batch, mesh, axis: str = "data"):
    """This rank's rows of every leaf (tensors or arrays, in dicts, lists
    and tuples) of ``batch`` along its leading dimension over ``axis``;
    every leaf's leading dimension must divide evenly."""
    def rows(a):
        lo, hi = shard_range(a.shape[0], mesh, axis)
        return a[lo:hi]

    return _map(rows, batch)


def mean_over(tensors, mesh, axis: str = "data") -> None:
    """Replace each tensor of the list ``tensors`` by its mean over
    ``axis``: one all-reduce of their concatenation, in place. At one rank
    the tensors keep their bits."""
    tensors = list(tensors)
    flat = torch.cat([t.reshape(-1) for t in tensors])
    dist.all_reduce(flat, group=axis_group(mesh, axis))
    flat.div_(require_axis(mesh, axis, "a mean over an axis"))
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()


def _first_rank(mesh) -> int:
    return int(mesh.mesh.reshape(-1)[0])


def replicate(tree, mesh):
    """Every tensor of ``tree`` (or every parameter and buffer of a module,
    in place) broadcast from the mesh's first rank to all of its ranks: the
    same values everywhere. Returns the replicated tree (the module)."""
    src = _first_rank(mesh)
    if isinstance(tree, torch.nn.Module):
        with torch.no_grad():
            for t in [*tree.parameters(), *tree.buffers()]:
                dist.broadcast(t.data, src)
        return tree

    def bcast(t):
        t = t.detach().clone()
        dist.broadcast(t, src)
        return t

    return _map(bcast, tree)


def gather_rows(tree, mesh, axis: str, dim: int = 0):
    """Every leaf of ``tree`` joined along ``dim`` over ``axis``, in the
    axis's order: each rank's shard at its coordinate, so every rank holds
    the global tensor. Numpy leaves come back as numpy (through the mesh's
    device; a float64 array stays float64)."""
    group = axis_group(mesh, axis)
    size = require_axis(mesh, axis, "a gather")
    device = mesh_device(mesh)

    def gather(a):
        host = isinstance(a, np.ndarray)
        t = (torch.from_numpy(np.ascontiguousarray(a)).to(device) if host
             else a.contiguous())
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=group)
        out = torch.cat(parts, dim)
        return out.cpu().numpy() if host else out

    return _map(gather, tree)
