"""Meshes: named axes over the ranks of a ``torch.distributed`` group.

Counterpart of the JAX package's parallel/mesh.py. JAX's mesh is
single-controller: one process drives N devices and XLA inserts the
collectives. Here every rank is a process of its own (SPMD) and a mesh is
a ``torch.distributed.device_mesh.DeviceMesh`` with named dims over all of
them:

* a mesh covers the whole world. JAX takes a prefix of its devices; here
  every rank runs the program, so a rank outside the mesh would have
  nothing to do: a mesh larger or smaller than the world raises;
* a rank's device is ``cuda:{LOCAL_RANK}`` (``initialize_distributed``
  sets it) or the CPU. A CUDA mesh runs on NCCL, a CPU mesh on gloo (gloo
  has no CUDA all-gather); a mesh whose device does not fit the group's
  backend raises;
* in one process with no process group, a mesh whose sizes are all 1 opens
  a one-rank group of its own on an in-memory store (no port), so
  ``make_mesh({"pop": 1})`` runs in one process, on the card and on the
  CPU.

Axis order follows dict order, the last axis innermost: on a ``("pop",
"data")`` mesh the ranks of one ``pop`` coordinate are neighbours.
"""

import math

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from differential_equations_dnn_tpu_torch.kernels.build import resolve_device

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _open_single_rank_group(device: torch.device) -> None:
    dist.init_process_group(_BACKENDS[device.type], store=dist.HashStore(),
                            rank=0, world_size=1)


def _check_backend(device: torch.device) -> None:
    backend = str(dist.get_backend())
    if _BACKENDS[device.type] not in backend:
        raise ValueError(
            f"a {device.type} mesh needs the {_BACKENDS[device.type]!r} "
            f"backend; the process group runs {backend!r}")


def make_mesh(axes: dict[str, int], device="cuda") -> DeviceMesh:
    """A mesh of ``{axis_name: size}`` over every rank of the process group
    (opened here as a one-rank group if there is none and every size is 1).
    The sizes must multiply to the world size; ``device`` ("cuda" or
    "cpu") is the ranks' device type, and must fit the group's backend."""
    device = resolve_device(device)
    if device.type not in _BACKENDS:
        raise ValueError(f"a mesh runs on 'cuda' or 'cpu' (got {device})")
    shape = tuple(int(n) for n in axes.values())
    if not shape or min(shape) < 1:
        raise ValueError(f"mesh axes need sizes >= 1 (got {axes})")
    n = math.prod(shape)
    if not dist.is_initialized():
        if n != 1:
            raise ValueError(f"mesh needs {n} devices, have 1 (no process "
                             f"group: call initialize_distributed() in "
                             f"every rank, e.g. under torchrun)")
        _open_single_rank_group(device)
    _check_backend(device)
    world = dist.get_world_size()
    if n != world:
        raise ValueError(
            f"mesh needs {n} devices, have {world}"
            + ("" if n > world else " (every rank runs the program, so a "
               "mesh covers the whole world)"))
    return init_device_mesh(device.type, shape,
                            mesh_dim_names=tuple(axes.keys()))


def single_axis_mesh(name: str = "data", n: int | None = None,
                     device="cuda") -> DeviceMesh:
    """One axis ``name`` of ``n`` ranks (None: the world's size, 1 without
    a process group)."""
    if n is None:
        n = dist.get_world_size() if dist.is_initialized() else 1
    return make_mesh({name: n}, device)


def as_mesh(mesh, device="cuda") -> DeviceMesh:
    """``mesh`` itself, or a ``{axis: size}`` dict made into one on
    ``device``: the drivers' ``mesh=`` takes either. A mesh on another
    device type than ``device`` raises."""
    if isinstance(mesh, dict):
        return make_mesh(mesh, device)
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(f"mesh= takes a DeviceMesh (make_mesh) or an "
                        f"{{axis: size}} dict (got {type(mesh).__name__})")
    want = resolve_device(device).type
    if mesh.device_type != want:
        raise ValueError(f"the mesh is on {mesh.device_type!r}, the call "
                         f"runs on {want!r}")
    return mesh


def mesh_shape(mesh: DeviceMesh) -> dict[str, int]:
    """``{axis: size}``, as the JAX mesh's ``shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def require_axis(mesh: DeviceMesh, name: str, what: str) -> int:
    """The size of axis ``name``; raises, naming ``what`` needs it, if the
    mesh has no such axis."""
    shape = mesh_shape(mesh)
    if name not in shape:
        raise ValueError(
            f"{what} needs a '{name}' mesh axis; the given mesh has axes "
            f"{tuple(shape)} — build it with make_mesh({{'{name}': N}})")
    return shape[name]


def axis_rank(mesh: DeviceMesh, name: str) -> int:
    """This rank's coordinate along axis ``name``."""
    return mesh.get_local_rank(name)


def axis_group(mesh: DeviceMesh, name: str):
    """The process group of this rank's line along axis ``name``."""
    return mesh.get_group(name)


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device: its CUDA device (``torch.cuda.set_device`` by
    ``initialize_distributed``) or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")
