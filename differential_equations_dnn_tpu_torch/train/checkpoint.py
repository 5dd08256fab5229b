"""Checkpoint / resume.

Counterpart of the JAX package's train/checkpoint.py. The reference never
saves model state: persistence is results-only (``temp_results/*.npy``,
heat.py:220-225). Here a training run's whole state is a checkpoint, so a
150 000-step FitzHugh–Nagumo run survives an interruption and resumes bit
for bit.

A checkpoint is a directory, as orbax's is in the JAX package (so the CLI's
``--checkpoint DIR`` means the same in both), holding one ``torch.save``
file of a tree of dicts, lists, numbers, strings and tensors: no module,
closure or generator is pickled, and :func:`restore_checkpoint` loads it
with ``weights_only=True``. The CLI's tree (JAX cli.py:223-233):

* ``params``    — the model's ``state_dict()``;
* ``opt_state`` — on the scan engine the optimizer's ``state_dict()``,
  whose param groups carry the update ``count`` (``trainer.make_optimizer``);
  on the fused engines ``{"m", "v"}``, the flat Adam moments of
  ``TrainResult.opt_state``;
* ``step``, ``seed`` — ints: the next step's index and the stream's seed;
* ``state``     — a stateful model's running statistics, by buffer name.

Tensors are saved from the CPU, so a checkpoint names no device.
"""

import os
from pathlib import Path

import torch

from differential_equations_dnn_tpu_torch.core.prng import generator
from differential_equations_dnn_tpu_torch.kernels.build import resolve_device
from differential_equations_dnn_tpu_torch.models.stateful import state_names
from differential_equations_dnn_tpu_torch.train.trainer import (
    TrainConfig,
    make_optimizer,
)

CHECKPOINT_FILE = "checkpoint.pt"


def _map(tree, leaf):
    """``tree`` with every tensor replaced by ``leaf(tensor)``."""
    if torch.is_tensor(tree):
        return leaf(tree)
    if isinstance(tree, dict):
        return {k: _map(v, leaf) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(v, leaf) for v in tree)
    return tree


def _abstract(tree):
    """Shapes and dtypes only: every tensor as a ``meta`` tensor."""
    return _map(tree, lambda t: torch.empty(t.shape, dtype=t.dtype,
                                            device="meta"))


def model_state(model) -> dict | None:
    """A stateful model's running statistics by buffer name (None for a
    stateless model): the tree's ``state``."""
    names = state_names(model)
    if not names:
        return None
    buffers = dict(model.named_buffers())
    return {name: buffers[name] for name in names}


def checkpoint_like(problem, config: TrainConfig, model=None, seed: int = 0,
                    engine: str = "scan") -> dict:
    """The structure of a full training checkpoint, to pass as ``like`` to
    :func:`restore_checkpoint`: the tree the CLI saves, every tensor a
    ``meta`` tensor of its shape and dtype (as the JAX package builds it
    with ``jax.eval_shape``).

    The model (default: ``problem.default_model()``) and its optimizer are
    built on the CPU and one zero-gradient update fills the optimizer's
    state, so the optimizer's own code gives its layout; no device memory
    is touched. ``engine="fused"`` gives the fused trainers' layout, flat
    ``{"m", "v"}`` moments over the model's parameters, instead."""
    if model is None:
        model = problem.default_model(generator=generator(seed))
    params = [p.detach() for p in model.parameters()]
    if engine == "fused":
        n = sum(p.numel() for p in params)
        flat = torch.empty(n, dtype=torch.float32, device="meta")
        opt_state = {"m": flat, "v": flat}
    else:
        shadow = [torch.zeros(p.shape, dtype=p.dtype) for p in params]
        optimizer = make_optimizer(config, shadow, fused=False)
        for t in shadow:
            t.grad = torch.zeros_like(t)
        optimizer.step()
        opt_state = _abstract(optimizer.state_dict())
    like = {"params": _abstract(model.state_dict()),
            "opt_state": opt_state, "step": 0, "seed": 0}
    state = model_state(model)
    if state is not None:
        like["state"] = _abstract(state)
    return like


def save_checkpoint(path: str | Path, tree, *, force: bool = True) -> Path:
    """Save ``tree`` (e.g. ``{"params": ..., "opt_state": ..., "step":
    ...}``) into the directory ``path``, its tensors copied to the CPU.
    ``force=False`` refuses an existing checkpoint. The file is written
    beside its final name and then renamed, so an interrupted save leaves
    the previous checkpoint whole."""
    path = Path(path).absolute()
    target = path / CHECKPOINT_FILE
    if target.exists() and not force:
        raise FileExistsError(f"a checkpoint exists at {path}")
    path.mkdir(parents=True, exist_ok=True)
    tmp = path / (CHECKPOINT_FILE + ".tmp")
    torch.save(_map(tree, lambda t: t.detach().cpu()), tmp)
    os.replace(tmp, target)
    return path


def _tensors_in(tree) -> bool:
    if torch.is_tensor(tree):
        return True
    if isinstance(tree, dict):
        return any(_tensors_in(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(_tensors_in(v) for v in tree)
    return False


def _check(tree, like, where="checkpoint"):
    """Raise if ``tree`` lacks a tensor of ``like`` or holds one of another
    shape or dtype (the other leaves are not compared: an optimizer's
    hyperparameters come from the run's config)."""
    if torch.is_tensor(like):
        if not torch.is_tensor(tree):
            raise ValueError(f"{where}: expected a tensor, got "
                             f"{type(tree).__name__}")
        if tree.shape != like.shape or tree.dtype != like.dtype:
            raise ValueError(f"{where}: {tuple(tree.shape)} {tree.dtype} "
                             f"where {tuple(like.shape)} {like.dtype} was "
                             f"expected")
    elif isinstance(like, dict):
        if not isinstance(tree, dict):
            raise ValueError(f"{where}: expected a dict")
        missing = [k for k, v in like.items()
                   if k not in tree and _tensors_in(v)]
        if missing:
            raise ValueError(f"{where}: missing {missing}")
        for k, v in like.items():
            if k in tree:
                _check(tree[k], v, f"{where}[{k!r}]")
    elif isinstance(like, (list, tuple)):
        if not isinstance(tree, (list, tuple)) or len(tree) != len(like):
            raise ValueError(f"{where}: expected {len(like)} entries")
        for i, (a, b) in enumerate(zip(tree, like)):
            _check(a, b, f"{where}[{i}]")


def restore_checkpoint(path: str | Path, like=None, device="cuda") -> dict:
    """Load the tree saved at ``path`` with ``torch.load(...,
    weights_only=True)``, its tensors on ``device`` (default "cuda", which
    raises without a GPU; pass "cpu" for the CPU). ``like`` (from
    :func:`checkpoint_like`) checks that every tensor it names is there
    with its shape and dtype, and raises a ValueError otherwise."""
    device = resolve_device(device)
    tree = torch.load(Path(path).absolute() / CHECKPOINT_FILE,
                      map_location=device, weights_only=True)
    if like is not None:
        _check(tree, like)
    return tree
