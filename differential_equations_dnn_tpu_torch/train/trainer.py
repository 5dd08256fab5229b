"""The generic (scan) trainer, and the training records every trainer fills.

Counterpart of the JAX package's train/trainer.py. One trainer serves every
equation and model: each step draws a collocation batch, takes
``problem.loss`` and its gradient with autograd, and applies one optimizer
update. The JAX package scans the steps of a chunk inside one jit; here, on
a CUDA device, the steps of a block of GRAPH_STEPS draws (a stateful
model's: CAPTURE_STEPS of them) are captured as one CUDA graph
(:class:`ScanGraph`) and replayed for every whole block, the steps left
over run eagerly, and on the CPU every step runs eagerly. A stateful model
(BatchNorm) refreshes its running statistics inside the step, so inside
the graph too. Further:

* Every call trains a module of its own, copied from the caller's
  model, and copies the trained parameters and buffers back at its end.
  A graph is captured once per key (:func:`graph_key`: the problem, the
  model's structure, the optimizer, the schedule's shape, the batch, the
  process's math settings), not once per call: it is kept with that
  module, its optimizer and device schedule (``kernels.graphs.
  TRAINER_GRAPHS``), and a later call of the same key copies its starting
  model, optimizer state and lr into them and replays. A call on a mesh,
  or one the key cannot describe, captures a graph of its own.

* Step ``i`` draws its batch from ``step_generator(seed, i)``, the
  counterpart of ``fold_in(run_key, i)``: a chunked run equals an uncut
  one and a resumed run an unbroken one. The draws are made on the host in
  blocks of steps, pinned, and copied to the device once per block.
* The loss history stays on the device and is fetched once per chunk, for
  ``log_every`` and ``metrics_file``; no step waits for the device.
* On a mesh (``mesh=``, parallel/mesh.py) the run is data-parallel over
  the mesh's ``config.data_axis``: every rank draws the same whole batch,
  trains on its own rows of it (``parallel.sharding.shard_batch``, after
  an adaptive selection over the whole batch) and takes the mean of the
  ranks' gradients and losses (one all-reduce a step, inside the step's
  CUDA graph), so the loss terms stay the global batch's means and every
  rank holds the same model (the JAX package's ``constrain_batch``). What
  couples the rows (a BatchNorm layer's moments, a causal loss's weights)
  gathers every rank's rows inside the step (``core.rows``), so it is the
  single run's too.
* The learning rate follows ``kernels.engine_core.scheduled_lr`` at the
  optimizer's own update count, as optax's schedules do; the count is part
  of the optimizer state, so a resumed run continues its schedule. On a
  CUDA device the lr and the count are device tensors that the step itself
  advances (:class:`DeviceSchedule`), and Adam and AdamW run torch's fused,
  capturable update with that lr tensor, so a replayed graph and an eager
  step give the same bits.
* Host snapshots of the model and optimizer state every ``snapshot_every``
  chunks back the retry of a failed chunk (``inject_fault`` tests it); a
  retry captures the graph anew, and leaves the key uncached, since
  restoring replaces the tensors the old one read.

The fused trainers (kernels.fused_train, kernels.fused_engine,
kernels.fused_dgm) fill the same ``TrainResult``.
"""

import contextlib
import copy
import dataclasses
import json
import math
import os
import time
import types
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from differential_equations_dnn_tpu_torch.core.prng import (
    generator,
    step_generator,
)
from differential_equations_dnn_tpu_torch.core.rows import sharded_rows
from differential_equations_dnn_tpu_torch.kernels import build, taylor_mlp
from differential_equations_dnn_tpu_torch.kernels import graphs as graph_cache
from differential_equations_dnn_tpu_torch.kernels.engine_core import (
    check_schedule,
    scheduled_lr,
)
from differential_equations_dnn_tpu_torch.models.stateful import (
    is_stateful,
    update_state,
)
from differential_equations_dnn_tpu_torch.utils import trace

# Steps whose batches are drawn, pinned and copied to the device together,
# and the steps of one captured CUDA graph of the scan step.
DRAW_BLOCK = 256
GRAPH_STEPS = DRAW_BLOCK
# Steps of a stateful model's CUDA graph, which a block of GRAPH_STEPS
# replays GRAPH_STEPS // CAPTURE_STEPS times. A capture runs each step's
# Python once: about 90 ms a step for a BatchNorm MLP's second-order taps,
# a quarter of a second for a ResNet's, so their graphs are kept short. A
# plain model captures the whole block: eight replays of a 32-step graph
# cost plain heat 709.43 µs a step against 658.15 for one 256-step graph
# (kernels.profile --scan heat; H100 80GB HBM3, 700 W).
CAPTURE_STEPS = 32

# The wrappers of hand-written kernels a scan step may launch: a replay
# adds each one's launches per graph to its count, as eager steps do.
_COUNTED = (taylor_mlp.heat_fused_streams,)

# ---------------------------------------------------------------------------
# Fault injection (the test hook of the snapshot/retry recovery)
# ---------------------------------------------------------------------------

_FAULT_QUEUE: list[int] = []


class _InjectedFault(Exception):
    pass


def inject_fault(at_dispatch: int):
    """Context manager: make the ``at_dispatch``-th chunk of the next
    training run raise, exercising snapshot/retry recovery in tests."""

    @contextlib.contextmanager
    def _ctx():
        _FAULT_QUEUE.append(at_dispatch)
        try:
            yield
        finally:
            _FAULT_QUEUE.clear()

    return _ctx()


# Device-failure signatures (substring match) a retry from the host snapshot
# could cure. The JAX package lists the TPU runtime's worker crashes; on a
# GPU none qualifies: a CUDA fault inside a kernel (an illegal address, a
# launch failure) poisons the process's CUDA context, so every later call
# in the same process fails too, and out-of-memory or shape errors recur on
# every retry. Only the injected fault is retried.
_RECOVERABLE: tuple[str, ...] = ()


def _is_recoverable(err: Exception) -> bool:
    if isinstance(err, _InjectedFault):
        return True
    msg = str(err)
    return any(sig in msg for sig in _RECOVERABLE)


@dataclass(frozen=True)
class TrainConfig:
    iterations: int = 1000
    batch_size: int = 32
    lrate: float = 1e-4
    log_every: int = 100        # host-side loss print cadence (0 = silent)
    chunk_size: int = 25_000    # steps between host fetches of the losses
    optimizer: str = "adam"     # "adam" | "adamw" | "sgd"
    # Learning-rate schedule: "constant" | "cosine" | "exponential", over
    # ``iterations`` steps; the final lr is lrate · schedule_decay.
    schedule: str = "constant"
    schedule_decay: float = 0.1
    # Residual-based adaptive collocation: draw adaptive_oversample × the
    # batch each step and keep the batch_size points with the largest
    # current residual. 0/1 disables.
    adaptive_oversample: int = 0
    data_axis: str = "data"     # the mesh axis of data-parallel training
    verbose: bool = True
    # Optional JSONL metrics stream: one record per chunk (step, loss stats,
    # iters/s).
    metrics_file: str | None = None
    # Host snapshots of (model, optimizer state) every ``snapshot_every``
    # chunks; a recoverable failure restores the last one and retries, up
    # to ``max_retries`` times. 0 disables snapshots and recovery.
    snapshot_every: int = 1
    max_retries: int = 2


@dataclass
class TrainResult:
    params: Any                 # the trained model (a list of N for packed
                                # replicas); a stateful model carries its
                                # trained running statistics
    opt_state: Any              # scan: the optimizer's state_dict; fused:
                                # {"m": flat tensor, "v": flat tensor}
    loss_history: np.ndarray    # [iterations] ([N, iterations] packed)
    wall_time: float            # steady-state seconds, after synchronize
    iters_per_sec: float        # iterations / wall_time
    compile_time: float = 0.0   # kernel build + first dispatch

    @property
    def final_loss(self) -> float:
        return float(self.loss_history[-1])


# ---------------------------------------------------------------------------
# The optimizer and the step
# ---------------------------------------------------------------------------


def make_optimizer(config: TrainConfig, params,
                   fused: bool | None = None) -> torch.optim.Optimizer:
    """The optimizer of ``config`` over ``params``, set up as the JAX
    package's optax one (train/trainer.py:163-174): Adam with torch's
    defaults (eps outside the square root, as ``optax.adam(eps=1e-8)``),
    AdamW with optax's weight decay 1e-4 (torch's own default is 1e-2), or
    plain SGD. ``fused=None`` gives torch's fused update on the GPU (one
    launch for all parameters instead of seven and far less host work per
    step) and the default on the CPU; ``False`` asks for the default
    (foreach) update everywhere, which SGD cannot run inside a CUDA graph.
    On the GPU the lr is a device tensor (:class:`DeviceSchedule` sets it)
    and Adam and AdamW are capturable. Each param group also carries the
    lr schedule (``lrate``, ``schedule``, ``horizon``, ``decay``) and the
    update ``count``, so the count travels with ``state_dict()`` as optax's
    does."""
    check_schedule(config.schedule)
    params = list(params)
    cuda = bool(params) and all(p.is_cuda for p in params)
    if fused is None:
        fused = cuda
    lr = (torch.tensor(config.lrate, dtype=torch.float32,
                       device=params[0].device) if cuda else config.lrate)
    if config.optimizer == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                               fused=fused, capturable=cuda)
    elif config.optimizer == "adamw":
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=1e-4, fused=fused,
                                capturable=cuda)
    elif config.optimizer == "sgd":
        opt = torch.optim.SGD(params, lr=lr, fused=fused)
    else:
        raise ValueError(f"unknown optimizer {config.optimizer!r} "
                         f"(adam | adamw | sgd)")
    for group in opt.param_groups:
        group.update(lrate=float(config.lrate), schedule=config.schedule,
                     horizon=float(config.iterations),
                     decay=float(config.schedule_decay), count=0)
    return opt


def load_opt_state(optimizer, opt_state) -> None:
    """Load a state_dict (``TrainResult.opt_state``, or
    :func:`opt_state_from_jax`) into ``optimizer``: the moments and the
    update count come from ``opt_state``, the hyperparameters and the
    schedule from the optimizer's own config, as a resumed JAX run rebuilds
    its optimizer from the config and takes only ``opt_state``. A copy is
    loaded, so ``opt_state`` itself is never trained on."""
    state = copy.deepcopy(opt_state)
    state["param_groups"] = [
        {**{k: v for k, v in group.items() if k != "params"},
         "params": saved["params"], "count": int(saved.get("count", 0))}
        for group, saved in zip(optimizer.param_groups,
                                state["param_groups"])]
    optimizer.load_state_dict(state)


def _set_lr(optimizer) -> None:
    """The lr of the coming update, from its group's count: step 0 gets
    ``lrate`` (optax evaluates a schedule at its count before updating)."""
    for group in optimizer.param_groups:
        if group["schedule"] != "constant":
            t = torch.tensor(group["count"] + 1, dtype=torch.float32)
            group["lr"] = float(scheduled_lr(group["lrate"], t,
                                             group["schedule"],
                                             group["horizon"],
                                             group["decay"]))
        group["count"] += 1


class DeviceSchedule:
    """The lr of each param group as a device tensor, which the optimizer
    reads, computed on the device by ``scheduled_lr`` from a device update
    count: what a CUDA graph of the step can advance (the host float
    ``_set_lr`` writes would be frozen into the graph). It takes each
    group's ``lrate``, schedule and ``count`` when made; the host count
    moves on by :meth:`count_steps`, never inside a step."""

    def __init__(self, optimizer):
        self.reset(optimizer)

    def reset(self, optimizer):
        """New lr and count tensors from ``optimizer``'s groups (after a
        ``load_state_dict``, which replaces the groups)."""
        self.rows = []
        for group in optimizer.param_groups:
            device = group["params"][0].device
            lrate = torch.tensor(float(group["lrate"]), dtype=torch.float32,
                                 device=device)
            group["lr"] = lrate.clone()
            count = torch.tensor(float(group["count"]), dtype=torch.float32,
                                 device=device)
            self.rows.append((group, lrate, count))

    def advance(self):
        """The lr of the coming update (at count + 1), then count + 1."""
        for group, lrate, count in self.rows:
            if group["schedule"] != "constant":
                group["lr"].copy_(scheduled_lr(lrate, count + 1.0,
                                               group["schedule"],
                                               group["horizon"],
                                               group["decay"]))
            count.add_(1.0)

    def load(self):
        """Each group's ``lrate`` and ``count`` written into the lr and
        count tensors :meth:`reset` made, in place: what a graph captured
        on them reads."""
        for group, lrate, count in self.rows:
            lrate.fill_(float(group["lrate"]))
            group["lr"].copy_(lrate)
            count.fill_(float(group["count"]))

    def state(self):
        """The device lr and count tensors (what a retry restores)."""
        return [t for group, _, count in self.rows
                for t in (group["lr"], count)]

    def count_steps(self, n):
        for group, _, _ in self.rows:
            group["count"] += n


def make_train_step(problem, model, optimizer, batch_size,
                    adaptive_oversample=0, schedule=None, mesh=None,
                    data_axis="data"):
    """The per-iteration step: ``step(batch) -> loss`` (a detached 0-d
    tensor on the batch's device) trains ``model`` in place with one update
    of ``optimizer`` on ``problem.loss``. ``schedule`` (a
    :class:`DeviceSchedule`, on a CUDA device) sets the lr on the device;
    without it the host sets it (``_set_lr``).

    With ``adaptive_oversample = k > 1`` the batch holds ``k · batch_size``
    candidates: the step keeps the ``batch_size`` with the largest current
    ``point_loss`` (computed without gradient, as JAX's stop_gradient) and
    trains on those. ``step.draw_size`` is the number of points a batch
    must hold.

    A stateful model (BatchNorm; models/stateful.py) trains on train-mode
    batch statistics, and after the update its running statistics are
    refreshed by one train-mode forward on ``problem.domain_inputs(batch)``
    with the updated parameters (JAX train/trainer.py:203-211).

    With a ``mesh`` the step trains on this rank's rows of the (selected)
    batch along ``data_axis`` and replaces its gradients and its loss by
    their means over that axis before the update: at one rank the same
    bits as without a mesh. On more than one rank the loss, its backward
    and the running-statistics refresh run inside ``core.rows.sharded_rows``,
    so a BatchNorm layer's moments and a causal loss's weights span every
    rank's rows, as the single run's span the whole batch."""
    # parallel/ imports this module: its mesh and sharding are imported at
    # call time.
    from differential_equations_dnn_tpu_torch.parallel.mesh import (
        axis_group,
        axis_rank,
        require_axis,
    )
    from differential_equations_dnn_tpu_torch.parallel.sharding import (
        mean_over,
        shard_batch,
    )

    rows = contextlib.nullcontext
    if mesh is not None:
        size = require_axis(mesh, data_axis, "data-parallel training")
        shards = (axis_group(mesh, data_axis), axis_rank(mesh, data_axis),
                  size)
        rows = lambda: sharded_rows(*shards)  # noqa: E731
    oversample = adaptive_oversample > 1
    stateful = is_stateful(model)
    params = [p for p in model.parameters() if p.requires_grad]

    def step(batch):
        if oversample:
            with torch.no_grad():
                r = problem.point_loss(model, batch)
            idx = torch.topk(r, batch_size).indices
            batch = {k: v[idx] for k, v in batch.items()}
        if mesh is not None:
            batch = shard_batch(batch, mesh, data_axis)
        if schedule is None:
            _set_lr(optimizer)
        else:
            schedule.advance()
        optimizer.zero_grad(set_to_none=True)
        with rows():
            loss = problem.loss(model, batch)
            loss.backward()
        if mesh is not None:
            loss = loss.detach().clone().reshape(1)
            mean_over([p.grad for p in params if p.grad is not None]
                      + [loss], mesh, data_axis)
            loss = loss[0]
        optimizer.step()
        if stateful:
            with rows():
                update_state(model, problem.domain_inputs(batch))
        return loss.detach()

    step.draw_size = batch_size * adaptive_oversample if oversample \
        else batch_size
    return step


def draw_batches(problem, seed, start, n, size, device):
    """The batches of steps ``start .. start + n − 1``, each drawn on the
    host by ``problem.sample(size, step_generator(seed, i))`` and stacked
    along a leading step axis; on a CUDA device the block goes through
    pinned memory in one asynchronous copy per array."""
    batches = [problem.sample(size, step_generator(seed, i))
               for i in range(start, start + n)]
    block = {k: torch.stack([b[k] for b in batches]) for k in batches[0]}
    if device.type == "cuda":
        block = {k: v.pin_memory().to(device, non_blocking=True)
                 for k, v in block.items()}
    return block


def capture_graph(step, static, losses, kept, what, restore=None):
    """One CUDA graph of ``len(losses)`` steps: step j reads slice j of
    the static device block ``static`` and writes its loss to
    ``losses[j]``. First one warm-up step on a side stream (which creates
    lazy state, such as the optimizer's, as torch.cuda.graphs asks), then
    the tensors of ``kept`` are put back and ``restore()`` runs; capture
    runs nothing. A step that cannot be captured raises, naming ``what``
    and the cause: there is no eager fallback. Returns (the graph, the
    launches of each _COUNTED wrapper it holds): the warm-up step's
    launches count, the capture's do not, and a replay adds the graph's
    (:func:`count_replays`)."""
    device = losses.device
    saved = [t.detach().clone() for t in kept]
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        step({k: v[0] for k, v in static.items()})
    torch.cuda.current_stream(device).wait_stream(side)
    with torch.no_grad():
        for t, v in zip(kept, saved):
            t.copy_(v)
    if restore is not None:
        restore()
    before = [f.launches for f in _COUNTED]
    graph = torch.cuda.CUDAGraph()
    # Under a process group NCCL's watchdog thread queries its events while
    # a step with a collective is captured: only this thread's calls must
    # be capture-safe.
    mode = ("thread_local" if torch.distributed.is_initialized()
            else "global")
    try:
        with torch.cuda.graph(graph, capture_error_mode=mode):
            for j in range(losses.shape[0]):
                losses[j].copy_(step({k: v[j] for k, v in static.items()}))
    except Exception as err:
        raise RuntimeError(f"{what} cannot be captured as a CUDA graph "
                           f"({type(err).__name__}: {err})") from err
    held = [f.launches - b for f, b in zip(_COUNTED, before)]
    for f, b in zip(_COUNTED, before):
        f.launches = b  # captured, not launched
    return graph, held


def count_replays(held, replays=1):
    """Add ``replays`` replays of a graph that holds ``held`` launches
    (:func:`capture_graph`) to the _COUNTED wrappers' counts."""
    for f, n in zip(_COUNTED, held):
        f.launches += n * replays


class ScanGraph:
    """GRAPH_STEPS scan steps replayed from one CUDA graph of ``steps``
    steps (GRAPH_STEPS; a stateful model's CAPTURE_STEPS), captured by
    :func:`capture_graph` from the first ``steps`` draws of ``block``:
    step j of the graph reads batch j of a static device block and writes
    its loss to slot j of a static ``[steps]`` buffer. :meth:`replay`
    copies each ``steps``-step slice of a block of GRAPH_STEPS draws in,
    replays, and returns the block's losses. After
    the warm-up step the model's parameters and buffers, the optimizer's
    state (moments zeroed where the warm-up created them) and the device
    schedule are put back. ``train`` keeps the graph across calls of one
    key (:class:`_ScanEntry`). The capture is a ``graph.capture`` span and
    a replay a ``graph.replay`` span (utils/trace.py), each counted."""

    def __init__(self, step, block, model, optimizer, schedule, name):
        with trace.span("graph.capture", trainer="scan"):
            device = next(iter(block.values())).device
            self.steps = (CAPTURE_STEPS if is_stateful(model)
                          else GRAPH_STEPS)
            self.static = {k: v[:self.steps].clone()
                           for k, v in block.items()}
            self.losses = torch.empty(self.steps, device=device)
            params = list(model.parameters())
            states = {id(p): {k: v.clone()
                              for k, v in optimizer.state[p].items()
                              if torch.is_tensor(v)}
                      for p in params if optimizer.state.get(p)}

            def restore():
                with torch.no_grad():
                    for p in params:
                        for key, v in optimizer.state[p].items():
                            if torch.is_tensor(v):
                                old = states.get(id(p), {}).get(key)
                                if old is None:
                                    v.zero_()
                                else:
                                    v.copy_(old)
                optimizer.zero_grad(set_to_none=True)

            self.graph, self.launches = capture_graph(
                step, self.static, self.losses,
                params + list(model.buffers()) + schedule.state(),
                f"the scan trainer's step of {name!r} (a chunk_size "
                f"below {GRAPH_STEPS} runs every step eagerly)", restore)
            build.sync(device)
        trace.count("graph.captures.scan")

    def replay(self, block):
        """The GRAPH_STEPS steps on ``block``'s batches; their losses."""
        with trace.span("graph.replay", trainer="scan"):
            out = torch.empty(GRAPH_STEPS, device=self.losses.device)
            for s in range(0, GRAPH_STEPS, self.steps):
                for k, v in block.items():
                    self.static[k].copy_(v[s:s + self.steps])
                self.graph.replay()
                out[s:s + self.steps].copy_(self.losses)
        count_replays(self.launches, GRAPH_STEPS // self.steps)
        trace.count("graph.replays.scan")
        return out


# ---------------------------------------------------------------------------
# The keys of the cached graphs
# ---------------------------------------------------------------------------


class _NoKey(Exception):
    """A value that a graph's key cannot describe."""


# What every module holds for torch's own bookkeeping (its tensors and
# submodules are keyed through named_parameters / named_buffers).
_MODULE_ATTRS = frozenset(vars(torch.nn.Module()))
_HOOKS = tuple(a for a in _MODULE_ATTRS if "hooks" in a)


def value_key(value):
    """A hashable description of ``value`` that equal settings share:
    numbers and strings with their type, tuples and lists and frozen
    dataclasses by their items, a Python function by its code, the
    values it closes over (an ansatz built twice from the same numbers)
    and the module globals it reads (:func:`globals_key`), anything else
    hashable as itself. A tensor, an array or any other unhashable value
    raises :class:`_NoKey`."""
    if value is None or isinstance(value, (bool, int, float, str)):
        return (type(value), value)
    if isinstance(value, (tuple, list)):
        return (type(value), tuple(value_key(v) for v in value))
    if isinstance(value, types.FunctionType):
        try:
            cells = tuple(value_key(c.cell_contents)
                          for c in value.__closure__ or ())
        except ValueError:  # an empty cell
            raise _NoKey from None
        return (value.__code__, value_key(value.__defaults__), cells,
                globals_key(value))
    if torch.is_tensor(value) or isinstance(value, np.ndarray):
        raise _NoKey
    try:
        hash(value)  # an unfrozen dataclass can change between calls
    except TypeError:
        raise _NoKey from None
    if dataclasses.is_dataclass(value) and not isinstance(value, type):
        return (type(value), tuple(
            (f.name, value_key(getattr(value, f.name)))
            for f in dataclasses.fields(value)))
    return (type(value), value)


def globals_key(fn):
    """The module globals that ``fn``'s code, and the code nested in it,
    names: a module, a class or a function as itself (by identity), any
    other value by :func:`value_key`. Names it does not find there
    (builtins, attributes) are left out."""
    names, codes = set(), [fn.__code__]
    while codes:
        code = codes.pop()
        names.update(code.co_names)
        codes.extend(c for c in code.co_consts
                     if isinstance(c, types.CodeType))
    out = []
    for name in sorted(names):
        if name not in fn.__globals__:
            continue
        value = fn.__globals__[name]
        out.append((name, value if isinstance(value, (
            types.ModuleType, type, types.FunctionType,
            types.BuiltinFunctionType)) else value_key(value)))
    return tuple(out)


def math_key():
    """The process's settings that choose the library kernels a capture
    bakes in: TF32 in cuBLAS and cuDNN, the float32 matmul precision,
    reduced-precision reductions, the preferred BLAS library,
    deterministic algorithms and cuDNN's switches."""
    matmul, cudnn = torch.backends.cuda.matmul, torch.backends.cudnn
    return (matmul.allow_tf32, cudnn.allow_tf32,
            torch.get_float32_matmul_precision(),
            matmul.allow_fp16_reduced_precision_reduction,
            matmul.allow_bf16_reduced_precision_reduction,
            torch.backends.cuda.preferred_blas_library(),
            torch.are_deterministic_algorithms_enabled(),
            torch.is_deterministic_algorithms_warn_only_enabled(),
            cudnn.enabled, cudnn.deterministic, cudnn.benchmark)


def model_key(model):
    """What decides ``model``'s step besides its tensors' values: each
    module's class and settings (widths, activation, an ansatz), and the
    names, shapes, dtypes and devices (with their index) of its parameters
    and buffers.
    Raises :class:`_NoKey` for a module with hooks or a tensor held as a
    plain attribute."""
    modules = []
    for name, m in model.named_modules():
        if any(getattr(m, h) for h in _HOOKS):
            raise _NoKey
        modules.append((name, type(m), tuple(
            (k, value_key(v)) for k, v in sorted(vars(m).items())
            if k not in _MODULE_ATTRS), m.training))
    tensors = tuple(
        (name, tuple(t.shape), t.dtype, t.device, t.requires_grad)
        for name, t in (*model.named_parameters(), *model.named_buffers()))
    return tuple(modules), tensors


def structure_key(problem, model):
    """``problem`` and ``model`` described for a graph's key
    (:func:`value_key`, :func:`model_key`), with the process's math
    settings (:func:`math_key`); None where either cannot be described."""
    try:
        return value_key(problem), model_key(model), math_key()
    except _NoKey:
        return None


def graph_key(problem, model, config, device, mesh=None):
    """The key of the scan graph that trains ``model`` on ``problem``
    under ``config``: exactly what the captured kernels read as host
    values or shapes, and the math settings that chose them
    (:func:`math_key`). The seed, the lr, the starting weights and moments,
    the draws and, under a constant schedule, the iterations are left out:
    each call copies them in. None (a graph of the call's own) on a mesh,
    or where the problem or the model cannot be described (an unhashable
    problem, a tensor held outside the parameters and buffers)."""
    structure = structure_key(problem, model)
    if mesh is not None or structure is None:
        return None
    horizon = (None if config.schedule == "constant"
               else (float(config.iterations), float(config.schedule_decay)))
    oversample = (config.adaptive_oversample
                  if config.adaptive_oversample > 1 else 0)
    return ("scan", structure, is_stateful(model), config.optimizer,
            config.schedule, horizon, config.batch_size, oversample,
            GRAPH_STEPS, CAPTURE_STEPS, device)


def _tensors(model):
    return [*model.parameters(), *model.buffers()]


class _ScanEntry:
    """A cached scan graph and what it holds pointers to: a module of its
    own, its optimizer (the moments and capturable Adam's ``step``
    tensors), the device schedule, the step closure (and through it the
    problem) and the :class:`ScanGraph` with its static draws and
    losses."""

    def __init__(self, model, optimizer, schedule, step, graph):
        self.model, self.optimizer = model, optimizer
        self.schedule, self.step, self.graph = schedule, step, graph

    def free(self):
        """Release the graph and its memory pool (evicted)."""
        self.graph.graph.reset()

    def load(self, model, opt_state, config):
        """A call's starting state, copied into the entry's tensors on the
        device: ``model``'s parameters and buffers; the moments and
        ``step`` from ``opt_state`` (a state_dict), or zero; the lr and
        the update count, as ``make_optimizer``, ``load_opt_state`` and
        :class:`DeviceSchedule` set them for a fresh capture."""
        saved = opt_state["state"] if opt_state is not None else {}
        with torch.no_grad():
            for dst, src in zip(_tensors(self.model), _tensors(model)):
                dst.copy_(src)
            params = [p for group in self.optimizer.param_groups
                      for p in group["params"]]
            for i, p in enumerate(params):
                for name, t in self.optimizer.state[p].items():
                    if torch.is_tensor(t):
                        src = saved.get(i, {}).get(name)
                        if src is None:
                            t.zero_()
                        else:
                            t.copy_(src)
        for j, group in enumerate(self.optimizer.param_groups):
            count = (int(opt_state["param_groups"][j].get("count", 0))
                     if opt_state is not None else 0)
            group.update(lrate=float(config.lrate),
                         horizon=float(config.iterations),
                         decay=float(config.schedule_decay), count=count)
        self.schedule.load()


# ---------------------------------------------------------------------------
# The training loop
# ---------------------------------------------------------------------------


def _snapshot(model, optimizer):
    """Host copies of the model's and the optimizer's state."""
    def host(obj):
        if torch.is_tensor(obj):
            return obj.detach().to("cpu", copy=True)
        if isinstance(obj, dict):
            return {k: host(v) for k, v in obj.items()}
        if isinstance(obj, list):
            return [host(v) for v in obj]
        return copy.deepcopy(obj)

    return host(model.state_dict()), host(optimizer.state_dict())


def train(problem, seed: int, config: TrainConfig | None = None, model=None,
          opt_state=None, start_step: int = 0, device="cuda", mesh=None,
          profile_dir: str | None = None) -> TrainResult:
    """Train ``model`` (default: ``problem.default_model()`` initialised
    from ``generator(seed)``) on ``problem``, in place; it stands for the
    JAX package's ``params`` and comes back as ``TrainResult.params``.
    ``opt_state`` (a previous ``TrainResult.opt_state``) and ``start_step``
    resume a run; step ``i`` draws from ``step_generator(seed, i)``.
    ``config=None`` takes the iterations, batch size and lr of
    ``problem.defaults`` (not its schedule), as the JAX trainer does.

    Steps run in chunks of ``config.chunk_size``; on a CUDA device each
    whole block of GRAPH_STEPS steps of a chunk replays one CUDA graph
    (:class:`ScanGraph`) and the rest run eagerly, with the same bits: a
    ``chunk_size`` below GRAPH_STEPS runs every step eagerly. A call
    trains a module of its own from copies of ``model``, ``opt_state`` and
    the lr, copies the trained parameters and buffers back into ``model``
    and returns ``opt_state`` as a copy of its own. The graph is captured
    once per :func:`graph_key` and kept with that module: a later call of
    the key trains it, with the same bits as a fresh capture.
    ``compile_time`` is one warm-up step on copies of the model and
    optimizer state (with the build of the kernels the step launches, if
    it launches any) and the graph's capture, or for a cached key the
    copies in; ``wall_time`` and
    ``iters_per_sec`` cover the training steps only, ending in
    ``torch.cuda.synchronize()``. ``profile_dir`` writes a
    ``torch.profiler`` trace of the run there. ``device`` defaults to
    "cuda" and raises without a GPU.

    ``mesh`` (a mesh of parallel/mesh.py, or an ``{axis: size}`` dict
    made into one on ``device``) trains data-parallel over its
    ``config.data_axis`` (see the module's docstring); every rank runs
    this call and returns the same model, on the mesh's device. The batch
    must divide evenly over the axis. A BatchNorm model's batch
    statistics and a causal loss's weights couple the rows of a batch:
    they span the global batch, every rank's rows (``core.rows``)."""
    config = config or TrainConfig(
        iterations=problem.defaults.iterations,
        batch_size=problem.defaults.batch_size,
        lrate=problem.defaults.lrate,
    )
    device = build.resolve_device(device)
    if mesh is not None:
        from differential_equations_dnn_tpu_torch.parallel import mesh as pm
        from differential_equations_dnn_tpu_torch.parallel import (
            sharding,
        )

        mesh = pm.as_mesh(mesh, device)
        device = pm.mesh_device(mesh)
        pm.require_axis(mesh, config.data_axis, "data-parallel training")
    cuda = device.type == "cuda"
    chunk = max(1, min(config.chunk_size, config.iterations))
    graphs = cuda and chunk >= GRAPH_STEPS
    graph = key = entry = None
    with trace.span("train.setup", trainer="scan"):
        if model is None:
            model = problem.default_model(generator=generator(seed))
        model.to(device).train()
        if mesh is not None:
            # Refuses a batch the axis does not divide, before any step.
            sharding.shard_range(config.batch_size, mesh, config.data_axis)
            sharding.replicate(model, mesh)
        if graphs:
            key = graph_key(problem, model, config, device, mesh)
            entry = graph_cache.TRAINER_GRAPHS.get(key)
        if entry is not None:
            entry.load(model, opt_state, config)
            net, optimizer, schedule = (entry.model, entry.optimizer,
                                        entry.schedule)
            step, graph = entry.step, entry.graph
        else:
            net = copy.deepcopy(model)
            optimizer = make_optimizer(config, net.parameters())
            if opt_state is not None:
                load_opt_state(optimizer, opt_state)
            schedule = DeviceSchedule(optimizer) if cuda else None
            step = make_train_step(problem, net, optimizer,
                                   config.batch_size,
                                   config.adaptive_oversample, schedule,
                                   mesh, config.data_axis)

    def run_chunk(start, n):
        nonlocal graph
        losses = []
        for b0 in range(0, n, DRAW_BLOCK):
            k = min(DRAW_BLOCK, n - b0)
            with trace.span("train.draw", trainer="scan", steps=k):
                block = draw_batches(problem, seed, start + b0, k,
                                     step.draw_size, device)
            if graphs and k == GRAPH_STEPS:
                if graph is None:
                    graph = ScanGraph(step, block, net, optimizer,
                                      schedule, problem.name)
                losses.append(graph.replay(block))
            else:
                with trace.span("train.eager", steps=k):
                    losses.extend(step({key: v[j] for key, v
                                        in block.items()})[None]
                                  for j in range(k))
            if schedule is not None:
                schedule.count_steps(k)
        with trace.span("train.fetch"):
            return torch.cat(losses).cpu().numpy()

    # Warm-up: one step on copies of the state (it builds the kernels the
    # step launches, if any), then the capture; a cached key needs neither.
    t0 = time.perf_counter()
    if entry is not None:
        trace.count("graph.reuses.scan")
    else:
        with trace.span("train.warmup", trainer="scan"):
            warm_model = copy.deepcopy(net)
            warm_opt = make_optimizer(config, warm_model.parameters())
            warm_opt.load_state_dict(copy.deepcopy(optimizer.state_dict()))
            warm_step = make_train_step(problem, warm_model, warm_opt,
                                        config.batch_size,
                                        config.adaptive_oversample,
                                        DeviceSchedule(warm_opt) if cuda
                                        else None, mesh, config.data_axis)
            block = draw_batches(problem, seed, start_step,
                                 GRAPH_STEPS if graphs else 1,
                                 step.draw_size, device)
            warm_step({k: v[0] for k, v in block.items()})
            del warm_model, warm_opt, warm_step
            if graphs:
                graph = ScanGraph(step, block, net, optimizer, schedule,
                                  problem.name)
                if key is not None:
                    graph_cache.TRAINER_GRAPHS.put(key, _ScanEntry(
                        net, optimizer, schedule, step, graph))
            build.sync(device)
    compile_time = time.perf_counter() - t0

    n_full, rem = divmod(config.iterations, chunk)
    chunks = [chunk] * n_full + ([rem] if rem else [])
    metrics_fh = open(config.metrics_file, "a") if config.metrics_file \
        else None
    snapshot = ((_snapshot(net, optimizer), start_step, 0)
                if config.snapshot_every else None)
    retries = dispatch_idx = 0
    losses_out = []
    profiler = contextlib.nullcontext()
    if profile_dir:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        profiler = torch.profiler.profile(activities=acts)
    t0 = time.perf_counter()
    done = start_step
    try:
        with profiler as prof:
            ci = 0
            while ci < len(chunks):
                n = chunks[ci]
                try:
                    if _FAULT_QUEUE and dispatch_idx == _FAULT_QUEUE[0]:
                        _FAULT_QUEUE.pop(0)
                        raise _InjectedFault(
                            f"injected at dispatch {dispatch_idx}")
                    c0 = time.perf_counter()
                    losses = run_chunk(done, n)
                    chunk_s = time.perf_counter() - c0
                except Exception as err:  # noqa: BLE001 — filtered below
                    dispatch_idx += 1
                    if (snapshot is None or retries >= config.max_retries
                            or not _is_recoverable(err)):
                        raise
                    retries += 1
                    (model_state, opt_saved), done, ci = snapshot
                    net.load_state_dict(model_state)
                    optimizer.load_state_dict(copy.deepcopy(opt_saved))
                    if cuda:
                        # The optimizer's tensors were replaced: a new lr
                        # and count, and a graph captured on them, which
                        # is this call's alone.
                        schedule.reset(optimizer)
                        graph = None
                        graph_cache.TRAINER_GRAPHS.pop(key)
                    losses_out = losses_out[:ci]
                    print(f"[recovery] device failure "
                          f"({type(err).__name__}); restored snapshot at "
                          f"step {done}, retry {retries}/{config.max_retries}")
                    continue
                dispatch_idx += 1
                losses_out.append(losses)
                if config.verbose and config.log_every:
                    for j in range(0, n, config.log_every):
                        i = done + j
                        if i % config.log_every == 0:
                            print(f"Iteration: {i}, Loss: {losses[j]}, "
                                  f"LR: {config.lrate}")
                done += n
                ci += 1
                if config.snapshot_every and ci % config.snapshot_every == 0:
                    snapshot = (_snapshot(net, optimizer), done, ci)
                if metrics_fh:
                    metrics_fh.write(json.dumps({
                        "step": done,
                        "loss": float(losses[-1]),
                        "loss_mean": float(losses.mean()),
                        "loss_min": float(losses.min()),
                        "iters_per_sec": round(n / chunk_s, 1),
                    }) + "\n")
                    metrics_fh.flush()
            with torch.no_grad():
                for dst, src in zip(_tensors(model), _tensors(net)):
                    dst.copy_(src)
            build.sync(device)
    finally:
        if metrics_fh:
            metrics_fh.close()
    wall = time.perf_counter() - t0
    if profile_dir:
        os.makedirs(profile_dir, exist_ok=True)
        prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))

    loss_history = (np.concatenate(losses_out) if losses_out
                    else np.zeros((0,), np.float32))
    return TrainResult(
        params=model,
        # A copy: a kept entry's tensors are the next call's.
        opt_state=copy.deepcopy(optimizer.state_dict()),
        loss_history=loss_history,
        wall_time=wall,
        iters_per_sec=config.iterations / wall if wall else math.inf,
        compile_time=compile_time,
    )


def opt_state_from_jax(optax_state, model) -> dict:
    """The port's optimizer state (a state_dict :func:`load_opt_state` and
    ``train(opt_state=...)`` take) holding an optax Adam state's ``count``,
    ``mu`` and ``nu`` for ``model``. ``optax_state`` is the optimizer state
    of the JAX trainer (a chain whose ``ScaleByAdamState`` is found by its
    fields), with the moments as nested dicts of arrays in the JAX layout
    (``{"fc_in": {"w", "b"}, ...}``), as ``params_from_jax`` takes them."""
    adam = _find_adam(optax_state)
    if adam is None:
        raise ValueError("optax_state holds no Adam state (count, mu, nu)")
    count = int(np.asarray(adam.count))
    names = [name for name, _ in model.named_parameters()]

    def leaf(tree, name):
        for part in name.split("."):
            tree = tree[part]
        return torch.tensor(np.asarray(tree, np.float32))

    state = {i: {"step": torch.tensor(float(count)),
                 "exp_avg": leaf(adam.mu, name),
                 "exp_avg_sq": leaf(adam.nu, name)}
             for i, name in enumerate(names)}
    return {"state": state,
            "param_groups": [{"params": list(range(len(names))),
                              "count": count}]}


def _find_adam(state):
    if all(hasattr(state, f) for f in ("count", "mu", "nu")):
        return state
    if isinstance(state, (tuple, list)):
        for s in state:
            found = _find_adam(s)
            if found is not None:
                return found
    return None
