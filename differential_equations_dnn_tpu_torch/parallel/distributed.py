"""Multi-process initialisation, the global mesh, and spawned ranks.

Counterpart of the JAX package's parallel/distributed.py. Every rank runs
the same program (SPMD): under ``torchrun --nproc-per-node N`` each calls
:func:`initialize_distributed` at its start, then builds its mesh with
:func:`global_mesh` or ``make_mesh``. A CUDA rank works on
``cuda:{LOCAL_RANK}`` over NCCL; a CPU rank over gloo.

:func:`spawn_ranks` starts N gloo (or NCCL, one card each) processes on
this host and runs one function in all of them: how the tests and
``dryrun_multichip`` run several ranks without ``torchrun``.
"""

import logging
import os
import queue
import shutil
import tempfile
import time
import traceback
from datetime import timedelta

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from differential_equations_dnn_tpu_torch.kernels.build import resolve_device
from differential_equations_dnn_tpu_torch.parallel.mesh import (
    _BACKENDS,
    make_mesh,
)

logger = logging.getLogger(__name__)


def initialize_distributed(coordinator_address: str | None = None,
                           num_processes: int | None = None,
                           process_id: int | None = None,
                           device="cuda") -> bool:
    """Join this process to the group of ``num_processes`` ranks that meet
    at ``coordinator_address`` ("host:port") as rank ``process_id``, over
    NCCL (``device`` "cuda", the default) or gloo ("cpu"). Arguments left
    None are read from ``torchrun``'s ``MASTER_ADDR``/``MASTER_PORT``,
    ``WORLD_SIZE`` and ``RANK``; a CUDA rank takes ``cuda:{LOCAL_RANK}``
    (default: its rank modulo the host's cards) as its device.

    A single process (one rank and no coordinator) is a no-op, with a log
    line, as in the JAX package: safe to call at every program's start.
    Returns whether a process group was initialised."""
    env = os.environ
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = (f"{env['MASTER_ADDR']}:"
                               f"{env.get('MASTER_PORT', '29500')}")
    if num_processes in (None, 1) and coordinator_address is None:
        logger.info("single-process run; torch.distributed not initialised")
        return False
    if coordinator_address is None or num_processes is None \
            or process_id is None:
        raise ValueError("a multi-process run needs coordinator_address, "
                         "num_processes and process_id (or torchrun's "
                         "environment)")
    device = resolve_device(device)
    if device.type == "cuda":
        local = int(env.get("LOCAL_RANK",
                            process_id % torch.cuda.device_count()))
        torch.cuda.set_device(local)
    dist.init_process_group(_BACKENDS[device.type],
                            init_method=f"tcp://{coordinator_address}",
                            world_size=int(num_processes),
                            rank=int(process_id))
    logger.info("torch.distributed initialised: rank %d/%d on %s",
                dist.get_rank(), dist.get_world_size(), device.type)
    return True


def global_mesh(axes: dict[str, int] | None = None, data_axis: str = "data",
                device="cuda"):
    """A mesh over every rank of the group. Default: one ``data_axis``
    axis spanning the world (1 rank without a process group). Several
    hosts: ``{"pop": hosts, "data": cards_per_host}``, so that the
    gradient mean of ``data`` stays within a host and ``pop`` (no traffic
    while it trains) spans them."""
    if axes is None:
        world = dist.get_world_size() if dist.is_initialized() else 1
        axes = {data_axis: world}
    return make_mesh(axes, device)


def _rank_main(rank, n_ranks, store_path, device_type, timeout_s, fn, args,
               results):
    torch.set_num_threads(1)
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    try:
        dist.init_process_group(
            _BACKENDS[device_type],
            store=dist.FileStore(store_path, n_ranks), rank=rank,
            world_size=n_ranks, timeout=timedelta(seconds=timeout_s))
        try:
            results.put((rank, True, fn(*args)))
        finally:
            dist.destroy_process_group()
    except Exception:  # noqa: BLE001 — reported to the parent, which raises
        results.put((rank, False, traceback.format_exc()))


def spawn_ranks(fn, n_ranks: int, *args, device="cpu", timeout=300.0):
    """Run ``fn(*args)`` in ``n_ranks`` new processes that form one process
    group (gloo on the CPU; on CUDA NCCL, rank r on card r, which needs
    ``n_ranks`` cards), on a file store in a fresh temporary directory.
    ``fn`` must be importable by name and its result picklable (numpy,
    not tensors). Returns the results by rank; raises with the first
    failed rank's traceback, or if the ranks do not finish within
    ``timeout`` seconds (then every rank is terminated)."""
    device = resolve_device(device)
    if device.type == "cuda" and torch.cuda.device_count() < n_ranks:
        raise ValueError(f"{n_ranks} NCCL ranks need {n_ranks} cards, have "
                         f"{torch.cuda.device_count()} (two NCCL ranks "
                         f"cannot share one card)")
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="spmd-")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_ranks, os.path.join(tmp, "store"),
                               device.type, timeout, fn, args, results),
                         daemon=True)
             for r in range(n_ranks)]
    out = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        while len(out) < n_ranks:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                if time.monotonic() > deadline:
                    raise TimeoutError(f"{n_ranks} ranks of {fn.__name__} "
                                       f"did not finish in {timeout} s")
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead and results.empty():
                    raise RuntimeError(f"a rank of {fn.__name__} died "
                                       f"(exit code {dead[0]})")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} of {fn.__name__} "
                                   f"failed:\n{value}")
            out[rank] = value
    finally:
        for p in procs:
            p.join(timeout=10)
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=10)
        results.close()
        shutil.rmtree(tmp, ignore_errors=True)
    return [out[r] for r in range(n_ranks)]
