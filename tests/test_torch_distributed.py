"""The port's multi-process initialisation (parallel/distributed.py),
mirroring tests/test_distributed.py: two real processes on this host join
one gloo group through ``initialize_distributed`` over TCP on localhost
(one by its arguments, one by torchrun's environment variables), check a
reduction across them, and run data-parallel training and a population
sweep over the two. The results are held against the same programs in
this single process: the topology moves rows and trials, not the maths
(the sweep bit for bit, the data-parallel losses to fp32 reassociation,
rtol 1e-4)."""

import socket

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import torch.multiprocessing as mp  # noqa: E402

from differential_equations_dnn_tpu_torch.parallel import (  # noqa: E402
    initialize_distributed,
)

import torch_parallel_cases as cases  # noqa: E402


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_single_process_is_a_no_op(monkeypatch):
    """No coordinator and one process: nothing to join, as in JAX."""
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    assert initialize_distributed(device="cpu") is False
    assert initialize_distributed(num_processes=1, device="cpu") is False


def test_a_partial_group_description_raises(monkeypatch):
    for name in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="coordinator_address"):
        initialize_distributed(num_processes=2, device="cpu")


def test_two_process_group():
    port = _free_port()
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    procs = [ctx.Process(target=cases.initialize_and_run,
                         args=(port, rank, rank == 1, results), daemon=True)
             for rank in (0, 1)]
    for p in procs:
        p.start()
    try:
        got = sorted(results.get(timeout=180) for _ in procs)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
    for rank, (r, joined, total, train, best) in enumerate(got):
        assert (r, joined) == (rank, True), total
        assert total == 3.0
    losses, params = got[0][3]
    want_losses, want_params = cases.data_parallel_train("jvp", None)
    np.testing.assert_allclose(losses, want_losses, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(params, want_params, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1][3][0], losses)
    assert got[0][4] == got[1][4] == cases.sweep_case(None)
