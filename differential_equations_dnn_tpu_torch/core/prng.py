"""Explicit, step-keyed randomness.

Weights are drawn from a seeded CPU ``torch.Generator`` (``generator(seed)``).
Collocation draws are keyed by the absolute step index, as the JAX package
keys them with ``fold_in(run_key, i)`` (kernels/fused_train.py:508-516): the
``[B, 2]`` uniforms of step ``i`` depend only on ``(seed, i)``, never on how
a run is cut into chunks or resumed.

The draws come from a counter-based integer hash evaluated with tensor ops,
so one seed gives bit-identical uniforms on the CPU and on the GPU. A step
hashes the lane indices ``0 .. batch_size · n_uniform − 1``, so at
``n_uniform=2`` the stream is the one the heat route has always drawn. The
stream is NOT JAX's threefry: the same seed gives other numbers than the
JAX package. Tests that compare the two hand both the same numpy uniforms.
"""

import torch

_M32 = 0xFFFFFFFF
_DRAW_DOMAIN = 0x5EED0001  # separates the draw stream from the init stream
_REPLICA_DOMAIN = 0x5EED0002  # and both from the replicas' init seeds
_STEP_DOMAIN = 0x5EED0003  # and all three from the scan trainer's steps
_TRIAL_DOMAIN = 0x5EED0004  # a population trial's stream seed
_FOLD_DOMAIN = 0x5EED0005  # a seed folded with a number


def generator(seed: int) -> torch.Generator:
    """A CPU generator for weight initialisation."""
    return torch.Generator().manual_seed(int(seed))


def step_generator(seed: int, i: int) -> torch.Generator:
    """The generator of step ``i`` of the scan trainer seeded ``seed``: a
    CPU generator whose 64-bit seed is the counter hash of ``(seed, i)``,
    the counterpart of the JAX package's ``fold_index(run_key, i)``
    (train/trainer.py:255-256). A step's draws depend on ``(seed, i)``
    alone, so a chunked run equals an uncut one, a resumed run an unbroken
    one, and the CPU and the GPU see the same batches."""
    key = _mix32(((seed ^ (seed >> 32)) ^ _STEP_DOMAIN) & _M32)
    h = _mix32((key + int(i) * 0x9E3779B9) & _M32)
    return torch.Generator().manual_seed((key << 32) | h)


def replica_generator(seed: int, r: int) -> torch.Generator:
    """The weight-init generator of replica ``r`` of an ensemble seeded
    ``seed``: a CPU generator whose 64-bit seed is the counter hash of
    ``(seed, r)``, the counterpart of the JAX package's ``fold_in(init_key,
    r)`` (kernels/fused_engine.py:1398-1402). Each replica's draws depend on
    ``(seed, r)`` alone, so replica r of an N-replica ensemble is the same
    network whatever N is. The single-run init ``generator(seed)`` is none
    of them."""
    key = _mix32(torch.tensor(((seed ^ (seed >> 32)) ^ _REPLICA_DOMAIN)
                              & _M32))
    h = _mix32((key + int(r) * 0x9E3779B9) & _M32)
    return torch.Generator().manual_seed((int(key) << 32) | int(h))


def _hash_pair(seed: int, n: int, domain: int) -> int:
    """The 64-bit counter hash of ``(seed, n)`` in ``domain``."""
    key = _mix32(((seed ^ (seed >> 32)) ^ domain) & _M32)
    return (key << 32) | _mix32((key + int(n) * 0x9E3779B9) & _M32)


def trial_seed(seed: int, t: int) -> int:
    """The seed of trial ``t``'s collocation stream in a population seeded
    ``seed``, the counterpart of the JAX package's ``fold_index(run_key,
    t)`` (parallel/population.py:99-101): trial t's step i draws from
    ``step_generator(trial_seed(seed, t), i)``, so its batches depend on
    ``(seed, t, i)`` alone, never on the population's size or its other
    trials, and a standalone ``train`` seeded ``trial_seed(seed, t)`` sees
    the same batches."""
    return _hash_pair(int(seed), t, _TRIAL_DOMAIN)


def fold_seed(seed: int, n: int) -> int:
    """``seed`` folded with ``n``, the counterpart of ``fold_in(key, n)``
    (a halving rung's population at ``(seed, spent)``)."""
    return _hash_pair(int(seed), n, _FOLD_DOMAIN)


def _mix32(x):
    """lowbias32 (C. Wellons) on int64 tensors (or Python ints) holding
    uint32 values. Tensor products wrap modulo 2^64, whose low 32 bits are
    the uint32 product."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def step_uniforms(seed: int, start: int, n: int, batch_size: int,
                  device=None, n_uniform: int = 2) -> torch.Tensor:
    """U[0, 1) draws of shape ``[n, batch_size, n_uniform]`` for the steps
    ``start .. start + n - 1``; float32 with 24 random bits each."""
    key = int(_mix32(torch.tensor(((seed ^ (seed >> 32)) ^ _DRAW_DOMAIN)
                                  & _M32)))
    steps = torch.arange(start, start + n, dtype=torch.int64, device=device)
    step_key = _mix32((steps * 0x9E3779B9 + key) & _M32)[:, None]
    lane = torch.arange(n_uniform * batch_size, dtype=torch.int64,
                        device=device)
    h = _mix32((lane * 0x85EBCA6B) & _M32 ^ step_key)
    h = _mix32((h + step_key) & _M32)
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u.reshape(n, batch_size, n_uniform)
