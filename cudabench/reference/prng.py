"""Frozen copy of the program's seeded draws (the counter hash of
``core/prng.py`` in ``differential_equations_dnn_tpu_torch``), kept here so
that the reference rebuilds the same initial weights and collocation
points from a seed without importing the program. A change to the
program's draws makes its runs fail the comparison: that is intended."""

import torch

_M32 = 0xFFFFFFFF
_DRAW_DOMAIN = 0x5EED0001
_REPLICA_DOMAIN = 0x5EED0002
_STEP_DOMAIN = 0x5EED0003
_TRIAL_DOMAIN = 0x5EED0004


def _mix32(x):
    """lowbias32 on Python ints or int64 tensors holding uint32 values."""
    x = x ^ (x >> 16)
    x = (x * 0x7FEB352D) & _M32
    x = x ^ (x >> 15)
    x = (x * 0x846CA68B) & _M32
    return x ^ (x >> 16)


def _hash_pair(seed, n, domain):
    key = _mix32(((seed ^ (seed >> 32)) ^ domain) & _M32)
    return (key << 32) | _mix32((key + int(n) * 0x9E3779B9) & _M32)


def generator(seed):
    """The CPU generator of a single run's weights."""
    return torch.Generator().manual_seed(int(seed))


def step_generator(seed, i):
    """The CPU generator of step ``i`` of a scan run seeded ``seed``."""
    return torch.Generator().manual_seed(_hash_pair(int(seed), i,
                                                    _STEP_DOMAIN))


def replica_generator(seed, r):
    """The CPU generator of replica (or trial) ``r``'s weights."""
    return torch.Generator().manual_seed(_hash_pair(int(seed), r,
                                                    _REPLICA_DOMAIN))


def trial_seed(seed, t):
    """The seed of a population trial's collocation stream."""
    return _hash_pair(int(seed), t, _TRIAL_DOMAIN)


def step_uniforms(seed, start, n, batch_size, n_uniform=2):
    """The fused trainers' U[0, 1) draws ``[n, batch_size, n_uniform]`` for
    steps ``start .. start + n − 1`` (24 random bits each), on the CPU."""
    key = int(_mix32(torch.tensor(((seed ^ (seed >> 32)) ^ _DRAW_DOMAIN)
                                  & _M32)))
    steps = torch.arange(start, start + n, dtype=torch.int64)
    step_key = _mix32((steps * 0x9E3779B9 + key) & _M32)[:, None]
    lane = torch.arange(n_uniform * batch_size, dtype=torch.int64)
    h = _mix32((lane * 0x85EBCA6B) & _M32 ^ step_key)
    h = _mix32((h + step_key) & _M32)
    u = (h >> 8).to(torch.float32) * (1.0 / (1 << 24))
    return u.reshape(n, batch_size, n_uniform)
