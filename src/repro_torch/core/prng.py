"""Counter-based PRNG reproducing JAX's default ``threefry2x32`` draws.

The reference package draws its search seeds, its initial k-NN lists and
its bridge hubs with ``jax.random`` (jax 0.9, ``jax_threefry_partitionable
=True``).  This module recomputes the same bits with int64 tensor
arithmetic (uint32 values, wrapped with ``& 0xFFFFFFFF``), so the port's
searches start from the reference's seeds and their ids can be compared
entry by entry.

A key is an int64 tensor ``[..., 2]`` holding two uint32 words; every
function broadcasts over the leading axes, which replaces ``jax.vmap`` over
per-row keys.  Provided: :func:`key`, :func:`fold_in`, :func:`split`,
:func:`random_bits`, :func:`randint` and :func:`choice` (without
replacement, uniform) — exactly the calls the reference makes.
"""
from __future__ import annotations

import math
import numbers

import numpy as np
import torch

_MASK = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _MASK


def threefry2x32(k1, k2, x1, x2):
    """The Threefry-2x32 hash (20 rounds) on broadcastable int64 tensors of
    uint32 values -> (y1, y2)."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x0 = (x1 + ks[0]) & _MASK
    x1 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROT[i % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & _MASK
        x1 = (x1 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x0, x1


def key(seed: int, device=None) -> torch.Tensor:
    """``jax.random.key(seed)`` for a seed that fits int32: [2] int64.
    Made on the device by a fill, not copied from the host, so a search
    can be captured into a CUDA graph (capture refuses a pageable copy)."""
    seed = int(seed)
    hi = (seed >> 32) & _MASK if seed > _MASK else 0
    return torch.where(torch.arange(2, device=device) == 0, hi, seed & _MASK)


def fold_in(k: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in``: keys [..., 2] x data (int or tensor
    broadcastable to the key's batch shape) -> keys.  An int is filled in
    on the key's device (no host copy: capturable)."""
    if isinstance(data, numbers.Integral):
        data = torch.full((), int(data) & _MASK, dtype=torch.int64,
                          device=k.device)
    else:
        data = torch.as_tensor(data, device=k.device).to(torch.int64) & _MASK
    y0, y1 = threefry2x32(k[..., 0], k[..., 1], torch.zeros_like(data), data)
    return torch.stack(torch.broadcast_tensors(y0, y1), dim=-1)


def split(k: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable form): [..., 2] -> [..., num, 2]."""
    lo = torch.arange(num, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          torch.zeros_like(lo), lo)
    return torch.stack((y0, y1), dim=-1)


def random_bits(k: torch.Tensor, shape: tuple) -> torch.Tensor:
    """32 random bits per element: [..., 2] -> [..., *shape] int64 in
    [0, 2**32)."""
    n = math.prod(shape)
    count = torch.arange(n, dtype=torch.int64, device=k.device)
    y0, y1 = threefry2x32(k[..., 0, None], k[..., 1, None],
                          count >> 32, count & _MASK)
    return (y0 ^ y1).reshape(*k.shape[:-1], *shape)


def randint(k: torch.Tensor, shape: tuple, minval: int, maxval: int,
            dtype=torch.int32) -> torch.Tensor:
    """``jax.random.randint`` for int32 draws in [minval, maxval) (the
    reference's modulus construction, uint32 wraparound included)."""
    if not 0 <= maxval - minval <= 2 ** 31:
        raise ValueError(f"span {maxval - minval} outside [0, 2**31]")
    ks = split(k)
    hi = random_bits(ks[..., 0, :], shape)
    lo = random_bits(ks[..., 1, :], shape)
    span = (maxval - minval) & _MASK if maxval > minval else 1
    mult = (2 ** 16) % span
    mult = ((mult * mult) & _MASK) % span
    off = ((((hi % span) * mult) & _MASK) + lo % span) & _MASK
    return (minval + off % span).to(dtype)


def choice(k: torch.Tensor, n: int, shape: tuple) -> torch.Tensor:
    """``jax.random.choice(key, n, shape, replace=False)`` for one key [2]:
    the first ``prod(shape)`` entries of the reference's sort-based shuffle
    of ``arange(n)`` (int32)."""
    m = math.prod(shape)
    if m > n:
        raise ValueError(f"cannot take {m} samples from {n} without "
                         "replacement")
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(_MASK)))
    x = torch.arange(n, dtype=torch.int32, device=k.device)
    for _ in range(rounds):
        ks = split(k)
        k, sub = ks[0], ks[1]
        order = torch.argsort(random_bits(sub, (n,)), stable=True)
        x = x[order]
    return x[:m].reshape(shape)
