"""Bucketed open-addressing visited filter: CUDA kernel wrapper + its plain
version.

Replaces the reference's ``kernels/visited.py::visited_filter_pallas``.
``table`` [B, S, W] int32 (EMPTY = -1, S a power of two) is one hash set
per row, bucket-major: a bucket's W ways are contiguous (the reference's
table is [B, W, S], the same sets transposed).  Lanes are probed and
inserted one after another, in the order given; ``fresh`` marks lanes that
are valid, were absent and found a free way.  Both versions update
``table`` IN PLACE and return it: the large regime's table is 671 MB, and
no caller reads the old state again.  The kernel is ``csrc/visited.cu``
(one warp a row, its 32 lanes' probes at once, their order resolved in
registers).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

VF_EMPTY = -1
MAX_WAYS = 8   # a bucket the kernel holds in registers
# the compiled bodies, in repro_visited_attrs' order: two 16-byte loads a
# bucket (W = 8), then word by word
BODIES = ["bucket_vec", "bucket_scalar"]
_GOLD = 0x9E3779B9  # Knuth's 2654435761 (int32 -1640531527)


def shift_for(n_buckets: int) -> int:
    """Right-shift amount mapping a 32-bit hash onto [0, n_buckets)."""
    if n_buckets < 2 or n_buckets & (n_buckets - 1):
        raise ValueError(
            f"visited-filter bucket count must be a power of two >= 2, "
            f"got {n_buckets}")
    return 32 - (n_buckets.bit_length() - 1)


def hash_bucket(ids: torch.Tensor, shift: int) -> torch.Tensor:
    """int32 ids -> int64 bucket indices in [0, 2**(32-shift)).

    The multiply wraps at 32 bits and the shift is logical: widened to
    int64 and masked, because torch's ``>>`` on int32 is arithmetic."""
    return ((ids.to(torch.int64) * _GOLD) & 0xFFFFFFFF) >> shift


def visited_filter_plain(table, ids, valid):
    """Plain PyTorch version (any device): one lane at a time, each a
    vectorized probe of the row batch's buckets.  Each row writes one way a
    lane (itself where the lane is not fresh), so no step indexes by a mask
    and none waits for the host: a CUDA graph can capture it."""
    B, S, W = table.shape
    shift = shift_for(S)
    rows = torch.arange(B, device=table.device)
    ways = torch.arange(W, device=table.device)
    bucket = hash_bucket(ids, shift)
    fresh = torch.zeros_like(valid)
    for m in range(ids.shape[1]):
        bk, lid = bucket[:, m], ids[:, m]
        tab = table[rows, bk]                                  # [B, W]
        hit = (tab == lid[:, None]).any(dim=1)
        slot = torch.where(tab == VF_EMPTY, ways, W).amin(dim=1)
        f = valid[:, m] & ~hit & (slot < W)
        fresh[:, m] = f
        way = slot.clamp(max=W - 1)
        table[rows, bk, way] = torch.where(f, lid, table[rows, bk, way])
    return table, fresh


@functools.cache
def _filter_fn():
    """The built kernel's C entry point, typed once."""
    fn = _build.library("visited").repro_visited_filter
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def visited_filter(table, ids, valid):
    """table [B, S, W] int32 (updated in place), ids [B, M] int32,
    valid [B, M] bool -> (table, fresh [B, M] bool).  CPU tensors take
    :func:`visited_filter_plain`; CUDA tensors launch the kernel (W <= 8
    ways)."""
    if table.device.type == "cpu":
        return visited_filter_plain(table, ids, valid)
    B, S, W = table.shape
    M = ids.shape[1]
    dev = table.device
    for t, name, dt, shape in ((table, "table", torch.int32, (B, S, W)),
                               (ids, "ids", torch.int32, (B, M)),
                               (valid, "valid", torch.bool, (B, M))):
        if t.dtype != dt or tuple(t.shape) != shape or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {dt} {list(shape)} on {dev}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}")
    if W > MAX_WAYS:
        raise ValueError(f"{W} ways exceed the kernel's {MAX_WAYS}")
    shift = shift_for(S)
    fresh = torch.empty((B, M), dtype=torch.bool, device=dev)
    err = _filter_fn()(_build.ptr(table), _build.ptr(ids),
                       _build.ptr(valid), _build.ptr(fresh), B, W, S, M,
                       shift, _build.stream_of(table))
    _build.check(err, "visited_filter")
    _build.count("visited_filter")
    return table, fresh


def body_attributes() -> dict:
    """Registers and spilled (local) bytes a thread of each compiled body,
    as the card reports them: ``{"bucket_vec": (regs, local), ...}``."""
    return _build.body_attributes("visited", "repro_visited_attrs", BODIES)
