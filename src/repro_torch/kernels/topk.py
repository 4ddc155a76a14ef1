"""(dist, id) rank merge and bitonic sort / top-k: CUDA kernel wrappers +
their plain versions.

:func:`rank_merge` replaces the reference's
``kernels/topk.py::rank_merge_pallas``; :func:`bitonic_sort` and
:func:`bitonic_topk` replace ``bitonic_sort_pallas`` and
``bitonic_topk_pallas``, which share its network there as they share the
kernel here.  The kernel is ``csrc/topk.cu`` (one CTA per row, bitonic
network in shared memory, ids carried); its header note gives the bound
and the design.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

INF = 3.4e38
PAD_ID = 2 ** 31 - 1
# the kernel sorts a row in shared memory: at most this many lanes
MAX_LANES = 16384


def rank_merge_plain(dists, ids, mask=None, *, keep: int):
    """Row-wise ascending (dist, id) order, ids carried; the first ``keep``
    lanes (plain PyTorch, any device).  Two stable sorts stand for the
    reference's ``lexsort((ids, dists))``; the dist key maps -0.0 to +0.0
    as lexsort's comparator does, while the returned dists are the inputs'
    own values."""
    if not 0 < keep <= dists.shape[1]:
        raise ValueError(f"keep={keep} must be in (0, {dists.shape[1]}]")
    if mask is not None:
        dists = torch.where(mask, dists, torch.full_like(dists, INF))
    o1 = torch.argsort(ids, dim=1, stable=True)
    key = torch.where(dists == 0, torch.zeros_like(dists), dists)
    o2 = torch.argsort(key.gather(1, o1), dim=1, stable=True)
    order = o1.gather(1, o2)[:, :keep]
    return dists.gather(1, order), ids.gather(1, order)


def merge_in_chunks(merge, dists, ids, mask=None, *, keep: int,
                    width: int):
    """``merge(dists, ids, mask, keep=)`` over rows wider than the
    ``width`` lanes it can take: each column chunk of at most ``width``
    lanes keeps its best ``keep``, and the survivors are merged again
    until they fit.  Exact, since (dist, id) orders the lanes totally: a
    row's best ``keep`` are among its chunks' best ``keep``."""
    W = dists.shape[1]
    if W > width and keep >= width:
        raise ValueError(f"keep={keep} must be below the {width} lanes "
                         f"one merge takes, for rows of {W} lanes")
    while W > width:
        parts = [merge(dists[:, c:c + width].contiguous(),
                       ids[:, c:c + width].contiguous(),
                       None if mask is None
                       else mask[:, c:c + width].contiguous(),
                       keep=min(keep, W - c)) for c in range(0, W, width)]
        dists = torch.cat([p[0] for p in parts], dim=1)
        ids = torch.cat([p[1] for p in parts], dim=1)
        mask, W = None, dists.shape[1]     # masked lanes came back as INF
    return merge(dists, ids, mask, keep=keep)


def _check_rows(dists, ids, mask):
    R, W = dists.shape
    dev = dists.device
    for t, name, dt in ((dists, "dists", torch.float32),
                        (ids, "ids", torch.int32),
                        (mask, "mask", torch.bool)):
        if t is None:
            continue
        if t.dtype != dt or tuple(t.shape) != (R, W) or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {dt} [{R}, {W}] on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def _launch(dists, ids, mask, keep: int, counter: str):
    """One launch of the network over rows of at most ``MAX_LANES``."""
    R, W = dists.shape
    dev = dists.device
    Wp = 1 << max(W - 1, 0).bit_length()
    od = torch.empty((R, keep), dtype=torch.float32, device=dev)
    oi = torch.empty((R, keep), dtype=torch.int32, device=dev)
    fn = _build.library("topk").repro_rank_merge
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_build.ptr(dists), _build.ptr(ids), _build.ptr(mask),
             _build.ptr(od), _build.ptr(oi), R, W, Wp, keep,
             _build.stream_of(dists))
    _build.check(err, counter)
    _build.LAUNCHES[counter] += 1
    return od, oi


def rank_merge(dists, ids, mask=None, *, keep: int):
    """dists [R, W] float32, ids [R, W] int32, mask [R, W] bool or None ->
    (dists [R, keep], ids [R, keep]).  CPU tensors take
    :func:`rank_merge_plain`; CUDA tensors launch the kernel, in column
    chunks (:func:`merge_in_chunks`) when W exceeds its ``MAX_LANES``."""
    if dists.device.type == "cpu":
        return rank_merge_plain(dists, ids, mask, keep=keep)
    W = dists.shape[1]
    if not 0 < keep <= W:
        raise ValueError(f"keep={keep} must be in (0, {W}]")
    _check_rows(dists, ids, mask)
    if W > MAX_LANES:
        return merge_in_chunks(rank_merge, dists, ids, mask, keep=keep,
                               width=MAX_LANES)
    return _launch(dists, ids, mask, keep, "rank_merge")


def _power_of_two(W: int) -> None:
    if W <= 0 or W & (W - 1):
        raise ValueError(f"width {W} must be a power of two")


def bitonic_topk(dists, ids, k: int):
    """dists [R, W] float32, ids [R, W] int32, W a power of two ->
    the first ``k`` lanes of each row in ascending (dist, id) order.
    A width that is not a power of two raises ``ValueError`` on any
    device, as the reference's kernel refuses it.  CPU tensors take
    :func:`rank_merge_plain` (the plain version, ``ref.topk_ref``); CUDA
    tensors launch the kernel (counted on ``bitonic_sort``), in column
    chunks when W exceeds ``MAX_LANES``."""
    W = dists.shape[1]
    _power_of_two(W)
    if not 0 < k <= W:
        raise ValueError(f"k={k} must be in (0, {W}]")
    if dists.device.type == "cpu":
        return rank_merge_plain(dists, ids, keep=k)
    _check_rows(dists, ids, None)
    if W > MAX_LANES:
        return merge_in_chunks(
            functools.partial(_launch, counter="bitonic_sort"), dists, ids,
            keep=k, width=MAX_LANES)
    return _launch(dists, ids, None, k, "bitonic_sort")


def bitonic_sort(dists, ids):
    """dists [R, W] float32, ids [R, W] int32, W a power of two of at
    most ``MAX_LANES`` -> both sorted row-wise by (dist, id).  Other widths
    raise ``ValueError`` on any device; CPU tensors take the plain version
    (``ref.sort_ref``), CUDA tensors launch the kernel (counted on
    ``bitonic_sort``)."""
    W = dists.shape[1]
    _power_of_two(W)
    if W > MAX_LANES:
        raise ValueError(f"width {W} exceeds the {MAX_LANES} lanes the "
                         "kernel sorts in shared memory")
    return bitonic_topk(dists, ids, W)
