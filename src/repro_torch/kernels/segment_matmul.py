"""Packed SpMM (fixed-degree neighbour aggregation, then a product with
W): CUDA kernel wrapper + its plain version.

Replaces the reference's ``kernels/segment_matmul.py::packed_spmm_pallas``.
The kernel is ``csrc/segment_matmul.cu`` (the gather, the sum or mean and
the product with W in one body, the aggregate kept in shared memory); its
header note gives the bound and the design.

``out[i] = agg[i] @ W`` with ``agg[i]`` the float32 sum of
``feat[nbrs[i, t]]`` over the lanes whose id is below ``Nf``
(``feat.shape[0]``), in the order t = 0 .. M-1, divided by
``max(cnt_i, 1)`` for ``combine="mean"``.  A negative id reads row 0 and
counts, as the reference's plain path clips it.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block import check

COMBINES = ("mean", "sum")
# the kernel stages a tile's neighbour ids in shared memory: 64 x M ints
MAX_DEGREE = 512


def aggregate(neighbors, feat, *, combine: str = "sum"):
    """``agg`` [N, d] float32 (plain PyTorch, any device): the reference's
    plain path (``ops.packed_spmm(use_pallas=False)``) before its ``@ w``,
    summed lane by lane in order."""
    if combine not in COMBINES:
        raise ValueError(f"combine={combine!r}")
    Nf = feat.shape[0]
    ok = neighbors < Nf
    rows = neighbors.long().clamp(0, Nf - 1)
    agg = torch.zeros((neighbors.shape[0], feat.shape[1]),
                      dtype=torch.float32, device=feat.device)
    for t in range(neighbors.shape[1]):
        agg = agg + torch.where(ok[:, t, None],
                                feat[rows[:, t]].to(torch.float32), 0.0)
    if combine == "mean":
        agg = agg / torch.clamp(ok.sum(1, keepdim=True), min=1)
    return agg


def packed_spmm_plain(neighbors, feat, w, *, combine: str = "sum"):
    """The same function in plain PyTorch (any device): neighbors [N, M]
    x feat [Nf, d] x w [d, f] -> [N, f] in feat's dtype."""
    return (aggregate(neighbors, feat, combine=combine)
            @ w.to(torch.float32)).to(feat.dtype)


def packed_spmm(neighbors, feat, w, *, combine: str = "sum"):
    """neighbors [N, M] int32 x feat [Nf, d] float32 x w [d, f] float32 ->
    [N, f] float32.  CPU tensors take :func:`packed_spmm_plain`; CUDA
    tensors launch the kernel (counted on ``packed_spmm``), which does the
    product with W itself."""
    if feat.device.type == "cpu":
        return packed_spmm_plain(neighbors, feat, w, combine=combine)
    if combine not in COMBINES:
        raise ValueError(f"combine={combine!r}")
    dev = feat.device
    check(feat, "feat", torch.float32, (None, None), dev)
    Nf, d = feat.shape
    check(neighbors, "neighbors", torch.int32, (None, None), dev)
    check(w, "w", torch.float32, (d, None), dev)
    (N, M), f = neighbors.shape, w.shape[1]
    if M > MAX_DEGREE:
        raise ValueError(f"degree M={M} exceeds the kernel's {MAX_DEGREE}")
    if Nf == 0 and N * M > 0:
        raise ValueError("feat has no rows to gather")
    out = torch.empty((N, f), dtype=torch.float32, device=dev)
    fn = _build.library("segment_matmul").repro_packed_spmm
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_build.ptr(neighbors), _build.ptr(feat), _build.ptr(w),
             _build.ptr(out), N, M, Nf, d, f, int(combine == "mean"),
             _build.stream_of(feat))
    _build.check(err, "packed_spmm")
    _build.LAUNCHES["packed_spmm"] += 1
    return out
