"""Gather-fused distance block: CUDA kernel wrapper + its plain version.

Replaces the reference's ``kernels/l2dist.py::gather_block_distances_pallas``
(fp32 and self-query bodies; the int8 body comes with the quantization
slice).  The kernel is ``csrc/l2dist.cu``; its header note gives the bound
and the design.

``out[s, q, c] = qn + vn - 2 <Q[s, q], X[idx[s, c]]>`` (``-<., .>`` for
ip/cos), 3.4e38 where ``mask`` is False or ``idx`` lies outside [0, N).
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

INF = 3.4e38


def _valid(X, idx, mask):
    valid = (idx >= 0) & (idx < X.shape[0])
    return valid if mask is None else valid & mask


def gather_distances_plain(Q, X, idx, mask=None, *, metric: str = "l2",
                           self_q: bool = False) -> torch.Tensor:
    """The same function in plain PyTorch (any device): Q [S, Kq, d]
    (ignored when ``self_q``) x X [N, d] x idx [S, C] -> [S, Kq, C]."""
    N = X.shape[0]
    V = X[idx.clamp(0, N - 1).long()]                    # [S, C, d]
    Q3 = V if self_q else Q
    dots = torch.bmm(Q3, V.transpose(1, 2))
    if metric in ("ip", "cos"):
        dist = -dots
    else:
        qn = torch.sum(Q3 * Q3, dim=2)
        vn = torch.sum(V * V, dim=2)
        dist = qn[:, :, None] + vn[:, None, :] - 2.0 * dots
    return torch.where(_valid(X, idx, mask)[:, None, :], dist,
                       torch.full_like(dist, INF))


def _check(t, name, dtype, ndim, device):
    if t.dtype != dtype or t.dim() != ndim or t.device != device \
            or not t.is_contiguous():
        raise ValueError(
            f"{name}: expected a contiguous {ndim}-D {dtype} tensor on "
            f"{device}, got {tuple(t.shape)} {t.dtype} on {t.device} "
            f"(contiguous={t.is_contiguous()})")


def gather_distances(Q, X, idx, mask=None, *, metric: str = "l2",
                     self_q: bool = False) -> torch.Tensor:
    """Distance block with the row gather inside the kernel.

    Q [S, Kq, d] float32 (None when ``self_q``), X [N, d] float32,
    idx [S, C] int32, mask [S, C] bool or None -> [S, Kq, C] float32
    (Kq = C when ``self_q``).  CPU tensors take
    :func:`gather_distances_plain`; CUDA tensors launch the kernel."""
    if X.device.type == "cpu":
        return gather_distances_plain(Q, X, idx, mask, metric=metric,
                                      self_q=self_q)
    dev = X.device
    if metric not in ("l2", "ip", "cos"):
        raise ValueError(f"metric={metric!r}")
    _check(X, "X", torch.float32, 2, dev)
    _check(idx, "idx", torch.int32, 2, dev)
    S, C = idx.shape
    N, d = X.shape
    if mask is not None:
        _check(mask, "mask", torch.bool, 2, dev)
        if tuple(mask.shape) != (S, C):
            raise ValueError(f"mask {tuple(mask.shape)} != idx {(S, C)}")
    if self_q:
        Kq = C
    else:
        _check(Q, "Q", torch.float32, 3, dev)
        if Q.shape[0] != S or Q.shape[2] != d:
            raise ValueError(f"Q {tuple(Q.shape)} does not match idx "
                             f"{(S, C)} and X {(N, d)}")
        Kq = Q.shape[1]
    out = torch.empty((S, Kq, C), dtype=torch.float32, device=dev)
    lib = _build.library("l2dist")
    fn = lib.repro_gather_distances
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_build.ptr(None if self_q else Q), _build.ptr(X),
             _build.ptr(idx), _build.ptr(mask), _build.ptr(out), S, Kq, C,
             d, N, int(metric in ("ip", "cos")), int(self_q),
             _build.stream_of(X))
    _build.check(err, "gather_distances")
    gather_distances.launches += 1
    return out


gather_distances.launches = 0
