"""Gather-fused distance block: CUDA kernel wrapper + its plain version.

Replaces the reference's ``kernels/l2dist.py::gather_block_distances_pallas``
(fp32, bf16, int8 and self-query bodies).  The kernel is
``csrc/l2dist.cu``; its header note gives the bound and the design.

``out[s, q, c] = qn + vn - 2 <Q[s, q], X[idx[s, c]]>`` (``-<., .>`` for
ip/cos), 3.4e38 where ``mask`` is False or ``idx`` lies outside [0, N).
With ``scales`` [N], X holds per-row int8 codes, dequantized as
``code * scales[id]`` before the same formula.  A bf16 X (a mesh plane's
``db_bf16`` database) is upcast row element by row element to fp32, as
the reference's XLA path upcasts its gathered rows.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block import block_distances_plain, check

INF = 3.4e38
# the compiled self-query bodies (NT 8-column tiles a warp; "_scalar":
# 4-byte staging; "_streamed": d in more than one chunk), then the int8
# row bodies (one warp a row; "_scalar": byte loads where d % 16 != 0),
# then the bf16 row bodies ("_scalar": element loads where d % 8 != 0 or a
# pointer is not 16-byte aligned), in repro_l2dist_attrs' order
SELFQ_BODIES = [f"selfq_nt{nt}{vec}{one}" for one in ("", "_streamed")
                for vec in ("", "_scalar") for nt in (4, 8)]
ROW8_BODIES = ["row8", "row8_scalar"]
ROWBF16_BODIES = ["rowbf16", "rowbf16_scalar"]
BODIES = SELFQ_BODIES + ROW8_BODIES + ROWBF16_BODIES


def _valid(X, idx, mask):
    valid = (idx >= 0) & (idx < X.shape[0])
    return valid if mask is None else valid & mask


def gather_distances_plain(Q, X, idx, mask=None, *, metric: str = "l2",
                           self_q: bool = False,
                           scales=None) -> torch.Tensor:
    """The same function in plain PyTorch (any device): Q [S, Kq, d]
    (ignored when ``self_q``) x X [N, d] x idx [S, C] -> [S, Kq, C].  A
    bf16 X is scored as ``X.float()`` (its gathered rows upcast)."""
    _check_dtypes(X, self_q, scales)
    idx_c = idx.clamp(0, X.shape[0] - 1).long()
    V = X[idx_c]                                          # [S, C, d]
    if V.dtype == torch.bfloat16:
        V = V.float()
    sc = None if scales is None else scales[idx_c]
    return block_distances_plain(V if self_q else Q, V, _valid(X, idx, mask),
                                 sc, metric=metric)


def _check_dtypes(X, self_q, scales) -> None:
    """bf16 rows take neither self-query tiles (the build is fp32) nor
    int8 scales."""
    if self_q and scales is not None:
        raise ValueError("self_q tiles (build-time diversify) score fp32 "
                         "rows; scales= is a search-time knob")
    if X.dtype == torch.bfloat16 and (self_q or scales is not None):
        raise ValueError("a bf16 X takes the search's row body only: no "
                         "self_q tiles and no int8 scales")


@functools.cache
def _gather_fn():
    """The built kernel's C entry point, typed once."""
    fn = _build.library("l2dist").repro_gather_distances
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _gather_bf16_fn():
    """The bf16 row body's C entry point, typed once."""
    fn = _build.library("l2dist").repro_gather_distances_bf16
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_distances(Q, X, idx, mask=None, *, metric: str = "l2",
                     self_q: bool = False, scales=None) -> torch.Tensor:
    """Distance block with the row gather inside the kernel.

    Q [S, Kq, d] float32 (None when ``self_q``), X [N, d] float32 or
    bf16 — or int8 codes with ``scales`` [N] float32 —, idx [S, C] int32,
    mask [S, C] bool or None -> [S, Kq, C] float32 (Kq = C when
    ``self_q``).  CPU tensors take :func:`gather_distances_plain`; CUDA
    tensors launch the kernel (counted on ``gather_distances``, on
    ``gather_distances_bf16`` for a bf16 X, or, with ``scales``, on
    ``gather_distances_int8``).  On the card, ``self_q`` tiles take
    C <= 1,024 (their staged rows fill a CTA's shared memory); a wider
    tile raises."""
    _check_dtypes(X, self_q, scales)
    if X.device.type == "cpu":
        return gather_distances_plain(Q, X, idx, mask, metric=metric,
                                      self_q=self_q, scales=scales)
    dev = X.device
    if metric not in ("l2", "ip", "cos"):
        raise ValueError(f"metric={metric!r}")
    quant = scales is not None
    bf16 = X.dtype == torch.bfloat16
    check(X, "X", torch.int8 if quant else X.dtype if bf16
          else torch.float32, (None, None), dev)
    N, d = X.shape
    check(idx, "idx", torch.int32, (None, None), dev)
    S, C = idx.shape
    if mask is not None:
        check(mask, "mask", torch.bool, (S, C), dev)
    if bf16:
        check(Q, "Q", torch.float32, (S, None, d), dev)
        Kq = Q.shape[1]
        out = torch.empty((S, Kq, C), dtype=torch.float32, device=dev)
        err = _gather_bf16_fn()(
            _build.ptr(Q), _build.ptr(X), _build.ptr(idx), _build.ptr(mask),
            _build.ptr(out), S, Kq, C, d, N, int(metric in ("ip", "cos")),
            _build.stream_of(X))
        _build.check(err, "gather_distances_bf16")
        _build.count("gather_distances_bf16")
        return out
    if quant:
        check(scales, "scales", torch.float32, (N,), dev)
    if self_q:
        Kq = C
    else:
        check(Q, "Q", torch.float32, (S, None, d), dev)
        Kq = Q.shape[1]
    out = torch.empty((S, Kq, C), dtype=torch.float32, device=dev)
    err = _gather_fn()(_build.ptr(None if self_q else Q), _build.ptr(X),
             _build.ptr(scales), _build.ptr(idx), _build.ptr(mask),
             _build.ptr(out), S, Kq, C, d, N, int(metric in ("ip", "cos")),
             int(self_q), _build.stream_of(X))
    _build.check(err, "gather_distances")
    _build.count("gather_distances_int8" if quant else "gather_distances")
    return out


def body_attributes() -> dict:
    """Registers and spilled (local) bytes a thread of each compiled body
    of :data:`BODIES`, as the card reports them: ``{"selfq_nt8": (regs,
    local), ..., "row8": ..., "rowbf16": ...}`` (NT: 8-column tiles a
    warp, 4 for K <= 32, 8 above)."""
    return _build.body_attributes("l2dist", "repro_l2dist_attrs", BODIES)
