"""Gather-fused distance block: CUDA kernel wrapper + its plain version.

Replaces the reference's ``kernels/l2dist.py::gather_block_distances_pallas``
(fp32, int8 and self-query bodies).  The kernel is ``csrc/l2dist.cu``; its
header note gives the bound and the design.

``out[s, q, c] = qn + vn - 2 <Q[s, q], X[idx[s, c]]>`` (``-<., .>`` for
ip/cos), 3.4e38 where ``mask`` is False or ``idx`` lies outside [0, N).
With ``scales`` [N], X holds per-row int8 codes, dequantized as
``code * scales[id]`` before the same formula.
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
# row bodies (one warp a row; "_scalar": byte loads where d % 16 != 0), in
# repro_l2dist_attrs' order
SELFQ_BODIES = [f"selfq_nt{nt}{vec}{one}" for one in ("", "_streamed")
                for vec in ("", "_scalar") for nt in (4, 8)]
ROW8_BODIES = ["row8", "row8_scalar"]
BODIES = SELFQ_BODIES + ROW8_BODIES


def _valid(X, idx, mask):
    valid = (idx >= 0) & (idx < X.shape[0])
    return valid if mask is None else valid & mask


def gather_distances_plain(Q, X, idx, mask=None, *, metric: str = "l2",
                           self_q: bool = False,
                           scales=None) -> torch.Tensor:
    """The same function in plain PyTorch (any device): Q [S, Kq, d]
    (ignored when ``self_q``) x X [N, d] x idx [S, C] -> [S, Kq, C]."""
    idx_c = idx.clamp(0, X.shape[0] - 1).long()
    V = X[idx_c]                                          # [S, C, d]
    sc = None if scales is None else scales[idx_c]
    return block_distances_plain(V if self_q else Q, V, _valid(X, idx, mask),
                                 sc, metric=metric)


@functools.cache
def _gather_fn():
    """The built kernel's C entry point, typed once."""
    fn = _build.library("l2dist").repro_gather_distances
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def gather_distances(Q, X, idx, mask=None, *, metric: str = "l2",
                     self_q: bool = False, scales=None) -> torch.Tensor:
    """Distance block with the row gather inside the kernel.

    Q [S, Kq, d] float32 (None when ``self_q``), X [N, d] float32 — or int8
    codes with ``scales`` [N] float32 —, idx [S, C] int32, mask [S, C] bool
    or None -> [S, Kq, C] float32 (Kq = C when ``self_q``).  CPU tensors
    take :func:`gather_distances_plain`; CUDA tensors launch the kernel
    (counted on ``gather_distances`` or, with ``scales``, on
    ``gather_distances_int8``).  On the card, ``self_q`` tiles take
    C <= 1,024 (their staged rows fill a CTA's shared memory); a wider
    tile raises."""
    if self_q and scales is not None:
        raise ValueError("self_q tiles (build-time diversify) score fp32 "
                         "rows; scales= is a search-time knob")
    if X.device.type == "cpu":
        return gather_distances_plain(Q, X, idx, mask, metric=metric,
                                      self_q=self_q, scales=scales)
    dev = X.device
    if metric not in ("l2", "ip", "cos"):
        raise ValueError(f"metric={metric!r}")
    quant = scales is not None
    check(X, "X", torch.int8 if quant else torch.float32, (None, None), dev)
    N, d = X.shape
    check(idx, "idx", torch.int32, (None, None), dev)
    S, C = idx.shape
    if mask is not None:
        check(mask, "mask", torch.bool, (S, C), dev)
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
    _build.LAUNCHES["gather_distances_int8" if quant
                    else "gather_distances"] += 1
    return out


def body_attributes() -> dict:
    """Registers and spilled (local) bytes a thread of each compiled body
    of :data:`BODIES`, as the card reports them: ``{"selfq_nt8": (regs,
    local), ..., "row8": ...}`` (NT: 8-column tiles a warp, 4 for K <= 32,
    8 above)."""
    return _build.body_attributes("l2dist", "repro_l2dist_attrs", BODIES)
