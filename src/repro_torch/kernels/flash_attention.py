"""Causal + sliding-window GQA attention: CUDA kernel wrapper + its plain
version.

Replaces the reference's ``kernels/flash_attention.py::
flash_attention_pallas``.  The kernel is ``csrc/flash_attention.cu`` (one
CTA per 64-query tile, head and batch row, KV streamed in tiles with the
online softmax in float32, masked tiles skipped through the loop bounds);
its header note gives the bound and the design.  The plain version is the
oracle :func:`repro_torch.kernels.ref.attention_ref`, the exact softmax in
float32.

q [B, Sq, H, hd], k and v [B, Skv, KV, hd], H = KV * G; query i sits at
position ``q_offset + i`` and sees key j when ``j <= q_offset + i`` and,
for ``window > 0``, ``j > q_offset + i - window``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.block import check

MAX_HEAD_DIM = 256   # the kernel's widest head (its shared-memory tile)


def check_shapes(q, k, v, *, window: int, q_offset: int) -> None:
    """Raise ``ValueError`` unless q, k and v have the layout above and
    every query row sees at least one key (on any device: the CPU must not
    accept what the card refuses)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B, Sq, H, hd], k and v [B, Skv, KV, hd]: got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Skv, KV, hdk = k.shape
    if Bk != B or hdk != hd or KV == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: "
                         "batch and head width must agree and H must be a "
                         "multiple of KV")
    if Skv == 0 or q_offset < 0 or (window > 0
                                    and q_offset + Sq - window >= Skv):
        raise ValueError(f"q_offset={q_offset}, window={window}, Sq={Sq}, "
                         f"Skv={Skv}: some query row would see no key")


def flash_attention(q, k, v, *, window: int = 0, q_offset: int = 0):
    """q [B, Sq, H, hd], k/v [B, Skv, KV, hd], all float32 or all bfloat16
    -> [B, Sq, H, hd] in q's dtype.  CPU tensors take
    :func:`repro_torch.kernels.ref.attention_ref`; CUDA tensors launch the
    kernel (counted on ``flash_attention``)."""
    check_shapes(q, k, v, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, window=window, q_offset=q_offset)
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: float32 or bfloat16, got {q.dtype}")
    dev = q.device
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    check(q, "q", q.dtype, (B, Sq, H, hd), dev)
    check(k, "k", q.dtype, (B, Skv, KV, hd), dev)
    check(v, "v", q.dtype, (B, Skv, KV, hd), dev)
    if hd > MAX_HEAD_DIM or B > 65535 or H > 65535:
        raise ValueError(f"hd={hd} (at most {MAX_HEAD_DIM}), B={B} and "
                         f"H={H} (at most 65535 each) exceed the kernel")
    out = torch.empty_like(q)
    fn = _build.library("flash_attention").repro_flash_attention
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = fn(_build.ptr(q), _build.ptr(k), _build.ptr(v), _build.ptr(out),
             B, Sq, Skv, H, KV, hd, window, q_offset, hd ** -0.5,
             int(q.dtype == torch.bfloat16), _build.stream_of(q))
    _build.check(err, "flash_attention")
    _build.LAUNCHES["flash_attention"] += 1
    return out
