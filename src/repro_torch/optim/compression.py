"""Error-feedback int8 gradient compression (the 1-bit-Adam family trick):
the port's copy of the reference's ``optim/compression.py``.

Gradients are quantized per tensor to int8 with a scale, the quantization
residual is carried in an error-feedback buffer (so the long-run update
is exact), and the int8 payload is what an all-reduce moves.
:func:`compressed_psum` is that all-reduce over a ``torch.distributed``
group: all ranks quantize against one shared scale (a MAX all-reduce of
the local maxima), so the int8 codes sum exactly as int32.  The per-tensor
``quantize`` / ``dequantize`` live in :mod:`repro_torch.ann.quantize`.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from repro_torch.ann import quantize as _q
from repro_torch.optim.tree import tree_map


def compress_with_feedback(grad: torch.Tensor, error: torch.Tensor):
    """Return (q, scale, new_error): grad + error is quantized and the
    residual is carried forward."""
    corrected = grad.to(torch.float32) + error
    q, scale = _q.quantize(corrected)
    new_error = corrected - _q.dequantize(q, scale)
    return q, scale, new_error


def init_error_state(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compressed_psum(grad_tree, error_tree, group=None):
    """The EF-int8 all-reduce over ``group`` (None: the default group):
    each leaf's corrected gradient g + e is quantized against the shared
    scale max_ranks(max|g + e|) / 127 + 1e-12, the int8 codes are summed
    as int32 across the ranks, and the sum times the scale is returned in
    the gradient's dtype, with each rank's new error buffer.  Returns
    (summed tree, error tree); every rank makes the same calls."""
    def leaf(g, e):
        corrected = g.to(torch.float32) + e
        top = torch.max(torch.abs(corrected))
        dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
        scale = top / 127.0 + 1e-12
        q = torch.clamp(torch.round(corrected / scale), -127, 127) \
            .to(torch.int8)
        new_e = corrected - q.to(torch.float32) * scale
        acc = q.to(torch.int32)
        dist.all_reduce(acc, op=dist.ReduceOp.SUM, group=group)
        return (acc.to(torch.float32) * scale).to(g.dtype), new_e

    out = tree_map(leaf, grad_tree, error_tree)   # a (sum, error) a leaf
    return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)
