"""Symmetric int8 quantization: per row for compressed residency (the
reference's ``ann/quantize.py::quantize_rows`` / ``dequantize_rows``),
and per tensor for gradient compression (its ``quantize`` /
``dequantize``, which ``repro_torch.optim.compression`` uses).

Each row of the database gets its own fp32 scale ``max|x| / 127`` and an
int8 code vector; all-zero rows get scale 1.0 so they round-trip to exact
zeros.  The codes equal the reference's bit for bit: the division is
``x / scale`` in fp32 (not a multiply by a reciprocal) and ``torch.round``
rounds half to even, as ``jnp.round`` does.  Searches score the codes
in-kernel and re-rank the survivors exactly against the fp32 rows.
"""
from __future__ import annotations

import torch


def quantize(x: torch.Tensor):
    """Symmetric per-tensor int8 quantization -> (q, scale): scale =
    max|x| / 127 + 1e-12 (a float32 scalar), q = round(x / scale) clipped
    to [-127, 127], the reference's arithmetic."""
    x32 = x.to(torch.float32)
    scale = torch.max(torch.abs(x32)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(x32 / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor):
    return q.to(torch.float32) * scale


def quantize_rows(X: torch.Tensor):
    """[N, d] -> (codes [N, d] int8, scales [N] float32), with
    ``codes[i] * scales[i]`` within ``scales[i] / 2`` of ``X[i]``."""
    x32 = torch.as_tensor(X).to(torch.float32)
    raw = x32.abs().amax(dim=1) / 127.0
    scales = torch.where(raw > 0.0, raw, torch.ones_like(raw))
    codes = torch.round(x32 / scales[:, None]).clamp(-127, 127) \
        .to(torch.int8)
    return codes.contiguous(), scales.contiguous()


def dequantize_rows(codes: torch.Tensor, scales: torch.Tensor):
    """Inverse of :func:`quantize_rows` -> [N, d] float32."""
    return codes.to(torch.float32) * scales[:, None]
