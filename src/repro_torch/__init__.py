"""`repro_torch` — the TSDG index (build + the paper's two searches) in
PyTorch, with hand-written CUDA kernels for Hopper on the hot path.

The package stands beside the JAX reference package and imports nothing of
it (nor JAX).  Entry points run on ``cuda`` unless the caller passes
``device="cpu"``; with no GPU and no explicit ``device="cpu"`` they raise
instead of carrying on quietly on the CPU (:func:`repro_torch.device.resolve_device`).

Importing the package turns TF32 OFF for float32 matrix products and
convolutions (``torch.backends.cuda.matmul.allow_tf32`` and
``torch.backends.cudnn.allow_tf32``): every distance the reference computes
is full float32, and TF32 keeps only ~3 decimal digits.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

__all__ = ["Index"]


def __getattr__(name):
    if name == "Index":
        from repro_torch.ann.index import Index
        return Index
    raise AttributeError(f"module 'repro_torch' has no attribute {name!r}")
