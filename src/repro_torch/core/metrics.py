"""Distance metrics for the ANN core (paper Table 1: L2 / Cosine / IP).

Smaller = closer, uniformly: inner-product and cosine are negated so a single
ascending comparison serves all three (the paper's footnote 1 convention).
"""
from __future__ import annotations

import torch


def preprocess(X: torch.Tensor, metric: str) -> torch.Tensor:
    """Dataset-side preprocessing (cosine -> unit norm)."""
    if metric == "cos":
        return X / torch.clamp(torch.linalg.norm(X, dim=-1, keepdim=True),
                               min=1e-12)
    return X


def pairwise(Q: torch.Tensor, X: torch.Tensor, metric: str) -> torch.Tensor:
    """[B, d] x [N, d] -> [B, N] (smaller = closer)."""
    dots = Q @ X.T
    if metric in ("ip", "cos"):
        return -dots
    # squared L2 via the Gram trick (one GEMM)
    qn = torch.sum(Q * Q, dim=-1, keepdim=True)
    xn = torch.sum(X * X, dim=-1)
    return qn + xn[None, :] - 2.0 * dots


def batched_rowwise(Q: torch.Tensor, V: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """Q [S, d] against per-row candidate vecs V [S, C, d] -> [S, C]."""
    dots = torch.einsum("scd,sd->sc", V, Q)
    if metric in ("ip", "cos"):
        return -dots
    qn = torch.sum(Q * Q, dim=-1)[:, None]
    vn = torch.sum(V * V, dim=-1)
    return qn + vn - 2.0 * dots


def point_pairs(A: torch.Tensor, B: torch.Tensor, metric: str) -> torch.Tensor:
    """Rowwise distance between A [.., d] and B [.., d] -> [..]."""
    dots = torch.sum(A * B, dim=-1)
    if metric in ("ip", "cos"):
        return -dots
    return torch.sum(torch.square(A - B), dim=-1)
