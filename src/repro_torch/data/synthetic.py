"""Synthetic datasets with exact ground truth.

Clustered Gaussians mimic the paper's SIFT/DEEP/GIST regimes (the occlusion
phenomenon of Fig. 1 only appears with cluster structure).  The generators
draw with numpy from a seed, so both packages see identical data; ground
truth is brute force in float64, on the CPU with numpy or, with
``device=``, on that device in chunks (1M x 10240 is minutes in numpy).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class Dataset:
    X: np.ndarray        # [N, d] float32 candidates
    Q: np.ndarray        # [B, d] float32 queries
    gt: np.ndarray       # [B, k_gt] int32 true NN ids (ascending distance)
    metric: str


def make_clustered(n: int = 20000, d: int = 32, n_queries: int = 200,
                   n_clusters: int = 64, noise: float = 0.15,
                   metric: str = "l2", k_gt: int = 100,
                   seed: int = 0, device=None) -> Dataset:
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(n_clusters, d)).astype(np.float32)
    assign = rng.integers(0, n_clusters, size=n)
    X = centers[assign] + noise * rng.normal(size=(n, d)).astype(np.float32)
    qa = rng.integers(0, n_clusters, size=n_queries)
    Q = centers[qa] + noise * rng.normal(size=(n_queries, d)).astype(np.float32)
    X = X.astype(np.float32)
    Q = Q.astype(np.float32)
    if metric == "cos":
        X = X / np.maximum(np.linalg.norm(X, axis=1, keepdims=True), 1e-12)
        Q = Q / np.maximum(np.linalg.norm(Q, axis=1, keepdims=True), 1e-12)
    gt = brute_force_gt(X, Q, k_gt, metric, device=device)
    return Dataset(X=X, Q=Q, gt=gt, metric=metric)


def make_uniform(n: int = 10000, d: int = 16, n_queries: int = 100,
                 metric: str = "l2", k_gt: int = 100, seed: int = 0,
                 device=None) -> Dataset:
    rng = np.random.default_rng(seed)
    X = rng.uniform(-1, 1, size=(n, d)).astype(np.float32)
    Q = rng.uniform(-1, 1, size=(n_queries, d)).astype(np.float32)
    gt = brute_force_gt(X, Q, k_gt, metric, device=device)
    return Dataset(X=X, Q=Q, gt=gt, metric=metric)


def brute_force_gt(X, Q, k: int, metric: str, *, device=None,
                   chunk: int = 256) -> np.ndarray:
    """Exact top-``k`` ids [B, k] int32 (ascending distance), float64.

    ``device=None`` computes with numpy on the host; any torch device
    computes there in ``chunk``-query blocks (X and Q may be numpy arrays
    or tensors)."""
    if device is None:
        X = np.asarray(X)
        Q = np.asarray(Q)
        out = np.empty((Q.shape[0], k), np.int32)
        X64 = X.astype(np.float64)
        for i in range(0, Q.shape[0], chunk):
            q = Q[i:i + chunk].astype(np.float64)
            if metric in ("ip", "cos"):
                dist = -(q @ X64.T)
            else:
                dist = ((q ** 2).sum(1)[:, None] + (X64 ** 2).sum(1)[None, :]
                        - 2 * q @ X64.T)
            out[i:i + chunk] = np.argsort(dist, axis=1)[:, :k].astype(np.int32)
        return out
    X64 = torch.as_tensor(X).to(device=device, dtype=torch.float64)
    Q64 = torch.as_tensor(Q).to(device=device, dtype=torch.float64)
    xn = (X64 * X64).sum(1)
    out = torch.empty((Q64.shape[0], k), dtype=torch.int32, device=device)
    for i in range(0, Q64.shape[0], chunk):
        q = Q64[i:i + chunk]
        if metric in ("ip", "cos"):
            dist = -(q @ X64.T)
        else:
            dist = (q * q).sum(1)[:, None] + xn[None, :] - 2 * q @ X64.T
        out[i:i + chunk] = torch.topk(dist, k, dim=1, largest=False,
                                      sorted=True).indices.to(torch.int32)
    return out.cpu().numpy()


def recall_at_k(found_ids: np.ndarray, gt: np.ndarray, k: int) -> float:
    """Paper Eq. 3."""
    hits = 0
    for f, g in zip(found_ids, gt):
        hits += len(set(f[:k].tolist()) & set(g[:k].tolist()))
    return hits / (gt.shape[0] * k)
