"""k-NN graph construction: exact tiled brute force + NN-expansion.

Per iteration each node scores its neighbors-of-neighbors and its reverse
neighbors with one gather-fused distance block and keeps the best ``k``
(the reference's TPU-shaped NN-Descent, ``core/knn_build.py``).  The
initial lists are the reference's ``jax.random`` draws, reproduced by
:mod:`repro_torch.core.prng`.
"""
from __future__ import annotations

import torch

from repro_torch.core import hotpath as HP
from repro_torch.core import metrics as M
from repro_torch.core import prng

INF = HP.INF


def tiled_map(fn, n: int):
    """``[fn(i) for i in range(n)]`` stacked along a new leading axis (per
    output when ``fn`` returns a tuple) — the reference's ``lax.map`` over
    tiles, run eagerly."""
    outs = [fn(i) for i in range(n)]
    if isinstance(outs[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*outs))
    return torch.stack(outs)


def exact_knn(X, k: int, metric: str = "l2", tile: int = 1024):
    """[N, d] -> (ids [N, k] int32, dists [N, k]); excludes self.  Ties go
    to the lower id, as ``lax.top_k`` breaks them."""
    N = X.shape[0]
    cols = torch.arange(N, device=X.device)
    ids, dists = [], []
    for s in range(0, N, tile):
        q = X[s:s + tile]
        dist = M.pairwise(q, X, metric)
        rows = torch.arange(s, s + q.shape[0], device=X.device)
        dist = torch.where(rows[:, None] == cols[None, :],
                           torch.full_like(dist, INF), dist)
        order = torch.argsort(dist, dim=1, stable=True)[:, :k]
        ids.append(order.to(torch.int32))
        dists.append(dist.gather(1, order))
    return torch.cat(ids), torch.cat(dists)


def reverse_neighbors(ids, valid, cap: int):
    """ids [N, K] (+valid mask) -> reverse lists [N, cap] int32 (sentinel
    N), each list in ascending source order."""
    N, K = ids.shape
    dev = ids.device
    src = torch.arange(N, dtype=torch.int32, device=dev).repeat_interleave(K)
    dst = torch.where(valid.reshape(-1), ids.reshape(-1).long(),
                      torch.full((N * K,), N, dtype=torch.long, device=dev))
    order = torch.argsort(dst, stable=True)
    sdst, ssrc = dst[order], src[order]
    counts = torch.bincount(dst, minlength=N + 1)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.arange(N * K, device=dev) - starts[sdst]
    keep = (rank < cap) & (sdst < N)
    slot = torch.where(keep, sdst * cap + rank,
                       torch.full_like(rank, N * cap))
    # the trash slot N*cap takes every dropped write and is discarded
    rev = torch.full((N * cap + 1,), N, dtype=torch.int32, device=dev)
    rev[slot] = ssrc
    return rev[:N * cap].reshape(N, cap)


def _dedup_by_id(all_ids, all_d):
    """Sort each row by id (stable) -> (ids, dists, dup) where ``dup``
    marks every repeat after an id's first lane."""
    order = torch.argsort(all_ids, dim=1, stable=True)
    sid = all_ids.gather(1, order)
    sd = all_d.gather(1, order)
    dup = torch.zeros_like(sid, dtype=torch.bool)
    dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
    return sid, sd, dup


def nn_descent(X, k: int, metric: str = "l2", iters: int = 8,
               sample: int = 8, seed: int = 0, backend: str = "auto"):
    """Approximate k-NN graph. Returns (ids [N, k] int32, dists [N, k])
    sorted ascending by (dist, id).

    Per iteration, candidates(u) = reverse(u) ++ B[B[u]][:, :sample] — one
    gather-fused distance block, merged by (dedup, top-k)."""
    N, d = X.shape
    dev = X.device
    backend = HP.resolve_backend(backend, dev)
    ar = torch.arange(N, device=dev)[:, None]
    ids = prng.randint(prng.key(seed, dev), (N, k), 0, N)
    ids = torch.where(ids == ar, (ids + 1) % N, ids)           # avoid self
    dists = HP.neighbor_distances(X, X, ids, metric=metric, backend=backend)
    dists, ids = HP.rank_merge(dists, ids, keep=k, backend=backend)
    for _ in range(iters):
        rev = reverse_neighbors(ids, ids < N, cap=k)           # [N, k]
        hop2 = ids[:, :sample][ids.clamp(0, N - 1).long()]     # [N, k, s]
        cand = torch.cat([rev, hop2.reshape(N, k * sample)], dim=1)
        cand = torch.where(cand == ar, torch.full_like(cand, N), cand)
        cdist = HP.neighbor_distances(X, X, cand, metric=metric,
                                      backend=backend)
        sid, sd, dup = _dedup_by_id(torch.cat([ids, cand], dim=1),
                                    torch.cat([dists, cdist], dim=1))
        dists, ids = HP.rank_merge(sd, sid, keep=k, mask=~dup & (sid < N),
                                   backend=backend)
    return ids, dists
