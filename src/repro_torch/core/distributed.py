"""The cross-pool dedup-top-k merge (the reference's
``core/distributed.py::merge_topk``).  The mesh search around it is a
later slice; on one device the merge fuses the base graph's results with
the streaming delta shard's scan.

Here ``PAD_ID`` is -1, as in the reference's merge (the search primitives'
pad id is 2**31 - 1, ``hotpath.PAD_ID``).
"""
from __future__ import annotations

import torch

from repro_torch.core.hotpath import INF
from repro_torch.core.search_small import lexsort_id_dist

PAD_ID = -1


def merge_topk(all_ids, all_d, k: int):
    """Dedup-top-k merge of candidate pools.

    ``all_ids`` [B, n_cand] int32 global ids, any negative id invalid;
    ``all_d`` [B, n_cand] their distances.  The same id may surface from
    several pools: it keeps one slot, its best copy.  Returns (ids [B, k],
    dists [B, k]) ascending by (dist, position in the (id, dist) order);
    rows with fewer than k distinct valid candidates pad with
    (PAD_ID, INF).  The top-k is a stable sort, so ties keep the lower
    position, as ``jax.lax.top_k`` does."""
    if k <= 0:
        raise ValueError(f"k must be >= 1, got {k}")
    B, W = all_ids.shape
    all_ids = all_ids.to(torch.int32)
    if k > W:  # fewer candidates than k: pad the pool
        all_ids = torch.cat([all_ids, all_ids.new_full((B, k - W), PAD_ID)],
                            dim=1)
        all_d = torch.cat([all_d, all_d.new_full((B, k - W), INF)], dim=1)
    # (id, dist) order, so the dedup keeps the best copy of each id
    o = lexsort_id_dist(all_ids, all_d)
    sid = all_ids.gather(1, o)
    sd = all_d.gather(1, o)
    dup = torch.zeros_like(sid, dtype=torch.bool)
    dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
    sd = torch.where(dup | (sid < 0), torch.full_like(sd, INF), sd)
    key = torch.where(sd == 0, torch.zeros_like(sd), sd)
    pos = torch.argsort(key, dim=1, stable=True)[:, :k]
    out_d = sd.gather(1, pos)
    out_ids = sid.gather(1, pos)
    return torch.where(out_d < INF, out_ids,
                       torch.full_like(out_ids, PAD_ID)), out_d
