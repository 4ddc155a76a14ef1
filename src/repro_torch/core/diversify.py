"""Two-stage graph diversification (the paper's §3; the reference's
``core/diversify.py``).

Stage 1 — *relaxed GD* (Eq. 2): greedy occlusion pruning of each k-NN list
with relaxation α.  Symmetrize — reverse edges of surviving lists are
appended.  Stage 2 — *soft GD*: each edge's occlusion factor λ (Eq. 1);
edges sorted per node by (λ, dist), λ > λ0 dropped, truncated to M.

The inner objects are [T, K, K] pairwise blocks of a node tile, computed by
the distance kernel in self-query mode (each row gathered once for both
sides).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core import hotpath as HP
from repro_torch.core import metrics as M
from repro_torch.core import prng
from repro_torch.core.knn_build import _dedup_by_id, reverse_neighbors

INF = HP.INF
LAM_NONE = 2 ** 30  # λ of an empty lane


def _full(like, value):
    return torch.full_like(like, value)


# --------------------------------------------------------------------------
# stage 1: relaxed GD
# --------------------------------------------------------------------------

def relaxed_gd_tile(X, nbr_ids, nbr_dists, *, alpha: float, metric: str,
                    backend: str = "auto"):
    """Greedy occlusion pruning for a tile of nodes.

    nbr_ids/nbr_dists [T, K] sorted ascending by distance -> keep [T, K]."""
    T, K = nbr_ids.shape
    N = X.shape[0]
    valid = nbr_ids < N
    pair = HP.neighbor_distances(None, X, nbr_ids, metric=metric,
                                 backend=backend, self_q=True)   # [T, K, K]

    # sign-aware α: ip/cos distances are negative, where a plain multiply
    # would make the occluder condition easier instead of harder
    def _relax(m):
        return torch.where(m >= 0, alpha * m, m / alpha)

    occ = (_relax(nbr_dists[:, :, None]) < nbr_dists[:, None, :]) \
        & (_relax(pair) < nbr_dists[:, None, :])
    keep = torch.zeros((T, K), dtype=torch.bool, device=X.device)
    keep[:, 0] = valid[:, 0]
    for j in range(1, K):
        occluded = (keep & occ[:, :, j]).any(dim=1)
        keep[:, j] = ~occluded & valid[:, j]
    return keep


def relaxed_gd(X, ids, dists, *, alpha: float, metric: str,
               tile: int = 2048, backend: str = "auto"):
    """Stage 1 over the whole graph, ``tile`` nodes at a time -> keep
    [N, K]."""
    return torch.cat([
        relaxed_gd_tile(X, ids[s:s + tile], dists[s:s + tile], alpha=alpha,
                        metric=metric, backend=backend)
        for s in range(0, ids.shape[0], tile)])


# --------------------------------------------------------------------------
# symmetrize: append reverse edges of the stage-1 graph
# --------------------------------------------------------------------------

def append_reverse(X, ids, dists, keep, *, rev_cap: int, metric: str,
                   backend: str = "auto"):
    """Undirected candidate lists: kept forward edges ++ reverse edges ->
    (adj_ids [N, K+rev_cap], adj_dists), sentinel N / INF, rows deduped and
    sorted by distance."""
    N, K = ids.shape
    fwd_ids = torch.where(keep, ids, _full(ids, N))
    fwd_d = torch.where(keep, dists, _full(dists, INF))
    rev = reverse_neighbors(fwd_ids, fwd_ids < N, cap=rev_cap)
    rd = HP.neighbor_distances(X, X, rev, metric=metric, backend=backend)
    sid, sd, dup = _dedup_by_id(torch.cat([fwd_ids, rev], dim=1),
                                torch.cat([fwd_d, rd], dim=1))
    sid = torch.where(dup, _full(sid, N), sid)
    sd = torch.where(dup, _full(sd, INF), sd)
    order = torch.argsort(sd, dim=1, stable=True)
    return sid.gather(1, order), sd.gather(1, order)


# --------------------------------------------------------------------------
# stage 2: soft GD (occlusion factors)
# --------------------------------------------------------------------------

def occlusion_factors_tile(X, nbr_ids, nbr_dists, *, metric: str,
                           backend: str = "auto"):
    """λ_j = #occluders of edge j within its node's list (Eq. 1, α = 1)."""
    N = X.shape[0]
    valid = nbr_ids < N
    pair = HP.neighbor_distances(None, X, nbr_ids, metric=metric,
                                 backend=backend, self_q=True)
    occ = (nbr_dists[:, :, None] < nbr_dists[:, None, :]) \
        & (pair < nbr_dists[:, None, :]) \
        & valid[:, :, None] & valid[:, None, :]
    lam = occ.sum(dim=1, dtype=torch.int32)
    return torch.where(valid, lam, _full(lam, LAM_NONE))


def soft_gd(X, adj_ids, adj_dists, *, lambda0: int, max_degree: int,
            metric: str, tile: int = 2048, backend: str = "auto"):
    """Stage 2: λ per edge, sort by (λ, dist), threshold λ0, truncate to M
    -> (neighbors [N, M], lambdas [N, M], degrees [N]), int32."""
    N = adj_ids.shape[0]
    lam = torch.cat([
        occlusion_factors_tile(X, adj_ids[s:s + tile], adj_dists[s:s + tile],
                               metric=metric, backend=backend)
        for s in range(0, N, tile)])
    # sort by (λ asc, dist asc) — lexsort via two stable argsorts
    order_d = torch.argsort(adj_dists, dim=1, stable=True)
    order_l = torch.argsort(lam.gather(1, order_d), dim=1, stable=True)
    order = order_d.gather(1, order_l)
    sid = adj_ids.gather(1, order)
    slam = lam.gather(1, order)
    ok = (slam <= lambda0) & (sid < N)
    sid = torch.where(ok, sid, _full(sid, N))
    slam = torch.where(ok, slam, _full(slam, LAM_NONE))
    degrees = ok[:, :max_degree].sum(dim=1, dtype=torch.int32)
    return (sid[:, :max_degree].to(torch.int32).contiguous(),
            slam[:, :max_degree].contiguous(), degrees)


# --------------------------------------------------------------------------
# packed graph + hub bridges
# --------------------------------------------------------------------------

@dataclasses.dataclass
class PackedGraph:
    """λ-sorted fixed-width adjacency (sentinel id = N), tensors on one
    device.  ``hubs`` — the bridge hub sample, also offered to the searches
    as seed candidates.  ``perm`` — the locality layout's new->old
    permutation (:mod:`repro_torch.ann.layout`): rows, neighbour ids and
    hubs are then in packed order, and the searches map ids back to the
    external order (``None`` for an unpacked graph)."""

    neighbors: torch.Tensor  # [N, M] int32
    lambdas: torch.Tensor    # [N, M] int32 (ascending per row)
    degrees: torch.Tensor    # [N] int32
    hubs: torch.Tensor | None = None   # [n_hubs] int32
    perm: torch.Tensor | None = None   # [N] int32, new->old

    @property
    def n(self) -> int:
        return self.neighbors.shape[0]

    @property
    def max_degree(self) -> int:
        return self.neighbors.shape[1]

    @property
    def device(self) -> torch.device:
        return self.neighbors.device

    def avg_degree(self) -> float:
        return float(self.degrees.float().mean())



def add_bridges(X, nbrs, lams, *, n_hubs: int, hub_k: int, metric: str,
                seed: int = 0):
    """Beyond-paper: cross-link a random hub sample with its exact hub-k-NN
    graph, splicing hub edges into the tail of each hub row with λ = 1.
    Returns (neighbors, lambdas, hubs)."""
    N, Mdeg = nbrs.shape
    dev = X.device
    key = prng.key(seed, dev)
    hubs = prng.choice(key, N, (n_hubs,))
    hl = hubs.long()
    hd = M.pairwise(X[hl], X[hl], metric)
    hd = torch.where(torch.eye(n_hubs, dtype=torch.bool, device=dev),
                     _full(hd, INF), hd)
    near_k = max(1, hub_k // 2)
    rand_k = hub_k - near_k
    hnn = torch.argsort(hd, dim=1, stable=True)[:, :near_k]   # nearest hubs
    hub_edges = hubs[hnn]
    if rand_k:  # Kleinberg-style long links make the hub graph an expander
        rnd = prng.randint(prng.fold_in(key, 7), (n_hubs, rand_k), 0, n_hubs)
        hub_edges = torch.cat([hub_edges, hubs[rnd.long()]], dim=1)
    hub_edges = torch.where(hub_edges == hubs[:, None], _full(hub_edges, N),
                            hub_edges)
    tail = torch.arange(Mdeg - hub_k, Mdeg, device=dev)
    new_nbrs = nbrs.clone()
    new_lams = lams.clone()
    new_nbrs[hl[:, None], tail[None, :]] = hub_edges
    new_lams[hl[:, None], tail[None, :]] = 1
    # restore the (λ, ·) order of each touched row
    order = torch.argsort(new_lams[hl], dim=1, stable=True)
    new_nbrs[hl] = new_nbrs[hl].gather(1, order)
    new_lams[hl] = new_lams[hl].gather(1, order)
    return new_nbrs, new_lams, hubs

