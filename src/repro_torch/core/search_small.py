"""Small-batch NN search — paper Algorithm 1 (the reference's
``core/search_small.py``).

Per query, ``t0`` independent cheap greedy searches advance in lock-step;
each hop gathers the current node's λ-prefix neighbors, scores them with
one gather-fused distance block, forms the lane-paired R_temp, half-merges
it into R_ij, and moves to R_temp's best.  The reference's ``lax.scan``
over hops is a Python loop here with the same ``active`` masking, and its
random seeds are the same ``jax.random`` draws (:mod:`repro_torch.core.prng`),
so the two packages run the same searches.

Ported options: ``exact_merge``, ``visited="hash"``, the ``t0_offset``/
``t0_total`` population placement, ``alive`` (the streaming tombstone mask),
``codes``/``scales`` with ``rerank_mult`` (int8 residency with an exact
fp32 re-rank) and ``graph.perm`` (the locality-packed layout).
"""
from __future__ import annotations

import torch

from repro_torch.core import hotpath as HP
from repro_torch.core import prng

INF = HP.INF


def packed_maps(perm, N: int, alive):
    """(inv, alive_int) of a packed graph: ``inv`` [N] int32 old->new,
    scattered on the device at each call, and the tombstone mask in packed
    order.  ``(None, alive)`` for an unpacked graph."""
    if perm is None:
        return None, alive
    p = perm.long()
    inv = torch.zeros((N,), dtype=torch.int32, device=perm.device) \
        .scatter_(0, p, torch.arange(N, dtype=torch.int32,
                                      device=perm.device))
    return inv, None if alive is None else alive[p]


def to_external(perm, ids, N: int):
    """Packed (internal) ids -> external ids; sentinels (>= N) stay."""
    if perm is None:
        return ids
    return torch.where(ids < N, perm[ids.long().clamp(0, N - 1)], ids)


def exact_rerank(Q, X, d, ids, *, k: int, metric: str, backend: str,
                 out_ids=None):
    """Re-score the approximate survivors ``ids`` [B, r] exactly against
    the fp32 rows and keep the best k.  Lanes whose approximate distance
    ``d`` is INF (masked by the merge) stay masked through the re-score.
    ``out_ids`` (default ``ids``) are the ids the merge ranks and returns:
    a packed graph's external ids for its internal rows."""
    ed = HP.neighbor_distances(Q, X, ids, metric=metric, mask=d < INF,
                               backend=backend)
    return HP.rank_merge(ed, ids if out_ids is None else out_ids, keep=k,
                         backend=backend)


def _pad_cols(t, width: int, value):
    if t.shape[1] >= width:
        return t
    pad = torch.full((t.shape[0], width - t.shape[1]), value, dtype=t.dtype,
                     device=t.device)
    return torch.cat([t, pad], dim=1)


def lexsort_id_dist(ids, dists):
    """Row order ascending by (id, dist) — ``jnp.lexsort((dists, ids))`` —
    from two stable sorts (the dist key maps -0.0 onto +0.0 as lexsort's
    comparator does)."""
    key = torch.where(dists == 0, torch.zeros_like(dists), dists)
    o1 = torch.argsort(key, dim=1, stable=True)
    o2 = torch.argsort(ids.gather(1, o1), dim=1, stable=True)
    return o1.gather(1, o2)


def _small_batch_search(X, graph, Q, *, k: int = 10, t0: int = 32,
                        hops: int = 6, hop_width: int = 32,
                        n_seeds: int = 32, lambda_limit: int = 10,
                        metric: str = "l2", exact_merge: bool = False,
                        width: int = 32, seed: int = 0, seed_offset=0,
                        t0_offset=0, t0_total: int | None = None,
                        alive=None, backend: str = "auto", codes=None,
                        scales=None, rerank_mult: int = 0,
                        visited: str = "none"):
    """Returns (ids [B, k] int32, dists [B, k]).

    ``alive`` [N] bool (streaming tombstones): dead rows are excluded from
    seed selection, from every hop's neighbour evaluation and from the
    final merge.  ``codes`` [N, d] int8 + ``scales`` [N] (int8 residency):
    seeds and hops score the codes; the final merge keeps the best
    ``max(rerank_mult, 1) * k`` distinct survivors and re-scores them
    exactly against the fp32 X before the top-k.

    ``graph.perm`` (the locality layout): X, codes and the graph's ids are
    in packed (internal) order, but everything seen from outside stays in
    the ORIGINAL ids — the random seeds are drawn externally and mapped in,
    ``alive`` is external, the visited filter hashes external ids, and the
    candidates are mapped back before the final (id, dist) dedup — so a
    packed graph answers as the unpacked one does.  The hops' merges order
    ties by internal id; the final merges by external id."""
    N, d = X.shape
    B = Q.shape[0]
    S = B * t0
    dev = X.device
    if k > t0 * width:
        raise ValueError(
            f"k={k} exceeds the candidate pool t0*width={t0 * width}; "
            "raise t0/width or lower k")
    if visited not in ("none", "hash"):
        raise ValueError(f"visited={visited!r} must be 'none' or 'hash'")
    backend = HP.resolve_backend(backend, dev)
    perm = graph.perm
    inv, alive_int = packed_maps(perm, N, alive)
    half = width // 2
    key = prng.fold_in(prng.key(seed, dev), seed_offset)
    t0_total = t0 if t0_total is None else t0_total
    flat = torch.arange(S, device=dev)
    row_ids = (flat // t0) * t0_total + t0_offset + flat % t0
    row_keys = prng.fold_in(key, row_ids)                     # [S, 2]
    Qs = Q[:, None, :].expand(B, t0, d).reshape(S, d)        # [S, d]

    # --- seeds: best of n_seeds randoms, half from the hubs when bridged --
    seeds = prng.randint(row_keys, (n_seeds,), 0, N)          # [S, n_seeds]
    if perm is not None:  # the draws are external ids: map them in
        seeds = inv[seeds.long()]
    if graph.hubs is not None:
        nh = graph.hubs.shape[0]
        hub_pick = prng.randint(prng.fold_in(row_keys, 1),
                                (n_seeds // 2,), 0, nh)
        # hubs hold internal ids at the same positions packed or not
        seeds[:, :n_seeds // 2] = graph.hubs[hub_pick.long()]
    seed_mask = None if alive is None else alive_int[seeds.long()]
    X_score = X if codes is None else codes  # int8 codes when quantized
    sd1, si1 = HP.seed_select(Qs, X_score, seeds, metric=metric, k=1,
                              mask=seed_mask, backend=backend, scales=scales)
    u, u_d = si1[:, 0], sd1[:, 0]

    rij_ids = torch.full((S, width), N, dtype=torch.int32, device=dev)
    rij_d = torch.full((S, width), INF, dtype=torch.float32, device=dev)
    rij_ids[:, 0] = u
    rij_d[:, 0] = u_d

    nbrs_all, lams_all = graph.neighbors, graph.lambdas
    M_deg = nbrs_all.shape[1]
    n_chunks = max(1, -(-M_deg // hop_width))
    if perm is not None and n_chunks > 1:
        raise ValueError(
            f"packed layout requires hop_width >= max_degree (got "
            f"{hop_width} < {M_deg}): the chunked R_temp argmin pairs "
            "lanes positionally, which is only permutation-equivariant "
            "when a hop is a single chunk")
    tril_w = torch.tril(torch.ones((width, width), dtype=torch.bool,
                                   device=dev), diagonal=-1)
    if visited == "hash":
        # <= M_deg fresh inserts per hop + the start node, per search row
        vtab = HP.visited_table(S, hops * M_deg + 1, device=dev)
        vtab, _ = HP.visited_filter(vtab, to_external(perm, u, N)[:, None],
                                    valid=(u < N)[:, None], backend=backend)
    active = torch.ones((S,), dtype=torch.bool, device=dev)

    for _ in range(hops):
        ui = u.long().clamp(max=N - 1)  # the reference's clamped gather
        nbrs = nbrs_all[ui]                                   # [S, M]
        visit = lams_all[ui] < lambda_limit  # idx >= N masked by the primitive
        if alive is not None:  # tombstoned neighbours never enter a ranking
            visit = visit & alive_int[nbrs.long().clamp(0, N - 1)]
        if visited == "hash":
            # already-seen ids drop to (INF, N) before scoring; keyed on
            # external ids, so the drops do not depend on the layout
            vtab, fresh = HP.visited_filter(
                vtab, to_external(perm, nbrs, N),
                valid=visit & (nbrs < N) & active[:, None], backend=backend)
            visit = fresh
            nbrs = torch.where(fresh, nbrs, torch.full_like(nbrs, N))
        dists = HP.neighbor_distances(Qs, X_score, nbrs, metric=metric,
                                      mask=visit, backend=backend,
                                      scales=scales)
        dists = _pad_cols(dists, n_chunks * hop_width, INF)
        nbrs = _pad_cols(nbrs, n_chunks * hop_width, N)

        # R_temp: lane-paired min across chunks of `hop_width`
        cd = dists.reshape(S, n_chunks, hop_width)
        ci = nbrs.reshape(S, n_chunks, hop_width)
        lane_arg = torch.argmin(cd, dim=1, keepdim=True)      # first min
        rt_d = _pad_cols(cd.gather(1, lane_arg)[:, 0], width, INF)
        rt_ids = _pad_cols(ci.gather(1, lane_arg)[:, 0], width, N)
        rt_d_s, rt_ids_s = HP.rank_merge(rt_d, rt_ids, keep=width,
                                         backend=backend)
        if visited == "hash":
            # the filter already makes R_temp's ids distinct and absent
            # from R_ij, so the dedup scans collapse into plain merges
            if exact_merge:
                new_d, new_ids = HP.rank_merge(
                    torch.cat([rij_d, rt_d_s], dim=1),
                    torch.cat([rij_ids, rt_ids_s], dim=1), keep=width,
                    backend=backend)
                improved = (new_d < rij_d).any(dim=1)
            else:
                improved = (rt_d_s[:, :half] < rij_d[:, half:]).any(dim=1)
                new_d, new_ids = HP.rank_merge(
                    torch.cat([rij_d[:, :half], rt_d_s[:, :half]], dim=1),
                    torch.cat([rij_ids[:, :half], rt_ids_s[:, :half]],
                              dim=1), keep=width, backend=backend)
        else:
            # dedup R_temp by id: the (dist, id) order puts each id's best
            # copy first; later copies become (INF, N) sentinels
            dup_rt = ((rt_ids_s[:, :, None] == rt_ids_s[:, None, :])
                      & tril_w[None]).any(dim=2) & (rt_ids_s < N)
            if exact_merge:
                in_rij = ((rt_ids_s[:, :, None] == rij_ids[:, None, :])
                          & (rij_d[:, None, :] < INF)).any(dim=2)
                drop = dup_rt | in_rij
                new_d, new_ids = HP.rank_merge(
                    torch.cat([rij_d, rt_d_s.masked_fill(drop, INF)], dim=1),
                    torch.cat([rij_ids, rt_ids_s.masked_fill(drop, N)],
                              dim=1), keep=width, backend=backend)
                improved = (new_d < rij_d).any(dim=1)
            else:
                # paper: best half of R_temp replaces the worst half of
                # R_ij, after dropping ids already in the kept half
                in_keep = ((rt_ids_s[:, :, None] == rij_ids[:, None, :half])
                           & (rij_d[:, None, :half] < INF)).any(dim=2)
                drop = dup_rt | in_keep
                rt_u_d, rt_u_i = HP.rank_merge(
                    rt_d_s.masked_fill(drop, INF),
                    rt_ids_s.masked_fill(drop, N), keep=width,
                    backend=backend)
                improved = (rt_u_d[:, :half] < rij_d[:, half:]).any(dim=1)
                new_d, new_ids = HP.rank_merge(
                    torch.cat([rij_d[:, :half], rt_u_d[:, :half]], dim=1),
                    torch.cat([rij_ids[:, :half], rt_u_i[:, :half]], dim=1),
                    keep=width, backend=backend)
        new_u = rt_ids_s[:, 0]                                # closest in R_temp
        # frozen searches keep their state
        rij_d = torch.where(active[:, None], new_d, rij_d)
        rij_ids = torch.where(active[:, None], new_ids, rij_ids)
        u = torch.where(active, new_u, u)
        active = active & improved

    # --- merge the t0 searches of each query (dedup keeps each id's best) -
    # external ids before the (id, dist) sort, so the copy that survives
    # the dedup is the one an unpacked graph keeps
    cand_ids = to_external(perm, rij_ids.reshape(B, t0 * width), N)
    cand_d = rij_d.reshape(B, t0 * width)
    o = lexsort_id_dist(cand_ids, cand_d)
    sid = cand_ids.gather(1, o)
    sd2 = cand_d.gather(1, o)
    dup = torch.zeros_like(sid, dtype=torch.bool)
    dup[:, 1:] = sid[:, 1:] == sid[:, :-1]
    keep_lane = ~dup & (sid < N)
    if alive is not None:  # a dead best-seed id can linger in slot 0
        keep_lane = keep_lane & alive[sid.long().clamp(0, N - 1)]
    if codes is None:
        out_d, out_ids = HP.rank_merge(sd2, sid, keep=k, mask=keep_lane,
                                       backend=backend)
        return out_ids.to(torch.int32), out_d
    rerank = min(max(rerank_mult, 1) * k, sd2.shape[1])
    rr_d, rr_ids = HP.rank_merge(sd2, sid, keep=rerank, mask=keep_lane,
                                 backend=backend)
    # rr_ids are external; the packed fp32 rows take internal ids
    gi = rr_ids if perm is None else torch.where(
        rr_ids < N, inv[rr_ids.long().clamp(0, N - 1)], rr_ids)
    out_d, out_ids = exact_rerank(Q, X, rr_d, gi, k=k, metric=metric,
                                  backend=backend, out_ids=rr_ids)
    return out_ids.to(torch.int32), out_d
