"""Large-batch NN search — paper Algorithm 2 (the reference's
``core/search_large.py``).

One best-first search per query, advanced in lock-step across the batch
with the paper's three structures: R (top-``ef`` ranking, Δ-relaxed
termination), C (expansion queue of ``m`` hashed segments with per-segment
eviction) and V (``mv`` circular visited segments, lossy by design).  The
reference's ``lax.scan`` over hops is a Python loop here with the same
``done`` masking; its seeds are the reference's ``jax.random`` draws.

Ported options: ``visited="hash"``, ``exact_visited``, ``gather_limit``,
``push_all_seeds``, ``alive``, ``codes``/``scales`` with ``rerank_mult``
and ``graph.perm`` (the locality-packed layout).
"""
from __future__ import annotations

import torch

from repro_torch.core import hotpath as HP
from repro_torch.core import prng
from repro_torch.core.search_small import (exact_rerank, packed_maps,
                                           to_external)

INF = HP.INF


def _seg_merge(d3, i3, keep: int, backend: str):
    """Per-segment eviction merge: [B, m, W] -> the ``keep`` smallest of
    each segment (one rank merge over the flattened segment rows)."""
    B, m, W = d3.shape
    dd, ii = HP.rank_merge(d3.reshape(B * m, W), i3.reshape(B * m, W),
                           keep=keep, backend=backend)
    return dd.reshape(B, m, keep), ii.reshape(B, m, keep)


def _large_batch_search(X, graph, Q, *, k: int = 10, ef: int = 64,
                        hops: int = 128, lambda_limit: int = 5,
                        metric: str = "l2", n_seeds: int = 32,
                        m_seg: int = 8, seg: int = 32, mv_seg: int = 8,
                        segv: int = 32, delta: float = 0.0, seed: int = 0,
                        seed_offset=0, push_all_seeds: bool = True,
                        gather_limit: int = 0, exact_visited: bool = False,
                        alive=None, backend: str = "auto", codes=None,
                        scales=None, rerank_mult: int = 0,
                        visited: str = "none"):
    """Returns (ids [B, k] int32, dists [B, k]).

    ``alive`` [N] bool: dead rows are dropped from the seed pool and from
    every expansion's admission, so they never enter R or C.
    ``codes``/``scales``: seeds and expansions score the int8 codes; the
    top ``max(rerank_mult, 1) * k`` of the final R are re-scored exactly
    against the fp32 X before the returned top-k.

    ``graph.perm`` (the locality layout): X, codes and the graph's ids are
    in packed (internal) order; the seeds are drawn as external ids and
    mapped in, every hash placement (C's segments, V's circular segments,
    the visited filter) keys on the external id while C, R and V store
    internal ids, ``alive`` is external, and R's ids leave as external ids
    — so a packed graph answers as the unpacked one does."""
    N, d = X.shape
    B = Q.shape[0]
    dev = X.device
    if k > ef:
        raise ValueError(f"k={k} exceeds the ranking array size ef={ef}; "
                         "raise ef or lower k")
    if visited not in ("none", "hash"):
        raise ValueError(f"visited={visited!r} must be 'none' or 'hash'")
    if visited == "hash" and exact_visited:
        raise ValueError("visited='hash' replaces the visited structures; "
                         "it cannot combine with exact_visited=True")
    backend = HP.resolve_backend(backend, dev)
    perm = graph.perm
    if perm is not None and gather_limit:
        raise ValueError(
            "packed layouts re-sort neighbor rows by id, destroying the "
            f"λ-ascending prefix gather_limit={gather_limit} relies on")
    inv, alive_int = packed_maps(perm, N, alive)

    def ext_hash(ids):  # the hash key of clamped (long) ids: external
        return ids if perm is None else perm[ids].long()

    def full(shape, value, dtype):
        return torch.full(shape, value, dtype=dtype, device=dev)

    # per-row keys: row i's seeds depend only on (seed, seed_offset + i)
    row_keys = prng.fold_in(prng.key(seed, dev),
                            torch.arange(B, device=dev) + seed_offset)
    seeds = prng.randint(row_keys, (n_seeds,), 0, N)          # [B, n_seeds]
    if perm is not None:  # the draws are external ids: map them in
        seeds = inv[seeds.long()]
    if graph.hubs is not None:
        nh = graph.hubs.shape[0]
        hub_pick = prng.randint(prng.fold_in(row_keys, 1),
                                (n_seeds // 2,), 0, nh)
        seeds[:, :n_seeds // 2] = graph.hubs[hub_pick.long()]

    nbrs_all, lams_all = graph.neighbors, graph.lambdas
    if gather_limit and gather_limit < nbrs_all.shape[1]:
        nbrs_all = nbrs_all[:, :gather_limit].contiguous()
        lams_all = lams_all[:, :gather_limit].contiguous()
    Mdeg = nbrs_all.shape[1]
    rows = torch.arange(B, device=dev)
    segs = torch.arange(m_seg, device=dev)

    # ---- init: distance + masked top-k over the deduped seeds ---------
    ss_ids = torch.sort(seeds, dim=1, stable=True).values
    dupm = torch.zeros_like(ss_ids, dtype=torch.bool)
    dupm[:, 1:] = ss_ids[:, 1:] == ss_ids[:, :-1]
    seed_keep = ~dupm if alive is None else ~dupm & alive_int[ss_ids.long()]
    X_score = X if codes is None else codes  # int8 codes when quantized
    init_d, sids = HP.seed_select(Q, X_score, ss_ids, metric=metric,
                                  k=n_seeds, mask=seed_keep, backend=backend,
                                  scales=scales)
    if not push_all_seeds:  # keep only the best seed (paper: R = C = {u})
        init_d = init_d.clone()
        init_d[:, 1:] = INF
    init_ok = init_d < INF
    init_ids = torch.where(init_ok, sids, torch.full_like(sids, N))

    R_ids = full((B, ef), N, torch.int32)
    R_d = full((B, ef), INF, torch.float32)
    n_init = min(ef, n_seeds)
    R_ids[:, :n_init] = init_ids[:, :n_init]
    R_d[:, :n_init] = init_d[:, :n_init]
    # C: hashed-segment batch insert of the seeds (keyed on external ids,
    # so packed and unpacked graphs fill the same segments)
    seg_of = ext_hash(init_ids.long().clamp(0, N - 1)) % m_seg
    smask = init_ok[:, None, :] & (seg_of[:, None, :] == segs[None, :, None])
    C_d, C_ids = _seg_merge(
        torch.cat([full((B, m_seg, seg), INF, torch.float32),
                   torch.where(smask, init_d[:, None, :], INF)], dim=2),
        torch.cat([full((B, m_seg, seg), N, torch.int32),
                   torch.where(smask, init_ids[:, None, :], N)], dim=2),
        seg, backend)
    V_ptr = None
    if visited == "hash":
        # the hash set subsumes V and the per-hop C/R membership scans;
        # seeds go in up front (they are already in R and C)
        V, _ = HP.visited_filter(
            HP.visited_table(B, n_seeds + hops * Mdeg, device=dev),
            to_external(perm, init_ids, N), valid=init_ok, backend=backend)
    elif exact_visited:
        # exact per-query byte table; marks are monotone, so a masked set
        # of 1s equals the reference's scatter-max
        V = torch.zeros((B, N), dtype=torch.uint8, device=dev)
        V.scatter_reduce_(1, init_ids.long().clamp(0, N - 1),
                          init_ok.to(torch.uint8), reduce="amax")
    else:
        V = full((B, mv_seg, segv), N, torch.int32)
        V_ptr = torch.zeros((B, mv_seg), dtype=torch.int32, device=dev)

    tril = torch.tril(torch.ones((Mdeg, Mdeg), dtype=torch.bool, device=dev),
                      diagonal=-1)
    done = torch.zeros((B,), dtype=torch.bool, device=dev)

    for _ in range(hops):
        # ---- pop the global min of C ----------------------------------
        flat_d = C_d.reshape(B, -1)
        flat_i = C_ids.reshape(B, -1)
        pidx = torch.argmin(flat_d, dim=1)
        u_d = flat_d[rows, pidx]
        u = flat_i[rows, pidx]
        empty = u_d >= INF
        # scatter_ takes its fill as a launch argument; an index_put of a
        # Python number copies it from the host, which capture refuses
        C_d2 = flat_d.clone().scatter_(1, pidx[:, None], INF)
        C_ids2 = flat_i.clone().scatter_(1, pidx[:, None], N)
        C_d2 = C_d2.reshape(B, m_seg, seg)
        C_ids2 = C_ids2.reshape(B, m_seg, seg)

        # ---- Δ-relaxed termination (only once R is full) --------------
        r_full = R_d[:, ef - 1] < INF
        worst = torch.where(r_full, R_d[:, ef - 1], INF)
        now_done = done | empty | (r_full & (u_d > worst + delta))
        u_safe = u.long().clamp(0, N - 1)

        # ---- neighbors of u, λ-prefix masked --------------------------
        e = nbrs_all[u_safe]                                  # [B, M]
        ok = (lams_all[u_safe] < lambda_limit) & (e < N) & ~now_done[:, None]
        e_safe = e.clamp(0, N - 1)
        el = e_safe.long()
        eh = ext_hash(el)
        if alive is not None:  # tombstoned neighbours never enter R or C
            ok = ok & alive_int[el]
        # repeats within this neighbor list keep their first occurrence
        dup_here = ((e_safe[:, :, None] == e_safe[:, None, :])
                    & tril[None]).any(dim=2)

        if visited == "hash":
            V, new = HP.visited_filter(V, to_external(perm, e, N), valid=ok,
                                       backend=backend)
        elif exact_visited:
            in_any = V.gather(1, el) == 1
            new = ok & ~in_any & ~dup_here
            V.scatter_reduce_(1, el, new.to(torch.uint8), reduce="amax")
        else:
            # ---- V.add(u) (circular segment insert) -------------------
            vs = ext_hash(u_safe) % mv_seg
            slot = V_ptr[rows, vs].long() % segv
            live = ~now_done  # updated in place: the old V is not reused
            # one slot a row, rewritten with itself where the row is done:
            # no boolean indexing, so no host sync (capturable)
            V[rows, vs, slot] = torch.where(live, u_safe.to(torch.int32),
                                            V[rows, vs, slot])
            V_ptr[rows, vs] += live.to(torch.int32)
            # membership tests: e not in V, C, R (paper line 15)
            in_V = (V[rows[:, None], eh % mv_seg] == e_safe[:, :, None]) \
                .any(dim=2)
            c_seg = eh % m_seg
            in_C = ((C_ids2[rows[:, None], c_seg] == e_safe[:, :, None])
                    & (C_d2[rows[:, None], c_seg] < INF)).any(dim=2)
            in_R = ((R_ids[:, None, :] == e_safe[:, :, None])
                    & (R_d[:, None, :] < INF)).any(dim=2)
            new = ok & ~in_V & ~in_C & ~in_R & ~dup_here

        # ---- distances for the new candidates: one fused block ---------
        ed = HP.neighbor_distances(Q, X_score, e_safe, metric=metric,
                                   mask=new, backend=backend, scales=scales)
        admit = (ed < worst[:, None]) | ~r_full[:, None]   # paper line 17
        ed = torch.where(admit, ed, INF)
        e_in = ed < INF

        # ---- push into R: merge candidates, keep ef smallest ------------
        R_d3, R_ids3 = HP.rank_merge(
            torch.cat([R_d, ed], dim=1),
            torch.cat([R_ids, torch.where(e_in, e, N)], dim=1), keep=ef,
            backend=backend)

        # ---- push into C: per-segment insert, evict most distant --------
        cand_mask = e_in[:, None, :] \
            & ((eh % m_seg)[:, None, :] == segs[None, :, None])
        C_d3, C_ids3 = _seg_merge(
            torch.cat([C_d2, torch.where(cand_mask, ed[:, None, :], INF)],
                      dim=2),
            torch.cat([C_ids2, torch.where(cand_mask, e[:, None, :], N)],
                      dim=2), seg, backend)

        R_d = torch.where(now_done[:, None], R_d, R_d3)
        R_ids = torch.where(now_done[:, None], R_ids, R_ids3)
        C_d = torch.where(now_done[:, None, None], C_d, C_d3)
        C_ids = torch.where(now_done[:, None, None], C_ids, C_ids3)
        done = now_done

    if codes is None:
        return to_external(perm, R_ids[:, :k], N).to(torch.int32), R_d[:, :k]
    # R is (dist, id)-sorted and id-deduped: a prefix is the top pool.  Its
    # internal ids index the packed fp32 rows; the last merge ranks the
    # external ids, so its ties fall as on an unpacked graph
    rerank = min(max(rerank_mult, 1) * k, ef)
    rr_ids = R_ids[:, :rerank]
    out_d, out_ids = exact_rerank(Q, X, R_d[:, :rerank], rr_ids, k=k,
                                  metric=metric, backend=backend,
                                  out_ids=to_external(perm, rr_ids, N))
    return out_ids.to(torch.int32), out_d
