"""Locality-packed graph layout (the reference's ``ann/layout.py``; CAGRA /
GGNN style).

Store the database in an order where a node's neighbours sit next to each
other, so a hop's row gathers read runs of adjacent rows.  This module is
the host-side half of that layout, in numpy:

  * :func:`locality_order` — a max-fresh-first greedy traversal: each pop
    numbers one node's still-unnumbered neighbours as ONE consecutive id
    run, and pops are ordered by how many fresh ids they can still mint;
  * :func:`apply_layout` — relabel every structure into the packed order:
    ``X[perm]`` rows, neighbour values through ``inv``, each row's lanes
    laid so consecutive-id runs start on ``span_group``-aligned lanes;
  * :func:`unpack_rows` — packed rows back to external order;
  * :func:`span_stats` — how many aligned G-lane groups of an adjacency are
    one contiguous run of rows (one copy of G rows instead of G copies).

The permutation rides on the graph (``PackedGraph.perm``, new->old) and in
the artifact (format v5).  The searches keep every externally visible
quantity (seeds, hash placements, tombstones, returned ids) in the
ORIGINAL id space, so a packed index answers as an unpacked one does.

Everything here runs once per build (the ``"layout"`` stage) on the host,
never on the serving path.
"""
from __future__ import annotations

import heapq

import numpy as np


def locality_order(neighbors: np.ndarray, *, starts=None) -> np.ndarray:
    """Max-fresh-first traversal order of the packed adjacency.

    ``neighbors`` [N, M] int with sentinel ``N`` for absent edges.  Each pop
    of a node ``u`` numbers ``u`` itself (if still unnumbered) and then
    every still-unnumbered neighbour of ``u``, in stored lane order, as one
    consecutive block of new ids.  Pops are ordered by *fresh count* (how
    many unnumbered neighbours a node still has, kept exactly through the
    reverse adjacency), largest first, so the long runs are minted before
    sibling pops fragment them; a stale heap entry is re-keyed lazily.

    ``starts`` (optional ints, e.g. the hub set) are popped first, in the
    given order; ties and leftovers resolve by smallest node id.  Returns
    ``perm`` [N] int32, new->old: packed row ``i`` holds original node
    ``perm[i]``.  The same order as the reference's, entry for entry; the
    adjacency and its reverse are built in numpy (CSR) rather than in a
    Python loop over numpy scalars.
    """
    nb = np.asarray(neighbors).astype(np.int64)
    N, M = nb.shape
    # the valid lanes of each row, first occurrence only (so a doubled lane
    # cannot decrement a count twice), in stored lane order
    keep = (nb >= 0) & (nb < N)
    for j in range(1, M):
        keep[:, j] &= ~(nb[:, :j] == nb[:, j:j + 1]).any(axis=1)
    per_row = keep.sum(axis=1)
    row_off = np.concatenate([[0], np.cumsum(per_row)]).tolist()
    tgt = nb[keep]                                  # row-major: lane order
    src = np.repeat(np.arange(N, dtype=np.int64), per_row)
    # reverse adjacency: the rows holding v, ascending (a stable sort)
    by_tgt = np.argsort(tgt, kind="stable")
    rev_off = np.concatenate(
        [[0], np.cumsum(np.bincount(tgt, minlength=N))]).tolist()
    rows, rev = tgt.tolist(), src[by_tgt].tolist()
    cnt = per_row.tolist()
    numbered = bytearray(N)
    perm: list = []

    def pop(u: int) -> None:
        fresh = []
        if not numbered[u]:
            numbered[u] = 1
            fresh.append(u)
        for v in rows[row_off[u]:row_off[u + 1]]:
            if not numbered[v]:
                numbered[v] = 1
                fresh.append(v)
        perm.extend(fresh)
        for v in fresh:
            for w in rev[rev_off[v]:rev_off[v + 1]]:
                cnt[w] -= 1

    for s in (starts if starts is not None else []):
        s = int(s)
        if 0 <= s < N:
            pop(s)
    heap = [(-c, u) for u, c in enumerate(cnt) if c > 0]
    heapq.heapify(heap)
    while heap:
        c, u = heapq.heappop(heap)
        if -c != cnt[u]:
            if cnt[u] > 0:
                heapq.heappush(heap, (-cnt[u], u))  # lazy re-key
            continue
        pop(u)
    perm.extend(u for u in range(N) if not numbered[u])  # isolated, ascending
    return np.asarray(perm, dtype=np.int32)


def inverse_permutation(perm: np.ndarray) -> np.ndarray:
    """old->new from new->old (``inv[perm[i]] == i``)."""
    perm = np.asarray(perm)
    inv = np.empty_like(perm)
    inv[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    return inv


def apply_layout(perm, X, neighbors, lambdas, degrees, hubs=None):
    """Relabel every build output into packed (new-id) order.

    Returns ``(X2, neighbors2, lambdas2, degrees2, hubs2)``:

      * ``X2[i] == X[perm[i]]`` (a row gather: the same fp32 bits);
      * ``neighbors2[i]`` is ``inv[neighbors[perm[i]]]``, its lanes laid so
        consecutive-id runs start on ``span_group``-aligned lanes (λ carried
        along, sentinel ``N`` last);
      * ``hubs2[j] == inv[hubs[j]]``: hub POSITIONS are kept, so the
        search's hub draws pick the same vectors as on the unpacked graph.

    Lane order within a row is otherwise free (the searches rank by the
    (dist, id) total order), but λ is no longer ascending along a row, so
    the λ-prefix ``gather_limit`` is refused for packed graphs.
    """
    perm = np.asarray(perm)
    X = np.asarray(X)
    nb = np.asarray(neighbors)
    lam = np.asarray(lambdas)
    N, M = nb.shape
    inv = inverse_permutation(perm)
    nb_p = nb[perm]
    valid = nb_p < N
    nb_new = np.where(valid, inv[np.clip(nb_p, 0, N - 1)], np.int32(N))
    order = _run_aligned_order(nb_new, N, span_group(M))
    neighbors2 = np.take_along_axis(nb_new, order, axis=1).astype(np.int32)
    lambdas2 = np.take_along_axis(lam[perm], order, axis=1)
    degrees2 = np.asarray(degrees)[perm]
    hubs2 = None if hubs is None \
        else inv[np.asarray(hubs)].astype(np.int32)
    return X[perm], neighbors2, lambdas2, degrees2, hubs2


def _run_aligned_order(nb_new: np.ndarray, N: int, G: int) -> np.ndarray:
    """Per-row lane order packing consecutive-id runs onto aligned groups.

    Sort each row, cut it into maximal consecutive runs, and emit each
    run's G-multiple prefix first (every such chunk then starts on an
    aligned lane and is itself consecutive), then the leftovers, then the
    sentinels.  Rows are ``M`` lanes and ``G | M`` (``span_group``), so the
    alignment holds across rows too.  Returns ``order`` [N, M] int32 lane
    indices into the source row (``take_along_axis``-ready).
    """
    M = nb_new.shape[1]
    sort_ord = np.argsort(nb_new, axis=1, kind="stable").astype(np.int32)
    if G <= 1:
        return sort_ord
    s = np.take_along_axis(nb_new, sort_ord, axis=1).astype(np.int64)
    # a lane starts a new run when it does not continue id + 1
    starts = np.ones_like(s, dtype=bool)
    starts[:, 1:] = s[:, 1:] != s[:, :-1] + 1
    starts |= s >= N                      # sentinels never join a run
    run_id = np.cumsum(starts, axis=1) - 1           # [N, M]
    # position within the run, and the run's total length, per lane
    lane = np.arange(M)
    run_start_lane = np.where(starts, lane, 0)
    run_start_lane = np.maximum.accumulate(run_start_lane, axis=1)
    pos = lane - run_start_lane
    run_len = np.zeros_like(run_id)
    np.add.at(run_len, (np.arange(s.shape[0])[:, None], run_id), 1)
    run_len = np.take_along_axis(run_len, run_id, axis=1)
    head = (pos < (run_len // G) * G) & (s < N)      # aligned-group lanes
    # stable three-way partition: head lanes (in sorted order), spill, pad
    klass = np.where(head, 0, np.where(s < N, 1, 2))
    part = np.argsort(klass, axis=1, kind="stable").astype(np.int32)
    return np.take_along_axis(sort_ord, part, axis=1)


def unpack_rows(X: np.ndarray, perm: np.ndarray, *,
                n_shards: int = 1) -> np.ndarray:
    """Packed rows back to external order: packed row ``j`` holds original
    row ``perm[j]``, so ``out[perm[j]] = X[j]``.  With ``n_shards > 1`` the
    inversion is per equal row slice (a mesh packs each shard's local ids
    on their own)."""
    X = np.asarray(X)
    perm = np.asarray(perm, np.int64)
    N = X.shape[0]
    if N % n_shards:
        raise ValueError(f"{N} rows not divisible into {n_shards} shards")
    n_local = N // n_shards
    off = (np.arange(N, dtype=np.int64) // n_local) * n_local
    out = np.empty_like(X)
    out[off + perm] = X
    return out


def span_group(C: int, *, cap: int = 8) -> int:
    """The group width for a C-lane gather: the largest power of two <=
    ``cap`` dividing C (1 = no grouping), so groups tile a row exactly."""
    g = 1
    while g * 2 <= cap and C % (g * 2) == 0:
        g *= 2
    return g


def span_stats(neighbors: np.ndarray, *, group: int | None = None) -> dict:
    """Coalescing yield of a (packed or unpacked) adjacency.

    The [*, C] index array is cut into aligned groups of ``group`` lanes
    (default :func:`span_group`); a group whose ids are one ascending
    contiguous run (``idx[c+i] == idx[c] + i``, all below N) could move as
    ONE copy of ``group`` rows, every other group as one copy a lane.
    Returns the reference's accounting: ``group``, ``n_groups``,
    ``n_coalesced``, ``dma_copies``, ``rows``, ``rows_per_copy`` and
    ``frac_coalesced``.
    """
    nb = np.asarray(neighbors)
    N, C = nb.shape
    G = span_group(C) if group is None else group
    if G <= 1 or C % G:
        total = N * C
        return {"group": 1, "n_groups": total, "n_coalesced": 0,
                "dma_copies": total, "rows": total,
                "rows_per_copy": 1.0, "frac_coalesced": 0.0}
    g3 = nb.reshape(N, C // G, G).astype(np.int64)
    expect = g3[:, :, :1] + np.arange(G, dtype=np.int64)
    contig = np.all(g3 == expect, axis=2) & np.all(g3 < N, axis=2)
    n_groups = N * (C // G)
    n_coal = int(contig.sum())
    copies = n_coal + (n_groups - n_coal) * G
    rows = n_groups * G
    return {"group": G, "n_groups": n_groups, "n_coalesced": n_coal,
            "dma_copies": copies, "rows": rows,
            "rows_per_copy": rows / copies,
            "frac_coalesced": n_coal / n_groups}
