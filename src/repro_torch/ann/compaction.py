"""Compaction: fold streamed mutations into a fresh index generation (the
reference's ``ann/compaction.py``).

:func:`compact` re-runs the staged build over the *effective corpus* —
live base rows, then live delta rows — and swaps the new generation into
the plane.  The build is the one a fresh ``Index.build`` runs, on the same
array shapes, so searches after a compaction answer as a cold build over
the same vectors does.  A new generation of the same shapes is copied into
the plane's buffers, so every captured CUDA graph keeps serving; one of
new shapes gets new buffers, and the engine drops the entries bound to the
old ones.  Compaction densifies ids: the returned ``id_map``
(int64 [n_base + n_delta_slots], old global id -> new id, -1 for deleted
rows) is the caller's bridge for external id bookkeeping.  On a packed
index the rows are un-permuted to external order first, and the rebuild
runs the config's pipeline, ``"layout"`` included, so the new generation
is packed again.  A mesh plane rebuilds its shard-local sub-indexes over
the effective corpus (``MeshPlane.rebind``), which must then split evenly
over its DB shards; a pod's ranks compact together, each rebuilding its
own shards over the gathered corpus.
"""
from __future__ import annotations

import numpy as np

from repro_torch.ann.pipeline import build_graph


def effective_corpus(stream, base_X: np.ndarray):
    """(X_eff, id_map) for a mutation log over ``base_X``: ``X_eff
    [n_active, d]`` is the live base rows (original order) followed by the
    live delta rows (slot order); ``id_map [n_total] int64`` maps every old
    global id to its row in X_eff, -1 where tombstoned."""
    base_X = np.asarray(base_X, np.float32)
    n_base = stream.n_base
    count = stream.delta.count
    base_alive = stream.base_alive
    delta_alive = stream.delta.alive[:count]
    parts = [base_X[base_alive]]
    if count:
        parts.append(stream.delta.X[:count][delta_alive])
    X_eff = np.concatenate(parts, axis=0) if len(parts) > 1 else parts[0]
    id_map = np.full((n_base + count,), -1, np.int64)
    id_map[:n_base][base_alive] = np.arange(int(base_alive.sum()))
    if count:
        id_map[n_base:][delta_alive] = int(base_alive.sum()) \
            + np.arange(int(delta_alive.sum()))
    return X_eff, id_map


def compact(engine, *, tile: int = 2048) -> np.ndarray:
    """Rebuild ``engine``'s index over its effective corpus and swap the
    new generation in; returns the old->new ``id_map``.  A clean index (no
    mutation since the last generation) is a no-op returning the identity
    map."""
    with engine.lock:
        stream = engine.stream
        plane = engine.plane
        if stream is None or not stream.dirty:
            engine.stream = None
            plane.clear_stream()
            return np.arange(plane.n_rows, dtype=np.int64)
        if stream.n_active() == 0:
            raise ValueError(
                "cannot compact to an empty index: every row is "
                "tombstoned; add vectors or rebuild")
        # the base rows in external order (a pod gathers every rank's):
        # the mutation log and id_map speak external ids
        X_eff, id_map = effective_corpus(stream, plane.host_rows())
        shards = getattr(plane, "n_db_shards", None)
        if shards is not None:
            if X_eff.shape[0] % shards:
                raise ValueError(
                    f"effective corpus has {X_eff.shape[0]} rows, not "
                    f"divisible over {shards} DB shards; add/delete "
                    "vectors to a multiple or compact on a single plane")
            # the shard build a fresh mesh (or pod) plane runs
            plane.rebind(X_eff)
        else:
            graph = build_graph(X_eff, engine.cfg, tile=tile,
                                device=plane.device)
            plane.rebind(X_eff, graph)
        engine.stream = None
        engine._prune_stale_entries()
        engine.stats.compactions += 1
        engine.stats.generation += 1
        return id_map
