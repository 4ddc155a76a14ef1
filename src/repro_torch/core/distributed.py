"""Distributed TSDG over a shard grid (the reference's
``core/distributed.py``): a sharded index build, the 2-D parallel search
and the cross-shard dedup-top-k merge.

The database (vectors + packed graph) is cut into equal row slices over the
grid's ``data`` axis (and ``pod``, when the grid has one); each slice owns
an independent TSDG sub-index over its rows, built with no cross-shard
traffic.  Queries are split over the ``model`` axis.  A query visits every
DB shard's sub-index, and the per-shard top-k are merged in shard-major
order, exactly as the reference's ``all_gather`` lays them out.

**One process, one device.**  The reference's grid is a JAX device mesh
driven by one controller through ``shard_map``.  Here a :class:`Mesh` is a
*logical* grid on one torch device: every (DB shard, query column) cell is
a search over views of the concatenated row-sharded operands, run one
after another on the device's stream.  The operands are laid out as the
reference lays them out (the concatenation of the shard-local results), so
an artifact moves between the packages unchanged, and the search stays
capturable into one CUDA graph.  A grid across processes (one a card)
is the pod's (:mod:`repro_torch.serve.pod`): each rank runs its shards'
cells, and the pools are gathered before the same merge.

Determinism contract (the reference's): every search row is seeded by its
GLOBAL index — the large regime passes each query column's row offset as
``seed_offset``, the small regime places each column's slice of the t0
population with ``t0_offset``/``t0_total``.  On a grid with one DB shard
the columns' searches are therefore exactly the single-device searches,
and the merged answers equal the single-device plane's bit for bit.

``PAD_ID`` is -1 here, as in the reference's merge (the search
primitives' pad id is 2**31 - 1, ``hotpath.PAD_ID``).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import hotpath as HP
from repro_torch.core.diversify import PackedGraph
from repro_torch.core.search_large import _large_batch_search
from repro_torch.core.search_small import (_small_batch_search,
                                           lexsort_id_dist)
from repro_torch.device import resolve_device

PAD_ID = -1
INF = HP.INF


# --------------------------------------------------------------------------
# the grid
# --------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Mesh:
    """A logical grid of shards on one device: ``axis_names`` (``data``
    and optionally ``pod`` cut the database, ``model`` the queries) with
    their ``shape``."""

    axis_names: tuple
    shape: tuple
    device: torch.device


def make_mesh(shape, axis_names, device=None) -> Mesh:
    """A :class:`Mesh` of ``shape`` over ``axis_names`` on ``device``
    (``None``: the CUDA device, through ``resolve_device``)."""
    shape = tuple(int(s) for s in shape)
    axis_names = tuple(str(a) for a in axis_names)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} and axis names {axis_names} "
                         "differ in length")
    if len(set(axis_names)) != len(axis_names):
        raise ValueError(f"duplicate mesh axis names {axis_names}")
    if any(s < 1 for s in shape):
        raise ValueError(f"mesh axis sizes must be >= 1, got {shape}")
    return Mesh(axis_names, shape, resolve_device(device))


def db_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def query_axes(mesh: Mesh) -> tuple:
    return tuple(a for a in ("model",) if a in mesh.axis_names)


def axis_sizes(mesh: Mesh) -> dict:
    return dict(zip(mesh.axis_names, mesh.shape))


def n_db_shards(mesh: Mesh) -> int:
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in db_axes(mesh)], dtype=np.int64))


def n_query_shards(mesh: Mesh) -> int:
    sizes = axis_sizes(mesh)
    return int(np.prod([sizes[a] for a in query_axes(mesh)],
                       dtype=np.int64))


def rows_per_shard(n: int, shards: int) -> int:
    if n % shards:
        raise ValueError(f"{n} rows do not split evenly into {shards} DB "
                         "shards (the shard grid cuts equal row slices)")
    return n // shards


# --------------------------------------------------------------------------
# build
# --------------------------------------------------------------------------

def make_build_fn(mesh: Mesh, cfg):
    """The sharded build: ``build(X, *, timings=None) -> (neighbors,
    lambdas, degrees, hubs)``, each the concatenation of the shards'
    results, with shard-LOCAL ids.  Each DB shard runs ``build_graph`` on
    its equal row slice.

    The "layout" stage is stripped from the pipeline, as the reference
    strips it (its traced shard build cannot run the host BFS); the mesh
    plane packs each shard afterwards (``MeshPlane._host_layout``).
    ``timings`` (a list) receives one dict of stage seconds per shard."""
    from repro_torch.ann.pipeline import build_graph

    pipeline = tuple(getattr(cfg, "build_pipeline", ()) or ())
    if "layout" in pipeline:
        cfg = dataclasses.replace(
            cfg, build_pipeline=tuple(p for p in pipeline if p != "layout"))
    shards = n_db_shards(mesh)

    def build(X, *, timings: list | None = None):
        X = torch.as_tensor(X).to(device=mesh.device,
                                  dtype=torch.float32).contiguous()
        n_local = rows_per_shard(X.shape[0], shards)
        parts = []
        for i in range(shards):
            t = {} if timings is not None else None
            g = build_graph(X[i * n_local:(i + 1) * n_local], cfg,
                            device=mesh.device, timings=t)
            if timings is not None:
                timings.append(t)
            hubs = g.hubs if g.hubs is not None else torch.zeros(
                (0,), dtype=torch.int32, device=mesh.device)
            parts.append((g.neighbors, g.lambdas, g.degrees, hubs))
        return tuple(torch.cat(p) for p in zip(*parts))

    return build


# --------------------------------------------------------------------------
# merges
# --------------------------------------------------------------------------

def merge_topk(all_ids, all_d, k: int):
    """Dedup-top-k merge of candidate pools.

    ``all_ids`` [B, n_cand] int32 global ids, any negative id invalid;
    ``all_d`` [B, n_cand] their distances.  The same id may surface from
    several pools: it keeps one slot, its best copy.  Returns (ids [B, k],
    dists [B, k]) ascending by (dist, position in the (id, dist) order);
    rows with fewer than k distinct valid candidates pad with
    (PAD_ID, INF).  The top-k is a stable sort, so ties keep the lower
    position, as ``jax.lax.top_k`` does.  Every step is row-wise."""
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


def _pool_merge(ids, dists, offsets, n_rows, k: int):
    """Stacked per-shard pools [P, B, k'] -> merged global (ids, dists)
    [B, k]."""
    valid = (ids >= 0) & (ids < n_rows[:, None, None]) & (dists < INF)
    gids = torch.where(valid, ids + offsets[:, None, None],
                       torch.full_like(ids, PAD_ID))
    gd = torch.where(valid, dists, torch.full_like(dists, INF))
    # shard-major column order, exactly the mesh plane's gather layout
    all_ids = gids.movedim(0, 1).reshape(gids.shape[1], -1)
    all_d = gd.movedim(0, 1).reshape(gd.shape[1], -1)
    return merge_topk(all_ids, all_d, k)


def merge_shard_results(results, offsets, n_rows, *, k: int,
                        batch: int | None = None):
    """Host-side counterpart of the mesh plane's cross-shard merge, used by
    the request router's sharded mode (:mod:`repro_torch.serve.router`).

    ``results`` is one (ids [B, k'], dists [B, k']) pair per surviving
    shard — shard-LOCAL ids from independent single-device engines.  Each
    shard's ids are offset by its global row start (``offsets``) after
    masking invalid lanes (negative / ``>= n_rows[i]`` ids, INF
    distances), then the pools are concatenated shard-major and reduced
    with :func:`merge_topk` — so a router over P equal row slices answers
    as a P-DB-shard mesh plane does, bit for bit.

    ``batch`` sizes the all-PAD answer when ``results`` is empty (every
    shard failed); otherwise it is inferred.  Returns numpy arrays."""
    if not results:
        if batch is None:
            raise ValueError("batch= is required when no shard survived")
        return (np.full((batch, k), PAD_ID, np.int32),
                np.full((batch, k), INF, np.float32))
    ids = torch.stack([torch.as_tensor(np.asarray(i, np.int32))
                       for i, _ in results])
    dists = torch.stack([torch.as_tensor(np.asarray(d, np.float32))
                         for _, d in results])
    gi, gd = _pool_merge(ids, dists,
                         torch.tensor(list(offsets), dtype=torch.int32),
                         torch.tensor(list(n_rows), dtype=torch.int32), k)
    return gi.numpy(), gd.numpy()


# --------------------------------------------------------------------------
# search
# --------------------------------------------------------------------------

def make_search_fn(mesh: Mesh, cfg, *, kind: str = "large", k: int = 10,
                   stream: bool = False):
    """The sharded search: ``search(*operands, Q) -> (global ids [B, k],
    dists [B, k])``.

    The operands are the reference's, in its order, each the concatenated
    row-sharded tensor (or the replicated one): ``X, neighbors, lambdas,
    degrees, hubs`` (``hubs`` [0] when the graph has none), then ``codes,
    scales`` with int8 residency, then ``perm`` with the "layout" stage,
    then, with ``stream=True``, ``alive`` [N], ``delta_X`` [cap, d],
    ``delta_alive`` [cap] and, with int8 residency, the delta's ``codes,
    scales``.  Shard ``i`` is the row slice ``[i * N / P, (i + 1) * N /
    P)`` of each row-sharded operand (``hubs``: of the hubs).

    * small regime — Q replicated; each query column runs its slice of the
      t0 searches at its global place in the population; every (shard,
      column) cell's answers are merged together;
    * large regime — B split over the query columns, each column's rows
      seeded by their global index; the shards' answers are merged per
      query row.

    ``stream=True`` splices the delta shard, scanned brute-force once per
    query slice (the reference scores it on every shard, each computing
    the same candidates), into the same merge at global ids
    ``N + slot``.  With ``cfg.db_bf16`` the searches read a bf16 copy of
    X (a bf16 X operand is used as it is).  The body reads no tensor value
    on the host, so it can be captured into a CUDA graph.  It is
    :func:`make_cells_fn`, :func:`splice_delta` and :func:`merge_topk`
    over the pools' rows in turn; the pod plane runs the same three with
    an exchange of the cells' pools between the first two."""
    cells = make_cells_fn(mesh, cfg, kind=kind, k=k)
    quantized = getattr(cfg, "quantization", "none") == "int8"
    has_layout = "layout" in tuple(getattr(cfg, "build_pipeline", ()) or ())

    def search(*ops):
        index_ops, stream_ops, Q = split_operands(
            ops, quantized=quantized, has_layout=has_layout, stream=stream)
        alive = stream_ops[0] if stream else None
        pools_i, pools_d = cells(*index_ops, Q, alive=alive)
        if stream:
            splice_delta(pools_i, pools_d, query_slices(Q, kind, mesh),
                         stream_ops[1:], index_ops[0].shape[0], cfg, k=k)
        return merge_topk(torch.cat(pools_i), torch.cat(pools_d), k)

    return search


def split_operands(ops, *, quantized: bool, has_layout: bool,
                   stream: bool):
    """``make_search_fn``'s operands -> ``((X, neighbors, lambdas,
    degrees, hubs, codes, scales, perm), (alive, delta_X, delta_alive,
    delta_quant), Q)``; absent parts are None (``delta_quant``: the
    delta's ``(codes, scales)``), and the stream tuple is empty without
    ``stream``."""
    ops = list(ops)
    X, nbrs, lams, degs, hubs = ops[:5]
    rest = ops[5:]
    codes = scales = perm = None
    if quantized:  # row-sharded codes ride right after the fp32 parts
        codes, scales = rest[:2]
        rest = rest[2:]
    if has_layout:  # shard-local locality perm rides after the codes
        perm = rest[0]
        rest = rest[1:]
    stream_ops = ()
    if stream:
        alive, dX, dal = rest[:3]
        rest = rest[3:]
        dquant = None
        if quantized:
            dquant = tuple(rest[:2])
            rest = rest[2:]
        stream_ops = (alive, dX, dal, dquant)
    if len(rest) != 1:
        raise ValueError(f"expected one query operand after the "
                         f"{len(ops) - len(rest)} index operands, got "
                         f"{len(rest)}")
    return (X, nbrs, lams, degs, hubs, codes, scales, perm), stream_ops, \
        rest[0]


def query_slices(Q, kind: str, mesh: Mesh) -> list:
    """The query rows of each pool: all of Q in the small regime, each
    query column's rows in the large."""
    if kind == "small":
        return [Q]
    n_q = n_query_shards(mesh)
    B_local = Q.shape[0] // n_q
    return [Q[j * B_local:(j + 1) * B_local] for j in range(n_q)]


def make_cells_fn(mesh: Mesh, cfg, *, kind: str = "large", k: int = 10,
                  first_shard: int = 0):
    """The grid's cells: ``cells(X, neighbors, lambdas, degrees, hubs,
    codes, scales, perm, Q, *, alive=None) -> (pools_i, pools_d)``, one
    (ids, dists) pool a query slice (:func:`query_slices`), each the
    cells' top-k at global ids in shard-major columns (PAD_ID, INF where
    a cell had fewer answers).  ``codes``/``scales``/``perm`` are None
    without int8 residency or the layout; ``alive`` is the tombstone mask
    over these rows.  The operands hold ``mesh``'s DB shards, whose first
    is global shard ``first_shard``: shard ``i``'s ids start at
    ``(first_shard + i) * n_local``."""
    if kind not in ("small", "large"):
        raise ValueError(f"kind={kind!r} must be 'small' or 'large'")
    n_db = n_db_shards(mesh)
    n_q = n_query_shards(mesh)
    quantized = getattr(cfg, "quantization", "none") == "int8"
    rerank_mult = getattr(cfg, "rerank_mult", 4)
    visited = getattr(cfg, "visited_filter", "none")
    bf16 = bool(getattr(cfg, "db_bf16", False))
    metric = cfg.metric

    def cells(X, nbrs, lams, degs, hubs, codes, scales, perm, Q, *,
              alive=None):
        if bf16 and X.dtype != torch.bfloat16:
            X = X.to(torch.bfloat16)
        n_local = rows_per_shard(X.shape[0], n_db)
        nh = hubs.shape[0] // n_db
        B = Q.shape[0]
        backend = HP.resolve_backend(
            getattr(cfg, "kernel_backend", "auto"), X.device)
        if kind == "large" and B % n_q:
            raise ValueError(f"batch {B} does not split over {n_q} query "
                             "shards; pad it to a multiple")
        B_local = B // n_q
        t0_local = max(1, cfg.small_t0 // n_q)
        quant_kw = {}
        cols_i = [[] for _ in range(n_q)]
        cols_d = [[] for _ in range(n_q)]
        for i in range(n_db):
            lo = i * n_local
            rows = slice(lo, lo + n_local)
            graph = PackedGraph(
                neighbors=nbrs[rows], lambdas=lams[rows], degrees=degs[rows],
                hubs=hubs[i * nh:(i + 1) * nh] if nh else None,
                perm=None if perm is None else perm[rows])
            if quantized:
                quant_kw = dict(codes=codes[rows], scales=scales[rows],
                                rerank_mult=rerank_mult)
            alive_s = None if alive is None else alive[rows]
            for j in range(n_q):
                if kind == "small":
                    # this column runs its slice of the t0 searches, placed
                    # at its GLOBAL position inside the population
                    ids, dist = _small_batch_search(
                        X[rows], graph, Q, k=k, t0=t0_local,
                        hops=cfg.small_hops, hop_width=cfg.hop_width,
                        n_seeds=cfg.n_seeds, lambda_limit=10, metric=metric,
                        t0_offset=j * t0_local, t0_total=t0_local * n_q,
                        alive=alive_s, visited=visited, backend=backend,
                        **quant_kw)
                else:
                    ids, dist = _large_batch_search(
                        X[rows], graph, Q[j * B_local:(j + 1) * B_local],
                        k=k, ef=cfg.large_ef, hops=cfg.large_hops,
                        lambda_limit=5, metric=metric,
                        n_seeds=getattr(cfg, "large_n_seeds", cfg.n_seeds),
                        m_seg=cfg.queue_segments, seg=cfg.segment_size,
                        mv_seg=cfg.visited_segments, delta=cfg.delta,
                        seed_offset=j * B_local,
                        gather_limit=getattr(cfg, "gather_limit", 0),
                        exact_visited=getattr(cfg, "exact_visited", False),
                        alive=alive_s, visited=visited, backend=backend,
                        **quant_kw)
                # the search pads with hotpath.PAD_ID (2**31 - 1): only
                # ids below n_local name rows of this shard
                ok = ids < n_local
                gid = ids + (first_shard + i) * n_local
                cols_i[j].append(torch.where(ok, gid,
                                             torch.full_like(ids, PAD_ID)))
                cols_d[j].append(torch.where(ok, dist,
                                             torch.full_like(dist, INF)))
        if kind == "small":  # every cell's pool, shard-major
            return ([torch.cat([cols_i[j][i] for i in range(n_db)
                                for j in range(n_q)], dim=1)],
                    [torch.cat([cols_d[j][i] for i in range(n_db)
                                for j in range(n_q)], dim=1)])
        # one pool a query column, over the DB shards
        return ([torch.cat(c, dim=1) for c in cols_i],
                [torch.cat(c, dim=1) for c in cols_d])

    return cells


def splice_delta(pools_i: list, pools_d: list, slices: list, delta_ops,
                 n_total: int, cfg, *, k: int) -> None:
    """Append the delta shard's candidates (:func:`delta_candidates`,
    ``delta_ops`` = (delta_X, delta_alive, delta_quant)) to each pool, in
    place, scanned once per query slice at global ids ``n_total +
    slot``."""
    dX, dal, dquant = delta_ops
    backend = HP.resolve_backend(getattr(cfg, "kernel_backend", "auto"),
                                 dX.device)
    for p, Qs in enumerate(slices):
        d_ids, d_d = delta_candidates(
            Qs, dX, dal, dquant, n_total, k=k, metric=cfg.metric,
            rerank_mult=getattr(cfg, "rerank_mult", 4), backend=backend)
        pools_i[p] = torch.cat([pools_i[p], d_ids], dim=1)
        pools_d[p] = torch.cat([pools_d[p], d_d], dim=1)


def delta_candidates(Q, dX, dal, dquant, n_total: int, *, k: int,
                     metric: str, rerank_mult: int, backend: str):
    """The delta shard's candidates for a query batch, at global ids
    ``n_total + slot`` (PAD_ID, INF where dead): every live slot's exact
    distance, or, with int8 delta codes ``dquant`` = (codes, scales),
    the best ``rerank_mult * k`` slots of the code scan re-scored exactly
    against the fp32 rows.  Both planes' stream searches splice these
    into their merge."""
    cap = dX.shape[0]
    slots = torch.arange(cap, dtype=torch.int32, device=dX.device)
    if dquant is None:
        dd = HP.scan_distances(Q, dX, metric=metric, mask=dal,
                               backend=backend)
        d_ids = torch.where(dal, n_total + slots,
                            torch.full_like(slots, PAD_ID))
        return (d_ids.expand_as(dd),
                torch.where(dal[None], dd, torch.full_like(dd, INF)))
    dcodes, dscales = dquant
    dd = HP.scan_distances(Q, dcodes, metric=metric, mask=dal,
                           backend=backend, scales=dscales)
    r = min(max(rerank_mult, 1) * k, cap)
    sd, ss = HP.rank_merge(dd, slots.expand_as(dd), keep=r, backend=backend)
    ed = HP.neighbor_distances(Q, dX, ss, metric=metric, mask=sd < INF,
                               backend=backend)
    return torch.where(ed < INF, n_total + ss,
                       torch.full_like(ss, PAD_ID)), ed
