"""Execution planes: where the database and the graph live, and the
search procedure of each regime (the reference's ``serve/plane.py``).

* :class:`SingleDevicePlane` — the database and the packed graph resident
  on one device (the reference's ``SingleDevicePlane``);
* :class:`MeshPlane` — the database and one sub-index per DB shard over a
  shard grid (:mod:`repro_torch.core.distributed`), the reference's
  ``MeshPlane``: one process, one device, every cell's launches on one
  stream, so a search is still one CUDA graph.

:func:`register_plane` / :func:`get_plane` / :func:`planes` name them
(``"single"``, ``"mesh"``, and ``"pod"``, the multi-process
:mod:`repro_torch.serve.pod`, registered when first asked for).

The engine above a plane asks for one callable per (regime, bucket, k):
``compile`` and ``compile_stream`` take the bucket-padded query batch and
return ``(ids, dists)``.  On a CUDA plane the callable is a
:class:`CapturedSearch`, the search's kernel launches captured into a CUDA
graph once and replayed at every call; on a CPU plane it is the eager
search (nothing is captured on the CPU), so the engine is the same code on
both.

**A captured graph binds addresses, not arguments.**  A JAX executable
takes its operands at each call; a CUDA graph replays against the
buffers it was captured with.  So the plane keeps its operands in buffers
it owns, and:

* a generation swap that keeps every operand's shape (:meth:`rebind`,
  compaction) copies the new corpus, graph and codes INTO those buffers:
  every captured graph stays valid and answers for the new generation;
* a swap that changes a shape allocates new buffers and moves the shape
  token, whose first field counts the allocations (so a later swap back to
  old shapes never matches a graph bound to freed buffers); a callable
  whose token no longer matches raises :class:`StaleGeneration` and never
  replays, and the engine re-dispatches and prunes;
* the stream operands (:meth:`set_stream`: the tombstone mask, the delta
  shard and, on an int8 plane, its codes and scales) are written into
  buffers kept while the delta's capacity holds; only a capacity change
  moves the stream token.

A quantized plane (``cfg.quantization="int8"``) holds per-row int8 codes
and scales beside the fp32 rows, made at install (or carried in with
``quant=``); searches score the codes and re-rank exactly against the fp32
rows.

A packed graph (``graph.perm``, the locality layout) keeps its rows in
packed order: ``X`` and ``quant`` arrive in external order and are
gathered by ``perm`` at install, unless ``packed=True`` says they already
are (an artifact load).  ``perm`` rides last among the owned operands, so a
same-shape packed generation copies its new permutation in too.

Host queries reach the device through :meth:`stage_query`: one pinned
host buffer per (shape, dtype), copied with ``non_blocking=True``.
"""
from __future__ import annotations

import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.ann.pipeline import build_graph
from repro_torch.ann.quantize import quantize_rows
from repro_torch.core import distributed as D
from repro_torch.core import hotpath
from repro_torch.core.diversify import PackedGraph
from repro_torch.core.distributed import PAD_ID, merge_topk
from repro_torch.core.search_large import _large_batch_search
from repro_torch.core.search_small import _small_batch_search
from repro_torch.device import resolve_device
from repro_torch.kernels import _build

# small_batch_search's ranking width: the per-query candidate pool is
# t0 * width entries
SMALL_WIDTH = 32


class StaleGeneration(RuntimeError):
    """A callable's operand buffers are no longer the plane's (a compaction
    swapped in a different-shaped corpus, or the delta shard grew); the
    engine re-dispatches against the new token."""


def _shapes_of(ops) -> tuple:
    return tuple((tuple(a.shape), a.dtype) for a in ops)


# one capture at a time in the process: engines over different planes
# (the sharded router's shards) capture from their own threads
_CAPTURE_LOCK = threading.Lock()


class CapturedSearch:
    """One search captured into a CUDA graph, replayed at each call.

    ``fn`` maps a query batch to ``(ids, dists)``.  It runs once eagerly on
    a side stream (the warm-up PyTorch's CUDA-graph notes prescribe; its
    launches count), then once under capture into ``pool`` with a static
    query buffer (its launches are recorded, not counted: capture runs
    nothing).  Captures are serialised in the process and run in
    ``thread_local`` error mode, so other threads may keep replaying,
    reading answers back and allocating while one captures.  A call checks ``current()`` (which raises
    :class:`StaleGeneration`), copies the batch into the static buffer,
    replays, counts the recorded launches and returns the static
    ``(ids, dists)``: read them before the next replay of any graph of
    the same pool."""

    def __init__(self, fn, shape, device, pool, current):
        self._current = current
        self.q = torch.zeros(shape, dtype=torch.float32, device=device)
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with _CAPTURE_LOCK:
            with torch.cuda.stream(side):
                fn(self.q)
            main.wait_stream(side)
            self.graph = torch.cuda.CUDAGraph()
            with _build.recording() as self.launches:
                with torch.cuda.graph(self.graph, pool=pool,
                                      capture_error_mode="thread_local"):
                    self.out = fn(self.q)

    def __call__(self, Qb):
        self._current()
        self.q.copy_(Qb)
        self.graph.replay()
        _build.replayed(self.launches)
        return self.out


class _OwnedPlane:
    """What both planes share: the operand buffers they own (a same-shape
    generation is copied in, else new buffers move the shape token), the
    stream buffers, pinned staging, and the engine's callables (a
    :class:`CapturedSearch` on the card, the eager search on the CPU).
    A subclass installs its operands through :meth:`_own` and defines
    ``search`` / ``search_stream``."""

    name = "?"

    def __init__(self, cfg, device):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.backend = hotpath.resolve_backend(
            getattr(cfg, "kernel_backend", "auto"), self.device)
        self.gather_fused = getattr(cfg, "gather_fused", "auto")
        self._allocs = 0            # operand buffer sets allocated so far
        self._stream_allocs = 0     # stream buffer sets allocated so far
        self._ops = ()
        self._stream_bufs = None    # kept across clear_stream()
        self.stream = None          # the attached stream operands
        self._pool = None           # the CUDA graphs' shared memory pool
        self._stage_bufs: dict = {}
        self.stage_reuses = 0
        self.perm_shards = 1        # row slices a packed perm is local to

    @property
    def quantized(self) -> bool:
        return getattr(self.cfg, "quantization", "none") == "int8"

    @property
    def n_rows(self) -> int:
        """Rows of the database the index answers over (the pod's: every
        rank's)."""
        return int(self.X.shape[0])

    def host_rows(self) -> np.ndarray:
        """The database on the host in external row order (a packed
        layout's rows un-permuted, per row slice of ``perm_shards``)."""
        from repro_torch.ann.layout import unpack_rows

        X = self.X.cpu().numpy()
        perm = self.graph.perm
        if perm is None:
            return X
        return unpack_rows(X, perm.cpu().numpy(), n_shards=self.perm_shards)

    def _own(self, ops) -> bool:
        """Make ``ops`` the plane's operands: copied into the current
        buffers when every shape and dtype matches (returns False), else
        into fresh buffers of the plane's own (returns True; the shape
        token moves and the stream buffers go).  Clears the stream."""
        self.stream = None
        if _shapes_of(ops) == _shapes_of(self._ops):
            for dst, src in zip(self._ops, ops):
                dst.copy_(src)
            return False
        self._ops = tuple(self._put(a, a.dtype, own=True) for a in ops)
        self._allocs += 1
        self._stream_bufs = None
        return True

    def _put(self, A, dtype=None, *, own: bool = False):
        """``A`` on the plane's device as a contiguous ``dtype`` tensor
        (None: its own dtype); with ``own``, never storage the caller
        still holds."""
        if isinstance(A, np.ndarray) and not A.flags.writeable:
            A = A.copy()  # np.asarray of a JAX array: torch wants it writable
        src = torch.as_tensor(A)
        out = src.to(device=self.device, dtype=dtype or src.dtype) \
            .contiguous()
        if own and out.untyped_storage().data_ptr() \
                == src.untyped_storage().data_ptr():
            out = out.clone()
        return out

    # -- generations & streaming -------------------------------------------

    def shape_token(self) -> tuple:
        """The operand buffers' identity: (allocations, shapes).  Moves only
        when a swap allocates new buffers."""
        return (self._allocs, _shapes_of(self._ops))

    def stream_token(self):
        """The stream buffers' identity, (allocations, delta capacity);
        None while no stream state is attached."""
        if self.stream is None:
            return None
        return (self._stream_allocs, int(self.stream[1].shape[0]))

    def _fingerprint(self) -> dict:
        """What the plane's searches depend on, under the reference's
        fingerprint names (``torch`` in place of ``jax``)."""
        dev = self.device
        cuda = dev.type == "cuda"
        return {
            "torch": torch.__version__,
            "platform": "gpu" if cuda else "cpu",
            "device_kind": torch.cuda.get_device_name(dev) if cuda
            else "cpu",
            "n_devices": torch.cuda.device_count() if cuda else 1,
            "kernel_backend": self.backend,
            "gather_fused": self.gather_fused,
            "plane": self.name,
            "quantization": getattr(self.cfg, "quantization", "none"),
            "layout": self.graph.perm is not None,
            "visited_filter": getattr(self.cfg, "visited_filter", "none"),
        }

    def set_stream(self, alive, delta_X, delta_alive) -> None:
        """Attach / refresh the stream operands: ``alive`` [N] bool (the
        base tombstone mask), ``delta_X`` [cap, d] float32, ``delta_alive``
        [cap] bool.  A quantized plane adds the delta's int8 codes and
        scales (delta_X stays fp32 for the exact re-rank).  Written into
        the kept buffers while their shapes (the capacity) hold."""
        stream = (self._put(alive, torch.bool),
                  self._put(delta_X, torch.float32),
                  self._put(delta_alive, torch.bool))
        if self.quantized:
            stream = stream + quantize_rows(stream[1])
        bufs = self._stream_bufs
        if bufs is not None and _shapes_of(bufs) == _shapes_of(stream):
            for dst, src in zip(bufs, stream):
                dst.copy_(src)
        else:
            bufs = self._stream_bufs = tuple(
                self._put(a, a.dtype, own=True) for a in stream)
            self._stream_allocs += 1
        self.stream = bufs

    def clear_stream(self) -> None:
        self.stream = None

    @property
    def stream_active(self) -> bool:
        return self.stream is not None

    def _require_stream(self, what: str):
        if self.stream is None:
            raise RuntimeError(
                "no stream state attached (set_stream() installs the "
                f"tombstone mask + delta shard before {what})")
        return self.stream

    # -- H2D staging --------------------------------------------------------

    def stage_query(self, Qh: np.ndarray) -> torch.Tensor:
        """A host query batch on the device: through one pinned host
        buffer per (shape, dtype), copied with ``non_blocking=True`` (the
        engine reads each answer back before the next batch is staged, so
        the buffer is free again by then).  A CPU plane needs no copy.
        ``stage_reuses`` counts the batches that found their buffer."""
        key = (tuple(Qh.shape), str(Qh.dtype))
        host = torch.from_numpy(Qh)
        if key in self._stage_bufs:
            self.stage_reuses += 1
        else:
            self._stage_bufs[key] = (
                torch.empty(Qh.shape, dtype=host.dtype, pin_memory=True)
                if self.device.type == "cuda" else None)
        if self.device.type != "cuda":
            return host
        buf = self._stage_bufs[key]
        buf.copy_(host)
        return buf.to(self.device, non_blocking=True)

    # -- the engine's callables ---------------------------------------------

    def compile(self, kind: str, bucket: int, k: int):
        """The frozen index's search for one (regime, bucket, k): a
        callable taking the padded [bucket, d] float32 batch on the device
        and returning (ids, dists) — a :class:`CapturedSearch` on the card,
        the eager search on the CPU."""
        return self._bind(kind, bucket, k, streaming=False)

    def compile_stream(self, kind: str, bucket: int, k: int):
        """The same for the mutable index (``search_stream``); bound to
        the current stream buffers too."""
        self._require_stream("compile_stream")
        return self._bind(kind, bucket, k, streaming=True)

    def _bind(self, kind: str, bucket: int, k: int, *, streaming: bool):
        token = self.shape_token()
        stream_tok = self.stream_token() if streaming else None

        def current():
            if self.shape_token() != token or (
                    streaming and self.stream_token() != stream_tok):
                raise StaleGeneration(
                    "callable bound to a previous generation's operand "
                    "buffers; re-dispatch against the new token")

        def fn(Q):
            if streaming:
                return self.search_stream(kind, Q, k)
            return self.search(kind, Q, k)

        if self.device.type != "cuda":
            def call(Qb):
                current()
                return fn(Qb)
            return call
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        return self._capture(fn, kind, bucket, k, streaming, current)

    def _capture(self, fn, kind: str, bucket: int, k: int,
                 streaming: bool, current):
        """The card's callable: ``fn`` captured whole."""
        return CapturedSearch(fn, (bucket, self.X.shape[1]), self.device,
                              self._pool, current)

    def graph_pool_bytes(self) -> int:
        """Bytes of device memory the plane's CUDA graphs hold (the
        segments of their shared pool); 0 before the first capture."""
        if self._pool is None:
            return 0
        pool = tuple(self._pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


class SingleDevicePlane(_OwnedPlane):
    """Database + graph (+ int8 codes, + stream operands) on one device."""

    name = "single"

    def __init__(self, X, cfg, *, graph: PackedGraph | None = None,
                 quant: tuple | None = None, device=None,
                 packed: bool = False):
        super().__init__(cfg, device)
        X = self._put(X, torch.float32)
        if graph is None:
            graph = build_graph(X, cfg, device=self.device)
        self._install(X, graph, quant=quant, packed=packed)

    def _install(self, X, graph, *, quant=None,
                 packed: bool = False) -> None:
        """Swap in a generation (clears the stream operands).  ``X`` (and
        ``quant``'s rows) arrive in external order and are gathered into
        packed order when the graph carries ``perm``, unless ``packed``.
        Operands of the current shapes are copied into the current
        buffers; otherwise the plane takes fresh buffers of its own."""
        if graph.device != self.device:
            raise ValueError(f"graph on {graph.device}, plane on "
                             f"{self.device}")
        perm = graph.perm
        gather = perm is not None and not packed
        if gather:
            X = X[perm.long()]
        ops = (X, graph.neighbors, graph.lambdas, graph.degrees)
        if graph.hubs is not None:
            ops = ops + (graph.hubs,)
        if self.quantized:
            if quant is None:  # build / compaction; a loaded index passes it
                quant, gather = quantize_rows(X), False  # rows packed already
            codes = self._put(quant[0], torch.int8)
            scales = self._put(quant[1], torch.float32)
            if codes.shape != X.shape or scales.shape != X.shape[:1]:
                raise ValueError(
                    f"quant= codes {tuple(codes.shape)} / scales "
                    f"{tuple(scales.shape)} do not match X "
                    f"{tuple(X.shape)}")
            if gather:
                codes, scales = codes[perm.long()], scales[perm.long()]
            ops = ops + (codes, scales)
        if perm is not None:
            ops = ops + (perm,)  # rides last; counted in the shape token
        if self._own(ops):
            self.X = self._ops[0]
            self.graph = dataclasses.replace(
                graph, neighbors=self._ops[1], lambdas=self._ops[2],
                degrees=self._ops[3],
                hubs=None if graph.hubs is None else self._ops[4],
                perm=None if perm is None else self._ops[-1])
            at = 4 + (graph.hubs is not None)
            self.codes, self.scales = (self._ops[at:at + 2] if self.quantized
                                       else (None, None))

    def rebind(self, X, graph) -> None:
        """Swap to a new generation's corpus (external order) + graph
        (compaction); clears the stream operands and re-quantizes on a
        quantized plane.  Same shapes: copied into the current buffers
        (a packed graph's ``perm`` too), every captured graph stays valid;
        else new buffers and a new shape token."""
        self._install(self._put(X, torch.float32), graph)

    def fingerprint(self) -> dict:
        """What the plane's searches depend on, under the reference's
        fingerprint names (``torch`` in place of ``jax``)."""
        return self._fingerprint()

    # -- engine-facing geometry --------------------------------------------

    def batch_multiple(self) -> int:
        return 1

    def topology(self):
        return None

    # -- searches -----------------------------------------------------------

    def _search_args(self, kind: str, k: int):
        """(procedure, keyword arguments) for one regime at one k."""
        cfg = self.cfg
        visited = getattr(cfg, "visited_filter", "none")
        if kind == "small":
            kwargs = dict(k=k, t0=cfg.small_t0, hops=cfg.small_hops,
                          hop_width=cfg.hop_width, n_seeds=cfg.n_seeds,
                          lambda_limit=10, metric=cfg.metric,
                          visited=visited, backend=self.backend)
            fn = _small_batch_search
        else:
            kwargs = dict(k=k, ef=cfg.large_ef, hops=cfg.large_hops,
                          lambda_limit=5, metric=cfg.metric,
                          n_seeds=getattr(cfg, "large_n_seeds", cfg.n_seeds),
                          m_seg=cfg.queue_segments, seg=cfg.segment_size,
                          mv_seg=cfg.visited_segments, delta=cfg.delta,
                          visited=visited, backend=self.backend)
            fn = _large_batch_search
        if self.quantized:
            kwargs.update(codes=self.codes, scales=self.scales,
                          rerank_mult=getattr(cfg, "rerank_mult", 4))
        return fn, kwargs

    def search(self, kind: str, Q: torch.Tensor, k: int):
        """Run one regime's procedure eagerly on a (padded) query batch on
        the plane's device -> (ids [B, k] int32, dists [B, k])."""
        fn, kwargs = self._search_args(kind, k)
        return fn(self.X, self.graph, Q, **kwargs)

    def search_stream(self, kind: str, Q: torch.Tensor, k: int):
        """The mutable index's search, eagerly: the base graph search with
        the tombstone mask in its keep-masks, a brute-force scan of the
        delta shard, and one ``merge_topk``.  Delta rows answer at ids
        ``N + slot``; rows with fewer than k live candidates pad with
        (-1, INF).  On a quantized plane the delta scan scores the int8
        codes, keeps the best ``rerank_mult * k`` slots and re-scores them
        against the fp32 delta rows."""
        self._require_stream("search_stream")
        fn, kwargs = self._search_args(kind, k)
        alive, dX, dal = self.stream[:3]
        N, INF = self.X.shape[0], hotpath.INF
        bids, bd = fn(self.X, self.graph, Q, alive=alive, **kwargs)
        valid = (bids < N) & (bd < INF)
        pool_i = torch.where(valid, bids, torch.full_like(bids, PAD_ID))
        pool_d = torch.where(valid, bd, torch.full_like(bd, INF))
        d_ids, d_d = D.delta_candidates(
            Q, dX, dal, self.stream[3:] if self.quantized else None, N, k=k,
            metric=self.cfg.metric,
            rerank_mult=getattr(self.cfg, "rerank_mult", 4),
            backend=self.backend)
        return merge_topk(torch.cat([pool_i, d_ids], dim=1),
                          torch.cat([pool_d, d_d], dim=1), k)


def shard_layout(X, built, n_shards: int):
    """The mesh's locality packing, shard by shard: each shard's
    sub-index to the host, ordered over its LOCAL ids
    (:func:`repro_torch.ann.layout.locality_order`), relabelled and laid
    back on X's device.  Returns ``((X, neighbors, lambdas, degrees,
    hubs, perm), seconds)``: the packed parts with the [N] shard-local
    ``perm`` last, and each shard's host seconds.  The searches map back
    to external local ids before the global offset."""
    from repro_torch.ann import layout as L

    X_h = X.cpu().numpy()
    nbrs, lams, degs, hubs = (a.cpu().numpy() for a in built)
    n_local = X_h.shape[0] // n_shards
    nh = hubs.shape[0] // n_shards
    outs = [[] for _ in range(6)]
    seconds = []
    for i in range(n_shards):
        t0 = time.perf_counter()
        rows = slice(i * n_local, (i + 1) * n_local)
        hub_i = hubs[i * nh:(i + 1) * nh] if nh else None
        perm_i = L.locality_order(nbrs[rows], starts=hub_i)
        packed = L.apply_layout(perm_i, X_h[rows], nbrs[rows], lams[rows],
                                degs[rows], hubs=hub_i)
        packed = packed[:4] + (packed[4] if hub_i is not None
                               else np.zeros((0,), np.int32), perm_i)
        for out, a in zip(outs, packed):
            out.append(a)
        seconds.append(time.perf_counter() - t0)
    parts = tuple(torch.from_numpy(np.ascontiguousarray(np.concatenate(o)))
                  .to(X.device) for o in outs)
    return parts, seconds


class MeshPlane(_OwnedPlane):
    """Database + one sub-index per DB shard over a shard grid
    (:class:`repro_torch.core.distributed.Mesh`); searches through
    :func:`~repro_torch.core.distributed.make_search_fn`.

    The operands are the reference's, each the concatenation of the
    shards' row slices: ``X, neighbors, lambdas, degrees, hubs`` (``hubs``
    [0] without bridges), then the int8 ``codes, scales``, then the
    shard-local ``perm`` of a packed layout — and, with ``cfg.db_bf16``,
    a bf16 copy of X made once at install, which the searches read (X
    stays fp32 for the artifact and for compaction).  ``parts=`` takes
    prebuilt ``(X, neighbors, lambdas, degrees, hubs[, codes, scales]
    [, perm])`` — how the artifact loader restores a sharded index without
    rebuilding; otherwise the plane builds one sub-index per DB shard
    (``build_seconds``: one dict of stage seconds a shard).  Stream
    operands are the single plane's: the tombstone mask over all N rows
    and one replicated delta shard."""

    name = "mesh"

    def __init__(self, X, cfg, mesh, *, parts: tuple | None = None):
        super().__init__(cfg, mesh.device)
        self.mesh = mesh
        if not D.db_axes(mesh):
            raise ValueError(
                f"mesh {D.axis_sizes(mesh)} has no DB axis; name one of its "
                "axes 'data' (and optionally 'pod'/'model')")
        self.n_db_shards = D.n_db_shards(mesh)
        self.n_q_shards = D.n_query_shards(mesh)
        # the shards this process holds: here all of them
        self.local_mesh, self.first_shard = self._local_grid(mesh)
        self.perm_shards = D.n_db_shards(self.local_mesh)
        self.build_seconds: list = []
        self._fns: dict = {}
        if parts is None:
            parts = self._build(X)
        self._install(tuple(self._put(a) for a in parts))

    def _local_grid(self, mesh):
        """(the grid of the shards this process holds, the global index
        of its first shard)."""
        return mesh, 0

    def _own_rows(self, A):
        """The rows of a row-sharded operand that this process holds."""
        return A

    @property
    def has_layout(self) -> bool:
        return "layout" in tuple(getattr(self.cfg, "build_pipeline", ())
                                 or ())

    def _build(self, X) -> tuple:
        """The shard build of this process's rows of ``X`` (stage seconds
        into ``build_seconds``), then the per-shard host layout: ``(X,
        neighbors, lambdas, degrees, hubs[, perm])``."""
        X = self._put(self._own_rows(X), torch.float32)
        self.build_seconds = []
        built = D.make_build_fn(self.local_mesh, self.cfg)(
            X, timings=self.build_seconds)
        return self._host_layout(X, built)

    def _host_layout(self, X, built) -> tuple:
        """Per-shard locality packing (:func:`shard_layout`) when the
        config has the "layout" stage, which the shard build strips."""
        if not self.has_layout:
            return (X, *built)
        parts, seconds = shard_layout(X, built, self.perm_shards)
        for timings, t in zip(self.build_seconds, seconds):
            timings["layout"] = t
        return parts

    def _install(self, parts) -> None:
        """Swap in a generation: this process's shards of ``parts`` as
        :meth:`__init__` takes them, already on the device.  A quantized
        config without saved codes derives them (row-local, so the shard
        cut does not matter); a ``db_bf16`` config makes the bf16 copy.
        Clears the stream."""
        X, nbrs, lams, degs, hubs = parts[:5]
        rest = tuple(parts[5:])
        perm = None
        if self.has_layout:
            perm, rest = rest[-1], rest[:-1]
        if self.quantized and not rest:
            rest = quantize_rows(X)  # X is packed already: so are the codes
        if len(rest) != (2 if self.quantized else 0):
            raise ValueError(
                f"parts= holds {len(parts)} operands, which does not match "
                f"quantization={self.cfg.quantization!r} and layout="
                f"{self.has_layout}")
        n_local = D.rows_per_shard(X.shape[0], self.perm_shards)
        if hubs.shape[0] % self.perm_shards:
            raise ValueError(f"{hubs.shape[0]} hubs do not split over "
                             f"{self.perm_shards} DB shards")
        ops = (X, nbrs, lams, degs, hubs) + tuple(rest)
        if perm is not None:
            ops = ops + (perm,)
        if self.cfg.db_bf16:  # made once: no graph casts the corpus
            ops = ops + (X.to(torch.bfloat16),)
        self._own(ops)
        o = self._ops
        self.X = o[0]
        self.n_local = n_local
        self.graph = PackedGraph(
            neighbors=o[1], lambdas=o[2], degrees=o[3],
            hubs=o[4] if o[4].shape[0] else None,
            perm=o[5 + len(rest)] if perm is not None else None)
        self.codes, self.scales = (o[5], o[6]) if self.quantized \
            else (None, None)
        self.X_search = o[-1] if self.cfg.db_bf16 else o[0]

    def operands(self) -> tuple:
        """The search's index operands, in the reference's order: X (its
        bf16 copy with ``db_bf16``), neighbors, lambdas, degrees, hubs
        [, codes, scales][, perm]."""
        o = self._ops
        n = 5 + 2 * self.quantized + (self.graph.perm is not None)
        return (self.X_search,) + o[1:n]

    # -- generations --------------------------------------------------------

    def rebind(self, X) -> None:
        """Swap to a new generation's corpus (external order): rebuild the
        shard-local sub-indexes over it — the build a fresh mesh plane
        runs — and install them (copied into the current buffers when the
        shapes hold, so every captured graph stays valid)."""
        self._install(self._build(X))

    def host_arrays(self) -> dict:
        """The operands on the host, each the concatenation of every DB
        shard's rows: ``X`` and the sub-indexes (``hubs`` always), the int8
        ``codes, scales``, a packed layout's shard-local ``perm``."""
        g = self.graph
        full = {"X": self.X, "neighbors": g.neighbors, "lambdas": g.lambdas,
                "degrees": g.degrees,
                "hubs": g.hubs if g.hubs is not None else torch.zeros(
                    (0,), dtype=torch.int32)}
        if self.quantized:
            full["codes"], full["scales"] = self.codes, self.scales
        if g.perm is not None:  # v5: rows shard-packed, perm shard-local
            full["perm"] = g.perm
        return {name: a.cpu().numpy() for name, a in full.items()}

    def host_shards(self) -> list:
        """:meth:`host_arrays` cut shard-major: one dict a DB shard with
        its X slice and its own sub-index.  The operands are the
        concatenations of the shards' results, so equal row slices ARE
        the per-shard arrays."""
        full = self.host_arrays()
        n = self.n_db_shards
        return [{name: a[i * (a.shape[0] // n):(i + 1) * (a.shape[0] // n)]
                 for name, a in full.items()} for i in range(n)]

    def fingerprint(self) -> dict:
        fp = self._fingerprint()
        fp["mesh_axes"] = self.topology()["axes"]
        return fp

    # -- engine-facing geometry --------------------------------------------

    def batch_multiple(self) -> int:
        """The large regime splits B over the query shards, so buckets
        must divide evenly across them."""
        return self.n_q_shards

    def topology(self) -> dict:
        """The grid, as the artifact's manifest records it:
        ``n_db_shards`` gates sub-index reuse on load."""
        return {"axes": D.axis_sizes(self.mesh),
                "n_db_shards": self.n_db_shards,
                "n_q_shards": self.n_q_shards}

    # -- searches -----------------------------------------------------------

    def _fn(self, kind: str, k: int, stream: bool):
        key = (kind, k, stream)
        fn = self._fns.get(key)
        if fn is None:
            fn = self._fns[key] = D.make_search_fn(
                self.mesh, self.cfg, kind=kind, k=k, stream=stream)
        return fn

    def search(self, kind: str, Q: torch.Tensor, k: int):
        """Every (shard, column) cell's search on a (padded) query batch,
        merged -> (global ids [B, k] int32, dists [B, k])."""
        return self._fn(kind, k, False)(*self.operands(), Q)

    def search_stream(self, kind: str, Q: torch.Tensor, k: int):
        """The mutable index's search: the cells with the tombstone mask,
        the delta shard's scan, one merge (delta rows at ids ``N +
        slot``)."""
        stream = self._require_stream("search_stream")
        return self._fn(kind, k, True)(*self.operands(), *stream, Q)


# --------------------------------------------------------------------------
# registry
# --------------------------------------------------------------------------

_PLANES: dict = {}


def register_plane(name: str, factory) -> None:
    """Register a plane factory ``(X, cfg, **kw) -> plane`` under
    ``name``."""
    _PLANES[name] = factory


def planes() -> tuple:
    return tuple(sorted(_PLANES))


def get_plane(name: str):
    if name == "pod" and name not in _PLANES:
        # registers itself on first use, so single-process code never
        # imports torch.distributed
        from repro_torch.serve import pod

        pod.PodPlane  # noqa: B018 — builds and registers the class
    try:
        return _PLANES[name]
    except KeyError:
        raise KeyError(f"unknown execution plane {name!r}; "
                       f"registered: {planes()}") from None


register_plane("single", lambda X, cfg, **kw: SingleDevicePlane(X, cfg, **kw))
register_plane("mesh", lambda X, cfg, **kw: MeshPlane(X, cfg, **kw))
