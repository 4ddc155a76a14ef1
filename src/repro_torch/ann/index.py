"""`Index` — the public handle of the port (the reference's
``repro.ann.Index``: build, search and streaming mutability)::

    from repro_torch.ann import Index

    index = Index.build(X, cfg)              # knn -> diversify -> bridges
    ids, dists = index.search(Q)             # automatic regime dispatch
    new_ids = index.add(V)                   # into the brute-force delta
    index.delete(ids_to_drop)                # tombstones
    id_map = index.compact()                 # rebuild, next generation
    index.save("/models/tsdg-1m")            # the versioned artifact
    index = Index.load("/models/tsdg-1m")    # restart: no rebuild
    index.warmup()                           # capture every reachable graph
    with index.serve(max_wait_ms=2.0) as mb: # micro-batching queue + QoS
        fut = mb.submit(q, deadline_ms=15.0)
    with index.serve(router="replicated:2") as r:  # replicas behind a router
        fut = r.submit(q)

Sharded serving is the same verbs: ``Index.build(X, cfg, mesh=mesh)``
(``mesh = repro_torch.core.distributed.make_mesh((4, 2), ("data",
"model"))``) builds one sub-index per DB shard of the grid behind the
same ``search()``, ``save`` writes the shard-major artifact, and
``Index.load(path, mesh=mesh)`` restores it without a rebuild.

``cfg.quantization="int8"`` scores per-row int8 codes in-kernel and
re-ranks exactly against the fp32 rows.  ``cfg.regime_calibration="probe"``
fits the regime split from timed probe batches (:attr:`Index.calibration`).
A ``"layout"`` stage in ``cfg.build_pipeline`` stores the rows in the
locality-packed order (:mod:`repro_torch.ann.layout`); ids in and out stay
external, and the answers are those of the unpacked graph.

Everything runs on the CUDA device unless ``device="cpu"`` is passed.
"""
from __future__ import annotations

from repro_torch.ann.pipeline import build_graph
from repro_torch.configs.base import ANNConfig
from repro_torch.device import resolve_device
from repro_torch.serve.engine import ANNEngine


class Index:
    """A built TSDG index plus its serving engine.

    Construct with :meth:`build` or :meth:`load`.  ``graph=`` takes a
    prebuilt :class:`~repro_torch.core.diversify.PackedGraph` (on the
    index's device) and skips the pipeline; a graph with ``perm`` gathers
    ``X`` (and ``quant``'s rows) into packed order, unless ``packed=True``
    says they already are (how :meth:`load` restores a packed artifact).
    ``mesh=`` builds one sub-index per DB shard of a shard grid
    (:mod:`repro_torch.core.distributed`) on the grid's device; ``plane=``
    takes any prebuilt plane (how :meth:`load` restores a sharded
    artifact).  After a build, ``build_seconds`` holds each stage's wall
    seconds (on a mesh: ``{"shard i": {stage: seconds}}``).
    ``threshold=`` overrides the §4 regime split."""

    def __init__(self, X, cfg: ANNConfig | None = None, *, k: int = 10,
                 graph=None, stages=None, tile: int = 2048, quant=None,
                 device=None, threshold: float | None = None, mesh=None,
                 plane=None, packed: bool = False):
        cfg = cfg or ANNConfig()
        self.build_seconds: dict = {}
        if plane is not None or mesh is not None:
            if stages is not None or graph is not None:
                raise ValueError("stages=/graph= do not apply with mesh= "
                                 "or plane=")
        elif graph is None:
            device = resolve_device(device)
            graph = build_graph(X, cfg, stages=stages, tile=tile,
                                device=device, timings=self.build_seconds)
        elif stages is not None:
            raise ValueError("stages= only applies when the pipeline runs "
                             "(not with graph=)")
        self.engine = ANNEngine(X, cfg, k=k, graph=graph, quant=quant,
                                device=device, threshold=threshold,
                                packed=packed, mesh=mesh, plane=plane)
        if mesh is not None:
            self.build_seconds = {
                f"shard {i}": t
                for i, t in enumerate(self.engine.plane.build_seconds)}

    @classmethod
    def build(cls, X, cfg: ANNConfig | None = None, *, k: int = 10,
              stages=None, tile: int = 2048, device=None,
              threshold: float | None = None, mesh=None) -> "Index":
        """Run the staged build pipeline (``cfg.build_pipeline``) on
        ``device`` and wrap the result in an `Index`."""
        return cls(X, cfg, k=k, stages=stages, tile=tile, device=device,
                   threshold=threshold, mesh=mesh)

    @classmethod
    def from_numpy(cls, X, graph_arrays, cfg: ANNConfig | None = None, *,
                   k: int = 10, quant=None, stream=None,
                   device=None) -> "Index":
        """An index over state built elsewhere, e.g. by the JAX package:
        ``graph_arrays`` maps the fields of a ``PackedGraph``
        (``neighbors``, ``lambdas``, ``degrees``, optional ``hubs`` and
        ``perm``) to numpy arrays, with ``X`` in external order; ``quant`` is the plane's ``(codes, scales)``;
        ``stream`` the mutation state ``(base_alive, delta_X,
        delta_alive, count)`` (see :mod:`repro_torch.ann.convert`)."""
        from repro_torch.ann.convert import graph_from_numpy

        device = resolve_device(device)
        index = cls(X, cfg, k=k, device=device, quant=quant,
                    graph=graph_from_numpy(**graph_arrays, device=device))
        if stream is not None:
            index.engine.restore_stream(*stream)
        return index

    def search(self, Q, *, k: int | None = None):
        """Answer one batch: (ids [B, k], dists [B, k]) numpy arrays."""
        return self.engine.query(Q, k=k)

    def regime(self, batch: int) -> str:
        """Which procedure a batch of this size takes ("small"/"large");
        a live delta shard's brute-force population counts."""
        return self.engine.regime(batch)

    def warmup(self, k: int | None = None) -> int:
        """Make every reachable (regime, bucket) entry of the engine's
        cache (on the card: capture its CUDA graph); returns the number of
        fresh entries."""
        return self.engine.warmup(k=k)

    def serve(self, *, router=None, **qos):
        """A running :class:`~repro_torch.serve.queue.MicroBatcher` over
        this index.  QoS knobs pass through: ``max_wait_ms`` (coalescing
        window), ``max_batch`` (dispatch cap; submits at or above it take
        the bypass lane); per request ``submit(..., deadline_ms=)``.

        With ``router=`` (a :class:`~repro_torch.serve.router.RouterConfig`
        or a spec ``"replicated:N"`` / ``"sharded:N"``): a running
        :class:`~repro_torch.serve.router.Router` instead, N endpoints
        each with its own queue (the QoS knobs apply to every queue).
        Replicated endpoints share this index's plane and cache; sharded
        endpoints cut the corpus into N equal slices and build one
        sub-index each."""
        if router is not None:
            from repro_torch.serve.router import Router, parse_router_spec

            if isinstance(router, str):
                router = parse_router_spec(router)
            return Router.for_index(self, router, **qos)
        from repro_torch.serve.queue import MicroBatcher

        return MicroBatcher(self.engine, **qos)

    # -- persistence --------------------------------------------------------

    def save(self, path, *, aot: bool = True, extra_ks=()):
        """Write the versioned artifact (format v5, the reference's layout:
        graph, database, config, fingerprint, the stream's mutations);
        :mod:`repro_torch.ann.artifact` has the format.  ``aot`` and
        ``extra_ks`` are accepted for the reference's signature; no
        executable is stored (the port's are CUDA graphs)."""
        from repro_torch.ann.artifact import save_index

        return save_index(self, path, aot=aot, extra_ks=extra_ks)

    @classmethod
    def load(cls, path, *, device=None, mesh=None) -> "Index":
        """Restore an index saved by either package (formats v1-v5)
        without rebuilding, on the card unless ``device="cpu"``.  Pass
        ``mesh=`` to restore a sharded artifact onto a grid with the same
        number of DB shards (on the grid's device); a sharded artifact
        without ``mesh=``, or onto another shard count, is gathered and
        rebuilt with a warning."""
        from repro_torch.ann.artifact import load_index

        return load_index(cls, path, device=device, mesh=mesh)

    # -- streaming mutability -----------------------------------------------

    def add(self, V):
        """Append vectors without rebuilding: they land in a brute-force
        delta shard searched beside the graph.  Returns their global ids
        (``n_base + slot``), stable until :meth:`compact`."""
        return self.engine.add(V)

    def delete(self, ids) -> int:
        """Tombstone ids (base or delta).  Deleted rows are still routed
        through during the graph walk but never returned.  All-or-nothing:
        unknown, duplicate or already-deleted ids raise KeyError without
        mutating anything."""
        return self.engine.delete(ids)

    def compact(self, *, tile: int = 2048):
        """Fold adds and deletes into a fresh generation: rebuild over the
        effective corpus and swap it in.  Returns the old->new id map
        (int64, -1 = deleted)."""
        return self.engine.compact(tile=tile)

    @property
    def generation(self) -> int:
        """Completed compactions since this index was built."""
        return self.engine.stats.generation

    @property
    def n_active(self) -> int:
        """Rows a search can currently return (base + delta - tombstones)."""
        return self.engine.n_active()

    @property
    def X(self):
        """The database on the device; on a packed index its rows are in
        packed order (row ``i`` is external id ``graph.perm[i]``)."""
        return self.engine.X

    @property
    def graph(self):
        return self.engine.graph

    @property
    def cfg(self) -> ANNConfig:
        return self.engine.cfg

    @property
    def k(self) -> int:
        return self.engine.k

    @property
    def stats(self):
        return self.engine.stats

    @property
    def backend(self) -> str:
        return self.engine.backend

    @property
    def device(self):
        return self.engine.device

    @property
    def plane(self):
        """The engine's execution plane (single-device or mesh)."""
        return self.engine.plane

    @property
    def mesh(self):
        return self.engine.mesh

    @property
    def calibration(self):
        """The fitted regime split, when ``regime_calibration="probe"``."""
        return self.engine.calibration

    def __repr__(self) -> str:
        g = self.graph
        return (f"Index(n={g.n}, d={self.X.shape[1]}, "
                f"max_degree={g.max_degree}, metric={self.cfg.metric!r}, "
                f"backend={self.backend!r}, plane={self.plane.name!r}, "
                f"device={str(self.device)!r}, k={self.k})")
