"""Pod execution plane — multi-process sharded serving over
``torch.distributed`` (the reference's ``serve/pod.py``).

:class:`PodPlane` stretches the mesh plane (:class:`~repro_torch.serve.
plane.MeshPlane`) over OS processes, one a card.  The grid of S DB shards
is cut over the W ranks: rank r holds shards ``[r·S/W, (r+1)·S/W)`` (S must
be a multiple of W) and builds, searches and rebuilds only those.  Because
the plane protocol is the only seam the serving engine sees, a pod engine
keeps the cache of captured graphs, warmup, streaming and stats unchanged.

Execution model is SPMD serving, as in the reference: every rank receives
the same full host corpus (and keeps only its rows on the device), and
calls ``engine.query`` with the SAME batch (the request router is the
front door that broadcasts requests in a real deployment).  A search runs
this rank's (shard, column) cells through the grid's own body
(:func:`repro_torch.core.distributed.make_cells_fn`), all-gathers every
rank's per-shard pools in rank order — which is shard-major order — and
merges them with the single-process grid's merge
(:func:`~repro_torch.core.distributed.merge_topk`, the delta shard
spliced in first).  So every rank returns the same answer, bit for bit
the single-process (S, 1) grid's.

On the card the search is split in three, since a collective of the gloo
backend cannot be captured into a CUDA graph (and an NCCL one only after
its communicator is warm): the local cells are one captured graph, the
exchange runs eagerly, and the delta splice and merge are a second
captured graph.  A replay equals the eager call bit for bit.

Queries stay replicated: with W > 1 a grid with a ``model`` axis is
refused.  ``topology()`` and ``fingerprint()`` add ``n_processes``.  Stream
mutations work as on the mesh plane: every rank applies the same calls,
the replicated delta stays identical everywhere, and ``compact()`` gathers
the corpus and rebuilds each rank's own shards.  ``Index.save`` on a pod
is SPMD (a collective gathers the shards, rank 0 writes, all ranks meet at
a barrier), and ``Index.load(path, mesh=)`` inside a pod re-binds each
rank's own shards.

The backend is the caller's choice: ``init_pod`` takes ``"nccl"`` for a
CUDA pod and ``"gloo"`` for a CPU one unless told otherwise.  NCCL refuses
two ranks on one card, so several ranks on one card pass
``backend="gloo"``; their exchange is then staged through pinned host
buffers, since that is how gloo moves data::

    # one process a card, all pointing at the same rendezvous
    init_pod("tcp://10.0.0.1:29500", world_size=4, rank=i)
    plane = PodPlane(X, cfg)               # one DB shard a rank
    index = Index(None, cfg, k=10, plane=plane, threshold=thr)

Registered as ``"pod"`` through :func:`repro_torch.serve.plane.
register_plane`; :func:`~repro_torch.serve.plane.get_plane` imports this
module lazily, and importing it touches nothing: :class:`PodPlane` is
built on first attribute access.

One multi-process caveat: ``cfg.regime_calibration="probe"`` fits the
regime threshold from *timed* probe batches, which could diverge across
processes near the split point and desynchronize the SPMD dispatch — pin a
static ``threshold=`` (or ship the saved artifact's calibrated value) on a
pod.
"""
from __future__ import annotations

_STATE: dict = {"initialized": False, "device": None}


def init_pod(init_method: str, *, world_size: int, rank: int,
             backend: str | None = None, device=None) -> None:
    """Join this process to a pod (idempotent): ``torch.distributed``'s
    default group over ``init_method`` (``"tcp://host:port"`` or
    ``"file:///path"``).  ``device`` is the pod's device on this rank
    (None: the current CUDA device, or an error without one); ``backend``
    None means ``"nccl"`` for a CUDA device and ``"gloo"`` on the CPU."""
    if _STATE["initialized"]:
        return
    import torch.distributed as dist

    from repro_torch.device import resolve_device

    dev = resolve_device(device)
    if backend is None:
        backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank)
    _STATE.update(initialized=True, device=dev)


def close_pod() -> None:
    """Leave the pod: destroy the default group (after a barrier)."""
    if not _STATE["initialized"]:
        return
    import torch.distributed as dist

    dist.barrier()
    dist.destroy_process_group()
    _STATE.update(initialized=False, device=None)


def active() -> bool:
    """Whether :func:`init_pod` joined this process to a pod."""
    return _STATE["initialized"]


def world() -> tuple:
    """(ranks, this rank): (1, 0) outside a pod."""
    if not active():
        return 1, 0
    import torch.distributed as dist

    return dist.get_world_size(), dist.get_rank()


_POD_CLS = None


def _build_pod_class():
    """Define and register :class:`PodPlane` on first use."""
    global _POD_CLS
    if _POD_CLS is not None:
        return _POD_CLS

    import numpy as np
    import torch
    import torch.distributed as dist

    from repro_torch.core import distributed as D
    from repro_torch.device import resolve_device
    from repro_torch.serve.plane import (CapturedSearch, MeshPlane,
                                         register_plane)

    class PodPlane(MeshPlane):
        """Cross-process mesh plane (see the module docstring).  ``mesh=``
        is the global grid (default: one ``data`` shard a rank, on
        ``device``, which defaults to the pod's); ``parts=`` takes the
        global prebuilt operands as :class:`MeshPlane` does, or, with
        ``local=True``, only this rank's shards of them (how the artifact
        loader restores a pod)."""

        name = "pod"

        def __init__(self, X, cfg, mesh=None, *, parts: tuple | None = None,
                     local: bool = False, device=None):
            self.world, self.rank = world()
            if mesh is None:
                mesh = D.make_mesh(
                    (self.world,), ("data",),
                    device=resolve_device(device or _STATE["device"]))
            if self.world > 1 and D.n_query_shards(mesh) > 1:
                raise ValueError(
                    "the pod plane serves queries replicated (every "
                    "process must hold the full answer); drop the 'model' "
                    "axis from the pod mesh")
            if D.n_db_shards(mesh) % self.world:
                raise ValueError(
                    f"{D.n_db_shards(mesh)} DB shards do not split over "
                    f"{self.world} processes")
            # gloo moves host memory: a card's pools go through pinned
            # buffers (the caller chose the backend)
            self._staged = active() and dist.get_backend() == "gloo" \
                and mesh.device.type == "cuda"
            self._cells_fns: dict = {}
            if parts is not None and not local:
                parts = tuple(self._own_rows(a) for a in parts)
            super().__init__(X, cfg, mesh, parts=parts)

        # -- this rank's shards -------------------------------------------

        def _local_grid(self, mesh):
            per = D.n_db_shards(mesh) // self.world
            names = ("data",) + (("model",) if self.n_q_shards > 1 else ())
            shape = (per,) + ((self.n_q_shards,) if self.n_q_shards > 1
                              else ())
            return (D.make_mesh(shape, names, device=mesh.device),
                    self.rank * per)

        def _own_rows(self, A):
            """This rank's equal slice of the rows of ``A`` (a
            row-sharded operand, or the hubs: S equal parts either way)."""
            n = A.shape[0]
            return A[self.rank * n // self.world:
                     (self.rank + 1) * n // self.world]

        def set_stream(self, alive, delta_X, delta_alive) -> None:
            """The stream operands with this rank's rows of the tombstone
            mask; the delta shard is replicated."""
            super().set_stream(self._own_rows(alive), delta_X, delta_alive)

        @property
        def n_rows(self) -> int:
            return self.n_local * self.n_db_shards

        def host_rows(self) -> np.ndarray:
            """Every rank's rows in external order (a collective)."""
            return self._gather_host(super().host_rows())

        def host_arrays(self) -> dict:
            """Every rank's operands on the host (a collective)."""
            return {name: self._gather_host(a)
                    for name, a in super().host_arrays().items()}

        def _gather_host(self, a: np.ndarray) -> np.ndarray:
            """Every rank's rows of a host array (one shape on all ranks),
            concatenated in rank order: over the card with NCCL, over the
            host with gloo."""
            if not active():
                return a
            comm = self.device if dist.get_backend() == "nccl" \
                else torch.device("cpu")
            t = torch.from_numpy(np.ascontiguousarray(a)).to(comm)
            out = t.new_empty((self.world,) + tuple(t.shape))
            dist.all_gather(list(out.unbind(0)), t)
            return out.reshape((-1,) + tuple(a.shape[1:])).cpu().numpy()

        def barrier(self) -> None:
            if active():
                dist.barrier()

        # -- identity -----------------------------------------------------

        def topology(self) -> dict:
            t = super().topology()
            t["n_processes"] = self.world
            return t

        def fingerprint(self) -> dict:
            fp = super().fingerprint()
            fp["n_processes"] = self.world
            return fp

        # -- searches: local cells, exchange, merge ------------------------

        def _cells(self, kind: str, k: int):
            fn = self._cells_fns.get((kind, k))
            if fn is None:
                fn = self._cells_fns[(kind, k)] = D.make_cells_fn(
                    self.local_mesh, self.cfg, kind=kind, k=k,
                    first_shard=self.first_shard)
            return fn

        def local_pool(self, kind: str, Q, k: int, streaming: bool):
            """This rank's cells on Q: [B, 2C] int32, each row's C
            candidate ids (global, shard-major) then their distances'
            bits."""
            g = self.graph
            alive = self._require_stream("search_stream")[0] if streaming \
                else None
            pools_i, pools_d = self._cells(kind, k)(
                self.X_search, g.neighbors, g.lambdas, g.degrees,
                self._ops[4], self.codes, self.scales, g.perm, Q,
                alive=alive)
            return torch.cat([torch.cat(pools_i),
                              torch.cat(pools_d).view(torch.int32)], dim=1)

        def exchange(self, local, out=None, staging=None):
            """Every rank's ``local`` pool stacked in rank order into
            ``out`` [W, B, 2C].  With gloo on the card through the pinned
            host pair ``staging`` (made here when None)."""
            if out is None:
                out = local.new_empty((self.world,) + tuple(local.shape))
            if not active():
                out[0].copy_(local)
            elif self._staged:
                h_local, h_out = staging or (
                    torch.empty(local.shape, dtype=local.dtype,
                                pin_memory=True),
                    torch.empty(out.shape, dtype=out.dtype,
                                pin_memory=True))
                h_local.copy_(local)             # waits for the stream
                dist.all_gather(list(h_out.unbind(0)), h_local)
                out.copy_(h_out)   # done before h_out can be written again
            else:
                dist.all_gather(list(out.unbind(0)), local)
            return out

        def merge(self, kind: str, Q, k: int, streaming: bool, gathered):
            """The gathered pools [W, B, 2C] -> (global ids [B, k], dists
            [B, k]): the rows' pools in shard-major order, the delta's
            candidates spliced in, the grid's merge."""
            W, B, C2 = gathered.shape
            C = C2 // 2
            ids = gathered[:, :, :C].movedim(0, 1).reshape(B, W * C)
            dists = gathered[:, :, C:].movedim(0, 1).reshape(B, W * C) \
                .view(torch.float32)
            slices = D.query_slices(Q, kind, self.local_mesh)
            sizes = [s.shape[0] for s in slices]
            pools_i, pools_d = list(ids.split(sizes)), list(dists.split(sizes))
            if streaming:
                st = self._require_stream("search_stream")
                D.splice_delta(pools_i, pools_d, slices,
                               (st[1], st[2],
                                st[3:] if self.quantized else None),
                               self.n_rows, self.cfg, k=k)
            return D.merge_topk(torch.cat(pools_i), torch.cat(pools_d), k)

        def search(self, kind: str, Q, k: int):
            """This rank's cells, the exchange and the merge, eagerly ->
            (global ids [B, k] int32, dists [B, k]); every rank must call
            it with the same batch."""
            return self.merge(kind, Q, k, False, self.exchange(
                self.local_pool(kind, Q, k, False)))

        def search_stream(self, kind: str, Q, k: int):
            return self.merge(kind, Q, k, True, self.exchange(
                self.local_pool(kind, Q, k, True)))

        def _capture(self, fn, kind, bucket, k, streaming, current):
            return PodCapture(self, kind, bucket, k, streaming, current)

    class PodCapture:
        """A pod search on the card: the local cells captured into one
        CUDA graph, the exchange eager (into buffers of its own, pinned
        ones with gloo), the splice and merge captured into a second
        graph.  A call checks ``current()``, replays, exchanges and
        replays, and returns the second graph's static ``(ids, dists)``."""

        def __init__(self, plane, kind, bucket, k, streaming, current):
            shape = (bucket, plane.X.shape[1])
            self.plane = plane
            self.cells = CapturedSearch(
                lambda q: plane.local_pool(kind, q, k, streaming), shape,
                plane.device, plane._pool, current)
            local = self.cells.out
            self.gathered = local.new_zeros((plane.world,)
                                            + tuple(local.shape))
            self.staging = None
            if plane._staged:
                self.staging = (
                    torch.empty(local.shape, dtype=local.dtype,
                                pin_memory=True),
                    torch.empty(self.gathered.shape, dtype=local.dtype,
                                pin_memory=True))
            self.merge = CapturedSearch(
                lambda q: plane.merge(kind, q, k, streaming, self.gathered),
                shape, plane.device, plane._pool, current)

        def __call__(self, Qb):
            local = self.cells(Qb)
            self.plane.exchange(local, self.gathered, self.staging)
            return self.merge(Qb)

    register_plane("pod", lambda X, cfg, **kw: PodPlane(X, cfg, **kw))
    _POD_CLS = PodPlane
    return PodPlane


def __getattr__(name: str):
    if name == "PodPlane":
        return _build_pod_class()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
