"""In-process serving (the reference's ``serve/engine.py::ANNEngine``):
regime dispatch, the shape-bucket ladder with edge padding, the serving
counters, and streaming mutability — ``add`` / ``delete`` into a host-side
mutation log published to the plane, and ``compact`` into a fresh
generation.  Execution is eager; the compile cache and staging come in
later slices.  One lock serialises queries and mutations, so a query sees
one generation and one stream state from start to end."""
from __future__ import annotations

import dataclasses
import threading

import numpy as np
import torch

from repro_torch.ann.delta import StreamState
from repro_torch.ann.dispatch import regime_for
from repro_torch.configs.base import ANNConfig
from repro_torch.serve.plane import SMALL_WIDTH, SingleDevicePlane


@dataclasses.dataclass
class ServeStats:
    n_queries: int = 0              # all queries answered
    n_batches: int = 0
    small_batches: int = 0
    large_batches: int = 0
    padded_queries: int = 0         # rows added by bucketing
    generation: int = 0             # completed compactions since build
    n_added: int = 0                # vectors appended via add()
    n_deleted: int = 0              # ids tombstoned via delete()
    compactions: int = 0
    stream_batches: int = 0         # batches answered with stream state

    def snapshot(self) -> dict:
        return dataclasses.asdict(self)


class ANNEngine:
    """Build once (or take a graph), answer batches of queries."""

    def __init__(self, X, cfg: ANNConfig | None = None, *, k: int = 10,
                 graph=None, quant=None, device=None):
        self.cfg = cfg or ANNConfig()
        self.k = k
        self.stats = ServeStats()
        self.buckets = tuple(sorted(self.cfg.serve_buckets))
        self.plane = SingleDevicePlane(X, self.cfg, graph=graph, quant=quant,
                                       device=device)
        self.stream: StreamState | None = None  # the host mutation log
        self.lock = threading.RLock()

    @property
    def X(self):
        return self.plane.X

    @property
    def graph(self):
        return self.plane.graph

    @property
    def backend(self) -> str:
        return self.plane.backend

    @property
    def device(self) -> torch.device:
        return self.plane.device

    def regime(self, batch: int) -> str:
        """Paper §4's split; a live delta shard adds its brute-force
        population (every query scores every live delta row)."""
        return regime_for(self.cfg, batch, n_delta=self._n_delta())

    def _n_delta(self) -> int:
        stream = self.stream
        return 0 if stream is None else stream.delta.n_alive()

    def bucket_for(self, batch: int) -> int:
        """Smallest ladder bucket >= batch; beyond the ladder, the next
        multiple of the largest bucket.  No ladder -> the raw batch."""
        if not self.buckets:
            return batch
        bucket = next((b for b in self.buckets if b >= batch), None)
        if bucket is None:
            top = self.buckets[-1]
            bucket = -(-batch // top) * top
        return bucket

    def _validate_k(self, k, kind: str) -> int:
        if k is None:
            k = self.k
        if not isinstance(k, int) or isinstance(k, bool) or k <= 0:
            raise ValueError(f"k must be a positive int, got {k!r}")
        if kind == "large" and k > self.cfg.large_ef:
            raise ValueError(
                f"k={k} exceeds large-batch ranking size ef="
                f"{self.cfg.large_ef}; raise cfg.large_ef or lower k")
        if kind == "small" and k > self.cfg.small_t0 * SMALL_WIDTH:
            raise ValueError(
                f"k={k} exceeds small-batch candidate pool t0*width="
                f"{self.cfg.small_t0 * SMALL_WIDTH}; raise cfg.small_t0 "
                "or lower k")
        return k

    @staticmethod
    def _numeric(A, what: str) -> torch.Tensor:
        A = torch.as_tensor(A)
        if A.dtype.is_complex or A.dtype == torch.bool:
            raise ValueError(
                f"{what} must be numeric (float/int), got {A.dtype}")
        return A

    def query(self, Q, *, k: int | None = None):
        """Answer a batch: (ids [B, k], dists [B, k]) numpy arrays."""
        Q = self._numeric(Q, "Q").to(device=self.device, dtype=torch.float32)
        d = self.X.shape[1]
        if Q.dim() != 2 or Q.shape[1] != d:
            raise ValueError(f"Q must be [B, {d}], got {tuple(Q.shape)}")
        B = Q.shape[0]
        if B == 0:
            raise ValueError("empty query batch")
        with self.lock:
            kind = self.regime(B)
            k = self._validate_k(k, kind)
            bucket = self.bucket_for(B)
            if bucket > B:  # edge padding: replicate the last row
                Q = torch.cat([Q, Q[-1:].expand(bucket - B, d)], dim=0)
            streaming = self.plane.stream_active
            search = (self.plane.search_stream if streaming
                      else self.plane.search)
            ids, dists = search(kind, Q.contiguous(), k)
            st = self.stats
            st.n_queries += B
            st.n_batches += 1
            st.padded_queries += bucket - B
            if kind == "small":
                st.small_batches += 1
            else:
                st.large_batches += 1
            if streaming:
                st.stream_batches += 1
        return ids[:B].cpu().numpy(), dists[:B].cpu().numpy()

    # -- streaming mutability ----------------------------------------------

    def add(self, V) -> np.ndarray:
        """Append vectors to the delta shard; returns their global ids
        (``n_base + slot``, stable until the next :meth:`compact`).
        Accepts [m, d] or a single [d] vector; numeric dtypes are cast to
        float32."""
        V = self._numeric(V, "vectors").to(torch.float32).cpu().numpy()
        if V.ndim == 1:
            V = V[None]
        d = int(self.X.shape[1])
        if V.ndim != 2 or V.shape[1] != d:
            raise ValueError(
                f"vectors must be [m, {d}] (or a single [{d}] vector), "
                f"got {tuple(V.shape)}")
        if V.shape[0] == 0:
            raise ValueError("empty add batch")
        with self.lock:
            stream = self._ensure_stream()
            ids = stream.add(V)
            self._push_stream()
            self.stats.n_added += len(ids)
        return ids

    def delete(self, ids) -> int:
        """Tombstone ids (base or delta).  All-or-nothing: unknown,
        out-of-range, duplicate or already-deleted ids raise KeyError and
        nothing is tombstoned.  Returns the number of ids removed."""
        with self.lock:
            stream = self._ensure_stream()
            n = stream.delete(ids)
            self._push_stream()
            self.stats.n_deleted += n
        return n

    def n_active(self) -> int:
        """Rows a search can currently return (base + delta - tombstones)."""
        stream = self.stream
        return int(self.X.shape[0]) if stream is None else stream.n_active()

    def _ensure_stream(self) -> StreamState:
        """Create the host-side mutation log on first use (caller holds
        the lock)."""
        if self.stream is None:
            self.stream = StreamState(
                int(self.X.shape[0]), int(self.X.shape[1]),
                min_cap=getattr(self.cfg, "delta_min_cap", 256))
        return self.stream

    def _push_stream(self) -> None:
        """Publish the mutation log as device operands (caller holds the
        lock).  One host copy of the delta shard per mutation, never per
        query."""
        self.plane.set_stream(*self.stream.device_view())

    def restore_stream(self, base_alive, delta_X, delta_alive,
                       count) -> None:
        """Attach mutation state carried in from numpy
        (:func:`repro_torch.ann.convert.stream_from_numpy`)."""
        from repro_torch.ann.convert import stream_from_numpy

        stream = stream_from_numpy(base_alive, delta_X, delta_alive, count)
        if stream.n_base != self.X.shape[0] \
                or stream.delta.d != self.X.shape[1]:
            raise ValueError(
                f"stream state over {stream.n_base} x {stream.delta.d} "
                f"does not match the index's {tuple(self.X.shape)}")
        with self.lock:
            self.stream = stream if stream.dirty else None
            if self.stream is None:
                self.plane.clear_stream()
            else:
                self._push_stream()

    def compact(self, *, tile: int = 2048) -> np.ndarray:
        """Fold streamed mutations into a fresh generation
        (:func:`repro_torch.ann.compaction.compact`); returns the old->new
        id map."""
        from repro_torch.ann.compaction import compact
        return compact(self, tile=tile)
