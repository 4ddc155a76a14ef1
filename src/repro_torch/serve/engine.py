"""In-process serving (the reference's ``serve/engine.py::ANNEngine``):
regime dispatch, the shape-bucket ladder with edge padding, the cache of
one callable per (regime, bucket, k), warmup, the serving counters, and
streaming mutability — ``add`` / ``delete`` into a host-side mutation log
published to the plane, and ``compact`` into a fresh generation.

On the card each cache entry is a CUDA graph captured from the hand
kernels' launches (:class:`~repro_torch.serve.plane.CapturedSearch`): a
batch is staged through a pinned host buffer, copied into the graph's
static query buffer, replayed, and its answer copied back off the static
outputs.  On the CPU an entry is the eager search; the engine is the same
code.  A capture that fails raises: the engine never answers eagerly on
the card instead.

The engine sits on an execution plane: a :class:`~repro_torch.serve.
plane.SingleDevicePlane` by default, a :class:`~repro_torch.serve.plane.
MeshPlane` with ``mesh=`` (one sub-index per DB shard of the grid), or any
prebuilt plane with ``plane=``.  ``cache_from=`` makes a serving replica
of another engine over the same plane: it shares the donor's cache and
its lock (:mod:`repro_torch.serve.router`).

The regime split is ``cfg.small_batch_threshold``, or ``threshold=``, or,
with ``cfg.regime_calibration="probe"``, a threshold fitted from timed
probe batches at init (:func:`repro_torch.ann.dispatch.calibrate`).

One lock serialises queries and mutations, so a query sees one generation
and one stream state from start to end, and the graphs, which share one
memory pool, replay one at a time on one stream, each answer read before
the next replay.  Replicas over one plane share that lock: a graph's
static buffers are one set, whichever engine replays it.
"""
from __future__ import annotations

import collections
import dataclasses
import threading
import time

import numpy as np
import torch

from repro_torch.ann.delta import StreamState
from repro_torch.ann.dispatch import calibrate, regime_for
from repro_torch.configs.base import ANNConfig
from repro_torch.device import resolve_device
from repro_torch.serve.plane import (SMALL_WIDTH, MeshPlane,
                                     SingleDevicePlane, StaleGeneration)


@dataclasses.dataclass
class RegimeStats:
    """Latency/throughput record for one regime, warmup split out."""

    n_batches: int = 0
    n_queries: int = 0
    total_s: float = 0.0            # steady-state wall time
    warmup_batches: int = 0
    warmup_s: float = 0.0           # capture-triggering calls (excluded)
    # bounded window of recent batch latencies; totals cover the history
    latencies_s: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=8192))

    def record(self, n: int, dt: float, *, warmup: bool) -> None:
        if warmup:
            self.warmup_batches += 1
            self.warmup_s += dt
            return
        self.n_batches += 1
        self.n_queries += n
        self.total_s += dt
        self.latencies_s.append(dt)

    def percentiles(self, qs=(50, 90, 99)) -> dict:
        if not self.latencies_s:
            return {f"p{q}": float("nan") for q in qs}
        arr = np.asarray(self.latencies_s)
        return {f"p{q}": float(np.percentile(arr, q)) for q in qs}

    def histogram(self, bins: int = 16):
        """(counts, edges_s) over steady-state batch latencies."""
        if not self.latencies_s:
            return np.zeros((bins,), np.int64), np.zeros((bins + 1,))
        return np.histogram(np.asarray(self.latencies_s), bins=bins)


@dataclasses.dataclass
class ServeStats:
    n_queries: int = 0              # all queries, warmup included
    n_batches: int = 0
    small_batches: int = 0
    large_batches: int = 0
    total_s: float = 0.0            # steady-state wall time (both regimes)
    steady_queries: int = 0
    compiles: int = 0               # cache entries made (graphs captured)
    aot_primed: int = 0             # entries restored from a saved index
    bucket_hits: int = 0            # calls served by a cached entry
    bucket_misses: int = 0          # calls that had to make one
    padded_queries: int = 0         # rows added by bucketing
    generation: int = 0             # completed compactions since build
    n_added: int = 0                # vectors appended via add()
    n_deleted: int = 0              # ids tombstoned via delete()
    compactions: int = 0
    stream_batches: int = 0         # batches answered with stream state
    # host batches moved through the plane's pinned staging buffers, and
    # how many found their buffer already made
    h2d_staged: int = 0
    h2d_stage_reuses: int = 0
    per_regime: dict = dataclasses.field(
        default_factory=lambda: {"small": RegimeStats(),
                                 "large": RegimeStats()})

    @property
    def qps(self) -> float:
        """Steady-state queries/s — warmup (capture) batches excluded."""
        return self.steady_queries / max(self.total_s, 1e-9)

    @property
    def bucket_hit_rate(self) -> float:
        total = self.bucket_hits + self.bucket_misses
        return self.bucket_hits / max(total, 1)

    def snapshot(self) -> dict:
        out = {
            "n_queries": self.n_queries, "n_batches": self.n_batches,
            "small_batches": self.small_batches,
            "large_batches": self.large_batches,
            "qps": self.qps, "compiles": self.compiles,
            "aot_primed": self.aot_primed,
            "bucket_hit_rate": self.bucket_hit_rate,
            "padded_queries": self.padded_queries,
            "generation": self.generation, "n_added": self.n_added,
            "n_deleted": self.n_deleted, "compactions": self.compactions,
            "stream_batches": self.stream_batches,
            "h2d_staged": self.h2d_staged,
            "h2d_stage_reuses": self.h2d_stage_reuses,
        }
        for name, reg in self.per_regime.items():
            for key, val in reg.percentiles().items():
                out[f"{name}_{key}_ms"] = val * 1e3
        return out


class ANNEngine:
    """Build once (or take a graph or a plane), answer batches of queries.

    ``mesh=`` builds a :class:`~repro_torch.serve.plane.MeshPlane` over
    the grid (on the grid's device); ``plane=`` takes a prebuilt plane.
    ``cache_from=`` (an engine over the same ``plane=``) shares that
    engine's cache and lock; stats stay per engine.  ``threshold=``
    overrides the regime split (the same ``B·t0 < 4·threshold`` rule as
    ``cfg.small_batch_threshold``); with ``cfg.regime_calibration="probe"``
    and no override the threshold is fitted at init and recorded in
    ``self.calibration``."""

    def __init__(self, X, cfg: ANNConfig | None = None, *, k: int = 10,
                 graph=None, quant=None, device=None, mesh=None, plane=None,
                 threshold: float | None = None, cache_from=None,
                 packed: bool = False):
        self.cfg = cfg or ANNConfig()
        self.k = k
        self.stats = ServeStats()
        self.buckets = tuple(sorted(self.cfg.serve_buckets))
        if plane is not None:
            if mesh is not None or graph is not None or quant is not None:
                raise ValueError("plane= already fixes the device layout; "
                                 "mesh=/graph=/quant= only apply when the "
                                 "engine builds its own plane")
            self.plane = plane
        elif mesh is not None:
            if graph is not None or quant is not None or packed:
                raise ValueError("mesh mode builds its own sharded graph "
                                 "(and codes); graph=/quant=/packed= are "
                                 "only for single-device engines")
            self.plane = MeshPlane(X, self.cfg, mesh)
        else:
            self.plane = SingleDevicePlane(X, self.cfg, graph=graph,
                                           quant=quant, device=device,
                                           packed=packed)
        if device is not None and resolve_device(device) != self.device:
            raise ValueError(f"device={device} but the plane is on "
                             f"{self.device}")
        self.mesh = getattr(self.plane, "mesh", None)
        self.stream: StreamState | None = None  # the host mutation log
        self.lock = threading.RLock()
        # (regime, bucket, k, backend, quantization, shape token,
        #  stream token) -> callable
        self._compiled: dict = {}
        if cache_from is not None:
            # a serving replica (serve/router.py): the entries bind to the
            # plane's buffers, and one lock keeps two engines from
            # replaying one graph's static buffers at once
            if cache_from.plane is not self.plane:
                raise ValueError(
                    "cache_from shares captured graphs, which bind to the "
                    "plane's operand buffers; it requires plane= set to "
                    "the donor's own plane")
            self._compiled = cache_from._compiled
            self.lock = cache_from.lock
        self.calibration = None
        self.threshold = threshold
        if threshold is None and self.cfg.regime_calibration == "probe":
            self.calibration = calibrate(self.plane, self.cfg, k=k)
            self.threshold = self.calibration.threshold

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
        """Paper §4's split (the calibrated or given threshold where there
        is one); a live delta shard adds its brute-force population (every
        query scores every live delta row)."""
        return regime_for(self.cfg, batch, threshold=self.threshold,
                          n_delta=self._n_delta())

    def _n_delta(self) -> int:
        stream = self.stream
        return 0 if stream is None else stream.delta.n_alive()

    def bucket_for(self, batch: int) -> int:
        """Smallest ladder bucket >= batch; beyond the ladder, the next
        multiple of the largest bucket.  No ladder -> the raw batch.
        Rounded up to the plane's batch multiple."""
        if not self.buckets:
            bucket = batch
        else:
            bucket = next((b for b in self.buckets if b >= batch), None)
            if bucket is None:
                top = self.buckets[-1]
                bucket = -(-batch // top) * top
        s = self.plane.batch_multiple()
        return -(-bucket // s) * s

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

    # -- the cache ------------------------------------------------------------

    def _get_executable(self, kind: str, bucket: int, k: int,
                        streaming: bool = False):
        """The cached callable for (regime, bucket, k, backend,
        quantization, shape token, stream token); the plane makes it on a
        miss (on the card: captures a graph).  A same-shape generation swap
        keeps the shape token, so every entry stays valid; the stream
        token moves only with the delta's capacity.  Returns (callable,
        made_now).  The caller holds the lock."""
        stream_tok = self.plane.stream_token() if streaming else None
        key = (kind, bucket, k, self.backend, self.cfg.quantization,
               self.plane.shape_token(), stream_tok)
        hit = self._compiled.get(key)
        if hit is not None:
            return hit, False
        make = self.plane.compile_stream if streaming else self.plane.compile
        exe = self._compiled[key] = make(kind, bucket, k)
        self.stats.compiles += 1
        return exe, True

    def _prune_stale_entries(self) -> None:
        """Drop entries bound to superseded operand buffers: their shape
        token never matches again, and they hold graph memory."""
        tok = self.plane.shape_token()
        with self.lock:
            for key in [key for key in self._compiled if key[5] != tok]:
                del self._compiled[key]

    # -- serving --------------------------------------------------------------

    @staticmethod
    def _check_numeric(dtype, what: str) -> None:
        bad = (dtype.is_complex or dtype == torch.bool
               if isinstance(dtype, torch.dtype)
               else np.dtype(dtype).kind not in "fiu")
        if bad:
            raise ValueError(
                f"{what} must be numeric (float/int), got {dtype}")

    def query(self, Q, *, k: int | None = None):
        """Answer a batch: (ids [B, k], dists [B, k]) numpy arrays.  A
        host batch is padded on the host and staged through the plane's
        pinned buffer; a tensor is moved and padded on the device."""
        if isinstance(Q, torch.Tensor):
            self._check_numeric(Q.dtype, "Q")
            host, shape = None, tuple(Q.shape)
        else:
            host = np.asarray(Q)
            self._check_numeric(host.dtype, "Q")
            host = np.ascontiguousarray(host, np.float32)
            shape = host.shape
        d = self.X.shape[1]
        if len(shape) != 2 or shape[1] != d:
            raise ValueError(f"Q must be [B, {d}], got {shape}")
        B = shape[0]
        if B == 0:
            raise ValueError("empty query batch")
        with self.lock:
            kind = self.regime(B)
            k = self._validate_k(k, kind)
            bucket = self.bucket_for(B)
            if host is not None:  # edge padding: replicate the last row
                Qh = host if bucket == B else np.pad(
                    host, ((0, bucket - B), (0, 0)), mode="edge")
                Qpad = self.plane.stage_query(Qh)
            else:
                Qpad = Q.to(device=self.device, dtype=torch.float32)
                if bucket > B:
                    Qpad = torch.cat(
                        [Qpad, Qpad[-1:].expand(bucket - B, d)], dim=0)
            # a callable bound to a superseded generation raises
            # StaleGeneration: look it up again against the new token
            for _ in range(3):
                streaming = self.plane.stream_active
                exe, made_now = self._get_executable(kind, bucket, k,
                                                     streaming)
                t0 = time.perf_counter()
                try:
                    ids, dists = exe(Qpad)
                except StaleGeneration:
                    continue
                break
            else:
                raise RuntimeError(
                    "query kept meeting stale generations; the plane's "
                    "tokens moved under every dispatch")
            # off the static outputs before the next replay (and the lock)
            ids = ids[:B].cpu().numpy()
            dists = dists[:B].cpu().numpy()
            dt = time.perf_counter() - t0
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
            if host is not None:
                st.h2d_staged += 1
                st.h2d_stage_reuses = self.plane.stage_reuses
            if made_now:
                st.bucket_misses += 1
            else:
                st.bucket_hits += 1
                st.total_s += dt
                st.steady_queries += B
            st.per_regime[kind].record(B, dt, warmup=made_now)
        return ids, dists

    def warmup_probes(self) -> list:
        """``[(regime, bucket, probe_batch)]`` covering every (regime,
        ladder bucket) pair a real request can reach: each bucket at its
        smallest and largest mapped batch, since the regime boundary can
        fall inside its range."""
        probes, done, prev = [], set(), 0
        for b_raw in self.buckets or (1,):
            b = self.bucket_for(b_raw)
            for probe in (prev + 1, b_raw):
                pair = (self.regime(probe), b)
                if pair not in done:
                    done.add(pair)
                    probes.append((pair[0], b, probe))
            prev = b_raw
        return probes

    def warmup(self, k: int | None = None) -> int:
        """Make every reachable (regime, ladder bucket, k) entry so the
        first real request is steady-state.  Returns the number of fresh
        entries (graphs captured on the card)."""
        before = self.stats.compiles
        d = self.X.shape[1]
        for _, _, probe in self.warmup_probes():
            self.query(np.zeros((probe, d), np.float32), k=k)
        return self.stats.compiles - before

    # -- the reference's AOT cache: no CUDA-graph form ------------------------

    @staticmethod
    def _no_aot(what: str):
        return NotImplementedError(
            f"{what}: the port's cache entries are CUDA graphs, which bind "
            "device addresses and have no serialized form, so an artifact "
            "carries no executables; a loaded index captures its graphs at "
            "warmup() or on first use")

    def export_executable(self, kind: str, bucket: int, k: int | None = None):
        raise self._no_aot("export_executable")

    def aot_operands(self):
        raise self._no_aot("aot_operands")

    def prime_executable(self, kind: str, bucket: int, k: int, call):
        raise self._no_aot("prime_executable")

    # -- streaming mutability ----------------------------------------------

    def add(self, V) -> np.ndarray:
        """Append vectors to the delta shard; returns their global ids
        (``n_base + slot``, stable until the next :meth:`compact`).
        Accepts [m, d] or a single [d] vector; numeric dtypes are cast to
        float32."""
        V = torch.as_tensor(V)
        self._check_numeric(V.dtype, "vectors")
        V = V.to(torch.float32).cpu().numpy()
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
        return self.plane.n_rows if stream is None else stream.n_active()

    def _ensure_stream(self) -> StreamState:
        """Create the host-side mutation log on first use (caller holds
        the lock)."""
        if self.stream is None:
            self.stream = StreamState(
                self.plane.n_rows, int(self.X.shape[1]),
                min_cap=getattr(self.cfg, "delta_min_cap", 256))
        return self.stream

    def _push_stream(self) -> None:
        """Publish the mutation log into the plane's stream buffers (caller
        holds the lock).  One host copy of the delta shard per mutation,
        never per query."""
        self.plane.set_stream(*self.stream.device_view())

    def restore_stream(self, base_alive, delta_X, delta_alive,
                       count: int | None = None) -> None:
        """Attach mutation state carried in from numpy.  With ``count``,
        the delta arrays are capacity-padded, as the reference's
        ``device_view()`` gives them
        (:func:`repro_torch.ann.convert.stream_from_numpy`); without, they
        hold only the assigned slots, as an artifact stores them
        (:meth:`repro_torch.ann.delta.StreamState.restore`)."""
        from repro_torch.ann.convert import stream_from_numpy

        if count is None:
            stream = StreamState.restore(
                base_alive, delta_X, delta_alive,
                min_cap=getattr(self.cfg, "delta_min_cap", 256))
        else:
            stream = stream_from_numpy(base_alive, delta_X, delta_alive,
                                       count)
        shape = (self.plane.n_rows, int(self.X.shape[1]))
        if (stream.n_base, stream.delta.d) != shape:
            raise ValueError(
                f"stream state over {stream.n_base} x {stream.delta.d} "
                f"does not match the index's {shape}")
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
