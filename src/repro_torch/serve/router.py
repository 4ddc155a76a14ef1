"""Request router — serving across replica endpoints (the reference's
``serve/router.py``, host Python).

:class:`Router` is one front door over N serving endpoints, each an
engine behind its own micro-batching queue
(:class:`~repro_torch.serve.queue.MicroBatcher`):

* **replicated** mode — every endpoint holds the SAME index; each request is
  dispatched to one healthy replica (``least_loaded`` by in-flight count, or
  ``round_robin``).  Replicas created by :func:`replicate_engine` share the
  donor engine's execution plane *and* its cache of captured graphs (and
  its lock: one graph's static buffers serve one replay at a time), so a
  warmed-up donor makes every replica start steady-state, and answers are
  bit for bit the donor's.
* **sharded** mode — one logical index split row-contiguously across the
  endpoints (:func:`shard_engines`); each request fans out to every shard,
  per-shard top-k are mapped to global ids and merged with
  :func:`repro_torch.core.distributed.merge_shard_results` — the host-side
  counterpart of the mesh plane's ``merge_topk``, so a router over P equal
  shards answers as a P-DB-shard mesh plane over the concatenated corpus
  does, bit for bit.  The shards' engines sit on one device here.

**Robustness** (the eject/readmit state machine): a dispatch
failure — or a periodic health probe that errors or times out — ejects the
replica (``healthy=False``); in replicated mode the failed request retries
on a healthy peer with bounded exponential backoff (``max_retries``,
``backoff_s``) so a replica killed under live traffic loses ZERO futures.
In sharded mode a dead shard has no peer holding its rows: after bounded
same-shard retries the request fails with :class:`PartialResultError`
carrying the surviving shards' merged top-k.  An ejected replica is
readmitted after ``readmit_probes`` consecutive successful probes.

:class:`RouterStats` aggregates the per-replica
:class:`~repro_torch.serve.engine.ServeStats` (compiles, regimes, latency
percentiles) and :class:`~repro_torch.serve.queue.BatcherStats` (expired
deadlines) plus the router's own counters (dispatches, retries, ejects,
readmits, lost futures) into one ``Router.snapshot()`` dict.

Wire-up is the facade: ``Index.serve(router=RouterConfig(...))`` or a
spec ``"replicated:N"`` / ``"sharded:N"``.  Endpoints are in-process
:class:`~repro_torch.serve.engine.ANNEngine` instances here — the seam a
real deployment replaces with RPC stubs is exactly
:class:`EngineEndpoint`'s four methods (submit/stats/kill/close).
"""
from __future__ import annotations

import dataclasses
import difflib
import itertools
import threading
from concurrent.futures import Future

import numpy as np

from repro_torch.serve.queue import DeadlineExceeded, MicroBatcher

ROUTER_MODES = ("replicated", "sharded")
ROUTER_POLICIES = ("least_loaded", "round_robin")

# exceptions that mean the REQUEST is wrong (propagate to the caller, never
# retried) — everything else means the REPLICA failed (eject + fail over)
_USER_ERRORS = (ValueError, TypeError, KeyError, DeadlineExceeded)


class ReplicaDead(RuntimeError):
    """The endpoint is down (killed, or its queue is closed)."""


class NoHealthyReplicas(RuntimeError):
    """Every endpoint is ejected; nothing can serve the request."""


class PartialResultError(RuntimeError):
    """Sharded-mode request lost one or more shards after bounded retries.

    Carries the *surviving* shards' merged top-k (``ids``/``dists``, shaped
    like a successful answer, global ids with ``PAD_ID`` padding) so callers
    that prefer partial recall over an error can still use it, plus the
    names of the ``failed`` and ``survivors`` endpoints."""

    def __init__(self, msg, *, ids, dists, failed, survivors):
        super().__init__(msg)
        self.ids = ids
        self.dists = dists
        self.failed = tuple(failed)
        self.survivors = tuple(survivors)


def _unknown(value, known, what: str) -> str:
    """get_arch-style did-you-mean message for an unknown option value."""
    close = difflib.get_close_matches(str(value), known, n=3, cutoff=0.5)
    hint = ""
    if close:
        hint = "; did you mean " + " or ".join(repr(c) for c in close) + "?"
    return f"unknown {what} {value!r}{hint} (known: {', '.join(known)})"


@dataclasses.dataclass(frozen=True)
class RouterConfig:
    """Topology + robustness knobs for :class:`Router` (and the facade's
    ``Index.serve(router=...)``).

    ``replicas`` is the endpoint count N of ``replicated:N`` /
    ``sharded:N``; ``endpoint_names`` optionally names them.
    ``health_interval_s=0`` disables the probe thread (dispatch failures
    still eject)."""

    mode: str = "replicated"
    replicas: int = 2
    policy: str = "least_loaded"          # replicated dispatch policy
    health_interval_s: float = 1.0        # probe period; 0 disables probing
    probe_timeout_s: float = 30.0         # probe answer deadline -> eject
    max_retries: int = 2                  # failovers per request
    backoff_s: float = 0.02               # retry delay, scaled by attempt
    readmit_probes: int = 1               # consecutive OK probes to readmit
    endpoint_names: tuple = ()

    def __post_init__(self):
        if self.mode not in ROUTER_MODES:
            raise ValueError(_unknown(self.mode, ROUTER_MODES,
                                      "router mode"))
        if self.policy not in ROUTER_POLICIES:
            raise ValueError(_unknown(self.policy, ROUTER_POLICIES,
                                      "router policy"))
        if not isinstance(self.replicas, int) or self.replicas < 1:
            raise ValueError(f"replicas must be a positive int, "
                             f"got {self.replicas!r}")
        if self.max_retries < 0 or self.backoff_s < 0:
            raise ValueError("max_retries and backoff_s must be >= 0")
        if self.health_interval_s < 0 or self.probe_timeout_s <= 0:
            raise ValueError("health_interval_s must be >= 0 and "
                             "probe_timeout_s > 0")
        if self.readmit_probes < 1:
            raise ValueError("readmit_probes must be >= 1")
        if self.endpoint_names and len(self.endpoint_names) != self.replicas:
            raise ValueError(
                f"endpoint_names has {len(self.endpoint_names)} entries "
                f"for {self.replicas} replicas")


def parse_router_spec(spec: str, **overrides) -> RouterConfig:
    """``"replicated:3"`` / ``"sharded:2"`` -> :class:`RouterConfig`, with
    a did-you-mean on an unknown mode."""
    mode, sep, n = spec.partition(":")
    if mode not in ROUTER_MODES:
        raise ValueError(_unknown(mode, ROUTER_MODES, "router mode")
                         + "; expected MODE:N, e.g. replicated:3")
    if not sep or not n.isdigit() or int(n) < 1:
        raise ValueError(f"router spec {spec!r} must be MODE:N with N a "
                         "positive int, e.g. replicated:3 or sharded:2")
    return RouterConfig(mode=mode, replicas=int(n), **overrides)


# ==========================================================================
# endpoints
# ==========================================================================

class _EngineProxy:
    """The queue-facing view of a replica's engine, with a failure switch.

    :meth:`EngineEndpoint.kill` flips the switch, after which every
    dispatch — including requests already coalesced into the victim's
    queue — fails with the injected exception, exactly like a process
    dying mid-batch.  The micro-batcher only touches ``cfg``, ``X`` and
    ``query``, so this is the whole surface."""

    def __init__(self, engine, owner: "EngineEndpoint"):
        self._engine = engine
        self._owner = owner

    @property
    def cfg(self):
        return self._engine.cfg

    @property
    def X(self):
        return self._engine.X

    def query(self, Q, *, k=None):
        dead = self._owner._dead
        if dead is not None:
            raise dead
        return self._engine.query(Q, k=k)


class EngineEndpoint:
    """One replica: an engine behind its own micro-batching
    queue.  ``id_offset``/``n_rows`` place a sharded endpoint's local ids in
    the global corpus (0/N for replicated endpoints).  This class is the
    RPC seam — a remote replica implements the same submit/stats/close."""

    def __init__(self, engine, *, name: str, id_offset: int = 0,
                 queue_kw: dict | None = None):
        self.engine = engine
        self.name = name
        self.id_offset = int(id_offset)
        self.n_rows = int(engine.X.shape[0])
        self._dead: Exception | None = None
        self.batcher = MicroBatcher(_EngineProxy(engine, self),
                                    **(queue_kw or {}))

    def submit(self, Q, *, k=None, deadline_ms=None) -> Future:
        """Enqueue one request; failures (including a killed endpoint)
        surface through the returned future, never synchronously — the
        router's retry path handles both uniformly."""
        dead = self._dead
        if dead is None:
            try:
                return self.batcher.submit(Q, k=k, deadline_ms=deadline_ms)
            except _USER_ERRORS:
                raise                     # malformed request: caller's bug
            except Exception as e:        # closed queue etc: replica fault
                dead = ReplicaDead(f"replica {self.name!r}: {e}")
        fut: Future = Future()
        fut.set_exception(dead)
        return fut

    # -- simulated failure (tests, CI, chaos drills) -------------------------

    def kill(self, exc: Exception | None = None) -> None:
        """Simulate the replica dying: every subsequent dispatch — even
        requests already sitting in its queue — fails until :meth:`revive`."""
        self._dead = exc or ReplicaDead(f"replica {self.name!r} killed")

    def revive(self) -> None:
        self._dead = None

    @property
    def alive(self) -> bool:
        return self._dead is None

    def stats(self) -> dict:
        """Engine + queue counters for this replica (one consistent view
        of each; the router's :meth:`Router.snapshot` aggregates these)."""
        with self.engine.lock:
            engine = self.engine.stats.snapshot()
        return {"engine": engine, "queue": self.batcher.stats.snapshot()}

    def close(self) -> None:
        self.batcher.close()


def replicate_engine(engine, n: int, *, names=(), queue_kw=None) -> list:
    """N serving replicas of one engine for the replicated router: each
    shares the donor's execution plane (the same device buffers — no extra
    residency) AND its cache of captured graphs and its lock (a warmed-up
    donor means every replica starts steady-state), with its own
    ServeStats and micro-batcher.  Answers are the donor's bit for bit."""
    from repro_torch.serve.engine import ANNEngine

    if n < 1:
        raise ValueError(f"need at least one replica, got {n}")
    if names and len(names) != n:
        raise ValueError(f"{len(names)} names for {n} replicas")
    endpoints = []
    for i in range(n):
        rep = ANNEngine(None, engine.cfg, k=engine.k, plane=engine.plane,
                        threshold=engine.threshold, cache_from=engine)
        endpoints.append(EngineEndpoint(
            rep, name=names[i] if names else f"r{i}", queue_kw=queue_kw))
    return endpoints


def shard_engines(X, cfg, *, shards: int, k: int = 10, threshold=None,
                  names=(), queue_kw=None, device=None) -> list:
    """Split ``X`` into ``shards`` contiguous equal row slices and build one
    single-device engine per slice on ``device`` (default: the CUDA
    device) — the sharded router's endpoints.  The equal cut mirrors the
    mesh plane's row sharding, and each sub-index build is the same
    ``build_graph`` a mesh shard runs on the same rows, so the fanned-out
    and merged answers are a P-DB-shard mesh plane's, bit for bit."""
    from repro_torch.serve.engine import ANNEngine

    X = np.asarray(X, np.float32)
    n = X.shape[0]
    if shards < 1:
        raise ValueError(f"need at least one shard, got {shards}")
    if n % shards:
        raise ValueError(
            f"N={n} rows do not split evenly into {shards} shards (the "
            "sharded router mirrors the mesh plane's equal row cut)")
    if names and len(names) != shards:
        raise ValueError(f"{len(names)} names for {shards} shards")
    per = n // shards
    endpoints = []
    for i in range(shards):
        eng = ANNEngine(X[i * per:(i + 1) * per], cfg, k=k,
                        threshold=threshold, device=device)
        endpoints.append(EngineEndpoint(
            eng, name=names[i] if names else f"s{i}", id_offset=i * per,
            queue_kw=queue_kw))
    return endpoints


def _external_rows(index) -> np.ndarray:
    """The index's base rows in external order: a packed plane holds them
    in packed order (per shard on a mesh), and the shards must answer in
    external ids."""
    X = index.X.cpu().numpy()
    perm = index.graph.perm
    if perm is None:
        return X
    from repro_torch.ann.layout import unpack_rows

    return unpack_rows(X, perm.cpu().numpy(),
                       n_shards=getattr(index.plane, "n_db_shards", 1))


# ==========================================================================
# stats
# ==========================================================================

@dataclasses.dataclass
class RouterStats:
    """Router-level counters (one lock, same discipline as BatcherStats);
    :meth:`Router.snapshot` composes these with every replica's engine +
    queue stats into the aggregated view."""

    n_requests: int = 0
    n_dispatches: int = 0      # endpoint submits, retries included
    retries: int = 0           # failovers after a replica fault
    lost_futures: int = 0      # requests failed by replica faults (not
    #                            user errors / partials) after retries
    partial_results: int = 0   # sharded requests that lost >= 1 shard
    ejects: int = 0
    readmits: int = 0
    probes: int = 0
    probe_failures: int = 0
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def bump(self, field: str, by: int = 1) -> None:
        with self._lock:
            setattr(self, field, getattr(self, field) + by)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "n_requests": self.n_requests,
                "n_dispatches": self.n_dispatches,
                "retries": self.retries,
                "lost_futures": self.lost_futures,
                "partial_results": self.partial_results,
                "ejects": self.ejects,
                "readmits": self.readmits,
                "probes": self.probes,
                "probe_failures": self.probe_failures,
            }


class _Replica:
    """Router-side state for one endpoint (guarded by the router's lock)."""

    __slots__ = ("endpoint", "healthy", "inflight", "dispatches",
                 "failures", "ejects", "readmits", "ok_probes",
                 "last_error")

    def __init__(self, endpoint: EngineEndpoint):
        self.endpoint = endpoint
        self.healthy = True
        self.inflight = 0
        self.dispatches = 0
        self.failures = 0
        self.ejects = 0
        self.readmits = 0
        self.ok_probes = 0        # consecutive successes while ejected
        self.last_error = None

    @property
    def name(self) -> str:
        return self.endpoint.name


class _InFlight:
    """One routed request: the caller-facing future plus retry/fan-out
    bookkeeping.  ``lock`` guards the sharded accumulation; the ``done``
    flag makes completion idempotent (a user error can finish the request
    while other shards are still resolving)."""

    __slots__ = ("Q", "k", "deadline_ms", "single", "outer", "attempts",
                 "tried", "lock", "done", "results", "failed", "remaining")

    def __init__(self, Q, k, deadline_ms, single):
        self.Q = Q
        self.k = k
        self.deadline_ms = deadline_ms
        self.single = single
        self.outer: Future = Future()
        self.attempts = 0          # replicated failovers so far
        self.tried: set = set()    # replica names already failed
        self.lock = threading.Lock()
        self.done = False
        self.results: list = []    # sharded: per-shard (ids, dists) | None
        self.failed: dict = {}     # sharded: shard index -> exception
        self.remaining = 0


# ==========================================================================
# router
# ==========================================================================

class Router:
    """Dispatch queries across replica endpoints; see module docstring.

    ``submit()`` mirrors the micro-batcher's API (vector or batch, ``k=``,
    ``deadline_ms=``, a Future resolving to (ids, dists)); ``query()`` is
    the synchronous convenience.  Use as a context manager — ``close()``
    waits for in-flight requests, stops the prober, and drains every
    replica's queue."""

    def __init__(self, endpoints, cfg: RouterConfig | None = None):
        self.cfg = cfg or RouterConfig(replicas=len(endpoints))
        if not endpoints:
            raise ValueError("router needs at least one endpoint")
        if len(endpoints) != self.cfg.replicas:
            raise ValueError(f"RouterConfig.replicas={self.cfg.replicas} "
                             f"but {len(endpoints)} endpoints given")
        names = [e.name for e in endpoints]
        if len(set(names)) != len(names):
            raise ValueError(f"endpoint names must be unique, got {names}")
        dims = {int(e.engine.X.shape[1]) for e in endpoints}
        if len(dims) != 1:
            raise ValueError(f"endpoints disagree on vector dim: {dims}")
        self.d = dims.pop()
        self.k = endpoints[0].engine.k
        self._replicas = [_Replica(e) for e in endpoints]
        self.stats = RouterStats()
        self._lock = threading.Lock()
        self._rr = itertools.count()      # round-robin cursor
        self._closed = False
        self._close_done = threading.Event()
        # in-flight request tracking so close() can drain
        self._n_inflight = 0
        self._idle = threading.Event()
        self._idle.set()
        self._probe_Q = np.zeros((1, self.d), np.float32)
        self._stop = threading.Event()
        self._prober = None
        if self.cfg.health_interval_s > 0:
            self._prober = threading.Thread(
                target=self._probe_loop, daemon=True, name="repro-router-hc")
            self._prober.start()

    @classmethod
    def for_index(cls, index, cfg: RouterConfig, **queue_kw) -> "Router":
        """The facade constructor behind ``Index.serve(router=...)``:
        replicated mode replicates the index's engine (shared plane and
        cache); sharded mode splits the index's corpus, in external row
        order, into ``cfg.replicas`` contiguous slices and builds one
        sub-index per slice on the index's device (a rebuild — capacity
        scaling, not a free view)."""
        qkw = queue_kw or None
        if cfg.mode == "replicated":
            eps = replicate_engine(index.engine, cfg.replicas,
                                   names=cfg.endpoint_names, queue_kw=qkw)
        else:
            eps = shard_engines(_external_rows(index), index.cfg,
                                shards=cfg.replicas, k=index.k,
                                threshold=index.engine.threshold,
                                names=cfg.endpoint_names, queue_kw=qkw,
                                device=index.device)
        return cls(eps, cfg)

    @property
    def endpoints(self) -> tuple:
        return tuple(r.endpoint for r in self._replicas)

    def healthy_replicas(self) -> tuple:
        with self._lock:
            return tuple(r.name for r in self._replicas if r.healthy)

    # -- client side ---------------------------------------------------------

    def submit(self, Q, *, k: int | None = None,
               deadline_ms: float | None = None) -> Future:
        """Route one request; `Q` is a single vector [d] or a batch [b, d].
        Returns a Future resolving to (ids, dists) shaped to the input
        rank.  Replica faults are retried/failed over per the config;
        malformed requests raise here, synchronously."""
        Q = np.asarray(Q, np.float32)
        single = Q.ndim == 1
        if single:
            Q = Q[None]
        if Q.ndim != 2 or Q.shape[0] == 0 or Q.shape[1] != self.d:
            raise ValueError(f"Q must be [{self.d}] or [b, {self.d}], "
                             f"got {Q.shape}")
        with self._lock:
            if self._closed:
                raise RuntimeError("Router is closed")
            self._n_inflight += 1
            self._idle.clear()
        self.stats.bump("n_requests")
        st = _InFlight(Q, k, deadline_ms, single)
        if self.cfg.mode == "replicated":
            self._dispatch(st)
        else:
            self._dispatch_sharded(st)
        return st.outer

    def query(self, Q, *, k: int | None = None, timeout: float | None = 60):
        """Synchronous convenience: ``submit(...).result(timeout)``."""
        return self.submit(Q, k=k).result(timeout=timeout)

    def close(self, *, drain: bool = True) -> None:
        """Stop probing, wait for in-flight requests (``drain=True``), and
        close every replica's queue.  Idempotent: concurrent/second calls
        wait for the first to finish."""
        with self._lock:
            first = not self._closed
            self._closed = True
        if not first:
            self._close_done.wait()
            return
        try:
            self._stop.set()
            if self._prober is not None:
                self._prober.join(timeout=60)
            if drain:
                # every accepted request either resolves or fails over on a
                # bounded schedule, so this terminates
                self._idle.wait(timeout=600)
            for rep in self._replicas:
                rep.endpoint.close()
        finally:
            self._close_done.set()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- request completion ---------------------------------------------------

    def _finish(self, st: _InFlight, result=None, exc=None) -> None:
        with st.lock:
            if st.done:
                return
            st.done = True
        if exc is not None:
            st.outer.set_exception(exc)
        else:
            ids, dists = result
            if st.single:
                ids, dists = ids[0], dists[0]
            st.outer.set_result((ids, dists))
        with self._lock:
            self._n_inflight -= 1
            if self._n_inflight == 0:
                self._idle.set()

    # -- replicated dispatch ---------------------------------------------------

    def _pick(self, exclude: set):
        """A healthy replica not in ``exclude`` (falling back to any healthy
        one), per the configured policy; None when all are ejected."""
        with self._lock:
            healthy = [r for r in self._replicas if r.healthy]
            pool = [r for r in healthy if r.name not in exclude] or healthy
            if not pool:
                return None
            if self.cfg.policy == "round_robin":
                return pool[next(self._rr) % len(pool)]
            return min(pool, key=lambda r: r.inflight)

    def _dispatch(self, st: _InFlight) -> None:
        rep = self._pick(st.tried)
        if rep is None:
            self.stats.bump("lost_futures")
            self._finish(st, exc=NoHealthyReplicas(
                f"all {len(self._replicas)} replicas are ejected"))
            return
        with self._lock:
            rep.inflight += 1
            rep.dispatches += 1
        self.stats.bump("n_dispatches")
        fut = rep.endpoint.submit(st.Q, k=st.k, deadline_ms=st.deadline_ms)
        fut.add_done_callback(
            lambda f, rep=rep: self._on_replicated_done(st, rep, f))

    def _on_replicated_done(self, st: _InFlight, rep: _Replica, fut) -> None:
        with self._lock:
            rep.inflight -= 1
        exc = fut.exception()
        if exc is None:
            self._finish(st, result=fut.result())
            return
        if isinstance(exc, _USER_ERRORS):
            self._finish(st, exc=exc)      # the request's fault: no retry
            return
        self._eject(rep, exc)
        st.tried.add(rep.name)
        st.attempts += 1
        if st.attempts > self.cfg.max_retries:
            self.stats.bump("lost_futures")
            self._finish(st, exc=exc)
            return
        self.stats.bump("retries")
        self._later(self.cfg.backoff_s * st.attempts, self._dispatch, st)

    def _later(self, delay: float, fn, *args) -> None:
        if delay <= 0:
            fn(*args)
            return
        t = threading.Timer(delay, fn, args=args)
        t.daemon = True
        t.start()

    # -- sharded dispatch -------------------------------------------------------

    def _dispatch_sharded(self, st: _InFlight) -> None:
        reps = self._replicas
        st.results = [None] * len(reps)
        st.remaining = len(reps)
        for i, rep in enumerate(reps):
            self._submit_shard(st, i, rep, attempt=0)

    def _submit_shard(self, st: _InFlight, i: int, rep: _Replica,
                      attempt: int) -> None:
        with self._lock:
            healthy = rep.healthy
            if healthy:
                rep.inflight += 1
                rep.dispatches += 1
        if not healthy and attempt == 0:
            # known-dead shard: fail its slot immediately, don't burn the
            # whole retry budget discovering what the prober already knows
            self._shard_failed(st, i, rep, ReplicaDead(
                f"shard {rep.name!r} is ejected"), self.cfg.max_retries)
            return
        if not healthy:
            # mid-retry eject (e.g. by the prober): one attempt to come back
            with self._lock:
                rep.inflight += 1
                rep.dispatches += 1
        self.stats.bump("n_dispatches")
        fut = rep.endpoint.submit(st.Q, k=st.k, deadline_ms=st.deadline_ms)
        fut.add_done_callback(
            lambda f, i=i, rep=rep, attempt=attempt:
            self._on_shard_done(st, i, rep, attempt, f))

    def _on_shard_done(self, st: _InFlight, i: int, rep: _Replica,
                       attempt: int, fut) -> None:
        with self._lock:
            rep.inflight -= 1
        exc = fut.exception()
        if exc is None:
            with st.lock:
                st.results[i] = fut.result()
                st.remaining -= 1
                ready = st.remaining == 0
            if ready:
                self._merge_shards(st)
            return
        if isinstance(exc, _USER_ERRORS):
            self._finish(st, exc=exc)      # outer future fails once; other
            return                         # shards resolve into a done st
        self._eject(rep, exc)
        if attempt < self.cfg.max_retries:
            # a shard has no peer holding its rows: retry the SAME shard
            self.stats.bump("retries")
            self._later(self.cfg.backoff_s * (attempt + 1),
                        self._submit_shard, st, i, rep, attempt + 1)
            return
        self._shard_failed(st, i, rep, exc, attempt)

    def _shard_failed(self, st: _InFlight, i: int, rep: _Replica, exc,
                      attempt) -> None:
        with st.lock:
            st.failed[i] = exc
            st.remaining -= 1
            ready = st.remaining == 0
        if ready:
            self._merge_shards(st)

    def _merge_shards(self, st: _InFlight) -> None:
        from repro_torch.core.distributed import merge_shard_results

        with st.lock:
            if st.done:
                return
            results = list(st.results)
            failed = dict(st.failed)
        k = st.k if st.k is not None else self.k
        reps = self._replicas
        survivors = [i for i in range(len(reps)) if results[i] is not None]
        pools = [results[i] for i in survivors]
        offsets = [reps[i].endpoint.id_offset for i in survivors]
        n_rows = [reps[i].endpoint.n_rows for i in survivors]
        B = st.Q.shape[0]
        try:
            ids, dists = merge_shard_results(pools, offsets, n_rows,
                                             k=k, batch=B)
        except Exception as e:  # noqa: BLE001 — deliver, don't die
            self._finish(st, exc=e)
            return
        if failed:
            self.stats.bump("partial_results")
            if st.single:
                ids, dists = ids[0], dists[0]
            names = lambda idx: tuple(reps[i].name for i in idx)  # noqa: E731
            self._finish(st, exc=PartialResultError(
                f"{len(failed)}/{len(reps)} shards failed after "
                f"{self.cfg.max_retries} retries "
                f"({', '.join(sorted(names(failed)))}); carrying the "
                "surviving shards' merged top-k",
                ids=ids, dists=dists,
                failed=names(sorted(failed)), survivors=names(survivors)))
            return
        self._finish(st, result=(ids, dists))

    # -- health: eject / probe / readmit -----------------------------------------

    def _eject(self, rep: _Replica, exc) -> None:
        with self._lock:
            rep.failures += 1
            rep.last_error = repr(exc)
            if not rep.healthy:
                return
            rep.healthy = False
            rep.ejects += 1
            rep.ok_probes = 0
        self.stats.bump("ejects")

    def _readmit(self, rep: _Replica) -> None:
        with self._lock:
            if rep.healthy:
                return
            rep.healthy = True
            rep.ok_probes = 0
        self.stats.bump("readmits")

    def _probe(self, rep: _Replica) -> bool:
        self.stats.bump("probes")
        try:
            fut = rep.endpoint.submit(self._probe_Q, k=self.k)
            fut.result(timeout=self.cfg.probe_timeout_s)
            return True
        except Exception as e:  # noqa: BLE001 — any failure ejects
            self.stats.bump("probe_failures")
            with self._lock:
                rep.last_error = repr(e)
            return False

    def _probe_loop(self) -> None:
        """Periodic health checks: a failed/timed-out probe ejects within
        one interval; ``readmit_probes`` consecutive successes readmit."""
        while not self._stop.wait(self.cfg.health_interval_s):
            for rep in self._replicas:
                if self._stop.is_set():
                    return
                ok = self._probe(rep)
                if rep.healthy:
                    if not ok:
                        self._eject(rep, ReplicaDead(
                            f"health probe failed for {rep.name!r}"))
                    continue
                with self._lock:
                    rep.ok_probes = rep.ok_probes + 1 if ok else 0
                    ready = rep.ok_probes >= self.cfg.readmit_probes
                if ready:
                    self._readmit(rep)

    # -- aggregated stats ----------------------------------------------------------

    def snapshot(self) -> dict:
        """One aggregated view: router counters, per-replica health +
        engine/queue stats, and cross-replica aggregates (summed counters;
        latency percentiles over the MERGED per-regime windows, not an
        average of per-replica percentiles)."""
        with self._lock:
            states = [(r, r.healthy, r.inflight, r.dispatches, r.failures,
                       r.ejects, r.readmits, r.last_error)
                      for r in self._replicas]
        replicas = {}
        agg = {"n_queries": 0, "n_batches": 0, "small_batches": 0,
               "large_batches": 0, "compiles": 0, "aot_primed": 0,
               "expired": 0, "qps": 0.0}
        windows = {"small": [], "large": []}
        for (rep, healthy, inflight, dispatches, failures, ejects,
             readmits, last_error) in states:
            eng = rep.endpoint.engine
            with eng.lock:
                e = eng.stats.snapshot()
                for regime, reg in eng.stats.per_regime.items():
                    windows[regime].extend(reg.latencies_s)
            q = rep.endpoint.batcher.stats.snapshot()
            replicas[rep.name] = {
                "healthy": healthy, "inflight": inflight,
                "dispatches": dispatches, "failures": failures,
                "ejects": ejects, "readmits": readmits,
                "last_error": last_error, "engine": e, "queue": q,
            }
            for key in ("n_queries", "n_batches", "small_batches",
                        "large_batches", "compiles", "aot_primed"):
                agg[key] += e[key]
            agg["qps"] += e["qps"]
            agg["expired"] += q["expired"]
        for regime, window in windows.items():
            arr = np.asarray(window) if window else np.asarray([np.nan])
            for p in (50, 90, 99):
                agg[f"{regime}_p{p}_ms"] = float(
                    np.nanpercentile(arr, p)) * 1e3 if window else float(
                    "nan")
        agg["healthy_replicas"] = sum(1 for s in states if s[1])
        agg["n_replicas"] = len(states)
        return {"mode": self.cfg.mode, "router": self.stats.snapshot(),
                "replicas": replicas, "aggregate": agg}
