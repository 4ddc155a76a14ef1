"""Async micro-batching queue: coalesce concurrent requests into one dispatch
(the reference's ``serve/queue.py``, which is plain Python: a copy).

The GPU serving systems the paper competes with (CAGRA, GGNN) get their
throughput from request coalescing — many concurrent callers, one device
launch.  :class:`MicroBatcher` is a single dispatcher thread that drains a
submission queue, concatenates requests that share `k` into one batch (up
to ``max_batch`` queries, waiting at most ``max_wait`` for co-riders),
answers them with one ``engine.query()`` call, and resolves each caller's
:class:`~concurrent.futures.Future` with its own rows.  Coalesced singles
ride the engine's shape buckets, so steady-state traffic replays the
engine's captured CUDA graphs.

    engine = ANNEngine(X, cfg, k=10)
    with MicroBatcher(engine) as mb:
        futs = [mb.submit(q) for q in queries]       # from any thread(s)
        results = [f.result() for f in futs]         # (ids [k], dists [k])
"""
from __future__ import annotations

import collections
import dataclasses
import queue as _queue
import threading
import time
from concurrent.futures import Future

import numpy as np


class DeadlineExceeded(TimeoutError):
    """The request's ``deadline_ms`` elapsed before it was dispatched.

    Raised *through the future* (``Future.result()``), never out of
    ``submit``; the request consumed no bucket slot and no device time."""


@dataclasses.dataclass
class _Request:
    Q: np.ndarray          # [b, d] float32
    k: int | None
    single: bool           # caller passed a bare vector -> return [k] rows
    future: Future
    deadline: float | None = None   # absolute time.monotonic() cutoff


@dataclasses.dataclass
class BatcherStats:
    """Dispatch counters, mutated by the dispatcher thread and read by any
    caller thread — every access goes through ``_lock`` so readers never
    see a torn update (e.g. ``n_dispatches`` bumped before ``n_queries``).
    ``snapshot()`` returns one consistent view; the bare attributes remain
    readable for single-field checks."""

    n_requests: int = 0
    n_queries: int = 0
    n_dispatches: int = 0
    bypass: int = 0                 # dispatches that took the QoS bypass lane
    expired: int = 0                # requests failed with DeadlineExceeded
    # recent dispatch sizes only (bounded; the means use the counters)
    dispatch_sizes: collections.deque = dataclasses.field(
        default_factory=lambda: collections.deque(maxlen=8192))
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False, compare=False)

    def record_dispatch(self, n_requests: int, n_queries: int, *,
                        bypass: bool = False) -> None:
        with self._lock:
            self.n_requests += n_requests
            self.n_queries += n_queries
            self.n_dispatches += 1
            if bypass:
                self.bypass += 1
            self.dispatch_sizes.append(n_queries)

    def record_expired(self) -> None:
        with self._lock:
            self.expired += 1

    @property
    def mean_coalesced(self) -> float:
        with self._lock:
            return self.n_queries / max(self.n_dispatches, 1)

    def snapshot(self) -> dict:
        """One consistent view of every counter (all under one lock hold)."""
        with self._lock:
            return {
                "n_requests": self.n_requests,
                "n_queries": self.n_queries,
                "n_dispatches": self.n_dispatches,
                "bypass": self.bypass,
                "expired": self.expired,
                "mean_coalesced":
                    self.n_queries / max(self.n_dispatches, 1),
                "dispatch_sizes": tuple(self.dispatch_sizes),
            }


class MicroBatcher:
    """Coalesces concurrent `submit()`s into batched `engine.query()` calls.

    Requests with different `k` never share a dispatch (they need different
    cache entries); a `k` change flushes the in-flight group.  Errors from
    the engine propagate to every future of the failed dispatch.

    **QoS bypass lane** — a submit whose batch is already ``>= max_batch``
    gains nothing from coalescing (it fills a dispatch by itself) but, in
    the FIFO queue, would head-of-line block every latency-sensitive single
    behind a multi-second bulk search.  Such requests skip the queue
    entirely: they dispatch immediately on a dedicated thread while the
    FIFO lane keeps draining interactive traffic (the engine is
    thread-safe: it serialises the device work of both lanes under its
    lock).  Counted in ``stats.bypass``.

    At most ``MAX_BYPASS_LANES`` bypass dispatches run concurrently; bulk
    submits beyond that fall back to the FIFO queue (bounded threads and
    bounded resident batches under bursty bulk traffic).

    **QoS deadlines** — ``submit(..., deadline_ms=)`` bounds how long a
    request may wait for dispatch; one that expires while queued fails
    with :class:`DeadlineExceeded` instead of occupying a slot in a
    coalesced batch (checked when the dispatcher pops it and again in the
    close-drain sweep; counted in ``stats.expired``).

    ``close(drain=True)`` (the default, also the context-manager exit)
    serves everything already enqueued — including submits that raced the
    shutdown sentinel — before returning; ``drain=False`` fails pending
    futures instead.  ``stats`` is safe to read from any thread; use
    ``stats.snapshot()`` for a consistent multi-field view.
    """

    MAX_BYPASS_LANES = 8

    def __init__(self, engine, *, max_wait_ms: float | None = None,
                 max_batch: int | None = None):
        cfg = engine.cfg
        self.engine = engine
        self.max_wait_s = (cfg.queue_max_wait_ms if max_wait_ms is None
                           else max_wait_ms) / 1e3
        self.max_batch = (cfg.queue_max_batch if max_batch is None
                          else max_batch)
        if self.max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.stats = BatcherStats()
        self._q: _queue.Queue = _queue.Queue()
        self._carry: _Request | None = None
        self._bypass_threads: list = []
        self._closed = False
        self._close_done = threading.Event()  # set once a close() finishes
        # makes submit's closed-check + enqueue atomic against close()
        # setting the flag: every accepted request is enqueued BEFORE the
        # shutdown sentinel, so it is either served by the dispatcher or
        # swept up by close()'s drain — no Future can be silently dropped
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(target=self._loop, daemon=True,
                                        name="repro-microbatcher")
        self._thread.start()

    # -- client side --------------------------------------------------------

    def submit(self, Q, *, k: int | None = None,
               deadline_ms: float | None = None) -> Future:
        """Enqueue one request; `Q` is a single vector [d] or a batch [b, d].

        Returns a Future resolving to (ids, dists) — shaped [k]/[b, k] to
        match the input rank.

        ``deadline_ms`` (QoS): if the request is still waiting for dispatch
        when the deadline elapses, its future fails with
        :class:`DeadlineExceeded` instead of occupying a slot in a
        coalesced batch — stale answers are never computed, and fresh
        traffic isn't padded out by requests nobody is waiting for anymore.
        The deadline gates *dispatch*, not completion: a request that makes
        it into a device batch before the cutoff is answered normally even
        if the answer lands after it.  Expired requests are counted in
        ``stats.expired``.
        """
        if deadline_ms is not None and deadline_ms <= 0:
            raise ValueError(f"deadline_ms must be > 0, got {deadline_ms}")
        Q = np.asarray(Q, np.float32)
        single = Q.ndim == 1
        if single:
            Q = Q[None]
        d = self.engine.X.shape[1]
        if Q.ndim != 2 or Q.shape[0] == 0 or Q.shape[1] != d:
            # reject here so a malformed request can't poison the group it
            # would be concatenated with in the dispatcher
            raise ValueError(f"Q must be [{d}] or [b, {d}], got {Q.shape}")
        fut: Future = Future()
        req = _Request(Q=Q, k=k, single=single, future=fut,
                       deadline=(None if deadline_ms is None
                                 else time.monotonic() + deadline_ms / 1e3))
        with self._submit_lock:
            if self._closed:
                raise RuntimeError(
                    "MicroBatcher is closed — close() was already called; "
                    "submits after close are rejected rather than queued "
                    "(they could never be dispatched)")
            self._bypass_threads = [x for x in self._bypass_threads
                                    if x.is_alive()]
            if (Q.shape[0] >= self.max_batch
                    and len(self._bypass_threads) < self.MAX_BYPASS_LANES):
                # QoS bypass lane: a full-dispatch bulk batch skips the
                # FIFO coalescing wait so it can't head-of-line block
                # latency traffic; served on its own thread immediately.
                # The lane count is capped — a burst of bulk submits past
                # the cap degrades gracefully to the FIFO queue instead of
                # spawning one thread (and one resident concatenated
                # batch) per request.
                t = threading.Thread(
                    target=self._serve_group, args=([req],),
                    kwargs={"bypass": True}, daemon=True,
                    name="repro-microbatcher-bypass")
                self._bypass_threads.append(t)
                t.start()
            else:
                self._q.put(req)
        return fut

    def close(self, *, drain: bool = True) -> None:
        """Stop the dispatcher; by default after draining pending work.

        Idempotent: a second (or concurrent) ``close()`` does not re-drain —
        it blocks until the first call has finished, so no caller ever
        returns from ``close()`` while futures are still being resolved."""
        with self._submit_lock:
            already = self._closed
            self._closed = True
        if already:
            self._close_done.wait(timeout=600)
            return
        try:
            self._close(drain)
        finally:
            self._close_done.set()

    def _close(self, drain: bool) -> None:
        if not drain:
            # fail whatever is still queued
            try:
                while True:
                    req = self._q.get_nowait()
                    req.future.set_exception(
                        RuntimeError("MicroBatcher closed"))
            except _queue.Empty:
                pass
        self._q.put(None)  # sentinel wakes the dispatcher
        self._thread.join(timeout=60)
        # requests that raced the sentinel (accepted by submit before the
        # closed flag was set, enqueued behind None via dispatcher re-puts,
        # or left by a timed-out join): with drain=True those callers asked
        # in good faith before the close completed — serve them, in
        # max_batch-capped same-k groups like the dispatcher would; only
        # fail them when drain=False
        leftovers = []
        try:
            while True:
                req = self._q.get_nowait()
                if req is not None:
                    leftovers.append(req)
        except _queue.Empty:
            pass
        if not drain:
            for req in leftovers:
                req.future.set_exception(RuntimeError("MicroBatcher closed"))
            for t in self._bypass_threads:  # already-dispatched bulk work
                t.join()
            return
        while leftovers:
            req = leftovers.pop(0)
            if self._expired(req):   # QoS: stale even at shutdown
                self._expire(req)
                continue
            group = [req]
            total = group[0].Q.shape[0]
            while (leftovers and leftovers[0].k == group[0].k
                   and total < self.max_batch):
                nxt = leftovers.pop(0)
                if self._expired(nxt):
                    self._expire(nxt)
                    continue
                total += nxt.Q.shape[0]
                group.append(nxt)
            self._serve_group(group)
        # bypass-lane dispatches run on their own threads; a close() must
        # not return while their futures are still unresolved (unbounded
        # join: killing a daemon thread mid-query would leave a future
        # that never resolves, which is strictly worse than waiting)
        for t in self._bypass_threads:
            t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- dispatcher side ----------------------------------------------------

    def _expired(self, req: _Request) -> bool:
        return req.deadline is not None and time.monotonic() > req.deadline

    def _expire(self, req: _Request) -> None:
        """Fail one request whose deadline passed before dispatch."""
        self.stats.record_expired()
        req.future.set_exception(DeadlineExceeded(
            "request expired before dispatch (deadline_ms elapsed while "
            "queued)"))

    def _next_group(self) -> list | None:
        """Block for the first request, then coalesce same-k co-riders until
        `max_batch` queries are aboard or `max_wait` elapses.  Returns None
        on shutdown.  Requests whose deadline passed while queued are
        expired at pop time — they never occupy a slot in the group."""
        first = self._carry
        self._carry = None
        while first is not None and self._expired(first):
            self._expire(first)
            first = None
        while first is None:
            first = self._q.get()
            if first is None:
                return None
            if self._expired(first):
                self._expire(first)
                first = None
        group = [first]
        total = first.Q.shape[0]
        deadline = time.monotonic() + self.max_wait_s
        while total < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._q.get(timeout=remaining)
            except _queue.Empty:
                break
            if nxt is None:  # shutdown after serving what we have
                self._q.put(None)
                break
            if self._expired(nxt):
                self._expire(nxt)
                continue
            if nxt.k != first.k:
                self._carry = nxt  # different cache entry: next group
                break
            group.append(nxt)
            total += nxt.Q.shape[0]
        return group

    def _serve_group(self, group: list, *, bypass: bool = False) -> None:
        """One coalesced dispatch: concat, query, slice results back out."""
        Q = np.concatenate([r.Q for r in group], axis=0)
        self.stats.record_dispatch(len(group), Q.shape[0], bypass=bypass)
        try:
            ids, dists = self.engine.query(Q, k=group[0].k)
        except Exception as e:  # noqa: BLE001 — deliver, don't die
            for r in group:
                r.future.set_exception(e)
            return
        row = 0
        for r in group:
            b = r.Q.shape[0]
            out = (ids[row], dists[row]) if r.single \
                else (ids[row:row + b], dists[row:row + b])
            r.future.set_result(out)
            row += b

    def _loop(self) -> None:
        while True:
            group = self._next_group()
            if group is None:
                return
            self._serve_group(group)
