"""The port's serving layer against the JAX reference, on the CPU.

The reference's engine test data and config (``tests/test_serve_engine.py``)
with ``large_hops=24``.  One graph, carried into both packages as numpy
(the port's through ``ann/convert.py``), serves every engine here:

* the engine's cache, counters and warmup against ``repro.serve.engine.
  ANNEngine`` on a mixed stream of batch sizes: equal ids, equal cache
  and stat counts;
* bucket padding bitwise against the raw procedures, in both regimes;
* generations: a same-shape compaction and same-capacity mutations make
  no cache entry, a shape-changing compaction drops its entries and
  re-dispatches, and a stale callable raises ``StaleGeneration``, which
  the engine retries;
* the micro-batching queue (a copy of the reference's) over the port's
  engine;
* ``calibrate`` of both packages fed the same probe timings.

On the CPU the engine's cache holds the eager searches (nothing is
captured); ``tests/test_torch_cuda.py`` holds the CUDA graphs on the card.
"""
import dataclasses
import threading
import time
from concurrent.futures import Future

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import dispatch as j_dispatch
from repro.configs import get_arch
from repro.core.diversify import PackedGraph as JPackedGraph
from repro.data.synthetic import make_clustered, recall_at_k
from repro.serve.engine import ANNEngine as JEngine
from repro_torch.ann import Index
from repro_torch.ann import dispatch as t_dispatch
from repro_torch.ann.convert import graph_from_numpy
from repro_torch.ann.pipeline import build_graph
from repro_torch.configs.base import ANNConfig
from repro_torch.core.search_large import _large_batch_search
from repro_torch.core.search_small import _small_batch_search
from repro_torch.serve.engine import ANNEngine, RegimeStats
from repro_torch.serve.plane import StaleGeneration
from repro_torch.serve.queue import DeadlineExceeded, MicroBatcher, _Request

# the plain versions are small here: one thread each, so the test
# workers running beside this file keep their cores
torch.set_num_threads(1)

KNOBS = dict(k_graph=12, max_degree=16, lambda0=8, bridge_hubs=32,
             bridge_k=8, large_ef=48, large_hops=24,
             serve_buckets=(8, 32, 128))
STREAM = [1, 7, 33, 100, 129] * 3


@pytest.fixture(scope="module")
def world():
    """The reference's engine-test data; the graph is built once (by the
    port: the reference's build costs 15 s of compiling on one core) and
    carried into both packages as numpy."""
    ds = make_clustered(n=3000, d=16, n_queries=128, n_clusters=24,
                        noise=0.6, seed=0)
    cfg = dataclasses.replace(ANNConfig(), **KNOBS)
    cfg_j = dataclasses.replace(get_arch("tsdg-paper"), kernel_backend="xla",
                                **KNOBS)
    g = build_graph(ds.X, cfg, device="cpu")
    arrays = dict(neighbors=g.neighbors.numpy(), lambdas=g.lambdas.numpy(),
                  degrees=g.degrees.numpy(), hubs=g.hubs.numpy())
    return dict(ds=ds, cfg=cfg, cfg_j=cfg_j, arrays=arrays)


def _engine(world, **kw):
    return ANNEngine(world["ds"].X, world["cfg"], k=10, device="cpu",
                     graph=graph_from_numpy(**world["arrays"],
                                            device="cpu"), **kw)


def _index(world, X=None, **kw):
    return Index.from_numpy(world["ds"].X if X is None else X,
                            world["arrays"], world["cfg"], k=10,
                            device="cpu", **kw)


@pytest.fixture(scope="module")
def mixed(world):
    """The reference's mixed stream through both engines."""
    ds = world["ds"]
    eng = _engine(world)
    jeng = JEngine(ds.X, world["cfg_j"], k=10, graph=JPackedGraph(
        **{name: jnp.asarray(a) for name, a in world["arrays"].items()}))
    rng = np.random.default_rng(0)
    out = []
    for B in STREAM:
        sel = rng.integers(0, len(ds.Q), B)
        out.append((eng.query(ds.Q[sel]), jeng.query(ds.Q[sel])))
    return dict(eng=eng, jeng=jeng, out=out)


# ----------------------------------------------------------------------
# the cache, counters and warmup against the reference's engine
# ----------------------------------------------------------------------

def test_mixed_stream_ids_and_counts_match_reference(mixed):
    for (ids, dists), (jids, jdists) in mixed["out"]:
        assert ids.shape == jids.shape
        np.testing.assert_array_equal(ids, jids)
        np.testing.assert_allclose(dists, jdists, rtol=1e-5, atol=1e-4)
    st, jst = mixed["eng"].stats, mixed["jeng"].stats
    for name in ("compiles", "bucket_hits", "bucket_misses", "n_queries",
                 "n_batches", "small_batches", "large_batches",
                 "padded_queries", "steady_queries", "h2d_staged",
                 "h2d_stage_reuses", "aot_primed"):
        assert getattr(st, name) == getattr(jst, name), name
    # (small, 8) by 1 and 7; (large, 128) by 33 and 100; (large, 256)
    assert st.compiles == 3 and st.bucket_hits == len(STREAM) - 3
    for kind in ("small", "large"):
        reg, jreg = st.per_regime[kind], jst.per_regime[kind]
        assert (reg.warmup_batches, reg.n_batches, reg.n_queries) \
            == (jreg.warmup_batches, jreg.n_batches, jreg.n_queries)
    assert set(st.snapshot()) == set(jst.snapshot())
    assert st.qps > 0 and 0 < st.bucket_hit_rate < 1
    p = st.per_regime["large"].percentiles()
    assert p["p50"] <= p["p99"]
    counts, edges = st.per_regime["large"].histogram(bins=4)
    assert counts.sum() == st.per_regime["large"].n_batches
    assert len(edges) == 5


def test_warmup_makes_the_references_entries(mixed):
    """``warmup_probes`` equals the reference's, and ``warmup`` makes the
    entries the reference's warmup would (its probes' pairs not cached
    yet), after which no batch size of the ladder makes one."""
    eng, jeng = mixed["eng"], mixed["jeng"]
    probes = jeng.warmup_probes()
    assert eng.warmup_probes() == probes
    cached = {key[:3] for key in jeng._compiled}
    j_new = len({(kind, b) for kind, b, _ in probes
                 if (kind, b, 10) not in cached})
    n = eng.warmup()
    assert n == j_new == 2             # (small, 32) and (large, 32)
    before = eng.stats.compiles
    for B in (7, 15, 16, 33):       # each (regime, bucket) pair once
        eng.query(np.zeros((B, 16), np.float32))
    assert eng.stats.compiles == before and len(probes) == 4


def test_regime_threshold_override_matches_reference(world):
    cfg = world["cfg"]
    eng = _engine(world, threshold=1.0)
    assert eng.threshold == 1.0
    for B in (1, 3, 15, 16, 17):
        assert eng.regime(B) == j_dispatch.regime_for(
            world["cfg_j"], B, threshold=1.0)
    assert eng.regime(1) == "large"
    assert _engine(world).regime(15) == "small"
    assert t_dispatch.regime_for(cfg, 15, threshold=1.0) == "large"


@pytest.mark.parametrize("B,kind", [(5, "small"), (33, "large")])
def test_padded_batch_bitwise_matches_raw(world, B, kind):
    """Bucket padding must not change the real rows' ids or dists."""
    cfg, ds = world["cfg"], world["ds"]
    eng = _engine(world)
    assert eng.regime(B) == kind and eng.bucket_for(B) > B
    ids, dists = eng.query(ds.Q[:B])
    Q = torch.from_numpy(ds.Q[:B])
    if kind == "small":
        raw = _small_batch_search(
            eng.X, eng.graph, Q, k=10, t0=cfg.small_t0, hops=cfg.small_hops,
            hop_width=cfg.hop_width, n_seeds=cfg.n_seeds, lambda_limit=10,
            metric=cfg.metric)
    else:
        raw = _large_batch_search(
            eng.X, eng.graph, Q, k=10, ef=cfg.large_ef, hops=cfg.large_hops,
            lambda_limit=5, metric=cfg.metric, n_seeds=cfg.large_n_seeds,
            m_seg=cfg.queue_segments, seg=cfg.segment_size,
            mv_seg=cfg.visited_segments, delta=cfg.delta)
    np.testing.assert_array_equal(ids, raw[0].numpy())
    np.testing.assert_array_equal(dists, raw[1].numpy())
    assert eng.stats.padded_queries == eng.bucket_for(B) - B


def test_tensor_and_host_batches_answer_alike(world):
    """A host batch goes through the plane's staging buffer, a tensor
    straight to the device: both answer alike, and only the host batches
    count as staged (the second reuses the first's buffer)."""
    eng = _engine(world)
    Q = world["ds"].Q[:5]
    a, _ = eng.query(Q)
    b, _ = eng.query(torch.from_numpy(Q))
    c, _ = eng.query(Q.astype(np.float64))
    np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(a, c)
    assert eng.stats.h2d_staged == 2 and eng.stats.h2d_stage_reuses == 1
    with pytest.raises(ValueError, match="numeric"):
        eng.query(np.zeros((2, 16), bool))
    with pytest.raises(ValueError, match=r"Q must be \[B, 16\]"):
        eng.query(np.zeros((4, 7), np.float32))


@pytest.mark.parametrize("item", ["mesh", "cache_from"])
def test_later_items_raise(world, item):
    """``mesh=`` and ``cache_from=`` used to raise; now a (1, 1) grid
    builds the single plane's graph and answers as it does, and a replica
    shares its donor's cache and lock and answers as the donor, bit for
    bit, both regimes."""
    from repro_torch.core.distributed import make_mesh

    donor = _engine(world)
    if item == "mesh":
        eng = ANNEngine(world["ds"].X, world["cfg"], k=10,
                        mesh=make_mesh((1, 1), ("data", "model"),
                                       device="cpu"))
        assert eng.plane.name == "mesh" and eng.mesh.shape == (1, 1)
    else:
        eng = ANNEngine(None, world["cfg"], k=10, plane=donor.plane,
                        cache_from=donor)
        assert eng._compiled is donor._compiled and eng.lock is donor.lock
    for B in (5, 100):
        Q = world["ds"].Q[:B]
        for a, b in zip(eng.query(Q), donor.query(Q)):
            np.testing.assert_array_equal(a.view(np.uint32),
                                          b.view(np.uint32))


def test_aot_entry_points_raise(world):
    """The reference's AOT entry points have no CUDA-graph form; the
    router they stood beside is here: ``serve(router=)`` answers as the
    index does."""
    eng = _engine(world)
    for call in (lambda: eng.export_executable("small", 8),
                 eng.aot_operands,
                 lambda: eng.prime_executable("small", 8, 10, None)):
        with pytest.raises(NotImplementedError, match="no serialized form"):
            call()
    index = _index(world)
    with index.serve(router="replicated:2", max_wait_ms=0.5) as r:
        assert r.cfg.mode == "replicated" and len(r.endpoints) == 2
        ids, _ = r.query(world["ds"].Q[:3])
    np.testing.assert_array_equal(ids, index.search(world["ds"].Q[:3])[0])


def test_regime_stats_window():
    rs = RegimeStats()
    assert np.isnan(rs.percentiles()["p50"])
    assert rs.histogram(bins=3)[0].sum() == 0
    rs.record(4, 0.5, warmup=True)
    for dt in (0.1, 0.2, 0.3):
        rs.record(2, dt, warmup=False)
    assert (rs.warmup_batches, rs.n_batches, rs.n_queries) == (1, 3, 6)
    assert rs.percentiles()["p50"] == pytest.approx(0.2)


# ----------------------------------------------------------------------
# generations: compaction, mutations and stale callables
# ----------------------------------------------------------------------

def test_same_shape_compaction_makes_no_entry(world):
    """The port's form of the reference's hot-swap bar: warm frozen and
    streaming entries, then a compaction whose corpus keeps the base
    shape; the new generation is served by the same entries (copied into
    their buffers) and answers as a fresh index over it does."""
    ds = world["ds"]
    index = _index(world)
    index.search(ds.Q[:8])
    index.search(ds.Q[:64])
    index.add(ds.Q[:4])
    index.search(ds.Q[:8])
    index.search(ds.Q[:64])
    index.delete([0, 1, 2, 3])
    entries = dict(index.engine._compiled)
    compiles = index.stats.compiles
    token = index.plane.shape_token()
    index.compact()
    assert index.plane.shape_token() == token
    ids, dists = index.search(ds.Q[:8])
    index.search(ds.Q[:64])
    assert index.stats.compiles == compiles
    assert index.engine._compiled == entries
    assert index.generation == 1
    assert (ids[:4, 0] >= ds.X.shape[0] - 4).all()
    g = index.graph
    fresh = Index.from_numpy(
        index.X.numpy().copy(),
        dict(neighbors=g.neighbors.numpy().copy(),
             lambdas=g.lambdas.numpy().copy(),
             degrees=g.degrees.numpy().copy(), hubs=g.hubs.numpy().copy()),
        world["cfg"], k=10, device="cpu")
    f8, fd8 = fresh.search(ds.Q[:8])
    np.testing.assert_array_equal(ids, f8)
    np.testing.assert_array_equal(dists, fd8)


def test_same_capacity_mutations_make_no_entry(world):
    ds = world["ds"]
    index = _index(world)
    v = index.add(ds.Q[:4])
    index.search(ds.Q[:8])
    before, tok = index.stats.compiles, index.plane.stream_token()
    index.delete(list(map(int, v[:2])))
    index.add(ds.Q[4:6])
    ids, _ = index.search(ds.Q[:8])
    assert index.stats.compiles == before
    assert index.plane.stream_token() == tok
    assert not np.isin(ids, v[:2]).any()
    # a capacity change moves the stream token: one new entry
    index.add(np.repeat(ds.Q[:1], 300, axis=0))
    index.search(ds.Q[:8])
    assert index.plane.stream_token() != tok
    assert index.stats.compiles == before + 1


def test_shape_changing_compaction_prunes_and_redispatches(world):
    ds = world["ds"]
    n = ds.X.shape[0]
    index = _index(world)
    index.search(ds.Q[:8])
    index.add(ds.Q[:4])
    index.search(ds.Q[:8])
    index.delete([10, 11])
    assert len(index.engine._compiled) == 2
    compiles = index.stats.compiles
    id_map = index.compact()
    assert index.engine._compiled == {}    # bound to the old buffers
    ids, _ = index.search(ds.Q[:8])
    assert index.stats.compiles == compiles + 1
    assert index.X.shape[0] == n + 2 and int(id_map.max()) == n + 1
    assert (ids[:4, 0] == id_map[n:n + 4]).all()


def test_stale_callable_raises_and_engine_retries(world):
    """A callable of a superseded generation raises StaleGeneration; the
    engine re-dispatches, and retries a callable that raised it once."""
    ds, cfg = world["ds"], world["cfg"]
    index = _index(world)
    plane = index.plane
    exe = plane.compile("small", 8, 10)
    X2 = ds.X[:600]
    plane.rebind(X2, build_graph(X2, cfg, device="cpu"))
    with pytest.raises(StaleGeneration):
        exe(torch.from_numpy(np.repeat(ds.Q[:1], 8, axis=0)))
    ids, _ = index.search(ds.Q[:8])
    assert ids.shape == (8, 10) and int(ids.max()) < 600

    eng = _engine(world)
    want, _ = eng.query(ds.Q[:5])
    (key, real), = eng._compiled.items()
    calls = []

    def flaky(Qb):
        calls.append(1)
        if len(calls) == 1:
            raise StaleGeneration("forced")
        return real(Qb)

    eng._compiled[key] = flaky
    got, _ = eng.query(ds.Q[:5])
    assert len(calls) == 2
    np.testing.assert_array_equal(got, want)


def test_probe_calibration_sets_the_threshold(world):
    index = _index(world)
    cal = Index.from_numpy(
        world["ds"].X, world["arrays"], dataclasses.replace(
            world["cfg"], regime_calibration="probe"),
        k=10, device="cpu").calibration
    assert index.calibration is None
    assert isinstance(cal, t_dispatch.Calibration)
    assert [B for B, _ in cal.probes["small"]] == [4, 32]
    assert all(t > 0 for rows in cal.probes.values() for _, t in rows)
    assert cal.cores >= 1 and cal.d == 16
    pinned = Index(world["ds"].X, dataclasses.replace(
        world["cfg"], regime_calibration="probe"), k=10, device="cpu",
        graph=graph_from_numpy(**world["arrays"], device="cpu"),
        threshold=3.0)
    assert pinned.calibration is None and pinned.engine.threshold == 3.0


# ----------------------------------------------------------------------
# calibrate: both packages on the same probe timings
# ----------------------------------------------------------------------

class _Ready:
    def block_until_ready(self):
        return self


class _StubPlane:
    """A plane whose callables do nothing: the clock is scripted."""

    device = torch.device("cpu")

    def __init__(self, d=16):
        self.X = np.zeros((4, d), np.float32)

    def batch_multiple(self):
        return 1

    def compile(self, kind, bucket, k):
        return lambda Q: (_Ready(), _Ready())


@pytest.mark.parametrize("ms", [
    {"small": (1.0, 8.0), "large": (5.0, 6.0)},     # crossover at B = 16.6
    {"small": (1.0, 1.5), "large": (5.0, 9.0)},     # small never loses
])
def test_calibrate_matches_reference_on_the_same_probes(monkeypatch, ms):
    def clock():
        t = [0.0]
        # per (regime, batch): 3 timed calls of start / end
        durs = iter(d / 1e3 for kind in ("small", "large")
                    for d in ms[kind] for _ in range(3))
        state = {"start": True}

        def perf_counter():
            if state["start"]:
                t[0] += 1.0
            else:
                t[0] += next(durs)
            state["start"] = not state["start"]
            return t[0]
        return perf_counter

    cfg_t = dataclasses.replace(ANNConfig(), **KNOBS)
    cfg_j = dataclasses.replace(get_arch("tsdg-paper"), **KNOBS)
    monkeypatch.setattr(time, "perf_counter", clock())
    ours = t_dispatch.calibrate(_StubPlane(), cfg_t, k=10)
    monkeypatch.setattr(time, "perf_counter", clock())
    theirs = j_dispatch.calibrate(_StubPlane(), cfg_j, k=10)
    assert ours.to_manifest() == theirs.to_manifest()
    assert ours.degenerate == (ms["small"][1] - ms["small"][0]
                               <= ms["large"][1] - ms["large"][0])
    assert t_dispatch.Calibration.from_manifest(ours.to_manifest()) == ours


# ----------------------------------------------------------------------
# the micro-batching queue over the port's engine
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def warm(world):
    eng = _engine(world)
    eng.warmup()
    return eng


class _Slow:
    """The port's engine behind a fixed delay per dispatch, so the queue's
    close and deadline races are timed exactly."""

    def __init__(self, engine, delay_s):
        self.engine, self.delay_s = engine, delay_s
        self.X, self.cfg = engine.X, engine.cfg
        self.served: list = []

    def query(self, Q, k=None):
        self.served.append(Q.shape[0])
        time.sleep(self.delay_s)
        return self.engine.query(Q, k=k)


def test_queue_coalesces_concurrent_singles(world, warm):
    ds = world["ds"]
    n = 24
    with MicroBatcher(warm, max_wait_ms=100, max_batch=64) as mb:
        futs = [mb.submit(ds.Q[i]) for i in range(n)]
        outs = [f.result(timeout=120) for f in futs]
    assert mb.stats.n_requests == n
    assert mb.stats.n_dispatches < n
    assert mb.stats.mean_coalesced > 1.0
    ids = np.stack([o[0] for o in outs])
    assert ids.shape == (n, 10) and outs[0][1].shape == (10,)
    assert recall_at_k(ids, ds.gt[:n], 10) > 0.85


def test_queue_concurrent_threads(world, warm):
    ds = world["ds"]
    results = {}

    def worker(tid):
        futs = [mb.submit(ds.Q[tid * 4 + j]) for j in range(4)]
        results[tid] = [f.result(timeout=120) for f in futs]

    with MicroBatcher(warm, max_wait_ms=50, max_batch=32) as mb:
        threads = [threading.Thread(target=worker, args=(t,))
                   for t in range(6)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(6))
    assert mb.stats.snapshot()["n_queries"] == 24
    for outs in results.values():
        assert all(ids.shape == (10,) for ids, _ in outs)


def test_queue_groups_by_k_and_takes_batches(world, warm):
    ds = world["ds"]
    with MicroBatcher(warm, max_wait_ms=30, max_batch=64) as mb:
        f5 = [mb.submit(ds.Q[i], k=5) for i in range(4)]
        f10 = [mb.submit(ds.Q[i], k=10) for i in range(4)]
        fb = mb.submit(ds.Q[:6])
        assert all(f.result(timeout=120)[0].shape == (5,) for f in f5)
        assert all(f.result(timeout=120)[0].shape == (10,) for f in f10)
        assert fb.result(timeout=120)[0].shape == (6, 10)
    assert mb.stats.n_dispatches >= 2


def test_queue_propagates_errors_and_rejects_wrong_dim(world, warm):
    ds, cfg = world["ds"], world["cfg"]
    with MicroBatcher(warm, max_wait_ms=10) as mb:
        f = mb.submit(ds.Q[0], k=cfg.small_t0 * 32 + 1)
        with pytest.raises(ValueError, match="exceeds small-batch"):
            f.result(timeout=120)
        with pytest.raises(ValueError, match="Q must be"):
            mb.submit(np.zeros((8,), np.float32))
        ids, _ = mb.submit(ds.Q[1]).result(timeout=120)
        assert ids.shape == (10,)


def test_queue_bypass_answers_like_search(world, warm):
    ds = world["ds"]
    with MicroBatcher(warm, max_wait_ms=1.0, max_batch=8) as mb:
        ids, _ = mb.submit(ds.Q[:16]).result(timeout=120)
    assert mb.stats.bypass == 1
    np.testing.assert_array_equal(ids, warm.query(ds.Q[:16])[0])


@pytest.mark.parametrize("drain", [True, False])
def test_queue_close_serves_or_fails_a_racing_submit(world, warm, drain):
    """A request enqueued behind the shutdown sentinel is served by
    ``close(drain=True)`` and failed by ``close(drain=False)``."""
    slow = _Slow(warm, 0.2)
    mb = MicroBatcher(slow, max_wait_ms=1, max_batch=4)
    f1 = mb.submit(world["ds"].Q[0])
    time.sleep(0.05)
    closer = threading.Thread(target=lambda: mb.close(drain=drain))
    closer.start()
    time.sleep(0.05)
    racer = _Request(Q=world["ds"].Q[:2], k=None, single=False,
                     future=Future())
    mb._q.put(racer)
    closer.join(timeout=60)
    assert not closer.is_alive()
    assert f1.result(timeout=60)[0].shape == (10,)
    if drain:
        assert racer.future.result(timeout=60)[0].shape == (2, 10)
    else:
        with pytest.raises(RuntimeError, match="closed"):
            racer.future.result(timeout=60)
    with pytest.raises(RuntimeError, match="MicroBatcher is closed"):
        mb.submit(world["ds"].Q[0])


def test_queue_deadlines(world, warm):
    """A request whose deadline passes while the dispatcher is busy fails
    with DeadlineExceeded and never reaches the engine; ``deadline_ms``
    threads through ``Index.serve``."""
    slow = _Slow(warm, 0.3)
    mb = MicroBatcher(slow, max_wait_ms=1, max_batch=4)
    try:
        f1 = mb.submit(world["ds"].Q[0])
        time.sleep(0.05)
        f2 = mb.submit(world["ds"].Q[1], deadline_ms=100.0)
        f3 = mb.submit(world["ds"].Q[2])
        with pytest.raises(DeadlineExceeded):
            f2.result(timeout=30)
        assert f1.result(timeout=30)[0].shape == (10,)
        assert f3.result(timeout=30)[0].shape == (10,)
        with pytest.raises(ValueError, match="deadline_ms"):
            mb.submit(world["ds"].Q[0], deadline_ms=0.0)
    finally:
        mb.close()
    snap = mb.stats.snapshot()
    assert snap["expired"] == 1 and snap["n_requests"] == 2
    assert sum(slow.served) == 2
    index = _index(world)
    with index.serve(max_wait_ms=1.0, max_batch=8) as mb:
        ids, _ = mb.submit(world["ds"].Q[0], deadline_ms=60_000.0) \
            .result(timeout=120)
    assert ids.shape == (10,) and mb.stats.expired == 0
