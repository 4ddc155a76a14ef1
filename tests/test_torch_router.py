"""The port's request router (``serve/router.py``) on the CPU, mirroring
``tests/test_router.py``: replicated and sharded dispatch, parity bit for
bit, failover under replica kills, eject and readmit by the health probe,
aggregated stats.

Endpoints are the port's engines on the CPU (their cache holds the eager
searches).  The regime threshold is pinned in every parity test, so every
endpoint takes the same regime.  The sharded router is held to the port's
``(P, 1)`` mesh bit for bit, and to the reference's
``merge_shard_results`` over the reference's single planes holding the
same shard graphs (ids exactly, distances within 1e-6 * (qn + vn)).
"""
import dataclasses
import time
from concurrent.futures import wait

import numpy as np
import pytest
import torch

from repro.configs import get_arch
from repro.data.synthetic import make_clustered, recall_at_k
from repro_torch.ann import Index
from repro_torch.ann.convert import graph_from_numpy
from repro_torch.configs.base import ANNConfig
from repro_torch.core import distributed as D
from repro_torch.core.distributed import merge_shard_results
from repro_torch.serve.engine import ANNEngine
from repro_torch.serve.router import (EngineEndpoint, NoHealthyReplicas,
                                      PartialResultError, ReplicaDead,
                                      Router, RouterConfig,
                                      parse_router_spec, replicate_engine,
                                      shard_engines)

# the plain versions are small here: one thread each, so the test
# workers running beside this file keep their cores
torch.set_num_threads(1)

KNOBS = dict(k_graph=8, max_degree=12, lambda0=4, bridge_hubs=16,
             bridge_k=4, large_ef=32, large_hops=16, serve_buckets=(8, 64))


def _bitwise(a, b):
    return (bool(np.array_equal(a[0], b[0]))
            and bool(np.array_equal(np.asarray(a[1]).view(np.uint32),
                                    np.asarray(b[1]).view(np.uint32))))


@pytest.fixture(scope="module")
def ds():
    return make_clustered(n=1024, d=16, n_queries=64, n_clusters=16,
                          noise=0.6, seed=0)


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(ANNConfig(), **KNOBS)


@pytest.fixture(scope="module")
def thresh(cfg):
    # population rule B*t0 < 4*thr: B < 32 -> small, B >= 32 -> large
    return 8.0 * cfg.small_t0


@pytest.fixture(scope="module")
def idx(ds, cfg, thresh):
    index = Index.build(ds.X, cfg, k=10, threshold=thresh, device="cpu")
    index.warmup()
    return index


# ----------------------------------------------------------------------
# config + construction validation
# ----------------------------------------------------------------------

def test_router_config_did_you_mean():
    with pytest.raises(ValueError, match="did you mean 'replicated'"):
        RouterConfig(mode="replcated")
    with pytest.raises(ValueError, match="did you mean 'least_loaded'"):
        RouterConfig(policy="least_loded")
    with pytest.raises(ValueError, match="replicas"):
        RouterConfig(replicas=0)
    with pytest.raises(ValueError, match="endpoint_names"):
        RouterConfig(replicas=2, endpoint_names=("lonely",))
    with pytest.raises(ValueError, match="readmit_probes"):
        RouterConfig(readmit_probes=0)
    with pytest.raises(ValueError, match="probe_timeout_s"):
        RouterConfig(probe_timeout_s=0.0)


def test_parse_router_spec():
    rc = parse_router_spec("replicated:3")
    assert rc.mode == "replicated" and rc.replicas == 3
    assert parse_router_spec("sharded:2").mode == "sharded"
    assert parse_router_spec("replicated:2",
                             health_interval_s=0.5).health_interval_s == 0.5
    with pytest.raises(ValueError, match="did you mean 'sharded'"):
        parse_router_spec("shardd:2")
    with pytest.raises(ValueError, match="MODE:N"):
        parse_router_spec("replicated")
    with pytest.raises(ValueError, match="positive int"):
        parse_router_spec("replicated:0")


def test_router_endpoint_validation(idx):
    eps = replicate_engine(idx.engine, 2)
    try:
        with pytest.raises(ValueError, match="replicas=3"):
            Router(eps, RouterConfig(replicas=3, health_interval_s=0.0))
    finally:
        for e in eps:
            e.close()
    with pytest.raises(ValueError, match="at least one endpoint"):
        Router([], RouterConfig(replicas=1))
    eps = replicate_engine(idx.engine, 2, names=("twin", "twin"))
    try:
        with pytest.raises(ValueError, match="unique"):
            Router(eps, RouterConfig(replicas=2, health_interval_s=0.0))
    finally:
        for e in eps:
            e.close()


def test_shard_engines_requires_equal_cut(cfg):
    X = np.zeros((10, 4), np.float32)
    with pytest.raises(ValueError, match="do not split evenly"):
        shard_engines(X, cfg, shards=3, device="cpu")


def test_replica_needs_the_donors_plane(ds, cfg, idx):
    """cache_from shares graphs bound to the donor plane's buffers: a
    replica over another plane is refused; one over the same plane shares
    the cache AND the lock."""
    other = Index(ds.X, cfg, graph=idx.graph, device="cpu")
    with pytest.raises(ValueError, match="cache_from"):
        ANNEngine(None, cfg, plane=other.plane, cache_from=idx.engine)
    rep = ANNEngine(None, cfg, plane=idx.plane, cache_from=idx.engine)
    assert rep._compiled is idx.engine._compiled
    assert rep.lock is idx.engine.lock
    with pytest.raises(ValueError, match="plane= already fixes"):
        ANNEngine(ds.X, cfg, plane=idx.plane, graph=idx.graph)


# ----------------------------------------------------------------------
# replicated mode: parity, shared cache, policies
# ----------------------------------------------------------------------

def test_replicated_bitwise_parity_both_regimes(ds, idx):
    """A replicated router answers as the donor index does, bit for bit,
    both regimes."""
    rc = RouterConfig(mode="replicated", replicas=2, health_interval_s=0.0)
    with idx.serve(router=rc) as r:
        for B in (5, 64):
            ref = idx.search(ds.Q[:B])
            assert _bitwise(r.query(ds.Q[:B]), ref), B
        # single-vector convenience strips the leading axis
        gi, gd = r.query(ds.Q[0])
        ref = idx.search(ds.Q[:1])
        assert gi.shape == (10,)
        assert np.array_equal(gi, ref[0][0])
        assert np.array_equal(np.asarray(gd).view(np.uint32),
                              np.asarray(ref[1][0]).view(np.uint32))


def test_replicated_shared_cache_zero_compiles(ds, idx):
    """Replicas share the donor's plane AND cache: a router over a warmed
    index makes no entry, and the snapshot sums the per-replica engine and
    queue counters consistently."""
    rc = RouterConfig(mode="replicated", replicas=3, policy="round_robin",
                      health_interval_s=0.0)
    # max_batch caps coalesced groups at the largest warmed bucket
    with idx.serve(router=rc, max_batch=64) as r:
        futs = [r.submit(ds.Q[:5]) for _ in range(6)]
        futs.append(r.submit(ds.Q[:64]))
        done, not_done = wait(futs, timeout=120)
        assert not not_done
        assert all(f.exception() is None for f in futs)
        snap = r.snapshot()
    agg, reps, rt = snap["aggregate"], snap["replicas"], snap["router"]
    assert agg["compiles"] == 0
    assert agg["n_replicas"] == 3 and agg["healthy_replicas"] == 3
    assert rt["n_requests"] == 7 and rt["n_dispatches"] == 7
    assert rt["retries"] == 0 and rt["lost_futures"] == 0
    assert agg["n_queries"] == sum(v["engine"]["n_queries"]
                                   for v in reps.values())
    # round-robin spreads the stream across every endpoint
    assert all(v["dispatches"] >= 2 for v in reps.values())
    assert agg["large_p50_ms"] > 0.0


def test_serve_router_accepts_spec_string(ds, idx):
    with idx.serve(router="replicated:2", max_wait_ms=0.5) as r:
        assert r.cfg.mode == "replicated" and r.cfg.replicas == 2
        ids, _ = r.query(ds.Q[:3])
        assert np.array_equal(ids, idx.search(ds.Q[:3])[0])


# ----------------------------------------------------------------------
# replicated mode: failure handling (zero lost futures)
# ----------------------------------------------------------------------

def test_kill_replica_mid_stream_zero_lost_futures(ds, idx):
    """A replica killed under live traffic loses no future: every request
    (those already coalesced into the victim's queue too) fails over to
    the healthy peer."""
    rc = RouterConfig(mode="replicated", replicas=2, health_interval_s=0.0,
                      max_retries=2, backoff_s=0.001)
    with idx.serve(router=rc) as r:
        futs = []
        for i in range(30):
            futs.append(r.submit(ds.Q[:5]))
            if i == 10:
                r.endpoints[0].kill()
        done, not_done = wait(futs, timeout=120)
        assert not not_done
        for f in futs:
            assert f.exception() is None
            ids, _ = f.result()
            # coalesced requests sit at varying row offsets of the merged
            # batch, and each row is seeded by its offset: recall, not bits
            assert np.asarray(ids).shape == (5, 10)
            assert recall_at_k(np.asarray(ids), ds.gt[:5], 10) > 0.5
        snap = r.snapshot()
    rt = snap["router"]
    assert rt["lost_futures"] == 0
    assert rt["ejects"] == 1
    assert rt["retries"] >= 1
    assert snap["replicas"]["r0"]["healthy"] is False
    assert snap["aggregate"]["healthy_replicas"] == 1


def test_all_replicas_dead_fails_request(ds, idx):
    rc = RouterConfig(mode="replicated", replicas=2, health_interval_s=0.0,
                      max_retries=1, backoff_s=0.0)
    with idx.serve(router=rc) as r:
        for e in r.endpoints:
            e.kill()
        fut = r.submit(ds.Q[:5])
        with pytest.raises(ReplicaDead):
            fut.result(timeout=60)
        # both ejected now: the next request fails fast, no healthy pool
        fut2 = r.submit(ds.Q[:5])
        with pytest.raises(NoHealthyReplicas):
            fut2.result(timeout=60)
        snap = r.snapshot()
    assert snap["router"]["lost_futures"] == 2
    assert snap["router"]["ejects"] == 2
    assert snap["aggregate"]["healthy_replicas"] == 0


def test_user_error_propagates_without_retry(ds, idx):
    """Malformed requests are the caller's: they raise (at once for shape
    errors, through the future for the engine's validation) and never
    burn the retry budget or eject a replica."""
    rc = RouterConfig(mode="replicated", replicas=2, health_interval_s=0.0)
    with idx.serve(router=rc) as r:
        with pytest.raises(ValueError, match="Q must be"):
            r.submit(np.zeros((0, 16), np.float32))
        with pytest.raises(ValueError, match="Q must be"):
            r.submit(np.zeros((2, 7), np.float32))
        fut = r.submit(ds.Q[:2], k=10 ** 6)
        with pytest.raises(ValueError):
            fut.result(timeout=60)
        snap = r.snapshot()
    assert snap["router"]["retries"] == 0
    assert snap["router"]["lost_futures"] == 0
    assert snap["router"]["ejects"] == 0
    assert snap["aggregate"]["healthy_replicas"] == 2


def test_health_probe_eject_and_readmit(idx):
    """The prober ejects a dead replica within one probe interval (plus
    scheduling slack) and readmits it after ``readmit_probes`` consecutive
    good probes; RouterStats counts both transitions."""
    rc = RouterConfig(mode="replicated", replicas=2, health_interval_s=0.05,
                      probe_timeout_s=30.0, readmit_probes=2)
    with idx.serve(router=rc) as r:
        r.endpoints[0].kill()
        t0 = time.monotonic()
        while "r0" in r.healthy_replicas():
            assert time.monotonic() - t0 < 10, "probe failed to eject"
            time.sleep(0.005)
        r.endpoints[0].revive()
        t0 = time.monotonic()
        while "r0" not in r.healthy_replicas():
            assert time.monotonic() - t0 < 10, "probe failed to readmit"
            time.sleep(0.005)
        snap = r.snapshot()
    rt = snap["router"]
    assert rt["ejects"] >= 1 and rt["readmits"] >= 1
    assert rt["probes"] >= 2 and rt["probe_failures"] >= 1
    assert snap["aggregate"]["healthy_replicas"] == 2


def test_router_close_is_idempotent(ds, idx):
    rc = RouterConfig(mode="replicated", replicas=2, health_interval_s=0.0)
    r = idx.serve(router=rc)
    assert np.asarray(r.query(ds.Q[:3])[0]).shape == (3, 10)
    r.close()
    r.close()  # a second close returns at once, no second drain
    with pytest.raises(RuntimeError, match="closed"):
        r.submit(ds.Q[:3])


# ----------------------------------------------------------------------
# sharded mode: merge semantics + partial results
# ----------------------------------------------------------------------

def test_sharded_router_merges_shards(ds, idx):
    """The routed answer is exactly merge_shard_results over the shard
    engines' own answers (global ids, best-copy dedup, (dist, id))."""
    rc = RouterConfig(mode="sharded", replicas=2, health_interval_s=0.0)
    with idx.serve(router=rc) as r:
        got = r.query(ds.Q[:5])
        pools, offsets, n_rows = [], [], []
        for e in r.endpoints:
            ids, dists = e.engine.query(ds.Q[:5])
            pools.append((np.asarray(ids), np.asarray(dists)))
            offsets.append(e.id_offset)
            n_rows.append(e.n_rows)
    ref = merge_shard_results(pools, offsets, n_rows, k=10, batch=5)
    assert _bitwise(got, ref)
    # the shard endpoints are row slices with global offsets
    assert offsets == [0, 512] and n_rows == [512, 512]


def test_sharded_partial_result_error(ds, idx):
    """A killed shard (no peer holds its rows) fails the request with a
    PartialResultError carrying the SURVIVING shards' merged top-k."""
    rc = RouterConfig(mode="sharded", replicas=2, health_interval_s=0.0,
                      max_retries=1, backoff_s=0.001)
    with idx.serve(router=rc) as r:
        survivor = r.endpoints[0]
        r.endpoints[1].kill()
        fut = r.submit(ds.Q[:5])
        with pytest.raises(PartialResultError) as ei:
            fut.result(timeout=60)
        err = ei.value
        assert err.failed == ("s1",) and err.survivors == ("s0",)
        sids, sdists = survivor.engine.query(ds.Q[:5])
        ref = merge_shard_results(
            [(np.asarray(sids), np.asarray(sdists))],
            [survivor.id_offset], [survivor.n_rows], k=10, batch=5)
        assert np.array_equal(err.ids, ref[0])
        assert np.array_equal(np.asarray(err.dists).view(np.uint32),
                              np.asarray(ref[1]).view(np.uint32))
        snap = r.snapshot()
    rt = snap["router"]
    assert rt["partial_results"] == 1
    assert rt["lost_futures"] == 0     # a partial is an answer, not a loss
    assert rt["retries"] >= 1          # the same shard was retried first
    assert snap["replicas"]["s1"]["healthy"] is False


def test_sharded_all_shards_dead(ds, idx):
    rc = RouterConfig(mode="sharded", replicas=2, health_interval_s=0.0,
                      max_retries=0, backoff_s=0.0)
    with idx.serve(router=rc) as r:
        for e in r.endpoints:
            e.kill()
        fut = r.submit(ds.Q[:2])
        with pytest.raises(PartialResultError) as ei:
            fut.result(timeout=60)
        # nothing survived: the carried top-k is all PAD
        assert ei.value.survivors == ()
        assert (np.asarray(ei.value.dists) >= np.float32(3.4e38)).all()


# ----------------------------------------------------------------------
# sharded router against the mesh, and against the reference's router
# ----------------------------------------------------------------------

def test_sharded_router_matches_mesh(ds, cfg, idx, thresh):
    """A router over P equal row slices answers as a (P, 1) mesh over the
    whole corpus, bit for bit, both regimes: merge_shard_results is the
    mesh's merge, and each slice's build is the mesh shard's."""
    mesh = D.make_mesh((2, 1), ("data", "model"), device="cpu")
    mi = Index.build(ds.X, cfg, k=10, mesh=mesh, threshold=thresh)
    rc = RouterConfig(mode="sharded", replicas=2, health_interval_s=0.0)
    with idx.serve(router=rc) as r:
        for B, regime in ((5, "small"), (64, "large")):
            assert mi.regime(B) == regime
            assert _bitwise(r.query(ds.Q[:B]), mi.search(ds.Q[:B])), B


@pytest.fixture(scope="module")
def shard_graphs(ds, cfg):
    """Each shard's graph, as the port's shard engines build it."""
    eps = shard_engines(ds.X, cfg, shards=2, k=10, device="cpu")
    for e in eps:
        e.close()
    return [{f: getattr(e.engine.graph, f).numpy() for f in
             ("neighbors", "lambdas", "degrees", "hubs")} for e in eps]


def test_sharded_router_matches_reference(ds, cfg, thresh, shard_graphs):
    """The reference's merge_shard_results over its own single planes'
    searches (each plane holding one shard's graph; its raw procedure and
    arguments, compiled once for both shards) against the port's sharded
    router over engines on the same graphs: ids exactly, distances within
    1e-6 * (qn + vn), both regimes (B = 5 pads to bucket 8)."""
    import jax
    import jax.numpy as jnp
    from repro.core import distributed as JD
    from repro.core.diversify import PackedGraph as JGraph
    from repro.serve.plane import SingleDevicePlane as JPlane

    cfg_j = dataclasses.replace(get_arch("tsdg-paper"), kernel_backend="xla",
                                **KNOBS)
    rows = [slice(i * 512, (i + 1) * 512) for i in range(2)]
    planes = [JPlane(jnp.asarray(ds.X[r]), cfg_j, graph=JGraph(
        **{f: jnp.asarray(a) for f, a in g.items()}))
        for r, g in zip(rows, shard_graphs)]
    t_eps = [EngineEndpoint(ANNEngine(
        ds.X[r], cfg, k=10, threshold=thresh, device="cpu",
        graph=graph_from_numpy(**g, device="cpu")), name=f"s{i}",
        id_offset=i * 512) for i, (r, g) in enumerate(zip(rows, shard_graphs))]
    norms = (ds.X.astype(np.float64) ** 2).sum(1)
    with Router(t_eps, RouterConfig(mode="sharded", replicas=2,
                                    health_interval_s=0.0)) as tr:
        for B, bucket, kind in ((5, 8, "small"), (64, 64, "large")):
            fn, kw = planes[0]._search_args(kind, 10)
            search = jax.jit(lambda X, nb, lam, deg, hubs, Q: fn(
                X, JGraph(nb, lam, deg, hubs), Q, **kw))
            Q = jnp.asarray(np.pad(ds.Q[:B], ((0, bucket - B), (0, 0)),
                                   mode="edge"))
            pools = [tuple(np.asarray(a)[:B] for a in search(
                p.X, p.graph.neighbors, p.graph.lambdas, p.graph.degrees,
                p.graph.hubs, Q)) for p in planes]
            want_i, want_d = JD.merge_shard_results(
                pools, [0, 512], [512, 512], k=10, batch=B)
            ids, dists = tr.query(ds.Q[:B])
            np.testing.assert_array_equal(ids, want_i)
            tol = 1e-6 * ((ds.Q[:B].astype(np.float64) ** 2).sum(1)[:, None]
                          + norms[want_i])
            assert (np.abs(dists.astype(np.float64) - want_d) <= tol).all()
