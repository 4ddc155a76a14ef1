"""Streaming mutability in the port against the JAX reference, on the CPU.

One graph built by the reference (``kernel_backend="xla"``) is carried into
the port, and both packages take the same adds and deletes:

* ``merge_topk`` exactly, with ties, negative ids, pools narrower than k
  and all-invalid rows;
* both searches with ``alive``, and ``Index`` add / delete / search:
  ids equal, no deleted id returned, each added row finds itself;
* ``delete``'s all-or-nothing ``KeyError``s, with the reference's
  messages;
* ``compact()``: ``id_map``, the compacted graph and ``generation``
  exactly;
* the reference's stream triple carried into the port from numpy.
"""
import dataclasses
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import Index as JIndex
from repro.ann.delta import StreamState as JStreamState
from repro.configs.tsdg_paper import reduced as j_reduced
from repro.core.distributed import merge_topk as j_merge_topk
from repro.core.search_large import _large_batch_search as j_large
from repro.core.search_small import _small_batch_search as j_small
from repro.data.synthetic import make_clustered, recall_at_k
from repro_torch.ann import Index
from repro_torch.ann.compaction import effective_corpus
from repro_torch.ann.convert import graph_from_numpy, stream_from_numpy
from repro_torch.ann.delta import StreamState
from repro_torch.configs.tsdg_paper import reduced
from repro_torch.core.distributed import PAD_ID, merge_topk
from repro_torch.core.search_large import _large_batch_search as t_large
from repro_torch.core.search_small import _small_batch_search as t_small

# the plain versions are small here: one thread each, so the test
# workers running beside this file keep their cores
torch.set_num_threads(1)

SMALL = dict(k=10, t0=4, hops=4, hop_width=8, n_seeds=8)
LARGE = dict(k=10, ef=16, hops=32, n_seeds=8, m_seg=4, seg=8, mv_seg=4,
             segv=8)
N, D = 1500, 16
INF = 3.4e38


@pytest.fixture(scope="module")
def world():
    ds = make_clustered(n=N, d=D, n_queries=300, seed=5)
    cfg_j = dataclasses.replace(j_reduced(), kernel_backend="xla",
                                bridge_hubs=64)
    g = JIndex.build(ds.X, cfg_j).graph
    arrays = dict(zip(("neighbors", "lambdas", "degrees", "hubs"),
                      (np.asarray(a) for a in (g.neighbors, g.lambdas,
                                               g.degrees, g.hubs))))
    rng = np.random.default_rng(11)
    V = (ds.X[rng.integers(0, N, 300)]
         + 0.05 * rng.normal(size=(300, D))).astype(np.float32)
    alive = np.ones(N, bool)
    alive[rng.choice(N, 150, replace=False)] = False
    return dict(ds=ds, cfg_j=cfg_j, jgraph=g, arrays=arrays, V=V,
                alive=alive, dead=np.flatnonzero(~alive),
                graph=graph_from_numpy(**arrays, device="cpu"),
                cfg_t=dataclasses.replace(reduced(), bridge_hubs=64))


def _mutate(index, world):
    """The same adds and deletes on either package's index."""
    new = index.add(world["V"])
    index.delete(world["dead"])
    index.delete(new[::5])
    return new


@pytest.fixture(scope="module")
def mutated(world):
    ds = world["ds"]
    ji = JIndex(ds.X, world["cfg_j"], graph=world["jgraph"])
    ti = Index.from_numpy(ds.X, world["arrays"], world["cfg_t"],
                          device="cpu")
    new_j, new_t = _mutate(ji, world), _mutate(ti, world)
    assert np.array_equal(new_j, new_t)
    return dict(ji=ji, ti=ti, new=new_t)


# ----------------------------------------------------------------------
# merge_topk
# ----------------------------------------------------------------------

def _merge_case(case):
    rng = np.random.default_rng(case)
    B, W = 6, 24
    ids = rng.integers(-2, 12, size=(B, W)).astype(np.int32)
    d = (rng.integers(0, 6, size=(B, W)) * 0.25).astype(np.float32)
    d[rng.random((B, W)) < 0.15] = INF
    if case == 1:       # every candidate invalid in two rows
        ids[:2] = -1
        d[2] = INF
    if case == 2:       # one id from several pools, equal distances
        ids[:, ::3] = 5
        d[:, ::3] = 0.5
    return ids, d


@pytest.mark.parametrize("case,k", [(0, 10), (1, 10), (2, 10), (3, 30)])
def test_merge_topk_matches_reference(case, k):
    """Ties, negative ids, all-invalid rows and (k = 30) a pool narrower
    than k: ids and distances exactly."""
    ids, d = _merge_case(case)
    a_ids, a_d = jax.jit(j_merge_topk, static_argnums=2)(
        jnp.asarray(ids), jnp.asarray(d), k)
    b_ids, b_d = merge_topk(torch.from_numpy(ids), torch.from_numpy(d), k)
    assert b_ids.shape == (6, k) and b_ids.dtype == torch.int32
    assert np.array_equal(b_ids.numpy(), np.asarray(a_ids))
    assert np.array_equal(b_d.numpy(), np.asarray(a_d))
    if case == 1:
        assert (b_ids[:3] == PAD_ID).all() and (b_d[:3] == INF).all()
    for row in b_ids.numpy().tolist():
        real = [i for i in row if i >= 0]
        assert len(real) == len(set(real))
    with pytest.raises(ValueError, match="k must be"):
        merge_topk(torch.from_numpy(ids), torch.from_numpy(d), 0)


# ----------------------------------------------------------------------
# the searches with tombstones
# ----------------------------------------------------------------------

@pytest.mark.parametrize("search,kw,B", [(t_small, SMALL, 40),
                                         (t_large, LARGE, 300)])
def test_searches_with_alive_match_reference(world, search, kw, B):
    ds = world["ds"]
    j_search = j_small if search is t_small else j_large
    a, ad = j_search(jnp.asarray(ds.X), world["jgraph"],
                     jnp.asarray(ds.Q[:B]), backend="xla",
                     alive=jnp.asarray(world["alive"]), **kw)
    b, bd = search(torch.from_numpy(ds.X), world["graph"],
                   torch.from_numpy(ds.Q[:B]),
                   alive=torch.from_numpy(world["alive"]), **kw)
    assert np.array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_allclose(bd.numpy(), np.asarray(ad), rtol=1e-5,
                               atol=1e-4)
    assert not np.isin(b.numpy(), world["dead"]).any()


# ----------------------------------------------------------------------
# Index add / delete / search / compact
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B", [10, 300])
def test_index_mutations_match_reference(world, mutated, B):
    ds = world["ds"]
    ji, ti = mutated["ji"], mutated["ti"]
    assert ti.regime(B) == ji.regime(B)
    assert ti.n_active == ji.n_active == N + 300 - 150 - 60
    a, ad = ji.search(ds.Q[:B])
    b, bd = ti.search(ds.Q[:B])
    assert np.array_equal(a, b)
    np.testing.assert_allclose(bd, ad, rtol=1e-5, atol=1e-4)
    dead = np.concatenate([world["dead"], mutated["new"][::5]])
    assert not np.isin(b, dead).any()
    assert ((b >= 0) & (b < N + 300)).all()
    s = ti.stats
    assert s.n_added == 300 and s.n_deleted == 210 and s.stream_batches > 0


def test_added_rows_find_themselves(world, mutated):
    live = np.setdiff1d(mutated["new"], mutated["new"][::5])[:12]
    ids, _ = mutated["ti"].search(world["V"][live - N])
    assert np.array_equal(ids[:, 0], live)


def test_stream_triple_carried_from_numpy(world, mutated):
    """The reference's device view of its mutation log, carried into a
    fresh port index, answers like the port's own mutated index."""
    ds = world["ds"]
    jstream = mutated["ji"].engine.stream
    view = jstream.device_view()
    carried = Index.from_numpy(ds.X, world["arrays"], world["cfg_t"],
                               stream=view + (jstream.delta.count,),
                               device="cpu")
    st = carried.engine.stream
    assert np.array_equal(st.base_alive, view[0])
    assert np.array_equal(st.delta.X, view[1])
    assert np.array_equal(st.delta.alive, view[2])
    assert st.delta.count == jstream.delta.count == 300
    assert carried.n_active == mutated["ji"].n_active
    for B in (10, 300):
        assert np.array_equal(carried.search(ds.Q[:B])[0],
                              mutated["ti"].search(ds.Q[:B])[0])
    # a deleted last add keeps its slot: the count says so, not the mask
    tail_dead = view[2].copy()
    tail_dead[299] = False
    st = stream_from_numpy(view[0], view[1], tail_dead, 300)
    assert st.delta.count == 300 and st.n_total() == N + 300
    assert st.add(view[1][:1]).tolist() == [N + 300]
    with pytest.raises(ValueError, match="below count"):
        stream_from_numpy(view[0], view[1], view[2], 299)
    with pytest.raises(ValueError, match="below count"):
        stream_from_numpy(*view, view[1].shape[0] + 1)
    with pytest.raises(TypeError):
        stream_from_numpy(*view)
    with pytest.raises(ValueError, match="does not match"):
        Index.from_numpy(ds.X[:100], {k: v[:100] for k, v in
                                      world["arrays"].items()
                                      if k != "hubs"},
                         world["cfg_t"], stream=view + (300,), device="cpu")


def test_delete_is_all_or_nothing_with_reference_messages():
    ours, ref = StreamState(10, 4, min_cap=4), JStreamState(10, 4,
                                                            min_cap=4)
    for st in (ours, ref):
        st.add(np.ones((3, 4), np.float32))
        st.delete([2, 11])
    for bad in ([1, 13], [3, 3], [2], [0, -1], np.array([0.5]), [12, 2]):
        msgs = []
        for st in (ours, ref):
            before = (st.base_alive.copy(), st.delta.alive.copy())
            with pytest.raises(KeyError) as e:
                st.delete(bad)
            msgs.append(str(e.value))
            assert np.array_equal(st.base_alive, before[0])
            assert np.array_equal(st.delta.alive, before[1])
        assert msgs[0] == msgs[1]
    assert ours.delete([]) == 0 and ours.delete(np.int64(12)) == 1
    assert ours.n_active() == 10 - 1 + 3 - 2 and ours.delta.cap == 4


def test_delta_capacity_doubles_like_reference():
    ours, ref = StreamState(5, 2, min_cap=3), JStreamState(5, 2, min_cap=3)
    for m in (1, 3, 5, 9):
        V = np.full((m, 2), m, np.float32)
        assert np.array_equal(ours.add(V), ref.add(V))
        assert ours.delta.cap == ref.delta.cap
    for a, b in zip(ours.device_view(), ref.device_view()):
        assert np.array_equal(a, b)


def test_compact_matches_reference(world):
    ds = world["ds"]
    ji = JIndex(ds.X, world["cfg_j"], graph=world["jgraph"])
    ti = Index.from_numpy(ds.X, world["arrays"], world["cfg_t"],
                          device="cpu")
    _mutate(ji, world)
    _mutate(ti, world)
    X_eff, _ = effective_corpus(ti.engine.stream, ds.X)
    m_j, m_t = ji.compact(), ti.compact()
    assert m_t.dtype == np.int64 and np.array_equal(m_j, m_t)
    assert ji.generation == ti.generation == 1
    assert ti.stats.compactions == 1 and ti.engine.stream is None
    assert ti.n_active == ji.n_active == X_eff.shape[0]
    assert np.array_equal(ti.X.numpy(), X_eff)
    for f in ("neighbors", "lambdas", "degrees", "hubs"):
        assert np.array_equal(getattr(ti.graph, f).numpy(),
                              np.asarray(getattr(ji.graph, f))), f
    a, _ = ji.search(ds.Q[:300])
    b, _ = ti.search(ds.Q[:300])
    assert np.array_equal(a, b)
    assert abs(recall_at_k(a, ds.gt[:300], 10)
               - recall_at_k(b, ds.gt[:300], 10)) <= 0.01
    # a clean index compacts to the identity
    assert np.array_equal(ti.compact(), np.arange(X_eff.shape[0]))
    assert ti.generation == 1


def test_mutation_input_validation(world):
    ti = Index.from_numpy(world["ds"].X, world["arrays"], world["cfg_t"],
                          device="cpu")
    with pytest.raises(ValueError, match=r"vectors must be \[m, 16\]"):
        ti.add(np.zeros((3, 15), np.float32))
    with pytest.raises(ValueError, match="empty add"):
        ti.add(np.zeros((0, 16), np.float32))
    with pytest.raises(ValueError, match="numeric"):
        ti.add(np.zeros((2, 16), bool))
    assert ti.add(np.zeros(16, np.int64)).tolist() == [N]
    with pytest.raises(KeyError, match="out of range"):
        ti.delete([N + 1])
    assert ti.n_active == N + 1


def test_concurrent_adds_and_queries_lose_nothing(world):
    """The engine's lock serialises mutations and queries: eight adding
    threads and two querying threads on a short switch interval; every
    add keeps its ids, and every query sees one consistent stream."""
    ti = Index.from_numpy(world["ds"].X, world["arrays"], world["cfg_t"],
                          device="cpu")
    got, errors = [], []
    V = world["V"][:3]

    def adder():
        try:
            for _ in range(5):
                got.append(ti.add(V))
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    def querier():
        try:
            for _ in range(3):
                ids, _ = ti.search(world["ds"].Q[:4])
                assert ((ids >= -1) & (ids < N + 120)).all()
        except Exception as e:  # noqa: BLE001 — reported below
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=adder) for _ in range(8)] + \
            [threading.Thread(target=querier) for _ in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors
    ids = np.sort(np.concatenate(got))
    assert np.array_equal(ids, N + np.arange(120))
    assert ti.stats.n_added == 120 and ti.n_active == N + 120
    assert ti.engine.stream.delta.count == 120
    assert np.array_equal(ti.engine.plane.stream[1][:120].numpy(),
                          np.tile(V, (40, 1)))
