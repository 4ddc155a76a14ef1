"""The locality-packed layout in the port (``repro_torch.ann.layout``, the
searches' ``graph.perm``, the ``"layout"`` stage and ``packed=``), on the
CPU, against the JAX reference.

One graph is built by the port and carried into the reference as numpy
arrays, so both packages lay out and search the very same graph:

* ``locality_order`` and ``apply_layout`` equal the reference's bit for
  bit; ``unpack_rows``, ``span_group`` and ``span_stats`` too;
* the port's packed searches (small and large, ``"none"``/``"hash"``,
  fp32/int8) meet the search parity contract against the reference's
  packed searches on the same packed graph and seeds: ids equal on >= 98%
  of entries, recall@10 within 0.01;
* the port's packed searches answer bit for bit as its unpacked ones;
* on a packed ``Index``, adds and deletes speak external ids, and
  ``compact()`` equals a cold packed build of the trimmed corpus.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import layout as JL
from repro.ann.quantize import quantize_rows as j_quantize
from repro.core.diversify import PackedGraph as JGraph
from repro.core.search_large import _large_batch_search as j_large
from repro.core.search_small import _small_batch_search as j_small
from repro.data.synthetic import make_clustered, recall_at_k
from repro_torch.ann import Index
from repro_torch.ann import layout as TL
from repro_torch.ann.convert import graph_from_numpy
from repro_torch.configs.base import ANNConfig
from repro_torch.configs.tsdg_paper import reduced
from repro_torch.core.search_large import _large_batch_search as t_large
from repro_torch.core.search_small import _small_batch_search as t_small

# the plain versions are small here: one thread, so the test workers
# running beside this file keep their cores
torch.set_num_threads(1)

N = 1200
SMALL = dict(k=10, t0=4, hops=4, hop_width=8, n_seeds=8)
LARGE = dict(k=10, ef=16, hops=24, n_seeds=8, m_seg=4, seg=8, mv_seg=4,
             segv=8)
PACKED_PIPE = ("knn", "diversify", "bridges", "layout")


@pytest.fixture(scope="module")
def world():
    """A graph built by the port, its layout by the reference, and both
    packages' packed and unpacked operands."""
    ds = make_clustered(n=N, d=16, n_queries=100, seed=5)
    cfg = dataclasses.replace(reduced(), bridge_hubs=64)
    g = Index.build(ds.X, cfg, device="cpu").graph
    nb, lam, deg, hubs = (t.numpy() for t in (g.neighbors, g.lambdas,
                                              g.degrees, g.hubs))
    perm = JL.locality_order(nb, starts=hubs)
    Xp, nbp, lamp, degp, hubsp = JL.apply_layout(perm, ds.X, nb, lam, deg,
                                                 hubs)
    codes, scales = (np.array(a) for a in j_quantize(jnp.asarray(ds.X)))
    return dict(
        ds=ds, cfg=cfg, arrays=(nb, lam, deg, hubs),
        packed=(Xp, nbp, lamp, degp, hubsp, perm),
        j_graph=JGraph(*(jnp.asarray(a) for a in (nbp, lamp, degp, hubsp)),
                       perm=jnp.asarray(perm)),
        t_graph=graph_from_numpy(nbp, lamp, degp, hubsp, perm,
                                 device="cpu"),
        t_unpacked=graph_from_numpy(nb, lam, deg, hubs, device="cpu"),
        quant=(codes, scales),
        quant_packed=(codes[perm], scales[perm]))


def _compare(a_ids, b_ids, gt):
    a_ids, b_ids = np.asarray(a_ids), np.asarray(b_ids)
    assert a_ids.shape == b_ids.shape
    assert (a_ids == b_ids).mean() >= 0.98
    assert abs(recall_at_k(a_ids, gt, 10) - recall_at_k(b_ids, gt, 10)) \
        <= 0.01


def _bitwise(a, b):
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))


# ----------------------------------------------------------------------
# the host layout, against the reference
# ----------------------------------------------------------------------

@pytest.mark.parametrize("starts", [False, True])
def test_locality_order_matches_reference(world, starts):
    nb, _, _, hubs = world["arrays"]
    s = hubs if starts else None
    np.testing.assert_array_equal(TL.locality_order(nb, starts=s),
                                  JL.locality_order(nb, starts=s))
    # repeated lanes, sentinels and isolated nodes on a random graph
    rng = np.random.default_rng(11)
    rnd = rng.integers(0, 301, size=(300, 6)).astype(np.int32)
    rnd[:20] = 300
    s = [7, 3, 299] if starts else None
    got = TL.locality_order(rnd, starts=s)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, JL.locality_order(rnd, starts=s))


def test_apply_layout_matches_reference(world):
    ds, (nb, lam, deg, hubs) = world["ds"], world["arrays"]
    perm = world["packed"][-1]
    got = TL.apply_layout(perm, ds.X, nb, lam, deg, hubs)
    for a, b in zip(got, world["packed"][:5]):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    np.testing.assert_array_equal(TL.inverse_permutation(perm),
                                  JL.inverse_permutation(perm))
    assert TL.apply_layout(perm, ds.X, nb, lam, deg)[4] is None


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_unpack_rows_matches_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    X = rng.standard_normal((48, 5)).astype(np.float32)
    perm = np.concatenate([rng.permutation(48 // n_shards)
                           for _ in range(n_shards)]).astype(np.int32)
    got = TL.unpack_rows(X, perm, n_shards=n_shards)
    np.testing.assert_array_equal(
        got, JL.unpack_rows(X, perm, n_shards=n_shards))
    n_local = 48 // n_shards
    off = (np.arange(48) // n_local) * n_local
    np.testing.assert_array_equal(got[off + perm], X)


def test_unpack_rows_rejects_ragged_shards():
    with pytest.raises(ValueError, match="not divisible"):
        TL.unpack_rows(np.zeros((10, 2), np.float32), np.arange(10),
                       n_shards=4)


def test_span_stats_match_reference(world):
    nb = world["arrays"][0]
    nbp = world["packed"][1]
    for C in range(1, 33):
        assert TL.span_group(C) == JL.span_group(C)
    for adj in (nb, nbp, nbp[:, :6]):
        for group in (None, 2, 4, 3):
            assert TL.span_stats(adj, group=group) \
                == JL.span_stats(adj, group=group)
    # the packed layout coalesces; the build's order barely does
    assert TL.span_stats(nbp)["frac_coalesced"] \
        > TL.span_stats(nb)["frac_coalesced"]


# ----------------------------------------------------------------------
# the packed searches
# ----------------------------------------------------------------------

def _search_kwargs(regime, visited, quant, q):
    kw = dict(SMALL if regime == "small" else LARGE, visited=visited)
    if quant:
        kw.update(codes=q[0], scales=q[1], rerank_mult=4)
    return kw


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("visited", ["none", "hash"])
@pytest.mark.parametrize("regime", ["small", "large"])
def test_packed_search_matches_reference(world, regime, visited, quant):
    ds, Xp = world["ds"], world["packed"][0]
    B = 40 if regime == "small" else 100
    j_fn, t_fn = (j_small, t_small) if regime == "small" \
        else (j_large, t_large)
    qp = world["quant_packed"]
    a, ad = j_fn(jnp.asarray(Xp), world["j_graph"], jnp.asarray(ds.Q[:B]),
                 backend="xla", **_search_kwargs(
                     regime, visited, quant,
                     tuple(jnp.asarray(x) for x in qp)))
    b, bd = t_fn(torch.from_numpy(Xp), world["t_graph"],
                 torch.from_numpy(ds.Q[:B]), **_search_kwargs(
                     regime, visited, quant,
                     tuple(torch.from_numpy(x) for x in qp)))
    _compare(a, b.numpy(), ds.gt[:B])
    assert ((b.numpy() >= 0) & (b.numpy() < N)).all()
    np.testing.assert_allclose(bd.numpy(), np.asarray(ad), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("visited", ["none", "hash"])
@pytest.mark.parametrize("regime", ["small", "large"])
def test_packed_search_equals_unpacked(world, regime, visited, quant):
    """The same graph in either order, the same answers, bit for bit;
    with a tombstone mask (external ids) too."""
    ds, Xp = world["ds"], world["packed"][0]
    B = 16 if regime == "small" else 64
    fn = t_small if regime == "small" else t_large
    Q = torch.from_numpy(ds.Q[:B])
    alive = torch.from_numpy(np.random.default_rng(2).random(N) > 0.05)
    for extra in ({}, dict(alive=alive)):
        u = fn(torch.from_numpy(ds.X), world["t_unpacked"], Q, **extra,
               **_search_kwargs(regime, visited, quant, tuple(
                   torch.from_numpy(x) for x in world["quant"])))
        p = fn(torch.from_numpy(Xp), world["t_graph"], Q, **extra,
               **_search_kwargs(regime, visited, quant, tuple(
                   torch.from_numpy(x) for x in world["quant_packed"])))
        _bitwise(u, p)


def test_packed_search_argument_checks(world):
    Xp, Q = torch.from_numpy(world["packed"][0]), torch.zeros((2, 16))
    with pytest.raises(ValueError, match="hop_width >= max_degree"):
        t_small(Xp, world["t_graph"], Q, **dict(SMALL, hop_width=4))
    with pytest.raises(ValueError, match="gather_limit"):
        t_large(Xp, world["t_graph"], Q, gather_limit=4, **LARGE)


# ----------------------------------------------------------------------
# the packed index: build, stream, compact
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def small_cfg():
    return ANNConfig(max_degree=8, hop_width=8, k_graph=12, n_seeds=4,
                     small_t0=4, small_hops=3, large_ef=24, large_hops=10,
                     serve_buckets=(8, 64), visited_filter="hash")


def test_packed_index_streams_in_external_ids(small_cfg):
    rng = np.random.default_rng(7)
    X = rng.standard_normal((384, 24)).astype(np.float32)
    Qs = rng.standard_normal((4, 24)).astype(np.float32)
    cfg = dataclasses.replace(small_cfg, build_pipeline=PACKED_PIPE)
    plain = Index.build(X, small_cfg, device="cpu")
    idx = Index.build(X, cfg, device="cpu")
    assert set(idx.build_seconds) == set(PACKED_PIPE)
    assert idx.graph.perm is not None and plain.graph.perm is None
    assert idx.plane._ops[-1] is idx.graph.perm  # perm rides last
    np.testing.assert_array_equal(idx.X.numpy(),
                                  X[idx.graph.perm.numpy()])
    for Q in (Qs, rng.standard_normal((64, 24)).astype(np.float32)):
        a, b = plain.search(Q, k=5), idx.search(Q, k=5)
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1].tobytes() == b[1].tobytes()
    victim = int(idx.search(Qs, k=1)[0][0, 0])
    V = rng.standard_normal((3, 24)).astype(np.float32)
    new_ids = idx.add(V)
    assert new_ids.tolist() == [384, 385, 386]
    idx.delete([victim, int(new_ids[0])])
    ids, _ = idx.search(Qs, k=5)
    assert victim not in ids and int(new_ids[0]) not in ids
    ids, _ = idx.search(V[1:], k=1)
    assert ids[:, 0].tolist() == new_ids[1:].tolist()
    id_map = idx.compact()
    assert id_map[victim] == -1 and id_map[int(new_ids[0])] == -1
    assert id_map[int(new_ids[1])] == 383
    assert idx.generation == 1 and idx.graph.perm is not None
    ids, _ = idx.search(Qs, k=5)
    assert victim not in ids


def test_packed_compaction_equals_cold_build(small_cfg):
    rng = np.random.default_rng(7)
    X = rng.standard_normal((384, 24)).astype(np.float32)
    Qs = rng.standard_normal((4, 24)).astype(np.float32)
    cfg = dataclasses.replace(small_cfg, build_pipeline=PACKED_PIPE,
                              visited_filter="none")
    idx = Index.build(X, cfg, device="cpu")
    idx.delete([0, 1])
    idx.compact()
    cold = Index.build(X[2:], cfg, device="cpu")
    torch.testing.assert_close(idx.graph.perm, cold.graph.perm, rtol=0,
                               atol=0)
    a, b = idx.search(Qs, k=5), cold.search(Qs, k=5)
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1].tobytes() == b[1].tobytes()


@pytest.mark.parametrize("kw,match", [
    (dict(gather_limit=4), "gather_limit"),
    (dict(hop_width=4), "hop_width >= max_degree"),
])
def test_layout_config_checks(kw, match):
    base = dict(max_degree=8, hop_width=8, build_pipeline=PACKED_PIPE)
    with pytest.raises(ValueError, match=match):
        ANNConfig(**dict(base, **kw))
    ANNConfig(**base)  # the checks pass a packed config that fits
