"""The port's two search procedures against the JAX reference, on the CPU.

One graph built by the reference (``kernel_backend="xla"``) is carried into
the port with :mod:`repro_torch.ann.convert`, so both packages search the
very same graph from the same ``jax.random`` seeds.  For both regimes and
both visited modes: recall@10 within 0.01 of the reference, and ids equal
on at least 98% of entries (the distances round differently in the last
bits, which may reorder near ties).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import Index as JIndex
from repro.configs.tsdg_paper import reduced as j_reduced
from repro.core.search_large import _large_batch_search as j_large
from repro.core.search_small import _small_batch_search as j_small
from repro.data.synthetic import make_clustered, recall_at_k
from repro_torch.ann import Index
from repro_torch.ann.convert import graph_from_numpy
from repro_torch.configs.tsdg_paper import reduced
from repro_torch.core.search_large import _large_batch_search as t_large
from repro_torch.core.search_small import _small_batch_search as t_small

# the plain versions are small here: one thread each, so the test
# workers running beside this file keep their cores
torch.set_num_threads(1)

SMALL = dict(k=10, t0=4, hops=4, hop_width=8, n_seeds=8)
LARGE = dict(k=10, ef=16, hops=32, n_seeds=8, m_seg=4, seg=8, mv_seg=4,
             segv=8)


@pytest.fixture(scope="module")
def world():
    ds = make_clustered(n=1500, d=16, n_queries=300, seed=5)
    cfg_j = dataclasses.replace(j_reduced(), kernel_backend="xla",
                                bridge_hubs=64)
    ji = JIndex.build(ds.X, cfg_j)
    g = ji.graph
    arrays = [np.asarray(a) for a in (g.neighbors, g.lambdas, g.degrees,
                                      g.hubs)]
    return dict(ds=ds, ji=ji, jgraph=g, arrays=arrays, cfg_j=cfg_j,
                graph=graph_from_numpy(*arrays, device="cpu"),
                X=torch.from_numpy(ds.X), Q=torch.from_numpy(ds.Q))


def _compare(a_ids, b_ids, gt):
    a_ids, b_ids = np.asarray(a_ids), np.asarray(b_ids)
    assert a_ids.shape == b_ids.shape
    assert (a_ids == b_ids).mean() >= 0.98
    assert abs(recall_at_k(a_ids, gt, 10) - recall_at_k(b_ids, gt, 10)) \
        <= 0.01


def _no_dups(ids, N):
    for row in np.asarray(ids).tolist():
        real = [i for i in row if i < N]
        assert len(set(real)) == len(real)


@pytest.mark.parametrize("visited", ["none", "hash"])
@pytest.mark.parametrize("exact_merge", [False, True])
def test_small_batch_matches_reference(world, visited, exact_merge):
    ds, B = world["ds"], 40
    kw = dict(SMALL, visited=visited, exact_merge=exact_merge)
    a, ad = j_small(jnp.asarray(ds.X), world["jgraph"],
                    jnp.asarray(ds.Q[:B]), backend="xla", **kw)
    b, bd = t_small(world["X"], world["graph"], world["Q"][:B], **kw)
    assert b.dtype == torch.int32 and b.shape == (B, 10)
    _compare(a, b.numpy(), ds.gt[:B])
    _no_dups(b.numpy(), 1500)
    np.testing.assert_allclose(bd.numpy(), np.asarray(ad), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("visited,exact_visited,gather_limit",
                         [("none", False, 0), ("hash", False, 0),
                          ("none", True, 0), ("none", False, 6)])
def test_large_batch_matches_reference(world, visited, exact_visited,
                                       gather_limit):
    ds = world["ds"]
    kw = dict(LARGE, visited=visited, exact_visited=exact_visited,
              gather_limit=gather_limit)
    a, ad = j_large(jnp.asarray(ds.X), world["jgraph"], jnp.asarray(ds.Q),
                    backend="xla", **kw)
    b, bd = t_large(world["X"], world["graph"], world["Q"], **kw)
    assert b.dtype == torch.int32 and b.shape == (300, 10)
    _compare(a, b.numpy(), ds.gt)
    _no_dups(b.numpy(), 1500)
    np.testing.assert_allclose(bd.numpy(), np.asarray(ad), rtol=1e-4,
                               atol=1e-3)


@pytest.mark.parametrize("visited", ["none", "hash"])
@pytest.mark.parametrize("B", [10, 300])
def test_index_on_reference_graph_matches(world, visited, B):
    """Through the entry points: the converted graph behind ``Index``,
    with regime dispatch and bucket padding, against ``repro.ann.Index``
    on the same graph."""
    ds = world["ds"]
    cfg_j = dataclasses.replace(world["cfg_j"], visited_filter=visited)
    cfg_t = dataclasses.replace(reduced(), bridge_hubs=64,
                                visited_filter=visited)
    ji = JIndex(ds.X, cfg_j, graph=world["jgraph"])
    ti = Index.from_numpy(ds.X, dict(zip(("neighbors", "lambdas", "degrees",
                                          "hubs"), world["arrays"])),
                          cfg_t, device="cpu")
    assert ti.regime(B) == ji.regime(B) == ("small" if B == 10 else "large")
    a, _ = ji.search(ds.Q[:B])
    b, _ = ti.search(ds.Q[:B])
    _compare(a, b, ds.gt[:B])


def test_push_best_seed_only(world):
    ds = world["ds"]
    kw = dict(LARGE, push_all_seeds=False)
    a, _ = j_large(jnp.asarray(ds.X), world["jgraph"], jnp.asarray(ds.Q),
                   backend="xla", **kw)
    b, _ = t_large(world["X"], world["graph"], world["Q"], **kw)
    _compare(a, b.numpy(), ds.gt)


def test_seed_offsets_match_reference(world):
    """Row seeds depend on the global row index only (seed_offset,
    t0_offset/t0_total), as in the reference."""
    ds = world["ds"]
    a, _ = j_small(jnp.asarray(ds.X), world["jgraph"], jnp.asarray(ds.Q[:8]),
                   backend="xla", seed_offset=3, t0_offset=4, t0_total=8,
                   **SMALL)
    b, _ = t_small(world["X"], world["graph"], world["Q"][:8], seed_offset=3,
                   t0_offset=4, t0_total=8, **SMALL)
    _compare(a, b.numpy(), ds.gt[:8])
    a, _ = j_large(jnp.asarray(ds.X), world["jgraph"], jnp.asarray(ds.Q[:8]),
                   backend="xla", seed_offset=100, **LARGE)
    b, _ = t_large(world["X"], world["graph"], world["Q"][:8],
                   seed_offset=100, **LARGE)
    _compare(a, b.numpy(), ds.gt[:8])


def test_padding_leaves_real_rows_unchanged(world):
    """Edge-padded rows do not change the real rows' answers."""
    X, G, Q = world["X"], world["graph"], world["Q"]
    a, _ = t_small(X, G, Q[:5], **SMALL)
    b, _ = t_small(X, G, torch.cat([Q[:5], Q[4:5].expand(3, -1)]), **SMALL)
    assert torch.equal(a, b[:5])


def test_argument_validation(world):
    X, G, Q = world["X"], world["graph"], world["Q"][:4]
    with pytest.raises(ValueError, match="candidate pool"):
        t_small(X, G, Q, **dict(SMALL, k=33, width=8))
    with pytest.raises(ValueError, match="ranking array"):
        t_large(X, G, Q, **dict(LARGE, k=17))
    with pytest.raises(ValueError, match="visited"):
        t_small(X, G, Q, visited="bloom", **SMALL)
    with pytest.raises(ValueError, match="cannot combine"):
        t_large(X, G, Q, visited="hash", exact_visited=True, **LARGE)
