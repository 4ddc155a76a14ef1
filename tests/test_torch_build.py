"""The port's index build against the JAX reference, on the CPU.

Same numpy data through both packages (the reference always with
``kernel_backend="xla"``):

* ``nn_descent`` k-NN recall within 0.01 of the reference's;
* the diversify stages run on the reference's own k-NN lists agree on at
  least 99.9% of keep / λ entries (distance rounding may flip a borderline
  occlusion test);
* the pieces that are pure integer bookkeeping (reverse lists, hub draws)
  match exactly;
* a search of the port-built graph reaches the recall of the
  reference-built one within 0.01.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann.pipeline import build_graph as j_build_graph
from repro.configs.tsdg_paper import reduced as j_reduced
from repro.core import diversify as JD
from repro.core import knn_build as JK
from repro.data.synthetic import make_clustered
from repro_torch.ann import build_graph, build_stages, register_stage
from repro_torch.configs.tsdg_paper import reduced
from repro_torch.core import diversify as TD
from repro_torch.core import knn_build as TK

# the plain versions are small here: one thread each, so the test
# workers running beside this file keep their cores
torch.set_num_threads(1)

K = 8


def _knn_recall(ids, exact):
    hits = sum(len(set(a) & set(b)) for a, b in zip(ids.tolist(),
                                                    exact.tolist()))
    return hits / exact.size


@pytest.fixture(scope="module")
def data():
    ds = make_clustered(n=1200, d=16, n_queries=64, seed=3)
    X = ds.X
    ex_ids, _ = JK.exact_knn(jnp.asarray(X), K)
    j_ids, j_d = JK.nn_descent(jnp.asarray(X), K, backend="xla")
    return dict(ds=ds, X=X, exact=np.array(ex_ids),
                j_ids=np.array(j_ids), j_d=np.array(j_d))


def test_exact_knn_matches_reference(data):
    ids, d = TK.exact_knn(torch.from_numpy(data["X"]), K, tile=500)
    agree = (ids.numpy() == data["exact"]).mean()
    assert agree >= 0.999
    assert _knn_recall(ids.numpy(), data["exact"]) >= 0.999


def test_nn_descent_recall_matches_reference(data):
    ids, d = TK.nn_descent(torch.from_numpy(data["X"]), K)
    assert ids.dtype == torch.int32 and ids.shape == (1200, K)
    assert (torch.diff(d, dim=1) >= 0).all()
    r_t = _knn_recall(ids.numpy(), data["exact"])
    r_j = _knn_recall(data["j_ids"], data["exact"])
    assert abs(r_t - r_j) <= 0.01
    assert r_t > 0.8


@pytest.mark.parametrize("cap", [4, 8])
def test_reverse_neighbors_exact(data, cap):
    ids = data["j_ids"]
    valid = np.random.default_rng(0).random(ids.shape) > 0.2
    ref = np.asarray(JK.reverse_neighbors(jnp.asarray(ids),
                                          jnp.asarray(valid), cap))
    ours = TK.reverse_neighbors(torch.from_numpy(ids),
                                torch.from_numpy(valid), cap)
    assert np.array_equal(ours.numpy(), ref)


def test_diversify_tiles_on_reference_knn(data):
    """Relaxed GD keep masks and soft-GD λ on the reference's k-NN lists."""
    X, ids, d = data["X"], data["j_ids"], data["j_d"]
    cfg = reduced()
    keep_j = np.array(JD.relaxed_gd(jnp.asarray(X), jnp.asarray(ids),
                                    jnp.asarray(d), alpha=cfg.alpha,
                                    metric="l2", tile=512, backend="xla"))
    Xt, it, dt = (torch.from_numpy(a) for a in (X, ids, d))
    keep_t = TD.relaxed_gd(Xt, it, dt, alpha=cfg.alpha, metric="l2",
                           tile=512).numpy()
    assert (keep_t == keep_j).mean() >= 0.999
    adj_j, adj_dj = JD.append_reverse(jnp.asarray(X), jnp.asarray(ids),
                                      jnp.asarray(d), jnp.asarray(keep_j),
                                      rev_cap=K, metric="l2", backend="xla")
    adj_t, adj_dt = TD.append_reverse(Xt, it, dt, torch.from_numpy(keep_j),
                                      rev_cap=K, metric="l2")
    assert (adj_t.numpy() == np.asarray(adj_j)).mean() >= 0.999
    lam_j = np.concatenate([np.asarray(JD.occlusion_factors_tile(
        jnp.asarray(X), adj_j[s:s + 512], adj_dj[s:s + 512], metric="l2",
        backend="xla")) for s in range(0, 1200, 512)])
    lam_t = np.concatenate([TD.occlusion_factors_tile(
        Xt, torch.from_numpy(np.array(adj_j[s:s + 512])),
        torch.from_numpy(np.array(adj_dj[s:s + 512])),
        metric="l2").numpy() for s in range(0, 1200, 512)])
    assert (lam_t == lam_j).mean() >= 0.999
    nj, lj, dj = JD.soft_gd(jnp.asarray(X), adj_j, adj_dj, lambda0=8,
                            max_degree=K, metric="l2", backend="xla")
    nt, lt, dg = TD.soft_gd(Xt, torch.from_numpy(np.array(adj_j)),
                            torch.from_numpy(np.array(adj_dj)), lambda0=8,
                            max_degree=K, metric="l2")
    assert (nt.numpy() == np.asarray(nj)).mean() >= 0.999
    assert (lt.numpy() == np.asarray(lj)).mean() >= 0.999
    assert (dg.numpy() == np.asarray(dj)).mean() >= 0.999


def test_add_bridges_matches_reference(data):
    """Hub draws (choice without replacement) are bitwise; the spliced
    rows agree entry for entry."""
    X = data["X"]
    nbrs = data["j_ids"]
    lams = np.sort(np.random.default_rng(1).integers(0, 9, nbrs.shape),
                   axis=1).astype(np.int32)
    jn, jl, jh = JD.add_bridges(jnp.asarray(X), jnp.asarray(nbrs),
                                jnp.asarray(lams), n_hubs=64, hub_k=4,
                                metric="l2")
    tn, tl, th = TD.add_bridges(torch.from_numpy(X), torch.from_numpy(nbrs),
                                torch.from_numpy(lams), n_hubs=64, hub_k=4,
                                metric="l2")
    assert np.array_equal(th.numpy(), np.asarray(jh))
    assert (tn.numpy() == np.asarray(jn)).mean() >= 0.999
    assert np.array_equal(tl.numpy(), np.asarray(jl))


def test_build_graph_matches_reference(data):
    """The whole pipeline: same graph shape, degree and λ order; a search
    of each graph with the reference's own procedure reaches the same
    recall within 0.01."""
    from repro.ann import Index as JIndex
    from repro.core.diversify import PackedGraph as JGraph
    from repro.data.synthetic import recall_at_k

    X, ds = data["X"], data["ds"]
    cfg_t = dataclasses.replace(reduced(), bridge_hubs=64)
    cfg_j = dataclasses.replace(j_reduced(), bridge_hubs=64,
                                kernel_backend="xla")
    timings = {}
    g_t = build_graph(X, cfg_t, device="cpu", timings=timings)
    g_j = j_build_graph(jnp.asarray(X), cfg_j)
    assert set(timings) == {"knn", "diversify", "bridges"}
    assert g_t.neighbors.shape == (1200, K)
    assert (torch.diff(g_t.lambdas, dim=1) >= 0).all()
    assert (g_t.neighbors.numpy() == np.asarray(g_j.neighbors)).mean() \
        >= 0.99
    as_j = JGraph(*(jnp.asarray(a.numpy()) for a in (
        g_t.neighbors, g_t.lambdas, g_t.degrees, g_t.hubs)))
    rec = []
    for g in (as_j, g_j):
        ids, _ = JIndex(X, cfg_j, graph=g).search(ds.Q)
        rec.append(recall_at_k(ids, ds.gt, 10))
    assert abs(rec[0] - rec[1]) <= 0.01


def test_stage_registry():
    assert {"knn", "diversify", "bridges"} <= set(build_stages())
    seen = []

    @register_stage("test_torch_noop")
    def _noop(state):
        seen.append(state.X.shape)

    X = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    cfg = dataclasses.replace(reduced(), bridge_hubs=0)
    g = build_graph(X, cfg, device="cpu",
                    stages=("knn", "diversify", "test_torch_noop"))
    assert seen == [(64, 8)] and g.hubs is None
    with pytest.raises(KeyError, match="did you mean"):
        build_graph(X, cfg, device="cpu", stages=("knn", "diversfy"))
    with pytest.raises(ValueError, match="produced no graph"):
        build_graph(X, cfg, device="cpu", stages=("knn",))



def test_tiled_map_stacks_like_reference():
    def fn(i):
        return i * np.ones(3, np.int32), i + 0.5

    ref = JK.tiled_map(lambda i: (i * jnp.ones(3, jnp.int32), i + 0.5), 4)
    ours = TK.tiled_map(lambda i: tuple(torch.as_tensor(a) for a in fn(i)),
                        4)
    for a, b in zip(ours, ref):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert TK.tiled_map(lambda i: torch.tensor([i, -i]), 2).tolist() \
        == [[0, 0], [1, -1]]
