"""The port's graph family (``repro_torch.models.gnn``, ``configs``,
``data/graphs.py``, ``data/sampler.py``,
``convert.gnn_params_from_reference``) against the JAX reference, on the
CPU.

The reference's weights (``init_params`` with ``jax.random.key(0)``; the
leaves that start at zero, biases, LN scales, ``eps``, drawn from numpy
so that they matter) are carried into the port, and the same numpy
graphs go through both.  Integers are equal exactly: the graphs, the
sampler's subgraphs and batches, the neighbour matrix.  Floats (both
sides compute in float32 and sum in different orders):

* ``aggregate``: within 1e-6 of the largest sum of |messages| a node;
  ``"max"`` exactly;
* logits within 1e-5 of the largest |logit| of the reference (the
  layers renormalise, so float32's unit roundoff, 6e-8, grows by at most
  a few hundred through 16 GatedGCN layers);
* the GraphSAGE kernel route (``packed_spmm``'s plain version on the CPU)
  against the edge-list route within the same 1e-5.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jbase
from repro.data import graphs as JDG
from repro.data import sampler as JS
from repro.launch import steps as jsteps
from repro.models import gnn as JG
from repro.models import module as jmodule
from repro_torch import configs as C
from repro_torch.configs import base as tbase
from repro_torch.data import graphs as DG
from repro_torch.data import sampler as S
from repro_torch.models import convert, module
from repro_torch.models import gnn as G

torch.set_num_threads(1)
CPU = torch.device("cpu")
ARCHS = ("gin-tu", "gatedgcn", "graphsage-reddit")
D_FEAT, N_CLASSES = 12, 5
TOL = 1e-5


def _cfgs(arch, full, **knobs):
    get = "get_arch" if full else "get_reduced"
    return (dataclasses.replace(getattr(jbase, get)(arch), **knobs),
            dataclasses.replace(getattr(C, get)(arch), **knobs))


def _ref_params(jcfg, seed=26):
    """The reference's weights as numpy arrays, each zero-init leaf drawn
    from numpy (N(0, 0.1^2))."""
    sch = JG.schema(jcfg, D_FEAT, N_CLASSES)
    params = jax.tree.map(np.asarray, jmodule.init_params(
        sch, jax.random.key(0)))
    rng = np.random.default_rng(seed)
    flat, treedef = jax.tree_util.tree_flatten(params)
    specs = jax.tree_util.tree_flatten(sch, is_leaf=jmodule.is_param_spec)[0]
    flat = [(0.1 * rng.normal(size=a.shape)).astype(np.float32)
            if s.init == "zeros" else a for a, s in zip(flat, specs)]
    return jax.tree_util.tree_unflatten(treedef, flat)


def _community(seed=0):
    return DG.make_community_graph(200, 800, D_FEAT, n_classes=N_CLASSES,
                                   seed=seed)


def _molecules(seed=0):
    return DG.molecule_batch_for_gnn(4, 10, 24, d_feat=D_FEAT,
                                     n_classes=N_CLASSES, seed=seed)


def _sampled(seed=0, fanouts=(3, 2)):
    return next(S.SampledStream(_community(seed), 8, fanouts, seed=seed))


def _reference(params, jcfg, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items() if k != "neighbors"}
    return np.asarray(JG.forward(params, jcfg, jb))


def _port(params, tcfg, batch, **kw):
    model = convert.gnn_params_from_reference(params, tcfg, D_FEAT,
                                              N_CLASSES, device=CPU)
    return G.forward(model, tcfg, G.batch_to(batch, CPU), **kw).numpy()


def _close(got, want, tol=TOL):
    assert got.shape == want.shape and got.dtype == want.dtype
    err = np.abs(got - want).max()
    assert err <= tol * np.abs(want).max(), (err, np.abs(want).max())


# ----------------------------------------------------------------------
# configs and data
# ----------------------------------------------------------------------

@pytest.mark.parametrize("getter", ["get_arch", "get_reduced"])
@pytest.mark.parametrize("arch", ARCHS + ("mace",))
def test_configs_equal_reference(arch, getter):
    got = getattr(C, getter)(arch)
    assert dataclasses.asdict(got) == dataclasses.asdict(
        getattr(jbase, getter)(arch))
    assert C.shapes_for(got) is tbase.GNN_SHAPES
    assert {k: dataclasses.asdict(v) for k, v in tbase.GNN_SHAPES.items()} \
        == {k: dataclasses.asdict(v) for k, v in jbase.GNN_SHAPES.items()}
    assert tbase.GNN_N_CLASSES == jsteps.GNN_N_CLASSES
    assert [f.name for f in dataclasses.fields(tbase.GNNConfig)] == \
        [f.name for f in dataclasses.fields(jbase.GNNConfig)]


def _same(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        assert np.array_equal(got[k], want[k]), k


@pytest.mark.parametrize("seed", [0, 5])
def test_graph_data_equals_reference(seed):
    _same(_community(seed), JDG.make_community_graph(
        200, 800, D_FEAT, n_classes=N_CLASSES, seed=seed))
    _same(DG.make_community_graph(300, 2000, 7, seed=seed, p_intra=0.5),
          JDG.make_community_graph(300, 2000, 7, seed=seed, p_intra=0.5))
    _same(DG.make_molecules(3, 12, 30, seed=seed),
          JDG.make_molecules(3, 12, 30, seed=seed))
    _same(_molecules(seed), JDG.molecule_batch_for_gnn(
        4, 10, 24, d_feat=D_FEAT, n_classes=N_CLASSES, seed=seed))


@pytest.mark.parametrize("fanouts", [(3, 2), (5,), (4, 3, 2)])
def test_sampler_equals_reference(fanouts):
    """The CSR, a subgraph, ``subgraph_sizes`` and three batches of the
    stream, bit for bit (the port's batches add ``"neighbors"``)."""
    g = _community(1)
    n = g["node_feat"].shape[0]
    got = S.NeighborSampler(g["edge_src"], g["edge_dst"], n)
    want = JS.NeighborSampler(g["edge_src"], g["edge_dst"], n)
    assert np.array_equal(got.nbr, want.nbr)
    assert np.array_equal(got.offsets, want.offsets)
    seeds = np.arange(0, n, 17)
    _same(got.sample_subgraph(seeds, fanouts, np.random.default_rng(2)),
          want.sample_subgraph(seeds, fanouts, np.random.default_rng(2)))
    assert S.subgraph_sizes(16, fanouts) == JS.subgraph_sizes(16, fanouts)
    mine, ref = S.SampledStream(g, 16, fanouts, seed=4), \
        JS.SampledStream(g, 16, fanouts, seed=4)
    for _ in range(3):
        b, r = next(mine), next(ref)
        nbrs = b.pop("neighbors")
        _same(b, r)
        assert nbrs.dtype == np.int32
        assert nbrs.shape == (S.subgraph_sizes(16, fanouts)[0],
                              max(fanouts))


@pytest.mark.parametrize("batch_nodes,fanouts", [
    (8, (3, 2)), (5, (4,)), (3, (2, 5, 3)), (1, (15, 10)), (2, (1, 1))])
@pytest.mark.parametrize("masked", [False, True])
def test_fanout_neighbors_equals_edge_lists(batch_nodes, fanouts, masked):
    """Each row's valid lanes are exactly the ``edge_src`` of the edges
    whose ``edge_dst`` is that row, in edge order; every other lane is
    the sentinel N."""
    g = _community(2)
    sampler = S.NeighborSampler(g["edge_src"], g["edge_dst"], 200)
    sub = sampler.sample_subgraph(np.arange(batch_nodes), fanouts,
                                  np.random.default_rng(0))
    n, e = S.subgraph_sizes(batch_nodes, fanouts)
    assert (len(sub["node_ids"]), len(sub["edge_src"])) == (n, e)
    mask = np.random.default_rng(1).random(e) < 0.7 if masked else None
    nbrs = S.fanout_neighbors(batch_nodes, fanouts, mask)
    assert nbrs.shape == (n, max(fanouts, default=0))
    assert nbrs.dtype == np.int32
    keep = np.ones(e, bool) if mask is None else mask
    for i in range(n):
        want = sub["edge_src"][(sub["edge_dst"] == i) & keep]
        row = nbrs[i]
        assert np.array_equal(row[row != n], want), i
        if mask is None:    # the valid lanes come first
            assert (row[len(want):] == n).all(), i
    if masked:
        with pytest.raises(ValueError, match="edges"):
            S.fanout_neighbors(batch_nodes, fanouts, mask[:-1])


# ----------------------------------------------------------------------
# message passing
# ----------------------------------------------------------------------

@pytest.mark.parametrize("kind", ["sum", "mean", "max"])
@pytest.mark.parametrize("mask", ["none", "some", "all"])
def test_aggregate_matches_reference(kind, mask):
    """Over 40 nodes, 150 edges: node 0 has no edge at all, node 1 only
    masked edges (with a mask), the rest random."""
    rng = np.random.default_rng(7)
    E, N, d = 150, 40, 6
    msg = rng.normal(size=(E, d)).astype(np.float32)
    dst = rng.integers(2, N, size=E).astype(np.int32)
    dst[:5] = 1
    emask = {"none": None, "some": rng.random(E) < 0.6,
             "all": np.zeros(E, bool)}[mask]
    if emask is not None:
        emask[:5] = False
    want = np.asarray(JG.aggregate(
        jnp.asarray(msg), jnp.asarray(dst), N, kind=kind,
        edge_mask=None if emask is None else jnp.asarray(emask)))
    got = G.aggregate(torch.from_numpy(msg), torch.from_numpy(dst), N,
                      kind=kind, edge_mask=None if emask is None
                      else torch.from_numpy(emask)).numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    if kind == "max":
        assert np.array_equal(got, want)
        assert (got[0] == 0).all()
        if emask is not None:
            assert (got[1] == np.finfo(np.float32).min).all()
    else:
        scale = G.aggregate(torch.from_numpy(np.abs(msg)),
                            torch.from_numpy(dst), N, kind="sum").numpy()
        assert (np.abs(got - want) <= 1e-6 * scale.max()).all()
    with pytest.raises(ValueError):
        G.aggregate(torch.from_numpy(msg), torch.from_numpy(dst), N,
                    kind="gated")


@pytest.mark.parametrize("full", [False, True])
def test_schema_equals_reference(full):
    for arch in ARCHS:
        jcfg, tcfg = _cfgs(arch, full)
        got = list(module.leaves(G.schema(tcfg, D_FEAT, N_CLASSES)))
        want = jax.tree_util.tree_flatten_with_path(
            JG.schema(jcfg, D_FEAT, N_CLASSES),
            is_leaf=jmodule.is_param_spec)[0]
        assert [p for p, _ in got] == [
            ".".join(k.key for k in path) for path, _ in want]
        for (path, s), (_, w) in zip(got, want):
            assert (s.shape, s.logical_axes, s.init, s.scale) == (
                w.shape, w.logical_axes, w.init, w.scale), path


# ----------------------------------------------------------------------
# forward
# ----------------------------------------------------------------------

CASES = [("gin-tu", {}), ("gin-tu", {"learnable_eps": False}),
         ("gatedgcn", {}), ("graphsage-reddit", {}),
         ("graphsage-reddit", {"aggregator": "sum"}),
         ("graphsage-reddit", {"aggregator": "max"})]


@pytest.mark.parametrize("graph", ["community", "molecules", "sampled"])
@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("arch,knobs", CASES)
def test_forward_matches_reference(arch, knobs, full, graph):
    """Logits of the reduced and the full-width model (the config's own
    layers and widths) on a community graph (node task), a molecule batch
    (graph task, mean pool) and a ``SampledStream`` batch (the GraphSAGE
    kernel route where it applies)."""
    jcfg, tcfg = _cfgs(arch, full, **knobs)
    batch = {"community": _community, "molecules": _molecules,
             "sampled": _sampled}[graph]()
    params = _ref_params(jcfg)
    want = _reference(params, jcfg, batch)
    got = _port(params, tcfg, batch)
    assert np.isfinite(want).all()
    _close(got, want)


@pytest.mark.parametrize("aggregator", ["mean", "sum"])
@pytest.mark.parametrize("full", [False, True])
def test_kernel_route_equals_edge_list(aggregator, full):
    """GraphSAGE over a sampled batch: ``neighbors`` through
    ``packed_spmm``'s plain version against the same batch without it
    (the edge list), within 1e-5 of the largest |logit|; masked edges
    (cleared in both) and rows with no child give the same 0."""
    _, tcfg = _cfgs("graphsage-reddit", full, aggregator=aggregator)
    jcfg, _ = _cfgs("graphsage-reddit", full, aggregator=aggregator)
    params = _ref_params(jcfg)
    model = convert.gnn_params_from_reference(params, tcfg, D_FEAT,
                                              N_CLASSES, device=CPU)
    batch = _sampled(3, (4, 3))
    mask = np.random.default_rng(0).random(len(batch["edge_src"])) < 0.8
    for emask in (batch["edge_mask"], mask):
        b = dict(batch, edge_mask=emask,
                 neighbors=S.fanout_neighbors(8, (4, 3), emask))
        tb = G.batch_to(b, CPU)
        assert G.kernel_route(tcfg, tb)
        got = G.forward(model, tcfg, tb).numpy()
        del tb["neighbors"]
        edge = G.forward(model, tcfg, tb).numpy()
        _close(got, edge)
        _close(got, _reference(params, jcfg, b))


def test_sentinel_rows_aggregate_to_zero():
    """A row whose lanes are all the sentinel (a last-layer node, or a
    node whose edges are all masked) contributes exactly 0, as the
    reference's s / max(cnt, 1)."""
    h = torch.randn(7, 4, generator=torch.Generator().manual_seed(0))
    w = torch.randn(4, 3, generator=torch.Generator().manual_seed(1))
    nbrs = torch.tensor([[1, 2], [7, 7], [3, 7], [7, 7], [4, 5], [7, 7],
                         [7, 7]], dtype=torch.int32)
    for combine in ("mean", "sum"):
        out = G.neighbor_product(nbrs, h, w, combine=combine)
        assert (out[[1, 3, 5, 6]] == 0).all()
        assert torch.equal(out[2], (h[3] @ w))


def test_init_params_gnn_module_runs():
    """``init_params`` (a seeded torch generator) into the module, its
    parameter names the reference's leaf paths."""
    for arch in ARCHS:
        cfg = C.get_reduced(arch)
        sch = G.schema(cfg, D_FEAT, N_CLASSES)
        model = G.GNN(cfg, module.init_params(
            sch, torch.Generator().manual_seed(0), device=CPU))
        assert sorted(n for n, _ in model.named_parameters()) == \
            [p for p, _ in module.leaves(sch)]
        out = model(G.batch_to(_community(), CPU))
        assert out.shape == (200, N_CLASSES) and bool(
            torch.isfinite(out).all())


def test_convert_checks_leaves_and_shapes():
    jcfg, tcfg = _cfgs("gatedgcn", False)
    params = _ref_params(jcfg)
    tree = dict(params, layers=dict(params["layers"]))
    del tree["layers"]["ln_e"]
    with pytest.raises(ValueError, match="missing"):
        convert.gnn_params_from_reference(tree, tcfg, D_FEAT, N_CLASSES,
                                          device=CPU)
    tree = dict(params, edge_init=np.zeros(3, np.float32))
    with pytest.raises(ValueError, match="edge_init: shape"):
        convert.gnn_params_from_reference(tree, tcfg, D_FEAT, N_CLASSES,
                                          device=CPU)
    with pytest.raises(ValueError, match="encoder.w: shape"):
        convert.gnn_params_from_reference(params, tcfg, D_FEAT + 1,
                                          N_CLASSES, device=CPU)


def test_kernel_backend_cuda_on_the_cpu_raises():
    jcfg, tcfg = _cfgs("graphsage-reddit", False)
    model = convert.gnn_params_from_reference(_ref_params(jcfg), tcfg,
                                              D_FEAT, N_CLASSES, device=CPU)
    tb = G.batch_to(_sampled(), CPU)
    with pytest.raises(ValueError, match="needs CUDA"):
        G.forward(model, tcfg, tb, kernel_backend="cuda")
    with pytest.raises(ValueError, match="needs CUDA"):
        G.neighbor_product(tb["neighbors"], tb["node_feat"],
                           torch.zeros(D_FEAT, 2), combine="mean",
                           kernel_backend="cuda")
    with pytest.raises(ValueError, match="must be one of"):
        G.forward(model, tcfg, tb, kernel_backend="pallas")


def test_stable_argsort_equals_numpy():
    """The CSR's and the community graph's radix sort: numpy's stable
    order exactly, ties kept in place, keys up to 2^32 - 1."""
    rng = np.random.default_rng(3)
    for keys in (rng.integers(0, 2 ** 32, 5000), np.full(9, 2 ** 32 - 1),
                 rng.integers(0, 7, 5000).astype(np.int32),
                 rng.integers(0, 300_000, 20_000), np.zeros(0, np.int64)):
        assert np.array_equal(DG.stable_argsort(keys),
                              np.argsort(keys, kind="stable"))
    with pytest.raises(ValueError, match="keys"):
        DG.stable_argsort(np.array([3, -1]))
