"""Int8 residency in the port against the JAX reference, on the CPU.

The reference (``kernel_backend="xla"``) builds one graph; its int8 codes
and scales are carried into the port with :mod:`repro_torch.ann.convert`,
so both packages score the same codes from the same seeds:

* ``quantize_rows``: codes and scales bit for bit;
* ``neighbor_distances`` / ``seed_select`` with ``scales`` and
  ``scan_distances`` (fp32 and int8): within 1e-6 * (qn + vn) per entry;
* both searches with ``codes`` at ``rerank_mult`` 1 and 4, and ``Index``
  with ``quantization="int8"``: ids equal, recall within 0.01.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import Index as JIndex
from repro.ann.quantize import quantize_rows as j_quantize_rows
from repro.configs.tsdg_paper import reduced as j_reduced
from repro.core import hotpath as JHP
from repro.core.search_large import _large_batch_search as j_large
from repro.core.search_small import _small_batch_search as j_small
from repro.data.synthetic import make_clustered, recall_at_k
from repro_torch.ann import Index
from repro_torch.ann.convert import graph_from_numpy
from repro_torch.ann.quantize import dequantize_rows, quantize_rows
from repro_torch.configs.tsdg_paper import reduced
from repro_torch.core import hotpath as HP
from repro_torch.core.search_large import _large_batch_search as t_large
from repro_torch.core.search_small import _small_batch_search as t_small

# the plain versions are small here: one thread each, so the test
# workers running beside this file keep their cores
torch.set_num_threads(1)

SMALL = dict(k=10, t0=4, hops=4, hop_width=8, n_seeds=8)
LARGE = dict(k=10, ef=16, hops=32, n_seeds=8, m_seg=4, seg=8, mv_seg=4,
             segv=8)
INF = 3.4e38


@pytest.fixture(scope="module")
def world():
    ds = make_clustered(n=1500, d=16, n_queries=300, seed=5)
    cfg_j = dataclasses.replace(j_reduced(), kernel_backend="xla",
                                bridge_hubs=64, quantization="int8")
    ji = JIndex.build(ds.X, cfg_j)
    g = ji.graph
    arrays = dict(zip(("neighbors", "lambdas", "degrees", "hubs"),
                      (np.asarray(a) for a in (g.neighbors, g.lambdas,
                                               g.degrees, g.hubs))))
    quant = (np.asarray(ji.engine.plane.codes),
             np.asarray(ji.engine.plane.scales))
    codes, scales = torch.tensor(quant[0]), torch.tensor(quant[1])
    return dict(ds=ds, ji=ji, jgraph=g, arrays=arrays, quant=quant,
                graph=graph_from_numpy(**arrays, device="cpu"),
                X=torch.from_numpy(ds.X), Q=torch.from_numpy(ds.Q),
                codes=codes, scales=scales)


def _rows(kind):
    rng = np.random.default_rng({"normal": 0, "edge": 1}[kind])
    X = (rng.normal(size=(64, 24))
         * rng.uniform(1e-3, 1e3, size=(64, 1))).astype(np.float32)
    if kind == "edge":
        X[0] = 0.0                                   # zero row: scale 1.0
        X[1] = np.arange(24) - 11.5                  # half-way values
        X[1, 0] = 127.0                              # ... at scale 1.0
        X[2] = -X[1]
        X[3, :] = 1e-30                              # tiny magnitudes
        X[4, 0] = -1e30                              # one huge entry
    return X


@pytest.mark.parametrize("kind", ["normal", "edge"])
def test_quantize_rows_bitwise(kind):
    X = _rows(kind)
    jc, js = (np.asarray(a) for a in j_quantize_rows(jnp.asarray(X)))
    tc, ts = quantize_rows(torch.from_numpy(X))
    assert tc.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tc.numpy(), jc) and np.array_equal(ts.numpy(), js)
    assert (np.abs(tc.numpy().astype(int)) <= 127).all()
    if kind == "edge":
        assert ts[0] == 1.0 and (tc[0] == 0).all()
        assert tc[1, 1:].tolist() == [round(v) for v in X[1, 1:]]  # even
    err = (dequantize_rows(tc, ts) - torch.from_numpy(X)).abs()
    assert (err <= ts[:, None] / 2 * (1 + 1e-6)).all()


def _close(ours, ref, qn, vn):
    """|delta| <= 1e-6 (qn + vn) on finite lanes, INF lanes bit-equal."""
    ours, ref = np.asarray(ours, np.float64), np.asarray(ref, np.float64)
    fin = ref < INF
    assert np.array_equal(fin, ours < INF)
    tol = 1e-6 * (qn + vn)
    assert (np.abs(ours - ref)[fin] <= np.broadcast_to(tol, fin.shape)[fin]) \
        .all()


@functools.partial(jax.jit, static_argnames=("metric",))
def _jnd8(Q, codes, scales, idx, mask, metric):
    return JHP.neighbor_distances(Q, codes, idx, metric=metric, mask=mask,
                                  backend="xla", scales=scales)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_neighbor_distances_and_seed_select_with_scales(world, metric):
    rng = np.random.default_rng(3)
    S, C = 40, 24
    Q = rng.normal(size=(S, 16)).astype(np.float32)
    idx = rng.integers(-3, 1520, size=(S, C)).astype(np.int32)
    mask = rng.random((S, C)) > 0.2
    codes_np, scales_np = world["quant"]
    ref = _jnd8(jnp.asarray(Q), jnp.asarray(codes_np),
                jnp.asarray(scales_np), jnp.asarray(idx), jnp.asarray(mask),
                metric)
    ours = HP.neighbor_distances(torch.from_numpy(Q), world["codes"],
                                 torch.from_numpy(idx),
                                 mask=torch.from_numpy(mask), metric=metric,
                                 scales=world["scales"])
    deq = codes_np.astype(np.float64) * scales_np[:, None]
    vn = (deq ** 2).sum(1)[np.clip(idx, 0, 1499)]
    qn = (Q.astype(np.float64) ** 2).sum(1)[:, None]
    _close(ours.numpy(), ref, qn, vn)
    jd, ji = JHP.seed_select(jnp.asarray(Q), jnp.asarray(codes_np),
                             jnp.asarray(np.clip(idx, 0, 1499)), k=4,
                             metric=metric, backend="xla",
                             scales=jnp.asarray(scales_np))
    td, ti = HP.seed_select(torch.from_numpy(Q), world["codes"],
                            torch.from_numpy(np.clip(idx, 0, 1499)), k=4,
                            metric=metric, scales=world["scales"])
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("quant", [False, True])
def test_scan_distances_matches_reference(world, quant):
    rng = np.random.default_rng(4)
    Q = rng.normal(size=(37, 16)).astype(np.float32)
    Xd = rng.normal(size=(100, 16)).astype(np.float32)
    mask = rng.random(100) > 0.3
    sc = None
    if quant:
        Xd, sc = (np.array(a) for a in j_quantize_rows(jnp.asarray(Xd)))
    ref = JHP.scan_distances(jnp.asarray(Q), jnp.asarray(Xd),
                             mask=jnp.asarray(mask), backend="xla",
                             scales=None if sc is None else jnp.asarray(sc))
    ours = HP.scan_distances(torch.from_numpy(Q), torch.from_numpy(Xd),
                             mask=torch.from_numpy(mask),
                             scales=None if sc is None
                             else torch.from_numpy(sc))
    assert ours.shape == (37, 100) and ours.dtype == torch.float32
    V = Xd.astype(np.float64) * (1.0 if sc is None else sc[:, None])
    _close(ours.numpy(), ref, (Q.astype(np.float64) ** 2).sum(1)[:, None],
           (V ** 2).sum(1)[None, :])


@pytest.mark.parametrize("rerank_mult", [1, 4])
@pytest.mark.parametrize("search,kw,B", [(t_small, SMALL, 40),
                                         (t_large, LARGE, 300)])
def test_searches_with_codes_match_reference(world, search, kw, B,
                                             rerank_mult):
    ds = world["ds"]
    j_search = j_small if search is t_small else j_large
    codes_np, scales_np = world["quant"]
    a, ad = j_search(jnp.asarray(ds.X), world["jgraph"],
                     jnp.asarray(ds.Q[:B]), backend="xla",
                     codes=jnp.asarray(codes_np),
                     scales=jnp.asarray(scales_np), rerank_mult=rerank_mult,
                     **kw)
    b, bd = search(world["X"], world["graph"], world["Q"][:B],
                   codes=world["codes"], scales=world["scales"],
                   rerank_mult=rerank_mult, **kw)
    assert np.array_equal(b.numpy(), np.asarray(a))
    np.testing.assert_allclose(bd.numpy(), np.asarray(ad), rtol=1e-5,
                               atol=1e-4)
    assert abs(recall_at_k(b.numpy(), ds.gt[:B], 10)
               - recall_at_k(np.asarray(a), ds.gt[:B], 10)) <= 0.01


@pytest.mark.parametrize("B", [10, 300])
def test_int8_index_matches_reference(world, B):
    """Through the entry points, on both quantizations of the same codes:
    carried in from the reference (``quant=``) and made by the port."""
    ds = world["ds"]
    cfg_t = dataclasses.replace(reduced(), bridge_hubs=64,
                                quantization="int8")
    carried = Index.from_numpy(ds.X, world["arrays"], cfg_t,
                               quant=world["quant"], device="cpu")
    own = Index.from_numpy(ds.X, world["arrays"], cfg_t, device="cpu")
    assert torch.equal(own.engine.plane.codes, carried.engine.plane.codes)
    assert torch.equal(own.engine.plane.scales, carried.engine.plane.scales)
    a, ad = world["ji"].search(ds.Q[:B])
    for ti in (carried, own):
        b, bd = ti.search(ds.Q[:B])
        assert np.array_equal(a, b)
        np.testing.assert_allclose(bd, ad, rtol=1e-5, atol=1e-4)


def test_quant_carried_from_numpy_round_trip(world):
    """The reference plane's numpy (codes, scales) go straight through
    ``quant=`` onto the port's plane, bit for bit."""
    cfg_t = dataclasses.replace(reduced(), quantization="int8")
    plane = Index.from_numpy(world["ds"].X, world["arrays"], cfg_t,
                             quant=world["quant"], device="cpu").engine.plane
    assert plane.codes.dtype == torch.int8
    assert plane.scales.dtype == torch.float32
    assert np.array_equal(plane.codes.numpy(), world["quant"][0])
    assert np.array_equal(plane.scales.numpy(), world["quant"][1])
    with pytest.raises(ValueError, match="do not match"):
        Index.from_numpy(world["ds"].X, world["arrays"], cfg_t,
                         quant=(world["quant"][0][:5], world["quant"][1]),
                         device="cpu")
