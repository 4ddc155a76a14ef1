"""The port's sharded index against the JAX reference, on the CPU:
``core/distributed.py`` (the grid, the sharded build, the 2-D search,
``merge_shard_results``), the mesh plane and the shard-major artifact.

The reference runs once, in a subprocess with four emulated devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``: the device count
is fixed when JAX starts), on ``jax.make_mesh((2, 2), ('data',
'model'))``.  It calls ``D.make_build_fn`` / ``D.make_search_fn``
directly, as ``tests/test_distributed.py`` does, never through its engine,
and writes the built arrays, its answers and a shard-major artifact.  Its
XLA compiles run at the lowest optimisation level: six search compiles
and a build are most of this file's time.  Data and config are
``tests/test_mesh_plane.py``'s (n = 2,048, d = 16).

* the port's ``make_build_fn`` on the same rows: hubs equal, the graph
  agreeing as the single-device build does (``tests/test_torch_build.py``);
* the port's ``make_search_fn`` on the reference's own arrays, both
  regimes: fp32 with a stream (tombstones and a delta), int8 with the hash
  visited filter and a stream, and ``db_bf16`` on the packed layout — ids
  exactly, distances within 1e-6 * (qn + vn);
* ``merge_shard_results`` exactly, the empty case too;
* the bf16 database's plain distances against the reference's XLA path;
* the reference's shard-major artifact loads.

The port's own grid (one DB shard against the single plane, the round
trip, compaction, the plane's surface) is ``tests/test_torch_mesh_plane.py``.
"""
import dataclasses
import os
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

from repro_torch.ann import Index
from repro_torch.configs.base import ANNConfig
from repro_torch.core import distributed as D
from repro_torch.kernels import l2dist

# the plain versions are small here: one thread each, so the test
# workers running beside this file keep their cores
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
KNOBS = dict(k_graph=12, max_degree=16, lambda0=8, bridge_hubs=32,
             bridge_k=8, large_ef=48, large_hops=24,
             serve_buckets=(8, 32, 128))
LAYOUT = ("knn", "diversify", "bridges", "layout")
CASES = {"stream": {},
         "int8_hash_stream": dict(quantization="int8",
                                  visited_filter="hash"),
         "bf16_layout": dict(db_bf16=True, build_pipeline=LAYOUT)}
INF = np.float32(3.4e38)

# the reference: argv = (npz out, artifact dir)
REFERENCE = r"""
import dataclasses, sys
import numpy as np, jax, jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.ann import Index, layout as L
from repro.ann.quantize import quantize_rows
from repro.configs import get_arch
from repro.core import distributed as D
from repro.data.synthetic import make_clustered
from repro.serve.plane import MeshPlane
out_path, art_path = sys.argv[1], sys.argv[2]
mesh = jax.make_mesh((2, 2), ("data", "model"))
ds = make_clustered(n=2048, d=16, n_queries=64, n_clusters=24, noise=0.6,
                    seed=0)
base = dataclasses.replace(
    get_arch("tsdg-paper"), k_graph=12, max_degree=16, lambda0=8,
    bridge_hubs=32, bridge_k=8, large_ef=48, large_hops=24,
    serve_buckets=(8, 32, 128), kernel_backend="xla")
sh = lambda *s: NamedSharding(mesh, P(*s))
row2, row1, rep2, rep1 = sh("data", None), sh("data"), sh(None, None), sh(None)
put = jax.device_put
X = put(jnp.asarray(ds.X), row2)
built = D.make_build_fn(mesh, base)(X)
nb, lam, deg, hubs = (np.asarray(a) for a in built)
out = dict(X=ds.X, Q=ds.Q, gt=ds.gt, neighbors=nb, lambdas=lam, degrees=deg,
           hubs=hubs)
# per-shard layout, as MeshPlane._host_layout packs it
n_local, nh = 1024, hubs.shape[0] // 2
lay = [[] for _ in range(6)]
for i in range(2):
    r = slice(i * n_local, (i + 1) * n_local)
    h = hubs[i * nh:(i + 1) * nh]
    perm = L.locality_order(nb[r], starts=h)
    for acc, a in zip(lay, L.apply_layout(perm, ds.X[r], nb[r], lam[r],
                                          deg[r], hubs=h) + (perm,)):
        acc.append(a)
lay = [np.concatenate(a) for a in lay]
for name, a in zip(("X", "neighbors", "lambdas", "degrees", "hubs", "perm"),
                   lay):
    out["layout_" + name] = a
codes, scales = (np.asarray(a) for a in quantize_rows(jnp.asarray(ds.X)))
out["codes"], out["scales"] = codes, scales
# a stream: base tombstones and a delta of 40 adds (every 7th deleted)
rng = np.random.default_rng(5)
cap, count = 64, 40
alive = np.ones(2048, bool); alive[::31] = False
dX = np.zeros((cap, 16), np.float32)
dX[:count] = ds.X[rng.integers(0, 2048, count)] \
    + 0.05 * rng.normal(size=(count, 16)).astype(np.float32)
dX[1:7] = ds.Q[:6] + 0.001  # live slots near the first queries
dal = np.zeros(cap, bool); dal[:count] = True; dal[:count:7] = False
dcodes, dscales = (np.asarray(a) for a in quantize_rows(jnp.asarray(dX)))
out.update(alive=alive, delta_X=dX, delta_alive=dal, delta_count=count)

def ops_for(case):
    if "layout" in case:
        o = [put(lay[0], row2), put(lay[1], row2), put(lay[2], row2),
             put(lay[3], row1), put(lay[4], row1)]
    else:
        o = [X, put(nb, row2), put(lam, row2), put(deg, row1),
             put(hubs, row1)]
    if "int8" in case:
        o += [put(codes, row2), put(scales, row1)]
    if "layout" in case:
        o += [put(lay[5], row1)]
    if "stream" in case:
        o += [put(alive, row1), put(dX, rep2), put(dal, rep1)]
        if "int8" in case:
            o += [put(dcodes, rep2), put(dscales, rep1)]
    return o

LAYOUT = ("knn", "diversify", "bridges", "layout")
CASES = {"stream": {},
         "int8_hash_stream": dict(quantization="int8", visited_filter="hash"),
         "bf16_layout": dict(db_bf16=True, build_pipeline=LAYOUT)}
for case, knobs in CASES.items():
    cfg = dataclasses.replace(base, **knobs)
    ops = ops_for(case)
    for kind, B in (("small", 5), ("large", 64)):
        fn = D.make_search_fn(mesh, cfg, kind=kind, k=10,
                              stream="stream" in case)
        Q = put(jnp.asarray(ds.Q[:B]), rep2 if kind == "small"
                else sh("model", None))
        ids, dist = fn(*ops, Q)
        out[f"{case}_{kind}_ids"] = np.asarray(ids)
        out[f"{case}_{kind}_dists"] = np.asarray(dist)
# the bf16 database's distances through the reference's XLA path
from repro.core import hotpath as HP
Xb = jnp.asarray(ds.X).astype(jnp.bfloat16)
bidx = rng.integers(-2, 2060, size=(64, 32)).astype(np.int32)
bmask = rng.random((64, 32)) > 0.2
out["bf16_idx"], out["bf16_mask"] = bidx, bmask
out["bf16_dists"] = np.asarray(HP.neighbor_distances(
    jnp.asarray(ds.Q), Xb, jnp.asarray(bidx), metric="l2",
    mask=jnp.asarray(bmask), backend="xla"))
# merge_shard_results, with and without survivors
res = [(out["stream_large_ids"][:, :5] % 1024, out["stream_large_dists"][:, :5]),
       (out["stream_large_ids"][:, 5:] % 1024, out["stream_large_dists"][:, 5:])]
gi, gd = D.merge_shard_results(res, [0, 1024], [1024, 1024], k=7)
out["msr_ids"], out["msr_dists"] = gi, gd
gi, gd = D.merge_shard_results([], [], [], k=7, batch=3)
out["msr_empty_ids"], out["msr_empty_dists"] = gi, gd
# the shard-major artifact: the packed int8 index with a live stream
cfg_a = dataclasses.replace(base, quantization="int8", build_pipeline=LAYOUT)
plane = MeshPlane(None, cfg_a, mesh, parts=tuple(ops_for("layout")))
idx = Index(None, cfg_a, k=10, plane=plane)
new = idx.add(dX[:count])
idx.delete(np.arange(0, 2048, 31)); idx.delete(new[::7])
idx.save(art_path, aot=False)
np.savez(out_path, **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("reference_mesh")
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=SRC,
               XLA_FLAGS="--xla_force_host_platform_device_count=4 "
               "--xla_backend_optimization_level=0 "
               "--xla_llvm_disable_expensive_passes=true")
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(d / "ref.npz"),
                        str(d / "artifact")], env=env, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stdout + "\n" + r.stderr
    with np.load(d / "ref.npz") as z:
        out = {name: z[name] for name in z.files}
    out["artifact"] = d / "artifact"
    return out


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(ANNConfig(), **KNOBS)


def _mesh(shape, names=("data", "model")):
    return D.make_mesh(shape, names, device="cpu")


def _bitwise(a, b) -> bool:
    return bool(np.array_equal(a[0], b[0])) and bool(np.array_equal(
        np.asarray(a[1]).view(np.uint32), np.asarray(b[1]).view(np.uint32)))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _operands(ref, case):
    """The reference's operand tuple of ``case``, as tensors."""
    p = "layout_" if "layout" in case else ""
    ops = [ref[p + n] for n in ("X", "neighbors", "lambdas", "degrees",
                                "hubs")]
    if "int8" in case:
        ops += [ref["codes"], ref["scales"]]
    if "layout" in case:
        ops.append(ref["layout_perm"])
    if "stream" in case:
        ops += [ref["alive"], ref["delta_X"], ref["delta_alive"]]
        if "int8" in case:
            from repro_torch.ann.quantize import quantize_rows
            ops += [a.numpy() for a in quantize_rows(_t(ref["delta_X"]))]
    return [_t(a) for a in ops]


def _norm_tol(ref, Q, ids):
    """1e-6 * (qn + vn) for each answered (query, id): the delta rows
    follow the base rows."""
    rows = np.concatenate([ref["X"], ref["delta_X"]]).astype(np.float64)
    vn = (rows ** 2).sum(1)[np.clip(ids, 0, rows.shape[0] - 1)]
    return 1e-6 * ((Q.astype(np.float64) ** 2).sum(1)[:, None] + vn)


# ----------------------------------------------------------------------
# against the reference
# ----------------------------------------------------------------------

def test_build_fn_matches_reference(ref, cfg):
    """Each shard's sub-index from the port's make_build_fn against the
    reference's: the hub draws exactly, the graph as the single-device
    build agrees (tests/test_torch_build.py), and each shard equal to the
    port's own build_graph on its slice."""
    from repro_torch.ann.pipeline import build_graph

    timings = []
    nb, lam, deg, hubs = D.make_build_fn(_mesh((2, 2)), cfg)(
        ref["X"], timings=timings)
    assert len(timings) == 2 and set(timings[0]) == {"knn", "diversify",
                                                     "bridges"}
    assert np.array_equal(hubs.numpy(), ref["hubs"])
    assert (nb.numpy() == ref["neighbors"]).mean() >= 0.99
    assert (lam.numpy() == ref["lambdas"]).mean() >= 0.99
    assert (deg.numpy() == ref["degrees"]).mean() >= 0.99
    g = build_graph(ref["X"][1024:], cfg, device="cpu")
    assert torch.equal(nb[1024:], g.neighbors)
    assert torch.equal(hubs[32:], g.hubs)


@pytest.mark.parametrize("kind", ["small", "large"])
@pytest.mark.parametrize("case", list(CASES))
def test_search_fn_matches_reference(ref, cfg, case, kind):
    """The port's make_search_fn on the reference's arrays, on a (2, 2)
    grid: ids exactly, distances within 1e-6 * (qn + vn)."""
    c = dataclasses.replace(cfg, **CASES[case])
    B = 5 if kind == "small" else 64
    fn = D.make_search_fn(_mesh((2, 2)), c, kind=kind, k=10,
                          stream="stream" in case)
    ids, dists = fn(*_operands(ref, case), _t(ref["Q"][:B]))
    want_i, want_d = ref[f"{case}_{kind}_ids"], ref[f"{case}_{kind}_dists"]
    np.testing.assert_array_equal(ids.numpy(), want_i)
    ok = want_i >= 0
    err = np.abs(dists.numpy().astype(np.float64) - want_d)
    assert (err[ok] <= _norm_tol(ref, ref["Q"][:B], want_i)[ok]).all()
    assert (dists.numpy()[~ok] == INF).all()
    if "stream" in case:  # tombstones never answer; the delta does
        dead = np.flatnonzero(~ref["alive"])
        assert not np.isin(want_i, dead).any()
        assert (want_i >= 2048).any()


def test_merge_shard_results_matches_reference(ref):
    ids, dists = ref["stream_large_ids"], ref["stream_large_dists"]
    res = [(ids[:, :5] % 1024, dists[:, :5]), (ids[:, 5:] % 1024,
                                              dists[:, 5:])]
    gi, gd = D.merge_shard_results(res, [0, 1024], [1024, 1024], k=7)
    np.testing.assert_array_equal(gi, ref["msr_ids"])
    np.testing.assert_array_equal(gd.view(np.uint32),
                                  ref["msr_dists"].view(np.uint32))
    gi, gd = D.merge_shard_results([], [], [], k=7, batch=3)
    np.testing.assert_array_equal(gi, ref["msr_empty_ids"])
    np.testing.assert_array_equal(gd, ref["msr_empty_dists"])
    with pytest.raises(ValueError, match="batch="):
        D.merge_shard_results([], [], [], k=7)


def test_bf16_plain_path_matches_reference(ref):
    """The bf16 database's plain distances (gathered rows upcast) against
    the reference's hotpath.neighbor_distances(backend="xla") on a bf16
    X."""
    X = _t(ref["X"]).to(torch.bfloat16)
    Q, idx = _t(ref["Q"]), _t(ref["bf16_idx"])
    out = l2dist.gather_distances(Q[:, None], X, idx, _t(ref["bf16_mask"]))
    assert torch.equal(out[:, 0], l2dist.gather_distances_plain(
        Q[:, None], X.float(), idx, _t(ref["bf16_mask"]))[:, 0])
    want = ref["bf16_dists"]
    Xb = X.float().double().numpy()
    vn = (Xb ** 2).sum(1)[np.clip(ref["bf16_idx"], 0, 2047)]
    tol = 1e-6 * ((ref["Q"].astype(np.float64) ** 2).sum(1)[:, None] + vn)
    got = out[:, 0].numpy()
    assert np.array_equal(got == INF, want == INF)
    assert (np.abs(got.astype(np.float64) - want) <= tol).all()


def test_reference_mesh_artifact_loads(ref):
    """The reference's shard-major artifact (packed int8 on a (2, 2) mesh,
    a live stream) loads in the port onto a (2, 2) grid: the saved
    sub-indexes re-bound as they are, the stream restored, and its
    searches those of the port's make_search_fn on the same arrays."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the reference's kernel_backend
        index = Index.load(ref["artifact"], mesh=_mesh((2, 2)))
    plane = index.plane
    assert plane.name == "mesh" and plane.quantized
    for name, got in (("X", plane.X), ("neighbors", plane.graph.neighbors),
                      ("hubs", plane.graph.hubs),
                      ("perm", plane.graph.perm)):
        assert np.array_equal(got.numpy(), ref["layout_" + name]), name
    assert np.array_equal(plane.codes.numpy(),
                          ref["codes"][_packed_rows(ref)])
    st = index.engine.stream
    assert st.n_base == 2048 and st.delta.count == 40
    assert np.array_equal(st.base_alive, ref["alive"])
    for B in (5, 64):
        kind = index.regime(B)
        Q = _t(ref["Q"][:B])
        Qp = torch.cat([Q, Q[-1:].expand(index.engine.bucket_for(B) - B,
                                         -1)])
        want = D.make_search_fn(_mesh((2, 2)), index.cfg, kind=kind,
                                stream=True)(*plane.operands(),
                                             *plane.stream, Qp)
        got = index.search(ref["Q"][:B])
        assert _bitwise(got, tuple(t[:B].numpy() for t in want))


def _packed_rows(ref):
    """Row i of the packed corpus is external row offset + perm[i]."""
    perm = ref["layout_perm"].astype(np.int64)
    return (np.arange(2048) // 1024) * 1024 + perm
