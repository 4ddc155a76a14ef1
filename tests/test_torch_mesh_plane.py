"""The port's shard grid on the CPU: the mesh plane against the port's own
single plane, the shard-major artifact, compaction on the grid, and the
plane's surface (``core/distributed.py``, ``serve/plane.py``
``MeshPlane``, ``ann/artifact.py``).  ``tests/test_torch_mesh.py`` holds
the same code to the JAX reference.

* a grid with one DB shard equals the single plane bit for bit, the
  reference's acceptance bar (``tests/test_mesh_plane.py``), with M = 2
  and 4 query columns, both visited modes;
* the shard-major round trip of a packed int8 index with a live stream is
  bit for bit; loading without a mesh and onto another shard count warn
  and rebuild; a single artifact loaded onto a mesh reshards;
* ``compact()`` on a grid answers as a fresh build of the effective
  corpus;
* ``db_bf16`` reads the bf16 copy made at install.
"""
import dataclasses
import json

import numpy as np
import pytest
import torch

from repro_torch.ann import Index
from repro_torch.ann.dispatch import calibrate
from repro_torch.configs.base import ANNConfig
from repro_torch.core import distributed as D
from repro_torch.data.synthetic import make_clustered
from repro_torch.serve.engine import ANNEngine
from repro_torch.serve.plane import MeshPlane, get_plane, planes

# the plain versions are small here: one thread each, so the test
# workers running beside this file keep their cores
torch.set_num_threads(1)

KNOBS = dict(k_graph=12, max_degree=16, lambda0=8, bridge_hubs=32,
             bridge_k=8, large_ef=48, large_hops=24,
             serve_buckets=(8, 32, 128))
LAYOUT = ("knn", "diversify", "bridges", "layout")


@pytest.fixture(scope="module")
def cfg():
    return dataclasses.replace(ANNConfig(), **KNOBS)


def _mesh(shape, names=("data", "model")):
    return D.make_mesh(shape, names, device="cpu")


def _bitwise(a, b) -> bool:
    return bool(np.array_equal(a[0], b[0])) and bool(np.array_equal(
        np.asarray(a[1]).view(np.uint32), np.asarray(b[1]).view(np.uint32)))


# ----------------------------------------------------------------------
# the port's own grid
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def data():
    return make_clustered(n=2048, d=16, n_queries=64, n_clusters=24,
                          noise=0.6, seed=0)


@pytest.fixture(scope="module")
def single(data, cfg):
    return Index.build(data.X, cfg, device="cpu")


def _one_shard(single, cfg, shape, names=("data", "model")):
    """A grid with one DB shard over the single index's own graph."""
    g = single.graph
    return Index(None, cfg, plane=MeshPlane(
        None, cfg, _mesh(shape, names),
        parts=(single.X, g.neighbors, g.lambdas, g.degrees, g.hubs)))


@pytest.mark.parametrize("M", [2, 4])
@pytest.mark.parametrize("knobs", [{}, dict(visited_filter="hash")],
                         ids=["none", "hash"])
def test_one_db_shard_mesh_equals_single_plane(data, cfg, single, M, knobs):
    """The reference's acceptance bar: on a (1, M) grid the model axis
    (the t0 split in the small regime, the query split in the large one)
    is bit-invisible — answers equal the single plane's."""
    c = dataclasses.replace(cfg, **knobs)
    one = Index(data.X, c, graph=single.graph, device="cpu")
    mesh_i = _one_shard(single, c, (1, M))
    for B in (5, 64):
        assert mesh_i.regime(B) == one.regime(B)
        assert _bitwise(mesh_i.search(data.Q[:B]), one.search(data.Q[:B]))


@pytest.fixture(scope="module")
def packed_int8(data, cfg):
    """A packed int8 index on a (2, 2) grid with a live stream."""
    c = dataclasses.replace(cfg, quantization="int8", build_pipeline=LAYOUT)
    index = Index.build(data.X, c, mesh=_mesh((2, 2)))
    assert set(index.build_seconds) == {"shard 0", "shard 1"}
    assert "layout" in index.build_seconds["shard 1"]
    rng = np.random.default_rng(7)
    new = index.add(data.X[rng.integers(0, 2048, 40)]
                    + 0.05 * rng.normal(size=(40, 16)).astype(np.float32))
    index.delete(np.arange(0, 2048, 31))
    index.delete(new[::7])
    return index


def test_shard_major_roundtrip_is_bitwise(data, packed_int8, tmp_path):
    packed_int8.save(tmp_path / "ix")
    manifest = json.loads((tmp_path / "ix" / "manifest.json").read_text())
    assert manifest["plane"] == "mesh" and manifest["topology"] == {
        "axes": {"data": 2, "model": 2}, "n_db_shards": 2, "n_q_shards": 2}
    assert [e["file"] for e in manifest["arrays"]] == ["arrays/0.npz",
                                                       "arrays/1.npz"]
    loaded = Index.load(tmp_path / "ix", mesh=_mesh((2, 2)))
    for a, b in zip(loaded.plane._ops, packed_int8.plane._ops):
        assert torch.equal(a, b)
    for B in (5, 64):
        assert _bitwise(loaded.search(data.Q[:B]),
                        packed_int8.search(data.Q[:B]))
    assert loaded.engine.stream.delta.count == 40


@pytest.mark.parametrize("mesh_shape,match", [
    (None, "without mesh="), ((4, 1), "topology mismatch")])
def test_mismatched_load_warns_and_rebuilds(data, packed_int8, tmp_path,
                                            mesh_shape, match):
    """Without a mesh, or onto another shard count, the shards are
    gathered (rows back in external order) and rebuilt; the saved
    stream's external ids stay valid, so deleted ids never answer."""
    packed_int8.save(tmp_path / "ix")
    mesh = None if mesh_shape is None else _mesh(mesh_shape)
    with pytest.warns(UserWarning, match=match):
        loaded = Index.load(tmp_path / "ix", device="cpu", mesh=mesh)
    assert loaded.plane.name == ("single" if mesh is None else "mesh")
    assert np.array_equal(loaded.engine.stream.base_alive,
                          packed_int8.engine.stream.base_alive)
    ids, _ = loaded.search(data.Q)
    dead = np.flatnonzero(~packed_int8.engine.stream.base_alive)
    assert not np.isin(ids, dead).any()
    assert (ids >= 0).all()


def test_single_artifact_onto_mesh_reshards(data, cfg, single, tmp_path):
    single.save(tmp_path / "sx")
    with pytest.warns(UserWarning, match="resharding"):
        loaded = Index.load(tmp_path / "sx", mesh=_mesh((2, 1)))
    fresh = Index.build(data.X, cfg, mesh=_mesh((2, 1)))
    assert loaded.plane.name == "mesh"
    assert _bitwise(loaded.search(data.Q), fresh.search(data.Q))


def test_mesh_compaction_equals_a_fresh_build(data, cfg):
    """compact() on a mesh rebuilds the shards over the effective corpus:
    the new generation answers as a fresh mesh build over it, and a
    corpus that does not split over the shards is refused."""
    mesh = _mesh((2, 2))
    index = Index.build(data.X, cfg, mesh=mesh)
    new = index.add(data.X[:6] + 0.01)
    index.delete(np.arange(0, 12, 2))
    id_map = index.compact()
    X_eff = np.concatenate([np.delete(data.X, np.arange(0, 12, 2), axis=0),
                            data.X[:6] + 0.01])
    assert id_map[new[0]] == 2042 and id_map[0] == -1
    fresh = Index.build(X_eff, cfg, mesh=mesh)
    for B in (5, 64):
        assert _bitwise(index.search(data.Q[:B]), fresh.search(data.Q[:B]))
    index.add(data.X[:1])
    with pytest.raises(ValueError, match="not divisible over 2 DB shards"):
        index.compact()


# ----------------------------------------------------------------------
# the plane's surface
# ----------------------------------------------------------------------

def test_plane_registry_and_pod():
    assert {"single", "mesh"} <= set(planes())
    assert get_plane("mesh") is not None
    # the pod registers itself when first asked for
    pod = get_plane("pod")
    assert pod is not None and "pod" in planes()
    with pytest.raises(KeyError, match="unknown execution plane"):
        get_plane("hexapod")


def test_mesh_plane_surface(data, cfg, single):
    """The grid's axes, the plane's topology and fingerprint, the engine's
    buckets rounded to the query shards, calibration's probes too."""
    with pytest.raises(ValueError, match="no DB axis"):
        MeshPlane(data.X, cfg, _mesh((2,), ("model",)))
    with pytest.raises(ValueError, match="differ in length"):
        D.make_mesh((2, 2), ("data",), device="cpu")
    mesh = _mesh((2, 1, 3), ("pod", "data", "model"))
    assert D.db_axes(mesh) == ("pod", "data")
    assert (D.n_db_shards(mesh), D.n_query_shards(mesh)) == (2, 3)
    c = dataclasses.replace(cfg, serve_buckets=(8, 32), large_hops=8,
                            small_hops=3)
    index = _one_shard(single, c, (1, 1, 3), ("pod", "data", "model"))
    eng, plane = index.engine, index.plane
    assert plane.batch_multiple() == 3
    assert plane.topology() == {"axes": {"pod": 1, "data": 1, "model": 3},
                                "n_db_shards": 1, "n_q_shards": 3}
    assert plane.fingerprint()["mesh_axes"] == plane.topology()["axes"]
    assert eng.bucket_for(8) == 9 and eng.bucket_for(9) == 33
    for B in (3, 33, 3, 33):
        ids, _ = eng.query(data.Q[:B])
        assert ids.shape == (B, 10)
    assert eng.stats.compiles == 2 and eng.stats.bucket_hits == 2
    cal = calibrate(plane, c, k=10, probe_batches=(4, 16), repeats=1)
    assert [B for B, _ in cal.probes["large"]] == [6, 18]
    with pytest.raises(ValueError, match="device="):
        ANNEngine(None, c, plane=plane, device="meta")


def test_db_bf16_reads_a_bf16_copy(data, cfg, single):
    """db_bf16 on a mesh: the searches read the bf16 copy made at
    install (X stays fp32), and answer as the reference's cast does; the
    single plane ignores the knob."""
    c = dataclasses.replace(cfg, db_bf16=True)
    plane = _one_shard(single, c, (1, 2)).plane
    assert plane.X.dtype == torch.float32
    Xb = plane.operands()[0]
    assert Xb.dtype == torch.bfloat16
    assert torch.equal(Xb, plane.X.to(torch.bfloat16))
    Q = torch.from_numpy(data.Q[:64])
    fn = D.make_search_fn(plane.mesh, c, kind="large")
    cast = fn(plane.X, *plane.operands()[1:], Q)  # the cast inside
    assert all(torch.equal(a, b) for a, b in zip(plane.search("large", Q,
                                                              10), cast))
    one = Index(data.X, c, graph=single.graph, device="cpu")
    assert _bitwise(one.search(data.Q[:5]), single.search(data.Q[:5]))
