"""The versioned index artifact in the port (``repro_torch.ann.artifact``,
``Index.save`` / ``Index.load``), on the CPU, against the JAX reference.

One graph is built by the port and handed to the reference, which saves
(``aot=False``) a packed int8 index with a live stream:

* the port loads it (format v5): its answers meet the search parity
  contract against the reference's own load of the same artifact (ids
  equal on >= 98% of entries, recall@10 within 0.01), and the stream's
  count and next id carry over;
* the reference's v4, v3, v2 and v1 forms (an unpacked artifact with its
  manifest doctored as the reference's own tests do) load, and answer bit
  for bit as the port's index over the same graph and mutations;
* a port save -> port load round trip answers bit for bit;
* the reference's ``Index.load`` reads a port-saved artifact;
* a bad magic, an unknown version and a flipped payload byte raise
  ``ArtifactError``, a shard-major payload's too; a sound shard-major
  manifest without ``mesh=`` loads, with a warning, as a rebuilt single
  index.
"""
import dataclasses
import hashlib
import json
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ann import Index as JIndex
from repro.ann import layout as JL
from repro.configs.tsdg_paper import reduced as j_reduced
from repro.core.diversify import PackedGraph as JGraph
from repro.data.synthetic import make_clustered, recall_at_k
from repro_torch.ann import Index
from repro_torch.ann.artifact import FORMAT_VERSION, ArtifactError
from repro_torch.configs.tsdg_paper import reduced

# the plain versions are small here: one thread, so the test workers
# running beside this file keep their cores
torch.set_num_threads(1)

N = 1200
PACKED_PIPE = ("knn", "diversify", "bridges", "layout")


def _mutate(index, ds):
    """The same adds and deletes on either package's index: 40 adds, 30
    base rows and 5 added rows deleted."""
    new = index.add(ds.Q[-40:] + np.float32(0.01))
    index.delete(np.arange(0, 300, 10))
    index.delete(np.asarray(new[:5]))
    return np.asarray(new)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    ds = make_clustered(n=N, d=16, n_queries=200, seed=5)
    cfg_t = dataclasses.replace(reduced(), bridge_hubs=64,
                                quantization="int8")
    g = Index.build(ds.X, cfg_t, device="cpu").graph
    arrays = [t.numpy() for t in (g.neighbors, g.lambdas, g.degrees, g.hubs)]
    perm = JL.locality_order(arrays[0], starts=arrays[3])
    _, *packed = JL.apply_layout(perm, ds.X, *arrays)
    cfg_j = dataclasses.replace(j_reduced(), bridge_hubs=64,
                                quantization="int8", kernel_backend="xla")
    root = tmp_path_factory.mktemp("artifacts")
    # the reference's packed int8 index with a live stream (format v5)
    jp = JIndex(ds.X, dataclasses.replace(cfg_j, build_pipeline=PACKED_PIPE),
                graph=JGraph(*(jnp.asarray(a) for a in packed),
                             perm=jnp.asarray(perm)))
    new = _mutate(jp, ds)
    jp.save(root / "v5", aot=False)
    # the same graph unpacked, the same mutations: the v4-v1 forms' source
    ju = JIndex(ds.X, cfg_j, graph=JGraph(*(jnp.asarray(a) for a in arrays)))
    _mutate(ju, ds)
    ju.save(root / "unpacked", aot=False)
    return dict(ds=ds, root=root, cfg_t=cfg_t, arrays=arrays, perm=perm,
                new=new, count=jp.engine.stream.delta.count)


def _load(path):
    with pytest.warns(UserWarning, match="loaded as 'auto'"):
        return Index.load(path, device="cpu")


def _bitwise(a, b):
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1].tobytes() == b[1].tobytes()


def _compare(a_ids, b_ids, gt):
    assert a_ids.shape == b_ids.shape
    assert (a_ids == b_ids).mean() >= 0.98
    assert abs(recall_at_k(a_ids, gt, 10) - recall_at_k(b_ids, gt, 10)) \
        <= 0.01


def _doctor(src, dst, version, *, drop_codes=False):
    """Copy ``src`` and rewrite it into the reference's format
    ``version`` (the fields and payloads that format lacks removed)."""
    shutil.copytree(src, dst)
    mpath = dst / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest["format_version"] = version
    for key in ("layout", "visited_filter"):       # pre-v5 fingerprint
        manifest["fingerprint"].pop(key)
    if drop_codes:                                  # pre-v4: no codes
        with np.load(dst / "arrays.npz") as arrs:
            v3 = {k: arrs[k] for k in arrs.files
                  if k not in ("codes", "scales")}
        np.savez(dst / "arrays.npz", **v3)
        manifest["arrays"]["sha256"] = hashlib.sha256(
            (dst / "arrays.npz").read_bytes()).hexdigest()
        manifest["fingerprint"].pop("quantization")
    if version <= 2:                                # pre-streaming
        manifest.pop("generation")
        manifest.pop("streaming", None)
        (dst / "streaming.npz").unlink()
    if version == 1:                                # pre-plane
        manifest.pop("plane")
    mpath.write_text(json.dumps(manifest))
    return dst


def test_port_loads_reference_v5(world):
    ds, path = world["ds"], world["root"] / "v5"
    assert json.loads((path / "manifest.json").read_text())[
        "format_version"] == FORMAT_VERSION
    ti = _load(path)
    assert ti.cfg.kernel_backend == "auto"
    assert ti.cfg.build_pipeline == PACKED_PIPE
    np.testing.assert_array_equal(ti.graph.perm.numpy(), world["perm"])
    np.testing.assert_array_equal(ti.X.numpy(), ds.X[world["perm"]])
    stream = ti.engine.stream
    assert stream.delta.count == world["count"] == 40
    assert stream.n_active() == N - 30 + 35
    ji = JIndex.load(path)
    for B in (10, 200):
        assert ti.regime(B) == ji.regime(B)
        a, _ = ji.search(ds.Q[:B])
        b, _ = ti.search(ds.Q[:B])
        _compare(np.asarray(a), b, ds.gt[:B])
        assert not np.isin(b, np.arange(0, 300, 10)).any()
        assert not np.isin(b, world["new"][:5]).any()
    assert ti.add(ds.Q[:1]).tolist() == [N + 40]


@pytest.mark.parametrize("version", [4, 3, 2, 1])
def test_port_loads_reference_older_forms(world, tmp_path, version):
    ds = world["ds"]
    path = _doctor(world["root"] / "unpacked", tmp_path / f"v{version}",
                   version, drop_codes=version <= 3)
    ti = _load(path)
    assert ti.graph.perm is None and ti.generation == 0
    want = Index.from_numpy(ds.X, dict(zip(
        ("neighbors", "lambdas", "degrees", "hubs"), world["arrays"])),
        world["cfg_t"], device="cpu")
    if version >= 3:
        _mutate(want, ds)
        assert ti.engine.stream.delta.count == 40
    else:
        assert ti.engine.stream is None
    for B in (10, 200):
        _bitwise(ti.search(ds.Q[:B]), want.search(ds.Q[:B]))


def test_port_round_trip_is_bitwise(world, tmp_path):
    ds = world["ds"]
    ti = _load(world["root"] / "v5")
    ti.engine.stats.generation = 3
    path = ti.save(tmp_path / "port", extra_ks=(5,))
    manifest = json.loads((path / "manifest.json").read_text())
    assert manifest["aot"] == [] and manifest["plane"] == "single"
    assert manifest["config"]["kernel_backend"] == "auto"
    assert manifest["fingerprint"]["layout"] is True
    with np.load(path / "arrays.npz") as arrs:
        assert {"X", "codes", "scales", "perm"} <= set(arrs.files)
    back = Index.load(path, device="cpu")
    assert back.generation == 3 and back.cfg == ti.cfg
    assert torch.equal(back.plane.codes, ti.plane.codes)
    assert back.engine.stream.delta.count == 40
    for B in (10, 200):
        _bitwise(back.search(ds.Q[:B]), ti.search(ds.Q[:B]))
    with pytest.raises(ValueError, match="exceeds"):
        ti.save(tmp_path / "bad", extra_ks=(17,))


def test_reference_loads_port_artifact(world, tmp_path):
    ds = world["ds"]
    ti = _load(world["root"] / "v5")
    ti.delete([N + 39])
    ti.save(tmp_path / "port")
    ji = JIndex.load(tmp_path / "port")
    assert ji.cfg.kernel_backend == "auto"
    np.testing.assert_array_equal(np.asarray(ji.graph.perm), world["perm"])
    assert ji.engine.stream.delta.count == 40
    a, _ = ji.search(ds.Q[:10])
    b, _ = ti.search(ds.Q[:10])
    _compare(np.asarray(a), b, ds.gt[:10])


def _rewrite(path, **fields):
    mpath = path / "manifest.json"
    manifest = json.loads(mpath.read_text())
    manifest.update(fields)
    mpath.write_text(json.dumps(manifest))


def test_bad_artifacts_are_refused(world, tmp_path):
    src = world["root"] / "v5"
    with pytest.raises(ArtifactError, match="missing manifest.json"):
        Index.load(tmp_path, device="cpu")
    bad = shutil.copytree(src, tmp_path / "magic")
    _rewrite(bad, magic="not-an-index")
    with pytest.raises(ArtifactError, match="not a repro-ann-index"):
        Index.load(bad, device="cpu")
    bad = shutil.copytree(src, tmp_path / "version")
    _rewrite(bad, format_version=FORMAT_VERSION + 1)
    with pytest.raises(ArtifactError, match="unsupported index artifact"):
        Index.load(bad, device="cpu")
    bad = shutil.copytree(src, tmp_path / "flipped")
    raw = bytearray((bad / "arrays.npz").read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (bad / "arrays.npz").write_bytes(bytes(raw))
    with pytest.raises(ArtifactError, match="checksum mismatch"):
        _load(bad)
    # shard-major: one shard, the same payload, under its own checksum
    mesh = shutil.copytree(src, tmp_path / "mesh")
    entry = json.loads((mesh / "manifest.json").read_text())["arrays"]
    _rewrite(mesh, plane="mesh", topology={"n_db_shards": 1},
             arrays=[entry])
    with pytest.warns(UserWarning, match="without mesh="):
        loaded = Index.load(mesh, device="cpu")
    assert loaded.plane.name == "single" and loaded.graph.perm is not None
    bad = shutil.copytree(mesh, tmp_path / "mesh_flipped")
    raw = bytearray((bad / "arrays.npz").read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    (bad / "arrays.npz").write_bytes(bytes(raw))
    with pytest.raises(ArtifactError, match="checksum mismatch"):
        Index.load(bad, device="cpu")
