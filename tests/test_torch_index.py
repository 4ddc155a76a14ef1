"""The port's entry points: config parity, ``Index.build(X).search(Q)``
against ``repro.ann.Index``, the engine's bucket ladder and counters, the
device rules, and the package's independence from JAX."""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.ann import Index as JIndex
from repro.configs.base import ANNConfig as JConfig
from repro.configs.tsdg_paper import reduced as j_reduced
from repro.data.synthetic import make_clustered, recall_at_k
from repro_torch.ann import Index, regime_for
from repro_torch.configs.base import ANN_SHAPES, ANNConfig
from repro_torch.configs.tsdg_paper import reduced
from repro_torch.data import synthetic as tsyn

# the plain versions are small here: one thread each, so the test
# workers running beside this file keep their cores
torch.set_num_threads(1)

SRC = os.path.join(os.path.dirname(__file__), "..", "src")


def test_config_fields_and_defaults_match_reference():
    ours = {f.name: f.default for f in dataclasses.fields(ANNConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JConfig)}
    assert ours == ref
    assert dataclasses.asdict(reduced()) == dataclasses.asdict(j_reduced())
    assert ANN_SHAPES["build_1m"].dims == dict(n=1_048_576, d=128, k=32)


@pytest.mark.parametrize("kw", [dict(db_bf16=True)])
def test_later_slice_knobs_raise(kw):
    """The later slices' knobs used to raise; the last of them, db_bf16,
    is accepted now.  As in the reference, only a mesh plane reads it: a
    single-plane index with it answers as one without, bit for bit."""
    cfg = dataclasses.replace(reduced(), bridge_hubs=0, **kw)
    assert cfg.db_bf16
    ds = make_clustered(n=400, d=8, n_queries=8, seed=1)
    ti = Index.build(ds.X, cfg, device="cpu")
    plain = Index(ds.X, reduced(), graph=ti.graph, device="cpu")
    assert ti.X.dtype == torch.float32
    for a, b in zip(ti.search(ds.Q), plain.search(ds.Q)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("kw", [dict(metric="hamming"),
                                dict(kernel_backend="pallas"),
                                dict(kernel_backend="xla"),
                                dict(visited_filter="bloom"),
                                dict(visited_filter="hash",
                                     exact_visited=True)])
def test_config_validation(kw):
    with pytest.raises(ValueError):
        ANNConfig(**kw)


def test_regime_rule_matches_reference():
    from repro.ann.dispatch import regime_for as j_regime_for

    for cfg_t, cfg_j in ((ANNConfig(), JConfig()), (reduced(), j_reduced())):
        for B in (1, 10, 15, 16, 17, 255, 256, 10240):
            assert regime_for(cfg_t, B) == j_regime_for(cfg_j, B)
    assert regime_for(ANNConfig(), 10) == "small"
    assert regime_for(ANNConfig(), 10240) == "large"
    with pytest.raises(ValueError):
        regime_for(ANNConfig(), 0)


@pytest.fixture(scope="module")
def built():
    ds = make_clustered(n=1500, d=32, n_queries=300, seed=7)
    cfg_t = dataclasses.replace(reduced(), bridge_hubs=64)
    cfg_j = dataclasses.replace(j_reduced(), bridge_hubs=64,
                                kernel_backend="xla")
    return dict(ds=ds, t=Index.build(ds.X, cfg_t, device="cpu"),
                j=JIndex.build(ds.X, cfg_j))


@pytest.mark.parametrize("B", [10, 300])
def test_build_and_search_match_reference(built, B):
    ds = built["ds"]
    ti, ji = built["t"], built["j"]
    assert ti.regime(B) == ji.regime(B)
    a, ad = ti.search(ds.Q[:B])
    b, _ = ji.search(ds.Q[:B])
    assert isinstance(a, np.ndarray) and a.shape == (B, 10)
    assert np.isfinite(ad).all()
    ra, rb = recall_at_k(a, ds.gt[:B], 10), recall_at_k(b, ds.gt[:B], 10)
    assert abs(ra - rb) <= 0.01


def test_index_properties_and_stats(built):
    ti = built["t"]
    assert ti.X.shape == (1500, 32) and ti.X.device.type == "cpu"
    assert ti.graph.n == 1500 and ti.graph.hubs is not None
    assert ti.cfg.k_graph == 8 and ti.k == 10 and ti.backend == "torch"
    assert set(ti.build_seconds) == {"knn", "diversify", "bridges"}
    before = ti.stats.snapshot()
    ti.search(built["ds"].Q[:10])          # small, bucket 32
    ti.search(built["ds"].Q[:300])         # large, bucket 512
    s = ti.stats
    assert s.n_queries - before["n_queries"] == 310
    assert s.n_batches - before["n_batches"] == 2
    assert s.small_batches - before["small_batches"] == 1
    assert s.large_batches - before["large_batches"] == 1
    assert s.padded_queries - before["padded_queries"] == 22 + 212
    assert "Index(n=1500" in repr(ti)


def test_engine_buckets_and_validation(built):
    eng = built["t"].engine
    assert [eng.bucket_for(b) for b in (1, 8, 9, 300, 2048, 2049, 5000)] \
        == [8, 8, 32, 512, 2048, 4096, 6144]
    with pytest.raises(ValueError, match="k must be"):
        eng.query(built["ds"].Q[:4], k=0)
    with pytest.raises(ValueError, match="exceeds"):
        eng.query(built["ds"].Q[:300], k=17)
    with pytest.raises(ValueError, match=r"Q must be \[B, 32\]"):
        eng.query(np.zeros((4, 31), np.float32))
    with pytest.raises(ValueError, match="empty"):
        eng.query(np.zeros((0, 32), np.float32))


def test_entry_points_need_a_gpu_unless_cpu_is_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X = np.zeros((64, 8), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Index.build(X, reduced())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Index.from_numpy(X, dict(neighbors=np.zeros((64, 8)),
                                 lambdas=np.zeros((64, 8)),
                                 degrees=np.zeros(64)), reduced())
    with pytest.raises(RuntimeError):
        Index.build(X, reduced(), device="cuda")


def test_from_numpy_round_trip(built):
    g = built["t"].graph
    arrays = {"neighbors": g.neighbors.numpy(), "lambdas": g.lambdas.numpy(),
              "degrees": g.degrees.numpy(), "hubs": g.hubs.numpy()}
    ti = Index.from_numpy(built["ds"].X, arrays,
                          built["t"].cfg, device="cpu")
    assert torch.equal(ti.graph.neighbors, g.neighbors)
    Q = built["ds"].Q[:10]
    assert np.array_equal(ti.search(Q)[0], built["t"].search(Q)[0])
    # a packed graph's perm passes through; X stays in external order
    from repro_torch.ann import layout

    perm = layout.locality_order(arrays["neighbors"], starts=arrays["hubs"])
    _, nb, lam, deg, hubs = layout.apply_layout(
        perm, built["ds"].X, arrays["neighbors"], arrays["lambdas"],
        arrays["degrees"], arrays["hubs"])
    tp = Index.from_numpy(built["ds"].X, dict(
        neighbors=nb, lambdas=lam, degrees=deg, hubs=hubs, perm=perm),
        built["t"].cfg, device="cpu")
    assert np.array_equal(tp.graph.perm.numpy(), perm)
    assert np.array_equal(tp.search(Q)[0], built["t"].search(Q)[0])


def test_data_generators_match_reference():
    from repro.data import synthetic as jsyn

    a = tsyn.make_clustered(n=500, d=8, n_queries=20, seed=2)
    b = jsyn.make_clustered(n=500, d=8, n_queries=20, seed=2)
    assert np.array_equal(a.X, b.X) and np.array_equal(a.Q, b.Q)
    assert np.array_equal(a.gt, b.gt)
    u, v = (m.make_uniform(n=300, d=4, n_queries=9, metric="ip")
            for m in (tsyn, jsyn))
    assert np.array_equal(u.gt, v.gt)
    gt_dev = tsyn.brute_force_gt(a.X, a.Q, 100, "l2", device="cpu",
                                 chunk=7)
    assert (gt_dev == a.gt).mean() >= 0.999
    assert tsyn.recall_at_k(a.gt, b.gt, 10) == 1.0


def test_metrics_match_reference():
    import jax.numpy as jnp

    from repro.core import metrics as JM
    from repro_torch.core import metrics as TM

    rng = np.random.default_rng(0)
    A = rng.normal(size=(6, 8)).astype(np.float32)
    B = rng.normal(size=(9, 8)).astype(np.float32)
    V = rng.normal(size=(6, 5, 8)).astype(np.float32)
    At, Bt, Vt = (torch.from_numpy(x) for x in (A, B, V))
    for m in ("l2", "ip", "cos"):
        np.testing.assert_allclose(TM.pairwise(At, Bt, m).numpy(),
                                   np.asarray(JM.pairwise(A, B, m)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(TM.batched_rowwise(At, Vt, m).numpy(),
                                   np.asarray(JM.batched_rowwise(A, V, m)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(TM.point_pairs(At, At.flip(0), m)
                                   .numpy(),
                                   np.asarray(JM.point_pairs(A, A[::-1], m)),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(TM.preprocess(At, m).numpy(),
                                   np.asarray(JM.preprocess(jnp.asarray(A),
                                                            m)), rtol=1e-6)


def test_package_imports_no_jax_or_reference():
    """Importing every module of the port (and the smoke script) loads no
    ``jax*`` module and nothing of the reference package."""
    code = (
        "import importlib, pkgutil, sys, repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or "
        "m.startswith(('jax.', 'jaxlib', 'repro.')) or m == 'repro')\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith('repro_torch')]))\n")
    root = os.path.abspath(os.path.join(SRC, ".."))
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.abspath(SRC),
                                                       root]))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 20


def test_chip_smoke_refuses_without_a_card(tmp_path):
    """No CUDA device (or no package beside it): non-zero exit, and no
    result line."""
    root = os.path.abspath(os.path.join(SRC, ".."))
    lone = tmp_path / "chip_smoke.py"
    lone.write_bytes(open(os.path.join(root, "chip_smoke.py"), "rb").read())
    for script in (os.path.join(root, "chip_smoke.py"), str(lone)):
        out = subprocess.run([sys.executable, script], capture_output=True,
                             text=True, timeout=120,
                             env=dict(os.environ, CUDA_VISIBLE_DEVICES=""))
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_resolve_device_names_the_current_cuda_device(monkeypatch):
    """"cuda" without an index resolves to the current device's index, so
    tensors placed with "cuda" and with "cuda:0" compare equal."""
    from repro_torch.device import resolve_device

    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert resolve_device("cuda") == torch.device("cuda", 0)
    assert resolve_device(None) == torch.device("cuda", 0)
    assert resolve_device("cuda:1") == torch.device("cuda", 1)
