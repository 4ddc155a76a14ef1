"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the reference
package, so it runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: distances within 1e-5 * (qn + vn) (the kernel sums in another
order than cuBLAS), merges and the visited filter exactly.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import kernels as K
from repro_torch.ann import Index
from repro_torch.configs.tsdg_paper import reduced
from repro_torch.core import hotpath as HP
from repro_torch.data.synthetic import make_clustered, recall_at_k
from repro_torch.kernels import l2dist, topk, visited

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.from_numpy(np.array(a)).to(dev) for a in arrays]


@pytest.mark.parametrize("S,Kq,C,d", [(64, 1, 32, 128), (33, 3, 20, 9),
                                      (16, 1, 288, 128)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gather_distances_matches_plain(dev, rng, S, Kq, C, d, metric):
    N = 5000
    X, Q, idx, mask = _on(
        dev, rng.normal(size=(N, d)).astype(np.float32),
        rng.normal(size=(S, Kq, d)).astype(np.float32),
        rng.integers(-2, N + 20, size=(S, C)).astype(np.int32),
        rng.random((S, C)) > 0.3)
    n0 = l2dist.gather_distances.launches
    out = l2dist.gather_distances(Q, X, idx, mask, metric=metric)
    ref = l2dist.gather_distances_plain(Q, X, idx, mask, metric=metric)
    torch.cuda.synchronize()
    assert l2dist.gather_distances.launches == n0 + 1
    norms = (Q.double() ** 2).sum(2)[:, :, None] \
        + (X.double() ** 2).sum(1)[idx.long().clamp(0, N - 1)][:, None, :]
    assert ((out.double() - ref.double()).abs() <= 1e-5 * norms).all()
    assert torch.equal(out == 3.4e38, ref == 3.4e38)


@pytest.mark.parametrize("K_,d", [(32, 128), (64, 128), (64, 960)])
def test_gather_distances_self_query_matches_plain(dev, rng, K_, d):
    """The diversify tiles, GIST's d = 960 included (d looped in chunks)."""
    N = 3000
    X, idx, mask = _on(dev, rng.normal(size=(N, d)).astype(np.float32),
                       rng.integers(0, N + 5, size=(40, K_)).astype(np.int32),
                       rng.random((40, K_)) > 0.2)
    out = l2dist.gather_distances(None, X, idx, mask, self_q=True)
    ref = l2dist.gather_distances_plain(None, X, idx, mask, self_q=True)
    vn = (X.double() ** 2).sum(1)[idx.long().clamp(0, N - 1)]
    tol = 1e-5 * (vn[:, :, None] + vn[:, None, :])
    assert ((out.double() - ref.double()).abs() <= tol).all()


@pytest.mark.parametrize("R,W,keep", [(50, 32, 32), (50, 320, 32),
                                      (7, 2048, 10), (9, 5, 3)])
def test_rank_merge_matches_plain(dev, rng, R, W, keep):
    d = (rng.integers(0, 6, size=(R, W)) * 0.5).astype(np.float32)
    d[rng.random((R, W)) < 0.1] = -0.0
    d, ids, mask = _on(dev, d, rng.integers(0, 99, size=(R, W))
                       .astype(np.int32), rng.random((R, W)) > 0.2)
    od, oi = topk.rank_merge(d, ids, mask, keep=keep)
    rd, ri = topk.rank_merge_plain(d, ids, mask, keep=keep)
    assert torch.equal(oi, ri) and bool((od == rd).all())


def test_visited_filter_matches_plain(dev, rng):
    t = HP.visited_table(64, 200, device=dev)
    for _ in range(3):
        ids, valid = _on(dev, rng.integers(0, 300, size=(64, 32))
                         .astype(np.int32), rng.random((64, 32)) > 0.2)
        tk, fk = visited.visited_filter(t.clone(), ids, valid)
        tp, fp = visited.visited_filter_plain(t.clone(), ids, valid)
        assert torch.equal(tk, tp) and torch.equal(fk, fp)
        t = tk


def test_wrappers_reject_bad_tensors(dev):
    X = torch.zeros((10, 4), device=dev)
    idx = torch.zeros((2, 3), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="idx"):
        l2dist.gather_distances(X[:2, None], X, idx)
    with pytest.raises(ValueError, match="ids"):
        topk.rank_merge(torch.zeros((2, 3), device=dev), idx, keep=2)


@pytest.mark.parametrize("visited_mode", ["none", "hash"])
def test_index_kernel_path_matches_plain_path(dev, visited_mode):
    """The whole slice on the card, small: build with the kernels, then
    search the same graph through the kernels and the plain versions."""
    ds = make_clustered(n=3000, d=32, n_queries=300, seed=4)
    cfg = dataclasses.replace(reduced(), bridge_hubs=64,
                              visited_filter=visited_mode)
    K.reset_launch_counts()
    idx = Index.build(ds.X, cfg, device=dev)
    plain = Index(ds.X, dataclasses.replace(cfg, kernel_backend="torch"),
                  graph=idx.graph, device=dev)
    for B in (10, 300):
        a, _ = idx.search(ds.Q[:B])
        b, _ = plain.search(ds.Q[:B])
        assert (a == b).mean() >= 0.98
        assert abs(recall_at_k(a, ds.gt[:B], 10)
                   - recall_at_k(b, ds.gt[:B], 10)) <= 0.01
    counts = K.launch_counts()
    assert counts["gather_distances"] > 0 and counts["rank_merge"] > 0
    assert (counts["visited_filter"] > 0) == (visited_mode == "hash")
