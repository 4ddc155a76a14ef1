"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test here is marked ``cuda`` and skips without a CUDA device (the
kernels have no CPU mode).  The file imports neither JAX nor the reference
package, so it runs on a GPU host that has only PyTorch:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda.py

Tolerances: distances within 1e-5 * (qn + vn) (the kernel sums in another
order than cuBLAS), merges, sorts and the visited filter exactly,
embedding bags within 1e-6 * the bag's sum of |rows|, packed SpMM within
1e-5 * (|agg| @ |W|), attention within 1e-5 * (P @ |V|) of the float32
oracle plus one rounding of the output (2^-8 * |out|) in bfloat16; a
bfloat16 bag or SpMM output likewise, against its plain version on the
widened inputs, plus 2^-8 * |out|.
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
from repro_torch.ann.quantize import quantize_rows
from repro_torch.kernels import (_build, block, embedding_bag,
                                  flash_attention, l2dist, ops, ref,
                                  segment_matmul, topk, visited)

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
    n0 = K.launch_counts()
    out = l2dist.gather_distances(Q, X, idx, mask, metric=metric)
    ref = l2dist.gather_distances_plain(Q, X, idx, mask, metric=metric)
    torch.cuda.synchronize()
    assert K.launch_counts()["gather_distances"] \
        == n0["gather_distances"] + 1
    norms = (Q.double() ** 2).sum(2)[:, :, None] \
        + (X.double() ** 2).sum(1)[idx.long().clamp(0, N - 1)][:, None, :]
    assert ((out.double() - ref.double()).abs() <= 1e-5 * norms).all()
    assert torch.equal(out == 3.4e38, ref == 3.4e38)


@pytest.mark.parametrize("C", [1, 31, 32, 33, 128, 288])
@pytest.mark.parametrize("d", [9, 16, 100, 128, 130, 960])
@pytest.mark.parametrize("Kq", [1, 3])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gather_distances_int8_matches_plain(dev, rng, C, d, Kq, metric):
    """The int8 body (a warp a row, 32-candidate blocks, 16-byte pieces):
    codes dequantized in registers, the scale gathered by the clipped id;
    ids outside [0, N), masked lanes and an all-masked row give exactly
    3.4e38.  d % 16 != 0 takes the byte-load body; C > 32 loops over
    blocks; Kq > 1 reuses the codes (d <= 128) or reloads them."""
    N, S = 5000, 40
    X, Q, idx, mask = _on(
        dev, rng.normal(size=(N, d)).astype(np.float32),
        rng.normal(size=(S, Kq, d)).astype(np.float32),
        rng.integers(-2, N + 20, size=(S, C)).astype(np.int32),
        rng.random((S, C)) > 0.3)
    mask[3] = False
    codes, scales = quantize_rows(X)
    n0 = K.launch_counts()
    out = l2dist.gather_distances(Q, codes, idx, mask, metric=metric,
                                  scales=scales)
    ref = l2dist.gather_distances_plain(Q, codes, idx, mask, metric=metric,
                                        scales=scales)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    assert n1["gather_distances_int8"] == n0["gather_distances_int8"] + 1
    assert n1["gather_distances"] == n0["gather_distances"]
    deq = codes.double() * scales.double()[:, None]
    norms = (Q.double() ** 2).sum(2)[:, :, None] \
        + (deq ** 2).sum(1)[idx.long().clamp(0, N - 1)][:, None, :]
    assert ((out.double() - ref.double()).abs() <= 1e-5 * norms).all()
    valid = (mask & (idx >= 0) & (idx < N))[:, None, :].expand_as(out)
    assert (out[~valid] == 3.4e38).all() and (out[3] == 3.4e38).all()
    assert torch.equal(out == 3.4e38, ref == 3.4e38)


def _shifted(t, dev):
    """``t``'s values one element past the start of their allocation, so
    the pointer is not 16-byte aligned."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=dev)
    buf[1:] = t.reshape(-1)
    return buf[1:].view(t.shape)


@pytest.mark.parametrize("C", [1, 31, 32, 33, 128, 288])
@pytest.mark.parametrize("d", [9, 16, 100, 128, 130, 960])
@pytest.mark.parametrize("Kq", [1, 3])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("offset", [False, True])
def test_gather_distances_bf16_matches_plain(dev, rng, C, d, Kq, metric,
                                             offset):
    """The bf16 row body (a warp a row, 32-candidate blocks, 16-byte
    pieces of 8 elements) against the plain version on ``X.float()``:
    within 1e-5 * (qn + vn) of the upcast rows; ids outside [0, N),
    masked lanes and an all-masked row give exactly 3.4e38.  d % 8 != 0,
    or X one element past its allocation (``offset``), takes the
    element-wise body; C > 32 loops over blocks; Kq > 1 reuses the rows
    (d <= 64) or reloads them."""
    N, S = 5000, 40
    X, Q, idx, mask = _on(
        dev, rng.normal(size=(N, d)).astype(np.float32),
        rng.normal(size=(S, Kq, d)).astype(np.float32),
        rng.integers(-2, N + 20, size=(S, C)).astype(np.int32),
        rng.random((S, C)) > 0.3)
    mask[3] = False
    Xb = X.to(torch.bfloat16)
    if offset:
        Xb = _shifted(Xb, dev)
        assert Xb.data_ptr() % 16
    n0 = K.launch_counts()
    out = l2dist.gather_distances(Q, Xb, idx, mask, metric=metric)
    ref = l2dist.gather_distances_plain(Q, Xb.float(), idx, mask,
                                        metric=metric)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    assert n1["gather_distances_bf16"] == n0["gather_distances_bf16"] + 1
    assert n1["gather_distances"] == n0["gather_distances"]
    norms = (Q.double() ** 2).sum(2)[:, :, None] \
        + (Xb.double() ** 2).sum(1)[idx.long().clamp(0, N - 1)][:, None, :]
    assert ((out.double() - ref.double()).abs() <= 1e-5 * norms).all()
    valid = (mask & (idx >= 0) & (idx < N))[:, None, :].expand_as(out)
    assert (out[~valid] == 3.4e38).all() and (out[3] == 3.4e38).all()
    assert torch.equal(out == 3.4e38, ref == 3.4e38)


def _block_case(dev, rng, S, Kq, C, d, metric, quant, offset=False):
    """One call of the block tile against its plain version: within
    1e-5 * (qn + vn), exactly 3.4e38 where masked (row S // 2 wholly when
    S >= 3), one launch on the body's counter.  ``offset``: Q and V start
    one element past their allocation, so neither is 16-byte aligned and
    the tile stages element by element."""
    Q, V, mask = _on(dev, rng.normal(size=(S, Kq, d)).astype(np.float32),
                     rng.normal(size=(S * C, d)).astype(np.float32),
                     rng.random((S, C)) > 0.25)
    if S >= 3:
        mask[S // 2] = False
    sc = None
    if quant:
        V, sc = quantize_rows(V)
        sc = sc.reshape(S, C)
    if offset:
        Q, V = _shifted(Q, dev), _shifted(V, dev)
        assert Q.data_ptr() % 16 and V.data_ptr() % 16
    V = V.reshape(S, C, d)
    body = "block_distances_int8" if quant else "block_distances"
    n0 = K.launch_counts()
    out = block.block_distances(Q, V, mask, sc, metric=metric)
    ref = block.block_distances_plain(Q, V, mask, sc, metric=metric)
    torch.cuda.synchronize()
    n1 = K.launch_counts()
    assert n1[body] == n0[body] + 1
    assert sum(n1.values()) == sum(n0.values()) + 1
    Vd = V.double() if sc is None else V.double() * sc.double()[:, :, None]
    norms = (Q.double() ** 2).sum(2)[:, :, None] \
        + (Vd ** 2).sum(2)[:, None, :]
    live = mask[:, None, :].expand_as(out)
    err = (out.double() - ref.double()).abs()
    assert (err[live] <= 1e-5 * norms[live]).all()
    assert torch.isfinite(out[live]).all()
    assert torch.equal(out == 3.4e38, ~live)


@pytest.mark.parametrize("Kq", [1, 127, 128, 129])
@pytest.mark.parametrize("C", [1, 63, 64, 65, 300])
@pytest.mark.parametrize("d", [9, 20, 33, 128, 130, 960])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quant", [False, True])
def test_block_distances_matches_plain(dev, rng, Kq, C, d, metric, quant):
    """The block on the tensor-core tile, fp32 and int8 codes, over the
    128 x 64 tile's edges (Kq 127-129, C 63-65 and 300), d in one 32-column
    chunk or many (960), in 16-byte pieces (d = 20 and 128 for fp32, 128
    and 960 for int8) or element by element (9, 33, 130), on S = 3 rows of
    which the middle one is wholly masked."""
    _block_case(dev, rng, 3, Kq, C, d, metric, quant)


@pytest.mark.parametrize("S,Kq,C,d", [(1, 200, 100, 128),
                                      (2048, 1, 32, 128),
                                      (65537, 2, 3, 4)])
@pytest.mark.parametrize("quant", [False, True])
def test_block_distances_rows_s(dev, rng, S, Kq, C, d, quant):
    """The row axis s: one row, the general shape's 2,048 rows, and
    65,537 rows, past the grid's 65,535 (a CTA loops over rows)."""
    _block_case(dev, rng, S, Kq, C, d, "l2", quant)


@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("quant", [False, True])
def test_block_distances_unaligned_rows(dev, rng, d, metric, quant):
    """Q and V one element off their allocation: rows whose width would
    take 16-byte pieces stage element by element instead."""
    _block_case(dev, rng, 3, 129, 65, d, metric, quant, offset=True)


def test_distance_tiles_reject_too_many_tiles(dev):
    """Past 2^31 - 1 tiles of 128 x 64 (2^17 x 2^14 = 2^31 here; d = 0
    keeps the operands empty) both wrappers raise before launching."""
    Q = torch.zeros((1, 1 << 24, 0), device=dev)
    V = torch.zeros((1, 1 << 20, 0), device=dev)
    n0 = K.launch_counts()
    with pytest.raises(ValueError, match="tiles"):
        block.block_distances(Q, V)
    with pytest.raises(ValueError, match="tiles"):
        ops.distance_matrix(Q[0], V[0])
    assert K.launch_counts() == n0


def test_scan_distances_through_the_seam(dev, rng):
    Q, Xd, m = _on(dev, rng.normal(size=(77, 16)).astype(np.float32),
                   rng.normal(size=(200, 16)).astype(np.float32),
                   rng.random(200) > 0.5)
    codes, sc = quantize_rows(Xd)
    for args in ((Xd, None), (codes, sc)):
        out = HP.scan_distances(Q, args[0], mask=m, scales=args[1])
        ref = HP.scan_distances(Q, args[0], mask=m, scales=args[1],
                                backend="torch")
        assert out.shape == (77, 200)
        assert torch.allclose(out, ref, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("K_,d", [
    *((k, d) for k in (8, 20, 32, 64) for d in (20, 33, 128, 960)),
    (100, 128), (100, 960), (128, 128), (128, 960), (1024, 48)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_gather_distances_self_query_matches_plain(dev, rng, K_, d, metric):
    """The diversify tiles on tensor cores: four tiles a CTA (K = 8), two
    (K = 20 and 32) or one; d in one chunk (20, 128) or streamed (GIST's
    960); d = 33 stages 4-byte rows; ids past N are clipped and masked.
    K > 64 takes two or more 64-column blocks, walked by the warps in
    rounds, each round streaming d again when d > 128; K = 1,024 is the
    widest tile, in 16-column chunks."""
    N = 3000
    X, idx, mask = _on(dev, rng.normal(size=(N, d)).astype(np.float32),
                       rng.integers(0, N + 5, size=(41, K_)).astype(np.int32),
                       rng.random((41, K_)) > 0.2)
    n0 = K.launch_counts()["gather_distances"]
    out = l2dist.gather_distances(None, X, idx, mask, metric=metric,
                                  self_q=True)
    ref = l2dist.gather_distances_plain(None, X, idx, mask, metric=metric,
                                        self_q=True)
    torch.cuda.synchronize()
    assert K.launch_counts()["gather_distances"] == n0 + 1
    vn = (X.double() ** 2).sum(1)[idx.long().clamp(0, N - 1)]
    tol = 1e-5 * (vn[:, :, None] + vn[:, None, :])
    assert ((out.double() - ref.double()).abs() <= tol).all()
    valid = ((idx < N) & mask)[:, None, :].expand_as(out)
    assert torch.equal(out == 3.4e38, ~valid)


def test_gather_distances_self_query_rejects_wide_tiles(dev):
    """Past K = 1,024 the staged rows do not fit a CTA: the call raises."""
    X = torch.zeros((10, 16), device=dev)
    idx = torch.zeros((1, 1025), dtype=torch.int32, device=dev)
    with pytest.raises(RuntimeError, match="gather_distances"):
        l2dist.gather_distances(None, X, idx, self_q=True)


def _merge_launches(R, W, keep):
    """Launches of one rank merge or top-k: its plan, or on the "chunks"
    path each column chunk's and each merge of the survivors'."""
    if topk.path(W, keep) != "chunks":
        return len(topk.plan(R, W, keep))
    n = 0
    while W > topk.MAX_LANES:
        starts = range(0, W, topk.MAX_LANES)
        n += sum(_merge_launches(R, min(topk.MAX_LANES, W - c),
                                 min(keep, W - c)) for c in starts)
        W = sum(min(keep, W - c) for c in starts)
    return n + _merge_launches(R, W, keep)


def _merge_case(rng, R, W):
    """Repeated dists, -0.0 beside +0.0 on equal ids, a row all masked and
    a row all 3.4e38 (R >= 3), PAD_ID lanes and ids near 2^31 - 1."""
    d = (rng.integers(0, 6, size=(R, W)) * 0.5).astype(np.float32)
    d[rng.random((R, W)) < 0.1] = -0.0
    d[rng.random((R, W)) < 0.03] = np.float32(topk.INF)
    ids = rng.integers(0, 99, size=(R, W)).astype(np.int32)
    ids[rng.random((R, W)) < 0.03] = topk.PAD_ID
    ids[rng.random((R, W)) < 0.03] = topk.PAD_ID - 1
    mask = rng.random((R, W)) > 0.2
    if R >= 3:
        mask[1] = False
        d[2] = np.float32(topk.INF)
    return d, ids, mask


_WIDTHS = (1, 31, 32, 33, 64, 96, 320, 1024, 1025, 2048, 16384, 16385,
           32768, 1 << 20)
_MERGE_CASES = [(50, 32, 32), (50, 320, 32), (7, 2048, 10), (9, 5, 3),
                (6, 40000, 40), (2, 16385, 16383)] + [
    (3 if W <= 2048 else 2, W, keep) for W in _WIDTHS
    for keep in sorted({1, 10, 32, 40, 64, topk.K_MAX, W})
    if keep <= W and (W <= topk.MAX_LANES or keep < topk.MAX_LANES)]


@pytest.mark.parametrize("R,W,keep", _MERGE_CASES)
def test_rank_merge_matches_plain(dev, rng, R, W, keep):
    """Every path's edges: ids equal bit for bit, dists by value, and
    the launches its plan gives (each column chunk one more on the
    "chunks" path)."""
    d, ids, mask = _on(dev, *_merge_case(rng, R, W))
    n0 = K.launch_counts()["rank_merge"]
    od, oi = topk.rank_merge(d, ids, mask, keep=keep)
    rd, ri = topk.rank_merge_plain(d, ids, mask, keep=keep)
    assert torch.equal(oi, ri) and bool((od == rd).all())
    assert K.launch_counts()["rank_merge"] - n0 \
        == _merge_launches(R, W, keep)


def test_topk_bodies_fit_without_spills(dev):
    """The card's own count: no body spills to local memory, and each
    fits its launch (255 registers at most; 256 threads of the warp body,
    512 of the CTA sort, in 65,536 registers)."""
    attrs = topk.body_attributes()
    assert len(attrs) == 11
    for name, (regs, local) in attrs.items():
        threads = 512 if name == "cta_sort" else topk.WARP_BODY_THREADS
        assert local == 0, (name, local)
        assert regs <= 255 and regs * threads <= 65536, (name, regs)


@pytest.mark.parametrize("M", [1, 7, 32, 33, 128])
@pytest.mark.parametrize("S,W", [(16, 8), (64, 8), (16, 3)])
def test_visited_filter_matches_plain(dev, rng, M, S, W):
    """Bit for bit, table and fresh lanes, over successive calls: ids are
    drawn from 1 or 3 buckets a row (chosen by their hash_bucket), so
    lanes share buckets, buckets fill and lanes drop; ids repeat inside
    and across calls; M > 32 runs in chunks of 32; W = 3 takes the
    word-by-word body."""
    B = 64
    pool = np.arange(20 * S, dtype=np.int32)
    home = visited.hash_bucket(torch.from_numpy(pool),
                               visited.shift_for(S)).numpy()
    # each row draws its ids from the same 1 (M < 32) or 3 buckets
    rows = [pool[np.isin(home, rng.choice(S, 1 if M < 32 else 3))]
            for _ in range(B)]
    t = torch.full((B, S, W), visited.VF_EMPTY, dtype=torch.int32,
                   device=dev)
    drops = 0
    for _ in range(4):
        ids = np.stack([rng.choice(r, M) for r in rows]).astype(np.int32)
        ids[:, M // 2:] = ids[:, :M - M // 2]
        ids, valid = _on(dev, ids, rng.random((B, M)) > 0.2)
        tk, fk = visited.visited_filter(t.clone(), ids, valid)
        tp, fp = visited.visited_filter_plain(t.clone(), ids, valid)
        assert torch.equal(tk, tp) and torch.equal(fk, fp)
        held = (tp[:, None] == ids[:, :, None, None]).any(3).any(2)
        drops += int((valid & ~fp & ~held).sum())
        t = tk
    assert drops > 0 or M == 1


def test_wrappers_reject_bad_tensors(dev):
    X = torch.zeros((10, 4), device=dev)
    idx = torch.zeros((2, 3), dtype=torch.int64, device=dev)
    with pytest.raises(ValueError, match="idx"):
        l2dist.gather_distances(X[:2, None], X, idx)
    with pytest.raises(ValueError, match="ids"):
        topk.rank_merge(torch.zeros((2, 3), device=dev), idx, keep=2)
    with pytest.raises(ValueError, match="scales"):
        l2dist.gather_distances(X[:2, None], X.to(torch.int8),
                                idx.to(torch.int32),
                                scales=torch.ones(10, dtype=torch.float64,
                                                  device=dev))
    with pytest.raises(ValueError, match="V"):
        block.block_distances(X[None], X[None].to(torch.int8))
    with pytest.raises(ValueError, match="ways"):
        visited.visited_filter(
            torch.full((2, 64, 9), -1, dtype=torch.int32, device=dev),
            idx.to(torch.int32), torch.ones((2, 3), dtype=torch.bool,
                                             device=dev))


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


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_streaming_index_kernel_path_matches_plain_path(dev, quant):
    """int8 residency and the streaming path on the card, small: the same
    mutations on a kernel-path and a plain-path index answer alike."""
    ds = make_clustered(n=3000, d=32, n_queries=300, seed=4)
    cfg = dataclasses.replace(reduced(), bridge_hubs=64, quantization=quant)
    rng = np.random.default_rng(3)
    V = (ds.X[rng.integers(0, 3000, 500)]
         + 0.05 * rng.normal(size=(500, 32))).astype(np.float32)
    K.reset_launch_counts()
    idx = Index.build(ds.X, cfg, device=dev)
    plain = Index(ds.X, dataclasses.replace(cfg, kernel_backend="torch"),
                  graph=idx.graph, device=dev)
    for index in (idx, plain):
        new = index.add(V)
        index.delete(np.arange(0, 3000, 31))
        index.delete(new[::7])
    for B in (10, 300):
        a, _ = idx.search(ds.Q[:B])
        b, _ = plain.search(ds.Q[:B])
        assert (a == b).mean() >= 0.98
        assert not np.isin(a, np.arange(0, 3000, 31)).any()
    ids, _ = idx.search(V[1:7])
    assert (ids[:, 0] == 3001 + np.arange(6)).all()
    counts = K.launch_counts()
    body = "block_distances" + ("_int8" if quant == "int8" else "")
    assert counts[body] > 0
    assert (counts["gather_distances_int8"] > 0) == (quant == "int8")
    id_map = idx.compact()
    assert idx.generation == 1 and idx.n_active == int((id_map >= 0).sum())


def test_int8_stream_past_the_merge_width_matches_plain_path(dev):
    """An int8 mutable index whose delta outgrew the rank_merge kernel's
    16384 lanes (16,400 adds: capacity 32768) still answers on the card,
    as the plain path does."""
    ds = make_clustered(n=3000, d=32, n_queries=300, seed=4)
    cfg = dataclasses.replace(reduced(), bridge_hubs=64,
                              quantization="int8")
    rng = np.random.default_rng(5)
    V = (ds.X[rng.integers(0, 3000, 16400)]
         + 0.05 * rng.normal(size=(16400, 32))).astype(np.float32)
    idx = Index.build(ds.X, cfg, device=dev)
    plain = Index(ds.X, dataclasses.replace(cfg, kernel_backend="torch"),
                  graph=idx.graph, device=dev)
    for index in (idx, plain):
        new = index.add(V)
        index.delete(new[::9])
    assert idx.engine.stream.delta.cap == 32768
    K.reset_launch_counts()
    for B in (10, 300):
        a, _ = idx.search(ds.Q[:B])
        b, _ = plain.search(ds.Q[:B])
        assert (a == b).mean() >= 0.98
        assert not np.isin(a, new[::9]).any()
    ids, _ = idx.search(V[16390:16398])      # live: no multiple of 9
    assert (ids[:, 0] == 3000 + np.arange(16390, 16398)).all()
    assert K.launch_counts()["block_distances_int8"] > 0


# ----------------------------------------------------------------------
# the kernel API (kernels/ops.py)
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,N,d", [(1, 300, 33), (70, 200, 48),
                                   (130, 1000, 128), (129, 8193, 128),
                                   (129, 1001, 960)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_distance_matrix_matches_plain(dev, rng, B, N, d, metric, dtype):
    """Ragged 128 x 64 tiles (B = 129, N = 8,193 and 1,001), odd N (one
    float at a time), d in one chunk or many (960), and 4-byte rows
    (d = 33) staged element-wise."""
    Q, X = _on(dev, rng.normal(size=(B, d)).astype(np.float32),
               rng.normal(size=(N, d)).astype(np.float32))
    Q, X = Q.to(dtype), X.to(dtype)
    n0 = K.launch_counts()["distance_matrix"]
    out = ops.distance_matrix(Q, X, metric=metric)
    ref = block.distance_matrix_plain(Q, X, metric=metric)
    torch.cuda.synchronize()
    assert K.launch_counts()["distance_matrix"] == n0 + 1
    assert out.dtype == torch.float32 and out.shape == (B, N)
    norms = (Q.double() ** 2).sum(1)[:, None] + (X.double() ** 2).sum(1)
    assert ((out.double() - ref.double()).abs() <= 1e-5 * norms).all()


def test_distance_tile_bodies_fit_without_spills(dev):
    """The card's own count for the tensor-core distance tiles (the
    self-query body of l2dist.cu; block.cu's tile, in its float32, bf16
    and int8-code bodies): no spill to local memory, at most 255
    registers."""
    l2 = l2dist.body_attributes()
    attrs = {**{b: l2[b] for b in l2dist.SELFQ_BODIES},
             **block.body_attributes()}
    assert list(attrs) == l2dist.SELFQ_BODIES + block.DM_BODIES
    for name, (regs, local) in attrs.items():
        assert local == 0, (name, local)
        assert regs <= 255, (name, regs)


def test_search_hop_bodies_fit_without_spills(dev):
    """The card's own count for the search hop's bodies (l2dist.cu's int8
    and bf16 row bodies, visited.cu's filter): no spill to local memory,
    at most 255 registers."""
    l2 = l2dist.body_attributes()
    rows = l2dist.ROW8_BODIES + l2dist.ROWBF16_BODIES
    attrs = {**{b: l2[b] for b in rows}, **visited.body_attributes()}
    assert list(attrs) == rows + visited.BODIES
    for name, (regs, local) in attrs.items():
        assert local == 0, (name, local)
        assert regs <= 255, (name, regs)


def test_distance_matrix_rejects_mixed_types(dev):
    X = torch.zeros((10, 4), device=dev)
    with pytest.raises(ValueError, match="Q"):
        ops.distance_matrix(X.to(torch.bfloat16), X)
    with pytest.raises(ValueError, match="X"):
        ops.distance_matrix(X.half(), X.half())


@pytest.mark.parametrize("R,W", [(3, 8), (37, 32), (200, 1024),
                                 (4, 16384), (5, 1), (3, 2048), (2, 4096)])
def test_bitonic_sort_matches_plain(dev, rng, R, W):
    """Repeated distances, -0.0 beside +0.0 and repeated ids, up to the
    kernel's widest row: the warp path to 1,024 lanes, the CTA sort
    above."""
    d = (rng.integers(0, 6, size=(R, W)) * 0.5).astype(np.float32)
    d[rng.random((R, W)) < 0.1] = -0.0
    d, ids = _on(dev, d, rng.integers(0, 99, size=(R, W)).astype(np.int32))
    n0 = K.launch_counts()["bitonic_sort"]
    od, oi = ops.bitonic_sort(d, ids)
    rd, ri = ref.sort_ref(d, ids)
    assert K.launch_counts()["bitonic_sort"] == n0 + 1
    assert torch.equal(oi, ri) and bool((od == rd).all())


@pytest.mark.parametrize("W,k,launches", [
    (1024, 10, 1), (32768, 10, 2), (2048, 10, 1), (1 << 20, 10, 2),
    (16384, 256, 1), (16384, 257, 1), (32768, 300, 3)])
def test_bitonic_topk_matches_plain(dev, rng, W, k, launches):
    """One warp a row up to 1,024 lanes; a selection up to ``K_MAX``
    kept (a second launch where a row takes several CTAs); the CTA sort
    above it; column chunks of 16,384, each sorted, and a merge beyond."""
    d, ids = _on(dev, rng.normal(size=(3, W)).astype(np.float32),
                 rng.integers(0, 1 << 20, size=(3, W)).astype(np.int32))
    n0 = K.launch_counts()["bitonic_sort"]
    od, oi = ops.bitonic_topk(d, ids, k)
    rd, ri = ref.topk_ref(d, ids, k)
    assert K.launch_counts()["bitonic_sort"] - n0 == launches \
        == _merge_launches(3, W, k)
    assert torch.equal(oi, ri) and torch.equal(od, rd)


@pytest.mark.parametrize("V,E,B,bag", [(1000, 32, 64, 10), (500, 40, 19, 7),
                                       (300, 8, 33, 20)])
@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_embedding_bag_matches_plain(dev, rng, V, E, B, bag, combine):
    """E off the warp's 32 lanes, and bags longer than the 16 row loads
    the kernel issues at once."""
    table, ids = _on(dev, rng.normal(size=(V, E)).astype(np.float32),
                     rng.integers(0, V, size=(B, bag)).astype(np.int32))
    n0 = K.launch_counts()["embedding_bag"]
    out = ops.embedding_bag(table, ids, combine=combine)
    ref = embedding_bag.embedding_bag_plain(table, ids, combine=combine)
    torch.cuda.synchronize()
    assert K.launch_counts()["embedding_bag"] == n0 + 1
    scale = table.abs()[ids.long()].sum(1) / (bag if combine == "mean" else 1)
    assert ((out - ref).abs() <= 1e-6 * scale).all()


@pytest.mark.parametrize("V,E,B,bag", [(1000, 32, 64, 10), (500, 40, 19, 7),
                                       (300, 8, 33, 20)])
@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_embedding_bag_bf16_matches_plain(dev, rng, V, E, B, bag, combine):
    """The bfloat16 body: rows widened, summed in float32, the output
    rounded once to bfloat16; against the plain version on the widened
    table within 1e-6 * the bag's sum of |rows| plus 2^-8 * |out|."""
    table, ids = _on(dev, rng.normal(size=(V, E)).astype(np.float32),
                     rng.integers(0, V, size=(B, bag)).astype(np.int32))
    table = table.bfloat16()
    n0 = K.launch_counts()["embedding_bag"]
    out = ops.embedding_bag(table, ids, combine=combine)
    want = embedding_bag.embedding_bag_plain(table.float(), ids,
                                             combine=combine)
    torch.cuda.synchronize()
    assert K.launch_counts()["embedding_bag"] == n0 + 1
    assert out.dtype == torch.bfloat16 and out.shape == (B, E)
    scale = table.float().abs()[ids.long()].sum(1) / (
        bag if combine == "mean" else 1)
    assert ((out.float() - want).abs()
            <= 1e-6 * scale + 2.0 ** -8 * want.abs()).all()
    assert torch.equal(out, embedding_bag.embedding_bag_plain(
        table, ids, combine=combine))


_BAG_CASES = [(1, 1), (10, 512), (17, 333), (40, 70_000)]


@pytest.mark.parametrize("E", [8, 16, 24, 32, 40, 64, 128, 300])
@pytest.mark.parametrize("bag,B", _BAG_CASES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_embedding_bag_vector_equals_lane(dev, rng, E, bag, B, dtype,
                                          combine):
    """The vector route bit for bit against the lane route and the plain
    version (the same adds in the same order), one launch a call, over
    rows of 1-75 pieces (E = 300 in float32 walks its row 32 pieces at a
    time), bags longer than the 8 row loads a lane issues at once, and
    batches past one pass of the persistent grid.  Rows that are not a
    whole number of 16-byte pieces take the lane route, and forcing the
    vector route on them raises."""
    V = 1000
    table, ids = _on(dev, rng.normal(size=(V, E)).astype(np.float32),
                     rng.integers(0, V, size=(B, bag)).astype(np.int32))
    table = table.to(dtype)
    plain = embedding_bag.embedding_bag_plain(table, ids, combine=combine)
    n0 = K.launch_counts()["embedding_bag"]
    lane = embedding_bag.embedding_bag(table, ids, combine=combine,
                                       via="lane")
    torch.cuda.synchronize()
    assert K.launch_counts()["embedding_bag"] == n0 + 1
    assert torch.equal(lane, plain)
    if (E * table.element_size()) % 16:
        assert embedding_bag.path(table, ids) == "lane"
        with pytest.raises(ValueError, match="16 bytes"):
            embedding_bag.embedding_bag(table, ids, via="vector")
        return
    assert embedding_bag.path(table, ids) == "vector"
    vec = embedding_bag.embedding_bag(table, ids, combine=combine,
                                      via="vector")
    auto = ops.embedding_bag(table, ids, combine=combine)
    torch.cuda.synchronize()
    assert K.launch_counts()["embedding_bag"] == n0 + 3
    assert vec.dtype == dtype and vec.shape == (B, E)
    assert torch.equal(vec, lane) and torch.equal(auto, vec)
    want = embedding_bag.embedding_bag_plain(table.float(), ids,
                                             combine=combine)
    scale = table.float().abs()[ids.long()].sum(1) / (
        bag if combine == "mean" else 1)
    tol = 1e-6 * scale + (2.0 ** -8 * want.abs()
                          if dtype == torch.bfloat16 else 0.0)
    assert ((vec.float() - want).abs() <= tol).all()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("via", ["vector", "lane"])
def test_embedding_bag_clamps_ids_outside_the_table(dev, rng, dtype, via):
    """Ids below 0 read row 0 and ids at or past V row V - 1, on both
    routes, as the plain version clamps them."""
    V, E, B, bag = 300, 32, 1000, 10
    table, ids = _on(dev, rng.normal(size=(V, E)).astype(np.float32),
                     rng.integers(-50, V + 50, size=(B, bag)).astype(
                         np.int32))
    table = table.to(dtype)
    ids[0] = torch.tensor([-2 ** 31, 2 ** 31 - 1, V, -1, 0, V - 1, 5, 6, 7,
                           8], dtype=torch.int32)
    out = embedding_bag.embedding_bag(table, ids, via=via)
    assert torch.equal(out, embedding_bag.embedding_bag_plain(table, ids))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_embedding_bag_unaligned_table_takes_the_lane_route(dev, rng,
                                                            dtype):
    """A table one element off its allocation is not 16-byte aligned: it
    takes the lane route, one launch, and the vector route refuses it."""
    V, E, B, bag = 500, 32, 700, 10
    base = torch.from_numpy(rng.normal(size=V * E + 1).astype(
        np.float32)).to(dev).to(dtype)
    table = base[1:].view(V, E)
    ids = _on(dev, rng.integers(0, V, size=(B, bag)).astype(np.int32))[0]
    assert table.is_contiguous() and table.data_ptr() % 16
    assert embedding_bag.path(table, ids) == "lane"
    assert embedding_bag.path(table.clone(), ids) == "vector"
    n0 = K.launch_counts()["embedding_bag"]
    out = embedding_bag.embedding_bag(table, ids)
    torch.cuda.synchronize()
    assert K.launch_counts()["embedding_bag"] == n0 + 1
    assert torch.equal(out, embedding_bag.embedding_bag_plain(table, ids))
    with pytest.raises(ValueError, match="16-byte aligned"):
        embedding_bag.embedding_bag(table, ids, via="vector")


@pytest.mark.parametrize("E,dtype,route", [
    (32, torch.float32, "vector"), (4, torch.float32, "vector"),
    (30, torch.float32, "lane"), (300, torch.float32, "vector"),
    (8, torch.bfloat16, "vector"), (12, torch.bfloat16, "lane"),
    (300, torch.bfloat16, "lane"), (32, torch.bfloat16, "vector")])
def test_embedding_bag_path_names_the_route(dev, E, dtype, route):
    table = torch.zeros((10, E), dtype=dtype, device=dev)
    ids = torch.zeros((3, 2), dtype=torch.int32, device=dev)
    assert embedding_bag.path(table, ids) == route
    with pytest.raises(ValueError, match="via"):
        embedding_bag.embedding_bag(table, ids, via="warp")


@pytest.mark.parametrize("full_width", [False, True])
def test_wide_deep_kernel_path_matches_plain(dev, full_width):
    """Wide & Deep's serve step on the card: the reduced config, and the
    full config's widths (40 fields of 32, 4 bag fields of 10, the
    1024-512-256 MLP) over vocabularies of 5,000 rows.  The kernel path
    launches embedding_bag once a bag field a step and its probabilities
    equal the plain path's (kernel_backend="torch", the kernel's plain
    version: the same adds); retrieval_step's ids too."""
    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.data.recsys import CTRStream
    from repro_torch.models import recsys as R
    from repro_torch.models.module import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced("wide-deep")
    if full_width:
        cfg = dataclasses.replace(get_arch("wide-deep"),
                                  vocab_sizes=(5000,) * 40)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = R.WideDeep(cfg, init_params(R.schema(cfg), gen, dev))
    batch = R.batch_to(next(CTRStream(cfg, 2048, seed=0)), dev)
    n0 = K.launch_counts()["embedding_bag"]
    kern = R.serve_step(model, cfg, batch)
    torch.cuda.synchronize()
    assert K.launch_counts()["embedding_bag"] - n0 == len(
        cfg.multi_hot_fields)
    plain = R.serve_step(model, cfg, batch, kernel_backend="torch")
    torch.cuda.synchronize()
    assert K.launch_counts()["embedding_bag"] - n0 == len(
        cfg.multi_hot_fields)
    assert bool(torch.isfinite(kern).all())
    assert float((kern - plain).abs().max()) <= 1e-6
    one = {k: v[:1] for k, v in batch.items()}
    items = torch.randn((50_000, R.RETRIEVAL_DIM), generator=gen, device=dev)
    ids_k, top_k = R.retrieval_step(model, cfg, dict(one, item_vectors=items))
    ids_p, top_p = R.retrieval_step(model, cfg, dict(one, item_vectors=items),
                                    kernel_backend="torch")
    assert torch.equal(top_k, top_p) and torch.equal(ids_k, ids_p)


def test_embedding_bag_bodies_fit_without_spills(dev):
    """The card's own count for embedding_bag.cu's bodies (the lane and
    every vector body): no spill to local memory, at most 255
    registers."""
    attrs = embedding_bag.body_attributes()
    assert list(attrs) == embedding_bag.BODIES
    for name, (regs, local) in attrs.items():
        assert local == 0, (name, local)
        assert regs <= 255, (name, regs)


def _spmm_case(dev, rng, N, M, Nf, d, f, offset=0,
               dtypes=(torch.float32, torch.float32)):
    """Ids in [-2, Nf + Nf / 9): sentinels, negative ids and (N > 5) an
    all-sentinel row 5; feat and W in ``dtypes``; with ``offset``, every
    operand starts that many elements into its allocation."""
    nbrs = rng.integers(-2, Nf + Nf // 9, size=(N, M)).astype(np.int32)
    if N > 5:
        nbrs[5] = Nf
    out = []
    for a, dt in ((nbrs, None),
                  (rng.normal(size=(Nf, d)).astype(np.float32), dtypes[0]),
                  (rng.normal(size=(d, f)).astype(np.float32), dtypes[1])):
        t = torch.from_numpy(np.concatenate([np.zeros(offset, a.dtype),
                                             a.ravel()])).to(dev)
        out.append((t if dt is None else t.to(dt))[offset:].view(a.shape))
    return out


def _assert_spmm(dev, nbrs, feat, w, combine, via):
    """One call along ``via`` within 1e-5 * (|agg| @ |W|) of the plain
    version on the widened inputs (plus 2^-8 * |out| for a bfloat16
    output), in feat's dtype, with the route's launches counted (fused 1,
    transform 2)."""
    n0 = K.launch_counts()["packed_spmm"]
    out = segment_matmul.packed_spmm(nbrs, feat, w, combine=combine, via=via)
    ref = segment_matmul.packed_spmm_plain(nbrs, feat.float(), w.float(),
                                           combine=combine)
    torch.cuda.synchronize()
    assert K.launch_counts()["packed_spmm"] - n0 == (1 if via == "fused"
                                                     else 2)
    agg = segment_matmul.aggregate(nbrs, feat, combine=combine)
    tol = 1e-5 * (agg.abs() @ w.float().abs())
    if feat.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * ref.abs()
    assert out.dtype == feat.dtype and out.shape == ref.shape
    assert bool(torch.isfinite(out).all())
    assert ((out.float() - ref).abs() <= tol).all()
    if nbrs.shape[0] > 5:
        assert (out[5] == 0).all()


@pytest.mark.parametrize("N,M,Nf", [(1, 15, 50), (129, 1, 40),
                                    (129, 20, 1000), (300, 15, 90),
                                    (300, 20, 2000)])
@pytest.mark.parametrize("d", [8, 70, 602, 960])
@pytest.mark.parametrize("f", [8, 16, 128, 200])
@pytest.mark.parametrize("via", ["fused", "transform"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_packed_spmm_matches_plain(dev, N, M, Nf, d, f, via, combine):
    """Both routes over their tiles' edges: sentinels skipped, negative ids
    read row 0, an all-sentinel row gives zeros; Nf below and above N; d
    in one 32-column chunk or many, its rows 16-byte (d = 8, 960) or only
    8-byte aligned (70, 602: the projection's 8-byte pieces); f within
    one 128-column tile or past it (200); M past the 16 row loads in
    flight."""
    rng = np.random.default_rng([N, M, Nf, d, f])
    _assert_spmm(dev, *_spmm_case(dev, rng, N, M, Nf, d, f), combine, via)


@pytest.mark.parametrize("N,M,Nf", [(1, 15, 50), (129, 1, 40),
                                    (129, 20, 1000), (300, 15, 90),
                                    (300, 20, 2000)])
@pytest.mark.parametrize("d", [8, 70, 602, 960])
@pytest.mark.parametrize("f", [8, 16, 128, 200])
@pytest.mark.parametrize("via", ["fused", "transform"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_packed_spmm_bf16_matches_plain(dev, N, M, Nf, d, f, via, combine):
    """The bfloat16 bodies over the float32 cases' edges: bfloat16 feat
    (the projection's element-wise staging, the fused gather's widening),
    float32 W, a bfloat16 output rounded once."""
    rng = np.random.default_rng([N, M, Nf, d, f, 16])
    _assert_spmm(dev, *_spmm_case(dev, rng, N, M, Nf, d, f,
                                  dtypes=(torch.bfloat16, torch.float32)),
                 combine, via)


@pytest.mark.parametrize("N,M,Nf", [(129, 20, 1000), (300, 15, 90)])
@pytest.mark.parametrize("d,f", [(70, 16), (602, 128), (960, 200)])
@pytest.mark.parametrize("feat_dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("via", ["fused", "transform"])
def test_packed_spmm_bf16_weights(dev, N, M, Nf, d, f, feat_dtype, via):
    """W in bfloat16, widened as it is read, with either feat: the
    projection's bodies for a bfloat16 W and the fused body's W load."""
    rng = np.random.default_rng([N, M, Nf, d, f, 2])
    _assert_spmm(dev, *_spmm_case(dev, rng, N, M, Nf, d, f,
                                  dtypes=(feat_dtype, torch.bfloat16)),
                 "mean", via)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_project_returns_its_dtype(dev, out_dtype):
    """``project`` alone: bfloat16 features give a bfloat16 Y by default,
    rounded once from the float32 product."""
    rng = np.random.default_rng(7)
    _, feat, w = _spmm_case(dev, rng, 1, 1, 300, 602, 128,
                            dtypes=(torch.bfloat16, torch.float32))
    y = segment_matmul.project(feat, w, out_dtype=out_dtype)
    want = feat.float() @ w
    torch.cuda.synchronize()
    assert y.dtype == out_dtype
    tol = 1e-5 * (feat.float().abs() @ w.abs())
    if out_dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * want.abs()
        assert segment_matmul.project(feat, w).dtype == torch.bfloat16
    assert ((y.float() - want).abs() <= tol).all()


@pytest.mark.parametrize("N,Nf,via", [(3000, 3000, "transform"),
                                      (300, 20000, "fused")])
def test_packed_spmm_api_takes_path(dev, N, Nf, via):
    """``ops.packed_spmm`` launches the route ``path`` picks: GraphSAGE's
    widths (M = 15, 602 -> 128) over the whole table project first, a
    minibatch over a table 67 times its size does not."""
    assert segment_matmul.path(N, 15, Nf, 602, 128) == via
    rng = np.random.default_rng([N, Nf])
    nbrs, feat, w = _spmm_case(dev, rng, N, 15, Nf, 602, 128)
    n0 = K.launch_counts()["packed_spmm"]
    out = ops.packed_spmm(nbrs, feat, w, combine="mean")
    torch.cuda.synchronize()
    assert K.launch_counts()["packed_spmm"] - n0 == (1 if via == "fused"
                                                     else 2)
    ref = segment_matmul.packed_spmm_plain(nbrs, feat, w, combine="mean")
    agg = segment_matmul.aggregate(nbrs, feat, combine="mean")
    assert ((out - ref).abs() <= 1e-5 * (agg.abs() @ w.abs())).all()


@pytest.mark.parametrize("d,f", [(602, 128), (33, 31), (70, 30)])
@pytest.mark.parametrize("via", ["fused", "transform"])
def test_packed_spmm_unaligned_rows(dev, d, f, via):
    """Operands one element off their allocation: the projection stages
    feat and W in 4-byte pieces; odd f stores Y one float at a time and
    f % 4 != 0 takes the gather's element-wise body."""
    rng = np.random.default_rng([d, f])
    _assert_spmm(dev, *_spmm_case(dev, rng, 300, 15, 400, d, f, offset=1),
                 "mean", via)


def test_spmm_bodies_fit_without_spills(dev):
    """The card's own count for segment_matmul.cu's bodies: no spill to
    local memory, at most 255 registers, and tensor-core (HMMA)
    instructions in each of the projection's bodies."""
    attrs = segment_matmul.body_attributes()
    assert list(attrs) == segment_matmul.BODIES
    for name, (regs, local) in attrs.items():
        assert local == 0, (name, local)
        assert regs <= 255, (name, regs)
    hmma = _build.hmma_counts("segment_matmul")
    assert hmma is not None, "cuobjdump not found beside nvcc"
    project = [n for k, n in hmma.items() if "project_kernel" in k]
    assert len(project) == len(segment_matmul.PROJECT_BODIES), hmma
    assert min(project) > 0, hmma


@pytest.mark.parametrize("d,f", [(602, 128), (33, 31)])
@pytest.mark.parametrize("via", ["fused", "transform"])
def test_packed_spmm_bf16_unaligned_rows(dev, d, f, via):
    """bfloat16 operands one element off their allocation (2-byte
    aligned): element-wise reads and stores."""
    rng = np.random.default_rng([d, f, 16])
    _assert_spmm(dev, *_spmm_case(dev, rng, 300, 15, 400, d, f, offset=1,
                                  dtypes=(torch.bfloat16, torch.bfloat16)),
                 "mean", via)


def _attention_case(dev, rng, B, Sq, Skv, H, KV, hd, dtype):
    q, k, v = _on(dev, *(rng.normal(size=(B, S, h, hd)).astype(np.float32)
                         for S, h in ((Sq, H), (Skv, KV), (Skv, KV))))
    return q.to(dtype), k.to(dtype), v.to(dtype)


def _assert_attention_close(out, q, k, v, window, q_offset):
    """Within 1e-5 * (P @ |V|) of the float32 oracle, plus one rounding
    of the output (2^-8 * |out|) in bfloat16."""
    want = ref.attention_ref(q.float(), k.float(), v.float(), window=window,
                             q_offset=q_offset)
    weight = ref.attention_ref(q.float(), k.float(), v.float().abs(),
                               window=window, q_offset=q_offset)
    torch.cuda.synchronize()
    assert out.dtype == q.dtype and out.shape == q.shape
    tol = 1e-5 * weight
    if q.dtype == torch.bfloat16:
        tol = tol + 2.0 ** -8 * want.abs()
    assert ((out.float() - want).abs() <= tol).all()


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,window,q_offset", [
    (2, 200, 200, 6, 3, 24, 0, 0), (1, 130, 130, 4, 4, 128, 32, 0),
    (2, 1, 300, 8, 2, 64, 0, 299), (1, 70, 100, 2, 1, 256, 40, 30),
    (1, 64, 64, 2, 2, 33, 0, 0),
    # 2 query rows a KV head (the split path's threshold), then 3 and 4
    (1, 2, 400, 2, 2, 64, 0, 398), (1, 3, 400, 2, 2, 64, 0, 397),
    (1, 2, 400, 4, 2, 64, 0, 398),
    # StarCoder2's G = 9 (36 heads over 4): 9 query rows a KV head at a
    # decode step, over SPLIT_NQ's 8; its window past the prompt; prefill
    (2, 1, 700, 36, 4, 128, 0, 699), (1, 1, 5000, 36, 4, 128, 4096, 4999),
    (1, 300, 300, 36, 4, 128, 0, 0), (1, 200, 200, 36, 4, 128, 64, 0)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_matches_plain(dev, rng, B, Sq, Skv, H, KV, hd,
                                       window, q_offset, dtype):
    """GQA, windows that skip whole KV tiles, a decode step, the widest
    head (256) and a head width off the kernel's padding; ragged query and
    key counts; both sides of the split path's threshold.  The tile path
    launches once, the split path twice (partials, combine)."""
    q, k, v = _attention_case(dev, rng, B, Sq, Skv, H, KV, hd, dtype)
    n0 = K.launch_counts()["flash_attention"]
    out = ops.flash_attention(q, k, v, window=window, q_offset=q_offset)
    body = flash_attention.path(B, Sq, Skv, H, KV, hd, dtype)
    assert K.launch_counts()["flash_attention"] - n0 \
        == (1 if body == "tile" else 2)
    _assert_attention_close(out, q, k, v, window, q_offset)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,window,q_offset,chunk", [
    (2, 1, 5000, 8, 4, 128, 0, 4999, None),   # GQA decode, G = 2; the
    #                                           last chunk ragged
    (2, 1, 3000, 4, 2, 64, 700, 2999, None),  # decode under a window
    (3, 1, 700, 32, 2, 256, 0, 699, None),    # G = 16: two row groups
    (1, 4, 600, 4, 2, 128, 3, 500, 2),        # chunks some rows see not
    (1, 8, 300, 1, 1, 33, 5, 200, 8),         # element-wise loads
    (2, 2, 90, 2, 1, 32, 0, 60, 16)])         # an offset, G = 2
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_split_matches_plain(dev, rng, B, Sq, Skv, H, KV, hd,
                                             window, q_offset, chunk, dtype):
    """The split body at its own edges (chunks of the plan, or of
    ``chunk`` keys; 1 to 16 query rows a KV head), two launches each, and
    its plain version ``split_plain`` within the same tolerance."""
    q, k, v = _attention_case(dev, rng, B, Sq, Skv, H, KV, hd, dtype)
    n0 = K.launch_counts()["flash_attention"]
    out = flash_attention.flash_attention(q, k, v, window=window,
                                          q_offset=q_offset, via="split",
                                          chunk=chunk)
    assert K.launch_counts()["flash_attention"] - n0 == 2
    _assert_attention_close(out, q, k, v, window, q_offset)
    plain = flash_attention.split_plain(q, k, v, window=window,
                                        q_offset=q_offset, chunk=chunk)
    _assert_attention_close(plain, q, k, v, window, q_offset)


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,window,q_offset", [
    (1, 64, 500, 4, 2, 64, 100, 300), (2, 3, 200, 2, 2, 128, 0, 197),
    (1, 17, 40, 3, 1, 48, 9, 23),
    # G = 9: 9 and 45 query rows a KV head
    (1, 1, 900, 36, 4, 128, 0, 899), (1, 5, 300, 36, 4, 64, 100, 295)])
@pytest.mark.parametrize("via", ["tile", "split"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bodies_agree(dev, rng, B, Sq, Skv, H, KV, hd,
                                      window, q_offset, via, dtype):
    """Each body also holds at shapes the other one takes."""
    q, k, v = _attention_case(dev, rng, B, Sq, Skv, H, KV, hd, dtype)
    n0 = K.launch_counts()["flash_attention"]
    out = flash_attention.flash_attention(q, k, v, window=window,
                                          q_offset=q_offset, via=via)
    assert K.launch_counts()["flash_attention"] - n0 \
        == (1 if via == "tile" else 2)
    _assert_attention_close(out, q, k, v, window, q_offset)


def test_flash_attention_bodies_fit_without_spills(dev):
    """The card's own count for every compiled body of
    flash_attention.cu: no spill to local memory, at most 255 registers."""
    attrs = flash_attention.body_attributes()
    assert list(attrs) == flash_attention.BODIES
    for name, (regs, local) in attrs.items():
        assert local == 0, (name, local)
        assert regs <= 255, (name, regs)


def test_flash_attention_rejects_mixed_types(dev):
    q = torch.zeros((1, 8, 2, 16), device=dev)
    with pytest.raises(ValueError, match="^k:"):
        ops.flash_attention(q, q.bfloat16(), q.bfloat16())
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.flash_attention(q.half(), q.half(), q.half())


# ----------------------------------------------------------------------
# flash_attention's gradient (csrc/flash_attention_bwd.cu)
# ----------------------------------------------------------------------

def _assert_grads_close(got, q, k, v, dout, window, q_offset):
    """Each of dq, dk, dv within 1e-4 of its largest |g| in the plain
    version on the widened inputs (float32 on the card: both sum over up
    to thousands of keys, in other orders; a dropped mask or scale moves
    the result by the order of the largest |g|), plus one rounding of the
    output (2^-8 * |g|) in bfloat16."""
    want = flash_attention.flash_attention_bwd_plain(
        q.float(), k.float(), v.float(), dout.float(), window=window,
        q_offset=q_offset)
    torch.cuda.synchronize()
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == x.dtype and g.shape == x.shape
        tol = 1e-4 * w.abs().max()
        if x.dtype == torch.bfloat16:
            tol = tol + 2.0 ** -8 * w.abs()
        assert ((g.float() - w).abs() <= tol).all()


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,window,q_offset", [
    (2, 130, 130, 4, 4, 32, 0, 0), (1, 100, 100, 6, 3, 64, 0, 0),
    (1, 200, 200, 4, 2, 128, 48, 0), (1, 70, 100, 2, 1, 256, 40, 30),
    (1, 64, 64, 2, 2, 33, 0, 0), (2, 1, 77, 4, 2, 64, 0, 76),
    # Skv > Sq: with q_offset, and keys past every query (dk = dv = 0)
    (1, 65, 300, 4, 4, 128, 0, 235), (1, 40, 200, 2, 2, 64, 0, 10),
    # StarCoder2's G = 9 (36 heads over 4); under a window at an offset
    (1, 150, 150, 36, 4, 128, 0, 0), (1, 90, 300, 18, 2, 128, 64, 210)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_matches_plain(dev, rng, B, Sq, Skv, H, KV, hd,
                                           window, q_offset, dtype):
    """The backward kernel over its edges: head widths 32-256 and one off
    the padding, G 1-9, windows that skip whole tiles, ragged query and
    key counts, Skv > Sq with q_offset; two launches (dq, then dk and
    dv), each counted."""
    q, k, v = _attention_case(dev, rng, B, Sq, Skv, H, KV, hd, dtype)
    dout = torch.randn(q.shape, device=dev).to(dtype)
    n0 = K.launch_counts()["flash_attention_bwd"]
    got = flash_attention.flash_attention_bwd(q, k, v, dout, window=window,
                                              q_offset=q_offset)
    assert K.launch_counts()["flash_attention_bwd"] - n0 == 2
    _assert_grads_close(got, q, k, v, dout, window, q_offset)
    if q_offset + Sq < Skv:
        assert not got[1][:, q_offset + Sq:].any()
        assert not got[2][:, q_offset + Sq:].any()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_grad_through_autograd(dev, rng, dtype, monkeypatch):
    """On CUDA tensors that need a gradient, ``flash_attention`` is the
    autograd Function: one tile launch forward, the backward kernel's two
    launches, never the plain version; a repeat is bit for bit (no
    atomics); under no_grad nothing is saved."""
    q, k, v = _attention_case(dev, rng, 2, 150, 150, 8, 2, 64, dtype)
    dout = torch.randn(q.shape, device=dev).to(dtype)

    def plain(*a, **kw):
        raise AssertionError("a CUDA tensor took the plain version")

    monkeypatch.setattr(flash_attention, "flash_attention_bwd_plain", plain)
    monkeypatch.setattr(flash_attention._ref, "attention_ref", plain)
    runs = []
    for _ in range(2):
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        n0 = K.launch_counts()
        out = flash_attention.flash_attention(*leaves, window=40)
        runs.append(torch.autograd.grad(out, leaves, dout))
        n1 = K.launch_counts()
        assert n1["flash_attention"] - n0["flash_attention"] == 1
        assert n1["flash_attention_bwd"] - n0["flash_attention_bwd"] == 2
    for a, b in zip(*runs):
        assert torch.equal(a, b)
    monkeypatch.undo()
    _assert_grads_close(runs[0], q, k, v, dout, 40, 0)
    with torch.no_grad():
        out = flash_attention.flash_attention(q.requires_grad_(), k, v)
    assert out.grad_fn is None


def test_flash_attention_bwd_bodies_fit(dev):
    """The card's own count for every compiled body of
    flash_attention_bwd.cu: at most 255 registers, no spill up to hd =
    128 (the widest bodies keep 128 accumulator registers a thread beside
    a tile's scores), and tensor-core (HMMA) instructions in every dq and
    dkv body, bf16 and float32."""
    attrs = flash_attention.bwd_body_attributes()
    assert list(attrs) == flash_attention.BWD_BODIES
    for name, (regs, local) in attrs.items():
        assert regs <= 255, (name, regs)
        if not name.endswith("hd256"):
            assert local == 0, (name, local)
    hmma = _build.hmma_counts("flash_attention_bwd")
    assert hmma is not None, "cuobjdump not found beside nvcc"
    bodies = [n for k, n in hmma.items()
              if "dq_kernel" in k or "dkv_kernel" in k]
    assert len(bodies) == len(flash_attention.BWD_BODIES), hmma
    assert min(bodies) > 0, hmma


def _bwd_excess(got, ref64):
    """The largest |got - ref| - 2^-8 |ref| for a bf16 output, |got - ref|
    otherwise, over the elements (chip_smoke.py's phase 17 (a))."""
    excess = (got.double() - ref64).abs()
    if got.dtype == torch.bfloat16:
        excess = excess - 2.0 ** -8 * ref64.abs()
    return float(excess.max())


# (Sq, Skv, window, q_offset) over the tiles' edges: 16 rows a warp, 64 a
# CTA, key tiles of 16-64 and query tiles of 16-64
_BWD_EDGES = [
    (15, 15, 0, 0), (16, 16, 0, 0), (17, 17, 0, 0), (63, 63, 0, 0),
    (64, 64, 0, 0), (65, 65, 0, 0), (129, 129, 0, 0),
    # one query row (a decode step); more keys than queries
    (1, 65, 0, 64), (1, 129, 0, 128), (15, 64, 0, 49), (17, 129, 0, 112),
    (63, 65, 0, 2),
    # windows that cut tiles, at an offset too
    (129, 129, 16, 0), (65, 129, 17, 64)]


@pytest.mark.parametrize("Sq,Skv,window,q_offset", _BWD_EDGES)
@pytest.mark.parametrize("hd", [32, 33, 64, 128, 256])
@pytest.mark.parametrize("G", [1, 2, 9])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_bwd_contract(dev, record_property, Sq, Skv, window,
                                      q_offset, hd, G, dtype):
    """The backward kernel's contract (chip_smoke.py's phase 17 (a)) at
    small shapes: each of dq, dk, dv within twice the largest error of the
    float32 plain version on the card against the float64 autograd of
    ``ref.attention_ref``, plus one rounding of a bf16 output; B = 2 and 4
    to 18 heads.  Both largest errors are taken over 4 draws of the shape
    (the first is the case's own seed), as over one larger case: over the
    few hundred elements of one decode-row draw the largest error of a
    float32 run is not a stable measure.  The first draw's own ratios are
    recorded beside the pooled ones."""
    KV = 4 if G == 1 else 2
    kw = dict(window=window, q_offset=q_offset)
    excess, err_plain, first = [0.0] * 3, [0.0] * 3, None
    for draw in range(4):
        rng = np.random.default_rng([Sq, Skv, window, hd, G] +
                                    ([draw] if draw else []))
        q, k, v = _attention_case(dev, rng, 2, Sq, Skv, KV * G, KV, hd,
                                  dtype)
        dout, = _on(dev, rng.normal(size=q.shape).astype(np.float32))
        dout = dout.to(dtype)
        leaves = [t.double().requires_grad_() for t in (q, k, v)]
        ref64 = torch.autograd.grad(ref.attention_ref(*leaves, **kw),
                                    leaves, dout.double())
        plain = flash_attention.flash_attention_bwd_plain(
            *(t.float() for t in (q, k, v, dout)), **kw)
        got = flash_attention.flash_attention_bwd(q, k, v, dout, **kw)
        torch.cuda.synchronize()
        for i, (g, r, p) in enumerate(zip(got, ref64, plain)):
            assert torch.isfinite(g).all()
            excess[i] = max(excess[i], _bwd_excess(g, r))
            err_plain[i] = max(err_plain[i],
                               float((p.double() - r).abs().max()))
        if draw == 0:
            first = [e / (2 * p) for e, p in zip(excess, err_plain)]
    ratios = [e / (2 * p) for e, p in zip(excess, err_plain)]
    record_property("err_over_tol", ratios)
    record_property("first_draw_err_over_tol", first)
    assert max(ratios) <= 1, (ratios, err_plain)


@pytest.mark.parametrize("arch", ["olmo-1b", "starcoder2-7b", "gemma3-27b",
                                  "olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_transformer_train_grads_kernel_path(dev, arch):
    """A reduced-width model's gradient tree on the kernel path
    (flash_attention's tile body forward and under remat again, the
    backward kernel twice a layer) and each token's loss against the
    float32 plain run (TF32 off): no further than twice the bf16 plain
    path's, in global relative error (the mean loss alone, one scalar,
    can sit near the reference by chance)."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params
    from repro_torch.optim.tree import tree_leaves
    from repro_torch.train.trainer import _grads_of

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    tree = init_params(T.schema(cfg), gen, dev)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 47), generator=gen,
                                     device=dev)}

    def run(c, backend):
        n0 = K.launch_counts()
        g, _ = _grads_of(lambda p, b: T.loss_fn(p, c, b,
                                                kernel_backend=backend),
                         tree, batch)
        torch.cuda.synchronize()
        n1 = K.launch_counts()
        with torch.no_grad():
            toks = batch["tokens"]
            logits = T.train_forward(tree, c, toks[:, :-1],
                                     kernel_backend=backend)[0].float()
            nll = torch.logsumexp(logits, -1) - torch.gather(
                logits, -1, toks[:, 1:, None])[..., 0]
        return (torch.cat([x.flatten() for x in tree_leaves(g)]), nll,
                {k: n1[k] - n0[k] for k in n1})

    g32, l32, _ = run(dataclasses.replace(cfg, compute_dtype="float32"),
                      "torch")
    gp, lp, none = run(cfg, "torch")
    gk, lk, launches = run(cfg, "auto")
    L = cfg.n_layers
    assert launches["flash_attention"] == 2 * L
    assert launches["flash_attention_bwd"] == 2 * L
    assert not any(none.values())
    assert bool(torch.isfinite(gk).all())
    for k, p, r in ((gk, gp, g32), (lk, lp, l32)):
        err_k, err_p = float((k - r).norm()), float((p - r).norm())
        assert err_k <= 2 * err_p, (err_k, err_p)


# ----------------------------------------------------------------------
# the language models: prefill and decode on flash_attention
# ----------------------------------------------------------------------

def _lm_run(model, cfg, toks, P, backend):
    """Prefill ``toks[:, :P]``, then teacher-forced decode steps to the
    end of ``toks``: float32 logits [steps + 1, B, V] and flash_attention's
    launches in the prefill and in each step."""
    from repro_torch.models import transformer as T

    B, S = toks.shape
    n0 = K.launch_counts()["flash_attention"]
    last, pre = T.prefill(model, cfg, toks[:, :P], kernel_backend=backend)
    launches = [K.launch_counts()["flash_attention"] - n0]
    cache = T.init_cache(cfg, B, S, device=toks.device)
    for name, kv in pre.items():
        for t in ("k", "v"):
            cache[name][t][:, :P] = kv[t]
    logits = [last.float()]
    for pos in range(P, S):
        n0 = K.launch_counts()["flash_attention"]
        x, cache = T.decode_step(model, cfg, cache, toks[:, pos], pos,
                                 kernel_backend=backend)
        launches.append(K.launch_counts()["flash_attention"] - n0)
        logits.append(x.float())
    torch.cuda.synchronize()
    return torch.stack(logits), launches


@pytest.mark.parametrize("arch", ["olmo-1b", "starcoder2-7b", "gemma3-27b",
                                  "olmoe-1b-7b", "kimi-k2-1t-a32b"])
def test_transformer_kernel_path_matches_plain(dev, arch):
    """A reduced-width model (the reduced configs, random weights from a
    seeded generator on the card), a 40-token prompt (past starcoder2's 32
    and gemma3's 16 windows) and 6 decode steps: the kernel path launches
    flash_attention once a layer in the prefill and twice a layer a step,
    and its logits sit no further from the float32 plain run (TF32 off)
    than twice the bf16 plain path's."""
    from repro_torch.configs import get_reduced
    from repro_torch.models import transformer as T
    from repro_torch.models.module import init_params

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_reduced(arch)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = T.Transformer(cfg, init_params(T.schema(cfg), gen, dev))
    toks = torch.randint(0, cfg.vocab, (2, 46), generator=gen, device=dev)
    ref, _ = _lm_run(model, dataclasses.replace(cfg, compute_dtype="float32"),
                     toks, 40, "torch")
    plain, none = _lm_run(model, cfg, toks, 40, "torch")
    kern, launches = _lm_run(model, cfg, toks, 40, "auto")
    L = cfg.n_layers
    assert launches == [L] + [2 * L] * 6 and not any(none)
    assert bool(torch.isfinite(kern).all())
    err_kernel = float((kern - ref).abs().max())
    err_plain = float((plain - ref).abs().max())
    assert err_kernel <= 2 * err_plain, (err_kernel, err_plain)


# ----------------------------------------------------------------------
# serving: the engine's CUDA graphs
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def served():
    """One small graph built on the card, and mutations for a live
    delta (500 adds, a base row in 31 and an add in 7 deleted)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    ds = make_clustered(n=3000, d=32, n_queries=300, seed=4)
    cfg = dataclasses.replace(reduced(), bridge_hubs=64)
    rng = np.random.default_rng(3)
    V = (ds.X[rng.integers(0, 3000, 500)]
         + 0.05 * rng.normal(size=(500, 32))).astype(np.float32)
    graph = Index.build(ds.X, cfg, device="cuda").graph
    return dict(ds=ds, cfg=cfg, V=V, graph=graph)


def _served_index(served, **knobs):
    cfg = dataclasses.replace(served["cfg"], **knobs)
    return Index(served["ds"].X, cfg, graph=served["graph"], device="cuda")


def _mutate(index, V):
    new = index.add(V)
    index.delete(np.arange(0, 3000, 31))
    index.delete(new[::7])


def _padded(Q, bucket):
    Q = torch.from_numpy(Q).cuda()
    return torch.cat([Q, Q[-1:].expand(bucket - Q.shape[0], -1)])


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("visited_mode", ["none", "hash"])
def test_replay_equals_eager(served, visited_mode, quant, stream):
    """Index.search replays the engine's captured graph: its ids and
    dists equal an eager call of the same search bit for bit, in both
    regimes, at the first replay and the next."""
    index = _served_index(served, visited_filter=visited_mode,
                          quantization=quant)
    if stream:
        _mutate(index, served["V"])
    plane = index.plane
    for B in (10, 300):
        kind, bucket = index.regime(B), index.engine.bucket_for(B)
        search = plane.search_stream if stream else plane.search
        want = [t[:B].cpu().numpy() for t in search(
            kind, _padded(served["ds"].Q[:B], bucket), 10)]
        for _ in range(2):
            ids, dists = index.search(served["ds"].Q[:B])
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_array_equal(dists, want[1])
    assert index.stats.compiles == 2 and index.stats.bucket_hits == 2
    assert plane.graph_pool_bytes() > 0


def test_replays_count_the_launches_recorded_at_capture(served):
    """The eager warm-up counts (its kernels ran), the capture does not,
    and each replay adds what the capture recorded."""
    plane = _served_index(served, visited_filter="hash").plane
    K.reset_launch_counts()
    exe = plane.compile("large", 32, 10)
    torch.cuda.synchronize()
    warm = K.launch_counts()
    assert {k: v for k, v in warm.items() if v} == exe.launches
    assert all(exe.launches[k] > 0 for k in
               ("gather_distances", "rank_merge", "visited_filter"))
    Q = torch.zeros((32, 32), device="cuda")
    exe(Q)
    exe(Q)
    torch.cuda.synchronize()
    assert K.launch_counts() == {
        k: v + 2 * exe.launches.get(k, 0) for k, v in warm.items()}


def test_same_shape_rebind_keeps_the_graphs(served):
    """A generation of the same shapes is copied into the captured
    buffers: the old graphs answer as a fresh eager search of it."""
    from repro_torch.ann import build_graph

    ds, cfg = served["ds"], served["cfg"]
    index = _served_index(served)
    plane = index.plane
    exes = {kind: plane.compile(kind, 32, 10) for kind in ("small", "large")}
    X2 = ds.X[::-1].copy()
    g2 = build_graph(X2, cfg, device="cuda")
    token = plane.shape_token()
    plane.rebind(X2, g2)
    assert plane.shape_token() == token
    fresh = Index(X2, cfg, graph=g2, device="cuda").plane
    Q = _padded(ds.Q[:32], 32)
    for kind, exe in exes.items():
        got = [t.cpu() for t in exe(Q)]
        want = [t.cpu() for t in fresh.search(kind, Q, 10)]
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_replay_after_a_shape_change_raises_stale_generation(served):
    """A graph bound to freed buffers never replays: StaleGeneration; the
    engine prunes it after a compaction and captures anew."""
    from repro_torch.ann import build_graph
    from repro_torch.serve.plane import StaleGeneration

    ds, cfg = served["ds"], served["cfg"]
    index = _served_index(served)
    plane = index.plane
    exe = plane.compile("small", 32, 10)
    X3 = ds.X[:2000]
    plane.rebind(X3, build_graph(X3, cfg, device="cuda"))
    with pytest.raises(StaleGeneration):
        exe(_padded(ds.Q[:32], 32))
    index = _served_index(served)
    index.search(ds.Q[:10])
    index.add(served["V"][:4])
    index.delete([5, 6])
    index.search(ds.Q[:10])
    assert len(index.engine._compiled) == 2
    id_map = index.compact()
    assert index.engine._compiled == {}
    assert int((id_map >= 0).sum()) == index.X.shape[0] == 3002
    ids, dists = index.search(ds.Q[:10])
    assert index.stats.compiles == 3
    kind, bucket = index.regime(10), index.engine.bucket_for(10)
    want = [t[:10].cpu().numpy() for t in index.plane.search(
        kind, _padded(ds.Q[:10], bucket), 10)]
    np.testing.assert_array_equal(ids, want[0])
    np.testing.assert_array_equal(dists, want[1])


def test_staging_reuses_its_pinned_buffer(served):
    plane = _served_index(served).plane
    Qh = served["ds"].Q[:8]
    a = plane.stage_query(Qh)
    buf = plane._stage_bufs[((8, 32), "float32")]
    b = plane.stage_query(Qh[::-1].copy())
    assert buf.is_pinned() and plane._stage_bufs[((8, 32), "float32")] is buf
    assert plane.stage_reuses == 1
    assert a.is_cuda and torch.equal(a.cpu(), torch.from_numpy(Qh))
    assert torch.equal(b.cpu(), torch.from_numpy(Qh[::-1].copy()))


# ----------------------------------------------------------------------
# the locality-packed layout and the artifact
# ----------------------------------------------------------------------

PACKED_PIPE = ("knn", "diversify", "bridges", "layout")


@pytest.fixture(scope="module")
def packed(served):
    """The served graph in the locality-packed order."""
    from repro_torch.ann import layout
    from repro_torch.ann.convert import graph_from_numpy

    g = served["graph"]
    arrays = [t.cpu().numpy() for t in (g.neighbors, g.lambdas, g.degrees,
                                        g.hubs)]
    perm = layout.locality_order(arrays[0], starts=arrays[3])
    _, *laid = layout.apply_layout(perm, served["ds"].X, *arrays)
    return graph_from_numpy(*laid, perm, device="cuda")


def _packed_index(served, packed, **knobs):
    cfg = dataclasses.replace(served["cfg"], build_pipeline=PACKED_PIPE,
                              **knobs)
    return Index(served["ds"].X, cfg, graph=packed, device="cuda")


def _same_bits(a, b):
    assert torch.equal(a[0], b[0])
    assert torch.equal(a[1].view(torch.int32), b[1].view(torch.int32))


@pytest.mark.parametrize("quant", ["none", "int8"])
@pytest.mark.parametrize("visited_mode", ["none", "hash"])
def test_packed_search_equals_unpacked(served, packed, visited_mode, quant):
    """The kernels on a packed graph answer as on the unpacked one, bit
    for bit, in both regimes (eager calls of each procedure)."""
    knobs = dict(visited_filter=visited_mode, quantization=quant)
    u = _served_index(served, **knobs).plane
    p = _packed_index(served, packed, **knobs).plane
    K.reset_launch_counts()
    for B in (10, 300):
        Q = _padded(served["ds"].Q[:B], B)
        for kind in ("small", "large"):
            _same_bits(u.search(kind, Q, 10), p.search(kind, Q, 10))
    gather = "gather_distances" + ("_int8" if quant == "int8" else "")
    assert K.launch_counts()[gather] > 0


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_packed_replay_equals_eager(served, packed, quant):
    index = _packed_index(served, packed, visited_filter="hash",
                          quantization=quant)
    _mutate(index, served["V"])
    plane = index.plane
    for B in (10, 300):
        kind, bucket = index.regime(B), index.engine.bucket_for(B)
        want = [t[:B].cpu().numpy() for t in plane.search_stream(
            kind, _padded(served["ds"].Q[:B], bucket), 10)]
        for _ in range(2):
            ids, dists = index.search(served["ds"].Q[:B])
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_array_equal(dists, want[1])
        assert not np.isin(ids, np.arange(0, 3000, 31)).any()
    assert index.stats.compiles == 2 and index.stats.bucket_hits == 2


def test_same_shape_packed_rebind_keeps_the_graphs(served, packed):
    """A packed generation of the same shapes copies its corpus, graph
    and perm into the captured buffers: the old graphs answer as a fresh
    eager search of it."""
    from repro_torch.ann import build_graph

    ds = served["ds"]
    index = _packed_index(served, packed)
    plane = index.plane
    perm_buf = plane.graph.perm
    exes = {kind: plane.compile(kind, 32, 10) for kind in ("small", "large")}
    X2 = ds.X[::-1].copy()
    g2 = build_graph(X2, index.cfg, device="cuda")
    token = plane.shape_token()
    plane.rebind(X2, g2)
    assert plane.shape_token() == token and plane.graph.perm is perm_buf
    assert torch.equal(perm_buf, g2.perm)
    fresh = Index(X2, index.cfg, graph=g2, device="cuda").plane
    Q = _padded(ds.Q[:32], 32)
    for kind, exe in exes.items():
        _same_bits([t.clone() for t in exe(Q)], fresh.search(kind, Q, 10))


def test_save_load_on_the_card_is_bitwise(served, packed, tmp_path):
    index = _packed_index(served, packed, visited_filter="hash",
                          quantization="int8")
    _mutate(index, served["V"])
    want = {B: index.search(served["ds"].Q[:B]) for B in (10, 300)}
    index.save(tmp_path / "idx")
    back = Index.load(tmp_path / "idx")
    assert back.device.type == "cuda" and back.graph.perm is not None
    assert back.engine.stream.delta.count == index.engine.stream.delta.count
    assert torch.equal(back.plane.codes, index.plane.codes)
    for B, (ids, dists) in want.items():
        got = back.search(served["ds"].Q[:B])
        np.testing.assert_array_equal(got[0], ids)
        np.testing.assert_array_equal(got[1], dists)


# ----------------------------------------------------------------------
# the shard grid and the router
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def mesh_parts(served):
    """The served corpus built on a (2, 2) grid: its operands, which every
    mesh test below re-binds (no rebuild)."""
    from repro_torch.core import distributed as D

    mesh = D.make_mesh((2, 2), ("data", "model"))
    built = D.make_build_fn(mesh, served["cfg"])(served["ds"].X)
    X = torch.from_numpy(served["ds"].X).cuda()
    return mesh, (X, *built)


def _mesh_index(served, mesh_parts, **knobs):
    from repro_torch.serve.plane import MeshPlane

    mesh, parts = mesh_parts
    cfg = dataclasses.replace(served["cfg"], **knobs)
    return Index(None, cfg, plane=MeshPlane(None, cfg, mesh, parts=parts))


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("knobs", [dict(), dict(quantization="int8"),
                                   dict(db_bf16=True)],
                         ids=["fp32", "int8", "bf16"])
def test_mesh_replay_equals_eager(served, mesh_parts, knobs, stream):
    """A (2, 2) grid's search is one captured graph over every cell's
    launches: its replay equals an eager call bit for bit, in both
    regimes, frozen and with a stream; deleted ids never answer; a bf16
    database launches the bf16 row body."""
    index = _mesh_index(served, mesh_parts, visited_filter="hash", **knobs)
    if stream:
        _mutate(index, served["V"])
    plane = index.plane
    K.reset_launch_counts()
    for B in (10, 300):
        kind, bucket = index.regime(B), index.engine.bucket_for(B)
        search = plane.search_stream if stream else plane.search
        want = [t[:B].cpu().numpy() for t in search(
            kind, _padded(served["ds"].Q[:B], bucket), 10)]
        for _ in range(2):
            ids, dists = index.search(served["ds"].Q[:B])
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_array_equal(dists, want[1])
        if stream:
            assert not np.isin(ids, np.arange(0, 3000, 31)).any()
    assert index.stats.compiles == 2 and index.stats.bucket_hits == 2
    body = {"fp32": "gather_distances", "int8": "gather_distances_int8",
            "bf16": "gather_distances_bf16"}[
        "int8" if knobs.get("quantization") else
        "bf16" if knobs.get("db_bf16") else "fp32"]
    assert K.launch_counts()[body] > 0
    assert plane.graph_pool_bytes() > 0


def test_sharded_router_equals_mesh_on_the_card(served, mesh_parts):
    """Index.serve(router="sharded:2") on the card answers as a (2, 1)
    grid over the same corpus, bit for bit, both regimes."""
    from repro_torch.core import distributed as D

    cfg, ds = served["cfg"], served["ds"]
    mi = Index.build(ds.X, cfg, mesh=D.make_mesh((2, 1), ("data", "model")))
    single = _served_index(served)
    with single.serve(router="sharded:2") as r:
        for B in (10, 300):
            ids, dists = r.query(ds.Q[:B])
            want = mi.search(ds.Q[:B])
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_array_equal(dists, want[1])


@pytest.mark.parametrize("stream", [False, True])
@pytest.mark.parametrize("quant", ["none", "int8"])
def test_pod_replay_equals_eager_on_the_card(served, mesh_parts, quant,
                                             stream):
    """A 1-rank pod (no process group) over the grid's two DB shards: its
    search is two captured graphs around the exchange, and a replay
    equals an eager call and the (2, 1) grid's replay bit for bit, in
    both regimes, frozen and with a stream; a repeated bucket captures
    nothing."""
    from repro_torch.core import distributed as D
    from repro_torch.serve.plane import MeshPlane
    from repro_torch.serve.pod import PodPlane

    _, parts = mesh_parts
    mesh = D.make_mesh((2, 1), ("data", "model"))
    cfg = dataclasses.replace(served["cfg"], quantization=quant)
    pod = Index(None, cfg, plane=PodPlane(None, cfg, mesh, parts=parts))
    grid = Index(None, cfg, plane=MeshPlane(None, cfg, mesh, parts=parts))
    if stream:
        _mutate(pod, served["V"])
        _mutate(grid, served["V"])
    plane = pod.plane
    for B in (10, 300):
        kind, bucket = pod.regime(B), pod.engine.bucket_for(B)
        search = plane.search_stream if stream else plane.search
        want = [t[:B].cpu().numpy() for t in search(
            kind, _padded(served["ds"].Q[:B], bucket), 10)]
        for _ in range(2):
            ids, dists = pod.search(served["ds"].Q[:B])
            np.testing.assert_array_equal(ids, want[0])
            np.testing.assert_array_equal(dists, want[1])
        g = grid.search(served["ds"].Q[:B])
        np.testing.assert_array_equal(ids, g[0])
        np.testing.assert_array_equal(dists, g[1])
    assert pod.stats.compiles == 2 and pod.stats.bucket_hits == 2


# ----------------------------------------------------------------------
# the graph family: GraphSAGE's neighbour mean on packed_spmm
# ----------------------------------------------------------------------

def _sage(dev, full=False):
    """GraphSAGE (reduced, or graphsage_reddit's widths) with every leaf
    drawn from a seeded generator on the card (biases non-zero), and a
    ``SampledStream`` batch (16 seeds, fanout (15, 10)) of a community
    graph, on the card."""
    from repro_torch.configs import get_arch, get_reduced
    from repro_torch.data.graphs import make_community_graph
    from repro_torch.data.sampler import SampledStream
    from repro_torch.models import gnn as G

    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = (get_arch if full else get_reduced)("graphsage-reddit")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    model = G.GNN(cfg, _init_all(G.schema(cfg, 24, 6), gen, dev))
    graph = make_community_graph(3000, 30000, 24, n_classes=6, seed=1)
    batch = G.batch_to(next(SampledStream(graph, 16, (15, 10), seed=2)),
                       dev)
    return cfg, model, batch


def _init_all(sch, gen, dev):
    """``init_params`` with every leaf, the zero-init ones too, drawn at
    std 0.1 or the leaf's own."""
    from repro_torch.models.module import init_params, leaves, std

    tree = init_params(sch, gen, dev)
    for path, spec in leaves(sch):
        node = tree
        *parents, name = path.split(".")
        for key in parents:
            node = node[key]
        if std(spec) == 0:
            node[name] = 0.1 * torch.randn(spec.shape, generator=gen,
                                           device=dev)
    return tree


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("aggregator", ["mean", "sum"])
def test_graphsage_kernel_path_matches_plain(dev, full, aggregator):
    """The kernel path launches ``packed_spmm`` once a layer ("fused" at
    d = f) and its logits are within 1e-5 of the largest |logit| of the
    plain path's (``kernel_backend="torch"``) and of the edge list's."""
    from repro_torch.kernels import segment_matmul as sm
    from repro_torch.models import gnn as G

    cfg, model, batch = _sage(dev, full)
    cfg = dataclasses.replace(cfg, aggregator=aggregator)
    N, M = batch["neighbors"].shape
    d = cfg.d_hidden
    assert sm.path(N, M, N, d, d) == "fused"
    n0 = K.launch_counts()["packed_spmm"]
    out = G.forward(model, cfg, batch)
    torch.cuda.synchronize()
    assert K.launch_counts()["packed_spmm"] - n0 == cfg.n_layers
    plain = G.forward(model, cfg, batch, kernel_backend="torch")
    edge = G.forward(model, cfg, {k: v for k, v in batch.items()
                                  if k != "neighbors"})
    assert K.launch_counts()["packed_spmm"] - n0 == cfg.n_layers
    scale = float(plain.abs().max())
    assert bool(torch.isfinite(out).all())
    assert float((out - plain).abs().max()) <= 1e-5 * scale
    assert float((out - edge).abs().max()) <= 1e-5 * scale


def test_graphsage_kernel_route_repeats_bitwise(dev):
    """Each output row owns its lanes (no atomics), so the kernel path
    gives the same bits on every call."""
    from repro_torch.models import gnn as G

    cfg, model, batch = _sage(dev, True)
    first = G.forward(model, cfg, batch)
    for _ in range(3):
        assert torch.equal(G.forward(model, cfg, batch), first)


@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_packed_spmm_sentinel_rows_give_zero(dev, combine):
    """Rows whose lanes are all the sentinel (a sampled subgraph's last
    layer) give exactly 0, the reference's s / max(cnt, 1), on both
    routes."""
    from repro_torch.data.sampler import fanout_neighbors

    nbrs = torch.from_numpy(fanout_neighbors(16, (15, 10))).to(dev)
    N = nbrs.shape[0]
    gen = torch.Generator(device=dev)
    gen.manual_seed(3)
    h = torch.randn((N, 128), generator=gen, device=dev)
    w = torch.randn((128, 128), generator=gen, device=dev)
    empty = (nbrs == N).all(1)
    assert int(empty.sum()) == N - 16 - 16 * 15
    for via in segment_matmul.ROUTES:
        out = segment_matmul.packed_spmm(nbrs, h, w, combine=combine,
                                         via=via)
        assert bool((out[empty] == 0).all()), via
        assert bool((out[~empty] != 0).any()), via


# ----------------------------------------------------------------------
# the gradients of packed_spmm and embedding_bag
# ----------------------------------------------------------------------

def _spmm_bwd_tols(nbrs, feat, w, dout, combine):
    """1e-5 of the magnitudes of dfeat's and dw's terms: the plain
    version on |feat|, |w| and |dout|."""
    return [1e-5 * t for t in segment_matmul.packed_spmm_bwd_plain(
        nbrs, feat.abs(), w.abs(), dout.abs(), combine=combine)]


def _assert_spmm_bwd(dev, rng, nbrs, feat, w, combine, offset=0):
    """The backward within the tolerances of its plain version, 5 entries
    counted a call (its own plan, projection, grouped sum, agg, dW), rows
    no lane reads exactly 0, and a repeat bit for bit."""
    N, f = nbrs.shape[0], w.shape[1]
    d_np = rng.normal(size=(N, f)).astype(np.float32)
    dout = torch.from_numpy(np.concatenate(
        [np.zeros(offset, np.float32), d_np.ravel()])).to(dev)[offset:]
    dout = dout.view(N, f)
    n0 = K.launch_counts()["packed_spmm_bwd"]
    got = segment_matmul.packed_spmm_bwd(nbrs, feat, w, dout,
                                         combine=combine)
    again = segment_matmul.packed_spmm_bwd(nbrs, feat, w, dout,
                                           combine=combine)
    want = segment_matmul.packed_spmm_bwd_plain(nbrs, feat, w, dout,
                                                combine=combine)
    torch.cuda.synchronize()
    assert K.launch_counts()["packed_spmm_bwd"] - n0 == 10
    for g, a, p, tol in zip(got, again, want,
                            _spmm_bwd_tols(nbrs, feat, w, dout, combine)):
        assert g.dtype == torch.float32 and g.shape == p.shape
        assert torch.equal(g, a)
        assert bool(torch.isfinite(g).all())
        assert ((g - p).abs() <= tol).all(), float((g - p).abs().max())
    Nf = feat.shape[0]
    read = torch.zeros(Nf, dtype=torch.bool, device=dev)
    ok = nbrs < Nf
    read[nbrs.long().clamp(min=0)[ok]] = True
    assert (got[0][~read] == 0).all()


@pytest.mark.parametrize("N,M,Nf", [(1, 15, 50), (129, 1, 40),
                                    (129, 20, 1000), (300, 15, 90),
                                    (300, 20, 2000)])
@pytest.mark.parametrize("d", [8, 70, 128, 602])
@pytest.mark.parametrize("f", [8, 70, 128, 602])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_packed_spmm_bwd_matches_plain(dev, N, M, Nf, d, f, combine):
    """The backward kernel (segment_matmul_bwd.cu with the projection and
    the gather of segment_matmul.cu) over its edges: sentinels, negative
    ids (row 0), an all-sentinel row, Nf below and above N, d and f in
    one dW tile or many, M from 1 to 20."""
    rng = np.random.default_rng([N, M, Nf, d, f, 7])
    nbrs, feat, w = _spmm_case(dev, rng, N, M, Nf, d, f)
    _assert_spmm_bwd(dev, rng, nbrs, feat, w, combine)


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("case", ["empty", "hot", "offset"])
def test_packed_spmm_bwd_edges(dev, combine, case):
    """Every row empty (dfeat all zeros, dW zeros); one feat row read by
    every lane of 4,000 rows (a run of 60,000 equal keys in the sort);
    operands one element off their allocation."""
    rng = np.random.default_rng(11)
    if case == "offset":
        nbrs, feat, w = _spmm_case(dev, rng, 300, 15, 400, 70, 33, offset=1)
        _assert_spmm_bwd(dev, rng, nbrs, feat, w, combine, offset=1)
        return
    N, M, Nf = (300, 7, 90) if case == "empty" else (4000, 15, 500)
    nbrs, feat, w = _spmm_case(dev, rng, N, M, Nf, 64, 32)
    nbrs.fill_(Nf if case == "empty" else 3)
    _assert_spmm_bwd(dev, rng, nbrs, feat, w, combine)


def test_packed_spmm_autograd_on_the_card(dev, rng, monkeypatch):
    """Through autograd on CUDA tensors: one fused launch forward, the
    backward's 4 and its own plan's 1 (with a plan given and built, 4),
    the gradients equal to packed_spmm_bwd's bit for bit with the plain
    version patched to raise; a plan of another matrix raises; under
    no_grad nothing is recorded."""
    nbrs, feat, w = _spmm_case(dev, rng, 200, 10, 300, 128, 128)
    dout = torch.randn((200, 128), device=dev)
    monkeypatch.setattr(segment_matmul, "packed_spmm_bwd_plain",
                        lambda *a, **k: (_ for _ in ()).throw(
                            AssertionError("plain path taken")))
    leaves = [feat.clone().requires_grad_(), w.clone().requires_grad_()]
    n0 = K.launch_counts()
    out = segment_matmul.packed_spmm(nbrs, *leaves, combine="mean")
    got = torch.autograd.grad(out, leaves, dout)
    n1 = K.launch_counts()
    assert n1["packed_spmm"] - n0["packed_spmm"] == 1
    assert n1["packed_spmm_bwd"] - n0["packed_spmm_bwd"] == 5
    want = segment_matmul.packed_spmm_bwd(nbrs, feat, w, dout,
                                          combine="mean")
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    plan = segment_matmul.SpmmPlan(nbrs, 300).build()
    n0 = K.launch_counts()
    out = segment_matmul.packed_spmm(nbrs, *leaves, combine="mean",
                                     plan=plan)
    again = torch.autograd.grad(out, leaves, dout)
    n1 = K.launch_counts()
    assert n1["packed_spmm_bwd"] - n0["packed_spmm_bwd"] == 4
    assert all(torch.equal(a, b) for a, b in zip(again, want))
    with pytest.raises(ValueError, match="another"):
        segment_matmul.packed_spmm_bwd(nbrs.clone(), feat, w, dout,
                                       plan=plan)
    with torch.no_grad():
        assert segment_matmul.packed_spmm(nbrs, *leaves).grad_fn is None
    with pytest.raises(ValueError, match="float32"):
        segment_matmul.packed_spmm_bwd(nbrs, feat.bfloat16(), w, dout)


def test_spmm_bwd_bodies_fit_without_spills(dev):
    attrs = segment_matmul.bwd_body_attributes()
    assert list(attrs) == segment_matmul.BWD_BODIES
    for name, (regs, local) in attrs.items():
        assert local == 0, (name, local)
        assert regs <= 255, (name, regs)


def _targets_on(dev, case):
    """A case of the CPU grouping tests: (targets [N, M] int64 on the CPU,
    -1 for none, rows R)."""
    from test_torch_lane_groups import _targets

    t, R = _targets(case)
    return torch.from_numpy(t), R


LANE_CASES = ["uniform", "zipf", "hot", "past_2^16", "all_invalid",
              "no_lanes", "no_rows", "rows_far_above_lanes", "one_row",
              "31_bits", "negative_ids"]


@pytest.mark.parametrize("case", LANE_CASES)
def test_spmm_plan_matches_plain(dev, case):
    """The plan built on the card (compaction, radix sort, runs) holds the
    integers of ``lane_groups_plain`` exactly: uniform and Zipf-skewed
    rows, one hot row in every row of lanes, one row read by 70,714
    lanes, every lane a sentinel, M = 0 and N = 0, Nf = 10^7 over 1,500
    lanes, Nf = 1, Nf = 2^31 - 1 (4 passes), negative ids (row 0); its
    rank inverts active; one entry counted."""
    from repro_torch.kernels.lane_groups import lane_groups_plain

    t, R = _targets_on(dev, "uniform" if case == "negative_ids" else case)
    nbrs = torch.where(t >= 0, t, R).to(torch.int32)
    if case == "negative_ids":
        nbrs = torch.where(t % 3 == 0, -1 - t % 5, nbrs).to(torch.int32)
    plan = segment_matmul.SpmmPlan(nbrs.to(dev), R)
    n0 = K.launch_counts()["packed_spmm_bwd"]
    got = plan.integers()
    assert K.launch_counts()["packed_spmm_bwd"] - n0 == 1
    want = lane_groups_plain(segment_matmul.SpmmPlan(nbrs, R).targets(), R)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k].cpu(), v), k
    g = plan.groups
    active = got["active"]
    rank = g.rank[:nbrs.shape[0]].long()
    assert torch.equal(rank[active], torch.arange(len(active), device=dev))
    assert int((rank >= 0).sum()) == len(active)
    assert plan.build() is plan and plan.groups is g
    assert K.launch_counts()["packed_spmm_bwd"] - n0 == 1


@pytest.mark.parametrize("case", ["uniform", "zipf", "hot", "past_2^16",
                                  "one_row", "rows_far_above_lanes",
                                  "31_bits"])
def test_bag_groups_match_plain(dev, case):
    """The bag's grouping, sorted straight from the ids (clamped: -1 reads
    row 0), holds ``lane_groups_plain``'s lanes, rows and starts exactly,
    V from 1 to 2^31 - 1."""
    from repro_torch.kernels.lane_groups import lane_groups_plain

    t, V = _targets_on(dev, case)
    ids = t.to(torch.int32)
    got = embedding_bag.bag_groups(ids.to(dev), V).integers()
    want = lane_groups_plain(ids.long().clamp(0, V - 1), V)
    assert sorted(got) == ["lanes", "rows", "starts"]
    for k in got:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.parametrize("B,bag,V,E", [(1, 1, 1, 8), (300, 10, 64, 32),
                                       (5000, 40, 100_000, 70),
                                       (70_000, 10, 1000, 32),
                                       (2000, 10, 10 ** 7, 4)])
def test_embedding_bag_bwd_sum_equals_cpu_plain(dev, B, bag, V, E):
    """With ``combine="sum"`` every term is dout[b] as it is, so the
    kernel's sums from zero in (b, t) order equal the CPU's float32
    ``embedding_bag_bwd_plain`` (``index_add_``, sequential in that
    order) bit for bit: ids repeated, clamped, and hot."""
    rng = np.random.default_rng([B, bag, E])
    ids = rng.integers(-2, min(V, 5000) + 3, size=(B, bag)).astype(np.int32)
    ids[::2, 0] = min(7, V - 1)
    dout = rng.normal(size=(B, E)).astype(np.float32)
    ids_c, dout_c = torch.from_numpy(ids), torch.from_numpy(dout)
    got = embedding_bag.embedding_bag_bwd(ids_c.to(dev), dout_c.to(dev), V,
                                          combine="sum")
    want = embedding_bag.embedding_bag_bwd_plain(ids_c, dout_c, V,
                                                 combine="sum")
    assert want.dtype == torch.float32
    assert torch.equal(got.cpu(), want)


def _assert_bag_bwd(dev, ids, dout, V, combine):
    """The backward within the bag contract (1e-6 of its terms' |sum|) of
    its plain version, one launch counted, rows no lookup reads exactly
    0, a repeat bit for bit."""
    n0 = K.launch_counts()["embedding_bag_bwd"]
    got = embedding_bag.embedding_bag_bwd(ids, dout, V, combine=combine)
    again = embedding_bag.embedding_bag_bwd(ids, dout, V, combine=combine)
    want = embedding_bag.embedding_bag_bwd_plain(ids, dout, V,
                                                 combine=combine)
    tol = 1e-6 * embedding_bag.embedding_bag_bwd_plain(ids, dout.abs(), V,
                                                       combine=combine)
    torch.cuda.synchronize()
    assert K.launch_counts()["embedding_bag_bwd"] - n0 == 2
    assert got.shape == (V, dout.shape[1]) and got.dtype == torch.float32
    assert torch.equal(got, again)
    assert ((got - want).abs() <= tol).all(), float((got - want).abs().max())
    read = torch.zeros(V, dtype=torch.bool, device=dev)
    read[ids.long().clamp(0, V - 1).flatten()] = True
    assert (got[~read] == 0).all()


@pytest.mark.parametrize("E", [8, 32, 70, 300])
@pytest.mark.parametrize("bag", [1, 10, 40])
@pytest.mark.parametrize("B,V", [(1, 50), (300, 64), (5000, 100_000)])
@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_embedding_bag_bwd_matches_plain(dev, E, bag, B, V, combine):
    """The backward kernel (embedding_bag_bwd.cu) over E 8-300, bag 1-40,
    ids repeated in and across bags (V = 64), clamped ids, and one id in
    every bag."""
    rng = np.random.default_rng([E, bag, B, V])
    ids = rng.integers(-2, V + 3, size=(B, bag)).astype(np.int32)
    ids[:, 0] = 5 % V                      # one id in every bag
    dout = rng.normal(size=(B, E)).astype(np.float32)
    ids, dout = _on(dev, ids, dout)
    _assert_bag_bwd(dev, ids, dout, V, combine)


@pytest.mark.parametrize("case", ["hot", "offset"])
def test_embedding_bag_bwd_edges(dev, case):
    """One id in every lookup of 70,000 bags of 10 (a run of 676,666
    equal keys in the sort); dout one element off its allocation."""
    rng = np.random.default_rng(13)
    if case == "hot":
        ids = torch.full((70_000, 10), 7, dtype=torch.int32, device=dev)
        ids[::3, 4] = 9
        dout, = _on(dev, rng.normal(size=(70_000, 32)).astype(np.float32))
        _assert_bag_bwd(dev, ids, dout, 1000, "mean")
        return
    ids, = _on(dev, rng.integers(0, 500, size=(300, 10)).astype(np.int32))
    flat, = _on(dev, rng.normal(size=300 * 33 + 1).astype(np.float32))
    _assert_bag_bwd(dev, ids, flat[1:].view(300, 33), 500, "sum")


def test_embedding_bag_autograd_on_the_card(dev, rng, monkeypatch):
    """Through autograd on a CUDA table that needs a gradient: one forward
    launch, one backward launch, equal bit for bit to embedding_bag_bwd
    with the plain version patched to raise; a bf16 table raises."""
    table, ids = _on(dev, rng.normal(size=(1000, 32)).astype(np.float32),
                     rng.integers(0, 1000, size=(512, 10)).astype(np.int32))
    dout = torch.randn((512, 32), device=dev)
    monkeypatch.setattr(embedding_bag, "embedding_bag_bwd_plain",
                        lambda *a, **k: (_ for _ in ()).throw(
                            AssertionError("plain path taken")))
    leaf = table.clone().requires_grad_()
    n0 = K.launch_counts()
    got, = torch.autograd.grad(embedding_bag.embedding_bag(leaf, ids),
                               leaf, dout)
    n1 = K.launch_counts()
    assert n1["embedding_bag"] - n0["embedding_bag"] == 1
    assert n1["embedding_bag_bwd"] - n0["embedding_bag_bwd"] == 1
    assert torch.equal(got, embedding_bag.embedding_bag_bwd(ids, dout, 1000))
    with pytest.raises(ValueError, match="float32"):
        embedding_bag.embedding_bag(table.bfloat16().requires_grad_(), ids)


def test_bag_bwd_bodies_fit_without_spills(dev):
    attrs = embedding_bag.bwd_body_attributes()
    assert list(attrs) == embedding_bag.BWD_BODIES
    for name, (regs, local) in attrs.items():
        assert local == 0, (name, local)
        assert regs <= 255, (name, regs)


def test_flash_attention_bwd_rows_bodies_fit(dev):
    """The float32 rows bodies (FFMA, few query rows): no spill, at most
    255 registers; bwd_path sends float32 calls of at most 64 rows a KV
    head there and bf16 never."""
    attrs = flash_attention.bwd_rows_attributes()
    assert list(attrs) == flash_attention.BWD_ROWS_BODIES
    for name, (regs, local) in attrs.items():
        assert local == 0 and regs <= 255, (name, regs, local)
    assert flash_attention.bwd_path(1, 9, 1, torch.float32) == "rows"
    assert flash_attention.bwd_path(64, 1, 1, torch.float32) == "rows"
    assert flash_attention.bwd_path(65, 1, 1, torch.float32) == "tile"
    assert flash_attention.bwd_path(1, 1, 1, torch.bfloat16) == "tile"
