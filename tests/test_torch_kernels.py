"""The port's three kernels against the JAX reference, on the CPU.

On the CPU each kernel wrapper takes its plain PyTorch version, so these
tests hold that version — the arithmetic the CUDA kernel is checked against
on the card — to the reference's ``kernel_backend="xla"`` oracle on the same
numpy inputs:

* distances within 1e-6 * (qn + vn) per entry (different summation orders
  round differently; both sides accumulate in float32), INF lanes exact;
* rank merges, hash buckets and visited filters exactly.

The kernels themselves are held to these plain versions on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import hotpath as JHP
from repro.kernels import visited as jvf
from repro_torch import kernels as K
from repro_torch.core import hotpath as HP
from repro_torch.kernels import (block, flash_attention, l2dist, ops, topk,
                                 visited)

# the plain versions are small here: one thread each, so the test
# workers running beside this file keep their cores
torch.set_num_threads(1)

METRICS = ("l2", "ip", "cos")
INF = 3.4e38


@functools.partial(jax.jit, static_argnames=("metric", "self_q"))
def _jnd(Q, X, idx, mask, metric, self_q=False):
    if self_q:
        return JHP.neighbor_distances(None, X, idx, metric=metric, mask=mask,
                                      backend="xla", q_idx=idx)
    return JHP.neighbor_distances(Q, X, idx, metric=metric, mask=mask,
                                  backend="xla")


@functools.partial(jax.jit, static_argnames=("keep",))
def _jrm(dists, ids, mask, keep):
    return JHP.rank_merge(dists, ids, keep=keep, mask=mask, backend="xla")


def _t(a):
    return torch.from_numpy(np.array(a))


def _assert_close_dist(ours, ref, Q3, V, valid):
    """|Δ| <= 1e-6 (qn + vn) on valid lanes, INF lanes bit-equal."""
    ours = np.asarray(ours, np.float64)
    ref = np.asarray(ref, np.float64)
    qn = (Q3.astype(np.float64) ** 2).sum(-1)
    vn = (V.astype(np.float64) ** 2).sum(-1)
    tol = 1e-6 * (qn[:, :, None] + vn[:, None, :])
    v = np.broadcast_to(valid[:, None, :], ours.shape)
    assert (np.abs(ours - ref)[v] <= tol[v]).all()
    assert (ours[~v] == np.float32(INF)).all() and (ref[~v] == ours[~v]).all()


def _case(rng, S, C, d, N=200, kq=None):
    X = rng.normal(size=(N, d)).astype(np.float32)
    Q = rng.normal(size=(S, d) if kq is None else (S, kq, d)) \
        .astype(np.float32)
    idx = rng.integers(-2, N + 20, size=(S, C)).astype(np.int32)
    mask = rng.random((S, C)) > 0.3
    return X, Q, idx, mask


# ----------------------------------------------------------------------
# gather_distances
# ----------------------------------------------------------------------

@pytest.mark.parametrize("S,C,d", [(5, 7, 9), (33, 32, 16), (64, 33, 40),
                                   (40, 24, 128)])
@pytest.mark.parametrize("metric", METRICS)
def test_distances_match_reference(rng, S, C, d, metric):
    X, Q, idx, mask = _case(rng, S, C, d)
    ref = np.asarray(_jnd(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(idx),
                          jnp.asarray(mask), metric))
    ours = HP.neighbor_distances(_t(Q), _t(X), _t(idx), metric=metric,
                                 mask=_t(mask), backend="torch").numpy()
    N = X.shape[0]
    valid = mask & (idx >= 0) & (idx < N)
    V = X[np.clip(idx, 0, N - 1)]
    _assert_close_dist(ours[:, None], ref[:, None], Q[:, None], V, valid)


@pytest.mark.parametrize("metric", METRICS)
def test_distances_multi_query_rows(rng, metric):
    X, Q, idx, mask = _case(rng, 12, 10, 16, kq=3)
    ref = np.asarray(_jnd(jnp.asarray(Q), jnp.asarray(X), jnp.asarray(idx),
                          jnp.asarray(mask), metric))
    ours = l2dist.gather_distances(_t(Q), _t(X), _t(idx), _t(mask),
                                   metric=metric).numpy()
    valid = mask & (idx >= 0) & (idx < X.shape[0])
    _assert_close_dist(ours, ref, Q, X[np.clip(idx, 0, 199)], valid)


@pytest.mark.parametrize("K_,d", [(8, 16), (32, 32), (64, 20)])
@pytest.mark.parametrize("metric", METRICS)
def test_distances_self_query(rng, K_, d, metric):
    """Diversify tiles: the candidate rows scored against themselves, the
    mask on the column axis only; chosen by the same-tensor test or by the
    explicit flag."""
    X, _, idx, mask = _case(rng, 16, K_, d)
    ref = np.asarray(_jnd(None, jnp.asarray(X), jnp.asarray(idx),
                          jnp.asarray(mask), metric, self_q=True))
    ti = _t(idx)
    by_identity = HP.neighbor_distances(None, _t(X), ti, q_idx=ti,
                                        metric=metric, mask=_t(mask))
    by_flag = HP.neighbor_distances(None, _t(X), ti, self_q=True,
                                    metric=metric, mask=_t(mask))
    assert torch.equal(by_identity, by_flag)
    V = X[np.clip(idx, 0, 199)]
    valid = mask & (idx >= 0) & (idx < 200)
    _assert_close_dist(by_flag.numpy(), ref, V, V, valid)


def test_distances_distinct_q_idx(rng):
    """q_idx equal in value but another tensor: rows of X as Kq queries."""
    X, _, idx, mask = _case(rng, 6, 5, 8)
    q_idx = rng.integers(0, 200, size=(6, 3)).astype(np.int32)
    ref = np.asarray(jax.jit(lambda X, i, q, m: JHP.neighbor_distances(
        None, X, i, mask=m, backend="xla", q_idx=q))(
        jnp.asarray(X), jnp.asarray(idx), jnp.asarray(q_idx),
        jnp.asarray(mask)))
    ours = HP.neighbor_distances(None, _t(X), _t(idx), q_idx=_t(q_idx),
                                 mask=_t(mask)).numpy()
    valid = mask & (idx >= 0) & (idx < 200)
    _assert_close_dist(ours, ref, X[q_idx], X[np.clip(idx, 0, 199)], valid)


def test_distances_masked_lanes_are_inf(rng):
    X, Q, _, _ = _case(rng, 4, 6, 8)
    idx = np.array([[0, 199, 200, -1, 5, 7]] * 4, np.int32)
    mask = np.array([[True, True, True, True, False, True]] * 4)
    out = HP.neighbor_distances(_t(Q), _t(X), _t(idx), mask=_t(mask)).numpy()
    assert (out[:, 2:5] == np.float32(INF)).all()
    assert (out[:, [0, 1, 5]] < 1e30).all()


# ----------------------------------------------------------------------
# rank_merge
# ----------------------------------------------------------------------

def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("R,W,keep", [(7, 5, 3), (16, 32, 32), (9, 96, 64),
                                      (3, 160, 32), (2, 320, 10),
                                      (2, 1000, 17)])
@pytest.mark.parametrize("masked", [False, True])
def test_rank_merge_matches_reference(rng, R, W, keep, masked):
    """Ties on distance (few distinct values), +-0.0, masked lanes and
    widths that are not powers of two: ids AND distances bit-equal."""
    d = (rng.integers(0, 6, size=(R, W)) * 0.5).astype(np.float32)
    d[rng.random((R, W)) < 0.2] = -0.0
    d[rng.random((R, W)) < 0.1] = np.float32(INF)
    ids = rng.integers(0, 50, size=(R, W)).astype(np.int32)
    mask = (rng.random((R, W)) > 0.25) if masked else None
    jd, ji = _jrm(jnp.asarray(d), jnp.asarray(ids),
                  None if mask is None else jnp.asarray(mask), keep)
    td, ti = HP.rank_merge(_t(d), _t(ids), keep=keep,
                           mask=None if mask is None else _t(mask))
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(_bits(td.numpy()), _bits(jd))


def test_rank_merge_negative_zero_ties_break_on_id():
    """-0.0 and +0.0 are one key, as lexsort canonicalizes them: the tie
    breaks on id, and each lane keeps its own zero."""
    d = np.array([[0.0, -0.0, 0.0, -0.0, 1.0]], np.float32)
    ids = np.array([[3, 1, 2, 0, 4]], np.int32)
    td, ti = topk.rank_merge(_t(d), _t(ids), keep=5)
    assert ti.tolist() == [[0, 1, 2, 3, 4]]
    assert np.signbit(td.numpy()[0]).tolist() == [True, True, False, False,
                                                  False]
    jd, ji = _jrm(jnp.asarray(d), jnp.asarray(ids), None, 5)
    assert np.array_equal(np.asarray(ji), ti.numpy())
    assert np.array_equal(_bits(jd), _bits(td.numpy()))


def test_rank_merge_validates_keep():
    d = torch.zeros((2, 4))
    i = torch.zeros((2, 4), dtype=torch.int32)
    for keep in (0, 5):
        with pytest.raises(ValueError):
            HP.rank_merge(d, i, keep=keep)


@pytest.mark.parametrize("W,width,keep", [(300, 64, 40), (1000, 128, 17),
                                          (65, 64, 63), (2049, 512, 500)])
@pytest.mark.parametrize("masked", [False, True])
def test_rank_merge_in_chunks_matches_reference(rng, W, width, keep, masked):
    """Rows wider than one merge takes (the kernel's 16384 lanes, here a
    narrow ``width``) go through in column chunks; with distance ties,
    +-0.0 and masks the result is the reference's full-width merge, bit
    for bit."""
    R = 5
    d = (rng.integers(0, 6, size=(R, W)) * 0.5).astype(np.float32)
    d[rng.random((R, W)) < 0.2] = -0.0
    ids = rng.integers(0, 50, size=(R, W)).astype(np.int32)
    mask = (rng.random((R, W)) > 0.25) if masked else None
    calls = []

    def merge(dd, ii, mm, *, keep):
        calls.append(dd.shape[1])
        return topk.rank_merge_plain(dd, ii, mm, keep=keep)

    td, ti = topk.merge_in_chunks(merge, _t(d), _t(ids),
                                  None if mask is None else _t(mask),
                                  keep=keep, width=width)
    jd, ji = _jrm(jnp.asarray(d), jnp.asarray(ids),
                  None if mask is None else jnp.asarray(mask), keep)
    assert max(calls) <= width and len(calls) > 1
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    assert np.array_equal(_bits(td.numpy()), _bits(jd))


def test_rank_merge_in_chunks_needs_keep_below_width():
    d = torch.zeros((2, 100))
    i = torch.zeros((2, 100), dtype=torch.int32)
    with pytest.raises(ValueError, match="below the 64 lanes"):
        topk.merge_in_chunks(topk.rank_merge_plain, d, i, keep=64, width=64)


# (R, W, keep) of every top-k the main path and the kernel API take at
# full size: the small and large searches, nn_descent, the int8 delta's
# pre-selection (one and two 16,384-slot deltas), the exact k-NN's top-10
# and phase 9's sorts
_MAIN_PATH_MERGES = [
    (2048, 32, 32), (2048, 64, 32), (32, 2048, 10), (32, 2048, 40),
    (10240, 128, 128), (10240, 96, 64), (81920, 160, 32), (81920, 64, 32),
    (1 << 20, 32, 32), (1 << 20, 320, 32), (10240, 16384, 40),
    (10240, 32768, 40), (1024, 1 << 20, 10), (2048, 64, 64),
    (10240, 1024, 10), (64, 16384, 16384)]


@pytest.mark.parametrize("R,W,keep", _MAIN_PATH_MERGES)
def test_topk_path_fits_the_card(R, W, keep):
    """One path for each main-path shape, never the column chunks; each
    launch within the H100's budget (227 KB of shared memory a block, 255
    registers a thread, 65,536 an SM); the launches chain from the row's
    W lanes to ``keep``."""
    p = topk.path(W, keep)
    assert p in ("warp", "select", "cta")
    launches = topk.plan(R, W, keep)
    assert [L.body for L in launches] in {
        "warp": [["warp"]], "cta": [["cta"]],
        "select": [["select"], ["select", "warp"]]}[p]
    width = W
    for L in launches:
        assert L.W == width and L.keep == keep
        assert L.smem_bytes <= 232448 and L.threads <= 1024
        # the pairs plus 48 registers of addresses and temporaries
        regs = L.pair_registers + 48
        assert regs <= 255 and L.threads * regs <= 65536
        if L.body == "cta":
            assert L.W <= L.Wp <= topk.MAX_LANES
        else:
            assert keep <= L.q <= 1024 and L.q % 32 == 0
        if L.body == "select":
            warps = L.threads // 32
            assert L.q <= topk.K_MAX and L.slice % L.q == 0
            assert warps * (L.groups - 1) * L.slice < L.W \
                <= warps * L.groups * L.slice
        width = L.out_width
    assert width == keep


def test_topk_path_bounds():
    assert topk.path(1024, 1024) == "warp"
    assert topk.path(1025, topk.K_MAX) == "select"
    assert topk.path(1025, topk.K_MAX + 1) == "cta"
    assert topk.path(topk.MAX_LANES + 1, topk.K_MAX + 1) == "chunks"
    with pytest.raises(ValueError, match="chunks"):
        topk.plan(1, topk.MAX_LANES + 1, topk.K_MAX + 1)
    with pytest.raises(ValueError, match="keep="):
        topk.path(8, 9)


@pytest.mark.parametrize("k", [1, 4])
def test_seed_select_matches_reference(rng, k):
    X, Q, _, _ = _case(rng, 10, 8, 16)
    seeds = rng.integers(0, 200, size=(10, 8)).astype(np.int32)
    jd, ji = jax.jit(lambda Q, X, s: JHP.seed_select(
        Q, X, s, k=k, backend="xla"))(jnp.asarray(Q), jnp.asarray(X),
                                      jnp.asarray(seeds))
    td, ti = HP.seed_select(_t(Q), _t(X), _t(seeds), k=k)
    assert np.array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-5,
                               atol=1e-4)


# ----------------------------------------------------------------------
# visited filter
# ----------------------------------------------------------------------

def test_hash_bucket_matches_reference(rng):
    ids = np.concatenate([rng.integers(-2 ** 31, 2 ** 31 - 1, size=500),
                          [0, 1, -1, 2 ** 31 - 1, -2 ** 31, 12345]]) \
        .astype(np.int32)
    for n_buckets in (64, 128, 2048):
        shift = visited.shift_for(n_buckets)
        ref = np.asarray(jvf.hash_bucket(jnp.asarray(ids), shift))
        ours = visited.hash_bucket(_t(ids), shift).numpy()
        assert np.array_equal(ours, ref)
        assert ours.min() >= 0 and ours.max() < n_buckets


def test_shift_for_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        visited.shift_for(48)


@pytest.mark.parametrize("B,M,bound,id_range", [(6, 8, 40, 64),
                                                (4, 32, 200, 500),
                                                (3, 16, 8, 10000)])
def test_visited_filter_matches_reference(rng, B, M, bound, id_range):
    """Several successive calls on one table: ids repeat inside and across
    calls (hits), tiny tables overflow buckets (drops) — the table and the
    fresh lanes equal the reference's after every call.  The port's table
    is bucket-major [B, S, W]; transposed back to the reference's
    [B, W, S], it must equal it bit for bit."""
    jt = JHP.visited_table(B, bound)
    tt = HP.visited_table(B, bound)
    for _ in range(4):
        ids = rng.integers(0, id_range, size=(B, M)).astype(np.int32)
        ids[:, M // 2:] = ids[:, :M - M // 2]
        valid = rng.random((B, M)) > 0.2
        jt, jf = jax.jit(lambda t, i, v: JHP.visited_filter(
            t, i, valid=v, backend="xla"))(jt, jnp.asarray(ids),
                                           jnp.asarray(valid))
        tt2, tf = HP.visited_filter(tt, _t(ids), valid=_t(valid))
        assert tt2 is tt  # in place
        assert np.array_equal(tf.numpy(), np.asarray(jf))
        assert np.array_equal(tt.permute(0, 2, 1).numpy(), np.asarray(jt))


def test_visited_table_sizing():
    t = HP.visited_table(3, 193)
    assert t.shape == (3, 64, 8) and t.dtype == torch.int32
    assert HP.visited_table(2, 4224).shape == (2, 2048, 8)
    assert (t == visited.VF_EMPTY).all()


# ----------------------------------------------------------------------
# dispatch rules
# ----------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_version_without_launching(rng):
    K.reset_launch_counts()
    X, Q, idx, mask = _case(rng, 4, 6, 8)
    a = l2dist.gather_distances(_t(Q)[:, None], _t(X), _t(idx), _t(mask))
    b = l2dist.gather_distances_plain(_t(Q)[:, None], _t(X), _t(idx),
                                      _t(mask))
    assert torch.equal(a, b)
    topk.rank_merge(torch.zeros((2, 4)), torch.zeros((2, 4),
                                                     dtype=torch.int32),
                    keep=2)
    visited.visited_filter(HP.visited_table(2, 4),
                           torch.zeros((2, 3), dtype=torch.int32),
                           torch.ones((2, 3), dtype=torch.bool))
    l2dist.gather_distances(_t(Q)[:, None], _t(X).to(torch.int8), _t(idx),
                            scales=torch.ones(200))
    l2dist.gather_distances(_t(Q)[:, None], _t(X).to(torch.bfloat16),
                            _t(idx))
    for sc in (None, torch.ones((1, 6))):
        block.block_distances(torch.zeros((1, 3, 8)), torch.zeros(
            (1, 6, 8), dtype=torch.float32 if sc is None else torch.int8),
            v_scales=sc)
    ops.distance_matrix(torch.zeros((2, 4)), torch.zeros((3, 4)))
    ops.bitonic_topk(torch.zeros((2, 8)),
                     torch.zeros((2, 8), dtype=torch.int32), 3)
    ops.embedding_bag(torch.zeros((5, 4)),
                      torch.zeros((2, 3), dtype=torch.int32))
    ops.packed_spmm(torch.zeros((2, 3), dtype=torch.int32),
                    torch.zeros((5, 4)), torch.zeros((4, 2)))
    ops.flash_attention(torch.zeros((1, 4, 2, 8)), torch.zeros((1, 4, 1, 8)),
                        torch.zeros((1, 4, 1, 8)))
    qkv = [torch.zeros(s, requires_grad=True)
           for s in ((1, 4, 2, 8), (1, 4, 1, 8), (1, 4, 1, 8))]
    flash_attention.flash_attention(*qkv).sum().backward()
    flash_attention.flash_attention_bwd(*(t.detach() for t in qkv),
                                        torch.ones((1, 4, 2, 8)))
    feat, w = (torch.zeros(s, requires_grad=True) for s in ((5, 4), (4, 2)))
    ops.packed_spmm(torch.zeros((2, 3), dtype=torch.int32), feat,
                    w).sum().backward()
    table = torch.zeros((5, 4), requires_grad=True)
    ops.embedding_bag(table, torch.zeros((2, 3), dtype=torch.int32)
                      ).sum().backward()
    assert K.launch_counts() == dict.fromkeys(
        ("gather_distances", "gather_distances_int8",
         "gather_distances_bf16", "rank_merge",
         "visited_filter", "block_distances", "block_distances_int8",
         "distance_matrix", "bitonic_sort", "embedding_bag", "packed_spmm",
         "flash_attention", "flash_attention_bwd", "packed_spmm_bwd",
         "embedding_bag_bwd"), 0)


def test_resolve_backend():
    assert HP.resolve_backend("auto", "cpu") == "torch"
    assert HP.resolve_backend(None, "cpu") == "torch"
    assert HP.resolve_backend("torch", "cpu") == "torch"
    assert HP.resolve_backend("auto", "cuda") == "cuda"
    with pytest.raises(ValueError, match="CUDA tensors"):
        HP.resolve_backend("cuda", "cpu")
    with pytest.raises(ValueError, match="unknown kernel backend"):
        HP.resolve_backend("pallas", "cpu")


def test_cuda_backend_on_cpu_tensors_raises(rng):
    X, Q, idx, _ = _case(rng, 4, 6, 8)
    with pytest.raises(ValueError):
        HP.neighbor_distances(_t(Q), _t(X), _t(idx), backend="cuda")


def test_later_slice_features_raise(rng):
    """Self-query tiles score fp32 rows: with ``scales`` they raise
    ``ValueError``, as the reference does (its Pallas backend)."""
    X, _, idx, _ = _case(rng, 4, 6, 8)
    codes = _t(X).to(torch.int8)
    with pytest.raises(ValueError, match="self_q"):
        HP.neighbor_distances(None, codes, _t(idx), q_idx=_t(idx),
                              self_q=True, scales=torch.ones(200))
    with pytest.raises(ValueError, match="self_q"):
        l2dist.gather_distances(None, codes, _t(idx), self_q=True,
                                scales=torch.ones(200))
    # a bf16 database takes the search's row body only
    Xb = _t(X).to(torch.bfloat16)
    with pytest.raises(ValueError, match="bf16"):
        l2dist.gather_distances(None, Xb, _t(idx), self_q=True)
    with pytest.raises(ValueError, match="bf16"):
        l2dist.gather_distances_plain(_t(X)[:4, None], Xb, _t(idx),
                                      scales=torch.ones(200))

