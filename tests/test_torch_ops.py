"""The port's kernel API (``repro_torch.kernels.ops``) against the JAX
reference's (``repro.kernels.ops`` with ``use_pallas=False``), on the CPU.

The same numpy inputs go through both.  On the CPU ``use_kernel=True``
takes each kernel's plain version, the arithmetic the CUDA kernel is held
to on the card (``tests/test_torch_cuda.py``, ``chip_smoke.py``), and
``use_kernel=False`` the port's oracles (``kernels/ref.py``).  Tolerances:

* distances within 1e-6 * (qn + xn) per entry (the two sides sum in
  different orders, both in float32);
* sorts and top-k exactly: the same ids and the same values;
* embedding bags within 1e-6 * the bag's sum of |rows| (/ bag for mean);
* SpMM within 1e-5 * (|agg| @ |W|) per entry;
* bfloat16 bags and SpMM as their tests state: the reference's plain
  path rounds its intermediates to bfloat16, the port only its output;
* attention within 1e-5 * (P @ |V|) per entry (the softmax weights
  applied to |v|), plus one bfloat16 rounding (2^-7 * |out|) when the
  inputs are bfloat16: each side rounds its float32 result once.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import ops, ref, segment_matmul, topk

# small inputs: one thread, so the test workers beside this file keep
# their cores
torch.set_num_threads(1)


@pytest.fixture
def rng():
    """A generator of this file's own for each test, so these tests leave
    the stream of the shared ``rng`` fixture (conftest.py), which later
    test files draw from, as it was."""
    return np.random.default_rng(13)


@functools.partial(jax.jit, static_argnames=("metric",))
def _jdist(Q, X, metric):
    return jops.distance_matrix(Q, X, metric=metric, use_pallas=False)


@jax.jit
def _jsort(d, ids):
    return jops.bitonic_sort(d, ids, use_pallas=False)


@functools.partial(jax.jit, static_argnames=("k",))
def _jtopk(d, ids, k):
    return jops.bitonic_topk(d, ids, k, use_pallas=False)


@functools.partial(jax.jit, static_argnames=("combine",))
def _jbag(table, ids, combine):
    return jops.embedding_bag(table, ids, combine=combine, use_pallas=False)


@functools.partial(jax.jit, static_argnames=("combine",))
def _jspmm(nbrs, feat, w, combine):
    return jops.packed_spmm(nbrs, feat, w, combine=combine,
                            use_pallas=False)


@functools.partial(jax.jit, static_argnames=("window", "q_offset"))
def _jattn(q, k, v, window, q_offset):
    return jops.flash_attention(q, k, v, window=window, q_offset=q_offset,
                                use_pallas=False)


def _both(fn, *args, **kw):
    """``fn`` through the plain versions (use_kernel=True on the CPU) and
    through the oracles (use_kernel=False)."""
    return [fn(*args, use_kernel=u, **kw) for u in (True, False)]


def _norms(Q, X):
    return ((Q.astype(np.float64) ** 2).sum(1)[:, None]
            + (X.astype(np.float64) ** 2).sum(1)[None, :])


# ----------------------------------------------------------------------
# distance matrix
# ----------------------------------------------------------------------

@pytest.mark.parametrize("B,N,d", [(8, 16, 4), (70, 200, 48), (1, 300, 33)])
@pytest.mark.parametrize("metric", ["l2", "ip", "cos"])
def test_distance_matrix_matches_reference(rng, B, N, d, metric):
    Q = rng.normal(size=(B, d)).astype(np.float32)
    X = rng.normal(size=(N, d)).astype(np.float32)
    if metric == "cos":
        Q /= np.linalg.norm(Q, axis=1, keepdims=True)
        X /= np.linalg.norm(X, axis=1, keepdims=True)
    want = np.asarray(_jdist(jnp.asarray(Q), jnp.asarray(X), metric))
    tol = 1e-6 * _norms(Q, X)
    for got in _both(ops.distance_matrix, torch.from_numpy(Q),
                     torch.from_numpy(X), metric=metric):
        assert got.dtype == torch.float32 and got.shape == (B, N)
        assert (np.abs(got.numpy().astype(np.float64) - want) <= tol).all()


@pytest.mark.parametrize("B,N,d", [(32, 64, 64), (70, 200, 48)])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_distance_matrix_bf16_inputs(rng, B, N, d, metric):
    """bfloat16 rows are widened to float32 before the arithmetic, as the
    reference's ``.astype(float32)`` does; both sides round the same numpy
    values to bfloat16."""
    Q = rng.normal(size=(B, d)).astype(np.float32)
    X = rng.normal(size=(N, d)).astype(np.float32)
    want = np.asarray(_jdist(jnp.asarray(Q).astype(jnp.bfloat16),
                             jnp.asarray(X).astype(jnp.bfloat16), metric))
    Qt = torch.from_numpy(Q).to(torch.bfloat16)
    Xt = torch.from_numpy(X).to(torch.bfloat16)
    tol = 1e-6 * _norms(Qt.float().numpy(), Xt.float().numpy())
    for got in _both(ops.distance_matrix, Qt, Xt, metric=metric):
        assert got.dtype == torch.float32
        assert (np.abs(got.numpy().astype(np.float64) - want) <= tol).all()


# ----------------------------------------------------------------------
# bitonic sort / top-k
# ----------------------------------------------------------------------

def _assert_sorted_like(got, want):
    (gd, gi), (wd, wi) = got, want
    assert np.array_equal(gi.numpy(), np.asarray(wi))
    assert np.array_equal(gd.numpy(), np.asarray(wd))   # by value


@pytest.mark.parametrize("R,W", [(3, 8), (37, 32), (200, 16)])
def test_bitonic_sort_matches_reference(rng, R, W):
    d = rng.normal(size=(R, W)).astype(np.float32)
    ids = rng.integers(0, 10_000, size=(R, W)).astype(np.int32)
    want = _jsort(jnp.asarray(d), jnp.asarray(ids))
    for got in _both(ops.bitonic_sort, torch.from_numpy(d),
                     torch.from_numpy(ids)):
        _assert_sorted_like(got, want)


def test_bitonic_sort_duplicates_and_signed_zeros(rng):
    """Repeated distances break on id; -0.0 and +0.0 are one key."""
    d = rng.integers(0, 4, size=(20, 32)).astype(np.float32)
    d[rng.random((20, 32)) < 0.3] = -0.0
    ids = rng.integers(0, 8, size=(20, 32)).astype(np.int32)
    want = _jsort(jnp.asarray(d), jnp.asarray(ids))
    for got in _both(ops.bitonic_sort, torch.from_numpy(d),
                     torch.from_numpy(ids)):
        _assert_sorted_like(got, want)


@pytest.mark.parametrize("R,W,k", [(16, 64, 10), (5, 32, 32), (9, 128, 1)])
def test_bitonic_topk_matches_reference(rng, R, W, k):
    d = rng.integers(0, 50, size=(R, W)).astype(np.float32) * 0.25
    ids = rng.integers(0, 1000, size=(R, W)).astype(np.int32)
    want = _jtopk(jnp.asarray(d), jnp.asarray(ids), k)
    for got in _both(ops.bitonic_topk, torch.from_numpy(d),
                     torch.from_numpy(ids), k):
        _assert_sorted_like(got, want)


def test_kernel_widths_are_checked_on_every_device():
    """The kernel sorts power-of-two rows (the reference asserts it even in
    interpret mode) of at most MAX_LANES lanes, so the CPU refuses what the
    card would; the oracles take any width."""
    d = torch.zeros((2, 6))
    ids = torch.zeros((2, 6), dtype=torch.int32)
    with pytest.raises(ValueError, match="power of two"):
        ops.bitonic_sort(d, ids)
    with pytest.raises(ValueError, match="power of two"):
        ops.bitonic_topk(d, ids, 2)
    assert ops.bitonic_sort(d, ids, use_kernel=False)[0].shape == (2, 6)
    wide = 2 * topk.MAX_LANES
    with pytest.raises(ValueError, match="exceeds"):
        ops.bitonic_sort(torch.zeros((1, wide)),
                         torch.zeros((1, wide), dtype=torch.int32))
    with pytest.raises(ValueError, match="k="):
        ops.bitonic_topk(torch.zeros((2, 8)),
                         torch.zeros((2, 8), dtype=torch.int32), 9)


# ----------------------------------------------------------------------
# embedding bag / packed spmm
# ----------------------------------------------------------------------

@pytest.mark.parametrize("V,E,B,bag", [(100, 8, 8, 3), (500, 16, 19, 7)])
@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_embedding_bag_matches_reference(rng, V, E, B, bag, combine):
    table = rng.normal(size=(V, E)).astype(np.float32)
    ids = rng.integers(0, V, size=(B, bag)).astype(np.int32)
    want = np.asarray(_jbag(jnp.asarray(table), jnp.asarray(ids), combine))
    scale = np.abs(table.astype(np.float64))[ids].sum(1)
    if combine == "mean":
        scale /= bag
    for got in _both(ops.embedding_bag, torch.from_numpy(table),
                     torch.from_numpy(ids), combine=combine):
        assert got.dtype == torch.float32 and got.shape == (B, E)
        assert (np.abs(got.numpy() - want) <= 1e-6 * scale).all()


@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_embedding_bag_bf16_matches_reference(rng, combine):
    """A bfloat16 table returns bfloat16.  The port sums the widened rows
    in float32 and rounds once; the reference's plain path rounds its sum
    and its mean's division to bfloat16.  So within 1e-6 * the bag's sum
    of |rows| (/ bag for mean) plus three bfloat16 roundings of values
    that sum bounds (3 * 2^-8 of it)."""
    V, E, B, bag = 300, 16, 19, 7
    table = torch.from_numpy(rng.normal(size=(V, E)).astype(np.float32)) \
        .bfloat16()
    ids = rng.integers(0, V, size=(B, bag)).astype(np.int32)
    want = np.asarray(_jbag(jnp.asarray(table.float().numpy()).astype(
        jnp.bfloat16), jnp.asarray(ids), combine).astype(jnp.float32))
    scale = np.abs(table.float().numpy().astype(np.float64))[ids].sum(1)
    if combine == "mean":
        scale /= bag
    got = ops.embedding_bag(table, torch.from_numpy(ids), combine=combine)
    assert got.dtype == torch.bfloat16 and got.shape == (B, E)
    assert (np.abs(got.float().numpy() - want)
            <= (1e-6 + 3 * 2.0 ** -8) * scale).all()


def _spmm_case(rng, N, M, d, f):
    feat = rng.normal(size=(N, d)).astype(np.float32)
    nbrs = rng.integers(-2, N + 30, size=(N, M)).astype(np.int32)
    nbrs[3] = N + 5                           # a row with no valid lane
    w = rng.normal(size=(d, f)).astype(np.float32)
    return feat, nbrs, w


def _spmm_weight(feat, nbrs, w, combine):
    """|agg| @ |W| in float64, the scale of the SpMM tolerance."""
    Nf = feat.shape[0]
    ok = nbrs < Nf
    agg = np.where(ok[..., None], feat[np.clip(nbrs, 0, Nf - 1)], 0.0) \
        .astype(np.float64).sum(1)
    if combine == "mean":
        agg /= np.maximum(ok.sum(1, keepdims=True), 1)
    return np.abs(agg) @ np.abs(w.astype(np.float64))


@pytest.mark.parametrize("N,M,d,f", [(50, 6, 24, 8), (100, 16, 32, 16)])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_packed_spmm_matches_reference(rng, N, M, d, f, combine):
    """Sentinel lanes (ids >= N) skipped, negative ids read row 0 and
    count, an all-sentinel row gives zeros."""
    feat, nbrs, w = _spmm_case(rng, N, M, d, f)
    want = np.asarray(_jspmm(jnp.asarray(nbrs), jnp.asarray(feat),
                             jnp.asarray(w), combine))
    tol = 1e-5 * _spmm_weight(feat, nbrs, w, combine)
    for got in _both(ops.packed_spmm, torch.from_numpy(nbrs),
                     torch.from_numpy(feat), torch.from_numpy(w),
                     combine=combine):
        assert got.dtype == torch.float32 and got.shape == (N, f)
        assert (np.abs(got.numpy() - want) <= tol).all()
        assert (got[3] == 0).all()


@pytest.mark.parametrize("w_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_packed_spmm_bf16_matches_reference(rng, w_dtype, combine):
    """bfloat16 features (W in either dtype) return bfloat16.  The port
    sums and multiplies in float32 and rounds the output once; the
    reference's plain path rounds its aggregate to bfloat16 (the sum and
    the mean's division) and, for a bfloat16 W, its output.  So within
    1e-5 * (|agg| @ |W|), plus 2^-7 * (|agg| @ |W|) for the aggregate's
    roundings, plus 2^-7 * |want| for the two outputs' roundings."""
    N, M, d, f = 60, 8, 24, 16
    feat, nbrs, w = _spmm_case(rng, N, M, d, f)
    feat_t = torch.from_numpy(feat).bfloat16()
    w_t = torch.from_numpy(w).to(getattr(torch, w_dtype))
    feat, w = feat_t.float().numpy(), w_t.float().numpy()
    want = np.asarray(_jspmm(
        jnp.asarray(nbrs), jnp.asarray(feat).astype(jnp.bfloat16),
        jnp.asarray(w).astype(getattr(jnp, w_dtype)), combine)
        .astype(jnp.float32))
    weight = _spmm_weight(feat, nbrs, w, combine)
    tol = (1e-5 + 2.0 ** -7) * weight + 2.0 ** -7 * np.abs(want)
    got = ops.packed_spmm(torch.from_numpy(nbrs), feat_t, w_t,
                          combine=combine)
    assert got.dtype == torch.bfloat16 and got.shape == (N, f)
    assert (np.abs(got.float().numpy() - want) <= tol).all()
    assert (got[3] == 0).all()


def test_kernel_api_dtypes_are_checked_on_every_device():
    """float32 and bfloat16 only, on the CPU as on the card."""
    ids = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.embedding_bag(torch.zeros((5, 4), dtype=torch.float16), ids)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        ops.packed_spmm(ids, torch.zeros((5, 4), dtype=torch.float64),
                        torch.zeros((4, 2)))
    with pytest.raises(ValueError, match="^w: float32 or bfloat16"):
        ops.packed_spmm(ids, torch.zeros((5, 4)),
                        torch.zeros((4, 2), dtype=torch.float16))
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        segment_matmul.project(torch.zeros((5, 4)), torch.zeros((4, 2)),
                               out_dtype=torch.float16)
    y = segment_matmul.project(torch.zeros((5, 4)).bfloat16(),
                               torch.zeros((4, 2)))
    assert y.dtype == torch.bfloat16 and y.shape == (5, 2)


@pytest.mark.parametrize("N,M,d,f", [(50, 6, 24, 8), (100, 16, 32, 16)])
@pytest.mark.parametrize("combine", ["sum", "mean"])
def test_transform_plain_matches_reference(N, M, d, f, combine):
    """The transform route's arithmetic (``feat @ w`` first, then the
    lane-order gather and mean of its rows) within 1e-5 * (|agg| @ |W|)
    of the reference, which aggregates first."""
    feat, nbrs, w = _spmm_case(np.random.default_rng(1900 + N + M), N, M,
                               d, f)
    want = np.asarray(_jspmm(jnp.asarray(nbrs), jnp.asarray(feat),
                             jnp.asarray(w), combine))
    tol = 1e-5 * _spmm_weight(feat, nbrs, w, combine)
    got = segment_matmul.transform_plain(*map(torch.from_numpy,
                                              (nbrs, feat, w)),
                                         combine=combine)
    assert got.dtype == torch.float32 and got.shape == (N, f)
    assert (np.abs(got.numpy() - want) <= tol).all()
    assert (got[3] == 0).all()


def test_segment_matmul_ref_matches_reference(rng):
    from repro.kernels import ref as jref

    feat = rng.normal(size=(30, 12)).astype(np.float32)
    w = rng.normal(size=(12, 5)).astype(np.float32)
    src = rng.integers(0, 30, size=80).astype(np.int32)
    dst = rng.integers(0, 24, size=80).astype(np.int32)
    want = np.asarray(jax.jit(jref.segment_matmul_ref, static_argnums=4)(
        jnp.asarray(feat), jnp.asarray(src), jnp.asarray(dst),
        jnp.asarray(w), 20))
    got = ref.segment_matmul_ref(*map(torch.from_numpy, (feat, src, dst, w)),
                                 20).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flash_attention_zero_inputs_give_zeros():
    """Both routes (the kernel's plain version on the CPU and the oracle)
    take a zero input to zeros of its shape."""
    q = torch.zeros((1, 4, 2, 8))
    for use_kernel in (True, False):
        out = ops.flash_attention(q, q, q, use_kernel=use_kernel)
        assert out.shape == q.shape and not out.any()


# ----------------------------------------------------------------------
# flash attention
# ----------------------------------------------------------------------

def _attn_case(rng, B, Sq, Skv, H, KV, hd, dtype=np.float32):
    q, k, v = (rng.normal(size=(B, S, h, hd)).astype(np.float32)
               for S, h in ((Sq, H), (Skv, KV), (Skv, KV)))
    if dtype != np.float32:   # round once to bf16, the same on both sides
        q, k, v = (torch.from_numpy(a).bfloat16().float().numpy()
                   for a in (q, k, v))
    return q, k, v


@pytest.mark.parametrize("B,Sq,Skv,H,KV,hd,window,q_offset,dtype", [
    (2, 256, 256, 4, 2, 32, 64, 0, "float32"),
    (2, 50, 70, 6, 3, 24, 16, 20, "float32"),
    (3, 1, 300, 4, 2, 32, 0, 299, "float32"),
    (1, 128, 128, 2, 2, 32, 0, 0, "bfloat16")])
def test_flash_attention_matches_reference(rng, B, Sq, Skv, H, KV, hd,
                                           window, q_offset, dtype):
    """GQA under a window at a shape of the reference's own tests
    (tests/test_kernels.py), a ragged chunk of prefill at an offset, one
    decode step, and the reference's bfloat16 case."""
    q, k, v = _attn_case(rng, B, Sq, Skv, H, KV, hd, dtype)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    want = np.asarray(_jattn(*(jnp.asarray(a).astype(jd) for a in (q, k, v)),
                             window, q_offset).astype(jnp.float32))
    weight = ref.attention_ref(*map(torch.from_numpy, (q, k, np.abs(v))),
                               window=window, q_offset=q_offset).numpy()
    tol = 1e-5 * weight + (2.0 ** -7 * np.abs(want) if dtype == "bfloat16"
                           else 0.0)
    args = [torch.from_numpy(a).to(getattr(torch, dtype)) for a in (q, k, v)]
    for got in _both(ops.flash_attention, *args, window=window,
                     q_offset=q_offset):
        assert got.dtype == args[0].dtype and got.shape == (B, Sq, H, hd)
        assert (np.abs(got.float().numpy() - want) <= tol).all()


def test_flash_attention_shapes_are_checked_on_every_device():
    """The kernel's wrapper refuses, on the CPU as on the card, inputs that
    leave a query row with no key to see; the oracle takes them."""
    q = torch.zeros((1, 4, 2, 8))
    kv = torch.zeros((1, 6, 1, 8))
    for bad in (dict(q_offset=-1), dict(window=2, q_offset=4)):
        with pytest.raises(ValueError, match="no key"):
            ops.flash_attention(q, kv, kv, **bad)
        assert ops.flash_attention(q, kv, kv, use_kernel=False,
                                   **bad).shape == q.shape
    with pytest.raises(ValueError, match="multiple of KV"):
        ops.flash_attention(torch.zeros((1, 4, 3, 8)), kv.expand(
            1, 6, 2, 8).contiguous(), kv.expand(1, 6, 2, 8).contiguous())
