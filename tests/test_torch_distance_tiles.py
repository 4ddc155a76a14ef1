"""The arithmetic of the port's tensor-core distance tiles, on the CPU,
against the JAX reference.

``csrc/l2dist.cu``'s self-query body (the diversify tiles, [T, K, K]) and
``csrc/block.cu``'s tile (the distance matrix, and the distance block of
the delta scan, whose int8 codes it stages as fl(code x scale)) run their
fp32 products on the TF32 tensor cores in 3xTF32: each operand is split
into x = hi + lo (both rounded to TF32 as ``cvt.rna`` rounds), and each
8-column step of a dot adds lo.hi, hi.lo and hi.hi into a float32
accumulator, one mma each.  The tensor cores' adder truncates, so each
chunk of d (128 columns in the self-query tile, 32 in block.cu's) sums
into a fresh accumulator that is added to the running one in float32,
rounded to nearest.  The CUDA bodies run only on the card
(``tests/test_torch_cuda.py``); here that arithmetic is emulated in numpy
on make_clustered-like rows and held to the reference
(``neighbor_distances(backend="xla")``,
``ops.distance_matrix(use_pallas=False)`` and
``scan_distances(backend="xla")``) within the card's contract,
1e-5 * (qn + vn), while a single TF32 rounding of the operands misses it,
and so, at GIST's d = 960, does the self-query tile without its flush.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro.ann.quantize import quantize_rows
from repro.core import hotpath as JHP
from repro.kernels import ops as jops


@functools.partial(jax.jit, static_argnames=("metric",))
def _jself(X, idx, mask, metric):
    return JHP.neighbor_distances(None, X, idx, metric=metric, mask=mask,
                                  backend="xla", q_idx=idx)


@functools.partial(jax.jit, static_argnames=("metric",))
def _jmatrix(Q, X, metric):
    return jops.distance_matrix(Q, X, metric=metric, use_pallas=False)


@functools.partial(jax.jit, static_argnames=("metric",))
def _jscan(Q, Xd, mask, scales, metric):
    return JHP.scan_distances(Q, Xd, metric=metric, mask=mask,
                              backend="xla", scales=scales)


def _tf32(x):
    """cvt.rna.tf32.f32: the float32 bits rounded to 10 mantissa bits,
    ties away from zero."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split(x):
    hi = _tf32(x)
    return hi, _tf32(np.asarray(x, np.float32) - hi)


def _mma(c, prods):
    """One mma step as the tensor cores add it: the accumulator c
    [...] float32 and the step's exact products [..., 8] aligned to the
    largest exponent among them, the bits past float32's 24 and one guard
    bit cut off, the sum cut to float32 (round toward zero).  A model: it
    puts the self-query tile's err/tol at d = 128 near the card's (0.25),
    where round-to-nearest adds would give a seventh of it."""
    c = c.astype(np.float64)
    _, e = np.frexp(np.maximum(np.abs(prods).max(-1), np.abs(c)))
    r = np.ldexp(1.0, 25 - e)                     # 1 / the kept quantum
    s = (np.trunc(prods * r[..., None]).sum(-1) + np.trunc(c * r)) / r
    f = s.astype(np.float32)                      # s is exact in float64
    return np.where(np.abs(f) > np.abs(s), np.nextafter(f, np.float32(0)), f)


def _dots(a, b, terms, chunk):
    """[..., M, d] x [..., N, d] -> [..., M, N] float32 as the tile sums
    them: per 8-column step (d zero-padded to a multiple of 8), one
    :func:`_mma` a (a-part, b-part) pair of ``terms``, in the order given,
    into the chunk's accumulator; every ``chunk`` columns that is added to
    the running sum in float32 (round to nearest) and starts again at 0."""
    width = a["hi"].shape[-1]
    pad = [(0, 0)] * (a["hi"].ndim - 1) + [(0, -width % 8)]
    a = {k: np.pad(v, pad).astype(np.float64) for k, v in a.items()}
    b = {k: np.pad(v, pad).astype(np.float64) for k, v in b.items()}
    acc = np.zeros(a["hi"].shape[:-1] + (b["hi"].shape[-2],), np.float32)
    part = np.zeros_like(acc)
    for k0 in range(0, a["hi"].shape[-1], 8):
        if k0 and k0 % chunk == 0:
            acc, part = acc + part, np.zeros_like(acc)
        for pa, pb in terms:
            part = _mma(part, a[pa][..., :, None, k0:k0 + 8]
                        * b[pb][..., None, :, k0:k0 + 8])
    return acc + part


THREE = (("lo", "hi"), ("hi", "lo"), ("hi", "hi"))   # the small ones first
ONCE = (("hi", "hi"),)


def _l2(qn, vn, dots):
    """The epilogue in float32: (qn + vn) - 2 dots."""
    return (qn[..., :, None] + vn[..., None, :]) - np.float32(2) * dots


def _rows(gen, n, d):
    """make_clustered-like rows: 16 Gaussian centres, noise 0.15."""
    centres = gen.normal(size=(16, d)).astype(np.float32)
    return (centres[gen.integers(0, 16, n)]
            + 0.15 * gen.normal(size=(n, d))).astype(np.float32)


@pytest.mark.parametrize("K", [32, 64])
@pytest.mark.parametrize("d", [20, 128, 960])
def test_self_query_tile_3xtf32_holds_the_tolerance(K, d):
    """Eight tiles of K rows gathered from 3,000 (ids past N and masked
    lanes included): the 3xTF32 tile within 1e-5 * (vn_i + vn_j) of the
    reference on every valid column; one TF32 rounding outside it.  At
    d = 960 (8 chunks) the tile without the flush between chunks misses
    the tolerance on the diagonal, 2 vn - 2 <v, v>."""
    gen = np.random.default_rng(1600 + 10 * K + d)
    N, S = 3000, 8
    X = _rows(gen, N, d)
    idx = gen.integers(0, N + 5, size=(S, K)).astype(np.int32)
    mask = gen.random((S, K)) > 0.1
    want = np.asarray(_jself(jnp.asarray(X), jnp.asarray(idx),
                             jnp.asarray(mask), "l2"))
    V = X[np.clip(idx, 0, N - 1)]                         # [S, K, d]
    vn = np.sum(V * V, axis=-1, dtype=np.float32)
    parts = dict(zip(("hi", "lo"), _split(V)))
    valid = (mask & (idx < N))[:, None, :].repeat(K, 1)
    tol = 1e-5 * (vn[:, :, None] + vn[:, None, :])
    three = _l2(vn, vn, _dots(parts, parts, THREE, 128))
    once = _l2(vn, vn, _dots(parts, parts, ONCE, 128))
    assert (want[~valid] == np.float32(3.4e38)).all()
    assert (np.abs(three - want)[valid] <= tol[valid]).all()
    assert (np.abs(once - want)[valid] / tol[valid]).max() > 4
    if d > 128:   # the diagonal alone: each row against itself
        rows = {k: v.reshape(S * K, 1, d) for k, v in parts.items()}
        unflushed = 2 * vn - 2 * _dots(rows, rows, THREE, d).reshape(S, K)
        diag = np.diagonal(want, axis1=1, axis2=2)
        ok = np.diagonal(valid, axis1=1, axis2=2)
        assert (np.abs(unflushed - diag) > 2e-5 * vn)[ok].any()


@pytest.mark.parametrize("K", [32, 64])
@pytest.mark.parametrize("d", [20, 128])
def test_distance_matrix_tile_3xtf32_holds_the_tolerance(K, d):
    """K queries near the rows against 4K rows, l2 and ip: the 3xTF32 tile
    within 1e-5 * (qn + xn) of the reference; one TF32 rounding outside
    it."""
    gen = np.random.default_rng(1700 + 10 * K + d)
    rows = _rows(gen, 5 * K, d)
    Q, X = rows[:K], rows[K:]
    qn = np.sum(Q * Q, axis=-1, dtype=np.float32)
    xn = np.sum(X * X, axis=-1, dtype=np.float32)
    tol = 1e-5 * (qn[:, None] + xn[None, :])
    q = dict(zip(("hi", "lo"), _split(Q)))
    x = dict(zip(("hi", "lo"), _split(X)))
    for metric in ("l2", "ip"):
        want = np.asarray(_jmatrix(jnp.asarray(Q), jnp.asarray(X), metric))
        three, once = (_dots(q, x, terms, 32) for terms in (THREE, ONCE))
        if metric == "l2":
            three, once = _l2(qn, xn, three), _l2(qn, xn, once)
        else:
            three, once = -three, -once
        assert (np.abs(three - want) <= tol).all(), metric
        assert (np.abs(once - want) / tol).max() > 4, metric


@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("d", [20, 128])
def test_block_tile_3xtf32_holds_the_tolerance(quant, d):
    """The delta scan on block.cu's tile: 64 queries near the rows against
    a 256-slot shard with a fifth of its slots masked, fp32 rows or int8
    codes (staged as fl(code x scale), vn over those values), l2 and ip:
    the 3xTF32 tile within 1e-5 * (qn + vn) of the reference's
    ``scan_distances`` on every live slot and 3.4e38 on masked ones; one
    TF32 rounding outside the tolerance."""
    gen = np.random.default_rng(1800 + 10 * d + quant)
    rows = _rows(gen, 320, d)
    Q, X = rows[:64], rows[64:]
    mask = gen.random(256) > 0.2
    scales = None
    if quant:
        codes, scales = (np.asarray(a) for a in quantize_rows(jnp.asarray(X)))
        X, V = codes, codes.astype(np.float32) * scales[:, None]
    else:
        V = X
    qn = np.sum(Q * Q, axis=-1, dtype=np.float32)
    vn = np.sum(V * V, axis=-1, dtype=np.float32)
    tol = 1e-5 * (qn[:, None] + vn[None, :])
    q = dict(zip(("hi", "lo"), _split(Q)))
    v = dict(zip(("hi", "lo"), _split(V)))
    for metric in ("l2", "ip"):
        want = np.asarray(_jscan(jnp.asarray(Q), jnp.asarray(X),
                                 jnp.asarray(mask), None if scales is None
                                 else jnp.asarray(scales), metric))
        three, once = (_dots(q, v, terms, 32) for terms in (THREE, ONCE))
        if metric == "l2":
            three, once = _l2(qn, vn, three), _l2(qn, vn, once)
        else:
            three, once = -three, -once
        assert (want[:, ~mask] == np.float32(3.4e38)).all(), metric
        live = np.broadcast_to(mask, want.shape)
        assert (np.abs(three - want)[live] <= tol[live]).all(), metric
        assert (np.abs(once - want)[live] / tol[live]).max() > 4, metric
