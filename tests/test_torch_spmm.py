"""The packed SpMM's two routes (``repro_torch.kernels.segment_matmul``),
on the CPU, against the JAX reference (``repro.kernels.ops.packed_spmm``
with ``use_pallas=False``).

* ``path``: which route a shape takes;
* the transform route's first kernel, ``Y = feat @ W`` on the 3xTF32
  tensor-core tile, emulated in float64 as the tile adds (each operand
  split into TF32 hi + lo, lo.hi + hi.lo + hi.hi an 8-column step, the
  tensor cores' truncating adds, a fresh accumulator each 32-column chunk
  of d added in float32), then the lane-order gather and mean of Y's
  rows: within 1e-5 * (|agg| @ |W|) of the reference at GraphSAGE's
  width, d = 602 and f = 128, while one TF32 rounding of the operands
  misses it.  The emulation's helpers are those of
  ``tests/test_torch_distance_tiles.py``.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro_torch.kernels import segment_matmul as sm
from test_torch_distance_tiles import ONCE, THREE, _dots, _split

torch.set_num_threads(1)


@functools.partial(jax.jit, static_argnames=("combine",))
def _jspmm(nbrs, feat, w, combine):
    return jops.packed_spmm(nbrs, feat, w, combine=combine,
                            use_pallas=False)


@pytest.mark.parametrize("N,M,Nf,d,f,expect", [
    (232_965, 15, 232_965, 602, 128, "transform"),  # GraphSAGE on Reddit
    (16_384, 10, 232_965, 602, 128, "fused"),       # minibatch_lg layer 1
    (20_000, 15, 400_000, 602, 128, "fused"),       # Nf = 20 N
    (232_965, 15, 232_965, 128, 128, "fused"),      # f >= d
    (232_965, 15, 232_965, 64, 256, "fused"),
    (1, 1, 1, 8, 16, "fused")])
def test_path_projects_first_only_where_it_moves_fewer_bytes(N, M, Nf, d, f,
                                                             expect):
    assert sm.path(N, M, Nf, d, f) == expect


def test_route_costs_count_lanes_and_rows():
    """The model ``path`` and the smoke's floors share: by default every
    one of the N * M lanes reads its row from HBM; reading each distinct
    row once moves fewer bytes for the same products."""
    N, M, Nf, d, f = 1000, 15, 1000, 602, 128
    cost = sm.route_costs(N, M, Nf, d, f)
    assert cost == sm.route_costs(N, M, Nf, d, f, lanes=N * M, rows=N * M)
    assert cost["fused"] == [(N * M * (4 + 4 * d) + 4 * d * f + 4 * N * f,
                              2 * N * d * f, sm.FP32_OPS_PER_S)]
    assert [len(cost[r]) for r in sm.ROUTES] == [1, 2]
    floor = sm.route_costs(N, M, Nf, d, f, rows=Nf)
    assert floor["transform"][0] == cost["transform"][0]
    for route in sm.ROUTES:
        assert [p for _, p, _ in floor[route]] == [
            p for _, p, _ in cost[route]]
        assert all(a[0] < b[0] for a, b in zip(floor[route], cost[route])
                   if a != b)
        assert sm.modelled_ms(floor[route]) <= sm.modelled_ms(cost[route])


def test_unknown_route_raises():
    with pytest.raises(ValueError, match="via"):
        sm.packed_spmm(torch.zeros((2, 3), dtype=torch.int32),
                       torch.zeros((5, 4)), torch.zeros((4, 2)), via="tile")


@pytest.mark.parametrize("combine", ["mean", "sum"])
def test_project_tile_3xtf32_holds_the_tolerance(combine):
    """96 feature rows of d = 602 through W [602, 128] (scaled by
    d^-0.5, as the smoke's), 80 output rows of 15 lanes with 10%
    sentinels and some negative ids: the emulated tile's Y, gathered and
    averaged lane by lane in float32, within 1e-5 * (|agg| @ |W|) of the
    reference on every entry; one TF32 rounding of the operands outside
    it."""
    gen = np.random.default_rng(1910 + (combine == "mean"))
    Nf, d, f, N, M = 96, 602, 128, 80, 15
    feat = gen.normal(size=(Nf, d)).astype(np.float32)
    w = (gen.normal(size=(d, f)) * d ** -0.5).astype(np.float32)
    nbrs = gen.integers(-2, Nf, size=(N, M)).astype(np.int32)
    nbrs[gen.random((N, M)) < 0.1] = Nf
    nbrs[7] = Nf                                  # a row with no valid lane
    want = np.asarray(_jspmm(jnp.asarray(nbrs), jnp.asarray(feat),
                             jnp.asarray(w), combine))
    ok = nbrs < Nf
    agg = np.where(ok[..., None], feat[np.clip(nbrs, 0, Nf - 1)], 0.0) \
        .astype(np.float64).sum(1)
    if combine == "mean":
        agg /= np.maximum(ok.sum(1, keepdims=True), 1)
    tol = 1e-5 * (np.abs(agg) @ np.abs(w.astype(np.float64)))
    a = dict(zip(("hi", "lo"), _split(feat)))
    b = dict(zip(("hi", "lo"), _split(np.ascontiguousarray(w.T))))
    for terms, holds in ((THREE, True), (ONCE, False)):
        Y = torch.from_numpy(_dots(a, b, terms, 32))        # [Nf, f]
        got = sm.aggregate(torch.from_numpy(nbrs), Y, combine=combine)
        err = np.abs(got.numpy() - want)
        assert (err <= tol).all() == holds, terms
        assert (got[7] == 0).all()
