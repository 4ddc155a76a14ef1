"""The order resolution of the port's visited-filter kernel, on the CPU.

``csrc/visited.cu`` gives a row's lanes to one warp, 32 at a time, and
probes them all at once: each lane loads its whole bucket from the table
as the previous chunk left it.  The strict lane order of the definition
(lane m sees every insertion of lanes < m) is then resolved in registers.
Lanes on one bucket form a group; a lane whose id a lower lane of the
group holds is never fresh; a first occurrence is a hit if the loaded
bucket holds its id, and otherwise the k-th miss of its group (k counted
over lower lanes) is fresh if the bucket had more than k empty ways and
takes the k-th empty one.  The kernel runs only on the card
(``tests/test_torch_cuda.py``); here that resolution is emulated in numpy,
a chunk of 32 lanes at once, and held bit for bit to ``visited_filter_plain``, which
probes one lane at a time, on tables of 2 to 64 buckets where lanes
collide, buckets fill and ids repeat inside and across calls.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import visited

# the plain filter is small here: one thread, so the test workers running
# beside this file keep their cores
torch.set_num_threads(1)

WARP = 32


def warp_filter(table, ids, valid):
    """The kernel's algorithm: table [B, S, W] int32 (updated in place),
    ids [B, M] int32, valid [B, M] bool -> fresh [B, M] bool."""
    B, S, W = table.shape
    M = ids.shape[1]
    shift = visited.shift_for(S)
    fresh = np.zeros((B, M), dtype=bool)
    rows = np.arange(B)[:, None]
    for m0 in range(0, M, WARP):
        lid = ids[:, m0:m0 + WARP]
        lval = valid[:, m0:m0 + WARP]
        n = lid.shape[1]
        bucket = ((lid.astype(np.int64) * 0x9E3779B9) & 0xFFFFFFFF) >> shift
        w = table[rows, bucket]                  # [B, n, W], all at once
        below = np.tril(np.ones((n, n), dtype=bool), -1)   # [lane, lower]
        grp = lval[:, :, None] & lval[:, None, :] \
            & (bucket[:, :, None] == bucket[:, None, :])
        same = grp & (lid[:, :, None] == lid[:, None, :])
        first = lval & ~(same & below).any(axis=2)
        hit = (w == lid[:, :, None]).any(axis=2)
        empty = w == visited.VF_EMPTY
        miss = first & ~hit
        rank = (grp & below & miss[:, None, :]).sum(axis=2)
        f = miss & (rank < empty.sum(axis=2))
        nth = np.cumsum(empty, axis=2) - 1       # index among the empties
        slot = np.argmax(empty & (nth == rank[:, :, None]), axis=2)
        r, c = np.nonzero(f)
        table[r, bucket[r, c], slot[r, c]] = lid[r, c]
        fresh[:, m0:m0 + n] = f
    return fresh


def prefill(rng, B, S, W):
    """A table whose buckets hold 0 to W ids each, in way order, so that
    some are full from the start: ids made to hash to their bucket (the
    hash's multiplier is odd, so it has an inverse mod 2^32)."""
    shift = visited.shift_for(S)
    inv = pow(0x9E3779B9, -1, 1 << 32)
    fill = rng.integers(0, W + 1, size=(B, S))
    low = rng.integers(0, 1 << shift, size=(B, S, W))
    h = (np.arange(S)[None, :, None] << shift) | low
    ids = ((h * inv) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)
    return np.where(np.arange(W) < fill[:, :, None], ids,
                    visited.VF_EMPTY).astype(np.int32)


@pytest.mark.parametrize("M", [1, 7, 32, 33, 128])
@pytest.mark.parametrize("S,W", [(2, 8), (4, 8), (16, 8), (64, 8), (8, 3)])
def test_warp_resolution_matches_plain(M, S, W):
    rng = np.random.default_rng(M * 131 + S * 7 + W)
    B = 24
    t_warp = prefill(rng, B, S, W)
    held = t_warp != visited.VF_EMPTY
    home = visited.hash_bucket(torch.from_numpy(t_warp), visited.shift_for(S))
    assert (home.numpy() == np.arange(S)[:, None])[held].all()
    t_plain = torch.from_numpy(t_warp.copy())
    drops = 0
    for call in range(5):
        # few distinct ids per bucket (hits, shared buckets, full buckets),
        # a few -1 ids (they equal EMPTY), repeats inside and across calls
        ids = rng.integers(-1, 6 * S, size=(B, M)).astype(np.int32)
        ids[:, M // 2:] = ids[:, :M - M // 2][:, ::-1]
        valid = rng.random((B, M)) > 0.15
        f_warp = warp_filter(t_warp, ids, valid)
        _, f_plain = visited.visited_filter_plain(
            t_plain, torch.from_numpy(ids), torch.from_numpy(valid))
        assert np.array_equal(f_warp, f_plain.numpy()), (call, M, S)
        assert np.array_equal(t_warp, t_plain.numpy()), (call, M, S)
        # valid lanes whose id is neither fresh nor in the table: drops
        held = (t_warp[:, None, :, :] == ids[:, :, None, None]).any((2, 3))
        drops += int((valid & ~f_warp & ~held).sum())
    assert drops > 0   # the run reached full buckets, not only inserts
