"""EmbeddingBag: CUDA kernel wrapper + its plain version.

Replaces the reference's ``kernels/embedding_bag.py::embedding_bag_pallas``.
The kernel is ``csrc/embedding_bag.cu``, with two routes that
:func:`path` chooses before launch, from the shape and the alignment:

* ``"vector"``: 16-byte pieces of each row, a group of lanes a bag,
  several bags a warp, a persistent grid that loads the next bag's ids
  while the current rows are in flight.  It takes a row of a multiple of
  16 bytes (E = 4k in float32, 8k in bfloat16) in a 16-byte aligned table.
* ``"lane"``: one warp a bag, a lane an element; every other row.

Each route has a float32 and a bfloat16 body; the vector route one of
each for every group width (:data:`BODIES`).  The source's header note
gives the bound and the design.

``out[b] = sum_t table[ids[b, t]]`` summed in float32 in the order
t = 0 .. bag-1 from zero (bfloat16 rows widened first), divided by
``bag`` for ``combine="mean"``, and returned in the table's dtype (a
bfloat16 output rounded once), as the reference's kernel returns it.  The
two routes compute the same bits.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block import check, check_dtypes

COMBINES = ("mean", "sum")
ROUTES = ("vector", "lane")
# the vector route's group widths (lanes a bag: the power of two at or
# above the row's 16-byte pieces, at most a warp)
GROUPS = (1, 2, 4, 8, 16, 32)
# the compiled bodies, in csrc/embedding_bag.cu repro_bag_attrs' order
BODIES = ["lane_f32", "lane_bf16"] + [
    f"vector_{t}_g{g}" for t in ("f32", "bf16") for g in GROUPS]
PIECE_BYTES = 16


def embedding_bag_plain(table, ids, *, combine: str = "mean"):
    """The same function in plain PyTorch (any device): table [V, E] x
    ids [B, bag] -> [B, E] in the table's dtype.  Ids are clamped into
    [0, V) as the kernel clamps them (the reference leaves them
    undefined there)."""
    if combine not in COMBINES:
        raise ValueError(f"combine={combine!r}")
    B, bag = ids.shape
    rows = ids.long().clamp(0, table.shape[0] - 1)
    acc = torch.zeros((B, table.shape[1]), dtype=torch.float32,
                      device=table.device)
    for t in range(bag):
        acc = acc + table[rows[:, t]].to(torch.float32)
    if combine == "mean":
        # a true division, as the kernel and the reference divide: PyTorch
        # multiplies by the reciprocal when the divisor is a Python scalar
        acc = acc / torch.full((), bag, dtype=torch.float32,
                               device=acc.device)
    return acc.to(table.dtype)


def path(table, ids) -> str:
    """The route a call takes on the card: ``"vector"`` where a row of the
    table is a whole number of 16-byte pieces and the table starts on a
    16-byte boundary (the output, allocated by the wrapper, always does),
    else ``"lane"``."""
    row = table.shape[1] * table.element_size()
    if row % PIECE_BYTES == 0 and table.data_ptr() % PIECE_BYTES == 0:
        return "vector"
    return "lane"


def group(E: int, dtype) -> int:
    """Lanes a bag in the vector route: the power of two at or above the
    row's 16-byte pieces, at most 32."""
    pieces = E * torch.empty((), dtype=dtype).element_size() // PIECE_BYTES
    return next(g for g in GROUPS if g >= pieces or g == GROUPS[-1])


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, its entry point typed once."""
    lib = _build.library("embedding_bag")
    lib.repro_embedding_bag.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 2 + [ctypes.c_longlong] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    lib.repro_embedding_bag.restype = ctypes.c_int
    return lib


def body_attributes() -> dict:
    """Registers and spilled (local) bytes a thread of each compiled body
    of :data:`BODIES`, as the card reports them."""
    return _build.body_attributes("embedding_bag", "repro_bag_attrs",
                                  BODIES)


def embedding_bag(table, ids, *, combine: str = "mean",
                  via: str | None = None):
    """table [V, E] float32 or bfloat16 x ids [B, bag] int32 -> [B, E] in
    the table's dtype.  CPU tensors take :func:`embedding_bag_plain`; CUDA
    tensors launch the route :func:`path` picks, in the body for the
    table's dtype (counted on ``embedding_bag``).  ``via`` forces a
    route, to hold one to the other; ``"vector"`` on a table it cannot
    read raises."""
    if via not in (None, *ROUTES):
        raise ValueError(f"via: 'vector' or 'lane', got {via!r}")
    check_dtypes(table=table)
    if table.device.type == "cpu":
        return embedding_bag_plain(table, ids, combine=combine)
    if combine not in COMBINES:
        raise ValueError(f"combine={combine!r}")
    dev = table.device
    check(table, "table", table.dtype, (None, None), dev)
    check(ids, "ids", torch.int32, (None, None), dev)
    (V, E), (B, bag) = table.shape, ids.shape
    if V == 0 and B * bag > 0:
        raise ValueError("an empty table has no rows to look up")
    route = path(table, ids)
    if via == "vector" and route != "vector":
        raise ValueError("via='vector' needs rows of a multiple of 16 bytes "
                         "in a 16-byte aligned table")
    route = via or route
    out = torch.empty((B, E), dtype=table.dtype, device=dev)
    err = _lib().repro_embedding_bag(
        _build.ptr(table), _build.ptr(ids), _build.ptr(out), B, bag, V, E,
        int(combine == "mean"), int(table.dtype == torch.bfloat16),
        int(route == "vector"), _build.stream_of(table))
    _build.check(err, "embedding_bag")
    _build.count("embedding_bag")
    return out
