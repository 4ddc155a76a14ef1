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

The gradient.  On CUDA tensors, where grad mode is on and the table
needs a gradient, :func:`embedding_bag` is an autograd ``Function`` (it
saves the ids only): its backward, :func:`embedding_bag_bwd`, launches
``csrc/embedding_bag_bwd.cu``, ``dtable[v] = sum over (b, t) with
clamp(ids[b, t]) = v, in (b, t) order, of dout[b] / bag`` (``/ 1`` for
"sum"), dense [V, E] float32 as the reference's autodiff of ``jnp.take``
gives it.  One entry call: the lookups sorted by row with a stable LSD
radix sort written for the card (``kernels/lane_groups.py``: 3 passes of
8-bit digits at V = 10^7, each O(the lookups)), the runs of equal rows, a
group of lanes a distinct row summing its lookups in (b, t) order, then a
store-only pass of zeros over the rows no lookup reads.  No float atomics
(a repeat is bit for bit; a hot row is one run of the sort, not a queue
of atomics), and no scratch the size of the table.  It replaces no TPU
kernel (the reference differentiates its plain path).
Its plain version is :func:`embedding_bag_bwd_plain`.  A bfloat16 table
refuses the backward (the reference trains in float32).  On CPU tensors
:func:`embedding_bag` is :func:`embedding_bag_plain`, differentiated by
autograd.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block import check, check_dtypes
from repro_torch.kernels.lane_groups import Groups

COMBINES = ("mean", "sum")
ROUTES = ("vector", "lane")
# the vector route's group widths (lanes a bag: the power of two at or
# above the row's 16-byte pieces, at most a warp)
GROUPS = (1, 2, 4, 8, 16, 32)
# the compiled bodies, in csrc/embedding_bag.cu repro_bag_attrs' order
BODIES = ["lane_f32", "lane_bf16"] + [
    f"vector_{t}_g{g}" for t in ("f32", "bf16") for g in GROUPS]
PIECE_BYTES = 16
# the gradient's compiled bodies, in csrc/embedding_bag_bwd.cu
# repro_bag_bwd_attrs' order
BWD_BODIES = ["radix_totals_ids", "radix_totals_pairs",
              "radix_onesweep_ids", "radix_onesweep_pairs", "scan_top",
              "runs_count", "runs_write", "group_sum_vec8",
              "group_sum_vec32", "group_sum_scalar", "zero_unread_vec",
              "zero_unread_scalar"]


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


def embedding_bag_bwd_plain(ids, dout, num_rows: int, *,
                            combine: str = "mean"):
    """The backward kernel's function in plain PyTorch (any device): the
    table's gradient [num_rows, E] for the output's gradient ``dout``
    [B, E]: each term ``dout[b] / bag`` (a true division; none for
    "sum"), summed by ``index_add_`` over the lookups in (b, t) order
    (sequential on the CPU) from zero, ids clamped as the forward clamps
    them.  Float64 ``dout`` computes in float64, other in float32."""
    if combine not in COMBINES:
        raise ValueError(f"combine={combine!r}")
    ct = torch.float64 if dout.dtype == torch.float64 else torch.float32
    B, bag = ids.shape
    terms = dout.to(ct)
    if combine == "mean":
        terms = terms / torch.full((), bag, dtype=ct, device=terms.device)
    rows = ids.long().clamp(0, num_rows - 1).reshape(-1)
    out = torch.zeros((num_rows, dout.shape[1]), dtype=ct,
                      device=dout.device)
    return out.index_add_(0, rows, terms.repeat_interleave(bag, dim=0))


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


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The gradient's built library, its entry point typed once."""
    lib = _build.library("embedding_bag_bwd")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_bag_bwd_scratch.argtypes = [ll, ll]
    lib.repro_bag_bwd_scratch.restype = ll
    lib.repro_bag_groups.argtypes = [p] * 7 + [i, i, ll, p]
    lib.repro_bag_groups.restype = i
    lib.repro_embedding_bag_bwd.argtypes = [p] * 9 + [i, i, ll, i, i, p]
    lib.repro_embedding_bag_bwd.restype = i
    return lib


def bwd_body_attributes() -> dict:
    """Registers and spilled bytes a thread of each compiled body of the
    gradient (:data:`BWD_BODIES`), as the card reports them."""
    return _build.body_attributes("embedding_bag_bwd", "repro_bag_bwd_attrs",
                                  BWD_BODIES)


def embedding_bag(table, ids, *, combine: str = "mean",
                  via: str | None = None):
    """table [V, E] float32 or bfloat16 x ids [B, bag] int32 -> [B, E] in
    the table's dtype.  CPU tensors take :func:`embedding_bag_plain`; CUDA
    tensors launch the route :func:`path` picks, in the body for the
    table's dtype (counted on ``embedding_bag``), and where grad mode is
    on and the table needs a gradient, through an autograd ``Function``
    whose backward is :func:`embedding_bag_bwd`.  ``via`` forces a
    route, to hold one to the other; ``"vector"`` on a table it cannot
    read raises."""
    if via not in (None, *ROUTES):
        raise ValueError(f"via: 'vector' or 'lane', got {via!r}")
    check_dtypes(table=table)
    if table.device.type == "cpu":
        return embedding_bag_plain(table, ids, combine=combine)
    if torch.is_grad_enabled() and table.requires_grad:
        return _Bag.apply(table, ids, combine, via)
    return _forward(table, ids, combine, via)


def _forward(table, ids, combine: str, via):
    """The forward's launch on CUDA tensors."""
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


class _Bag(torch.autograd.Function):
    """The kernel's forward, saving the ids; its backward launches
    :func:`embedding_bag_bwd`."""

    @staticmethod
    def forward(ctx, table, ids, combine, via):
        if table.dtype != torch.float32:
            raise ValueError("embedding_bag's backward takes a float32 "
                             "table (the reference trains in float32)")
        ctx.save_for_backward(ids)
        ctx.num_rows, ctx.combine = table.shape[0], combine
        return _forward(table, ids, combine, via)

    @staticmethod
    def backward(ctx, dout):
        ids, = ctx.saved_tensors
        dtable = embedding_bag_bwd(ids, dout.contiguous(), ctx.num_rows,
                                   combine=ctx.combine)
        return dtable, None, None, None


def _check_ids(ids, num_rows: int) -> None:
    if ids.shape[0] * ids.shape[1] >= 2 ** 31 or num_rows >= 2 ** 31:
        raise ValueError("the backward takes fewer than 2^31 lookups and "
                         "table rows")
    if num_rows == 0 and ids.numel() > 0:
        raise ValueError("an empty table has no rows to look up")


def _scratch(ids, num_rows: int):
    return torch.empty(_bwd_lib().repro_bag_bwd_scratch(ids.numel(),
                                                        max(num_rows, 1)),
                       dtype=torch.int32, device=ids.device)


def bag_groups(ids, num_rows: int) -> Groups:
    """The card's grouping of ids [B, bag] int32 (CUDA) over a table of
    ``num_rows`` rows, the first half of :func:`embedding_bag_bwd`'s
    launches (counted on ``embedding_bag_bwd``): the lookups sorted by
    their clamped row, stably, and the runs.  Its integers are
    ``lane_groups_plain(ids.clamp(0, num_rows - 1), num_rows)``'s lanes,
    rows and starts."""
    check(ids, "ids", torch.int32, (None, None), ids.device)
    _check_ids(ids, num_rows)
    if num_rows == 0:
        raise ValueError("an empty table has no rows to group by")
    B, bag = ids.shape
    g = Groups(B * bag, None, ids.device)
    scratch = _scratch(ids, num_rows)
    err = _bwd_lib().repro_bag_groups(
        _build.ptr(ids), _build.ptr(g.lanes), _build.ptr(g.rows),
        _build.ptr(g.starts), _build.ptr(g.firsts), _build.ptr(g.meta),
        _build.ptr(scratch), B, bag, num_rows, _build.stream_of(ids))
    _build.check(err, "embedding_bag_bwd groups")
    _build.count("embedding_bag_bwd")
    return g


def embedding_bag_bwd(ids, dout, num_rows: int, *, combine: str = "mean"):
    """The gradient of :func:`embedding_bag` with respect to the table
    [num_rows, E] for the output's gradient ``dout`` [B, E] float32:
    ``dtable`` [num_rows, E] float32, dense.  CPU tensors take
    :func:`embedding_bag_bwd_plain`; CUDA tensors launch the grouping, the
    sum over the distinct rows and the zeros (one entry, counted once on
    ``embedding_bag_bwd``)."""
    if dout.device.type == "cpu":
        return embedding_bag_bwd_plain(ids, dout, num_rows, combine=combine)
    if combine not in COMBINES:
        raise ValueError(f"combine={combine!r}")
    dev = dout.device
    check(dout, "dout", torch.float32, (None, None), dev)
    check(ids, "ids", torch.int32, (dout.shape[0], None), dev)
    (B, E), bag = dout.shape, ids.shape[1]
    _check_ids(ids, num_rows)
    dtable = torch.empty((num_rows, E), dtype=torch.float32, device=dev)
    g = Groups(B * bag, None, dev)
    scratch = _scratch(ids, num_rows)
    err = _bwd_lib().repro_embedding_bag_bwd(
        _build.ptr(dout), _build.ptr(ids), _build.ptr(dtable),
        _build.ptr(g.lanes), _build.ptr(g.rows), _build.ptr(g.starts),
        _build.ptr(g.firsts), _build.ptr(g.meta), _build.ptr(scratch), B,
        bag, num_rows, E,
        int(combine == "mean"), _build.stream_of(dout))
    _build.check(err, "embedding_bag_bwd")
    _build.count("embedding_bag_bwd")
    return dtable
