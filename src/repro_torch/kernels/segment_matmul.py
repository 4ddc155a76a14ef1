"""Packed SpMM (fixed-degree neighbour aggregation, then a product with
W): CUDA kernel wrappers + their plain versions.

Replaces the reference's ``kernels/segment_matmul.py::packed_spmm_pallas``.
The kernels are ``csrc/segment_matmul.cu``, two routes chosen by
:func:`path` from the shapes alone; its header note gives both designs:

* ``"fused"``: one kernel gathers feat's rows, sums (or averages) them
  and multiplies the aggregate by W in fp32 FFMA.  One launch.
* ``"transform"``: ``Y = feat @ W`` on a 3xTF32 tensor-core tile
  (:func:`project`), then the gather and mean over Y's rows
  (:func:`gather_rows`).  Two launches.

The product is linear, so both compute the same function.  :func:`path`
models each launch as max(bytes / 3.35 TB/s, products / rate) and takes
the route with the smaller sum, counting all N * M lanes (the sentinels
are not known without reading ``neighbors``):

* fused: N M (4 + 4 d) bytes of ids and rows once per 128-column tile of
  the output, + 4 d f + 4 N f; 2 N d f products at 67 TFLOP/s (fp32);
* transform: 4 Nf d (per 128-column tile) + 4 d f + 4 Nf f bytes and
  3 x 2 Nf d f products issued at mma.sync's ~313 TFLOP/s, then
  N M (4 + 4 f) + 4 N f bytes.

Projecting first reads fewer bytes a lane only when f < d, so f >= d is
always "fused"; below it the model prefers "transform" while Nf is not
much larger than N (GraphSAGE over the whole graph) and "fused" for a
minibatch over a large table.

``out[i] = agg[i] @ W`` with ``agg[i]`` the float32 sum of
``feat[nbrs[i, t]]`` over the lanes whose id is below ``Nf``
(``feat.shape[0]``), in the order t = 0 .. M-1, divided by
``max(cnt_i, 1)`` for ``combine="mean"``.  A negative id reads row 0 and
counts, as the reference's plain path clips it.  Both routes sum in that
lane order in float32: "fused" feat's rows, then the product; "transform"
the rows of Y = feat @ W.  feat and W are each float32 or bfloat16
(widened to float32, the reference's ``.astype(float32)``: feat's rows as
the kernels read them, a bfloat16 W once by the wrapper), and the output takes feat's dtype, a bfloat16 one
rounded once: the transform route keeps Y in float32.  :func:`path`
prices float32 rows whatever the dtype.

The gradient.  On CUDA tensors that need one, :func:`packed_spmm` is an
autograd ``Function`` (under ``no_grad``, or with neither feat nor w
needing a gradient, nothing is saved): its forward is the kernel above
and saves neighbors, feat and w; its backward, :func:`packed_spmm_bwd`,
computes ``dfeat[j] = sum over valid lanes (i, t) reading row j, in
(i, t) order, of (dout[i] @ w^T) / c_i`` (c_i = 1 for "sum", max(count_i,
1) for "mean") and ``dw = agg^T @ dout``, with no gradient for
neighbors, in float32, over the active rows only (those with a valid
lane; at minibatch_lg 16,384 of 169,984).  It rests on a
:class:`SpmmPlan`, the grouping of one neighbour matrix
(``kernels/lane_groups.py``), built on the card at first need by
``csrc/segment_matmul_bwd.cu`` (the valid lanes compacted, each row's
count and the active rows, then a stable LSD radix sort of the lanes by
the row they read, and the runs of distinct rows): GraphSAGE's forward
makes one a batch and both layers' backward share it.  Then, a call: the
projection's 3xTF32 tile for ``dout[active] @ w^T``, each distinct feat
row's terms summed in lane order (a group of lanes takes the rows that
start in a block of sorted lanes) and a store-only pass of zeros over the
rows no lane reads, the forward's gather for the active rows' agg, and dW
as a tile a split of the active rows and an ordered sum of the splits.  No float atomics: a repeat is bit for bit.  It replaces no
TPU kernel (the reference differentiates its plain path).  Its plain
version is :func:`packed_spmm_bwd_plain`.  On CPU tensors
:func:`packed_spmm` is :func:`packed_spmm_plain`, differentiated by
autograd, and a plan is ignored.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block import FLOAT_DTYPES, check, check_dtypes
from repro_torch.kernels.lane_groups import (META_ACTIVE, Groups,
                                             lane_groups_plain)

COMBINES = ("mean", "sum")
ROUTES = ("fused", "transform")
# the fused kernel stages a tile's neighbour ids in shared memory: 64 x M
MAX_DEGREE = 512
# the compiled bodies, in csrc/segment_matmul.cu repro_spmm_attrs' order:
# the projection's by the cp.async pieces (bytes) of feat's and W's rows,
# 2 for a bfloat16 feat read element by element
PROJECT_BODIES = ["project_a16_w16", "project_a8_w16", "project_a4_w4",
                  "project_a2_w16", "project_a2_w4"]
BODIES = ["fused", "fused_bf16", *PROJECT_BODIES, "gather_vec",
          "gather_scalar", "copy_rows_vec", "copy_rows_scalar"]
# the gradient's compiled bodies, in csrc/segment_matmul_bwd.cu
# repro_spmm_bwd_attrs' order
BWD_BODIES = ["compact_count", "compact_write", "radix_totals",
              "radix_onesweep", "scan_top", "runs_count", "runs_write",
              "group_sum_vec8", "group_sum_vec32", "group_sum_scalar",
              "zero_unread_vec", "zero_unread_scalar", "dw_partial",
              "dw_reduce"]
DW_MAX_SPLITS = 128              # splits of the rows for dW
DW_SPLIT_ROWS = 1024             # rows a split at least
DW_PART_FLOATS = 1 << 24         # the splits' partial sums at most
HBM_BYTES_PER_S = 3.35e12       # H100 SXM
FP32_OPS_PER_S = 67e12          # fp32 FFMA, outside the tensor cores
MMA_TF32_OPS_PER_S = 313e12     # mma.sync's TF32 ceiling (PERF.md)
TILE_COLS = 128                 # output columns a CTA of every kernel


def route_costs(N: int, M: int, Nf: int, d: int, f: int, *,
                lanes: int | None = None, rows: int | None = None,
                elem: int = 4) -> dict:
    """Each route's launches under the module note's model, as
    ``{route: [(bytes, products, products a second), ...]}``.  ``lanes``
    counts the lanes gathered (all N * M by default: :func:`path` does not
    read ``neighbors``) and ``rows`` the rows of feat or Y a gather reads
    from HBM (by default one a lane, none found in L2); ``elem`` is the
    bytes of an element of feat and of the output (Y is float32)."""
    lanes = N * M if lanes is None else lanes
    rows = lanes if rows is None else rows
    tiles = -(-f // TILE_COLS)
    ids = tiles * N * M * 4
    return {
        "fused": [(ids + tiles * rows * elem * d + 4 * d * f + elem * N * f,
                   2 * N * d * f, FP32_OPS_PER_S)],
        "transform": [(tiles * elem * Nf * d + 4 * d * f + 4 * Nf * f,
                       6 * Nf * d * f, MMA_TF32_OPS_PER_S),
                      (ids + rows * 4 * f + elem * N * f, lanes * f,
                       FP32_OPS_PER_S)]}


def modelled_ms(launches) -> float:
    """The modelled device time of launches from :func:`route_costs`: the
    sum of max(bytes / 3.35 TB/s, products / rate), in ms."""
    return sum(max(b / HBM_BYTES_PER_S, p / rate)
               for b, p, rate in launches) * 1e3


def path(N: int, M: int, Nf: int, d: int, f: int) -> str:
    """The route of a call (see the module note): ``"fused"`` for f >= d,
    else the route with the smaller modelled device time."""
    if f >= d:
        return "fused"
    cost = route_costs(N, M, Nf, d, f)
    return ("transform" if modelled_ms(cost["transform"])
            < modelled_ms(cost["fused"]) else "fused")


def aggregate(neighbors, feat, *, combine: str = "sum",
              dtype=torch.float32):
    """``agg`` [N, d] in ``dtype`` (float32 by default; plain PyTorch, any
    device): the reference's plain path (``ops.packed_spmm(use_pallas=
    False)``) before its ``@ w``, summed lane by lane in order."""
    if combine not in COMBINES:
        raise ValueError(f"combine={combine!r}")
    Nf = feat.shape[0]
    ok = neighbors < Nf
    rows = neighbors.long().clamp(0, Nf - 1)
    agg = torch.zeros((neighbors.shape[0], feat.shape[1]),
                      dtype=dtype, device=feat.device)
    for t in range(neighbors.shape[1]):
        agg = agg + torch.where(ok[:, t, None],
                                feat[rows[:, t]].to(dtype), 0.0)
    if combine == "mean":
        agg = agg / torch.clamp(ok.sum(1, keepdim=True), min=1)
    return agg


def packed_spmm_plain(neighbors, feat, w, *, combine: str = "sum"):
    """The same function in plain PyTorch (any device): neighbors [N, M]
    x feat [Nf, d] x w [d, f] -> [N, f] in feat's dtype."""
    return (aggregate(neighbors, feat, combine=combine)
            @ w.to(torch.float32)).to(feat.dtype)


def transform_plain(neighbors, feat, w, *, combine: str = "sum"):
    """The transform route's arithmetic in plain PyTorch (any device):
    ``feat @ w`` in float32, then the lane-order gather and mean of its
    rows -> [N, f] float32."""
    return aggregate(neighbors, feat.to(torch.float32) @ w.to(torch.float32),
                     combine=combine)


def packed_spmm_bwd_plain(neighbors, feat, w, dout, *,
                          combine: str = "sum"):
    """The backward kernel's function in plain PyTorch (any device):
    ``(dfeat [Nf, d], dw [d, f])`` for the output's gradient ``dout``
    [N, f].  ``g = dout @ w^T``, divided row by row by max(count_i, 1)
    for "mean", summed into dfeat by ``index_add_`` over the valid lanes
    in (i, t) order (sequential on the CPU); ``dw = agg^T @ dout``.
    Float64 inputs compute in float64, others in float32 (both results
    float32 then)."""
    if combine not in COMBINES:
        raise ValueError(f"combine={combine!r}")
    ct = torch.float64 if feat.dtype == torch.float64 else torch.float32
    N, M = neighbors.shape
    Nf = feat.shape[0]
    ok = neighbors < Nf
    g = dout.to(ct) @ w.to(ct).T
    if combine == "mean":
        g = g / torch.clamp(ok.sum(1, keepdim=True), min=1).to(ct)
    lanes = torch.arange(N, device=g.device)[:, None].expand(N, M)[ok]
    dfeat = torch.zeros((Nf, feat.shape[1]), dtype=ct, device=g.device)
    dfeat.index_add_(0, neighbors.long().clamp(min=0)[ok], g[lanes])
    dw = aggregate(neighbors, feat, combine=combine, dtype=ct).T \
        @ dout.to(ct)
    return dfeat, dw


def dw_splits(N: int, d: int, f: int) -> int:
    """Splits of the N rows for dW's tile: one per ``DW_SPLIT_ROWS`` rows,
    at most ``DW_MAX_SPLITS``, their partials at most ``DW_PART_FLOATS``
    floats."""
    return max(1, min(DW_MAX_SPLITS, -(-N // DW_SPLIT_ROWS),
                      DW_PART_FLOATS // max(1, d * f)))


@functools.cache
def _lib():
    """The built library, its C entry points typed once."""
    lib = _build.library("segment_matmul")
    lib.repro_spmm_fused.argtypes = [ctypes.c_void_p] * 4 + [
        ctypes.c_int] * 7 + [ctypes.c_void_p]
    lib.repro_spmm_project.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    lib.repro_spmm_gather.argtypes = [ctypes.c_void_p] * 3 + [
        ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.repro_spmm_project_rows.argtypes = [ctypes.c_void_p] * 6 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    lib.repro_spmm_gather_rows.argtypes = [ctypes.c_void_p] * 5 + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    for fn in (lib.repro_spmm_fused, lib.repro_spmm_project,
               lib.repro_spmm_gather, lib.repro_spmm_project_rows,
               lib.repro_spmm_gather_rows):
        fn.restype = ctypes.c_int
    return lib


def body_attributes() -> dict:
    """Registers and spilled (local) bytes a thread of each compiled body
    of :data:`BODIES`, as the card reports them."""
    return _build.body_attributes("segment_matmul", "repro_spmm_attrs",
                                  BODIES)


@functools.cache
def _bwd_lib():
    """The gradient's built library, its entry points typed once."""
    lib = _build.library("segment_matmul_bwd")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.repro_spmm_plan_scratch.argtypes = [i] * 3
    lib.repro_spmm_plan_scratch.restype = ctypes.c_longlong
    lib.repro_spmm_plan.argtypes = [p] * 10 + [i] * 3 + [p]
    lib.repro_spmm_bwd_dfeat.argtypes = [p] * 9 + [i] * 5 + [p]
    lib.repro_spmm_bwd_dw.argtypes = [p] * 6 + [i] * 3 + [p]
    for fn in (lib.repro_spmm_plan, lib.repro_spmm_bwd_dfeat,
               lib.repro_spmm_bwd_dw):
        fn.restype = i
    return lib


def bwd_body_attributes() -> dict:
    """Registers and spilled bytes a thread of each compiled body of the
    gradient (:data:`BWD_BODIES`), as the card reports them."""
    return _build.body_attributes("segment_matmul_bwd",
                                  "repro_spmm_bwd_attrs", BWD_BODIES)


def _bf16(t) -> int:
    return int(t.dtype == torch.bfloat16)


def project(feat, w, *, out_dtype=None):
    """feat [Nf, d] x w [d, f], each float32 or bfloat16 -> [Nf, f] in
    ``out_dtype`` (feat's dtype by default), the product in float32: the
    transform route's first kernel (which asks for float32).  CPU tensors
    take ``feat @ w`` in float32; CUDA tensors launch the 3xTF32 tile on
    w widened to float32 (counted on ``packed_spmm``)."""
    check_dtypes(feat=feat, w=w)
    out_dtype = feat.dtype if out_dtype is None else out_dtype
    if out_dtype not in FLOAT_DTYPES:
        raise ValueError(f"out_dtype: float32 or bfloat16, got {out_dtype}")
    if feat.device.type == "cpu":
        return (feat.to(torch.float32) @ w.to(torch.float32)).to(out_dtype)
    dev = feat.device
    check(feat, "feat", feat.dtype, (None, None), dev)
    Nf, d = feat.shape
    check(w, "w", w.dtype, (d, None), dev)
    w = w.to(torch.float32)
    f = w.shape[1]
    y = torch.empty((Nf, f), dtype=out_dtype, device=dev)
    err = _lib().repro_spmm_project(_build.ptr(feat), _build.ptr(w),
                                    _build.ptr(y), Nf, d, f, _bf16(feat),
                                    _bf16(y),
                                    _build.stream_of(feat))
    _build.check(err, "packed_spmm project")
    _build.count("packed_spmm")
    return y


def gather_rows(neighbors, y, *, combine: str = "sum",
                out_dtype=torch.float32):
    """neighbors [N, M] int32 over y [Nf, f] float32 -> [N, f] in
    ``out_dtype`` (float32 or bfloat16, rounded once), :func:`aggregate`
    of y's rows, the transform route's second kernel.  CPU tensors take
    :func:`aggregate`; CUDA tensors launch the gather (counted on
    ``packed_spmm``)."""
    if out_dtype not in FLOAT_DTYPES:
        raise ValueError(f"out_dtype: float32 or bfloat16, got {out_dtype}")
    if y.device.type == "cpu":
        return aggregate(neighbors, y, combine=combine).to(out_dtype)
    if combine not in COMBINES:
        raise ValueError(f"combine={combine!r}")
    dev = y.device
    check(y, "y", torch.float32, (None, None), dev)
    check(neighbors, "neighbors", torch.int32, (None, None), dev)
    (N, M), (Nf, f) = neighbors.shape, y.shape
    if Nf == 0 and N * M > 0:
        raise ValueError("y has no rows to gather")
    out = torch.empty((N, f), dtype=out_dtype, device=dev)
    err = _lib().repro_spmm_gather(_build.ptr(neighbors), _build.ptr(y),
                                   _build.ptr(out), N, M, Nf, f,
                                   int(combine == "mean"), _bf16(out),
                                   _build.stream_of(y))
    _build.check(err, "packed_spmm gather")
    _build.count("packed_spmm")
    return out


def packed_spmm(neighbors, feat, w, *, combine: str = "sum",
                via: str | None = None, plan: "SpmmPlan | None" = None):
    """neighbors [N, M] int32 x feat [Nf, d] x w [d, f], feat and w each
    float32 or bfloat16 -> [N, f] in feat's dtype.  CPU tensors take
    :func:`packed_spmm_plain`; CUDA tensors launch the route :func:`path`
    picks ("fused": one launch, "transform": two, each counted on
    ``packed_spmm``), and where grad mode is on and feat or w needs a
    gradient, through an autograd ``Function`` whose backward is
    :func:`packed_spmm_bwd` on ``plan`` (a :class:`SpmmPlan` of
    neighbors over Nf rows, shared by every call on them; without one the
    backward builds its own).  ``via`` forces a route, to hold it to
    shapes it would not take."""
    if via not in (None, *ROUTES):
        raise ValueError(f"via: 'fused' or 'transform', got {via!r}")
    check_dtypes(feat=feat, w=w)
    if feat.device.type == "cpu":
        return packed_spmm_plain(neighbors, feat, w, combine=combine)
    if torch.is_grad_enabled() and (feat.requires_grad or w.requires_grad):
        return _SpMM.apply(neighbors, feat, w, combine, via, plan)
    return _forward(neighbors, feat, w, combine, via)


def _forward(neighbors, feat, w, combine: str, via):
    """The forward's launches on CUDA tensors."""
    if combine not in COMBINES:
        raise ValueError(f"combine={combine!r}")
    dev = feat.device
    check(feat, "feat", feat.dtype, (None, None), dev)
    Nf, d = feat.shape
    check(neighbors, "neighbors", torch.int32, (None, None), dev)
    check(w, "w", w.dtype, (d, None), dev)
    (N, M), f = neighbors.shape, w.shape[1]
    if Nf == 0 and N * M > 0:
        raise ValueError("feat has no rows to gather")
    route = via or path(N, M, Nf, d, f)
    if route == "transform":
        return gather_rows(neighbors,
                           project(feat, w, out_dtype=torch.float32),
                           combine=combine, out_dtype=feat.dtype)
    if M > MAX_DEGREE:
        raise ValueError(f"degree M={M} exceeds the fused kernel's "
                         f"{MAX_DEGREE}")
    out = torch.empty((N, f), dtype=feat.dtype, device=dev)
    w = w.to(torch.float32)
    err = _lib().repro_spmm_fused(_build.ptr(neighbors), _build.ptr(feat),
                                  _build.ptr(w), _build.ptr(out), N, M, Nf,
                                  d, f, int(combine == "mean"), _bf16(feat),
                                  _build.stream_of(feat))
    _build.check(err, "packed_spmm")
    _build.count("packed_spmm")
    return out


class _SpMM(torch.autograd.Function):
    """The kernel's forward, saving neighbors, feat, w and the plan; its
    backward launches :func:`packed_spmm_bwd` on that plan."""

    @staticmethod
    def forward(ctx, neighbors, feat, w, combine, via, plan):
        ctx.save_for_backward(neighbors, feat, w)
        ctx.combine, ctx.plan = combine, plan
        return _forward(neighbors, feat, w, combine, via)

    @staticmethod
    def backward(ctx, dout):
        neighbors, feat, w = ctx.saved_tensors
        dfeat, dw = packed_spmm_bwd(
            neighbors, feat, w, dout.contiguous(), combine=ctx.combine,
            need_feat=ctx.needs_input_grad[1],
            need_w=ctx.needs_input_grad[2], plan=ctx.plan)
        return None, dfeat, dw, None, None, None


class SpmmPlan:
    """The grouping of one neighbour matrix ``neighbors`` [N, M] int32
    over a feat of ``num_rows`` rows (``kernels/lane_groups.py``), for
    every :func:`packed_spmm_bwd` on it: each row's valid lanes, the
    active rows, the valid lanes sorted by the row they read and the runs
    of distinct rows.  Made for a batch and dropped with it (no cache);
    :meth:`build` launches it on the card at first need (one entry,
    counted on ``packed_spmm_bwd``).  On CPU tensors nothing is built: the
    plain path needs no plan."""

    def __init__(self, neighbors, num_rows: int):
        self.neighbors, self.num_rows = neighbors, int(num_rows)
        self.groups: Groups | None = None

    def targets(self):
        """The row each lane reads, -1 for none: the plain version's
        input."""
        nbrs = self.neighbors
        return torch.where(nbrs < self.num_rows, nbrs.long().clamp(min=0),
                           -1)

    def matches(self, neighbors, num_rows: int) -> bool:
        """Whether this plan was made for ``neighbors`` (the same tensor's
        memory and shape) over ``num_rows`` rows."""
        n = self.neighbors
        return (num_rows == self.num_rows and n.device == neighbors.device
                and n.shape == neighbors.shape
                and n.data_ptr() == neighbors.data_ptr())

    def build(self) -> "SpmmPlan":
        """Launch the grouping on the card unless it is built (nothing on
        CPU tensors); returns the plan."""
        nbrs = self.neighbors
        if self.groups is not None or nbrs.device.type == "cpu":
            return self
        check(nbrs, "neighbors", torch.int32, (None, None), nbrs.device)
        (N, M), Nf = nbrs.shape, self.num_rows
        if N * M >= 2 ** 31:
            raise ValueError(f"N * M = {N * M} lanes exceed the kernel's "
                             "2^31")
        if Nf == 0 and N * M > 0:
            raise ValueError("feat has no rows to gather")
        if Nf >= 2 ** 31:
            raise ValueError(f"num_rows = {Nf} exceeds the kernel's 2^31")
        lib = _bwd_lib()
        g = Groups(N * M, N, nbrs.device)
        scratch = torch.empty(lib.repro_spmm_plan_scratch(N, M, Nf),
                              dtype=torch.int32, device=nbrs.device)
        err = lib.repro_spmm_plan(
            _build.ptr(nbrs), _build.ptr(g.counts), _build.ptr(g.active),
            _build.ptr(g.rank), _build.ptr(g.lanes), _build.ptr(g.rows),
            _build.ptr(g.starts), _build.ptr(g.firsts), _build.ptr(g.meta),
            _build.ptr(scratch), N, M, Nf, _build.stream_of(nbrs))
        _build.check(err, "packed_spmm_bwd plan")
        _build.count("packed_spmm_bwd")
        self.groups = g
        return self

    def integers(self) -> dict:
        """The grouping's integers (:func:`lane_groups_plain`'s): on the
        card the built plan's, read back (a sync); on the CPU the plain
        version's."""
        if self.neighbors.device.type == "cpu":
            return lane_groups_plain(self.targets(), self.num_rows)
        return self.build().groups.integers()


def packed_spmm_bwd(neighbors, feat, w, dout, *, combine: str = "sum",
                    need_feat: bool = True, need_w: bool = True,
                    plan: SpmmPlan | None = None):
    """The gradient of :func:`packed_spmm` with respect to feat and w for
    the output's gradient ``dout`` [N, f]: ``(dfeat [Nf, d], dw [d, f])``
    float32, each None where not asked for.  CPU tensors take
    :func:`packed_spmm_bwd_plain` (``plan`` ignored); CUDA tensors build
    ``plan`` (a :class:`SpmmPlan` of neighbors over Nf rows; a new one
    where none is given) unless it is built, then launch, for dfeat, the
    projection ``dout[active] @ w^T`` and the sum over the plan's distinct
    rows with the zeros, for dw, the gather of the active rows' agg and the
    split tile with its ordered sum: each entry counted on
    ``packed_spmm_bwd`` (4 with both, and 1 for a plan built here).  The
    card takes float32 operands only (the reference trains in float32):
    bfloat16 raises."""
    check_dtypes(feat=feat, w=w)
    if feat.device.type == "cpu":
        dfeat, dw = packed_spmm_bwd_plain(neighbors, feat, w, dout,
                                          combine=combine)
        return (dfeat if need_feat else None), (dw if need_w else None)
    if combine not in COMBINES:
        raise ValueError(f"combine={combine!r}")
    if torch.bfloat16 in (feat.dtype, w.dtype, dout.dtype):
        raise ValueError("packed_spmm's backward takes float32 feat, w and "
                         "dout (the reference trains in float32)")
    dev = feat.device
    check(feat, "feat", torch.float32, (None, None), dev)
    Nf, d = feat.shape
    check(neighbors, "neighbors", torch.int32, (None, None), dev)
    check(w, "w", torch.float32, (d, None), dev)
    (N, M), f = neighbors.shape, w.shape[1]
    check(dout, "dout", torch.float32, (N, f), dev)
    if plan is None:
        plan = SpmmPlan(neighbors, Nf)
    elif not plan.matches(neighbors, Nf):
        raise ValueError("the plan was made for another neighbour matrix "
                         "or feat")
    gr = plan.build().groups
    stream = _build.stream_of(feat)
    mean = int(combine == "mean")
    f32 = dict(dtype=torch.float32, device=dev)
    n_active = _build.ptr(gr.meta[META_ACTIVE:])
    dfeat = dw = dout_a = None
    if need_feat:
        # G's rows of the active rows, in their order (the rows past their
        # count, a bound on the host, stay unwritten)
        g = torch.empty((N, d), **f32)
        dout_a = torch.empty((N, f), **f32)
        wt = w.T.contiguous()
        err = _lib().repro_spmm_project_rows(
            _build.ptr(dout), _build.ptr(wt), _build.ptr(g),
            _build.ptr(dout_a), _build.ptr(gr.active), n_active, N, f, d,
            stream)
        _build.check(err, "packed_spmm_bwd project")
        _build.count("packed_spmm_bwd")
        dfeat = torch.empty((Nf, d), **f32)
        err = _bwd_lib().repro_spmm_bwd_dfeat(
            _build.ptr(g), _build.ptr(gr.lanes), _build.ptr(gr.rows),
            _build.ptr(gr.starts), _build.ptr(gr.firsts),
            _build.ptr(gr.counts),
            _build.ptr(gr.rank), _build.ptr(gr.meta), _build.ptr(dfeat), N,
            M, Nf, d, mean, stream)
        _build.check(err, "packed_spmm_bwd dfeat")
        _build.count("packed_spmm_bwd")
        del g, wt
    if need_w:
        agg = torch.empty((N, d), **f32)
        err = _lib().repro_spmm_gather_rows(
            _build.ptr(neighbors), _build.ptr(feat), _build.ptr(agg),
            _build.ptr(gr.active), n_active, N, M, Nf, d, mean, stream)
        _build.check(err, "packed_spmm_bwd agg")
        _build.count("packed_spmm_bwd")
        S = dw_splits(N, d, f)
        part = torch.empty((S, d, f), **f32)
        dw = torch.empty((d, f), **f32)
        # dout's active rows: the projection's copy of them, else through
        # the list
        err = _bwd_lib().repro_spmm_bwd_dw(
            _build.ptr(agg), _build.ptr(dout if dout_a is None else dout_a),
            _build.ptr(gr.active if dout_a is None else None),
            _build.ptr(gr.meta), _build.ptr(dw), _build.ptr(part), d, f, S,
            stream)
        _build.check(err, "packed_spmm_bwd dw")
        _build.count("packed_spmm_bwd")
    return dfeat, dw
