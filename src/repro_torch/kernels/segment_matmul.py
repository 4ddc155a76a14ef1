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
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.block import FLOAT_DTYPES, check, check_dtypes

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
          "gather_scalar"]
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


def aggregate(neighbors, feat, *, combine: str = "sum"):
    """``agg`` [N, d] float32 (plain PyTorch, any device): the reference's
    plain path (``ops.packed_spmm(use_pallas=False)``) before its ``@ w``,
    summed lane by lane in order."""
    if combine not in COMBINES:
        raise ValueError(f"combine={combine!r}")
    Nf = feat.shape[0]
    ok = neighbors < Nf
    rows = neighbors.long().clamp(0, Nf - 1)
    agg = torch.zeros((neighbors.shape[0], feat.shape[1]),
                      dtype=torch.float32, device=feat.device)
    for t in range(neighbors.shape[1]):
        agg = agg + torch.where(ok[:, t, None],
                                feat[rows[:, t]].to(torch.float32), 0.0)
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
    for fn in (lib.repro_spmm_fused, lib.repro_spmm_project,
               lib.repro_spmm_gather):
        fn.restype = ctypes.c_int
    return lib


def body_attributes() -> dict:
    """Registers and spilled (local) bytes a thread of each compiled body
    of :data:`BODIES`, as the card reports them."""
    return _build.body_attributes("segment_matmul", "repro_spmm_attrs",
                                  BODIES)


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
                via: str | None = None):
    """neighbors [N, M] int32 x feat [Nf, d] x w [d, f], feat and w each
    float32 or bfloat16 -> [N, f] in feat's dtype.  CPU tensors take
    :func:`packed_spmm_plain`; CUDA tensors launch the route :func:`path`
    picks ("fused": one launch, "transform": two, each counted on
    ``packed_spmm``).  ``via`` forces a route, to hold it to shapes it
    would not take."""
    if via not in (None, *ROUTES):
        raise ValueError(f"via: 'fused' or 'transform', got {via!r}")
    check_dtypes(feat=feat, w=w)
    if feat.device.type == "cpu":
        return packed_spmm_plain(neighbors, feat, w, combine=combine)
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
