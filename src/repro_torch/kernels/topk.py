"""(dist, id) rank merge and bitonic sort / top-k: CUDA kernel wrappers +
their plain versions.

:func:`rank_merge` replaces the reference's
``kernels/topk.py::rank_merge_pallas``; :func:`bitonic_sort` and
:func:`bitonic_topk` replace ``bitonic_sort_pallas`` and
``bitonic_topk_pallas``, which share its network there as they share the
kernel here.  The kernel is ``csrc/topk.cu``, two bodies chosen by
:func:`path` from (W, keep) alone (:func:`plan` sizes the launches):

* ``"warp"``, rows up to 1,024 lanes: one warp a row, a sorted queue in
  registers, one launch;
* ``"select"``, wider rows keeping at most ``K_MAX`` lanes: one pass in
  which each warp of a CTA keeps such a queue over a column slice and the
  CTA merges its warps' queues; where a row takes several CTAs, one more
  (warp) launch merges theirs;
* ``"cta"``, wider rows keeping more, up to ``MAX_LANES``: a full bitonic
  sort, one CTA a row, one launch;
* ``"chunks"``: anything wider, merged in column chunks of ``MAX_LANES``
  (:func:`merge_in_chunks`), each chunk and each merge of survivors one of
  the paths above.

The source's header note gives the bound and the design.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build

INF = 3.4e38
PAD_ID = 2 ** 31 - 1
WARP_LANES = 1024     # rows up to this wide: one warp each
K_MAX = 256           # the widest prefix the one-pass selection keeps
MAX_LANES = 16384     # the widest full sort: one CTA, the row in shared memory
# a selection's first pass aims at 4 waves of 64 warps on the H100's 132 SMs
SELECT_WARPS = 4 * 64 * 132
WARP_BODY_THREADS = 256   # 8 warps a CTA of the warp and select kernels
SLICE_CHUNKS = 64         # a row takes several CTAs only past 64 queues a warp
CTA_PAIRS = 32            # (dist, id) pairs a thread of the CTA sort holds


def rank_merge_plain(dists, ids, mask=None, *, keep: int):
    """Row-wise ascending (dist, id) order, ids carried; the first ``keep``
    lanes (plain PyTorch, any device).  Two stable sorts stand for the
    reference's ``lexsort((ids, dists))``; the dist key maps -0.0 to +0.0
    as lexsort's comparator does, while the returned dists are the inputs'
    own values."""
    if not 0 < keep <= dists.shape[1]:
        raise ValueError(f"keep={keep} must be in (0, {dists.shape[1]}]")
    if mask is not None:
        dists = torch.where(mask, dists, torch.full_like(dists, INF))
    o1 = torch.argsort(ids, dim=1, stable=True)
    key = torch.where(dists == 0, torch.zeros_like(dists), dists)
    o2 = torch.argsort(key.gather(1, o1), dim=1, stable=True)
    order = o1.gather(1, o2)[:, :keep]
    return dists.gather(1, order), ids.gather(1, order)


def merge_in_chunks(merge, dists, ids, mask=None, *, keep: int,
                    width: int):
    """``merge(dists, ids, mask, keep=)`` over rows wider than the
    ``width`` lanes it can take: each column chunk of at most ``width``
    lanes keeps its best ``keep``, and the survivors are merged again
    until they fit.  Exact, since (dist, id) orders the lanes totally: a
    row's best ``keep`` are among its chunks' best ``keep``."""
    W = dists.shape[1]
    if W > width and keep >= width:
        raise ValueError(f"keep={keep} must be below the {width} lanes "
                         f"one merge takes, for rows of {W} lanes")
    while W > width:
        parts = [merge(dists[:, c:c + width].contiguous(),
                       ids[:, c:c + width].contiguous(),
                       None if mask is None
                       else mask[:, c:c + width].contiguous(),
                       keep=min(keep, W - c)) for c in range(0, W, width)]
        dists = torch.cat([p[0] for p in parts], dim=1)
        ids = torch.cat([p[1] for p in parts], dim=1)
        mask, W = None, dists.shape[1]     # masked lanes came back as INF
    return merge(dists, ids, mask, keep=keep)


def _check_rows(dists, ids, mask):
    R, W = dists.shape
    dev = dists.device
    for t, name, dt in ((dists, "dists", torch.float32),
                        (ids, "ids", torch.int32),
                        (mask, "mask", torch.bool)):
        if t is None:
            continue
        if t.dtype != dt or tuple(t.shape) != (R, W) or t.device != dev \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {dt} [{R}, {W}] on {dev}, got "
                f"{t.dtype} {tuple(t.shape)} on {t.device}")


def path(W: int, keep: int) -> str:
    """The kernel path of rows of W lanes keeping ``keep``: "warp",
    "select", "cta" or "chunks" (see the module note)."""
    if not 0 < keep <= W:
        raise ValueError(f"keep={keep} must be in (0, {W}]")
    if W <= WARP_LANES:
        return "warp"
    if keep <= K_MAX:
        return "select"
    return "cta" if W <= MAX_LANES else "chunks"


def queue_width(keep: int) -> int:
    """The warp body's sorted queue: a power of two of at least 32 lanes
    and at least ``keep``."""
    return max(32, 1 << (keep - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class Launch:
    """One launch of a kernel of ``csrc/topk.cu`` over rows of W lanes,
    writing rows of ``out_width`` lanes: ``"warp"`` (one warp a row),
    ``"select"`` (``groups`` CTAs a row, 8 warps of ``slice`` columns
    each, every CTA writing its best ``keep``) or ``"cta"`` (the full
    sort of rows padded to ``Wp``)."""
    body: str
    W: int
    keep: int
    q: int = 0                # warp, select: queue width
    slice: int = 0            # select: columns a warp takes
    groups: int = 1           # select: CTAs a row
    Wp: int = 0               # cta: padded width

    @property
    def out_width(self) -> int:
        return self.groups * self.keep

    @property
    def threads(self) -> int:
        return self.Wp // CTA_PAIRS if self.body == "cta" \
            else WARP_BODY_THREADS

    @property
    def smem_bytes(self) -> int:
        if self.body == "cta":
            return self.Wp * 8
        return 8 * self.q * 8 if self.body == "select" else 0

    @property
    def pair_registers(self) -> int:
        """32-bit registers a thread holds pairs in: the queue and the
        chunk, and up to a queue of 256 the chunk in flight; the CTA
        sort's 32 pairs."""
        if self.body == "cta":
            return 2 * CTA_PAIRS
        return 2 * (self.q // 32) * (3 if self.q <= 256 else 2)


@functools.lru_cache(maxsize=256)
def plan(R: int, W: int, keep: int) -> tuple:
    """The launches that take rows of W lanes to their best ``keep`` on
    the card (every path but "chunks").  A selection gives a row enough
    CTAs for R rows to make ``SELECT_WARPS`` warps, but more than one
    only while each warp still walks ``SLICE_CHUNKS`` queues' worth of
    columns and the CTAs' queues fit one warp launch."""
    p = path(W, keep)
    if p == "chunks":
        raise ValueError(f"rows of {W} lanes keeping {keep} merge in "
                         f"column chunks of {MAX_LANES}")
    if p == "cta":
        return (Launch("cta", W, keep,
                       Wp=max(2048, 1 << (W - 1).bit_length())),)
    q = queue_width(keep)
    if p == "warp":
        return (Launch("warp", W, keep, q=q),)
    warps = WARP_BODY_THREADS // 32
    groups = max(1, min(-(-SELECT_WARPS // (warps * max(R, 1))),
                        W // (warps * SLICE_CHUNKS * q),
                        WARP_LANES // keep))
    width = -(-W // (warps * groups))
    width = -(-width // q) * q
    first = Launch("select", W, keep, q=q, slice=width,
                   groups=-(-W // (warps * width)))
    if first.groups == 1:
        return (first,)
    return (first,) + plan(R, first.out_width, keep)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, its entry points typed once."""
    lib = _build.library("topk")
    ptrs = [ctypes.c_void_p] * 5
    lib.repro_topk_warp.argtypes = ptrs + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.repro_topk_cta.argtypes = ptrs + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    for fn in (lib.repro_topk_warp, lib.repro_topk_cta):
        fn.restype = ctypes.c_int
    return lib


def body_attributes() -> dict:
    """Registers and spilled (local) bytes a thread of each compiled
    kernel, as the card reports them: ``{"warp_q32": (regs, local), ...,
    "select_q256": ..., "cta_sort": ...}``."""
    names = ([f"warp_q{32 << p}" for p in range(6)]
             + [f"select_q{32 << p}" for p in range(4)] + ["cta_sort"])
    return _build.body_attributes("topk", "repro_topk_attrs", names)


def _launch(L: Launch, dists, ids, mask, stream, counter: str):
    R = dists.shape[0]
    od = torch.empty((R, L.out_width), dtype=torch.float32,
                     device=dists.device)
    oi = torch.empty((R, L.out_width), dtype=torch.int32,
                     device=dists.device)
    args = (dists.data_ptr(), ids.data_ptr(),
            None if mask is None else mask.data_ptr(), od.data_ptr(),
            oi.data_ptr(), R, L.W, L.keep)
    if L.body == "cta":
        err = _lib().repro_topk_cta(*args[:-1], L.Wp, L.keep, stream)
    else:
        err = _lib().repro_topk_warp(*args, L.q, L.slice, L.groups, stream)
    _build.check(err, counter)
    _build.count(counter)
    return od, oi


def _run(dists, ids, mask, *, keep: int, counter: str):
    """The launches of :func:`plan`, one after the other."""
    R, W = dists.shape
    if R == 0:
        return (dists.new_empty((0, keep)), ids.new_empty((0, keep)))
    stream = torch.cuda.current_stream(dists.device).cuda_stream
    for L in plan(R, W, keep):
        dists, ids = _launch(L, dists, ids, mask, stream, counter)
        mask = None                  # masked lanes came back as INF
    return dists, ids


def rank_merge(dists, ids, mask=None, *, keep: int):
    """dists [R, W] float32, ids [R, W] int32, mask [R, W] bool or None ->
    (dists [R, keep], ids [R, keep]).  CPU tensors take
    :func:`rank_merge_plain`; CUDA tensors launch the kernel along
    :func:`path`, in column chunks (:func:`merge_in_chunks`) on its
    "chunks" path."""
    if dists.device.type == "cpu":
        return rank_merge_plain(dists, ids, mask, keep=keep)
    W = dists.shape[1]
    p = path(W, keep)
    _check_rows(dists, ids, mask)
    if p == "chunks":
        return merge_in_chunks(rank_merge, dists, ids, mask, keep=keep,
                               width=MAX_LANES)
    return _run(dists, ids, mask, keep=keep, counter="rank_merge")


def _power_of_two(W: int) -> None:
    if W <= 0 or W & (W - 1):
        raise ValueError(f"width {W} must be a power of two")


def bitonic_topk(dists, ids, k: int):
    """dists [R, W] float32, ids [R, W] int32, W a power of two ->
    the first ``k`` lanes of each row in ascending (dist, id) order.
    A width that is not a power of two raises ``ValueError`` on any
    device, as the reference's kernel refuses it.  CPU tensors take
    :func:`rank_merge_plain` (the plain version, ``ref.topk_ref``); CUDA
    tensors launch the kernel along :func:`path` (counted on
    ``bitonic_sort``)."""
    W = dists.shape[1]
    _power_of_two(W)
    if not 0 < k <= W:
        raise ValueError(f"k={k} must be in (0, {W}]")
    if dists.device.type == "cpu":
        return rank_merge_plain(dists, ids, keep=k)
    _check_rows(dists, ids, None)
    run = functools.partial(_run, counter="bitonic_sort")
    if path(W, k) == "chunks":
        return merge_in_chunks(run, dists, ids, keep=k, width=MAX_LANES)
    return run(dists, ids, None, keep=k)


def bitonic_sort(dists, ids):
    """dists [R, W] float32, ids [R, W] int32, W a power of two of at
    most ``MAX_LANES`` -> both sorted row-wise by (dist, id).  Other widths
    raise ``ValueError`` on any device; CPU tensors take the plain version
    (``ref.sort_ref``), CUDA tensors launch the kernel (counted on
    ``bitonic_sort``)."""
    W = dists.shape[1]
    _power_of_two(W)
    if W > MAX_LANES:
        raise ValueError(f"width {W} exceeds the {MAX_LANES} lanes the "
                         "kernel sorts in shared memory")
    return bitonic_topk(dists, ids, W)
