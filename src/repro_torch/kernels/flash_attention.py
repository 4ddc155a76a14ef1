"""Causal + sliding-window GQA attention: CUDA kernel wrapper + its plain
versions.

Replaces the reference's ``kernels/flash_attention.py::
flash_attention_pallas``.  The kernel is ``csrc/flash_attention.cu``, two
bodies chosen by :func:`path` from the shapes alone:

* ``"tile"`` (prefill): tensor-core tiles of 64 query rows, K and V
  streamed through a cp.async ring, the online softmax in float32; bf16
  inputs multiply S in bf16 and P @ V with P split into two bf16 parts,
  float32 inputs multiply both products in 3xTF32.  One launch.
* ``"split"`` (decode, few query rows a KV head): the visible keys cut
  into chunks (:func:`split_plan`), one CTA a (chunk, KV head, batch row)
  writing float32 partials (m, l, acc), then a combine.  Two launches.

The source's header note gives the bounds, both designs and why the
operand splits exist.  The plain version of the kernel's function is the
oracle :func:`repro_torch.kernels.ref.attention_ref`, the exact softmax
in float32; :func:`split_plain` is the split path's arithmetic (partials
per planned chunk, then the combine) in plain PyTorch.

q [B, Sq, H, hd], k and v [B, Skv, KV, hd], H = KV * G; query i sits at
position ``q_offset + i`` and sees key j when ``j <= q_offset + i`` and,
for ``window > 0``, ``j > q_offset + i - window``.

The gradient.  On CUDA tensors that need one, :func:`flash_attention` is
an autograd ``Function`` (under ``no_grad`` nothing is saved): its
forward is the kernel above and saves q, k and v; its backward,
:func:`flash_attention_bwd`, launches ``csrc/flash_attention_bwd.cu``,
two passes of ``mma.sync`` tensor-core tiles: dq with each row's
log-sum-exp and D (O recomputed in float32), then dk and dv over a KV
head's G heads.  bf16 inputs multiply S and dP in bf16 and split P and dS
into three bf16 pieces (exact in float32) for the other products; float32
inputs split every operand into three TF32 pieces, six products each,
except at few query rows a KV head (:func:`bwd_path`), where two bodies
compute the plain version's formula in float64 and round each output
once.
The source's note gives the design, bounds and why the splits.  It
replaces no TPU kernel: the reference takes the plain attention's
gradient by autodiff (``src/repro/models/layers.py:86``).  Its plain
version, :func:`flash_attention_bwd_plain`, is the same function in
PyTorch (log-sum-exp, O recomputed in float32, D, dS).  On CPU tensors
:func:`flash_attention` is ``attention_ref``, differentiated by autograd.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from repro_torch.kernels import _build
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.block import check

MAX_HEAD_DIM = 256     # the widest head the kernels pad to
HEAD_DIMS = (32, 64, 128, 256)   # the padded head widths compiled
# the split path at every decode step (Sq = 1: the tile path would read K
# and V once for each of the G heads) and up to this many query rows
# (Sq * G) a KV head; the tile path above it.  On the H100 at G = 1 over
# 32,768 keys, split wins at 1 and 2 rows and the tile path from 4
# (PERF.md; chip_smoke.py's [threshold] lines)
SPLIT_ROWS = 2
SPLIT_NQ = (1, 2, 4, 8)  # query rows a split CTA takes (compiled)
SPLIT_CTAS = 132 * 16    # a split launch aims at 16 CTAs an H100 SM
MIN_CHUNK = 256          # keys a chunk at least
CHUNK_ALIGN = 64         # chunks a multiple of this many keys
# the compiled bodies, in the order of csrc/flash_attention.cu
# repro_flash_attrs
BODIES = ([f"tile_{t}_hd{d}" for t in ("bf16", "f32") for d in HEAD_DIMS]
          + [f"split_{t}_hd{d}_{r}" for t in ("bf16", "f32")
             for d in HEAD_DIMS for r in ("nq1", "nq2", "nq4", "nq8",
                                           "scalar")]
          + ["combine_bf16", "combine_f32"])
# the gradient's compiled bodies, in the order of csrc/flash_attention_bwd.cu
# repro_flash_bwd_attrs
BWD_BODIES = [f"{p}_{t}_hd{d}" for p in ("dq", "dkv") for t in ("bf16", "f32")
              for d in HEAD_DIMS]
# the float32 rows bodies (float64 inside), in the order of
# repro_flash_bwd_rows_attrs
BWD_ROWS_BODIES = ["rows_q_f64", "rows_kv_f64"]
# a float32 gradient with at most this many query rows a KV head (Sq * G)
# takes the rows bodies: one dq CTA's tile
BWD_ROWS_MAX = 64


def bwd_path(Sq: int, H: int, KV: int, dtype) -> str:
    """The gradient's bodies: ``"rows"`` (the plain version's formula in
    float64, each output rounded to float32 once) for float32 with at
    most ``BWD_ROWS_MAX`` query rows a KV head, else ``"tile"`` (the
    tensor-core passes)."""
    return ("rows" if dtype == torch.float32 and Sq * (H // KV)
            <= BWD_ROWS_MAX else "tile")


def check_shapes(q, k, v, *, window: int, q_offset: int) -> None:
    """Raise ``ValueError`` unless q, k and v have the layout above and
    every query row sees at least one key (on any device: the CPU must not
    accept what the card refuses)."""
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"q [B, Sq, H, hd], k and v [B, Skv, KV, hd]: got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, Sq, H, hd = q.shape
    Bk, Skv, KV, hdk = k.shape
    if Bk != B or hdk != hd or KV == 0 or H % KV:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)}: "
                         "batch and head width must agree and H must be a "
                         "multiple of KV")
    if Skv == 0 or q_offset < 0 or (window > 0
                                    and q_offset + Sq - window >= Skv):
        raise ValueError(f"q_offset={q_offset}, window={window}, Sq={Sq}, "
                         f"Skv={Skv}: some query row would see no key")


def path(B: int, Sq: int, Skv: int, H: int, KV: int, hd: int,
         dtype) -> str:
    """The kernel body of a call: ``"split"`` for a decode step (Sq = 1)
    or at most ``SPLIT_ROWS`` query rows a KV head, else ``"tile"``."""
    return "split" if Sq == 1 or Sq * (H // KV) <= SPLIT_ROWS else "tile"


@dataclasses.dataclass(frozen=True)
class SplitPlan:
    """The split path's chunks: ``chunks`` runs of ``chunk`` keys from
    key ``lo``, and ``nq`` query rows a CTA."""
    lo: int
    chunk: int
    chunks: int
    nq: int


def split_plan(B: int, Sq: int, Skv: int, H: int, KV: int, *,
               window: int = 0, q_offset: int = 0,
               chunk: int | None = None) -> SplitPlan:
    """Cut the keys some query row sees, [lo, hi), into chunks: enough for
    about ``SPLIT_CTAS`` CTAs, each of at least ``MIN_CHUNK`` keys (or
    ``chunk`` keys each, where given)."""
    rows = Sq * (H // KV)
    nq = min(SPLIT_NQ[-1], 1 << max(0, rows - 1).bit_length())
    lo = max(0, q_offset - window + 1) if window > 0 else 0
    hi = min(Skv, q_offset + Sq)
    span = hi - lo
    if chunk is None:
        ctas = B * KV * -(-rows // nq)
        n = max(1, min(-(-SPLIT_CTAS // ctas), span // MIN_CHUNK))
        chunk = -(-span // n)
        chunk = -(-chunk // CHUNK_ALIGN) * CHUNK_ALIGN
    return SplitPlan(lo, chunk, -(-span // chunk), nq)


def split_plain(q, k, v, *, window: int = 0, q_offset: int = 0,
                chunk: int | None = None):
    """The split path's arithmetic in plain PyTorch (any device): float32
    partials (m, l, acc) over each chunk of :func:`split_plan`, an empty
    chunk m = -inf and l = 0, then acc and l rescaled by exp(m_c - M),
    summed and divided.  Same layout and result type as
    :func:`flash_attention`."""
    check_shapes(q, k, v, window=window, q_offset=q_offset)
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    plan = split_plan(B, Sq, Skv, H, KV, window=window, q_offset=q_offset,
                      chunk=chunk)
    qf = q.to(torch.float32).reshape(B, Sq, KV, G, hd) * hd ** -0.5
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    ms, ls, accs = [], [], []
    for c in range(plan.chunks):
        ks = plan.lo + c * plan.chunk
        ke = min(Skv, ks + plan.chunk)
        s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf[:, ks:ke])
        k_pos = torch.arange(ks, ke, device=q.device)
        mask = k_pos[None, :] <= q_pos[:, None]
        if window > 0:
            mask &= k_pos[None, :] > q_pos[:, None] - window
        s = s.masked_fill(~mask, float("-inf"))
        m = s.amax(-1)                                   # [B, KV, G, Sq]
        p = torch.exp(s - torch.where(torch.isinf(m), 0.0, m)[..., None])
        ms.append(m)
        ls.append(p.sum(-1))
        accs.append(torch.einsum("bkgqs,bskh->bkgqh", p, vf[:, ks:ke]))
    m = torch.stack(ms)
    w = torch.exp(m - m.amax(0))          # an empty chunk: exp(-inf) = 0
    l_sum = (w * torch.stack(ls)).sum(0)
    o = (w[..., None] * torch.stack(accs)).sum(0) / l_sum[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, hd).to(q.dtype)


@functools.cache
def _lib() -> ctypes.CDLL:
    """The built library, its entry points typed once."""
    lib = _build.library("flash_attention")
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.repro_flash_tile.argtypes = [p] * 4 + [i] * 8 + [f, i, i, p]
    lib.repro_flash_split.argtypes = [p] * 6 + [i] * 12 + [f, i, i, p]
    lib.repro_flash_combine.argtypes = [p] * 4 + [i] * 4 + [p]
    for fn in (lib.repro_flash_tile, lib.repro_flash_split,
               lib.repro_flash_combine):
        fn.restype = i
    return lib


def body_attributes() -> dict:
    """Registers and spilled (local) bytes a thread of each compiled
    kernel, as the card reports them: ``{"tile_bf16_hd32": (regs, local),
    ..., "combine_f32": ...}``."""
    return _build.body_attributes("flash_attention", "repro_flash_attrs",
                                  BODIES)


def flash_attention(q, k, v, *, window: int = 0, q_offset: int = 0,
                    via: str | None = None, chunk: int | None = None):
    """q [B, Sq, H, hd], k/v [B, Skv, KV, hd], all float32 or all bfloat16
    -> [B, Sq, H, hd] in q's dtype.  CPU tensors take
    :func:`repro_torch.kernels.ref.attention_ref`; CUDA tensors launch the
    kernel along :func:`path`, each launch counted on ``flash_attention``,
    and where grad mode is on and q, k or v needs a gradient, through an
    autograd ``Function`` whose backward is :func:`flash_attention_bwd`.
    ``via`` ("tile" or "split") and ``chunk`` (the split path's keys a
    chunk) override the plan, to hold a body to shapes it would not
    take."""
    check_shapes(q, k, v, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return _ref.attention_ref(q, k, v, window=window, q_offset=q_offset)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _Attention.apply(q, k, v, window, q_offset, via, chunk)
    return _forward(q, k, v, window, q_offset, via, chunk)


def _forward(q, k, v, window: int, q_offset: int, via, chunk):
    """The kernel's launch on CUDA tensors (shapes already checked)."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: float32 or bfloat16, got {q.dtype}")
    dev = q.device
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    check(q, "q", q.dtype, (B, Sq, H, hd), dev)
    check(k, "k", q.dtype, (B, Skv, KV, hd), dev)
    check(v, "v", q.dtype, (B, Skv, KV, hd), dev)
    if hd > MAX_HEAD_DIM or B > 65535 or H > 65535:
        raise ValueError(f"hd={hd} (at most {MAX_HEAD_DIM}), B={B} and "
                         f"H={H} (at most 65535 each) exceed the kernel")
    body = via or path(B, Sq, Skv, H, KV, hd, q.dtype)
    if body not in ("tile", "split"):
        raise ValueError(f"via: 'tile' or 'split', got {via!r}")
    out = torch.empty_like(q)
    bf16 = int(q.dtype == torch.bfloat16)
    # 16-byte rows for cp.async and vector loads
    vec = int(hd * q.element_size() % 16 == 0 and all(
        t.data_ptr() % 16 == 0 for t in (q, k, v)))
    stream = _build.stream_of(q)
    ptrs = [_build.ptr(t) for t in (q, k, v)]
    if body == "tile":
        err = _lib().repro_flash_tile(*ptrs, _build.ptr(out), B, Sq, Skv, H,
                                      KV, hd, window, q_offset, hd ** -0.5,
                                      bf16, vec, stream)
        _build.check(err, "flash_attention")
        _build.count("flash_attention")
        return out
    plan = split_plan(B, Sq, Skv, H, KV, window=window, q_offset=q_offset,
                      chunk=chunk)
    rows = B * Sq * H
    part = torch.empty(rows * plan.chunks * (hd + 2), dtype=torch.float32,
                       device=dev)
    n = rows * plan.chunks
    pm, pl, pacc = (_build.ptr(t) for t in (part[:n], part[n:2 * n],
                                             part[2 * n:]))
    err = _lib().repro_flash_split(*ptrs, pm, pl, pacc, B, Sq, Skv, H, KV,
                                   hd, window, q_offset, plan.lo, plan.chunk,
                                   plan.chunks, plan.nq, hd ** -0.5, bf16,
                                   vec, stream)
    _build.check(err, "flash_attention split")
    _build.count("flash_attention")
    err = _lib().repro_flash_combine(pm, pl, pacc, _build.ptr(out), rows, hd,
                                     plan.chunks, bf16, stream)
    _build.check(err, "flash_attention combine")
    _build.count("flash_attention")
    return out


class _Attention(torch.autograd.Function):
    """The kernel's forward, saving q, k and v; its backward launches
    :func:`flash_attention_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, window, q_offset, via, chunk):
        ctx.save_for_backward(q, k, v)
        ctx.window, ctx.q_offset = window, q_offset
        return _forward(q, k, v, window, q_offset, via, chunk)

    @staticmethod
    def backward(ctx, dout):
        q, k, v = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, dout.contiguous(),
                                         window=ctx.window,
                                         q_offset=ctx.q_offset)
        return dq, dk, dv, None, None, None, None


def flash_attention_bwd_plain(q, k, v, dout, *, window: int = 0,
                              q_offset: int = 0):
    """The backward kernel's function in plain PyTorch (any device):
    s = scale * q k^T over the visible keys, lse = m + log(sum exp(s - m)),
    P = exp(s - lse), O = P V in float32, D = rowsum(dout * O),
    dS = P (dout v^T - D); dq = scale dS k, dk = scale dS^T q (summed over
    a KV head's G heads), dv = P^T dout.  Float64 inputs compute in
    float64, others in float32.  Returns (dq, dk, dv) in the inputs'
    dtypes."""
    check_shapes(q, k, v, window=window, q_offset=q_offset)
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = hd ** -0.5
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(ct).reshape(B, Sq, KV, G, hd)
    dof = dout.to(ct).reshape(B, Sq, KV, G, hd)
    kf, vf = k.to(ct), v.to(ct)
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, kf) * scale
    s = s.masked_fill(~mask, float("-inf"))
    m = s.amax(-1, keepdim=True)
    lse = m + torch.log(torch.exp(s - m).sum(-1, keepdim=True))
    p = torch.exp(s - lse)
    o = torch.einsum("bkgqs,bskh->bkgqh", p, vf)
    delta = (o * dof.permute(0, 2, 3, 1, 4)).sum(-1, keepdim=True)
    dp = torch.einsum("bqkgh,bskh->bkgqs", dof, vf)
    ds = p * (dp - delta)
    dq = torch.einsum("bkgqs,bskh->bqkgh", ds, kf) * scale
    dk = torch.einsum("bkgqs,bqkgh->bskh", ds, qf) * scale
    dv = torch.einsum("bkgqs,bqkgh->bskh", p, dof)
    return (dq.reshape(B, Sq, H, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


@functools.cache
def _bwd_lib() -> ctypes.CDLL:
    """The gradient's built library, its entry points typed once."""
    lib = _build.library("flash_attention_bwd")
    i, p, f = ctypes.c_int, ctypes.c_void_p, ctypes.c_float
    lib.repro_flash_bwd_dq.argtypes = [p] * 7 + [i] * 8 + [f, i, p]
    lib.repro_flash_bwd_dkv.argtypes = [p] * 8 + [i] * 8 + [f, i, p]
    d = ctypes.c_double
    lib.repro_flash_bwd_rows_dq.argtypes = [p] * 7 + [i] * 8 + [d, p]
    lib.repro_flash_bwd_rows_dkv.argtypes = [p] * 8 + [i] * 8 + [d, p]
    for fn in (lib.repro_flash_bwd_dq, lib.repro_flash_bwd_dkv,
               lib.repro_flash_bwd_rows_dq, lib.repro_flash_bwd_rows_dkv):
        fn.restype = i
    return lib


def bwd_body_attributes() -> dict:
    """Registers and spilled (local) bytes a thread of each compiled body
    of the gradient, as the card reports them: ``{"dq_bf16_hd32": (regs,
    local), ..., "dkv_f32_hd256": ...}``."""
    return _build.body_attributes("flash_attention_bwd",
                                  "repro_flash_bwd_attrs", BWD_BODIES)


def bwd_rows_attributes() -> dict:
    """The same for the float32 rows bodies (:data:`BWD_ROWS_BODIES`)."""
    return _build.body_attributes("flash_attention_bwd",
                                  "repro_flash_bwd_rows_attrs",
                                  BWD_ROWS_BODIES)


def flash_attention_bwd(q, k, v, dout, *, window: int = 0,
                        q_offset: int = 0):
    """The gradient of :func:`flash_attention` with respect to q, k and v
    for the output's gradient ``dout`` [B, Sq, H, hd] (q's dtype):
    ``(dq, dk, dv)`` in the inputs' dtypes.  CPU tensors take
    :func:`flash_attention_bwd_plain`; CUDA tensors launch the kernel's
    two passes along :func:`bwd_path`, each counted on
    ``flash_attention_bwd``."""
    check_shapes(q, k, v, window=window, q_offset=q_offset)
    if q.device.type == "cpu":
        return flash_attention_bwd_plain(q, k, v, dout, window=window,
                                         q_offset=q_offset)
    return _launch_bwd(q, k, v, dout, window, q_offset)


def _launch_bwd(q, k, v, dout, window: int, q_offset: int):
    """The two launches."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"q: float32 or bfloat16, got {q.dtype}")
    dev = q.device
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    check(q, "q", q.dtype, (B, Sq, H, hd), dev)
    check(k, "k", q.dtype, (B, Skv, KV, hd), dev)
    check(v, "v", q.dtype, (B, Skv, KV, hd), dev)
    check(dout, "dout", q.dtype, (B, Sq, H, hd), dev)
    if hd > MAX_HEAD_DIM or B > 65535 or H > 65535:
        raise ValueError(f"hd={hd} (at most {MAX_HEAD_DIM}), B={B} and "
                         f"H={H} (at most 65535 each) exceed the kernel")
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    stats = torch.empty((2, B, H, Sq), dtype=torch.float32, device=dev)
    bf16 = int(q.dtype == torch.bfloat16)
    stream = _build.stream_of(q)
    ins = [_build.ptr(t) for t in (q, k, v, dout)]
    lse, delta = _build.ptr(stats[0]), _build.ptr(stats[1])
    shape = (B, Sq, Skv, H, KV, hd, window, q_offset)
    lib = _bwd_lib()
    if bwd_path(Sq, H, KV, q.dtype) == "rows":
        st64 = torch.empty((2, B, H, Sq), dtype=torch.float64, device=dev)
        lse, delta = _build.ptr(st64[0]), _build.ptr(st64[1])
        err = lib.repro_flash_bwd_rows_dq(*ins, _build.ptr(dq), lse, delta,
                                          *shape, hd ** -0.5, stream)
        _build.check(err, "flash_attention_bwd rows dq")
        _build.count("flash_attention_bwd")
        err = lib.repro_flash_bwd_rows_dkv(*ins, lse, delta, _build.ptr(dk),
                                           _build.ptr(dv), *shape,
                                           hd ** -0.5, stream)
        _build.check(err, "flash_attention_bwd rows dkv")
        _build.count("flash_attention_bwd")
        return dq, dk, dv
    err = lib.repro_flash_bwd_dq(*ins, _build.ptr(dq), lse, delta, *shape,
                                 hd ** -0.5, bf16, stream)
    _build.check(err, "flash_attention_bwd dq")
    _build.count("flash_attention_bwd")
    err = lib.repro_flash_bwd_dkv(*ins, lse, delta, _build.ptr(dk),
                                  _build.ptr(dv), *shape, hd ** -0.5, bf16,
                                  stream)
    _build.check(err, "flash_attention_bwd dkv")
    _build.count("flash_attention_bwd")
    return dq, dk, dv
