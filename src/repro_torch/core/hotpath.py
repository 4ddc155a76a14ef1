"""Kernel-dispatch seam for the search hot path (the reference's
``core/hotpath.py``).

Every hot loop of the build and both searches reduces to these primitives:

  * :func:`neighbor_distances` — gather of candidate rows + distance block
    with the validity mask applied;
  * :func:`rank_merge` — (dist, id)-ascending merge keeping ``keep`` per row;
  * :func:`seed_select` — the two composed over seed candidates;
  * :func:`scan_distances` — the whole delta shard scored against a query
    batch (a GEMM with the norm + mask epilogue);
  * :func:`visited_table` / :func:`visited_filter` — per-row hash sets of
    visited ids (``visited_filter="hash"``).

Two backends compute them: ``"cuda"`` (the hand-written kernels in
:mod:`repro_torch.kernels`) and ``"torch"`` (their plain PyTorch versions,
on any device).  :func:`resolve_backend` maps ``"auto"`` to ``"cuda"`` for
CUDA tensors and ``"torch"`` for CPU tensors; ``"cuda"`` on a CPU tensor
raises.  There is no fall back: a CUDA tensor on the ``"cuda"`` backend
launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import block as _block
from repro_torch.kernels import l2dist as _l2
from repro_torch.kernels import topk as _topk
from repro_torch.kernels import visited as _vf

INF = 3.4e38
PAD_ID = _topk.PAD_ID
BACKENDS = ("cuda", "torch")


def resolve_backend(name: str | None, device) -> str:
    """``"auto"``/None -> "cuda" on a CUDA device, "torch" on the CPU;
    explicit names are validated against the tensor's device."""
    device = torch.device(device)
    name = name or "auto"
    if name == "auto":
        return "cuda" if device.type == "cuda" else "torch"
    if name not in BACKENDS:
        raise ValueError(f"unknown kernel backend {name!r}; known: "
                         f"{('auto',) + BACKENDS}")
    if name == "cuda" and device.type != "cuda":
        raise ValueError(f"kernel_backend='cuda' needs CUDA tensors, got "
                         f"tensors on {device}")
    return name


def _q3_of(Q, X, q_idx):
    """Query block: explicit Q ([S, d] squeezed or [S, Kq, d]) or the rows
    of X named by ``q_idx`` [S, Kq]."""
    if q_idx is not None:
        return X[q_idx.clamp(0, X.shape[0] - 1).long()], False
    squeeze = Q.dim() == 2
    return (Q[:, None, :] if squeeze else Q), squeeze


def neighbor_distances(Q, X, idx, *, metric: str = "l2", mask=None,
                       backend: str | None = None, q_idx=None,
                       self_q: bool | None = None, scales=None):
    """Fused gather + distance block, smaller = closer.

    Q [S, d] (or [S, Kq, d]), X [N, d], idx [S, C] int32 -> [S, C] (or
    [S, Kq, C]) float32.  Lanes of ``idx`` outside [0, N) and lanes where
    ``mask`` is False come back as 3.4e38.

    ``q_idx`` [S, Kq] replaces Q (pass Q=None) with rows of X.  Self-query
    mode — the query rows ARE the candidate rows, the diversify tiles — is
    chosen by ``self_q=True`` or, as in the reference, by passing the same
    tensor object as ``q_idx`` and ``idx``; the kernel then gathers each
    row once for both sides.

    ``scales`` [N] float32 marks X as per-row int8 codes (compressed
    residency): each candidate row is dequantized as ``code * scale`` with
    the scale gathered by the same clipped id.  Self-query tiles score
    fp32 rows only, so ``self_q`` with ``scales`` raises ``ValueError``.
    """
    b = resolve_backend(backend, X.device)
    if self_q is None:
        self_q = q_idx is not None and q_idx is idx
    if self_q and scales is not None:
        raise ValueError("self_q tiles (build-time diversify) score fp32 "
                         "rows; scales= is a search-time knob")
    fn = _l2.gather_distances if b == "cuda" else _l2.gather_distances_plain
    idx = idx.to(torch.int32).contiguous()
    if mask is not None:
        mask = mask.contiguous()
    if self_q:
        return fn(None, X, idx, mask, metric=metric, self_q=True)
    Q3, squeeze = _q3_of(Q, X, q_idx)
    out = fn(Q3.contiguous(), X, idx, mask, metric=metric, scales=scales)
    return out[:, 0] if squeeze else out


def rank_merge(dists, ids, *, keep: int, mask=None,
               backend: str | None = None):
    """Row-wise ascending (dist, id) sort carrying ids; the best ``keep``
    per row as (dists [S, keep], ids [S, keep]).  ``mask`` lanes that are
    False are demoted to INF distance (ids untouched)."""
    b = resolve_backend(backend, dists.device)
    if b == "cuda":
        return _topk.rank_merge(
            dists.contiguous(), ids.to(torch.int32).contiguous(),
            None if mask is None else mask.contiguous(), keep=keep)
    return _topk.rank_merge_plain(dists, ids, mask, keep=keep)


def seed_select(Q, X, seeds, *, metric: str = "l2", k: int = 1, mask=None,
                backend: str | None = None, scales=None):
    """Distance + masked top-k over seed candidates: (dists [S, k],
    ids [S, k]) of the k closest valid seeds per row."""
    d = neighbor_distances(Q, X, seeds, metric=metric, mask=mask,
                           backend=backend, scales=scales)
    return rank_merge(d, seeds, keep=k, backend=backend)


def scan_distances(Q, Xd, *, metric: str = "l2", mask=None,
                   backend: str | None = None, scales=None):
    """Brute-force distance block of a whole (delta) shard against a query
    batch: Q [B, d], Xd [cap, d] -> [B, cap] float32, smaller = closer.
    ``mask`` [cap] bool demotes unfilled / tombstoned slots to INF;
    ``scales`` [cap] float32 marks Xd as int8 codes.  As in the reference,
    the whole scan is one [1, B, cap] block."""
    b = resolve_backend(backend, Xd.device)
    fn = _block.block_distances if b == "cuda" \
        else _block.block_distances_plain
    out = fn(Q.contiguous()[None], Xd.contiguous()[None],
             None if mask is None else mask.contiguous()[None],
             None if scales is None else scales.contiguous()[None],
             metric=metric)
    return out[0]


def visited_table(rows: int, bound: int, *, ways: int = 8,
                  device=None) -> torch.Tensor:
    """Empty visited-filter table for ``rows`` searches, sized for at most
    ``bound`` distinct insertions each at load factor <= 1/2 (a power of two
    >= 64 buckets).  Shape [rows, n_buckets, ways] int32, all EMPTY:
    bucket-major, so a bucket's ways are one contiguous sector (the
    reference's table is [rows, ways, n_buckets])."""
    n_buckets = 64
    need = -(-2 * bound // ways)
    while n_buckets < need:
        n_buckets *= 2
    return torch.full((rows, n_buckets, ways), _vf.VF_EMPTY,
                      dtype=torch.int32, device=device)


def visited_filter(table, ids, *, valid, backend: str | None = None):
    """Probe-and-insert a lane block into per-row visited hash sets.

    ``table`` [B, S, W] int32 — updated IN PLACE and returned —, ``ids``
    [B, M] int32, ``valid`` [B, M] bool -> ``(table, fresh [B, M] bool)``.
    Lanes are processed in the reference's canonical order (ascending id,
    invalid lanes last, stable), so the drop set does not depend on how the
    caller arranged its lanes."""
    ids = ids.to(torch.int32)
    key = torch.where(valid, ids, torch.full_like(ids, PAD_ID))
    order = torch.argsort(key, dim=1, stable=True)
    s_ids = ids.gather(1, order).contiguous()
    s_valid = valid.gather(1, order).contiguous()
    b = resolve_backend(backend, table.device)
    fn = _vf.visited_filter if b == "cuda" else _vf.visited_filter_plain
    table, s_fresh = fn(table, s_ids, s_valid)
    return table, torch.empty_like(s_fresh).scatter_(1, order, s_fresh)
