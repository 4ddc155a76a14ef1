"""The kernel API: the port's copy of the reference's ``kernels/ops.py``.

Each function keeps the reference's signature and defaults, with
``use_pallas`` renamed ``use_kernel`` and no ``interpret``.
``use_kernel=False`` computes with the oracles of :mod:`ref`.  With
``use_kernel=True`` (the default) CPU tensors take each kernel's plain
version and CUDA tensors launch the hand-written kernel or raise; nothing
falls back.  Model code calls these, never a kernel's library.
"""
from __future__ import annotations

from repro_torch.kernels import block as _block
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import ref as _ref
from repro_torch.kernels import segment_matmul as _sm
from repro_torch.kernels import topk as _topk


def distance_matrix(Q, X, *, metric: str = "l2", use_kernel: bool = True):
    """[B, d] x [N, d] -> [B, N]; smaller = closer."""
    if not use_kernel:
        return _ref.distance_matrix_ref(Q, X, metric=metric)
    return _block.distance_matrix(Q, X, metric=metric)


def bitonic_sort(dists, ids, *, use_kernel: bool = True):
    if not use_kernel:
        return _ref.sort_ref(dists, ids)
    return _topk.bitonic_sort(dists, ids)


def bitonic_topk(dists, ids, k: int, *, use_kernel: bool = True):
    if not use_kernel:
        return _ref.topk_ref(dists, ids, k)
    return _topk.bitonic_topk(dists, ids, k)


def flash_attention(q, k, v, *, window: int = 0, q_offset: int = 0,
                    use_kernel: bool = True):
    """q [B, Sq, H, hd]; k/v [B, Skv, KV, hd]; H = KV * G.  Causal."""
    if not use_kernel:
        return _ref.attention_ref(q, k, v, window=window, q_offset=q_offset)
    return _fa.flash_attention(q, k, v, window=window, q_offset=q_offset)


def embedding_bag(table, ids, *, combine: str = "mean",
                  use_kernel: bool = True):
    if not use_kernel:
        return _ref.embedding_bag_ref(table, ids, combine=combine)
    return _eb.embedding_bag(table, ids, combine=combine)


def packed_spmm(neighbors, feat, w, *, combine: str = "sum",
                use_kernel: bool = True):
    """neighbors [N, M] (sentinel >= feat.shape[0]); feat [Nf, d];
    w [d, f] -> [N, f]."""
    if not use_kernel:
        return _sm.packed_spmm_plain(neighbors, feat, w, combine=combine)
    return _sm.packed_spmm(neighbors, feat, w, combine=combine)
