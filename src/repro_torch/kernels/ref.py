"""Plain PyTorch oracles for the kernel API (the port's copy of the
reference's ``kernels/ref.py``), on any device.  ``sort_ref``,
``topk_ref`` and ``attention_ref`` are also the plain versions of their
kernels.
"""
from __future__ import annotations

import torch

from repro_torch.core import metrics as M
from repro_torch.kernels.topk import rank_merge_plain


def distance_matrix_ref(Q, X, *, metric: str = "l2"):
    return M.pairwise(Q.to(torch.float32), X.to(torch.float32), metric)


def sort_ref(dists, ids):
    """Row-wise ascending (dist, id) lexicographic sort."""
    return rank_merge_plain(dists, ids, keep=dists.shape[1])


def topk_ref(dists, ids, k: int):
    sd, si = sort_ref(dists, ids)
    return sd[:, :k], si[:, :k]


def attention_ref(q, k, v, *, window: int = 0, q_offset: int = 0):
    """Exact softmax attention (fp32; float64 inputs in float64), causal
    + optional window, GQA: q [B, Sq, H, hd], k/v [B, Skv, KV, hd] ->
    [B, Sq, H, hd] in q's dtype."""
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = hd ** -0.5
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf = q.to(ct).reshape(B, Sq, KV, G, hd) * scale
    s = torch.einsum("bqkgh,bskh->bkgqs", qf, k.to(ct))
    q_pos = q_offset + torch.arange(Sq, device=q.device)
    k_pos = torch.arange(Skv, device=q.device)
    mask = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        mask &= k_pos[None, :] > (q_pos[:, None] - window)
    s = torch.where(mask, s, torch.full((), -1e30, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskh->bqkgh", p, v.to(ct))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def embedding_bag_ref(table, ids, *, combine: str = "mean"):
    emb = table[ids.long()]
    return emb.sum(-2) if combine == "sum" else emb.mean(-2)


def segment_matmul_ref(feat, src, dst, w, n_nodes: int):
    """GNN gather-GEMM-scatter: sum_{e: dst=i} (feat[src_e] @ w); edges
    whose dst lies outside [0, n_nodes) are dropped, as segment_sum drops
    them."""
    msg = feat[src.long()] @ w
    keep = (dst >= 0) & (dst < n_nodes)
    out = torch.zeros((n_nodes, msg.shape[1]), dtype=msg.dtype,
                      device=msg.device)
    return out.index_add_(0, dst[keep].long(), msg[keep])
