"""Mixture-of-Experts layer with sort-based capacity dispatch: the port's
copy of the reference's ``models/moe.py``, in plain PyTorch.

top-k routing -> stable sort of (token, slot) pairs by expert id ->
rank-in-expert from the per-expert counts -> scatter into [E, C, d]
buffers -> batched per-expert products -> inverse gather + weighted
combine.  The routing integers equal the reference's: ``jax.lax.top_k``
breaks ties toward the lower expert index, and :func:`top_k` selects with
a stable descending sort to do the same (``torch.topk`` promises no tie
order); ``argsort(stable=True)`` is ``torch.sort(stable=True)``.  The
capacity depends on the tokens of a group (:func:`capacity`), so a
prefill (T = B S tokens) can drop tokens where a decode step (T = B)
drops none, as in the reference.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import MoEConfig


def router_probs(x, w_router):
    logits = torch.einsum("td,de->te", x.to(torch.float32),
                          w_router.to(torch.float32))
    return logits, torch.softmax(logits, dim=-1)


def top_k(probs, k: int):
    """The k largest entries of each row and their indices, ties toward
    the lower index (``jax.lax.top_k``'s order)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    c = int(n_tokens * cfg.top_k / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)  # round up to 8, as the reference does


def _dispatch_group(x, top_e, top_p, E: int, K: int, C: int):
    """Sort-based dispatch of one token group.

    x [Tg, d]; top_e/top_p [Tg, K].  Returns (buffer [E, C, d],
    combine state (sorted_t, expert-or-E, rank, weights), counts [E]).
    """
    Tg, d = x.shape
    dev = x.device
    flat_e = top_e.reshape(Tg * K)                             # expert of slot
    flat_t = torch.arange(Tg, device=dev).repeat_interleave(K)  # its token
    order = torch.sort(flat_e, stable=True).indices            # [Tg*K]
    sorted_e = flat_e[order]
    sorted_t = flat_t[order]
    counts = torch.bincount(flat_e, minlength=E)               # [E]
    starts = torch.cat([counts.new_zeros(1), torch.cumsum(counts, 0)[:-1]])
    rank = torch.arange(Tg * K, device=dev) - starts[sorted_e]  # rank in expert
    keep = rank < C                                            # capacity drop
    se = torch.where(keep, sorted_e, E)
    buf = x.new_zeros((E, C, d))
    buf[se[keep], rank[keep]] = x[sorted_t[keep]]
    w = top_p.reshape(Tg * K)[order] * keep
    return buf, (sorted_t, se, rank, w), counts


def _combine_group(y, state, Tg: int):
    sorted_t, se, rank, w = state
    E, C, d = y.shape
    keep = se < E
    gathered = y.new_zeros((se.shape[0], d))
    gathered[keep] = y[se[keep], rank[keep]]                   # [Tg*K, d]
    contrib = gathered * w[:, None].to(y.dtype)
    return y.new_zeros((Tg, d)).index_add_(0, sorted_t, contrib)


def moe_ffn(x, params, cfg: MoEConfig):
    """x: [T, d] (tokens already flattened); params: router [d, E], w_gate
    and w_up [E, d, f], w_down [E, f, d].  Returns (y, aux_metrics).

    With cfg.dispatch_groups == G > 1 (and T a multiple of G), tokens are
    split into G contiguous groups, each dispatched on its own with the
    capacity of its Tg = T / G tokens.
    """
    T, d = x.shape
    E, K = cfg.n_experts, cfg.top_k
    G = cfg.dispatch_groups if T % cfg.dispatch_groups == 0 else 1
    Tg = T // G
    C = capacity(Tg, cfg)

    logits, probs = router_probs(x, params["router"])          # [T, E]
    top_p, top_e = top_k(probs, K)                             # [T, K]
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    xg = x.reshape(G, Tg, d)
    eg = top_e.reshape(G, Tg, K)
    pg = top_p.reshape(G, Tg, K)
    groups = [_dispatch_group(xg[g], eg[g], pg[g], E, K, C) for g in range(G)]
    buf = torch.stack([b for b, _, _ in groups])               # [G, E, C, d]
    counts_g = torch.stack([c for _, _, c in groups])          # [G, E]

    # ---- per-expert products
    g_ = torch.einsum("gecd,edf->gecf", buf, params["w_gate"])
    u = torch.einsum("gecd,edf->gecf", buf, params["w_up"])
    y = torch.einsum("gecf,efd->gecd", F.silu(g_) * u, params["w_down"])

    # ---- combine (inverse gather, group-local)
    out = torch.stack([_combine_group(y[g], groups[g][1], Tg)
                       for g in range(G)]).reshape(T, d)

    # ---- aux losses (GShard)
    counts = counts_g.sum(0)
    keep_frac = torch.clamp(counts_g, max=C).sum() / (T * K)
    me = torch.mean(probs, dim=0)                              # mean prob/expert
    ce = counts.to(torch.float32) / (T * K)                    # load fraction
    aux = {
        "load_balance_loss": cfg.aux_loss * E * torch.sum(me * ce),
        "router_z_loss": cfg.router_z_loss
        * torch.mean(torch.square(torch.logsumexp(logits, dim=-1))),
        "dropped_fraction": 1.0 - keep_frac,
    }
    return out, aux
