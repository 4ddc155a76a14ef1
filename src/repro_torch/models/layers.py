"""Transformer building blocks: norms, RoPE, chunked (flash-style)
attention, in plain PyTorch: the port's copy of the reference's
``models/layers.py``, with its arithmetic.

Each function keeps the reference's casts: norms and RoPE in float32 and
back to the input's dtype; attention scores and the P @ V products
accumulate in float32 (the reference's ``preferred_element_type``: the
operands are widened first, so each product is exact and only the
summation order differs), ``q`` is scaled in its own dtype, ``p`` is cast
to V's dtype before P @ V, and masked scores are ``NEG_INF``.  The chunk
sizes are the reference's.  These are the model's attention on the CPU and
under ``kernel_backend="torch"``; on the card the model launches
``repro_torch.kernels.flash_attention`` instead (``transformer.py``).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e30


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def rms_norm(x, scale=None, eps: float = 1e-6):
    x32 = x.to(torch.float32)
    var = torch.mean(torch.square(x32), dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * (1.0 + scale.to(torch.float32))
    return y.to(x.dtype)


def nonparametric_ln(x, eps: float = 1e-5):
    """OLMo-style LayerNorm without learnable scale/bias."""
    x32 = x.to(torch.float32)
    mu = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.var(x32, dim=-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + eps)).to(x.dtype)


def make_norm(cfg):
    if cfg.nonparametric_ln:
        return lambda x, scale=None: nonparametric_ln(x)
    return rms_norm


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 10000.0):
    """x: [..., S, H, hd]; positions: broadcastable to [..., S].  The two
    halves of the head rotate together (split, not interleaved)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                  # [hd/2]
    ang = positions[..., None].to(torch.float32) * freqs     # [..., S, hd/2]
    sin, cos = torch.sin(ang), torch.cos(ang)
    sin = sin[..., None, :]  # broadcast over heads
    cos = cos[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


# --------------------------------------------------------------------------
# chunked (memory-bounded) attention
# --------------------------------------------------------------------------

def _chunk_mask(q_pos, k_pos, window):
    """causal + optional sliding window; q_pos [Cq], k_pos [Ck] -> [Cq, Ck].
    ``window`` <= 0 means full causal attention, > 0 a sliding window."""
    m = k_pos[None, :] <= q_pos[:, None]
    if window > 0:
        m = m & (k_pos[None, :] > (q_pos[:, None] - window))
    return m


def _pad_seq(x, n: int):
    """Zeros appended along axis 1 up to ``n`` rows."""
    if x.shape[1] == n:
        return x
    return F.pad(x, (0, 0, 0, 0, 0, n - x.shape[1]))


def chunked_attention(q, k, v, *, window: int = 0, q_offset: int = 0,
                      chunk_q: int = 512, chunk_kv: int = 1024,
                      kv_valid: int | None = None):
    """FlashAttention-style running softmax over KV chunks.

    q: [B, Sq, H, hd]; k/v: [B, Skv, KV, hd] (GQA: H = KV * G).
    window: 0/negative = full causal; >0 = sliding window.
    q_offset: absolute position of q[0] (decode / chunked prefill).
    kv_valid: number of valid KV slots (decode with padded cache).
    """
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = hd ** -0.5
    dev = q.device

    nq = -(-Sq // chunk_q)
    nkv = -(-Skv // chunk_kv)
    qp = _pad_seq(q, nq * chunk_q)
    kp = _pad_seq(k, nkv * chunk_kv)
    vp = _pad_seq(v, nkv * chunk_kv)

    # [B, nq, Cq, KV, G, hd] view of q, scaled in its own dtype
    qp = (qp.reshape(B, nq, chunk_q, KV, G, hd) * scale).to(torch.float32)
    kp = kp.reshape(B, nkv, chunk_kv, KV, hd)
    vp = vp.reshape(B, nkv, chunk_kv, KV, hd)

    q_pos = q_offset + torch.arange(nq * chunk_q, device=dev)
    k_pos = torch.arange(nkv * chunk_kv, device=dev).reshape(nkv, chunk_kv)
    valid = Skv if kv_valid is None else kv_valid

    acc = torch.zeros((B, nq, chunk_q, KV, G, hd), dtype=torch.float32,
                      device=dev)
    m_run = torch.full((B, nq, chunk_q, KV, G), NEG_INF, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((B, nq, chunk_q, KV, G), dtype=torch.float32,
                        device=dev)
    for ikv in range(nkv):
        kc, vc = kp[:, ikv], vp[:, ikv]
        kpos = k_pos[ikv]
        # scores: [B, nq, Cq, KV, G, Ck]
        s = torch.einsum("bqckgh,bzkh->bqckgz", qp, kc.to(torch.float32))
        mask = _chunk_mask(q_pos, kpos, window)
        mask = mask.reshape(nq, chunk_q, chunk_kv)[None, :, :, None, None, :]
        mask = mask & (kpos < valid)[None, None, None, None, None, :]
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m_run, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m_run - m_new)
        l_run = l_run * corr + p.sum(-1)
        pv = torch.einsum("bqckgz,bzkh->bqckgh",
                          p.to(vc.dtype).to(torch.float32),
                          vc.to(torch.float32))
        acc = acc * corr[..., None] + pv
        m_run = m_new
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    out = out.reshape(B, nq * chunk_q, H, hd)[:, :Sq]
    return out.to(q.dtype)


def windowed_chunked_attention(q, k, v, *, window: int, q_offset: int = 0,
                               chunk_q: int = 1024, chunk_kv: int = 1024):
    """Sliding-window attention that skips the KV chunks wholly outside
    each query chunk's window: query chunk [q_lo, q_hi] reads only the KV
    chunks inside [q_lo - window, q_hi]."""
    if not isinstance(window, int) or window <= 0:
        raise ValueError(f"window must be a positive int, got {window!r}")
    B, Sq, H, hd = q.shape
    _, Skv, KV, _ = k.shape
    G = H // KV
    scale = hd ** -0.5
    dev = q.device
    nq = -(-Sq // chunk_q)
    nkv = -(-Skv // chunk_kv)
    qp = _pad_seq(q, nq * chunk_q)
    kp = _pad_seq(k, nkv * chunk_kv).reshape(B, nkv, chunk_kv, KV, hd)
    vp = _pad_seq(v, nkv * chunk_kv).reshape(B, nkv, chunk_kv, KV, hd)

    outs = []
    for iq in range(nq):
        q_lo = q_offset + iq * chunk_q
        q_hi = q_offset + (iq + 1) * chunk_q - 1
        c_lo = max(0, (q_lo - window + 1) // chunk_kv)
        c_hi = min(nkv - 1, q_hi // chunk_kv)
        qc = (qp[:, iq * chunk_q:(iq + 1) * chunk_q]
              .reshape(B, chunk_q, KV, G, hd) * scale).to(torch.float32)
        q_pos = q_lo + torch.arange(chunk_q, device=dev)
        acc = torch.zeros((B, chunk_q, KV, G, hd), dtype=torch.float32,
                          device=dev)
        m_run = torch.full((B, chunk_q, KV, G), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros((B, chunk_q, KV, G), dtype=torch.float32,
                            device=dev)
        for ikv in range(c_lo, c_hi + 1):  # only in-window chunks
            kc, vc = kp[:, ikv], vp[:, ikv]
            k_pos = ikv * chunk_kv + torch.arange(chunk_kv, device=dev)
            s = torch.einsum("bckgh,bzkh->bckgz", qc, kc.to(torch.float32))
            mask = _chunk_mask(q_pos, k_pos, window) \
                & (k_pos < Skv)[None, :]
            s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m_run, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(-1)
            pv = torch.einsum("bckgz,bzkh->bckgh",
                              p.to(vc.dtype).to(torch.float32),
                              vc.to(torch.float32))
            acc = acc * corr[..., None] + pv
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
        outs.append(out.reshape(B, chunk_q, H, hd))
    return torch.cat(outs, dim=1)[:, :Sq].to(q.dtype)


def decode_attention(q, k_cache, v_cache, *, pos, slot_pos=None,
                     window: int = 0):
    """Single-token attention against a (possibly ring-buffer) KV cache.

    q: [B, 1, H, hd]; k_cache/v_cache: [B, S, KV, hd].
    pos: current absolute position, an int or a [B] tensor.
    slot_pos: [B, S] absolute position stored in each cache slot (ring
      buffers); None means slot i holds position i.
    """
    B, S, KV, hd = k_cache.shape
    H = q.shape[2]
    G = H // KV
    scale = hd ** -0.5
    dev = q.device
    qg = (q.reshape(B, KV, G, hd) * scale).to(torch.float32)
    s = torch.einsum("bkgh,bskh->bkgs", qg, k_cache.to(torch.float32))
    pos_b = torch.as_tensor(pos, device=dev).expand(B)
    if slot_pos is None:
        slot_pos = torch.arange(S, device=dev)[None, :].expand(B, S)
    m = slot_pos <= pos_b[:, None]
    m = m & (slot_pos >= 0)
    if window > 0:
        m = m & (slot_pos > (pos_b[:, None] - window))
    s = torch.where(m[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p.to(v_cache.dtype)
                       .to(torch.float32), v_cache.to(torch.float32))
    return out.reshape(B, 1, H, hd).to(q.dtype)


def swiglu(x, w_gate, w_up, w_down):
    g = torch.einsum("...d,df->...f", x, w_gate)
    u = torch.einsum("...d,df->...f", x, w_up)
    return torch.einsum("...f,fd->...d", F.silu(g) * u, w_down)
