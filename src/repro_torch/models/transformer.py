"""Decoder-only transformer covering the five language models: the port's
copy of the reference's ``models/transformer.py``: its serving path
(``forward``, ``prefill``, ``decode_step``) and its training loss
(``loss_fn`` over :func:`train_forward`).

Features driven entirely by :class:`TransformerConfig`:
  * GQA attention + RoPE, optional QK-norm
  * sliding-window (starcoder2) and 5:1 local:global (gemma3) masking by
    a per-layer window (:func:`layer_windows`)
  * MoE FFN (olmoe / kimi-k2) with sort-based capacity dispatch + shared
    experts, or dense SwiGLU FFN, or starcoder2's GELU MLP (tanh GELU, as
    ``jax.nn.gelu`` defaults to)
  * non-parametric LN (olmo) vs RMSNorm
  * serving: prefill, then decode steps into uniform full per-layer KV
    caches (slot = pos % S_max, as the reference writes them)
  * training: :func:`loss_fn` on the reference's parameter tree, each
    layer under ``torch.utils.checkpoint`` when ``cfg.remat`` (the
    reference's ``jax.checkpoint(nothing_saveable)``)

Serving: the model is a :class:`Transformer` module whose parameter names
are the reference's leaves (``embed``, ``blocks.<i>.wq`` ...
``blocks.<i>.mlp.w_up``, ``final_ln``, ``lm_head``), one block a layer, in
the reference's layouts (``wq`` [d, H, hd], ``wo`` [H, hd, d]).  The
matmul weights are cast to the compute dtype at first use and kept
(:meth:`Transformer.weights`) until a parameter changes in place (an
optimizer step on the tree the module views): the same bits as the
reference's ``.astype(cdt)`` at every use.  ``forward``, ``prefill`` and
``decode_step`` run without gradients.

Training: :func:`train_forward` takes the tree itself, float32 stacked
leaves ``blocks.*`` [L, ...] (the layout the optimizers update), unbinds
each stacked leaf once, and casts each layer's slices to the compute
dtype inside autograd at every step, as the reference's ``.astype(cdt)``
does, so the gradients reach the float32 stacked leaves.

Attention: on a CUDA tensor prefill and decode launch the hand-written
kernel ``repro_torch.kernels.flash_attention`` (prefill with
``q_offset=0`` and the layer's window, its "tile" body; a decode step
over the whole cache with ``q_offset=pos``, whose causal bound masks the
empty slots, its "split" body); the training forward launches the tile
body too, and its gradient the hand-written backward
(``csrc/flash_attention_bwd.cu``).  On the CPU, or with
``kernel_backend="torch"`` on any device, they take the plain functions
of :mod:`layers`, chosen as the reference chooses them: a window uniform
across the layers takes ``windowed_chunked_attention``, other layers
``chunked_attention`` with the window as a mask, and a decode step
``decode_attention``; autograd differentiates them.  Nothing falls back:
``"cuda"`` on a CPU tensor raises.  The large products stay
``torch.einsum``, as the reference leaves them to XLA.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
from repro_torch.kernels import flash_attention as _fa
from repro_torch.models import layers as L
from repro_torch.models import moe as moe_lib
from repro_torch.models.module import DTYPES, ParamSpec
from repro_torch.models.module import use_kernel as _use_kernel

# the leaves of a block cast to the compute dtype (the norms' scales are
# read as they are, the reference's rms_norm widens them itself)
_MATMUL = ("wq", "wk", "wv", "wo")
_GROUPS = ("mlp", "moe", "shared")


# --------------------------------------------------------------------------
# schema
# --------------------------------------------------------------------------

def schema(cfg: TransformerConfig) -> dict:
    d, f, v = cfg.d_model, cfg.d_ff, cfg.vocab
    H, KV, hd, Ln = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim, cfg.n_layers
    pdt = cfg.param_dtype
    emb_std = 1.0 / np.sqrt(d)

    def P(shape, axes, init="fan_in", scale=1.0):
        return ParamSpec(tuple(shape), tuple(axes), init=init, scale=scale,
                         dtype=pdt)

    block: dict = {
        "wq": P((Ln, d, H, hd), ("layers", "fsdp", "heads", None)),
        "wk": P((Ln, d, KV, hd), ("layers", "fsdp", "kv_heads", None)),
        "wv": P((Ln, d, KV, hd), ("layers", "fsdp", "kv_heads", None)),
        "wo": P((Ln, H, hd, d), ("layers", "heads", None, "fsdp")),
    }
    if not cfg.nonparametric_ln:
        block["ln1"] = P((Ln, d), ("layers", None), init="zeros")
        block["ln2"] = P((Ln, d), ("layers", None), init="zeros")
    if cfg.moe is not None:
        E, fe = cfg.moe.n_experts, cfg.moe.d_expert
        block["moe"] = {
            "router": P((Ln, d, E), ("layers", None, "expert"),
                        init="normal", scale=emb_std),
            "w_gate": P((Ln, E, d, fe), ("layers", "expert", "fsdp", None)),
            "w_up": P((Ln, E, d, fe), ("layers", "expert", "fsdp", None)),
            "w_down": P((Ln, E, fe, d), ("layers", "expert", None, "fsdp")),
        }
        if cfg.moe.n_shared:
            fs = cfg.moe.d_expert * cfg.moe.n_shared
            block["shared"] = {
                "w_gate": P((Ln, d, fs), ("layers", "fsdp", "mlp")),
                "w_up": P((Ln, d, fs), ("layers", "fsdp", "mlp")),
                "w_down": P((Ln, fs, d), ("layers", "mlp", "fsdp")),
            }
    elif cfg.gated_ffn:
        block["mlp"] = {
            "w_gate": P((Ln, d, f), ("layers", "fsdp", "mlp")),
            "w_up": P((Ln, d, f), ("layers", "fsdp", "mlp")),
            "w_down": P((Ln, f, d), ("layers", "mlp", "fsdp")),
        }
    else:  # plain 2-matrix GELU MLP (starcoder2)
        block["mlp"] = {
            "w_up": P((Ln, d, f), ("layers", "fsdp", "mlp")),
            "w_down": P((Ln, f, d), ("layers", "mlp", "fsdp")),
        }

    sch: dict = {
        "embed": ParamSpec((v, d), ("vocab", "fsdp"), init="embed",
                           scale=emb_std, dtype=pdt),
        "blocks": block,
    }
    if not cfg.nonparametric_ln:
        sch["final_ln"] = P((d,), (None,), init="zeros")
    if not cfg.tie_embeddings:
        sch["lm_head"] = P((d, v), ("fsdp", "vocab"))
    return sch


def layer_windows(cfg: TransformerConfig) -> np.ndarray:
    """Per-layer attention window; <=0 = full causal."""
    if cfg.local_global_ratio:
        r = cfg.local_global_ratio
        w = [cfg.local_window if (i + 1) % (r + 1) != 0 else 0
             for i in range(cfg.n_layers)]
    elif cfg.window:
        w = [cfg.window] * cfg.n_layers
    else:
        w = [0] * cfg.n_layers
    return np.asarray(w, np.int32)


# --------------------------------------------------------------------------
# the module
# --------------------------------------------------------------------------

def _param(t) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class Block(nn.Module):
    """One layer's parameters under the reference's leaf names: ``wq``,
    ``wk``, ``wv``, ``wo``, ``ln1``/``ln2`` (RMSNorm archs), and the
    ``mlp``, ``moe`` and ``shared`` groups."""

    def __init__(self, leaves: dict):
        super().__init__()
        for name, t in leaves.items():
            if isinstance(t, dict):
                setattr(self, name, nn.ParameterDict(
                    {k: _param(v) for k, v in t.items()}))
            else:
                setattr(self, name, _param(t))


class Transformer(nn.Module):
    """The model: ``embed`` [V, d], ``blocks`` (one :class:`Block` a
    layer), ``final_ln`` and ``lm_head`` where the config has them.  Built
    from a tree in the reference's layout (``init_params(schema(cfg), ...)``
    or ``convert.params_from_reference``): each block's leaves are views
    of the stacked ``blocks`` leaves [L, ...], sliced along the layer
    axis."""

    def __init__(self, cfg: TransformerConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.embed = _param(tree["embed"])
        self.blocks = nn.ModuleList(
            Block(_slice(tree["blocks"], i)) for i in range(cfg.n_layers))
        for name in ("final_ln", "lm_head"):
            if name in tree:
                setattr(self, name, _param(tree[name]))
        self._weights: dict = {}

    def weights(self, dtype) -> dict:
        """The parameters the layers compute with in ``dtype``: each
        block's matmul weights (and its MoE router) cast to ``dtype``, its
        norms' scales as they are; the embedding cast, and the head (the
        embedding's transpose when tied).  Cast at first use and kept
        until a parameter changes in place (keyed on the parameters'
        version counters, which an in-place update of the stacked leaves
        they view moves too): a parameter already in ``dtype`` is used as
        it is."""
        version = tuple(p._version for p in self.parameters())
        kept = self._weights.get(dtype)
        w = kept[1] if kept is not None and kept[0] == version else None
        if w is None:
            embed = self.embed.detach().to(dtype)
            layers = []
            for blk in self.blocks:
                p = {name: t.detach()
                     for name, t in blk.named_parameters(recurse=False)}
                for group in _GROUPS:
                    if hasattr(blk, group):
                        p[group] = {k: v.detach()
                                    for k, v in getattr(blk, group).items()}
                layers.append(_cast_layer(p, dtype))
            head = embed.T if self.cfg.tie_embeddings \
                else self.lm_head.detach().to(dtype)
            final_ln = getattr(self, "final_ln", None)
            w = dict(embed=embed, head=head, layers=layers,
                     final_ln=None if final_ln is None else final_ln.detach())
            self._weights[dtype] = (version, w)
        return w

    def forward(self, tokens, **kw):
        return forward(self, self.cfg, tokens, **kw)


def _slice(blocks: dict, i: int) -> dict:
    return {k: _slice(v, i) if isinstance(v, dict) else v[i]
            for k, v in blocks.items()}


# --------------------------------------------------------------------------
# blocks
# --------------------------------------------------------------------------

def _norm(cfg, x, scale):
    if cfg.nonparametric_ln:
        return L.nonparametric_ln(x)
    return L.rms_norm(x, scale)


def _qk_norm(x):
    x32 = x.to(torch.float32)
    return (x32 * torch.rsqrt(
        torch.mean(torch.square(x32), -1, keepdim=True) + 1e-6)).to(x.dtype)


def _qkv(cfg, p, x, positions):
    h = _norm(cfg, x, p.get("ln1"))
    q = torch.einsum("bsd,dhk->bshk", h, p["wq"])
    k = torch.einsum("bsd,dhk->bshk", h, p["wk"])
    # contiguous: the kernel takes each operand dense, as the cache holds it
    v = torch.einsum("bsd,dhk->bshk", h, p["wv"]).contiguous()
    if getattr(cfg, "qk_norm", False):
        q, k = _qk_norm(q), _qk_norm(k)
    q = L.apply_rope(q, positions, cfg.rope_theta)
    k = L.apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def attention_block(cfg, p, x, *, window, positions, kv_cache=None, pos=None,
                    slot_pos=None, kernel_backend: str = "auto"):
    """Returns (out, (k, v)), k/v for cache collection during prefill.
    ``p`` holds the layer's weights in the compute dtype
    (:meth:`Transformer.weights`).  Without ``kv_cache`` (prefill), a
    Python int ``window`` > 0 is one uniform across the layers and takes
    ``windowed_chunked_attention``; a numpy scalar window (the layers
    differ) is a mask in ``chunked_attention``: the reference's rule
    (its per-layer windows are traced arrays).  With ``kv_cache`` (k, v)
    the single token attends over it at ``pos``."""
    q, k, v = _qkv(cfg, p, x, positions)
    w = int(window)
    if kv_cache is None:  # prefill: attend within the sequence
        if _use_kernel(kernel_backend, x.device):
            out = _fa.flash_attention(q, k, v, window=max(w, 0))
        elif isinstance(window, int) and window > 0:
            out = L.windowed_chunked_attention(q, k, v, window=window)
        else:
            out = L.chunked_attention(q, k, v, window=w)
    else:  # decode: single token against the cache
        kc, vc = kv_cache
        out = _attend_cache(q, kc, vc, pos=pos, window=w, slot_pos=slot_pos,
                            kernel_backend=kernel_backend)
    out = torch.einsum("bshk,hkd->bsd", out, p["wo"])
    return out, (k, v)


def _attend_cache(q, kc, vc, *, pos, window: int, slot_pos=None,
                  kernel_backend: str = "auto"):
    """One token [B, 1, H, hd] at ``pos`` over the cache: the kernel over
    the whole cache with ``q_offset=pos`` (slot i holds position i), or
    ``decode_attention``.  A ring buffer's ``slot_pos`` has no kernel
    route: it needs ``kernel_backend="torch"``."""
    if _use_kernel(kernel_backend, q.device):
        if slot_pos is not None:
            raise ValueError("slot_pos has no kernel route; pass "
                             "kernel_backend='torch'")
        return _fa.flash_attention(q, kc, vc, window=max(window, 0),
                                   q_offset=int(pos))
    return L.decode_attention(q, kc, vc, pos=pos, slot_pos=slot_pos,
                              window=window)


def ffn_block(cfg, p, x):
    """Returns (out, aux)."""
    h = _norm(cfg, x, p.get("ln2"))
    aux = {}
    if cfg.moe is not None:
        B, S, d = h.shape
        y, aux = moe_lib.moe_ffn(h.reshape(B * S, d), p["moe"], cfg.moe)
        y = y.reshape(B, S, d)
        if cfg.moe.n_shared:
            sp = p["shared"]
            y = y + L.swiglu(h, sp["w_gate"], sp["w_up"], sp["w_down"])
    elif cfg.gated_ffn:
        mp = p["mlp"]
        y = L.swiglu(h, mp["w_gate"], mp["w_up"], mp["w_down"])
    else:
        mp = p["mlp"]
        u = torch.einsum("...d,df->...f", h, mp["w_up"])
        y = torch.einsum("...f,fd->...d", F.gelu(u, approximate="tanh"),
                         mp["w_down"])
    return y, aux


def block(cfg, p, x, *, window, positions, kernel_backend: str = "auto"):
    a, kv = attention_block(cfg, p, x, window=window, positions=positions,
                            kernel_backend=kernel_backend)
    x = x + a
    f, aux = ffn_block(cfg, p, x)
    x = x + f
    return x, kv, aux


# --------------------------------------------------------------------------
# forward (prefill; serving, without gradients)
# --------------------------------------------------------------------------

@torch.no_grad()
def forward(params: Transformer, cfg: TransformerConfig, tokens, *,
            collect_cache=False, kernel_backend: str = "auto"):
    """tokens [B, S] -> logits [B, S, V] in the compute dtype, and the
    summed MoE aux losses (a float32 scalar); with ``collect_cache`` also
    each layer's (k, v), between them."""
    cdt = DTYPES[cfg.compute_dtype]
    W = params.weights(cdt)
    B, S = tokens.shape
    x = W["embed"][tokens.long()]
    positions = torch.arange(S, device=x.device)[None, :]
    windows = layer_windows(cfg)
    # a window uniform across the layers is passed as an int, so the plain
    # path skips the out-of-window KV chunks (the reference's static window)
    uniform_w = int(windows[0]) if len(set(windows.tolist())) == 1 else None
    caches = []
    moe_loss = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(cfg.n_layers):
        window = uniform_w if uniform_w is not None else windows[i]
        x, kv, aux = block(cfg, W["layers"][i], x, window=window,
                           positions=positions, kernel_backend=kernel_backend)
        for name in ("load_balance_loss", "router_z_loss"):
            if name in aux:
                moe_loss = moe_loss + aux[name]
        caches.append(kv)
    x = _norm(cfg, x, W["final_ln"])
    logits = torch.einsum("bsd,dv->bsv", x, W["head"])
    if collect_cache:
        return logits, caches, moe_loss
    return logits, moe_loss


# --------------------------------------------------------------------------
# training: the differentiable forward and the loss
# --------------------------------------------------------------------------

def _layers_of(blocks: dict, n: int) -> list:
    """The stacked block leaves [L, ...] as ``n`` per-layer dicts of views:
    one ``unbind`` a leaf, whose backward stacks the layers' gradients
    once."""
    per = [{} for _ in range(n)]
    for name, t in blocks.items():
        if isinstance(t, dict):
            for i, sub in enumerate(_layers_of(t, n)):
                per[i][name] = sub
        else:
            for i, view in enumerate(torch.unbind(t, 0)):
                per[i][name] = view
    return per


def _cast_layer(p: dict, cdt) -> dict:
    """One layer's leaves as the layers compute with them (what
    :meth:`Transformer.weights` keeps): the attention matrices and the
    ``mlp``, ``moe`` and ``shared`` groups in ``cdt``, the norms' scales
    as they are."""
    return {name: ({k: v.to(cdt) for k, v in t.items()}
                   if isinstance(t, dict)
                   else t.to(cdt) if name in _MATMUL else t)
            for name, t in p.items()}


def train_forward(params: dict, cfg: TransformerConfig, tokens, *,
                  kernel_backend: str = "auto"):
    """tokens [B, S] -> (logits [B, S, V] in the compute dtype, the summed
    MoE aux losses, a float32 scalar), differentiable with respect to the
    leaves of ``params``, the reference's tree (``embed``, stacked
    ``blocks`` [L, ...], ``final_ln``, ``lm_head``).  Each layer casts its
    slices to the compute dtype inside autograd; with ``cfg.remat`` it
    runs under ``torch.utils.checkpoint`` (nothing saved but its input;
    recomputed in the backward)."""
    cdt = DTYPES[cfg.compute_dtype]
    B, S = tokens.shape
    x = params["embed"][tokens.long()].to(cdt)
    positions = torch.arange(S, device=x.device)[None, :]
    windows = layer_windows(cfg)
    uniform_w = int(windows[0]) if len(set(windows.tolist())) == 1 else None
    layers = _layers_of(params["blocks"], cfg.n_layers)
    zero = torch.zeros((), dtype=torch.float32, device=x.device)

    def body(x, p, window):
        y, _, aux = block(cfg, _cast_layer(p, cdt), x, window=window,
                          positions=positions, kernel_backend=kernel_backend)
        return y, (aux.get("load_balance_loss", zero)
                   + aux.get("router_z_loss", zero))

    moe_loss = zero
    for i in range(cfg.n_layers):
        window = uniform_w if uniform_w is not None else windows[i]
        if cfg.remat:
            x, aux = checkpoint(body, x, layers[i], window,
                                use_reentrant=False, preserve_rng_state=False)
        else:
            x, aux = body(x, layers[i], window)
        moe_loss = moe_loss + aux
    x = _norm(cfg, x, params.get("final_ln"))
    head = params["embed"].T if cfg.tie_embeddings else params["lm_head"]
    logits = torch.einsum("bsd,dv->bsv", x, head.to(cdt))
    return logits, moe_loss


def loss_fn(params: dict, cfg: TransformerConfig, batch, *,
            kernel_backend: str = "auto"):
    """The reference's next-token loss: ``batch["tokens"]`` [B, S + 1];
    returns (loss, {"loss", "nll", "moe_loss", "acc"}), float32 scalars:
    nll the mean of logsumexp(logits) - the gold logit in float32, loss
    nll plus the MoE aux losses, acc the share of argmax hits."""
    tokens = batch["tokens"]
    inputs, labels = tokens[:, :-1], tokens[:, 1:].long()
    logits, moe_loss = train_forward(params, cfg, inputs,
                                     kernel_backend=kernel_backend)
    logits = logits.to(torch.float32)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None])[..., 0]
    nll = torch.mean(logz - gold)
    loss = nll + moe_loss
    acc = torch.mean((torch.argmax(logits, -1) == labels).to(torch.float32))
    return loss, {"loss": loss, "nll": nll, "moe_loss": moe_loss, "acc": acc}


# --------------------------------------------------------------------------
# serving: prefill + decode with per-layer caches
# --------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               device=None):
    """Uniform full KV caches in the compute dtype, zeros, on ``device``
    (None: the CUDA device, or a ``RuntimeError``)."""
    device = resolve_device(device)
    KV, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cdt = DTYPES[cfg.compute_dtype]
    return {f"layer_{i}": {
        "k": torch.zeros((batch, max_len, KV, hd), dtype=cdt, device=device),
        "v": torch.zeros((batch, max_len, KV, hd), dtype=cdt, device=device)}
        for i in range(cfg.n_layers)}


def cache_logical_axes(cfg: TransformerConfig):
    return ("batch", "kv_seq", "kv_heads", None)


def prefill(params: Transformer, cfg: TransformerConfig, tokens, *,
            kernel_backend: str = "auto"):
    """Returns (last_logits [B, V], cache dict of each layer's k and v
    [B, S, KV, hd])."""
    logits, caches, _ = forward(params, cfg, tokens, collect_cache=True,
                                kernel_backend=kernel_backend)
    cache = {f"layer_{i}": {"k": k, "v": v}
             for i, (k, v) in enumerate(caches)}
    return logits[:, -1], cache


@torch.no_grad()
def decode_step(params: Transformer, cfg: TransformerConfig, cache, token,
                pos, *, kernel_backend: str = "auto"):
    """token [B] int, pos the position being generated (an int).

    Writes K/V at slot ``pos % S_max`` of each layer's cache, in place
    (the reference returns an updated copy), and attends over slots <=
    pos.  Returns (logits [B, V], the cache).
    """
    cdt = DTYPES[cfg.compute_dtype]
    W = params.weights(cdt)
    pos = int(pos)
    B = token.shape[0]
    x = W["embed"][token.long()][:, None, :]  # [B, 1, d]
    positions = torch.full((B, 1), pos, device=x.device)
    windows = layer_windows(cfg)
    for i in range(cfg.n_layers):
        p = W["layers"][i]
        lc = cache[f"layer_{i}"]
        S_max = lc["k"].shape[1]
        slot = pos % S_max  # full cache: slot == pos; ring buffer: wraps
        q, k, v = _qkv(cfg, p, x, positions)
        lc["k"][:, slot] = k[:, 0]
        lc["v"][:, slot] = v[:, 0]
        out = _attend_cache(q, lc["k"], lc["v"], pos=pos,
                            window=int(windows[i]),
                            kernel_backend=kernel_backend)
        x = x + torch.einsum("bshk,hkd->bsd", out, p["wo"])
        f, _ = ffn_block(cfg, p, x)
        x = x + f
    x = _norm(cfg, x, W["final_ln"])
    logits = torch.einsum("bsd,dv->bsv", x, W["head"])[:, 0]
    return logits, cache
