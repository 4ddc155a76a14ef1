"""Wide & Deep [arXiv:1606.07792] with a real EmbeddingBag: the port's copy
of the reference's ``models/recsys.py`` (its serving path: ``forward``,
``serve_step``, ``retrieval_step``; and the training loss ``loss_fn``).

The model is a :class:`WideDeep` module whose parameter names are the
reference's leaves (``tables.field_<i>``, ``wide``, ``mlp.w<i>`` /
``mlp.b<i>``, ``head``, ``retrieval_proj``) in its layouts.  Every
function takes either the module or a nested dict of tensors in the same
layout (``init_params(schema(cfg), ...)``).

The bag fields (``cfg.multi_hot_fields``): on a CUDA tensor
:func:`embedding_bag` launches the hand-written kernel
``repro_torch.kernels.embedding_bag`` (one launch a bag field a step); on
the CPU, or with ``kernel_backend="torch"`` on any device, it takes that
kernel's plain version, the same function (take, then a float32 sum in
bag order and a true division) in plain PyTorch.  Nothing falls back:
``"cuda"`` on a CPU tensor raises.  Training differentiates the same
call: on the card the kernel's autograd ``Function``, whose backward is
the hand-written ``embedding_bag_bwd`` (a dense table gradient); elsewhere
autograd of the plain version.  The single-id fields are a plain gather,
as the reference's ``jnp.take`` is (its gradient autograd's
``index_put_`` with accumulation, as the reference computes it outside
any kernel); the MLP and the retrieval
GEMM stay ``torch.matmul``, as the reference leaves them to XLA.

The reference computes in float32 throughout (it never casts to
``compute_dtype``), and so does the port: on the card its float32
products need TF32 off (``torch.backends.cuda.matmul.allow_tf32``, False
by default), which the port does not change.  ``with_logical`` (the
reference's sharding annotations) has no counterpart: the port's model
runs on one device.  The :class:`WideDeep` module's parameters need no
gradient (serving); the trainer differentiates the nested tree
(``init_params(schema(cfg), ...)``), which every function takes too.
"""
from __future__ import annotations

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import RecsysConfig
from repro_torch.kernels import embedding_bag as _eb
from repro_torch.models.module import (  # noqa: F401
    ParamSpec, batch_to, use_kernel)

RETRIEVAL_DIM = 64
# the wide branch's multiplicative hash (Knuth's 2^32 / golden ratio)
_HASH_MUL = 2654435761
_U32 = 0xFFFFFFFF


def schema(cfg: RecsysConfig) -> dict:
    E = cfg.embed_dim
    tables = {
        f"field_{i}": ParamSpec((v, E), ("table", None), init="embed",
                                scale=0.05)
        for i, v in enumerate(cfg.vocab_sizes)
    }
    deep_in = cfg.n_sparse * E + cfg.n_dense
    dims = (deep_in,) + tuple(cfg.mlp)
    mlp = {}
    for i in range(len(cfg.mlp)):
        mlp[f"w{i}"] = ParamSpec((dims[i], dims[i + 1]), ("fsdp", "mlp"))
        mlp[f"b{i}"] = ParamSpec((dims[i + 1],), (None,), init="zeros")
    return {
        "tables": tables,
        "wide": ParamSpec((cfg.wide_hash_buckets, 1), ("table", None),
                          init="zeros"),
        "mlp": mlp,
        "head": ParamSpec((cfg.mlp[-1], 1), (None, None)),
        "retrieval_proj": ParamSpec((cfg.mlp[-1], RETRIEVAL_DIM),
                                    (None, None)),
    }


# --------------------------------------------------------------------------
# the module
# --------------------------------------------------------------------------

def _param(t) -> nn.Parameter:
    return nn.Parameter(t, requires_grad=False)


class WideDeep(nn.Module):
    """The model: ``tables`` (one [V_i, E] table a field), ``wide``
    [buckets, 1], ``mlp`` (``w<i>``, ``b<i>``), ``head`` and
    ``retrieval_proj``, built from a tree in the reference's layout
    (``init_params(schema(cfg), ...)`` or
    ``convert.recsys_params_from_reference``)."""

    def __init__(self, cfg: RecsysConfig, tree: dict):
        super().__init__()
        self.cfg = cfg
        self.tables = nn.ParameterDict(
            {k: _param(v) for k, v in tree["tables"].items()})
        self.mlp = nn.ParameterDict(
            {k: _param(v) for k, v in tree["mlp"].items()})
        for name in ("wide", "head", "retrieval_proj"):
            setattr(self, name, _param(tree[name]))

    def forward(self, batch, **kw):
        return forward(self, self.cfg, batch, **kw)


def _get(params, name):
    """A leaf or group of the module or of a nested dict alike."""
    return params[name] if isinstance(params, dict) else getattr(params,
                                                                 name)


# --------------------------------------------------------------------------
# embedding bag — the kernel on the card, its plain version elsewhere
# --------------------------------------------------------------------------

def embedding_bag(table, ids, *, combine: str = "mean",
                  kernel_backend: str = "auto"):
    """table [V, E]; ids [B, bag] int32, contiguous -> [B, E]."""
    if use_kernel(kernel_backend, table.device):
        return _eb.embedding_bag(table, ids, combine=combine)
    return _eb.embedding_bag_plain(table, ids, combine=combine)


def _hash(x, a: int, buckets: int):
    """The reference's ``(uint32(x) * 2654435761 + a) % buckets`` with
    uint32 arithmetic that wraps, in int64: x's low 32 bits (an int32's
    uint32 cast), the product's low 32 bits from two partial products
    that stay below 2^49, then the add's."""
    x = x.to(torch.int64) & _U32
    lo = (x & 0xFFFF) * _HASH_MUL
    hi = (((x >> 16) * _HASH_MUL) & 0xFFFF) << 16
    h = (((lo + hi) & _U32) + a) & _U32
    return (h % buckets).to(torch.int32)


def wide_indices(cfg: RecsysConfig, sparse):
    """The wide branch's bucket of each unary hash and of each pairwise
    cross of the first 8 fields: [B, n_sparse + 28]."""
    sparse = sparse.to(torch.int64)
    wide_idx = [_hash(sparse[:, i] + 7919 * i, 13 * i + 1,
                      cfg.wide_hash_buckets) for i in range(cfg.n_sparse)]
    nc = min(8, cfg.n_sparse)
    for i in range(nc):
        for j in range(i + 1, nc):
            cross = sparse[:, i] * 31 + sparse[:, j]
            wide_idx.append(_hash(cross, 97 * (i * nc + j) + 3,
                                  cfg.wide_hash_buckets))
    return torch.stack(wide_idx, dim=1)


# --------------------------------------------------------------------------
# towers
# --------------------------------------------------------------------------

def user_tower(params, cfg: RecsysConfig, batch, *,
               kernel_backend: str = "auto"):
    """-> deep activations [B, mlp[-1]] plus the wide logit [B].  The bag
    fields' ids are copied once into one contiguous [n_multi, B, bag]
    tensor, whose rows are the kernel's ids."""
    tables = _get(params, "tables")
    sparse = batch["sparse_ids"]                              # [B, n_sparse]
    multi = list(cfg.multi_hot_fields)
    bags = batch["bags"].to(torch.int32).transpose(0, 1).contiguous()
    embs = []
    for i in range(cfg.n_sparse):
        t = tables[f"field_{i}"]
        if i in multi:
            embs.append(embedding_bag(t, bags[multi.index(i)],
                                      kernel_backend=kernel_backend))
        else:
            embs.append(t[sparse[:, i].long()])
    x = torch.cat(embs + [batch["dense"]], dim=-1)
    mp = _get(params, "mlp")
    for i in range(len(cfg.mlp)):
        x = torch.relu(x @ mp[f"w{i}"] + mp[f"b{i}"])
    widx = wide_indices(cfg, sparse)
    wide_logit = _get(params, "wide")[widx.long(), 0].sum(dim=1)
    return x, wide_logit


def forward(params, cfg: RecsysConfig, batch, *,
            kernel_backend: str = "auto"):
    """CTR logit [B]."""
    deep, wide_logit = user_tower(params, cfg, batch,
                                  kernel_backend=kernel_backend)
    return (deep @ _get(params, "head"))[:, 0] + wide_logit


def serve_step(params, cfg: RecsysConfig, batch, *,
               kernel_backend: str = "auto"):
    """Online/bulk inference: calibrated CTR."""
    return torch.sigmoid(forward(params, cfg, batch,
                                 kernel_backend=kernel_backend))


def retrieval_step(params, cfg: RecsysConfig, batch, *,
                   kernel_backend: str = "auto"):
    """Score 1 user against ``n_candidates`` item vectors in one GEMM;
    top-100: (ids int32, scores), best first.

    batch: user features (batch=1) + item_vectors [n_cand, RETRIEVAL_DIM].
    """
    deep, _ = user_tower(params, cfg, batch, kernel_backend=kernel_backend)
    u = deep @ _get(params, "retrieval_proj")                 # [1, Dv]
    scores = (u @ batch["item_vectors"].T)[0]                 # [n_cand]
    top, idx = torch.topk(scores, 100)
    return idx.to(torch.int32), top


def loss_fn(params, cfg: RecsysConfig, batch):
    """The mean logistic loss in its stable form, ``max(z, 0) - z y +
    log1p(exp(-|z|))``, and ``acc``, the share of rows whose logit's sign
    matches the label (the reference's ``loss_fn``).  Returns (loss,
    {"loss", "acc"})."""
    logit = forward(params, cfg, batch)
    logit = logit.to(torch.promote_types(logit.dtype, torch.float32))
    y = batch["labels"].to(logit.dtype)
    loss = torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))
    acc = torch.mean(((logit > 0) == (y > 0.5)).to(logit.dtype))
    return loss, {"loss": loss, "acc": acc}
