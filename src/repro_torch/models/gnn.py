"""GNN family: GIN, GatedGCN, GraphSAGE over a shared packed-graph batch,
the port's copy of the reference's ``models/gnn.py`` (its forward;
``loss_fn`` is training and is not ported yet).

Message passing is gather -> (edge compute) -> segment-scatter over an
edge list, as in the reference, with torch's segment reductions
(``index_add_`` for its ``jax.ops.segment_sum``, ``scatter_reduce`` for
its ``segment_max``).

Batch format (tensors, fixed-shape, padded, maskable):
  node_feat [N, F] · edge_src/edge_dst [E] · node_mask [N] · edge_mask [E]
  labels [N] (node tasks) or [G] + graph_ids [N] (graph tasks)
  seed_mask [N] (minibatch: loss restricted to seed nodes)
  neighbors [N, M] int32 (optional: a fixed-degree neighbour matrix of
  the same edges, sentinel N past a row's degree; ``SampledStream``'s)

The kernel route: GraphSAGE with the ``"mean"`` or ``"sum"`` aggregator
over a batch that carries ``"neighbors"`` computes each layer's
``aggregate(h[src], dst) @ w_nbr`` as one :func:`neighbor_product` call,
which on a CUDA tensor launches the hand-written ``packed_spmm`` kernel
(``repro_torch.kernels.segment_matmul``: one launch a layer at
minibatch_lg's d = f = 128) and on the CPU, or with
``kernel_backend="torch"`` on any device, takes that kernel's plain
version, the same function (a float32 sum in lane order, a division by
max(count, 1), then the product).  Nothing falls back: ``"cuda"`` on a
CPU tensor raises.  A row whose lanes are all the sentinel gives 0, the
reference's ``s / max(cnt, 1)``.  Every other case takes the edge list:
GIN, GatedGCN, the ``"max"`` aggregator and batches without
``"neighbors"`` (the ragged full graphs).

The model is a :class:`GNN` module whose parameter names are the
reference's leaves in its layouts (the layer axis first); every function
takes either the module or a nested dict of tensors in the same layout
(``init_params(schema(...), ...)``).  Arithmetic runs in the parameters'
dtype (float32, as the reference's), the layer norms in at least float32;
a float64 model on float64 inputs is a float64 reference.  On the card
the float32 products need TF32 off (``torch.backends.cuda.matmul.
allow_tf32``, False by default), which the port does not change.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import GNNConfig
from repro_torch.kernels import segment_matmul as _sm
from repro_torch.models.module import (  # noqa: F401
    ParamSpec, TreeModule, as_tree, batch_to, use_kernel)


def _mlp_schema(name_dims, logical=("fsdp", "mlp")):
    din, dh, dout = name_dims
    return {
        "w1": ParamSpec((din, dh), logical),
        "b1": ParamSpec((dh,), (None,), init="zeros"),
        "w2": ParamSpec((dh, dout), (logical[1], logical[0])),
        "b2": ParamSpec((dout,), (None,), init="zeros"),
    }


def _mlp(p, x):
    h = torch.relu(x @ p["w1"] + p["b1"])
    return h @ p["w2"] + p["b2"]


def schema(cfg: GNNConfig, d_feat: int, n_classes: int) -> dict:
    d, Ln = cfg.d_hidden, cfg.n_layers
    sch: dict = {
        "encoder": {
            "w": ParamSpec((d_feat, d), ("fsdp", None)),
            "b": ParamSpec((d,), (None,), init="zeros"),
        },
        "decoder": {
            "w": ParamSpec((d, n_classes), (None, None)),
            "b": ParamSpec((n_classes,), (None,), init="zeros"),
        },
    }
    if cfg.kind == "gin":
        sch["layers"] = {
            "mlp": {k: ParamSpec((Ln,) + s.shape, ("layers",) + s.logical_axes,
                                 init=s.init, scale=s.scale)
                    for k, s in _mlp_schema((d, 2 * d, d)).items()},
            # LN between layers (the reference's stand-in for BatchNorm)
            "ln": ParamSpec((Ln, d), ("layers", None), init="zeros"),
        }
        if cfg.learnable_eps:
            sch["layers"]["eps"] = ParamSpec((Ln,), ("layers",), init="zeros")
    elif cfg.kind == "gatedgcn":
        def lin(shape, axes):
            return ParamSpec((Ln,) + shape, ("layers",) + axes)

        sch["layers"] = {
            "A": lin((d, d), (None, None)), "B": lin((d, d), (None, None)),
            "C": lin((d, d), (None, None)), "U": lin((d, d), (None, None)),
            "V": lin((d, d), (None, None)),
            "ln_h": ParamSpec((Ln, d), ("layers", None), init="zeros"),
            "ln_e": ParamSpec((Ln, d), ("layers", None), init="zeros"),
        }
        sch["edge_init"] = ParamSpec((d,), (None,), init="normal", scale=0.1)
    elif cfg.kind == "graphsage":
        sch["layers"] = {
            "w_self": ParamSpec((Ln, d, d), ("layers", None, None)),
            "w_nbr": ParamSpec((Ln, d, d), ("layers", None, None)),
            "b": ParamSpec((Ln, d), ("layers", None), init="zeros"),
        }
    else:
        raise ValueError(cfg.kind)
    return sch


class GNN(TreeModule):
    """The model: ``encoder``, ``decoder``, ``layers`` (the stacked
    per-layer leaves) and GatedGCN's ``edge_init``, built from a tree in
    the reference's layout (``init_params(schema(cfg, d_feat,
    n_classes), ...)`` or ``convert.gnn_params_from_reference``)."""

    def __init__(self, cfg: GNNConfig, tree: dict):
        super().__init__(tree)
        self.cfg = cfg

    def forward(self, batch, **kw):
        return forward(self, self.cfg, batch, **kw)


# --------------------------------------------------------------------------
# message-passing primitives
# --------------------------------------------------------------------------

def segment_sum(x, ids, n: int):
    """Sum the rows of ``x`` [E, ...] into ``n`` segments by ``ids`` [E]."""
    out = torch.zeros((n,) + tuple(x.shape[1:]), dtype=x.dtype,
                      device=x.device)
    return out.index_add_(0, ids.long(), x)


def aggregate(messages, dst, n_nodes: int, *, kind: str, edge_mask=None):
    """segment-reduce messages [E, d] by dst -> [N, d].  ``"max"``: a node
    whose edges are all masked gets the dtype's finite minimum (the
    reference's), a node with no edge 0."""
    if edge_mask is not None:
        messages = torch.where(edge_mask[:, None], messages, 0.0)
    if kind == "sum":
        return segment_sum(messages, dst, n_nodes)
    if kind == "mean":
        s = segment_sum(messages, dst, n_nodes)
        ones = (edge_mask.to(messages.dtype) if edge_mask is not None
                else torch.ones((messages.shape[0],), dtype=messages.dtype,
                                device=messages.device))
        cnt = segment_sum(ones, dst, n_nodes)
        return s / torch.clamp(cnt, min=1.0)[:, None]
    if kind == "max":
        if edge_mask is not None:
            messages = torch.where(edge_mask[:, None], messages,
                                   torch.finfo(messages.dtype).min)
        m = torch.full((n_nodes, messages.shape[1]), -torch.inf,
                       dtype=messages.dtype, device=messages.device)
        m = m.scatter_reduce(0, dst.long()[:, None].expand_as(messages),
                             messages, "amax", include_self=True)
        return torch.where(torch.isfinite(m), m, 0.0)
    raise ValueError(kind)


def neighbor_product(neighbors, h, w, *, combine: str,
                     kernel_backend: str = "auto"):
    """``aggregate`` of ``h``'s rows over each row of ``neighbors`` [N, M]
    (sentinel ids >= h.shape[0] skipped), then ``@ w``: the hand-written
    ``packed_spmm`` kernel on the card, its plain version elsewhere."""
    if use_kernel(kernel_backend, h.device):
        return _sm.packed_spmm(neighbors, h, w, combine=combine)
    return _sm.packed_spmm_plain(neighbors, h, w, combine=combine)


def _wide(x):
    """x in at least float32 (the reference's ``astype(float32)``; a
    float64 reference stays float64)."""
    return x.to(torch.promote_types(x.dtype, torch.float32))


def _ln(x, scale):
    x32 = _wide(x)
    mu = x32.mean(-1, keepdim=True)
    var = x32.var(-1, keepdim=True, correction=0)
    return ((x32 - mu) * torch.rsqrt(var + 1e-5)
            * (1 + _wide(scale))).to(x.dtype)


def kernel_route(cfg: GNNConfig, batch) -> bool:
    """Whether ``forward`` takes the ``packed_spmm`` route (see the module
    note)."""
    return cfg.kind == "graphsage" and cfg.aggregator in ("mean", "sum") \
        and "neighbors" in batch


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def forward(params, cfg: GNNConfig, batch, *, kernel_backend: str = "auto"):
    """Returns logits: [N, n_classes] (node tasks) or [G, n_classes]."""
    p = as_tree(params)
    use_kernel(kernel_backend, batch["node_feat"].device)   # validates
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    emask = batch.get("edge_mask")
    nmask = batch.get("node_mask")
    N = batch["node_feat"].shape[0]
    h = batch["node_feat"] @ p["encoder"]["w"] + p["encoder"]["b"]
    lp = p["layers"]
    nbrs = batch["neighbors"] if kernel_route(cfg, batch) else None

    if cfg.kind == "gatedgcn":
        e = p["edge_init"].expand(src.shape[0], cfg.d_hidden)

    for i in range(cfg.n_layers):
        li = {k: (v[i] if not isinstance(v, dict)
                  else {kk: vv[i] for kk, vv in v.items()})
              for k, v in lp.items()}
        if cfg.kind == "gin":
            agg = aggregate(h[src], dst, N, kind="sum", edge_mask=emask)
            eps = li.get("eps", 0.0)
            h_new = _mlp(li["mlp"], (1.0 + eps) * h + agg)
            h = torch.relu(_ln(h_new, li["ln"]))
        elif cfg.kind == "gatedgcn":
            e_new = h[src] @ li["A"] + h[dst] @ li["B"] + e @ li["C"]
            eta = torch.sigmoid(e_new)
            msg = eta * (h[src] @ li["V"])
            num = aggregate(msg, dst, N, kind="sum", edge_mask=emask)
            den = aggregate(eta, dst, N, kind="sum", edge_mask=emask)
            h_new = h @ li["U"] + num / (den + 1e-6)
            h = h + torch.relu(_ln(h_new, li["ln_h"]))     # residual
            e = e + torch.relu(_ln(e_new, li["ln_e"]))
        elif cfg.kind == "graphsage":
            if nbrs is not None:
                nb = neighbor_product(nbrs, h, li["w_nbr"],
                                      combine=cfg.aggregator,
                                      kernel_backend=kernel_backend)
            else:
                nb = aggregate(h[src], dst, N, kind=cfg.aggregator,
                               edge_mask=emask) @ li["w_nbr"]
            h = torch.relu(h @ li["w_self"] + nb + li["b"])
            h = h / torch.clamp(torch.linalg.vector_norm(
                h, dim=-1, keepdim=True), min=1e-6)
        else:
            raise ValueError(cfg.kind)

    # parameter-free LN ahead of the decoder
    h32 = _wide(h)
    h = (h32 - h32.mean(-1, keepdim=True)) \
        * torch.rsqrt(h32.var(-1, keepdim=True, correction=0) + 1e-5)

    if "graph_ids" in batch:  # graph-level readout (molecule shape)
        if nmask is not None:
            h = torch.where(nmask[:, None], h, 0.0)
        n_graphs = batch["labels"].shape[0]
        pooled = segment_sum(h, batch["graph_ids"], n_graphs)
        ones = (nmask.to(h.dtype) if nmask is not None
                else torch.ones(h.shape[0], dtype=h.dtype, device=h.device))
        cnt = segment_sum(ones, batch["graph_ids"], n_graphs)
        pooled = pooled / torch.clamp(cnt, min=1.0)[:, None]   # mean pool
        return pooled @ p["decoder"]["w"] + p["decoder"]["b"]
    return h @ p["decoder"]["w"] + p["decoder"]["b"]
