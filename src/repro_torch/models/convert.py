"""Carry the reference's weights into the port.

:func:`params_from_reference` takes the reference's ``init_params`` tree
(``src/repro/models/transformer.py``'s schema: ``embed``, the stacked
``blocks`` leaves [L, ...], ``final_ln``, ``lm_head``) as numpy arrays and
returns the port's :class:`~repro_torch.models.transformer.Transformer`
with the same bits: the layouts are the same, so each leaf is a copy, and
each block's parameters are slices of the stacked leaves.  Every leaf of
the reference maps to exactly one parameter of the port and no parameter
is left unset; anything else raises.  :func:`recsys_params_from_reference`
does the same for Wide & Deep (``src/repro/models/recsys.py``'s schema)
into the port's :class:`~repro_torch.models.recsys.WideDeep`,
:func:`gnn_params_from_reference` for GIN, GatedGCN and GraphSAGE
(``src/repro/models/gnn.py``) into :class:`~repro_torch.models.gnn.GNN`
and :func:`mace_params_from_reference` for MACE
(``src/repro/models/mace.py``) into :class:`~repro_torch.models.mace.MACE`.
:func:`opt_state_from_reference` carries an optimizer's state (AdamW's
``m``, ``v``, ``count``; Adafactor's ``slots``, ``count``), so both
packages can continue from the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import (GNNConfig, RecsysConfig,
                                      TransformerConfig)
from repro_torch.device import resolve_device
from repro_torch.models import gnn as G
from repro_torch.models import mace as MC
from repro_torch.models import recsys as R
from repro_torch.models import transformer as T
from repro_torch.models.module import leaves


def _tensor(a, device) -> torch.Tensor:
    """A copy of the array on ``device`` (the caller's array may be
    read-only, as a JAX array's numpy view is)."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":   # ml_dtypes' bfloat16: the raw bits
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a)).to(device)


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, t in flat.items():
        node = tree
        *parents, name = path.split(".")
        for key in parents:
            node = node.setdefault(key, {})
        node[name] = t
    return tree


def _checked(tree: dict, sch: dict, device) -> dict:
    """The reference's tree as tensors on ``device``, in its nested
    layout, after checking that it holds exactly the schema's leaves at
    the schema's shapes."""
    want = dict(leaves(sch))
    got = dict(leaves(tree))
    if set(got) != set(want):
        raise ValueError(f"leaves missing {sorted(set(want) - set(got))}, "
                         f"unknown {sorted(set(got) - set(want))}")
    for path, spec in want.items():
        if tuple(np.shape(got[path])) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {np.shape(got[path])}, the "
                             f"schema's {spec.shape}")
    return _unflatten({path: _tensor(a, device) for path, a in got.items()})


def params_from_reference(tree: dict, cfg: TransformerConfig,
                          device=None) -> T.Transformer:
    """The reference's parameter tree (numpy arrays) -> the port's model on
    ``device`` (None: the CUDA device, or a ``RuntimeError``).  The tree
    must hold exactly the schema's leaves, at the schema's shapes."""
    device = resolve_device(device)
    sch = T.schema(cfg)
    model = T.Transformer(cfg, _checked(tree, sch, device))
    n_params = sum(1 for _ in model.parameters())
    n_leaves = sum(cfg.n_layers if path.startswith("blocks.") else 1
                   for path, _ in leaves(sch))
    if n_params != n_leaves:
        raise ValueError(f"{n_params} parameters for {n_leaves} leaf slices")
    return model


def _tree_model(cls, cfg, tree: dict, sch: dict, device):
    model = cls(cfg, _checked(tree, sch, device))
    n_params = sum(1 for _ in model.parameters())
    n_leaves = sum(1 for _ in leaves(sch))
    if n_params != n_leaves:
        raise ValueError(f"{n_params} parameters for {n_leaves} leaves")
    return model


def recsys_params_from_reference(tree: dict, cfg: RecsysConfig,
                                 device=None) -> R.WideDeep:
    """The reference's Wide & Deep parameter tree (numpy arrays) -> the
    port's :class:`~repro_torch.models.recsys.WideDeep` on ``device``
    (None: the CUDA device, or a ``RuntimeError``), with the checks of
    :func:`params_from_reference`."""
    return _tree_model(R.WideDeep, cfg, tree, R.schema(cfg),
                       resolve_device(device))


def gnn_params_from_reference(tree: dict, cfg: GNNConfig, d_feat: int,
                              n_classes: int, device=None) -> G.GNN:
    """The reference's GIN, GatedGCN or GraphSAGE parameter tree (numpy
    arrays; ``schema(cfg, d_feat, n_classes)``) -> the port's
    :class:`~repro_torch.models.gnn.GNN` on ``device`` (None: the CUDA
    device, or a ``RuntimeError``), with the checks of
    :func:`params_from_reference`."""
    return _tree_model(G.GNN, cfg, tree, G.schema(cfg, d_feat, n_classes),
                       resolve_device(device))


def mace_params_from_reference(tree: dict, cfg: GNNConfig,
                               device=None) -> MC.MACE:
    """The reference's MACE parameter tree (numpy arrays) -> the port's
    :class:`~repro_torch.models.mace.MACE` on ``device`` (None: the CUDA
    device, or a ``RuntimeError``), with the checks of
    :func:`params_from_reference`."""
    return _tree_model(MC.MACE, cfg, tree, MC.schema(cfg),
                       resolve_device(device))


def _tensors(tree, device):
    if isinstance(tree, dict):
        return {k: _tensors(v, device) for k, v in tree.items()}
    return _tensor(tree, device)


def opt_state_from_reference(state: dict, device=None) -> dict:
    """The reference's optimizer state (numpy arrays: AdamW's ``{"m",
    "v", "count"}`` or Adafactor's ``{"slots", "count"}``) -> the port's,
    tensors on ``device`` (None: the CUDA device, or a ``RuntimeError``)
    with the same bits, ``count`` an int32 scalar.  Any other layout
    raises."""
    device = resolve_device(device)
    if set(state) not in ({"m", "v", "count"}, {"slots", "count"}):
        raise ValueError(f"an AdamW or Adafactor state, got keys "
                         f"{sorted(state)}")
    out = _tensors(state, device)
    out["count"] = out["count"].to(torch.int32).reshape(())
    return out
