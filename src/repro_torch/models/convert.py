"""Carry the reference's language-model weights into the port.

:func:`params_from_reference` takes the reference's ``init_params`` tree
(``src/repro/models/transformer.py``'s schema: ``embed``, the stacked
``blocks`` leaves [L, ...], ``final_ln``, ``lm_head``) as numpy arrays and
returns the port's :class:`~repro_torch.models.transformer.Transformer`
with the same bits: the layouts are the same, so each leaf is a copy, and
each block's parameters are slices of the stacked leaves.  Every leaf of
the reference maps to exactly one parameter of the port and no parameter
is left unset; anything else raises.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import TransformerConfig
from repro_torch.device import resolve_device
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


def params_from_reference(tree: dict, cfg: TransformerConfig,
                          device=None) -> T.Transformer:
    """The reference's parameter tree (numpy arrays) -> the port's model on
    ``device`` (None: the CUDA device, or a ``RuntimeError``).  The tree
    must hold exactly the schema's leaves, at the schema's shapes."""
    device = resolve_device(device)
    want = dict(leaves(T.schema(cfg)))
    got = dict(leaves(tree))
    if set(got) != set(want):
        raise ValueError(f"leaves missing {sorted(set(want) - set(got))}, "
                         f"unknown {sorted(set(got) - set(want))}")
    for path, spec in want.items():
        if tuple(np.shape(got[path])) != tuple(spec.shape):
            raise ValueError(f"{path}: shape {np.shape(got[path])}, the "
                             f"schema's {spec.shape}")
    model = T.Transformer(cfg, _unflatten(
        {path: _tensor(a, device) for path, a in got.items()}))
    n_params = sum(1 for _ in model.parameters())
    n_leaves = sum(cfg.n_layers if path.startswith("blocks.") else 1
                   for path in want)
    if n_params != n_leaves:
        raise ValueError(f"{n_params} parameters for {n_leaves} leaf slices")
    return model
