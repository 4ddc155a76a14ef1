"""Parameter schemas: the port's copy of the reference's
``models/module.py``.

A model declares a *schema*, a nested dict whose leaves are
:class:`ParamSpec` (shape, logical axis names, initializer).  From it
:func:`init_params` materialises a nested dict of tensors in the same
layout.  ``logical_axes`` is kept as metadata: the port's models run on
one device and carry no sharding annotations.

``init_params`` draws from an explicit ``torch.Generator``, so its values
differ from the reference's ``jax.random`` ones, but each leaf follows the
reference's distribution: ``normal`` and ``embed`` N(0, scale^2),
``fan_in`` N(0, (scale / sqrt(fan_in))^2) with the reference's fan_in
(``shape[0]`` for a leaf of at most two axes, else ``prod(shape[:-1])``,
the layer axis of a stacked leaf included), ``zeros`` and ``ones``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
from torch import nn

from repro_torch.configs.base import KERNEL_BACKENDS
from repro_torch.device import resolve_device

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """Declarative description of one parameter tensor."""

    shape: tuple
    logical_axes: tuple  # one logical axis name (or None) per dim
    init: str = "normal"  # normal | fan_in | zeros | ones | embed
    scale: float = 1.0
    dtype: str = "float32"

    def __post_init__(self):
        if len(self.shape) != len(self.logical_axes):
            raise ValueError(f"shape {self.shape} vs logical axes "
                             f"{self.logical_axes}")


def use_kernel(kernel_backend: str, device) -> bool:
    """Whether a model launches the hand-written kernels: ``"auto"`` on a
    CUDA tensor, ``"cuda"`` always (a CPU tensor raises), ``"torch"``
    never."""
    if kernel_backend not in KERNEL_BACKENDS:
        raise ValueError(f"kernel_backend={kernel_backend!r} must be one of "
                         f"{KERNEL_BACKENDS}")
    if kernel_backend == "cuda" and device.type != "cuda":
        raise ValueError("kernel_backend='cuda' needs CUDA tensors")
    return kernel_backend != "torch" and device.type == "cuda"


class TreeModule(nn.Module):
    """A nested dict of tensors as a module: each dict a submodule, each
    tensor a parameter (no gradients) under its own key, so the module's
    parameter names are the tree's dotted leaf paths.  :meth:`tree` gives
    the nested dict back, holding the parameters themselves."""

    def __init__(self, tree: dict):
        super().__init__()
        for key in sorted(tree):
            value = tree[key]
            if isinstance(value, dict):
                self.add_module(key, TreeModule(value))
            else:
                self.register_parameter(
                    key, nn.Parameter(value, requires_grad=False))

    def tree(self) -> dict:
        out = {k: p for k, p in self.named_parameters(recurse=False)}
        out.update((k, m.tree()) for k, m in self.named_children())
        return out


def batch_to(batch: dict, device) -> dict:
    """A batch of numpy arrays (a data stream's) as tensors on
    ``device``."""
    return {k: torch.as_tensor(np.asarray(v), device=device)
            for k, v in batch.items()}


def as_tree(params) -> dict:
    """A model's parameters as a nested dict: a :class:`TreeModule`'s
    :meth:`~TreeModule.tree`, or the dict itself."""
    return params.tree() if isinstance(params, TreeModule) else params


def is_param_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def leaves(tree, prefix: str = ""):
    """``(path, leaf)`` for each leaf of a nested dict (a schema's specs,
    or a parameter tree's arrays), depth first in key order (the order of
    the reference's ``jax.tree.flatten``); a path joins keys with dots."""
    if not isinstance(tree, dict):
        yield prefix, tree
        return
    for key in sorted(tree):
        yield from leaves(tree[key], f"{prefix}.{key}" if prefix else key)


def std(spec: ParamSpec) -> float:
    """The standard deviation of the leaf's initializer (0 for zeros and
    ones)."""
    if spec.init in ("zeros", "ones"):
        return 0.0
    if spec.init in ("normal", "embed"):
        return spec.scale
    if spec.init == "fan_in":
        shape = spec.shape
        fan_in = shape[0] if len(shape) <= 2 else int(np.prod(shape[:-1]))
        return spec.scale / math.sqrt(max(1, fan_in))
    raise ValueError(f"unknown init {spec.init}")


def _init_leaf(spec: ParamSpec, generator, device, dtype):
    dtype = dtype or DTYPES[spec.dtype]
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    x = torch.randn(spec.shape, generator=generator, device=device)
    return x.mul_(std(spec)).to(dtype)


def init_params(schema, generator: torch.Generator, device=None,
                dtype=None):
    """Materialise a schema into a nested dict of tensors on ``device``
    (None: the CUDA device, or a ``RuntimeError``), drawn from
    ``generator`` (which must live on that device) leaf by leaf in the
    order of :func:`leaves`.  ``dtype`` overrides each leaf's."""
    device = resolve_device(device)
    if is_param_spec(schema):
        return _init_leaf(schema, generator, device, dtype)
    return {key: init_params(schema[key], generator, device, dtype)
            for key in sorted(schema)}


def param_count(schema) -> int:
    return sum(int(np.prod(s.shape)) for _, s in leaves(schema))


def param_bytes(schema, bytes_per_param=None) -> int:
    return sum(int(np.prod(s.shape))
               * (bytes_per_param or DTYPES[s.dtype].itemsize)
               for _, s in leaves(schema))
