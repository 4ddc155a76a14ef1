"""Carry a graph built by the JAX package into the port.

The arrays are the fields of the reference's ``PackedGraph`` as numpy
(``np.asarray`` of each, taken by the caller), so both packages can search
the very same graph.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.diversify import PackedGraph
from repro_torch.device import resolve_device


def graph_from_numpy(neighbors, lambdas, degrees, hubs=None, *,
                     device) -> PackedGraph:
    """numpy (or array-like) packed-graph fields -> a PackedGraph of int32
    tensors on ``device``."""
    device = resolve_device(device)

    def conv(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

    return PackedGraph(neighbors=conv(neighbors), lambdas=conv(lambdas),
                       degrees=conv(degrees),
                       hubs=None if hubs is None else conv(hubs))

