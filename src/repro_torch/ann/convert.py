"""Carry state built by the JAX package into the port, from numpy.

* the graph: the fields of the reference's ``PackedGraph`` (``perm``
  included);
* the streaming state: ``(base_alive, delta_X, delta_alive)`` as the
  reference's ``StreamState.device_view()`` gives it, with the number of
  assigned delta slots (its ``stream.delta.count``).

The int8 residency needs no conversion: ``Index(quant=)`` takes the
reference plane's numpy ``(codes, scales)`` as they are.

The caller takes ``np.asarray`` of each array, so both packages can work
on the very same operands.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.diversify import PackedGraph
from repro_torch.device import resolve_device


def graph_from_numpy(neighbors, lambdas, degrees, hubs=None, perm=None, *,
                     device) -> PackedGraph:
    """numpy (or array-like) packed-graph fields -> a PackedGraph of int32
    tensors on ``device``; ``perm`` is a packed graph's locality
    permutation (new->old)."""
    device = resolve_device(device)

    def conv(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

    return PackedGraph(neighbors=conv(neighbors), lambdas=conv(lambdas),
                       degrees=conv(degrees),
                       hubs=None if hubs is None else conv(hubs),
                       perm=None if perm is None else conv(perm))



def stream_from_numpy(base_alive, delta_X, delta_alive, count):
    """The reference's stream triple -> a :class:`~repro_torch.ann.delta.
    StreamState` holding the same tombstones and delta rows, at the same
    capacity (``delta_X`` and ``delta_alive`` are capacity-padded).
    ``count`` is the number of assigned delta slots (the reference's
    ``stream.delta.count``): the triple cannot tell a deleted last add from
    an unfilled slot, and the next add's id is ``n_base + count``."""
    from repro_torch.ann.delta import StreamState

    base_alive = np.asarray(base_alive, bool)
    delta_X = np.asarray(delta_X, np.float32)
    delta_alive = np.asarray(delta_alive, bool)
    st = StreamState(base_alive.shape[0], delta_X.shape[1],
                     min_cap=delta_X.shape[0])
    st.base_alive[:] = base_alive
    count = int(count)
    if not 0 <= count <= delta_X.shape[0] or delta_alive[count:].any():
        raise ValueError(
            f"count={count}: the delta holds {delta_X.shape[0]} slots and "
            f"every live one must lie below count")
    st.delta.append(delta_X[:count])
    st.delta.alive[:] = delta_alive
    return st
