"""Global-norm gradient clipping: the port's copy of the reference's
``optim/clip.py``.  The squares are summed leaf by leaf in the reference's
flatten order (sorted keys)."""
from __future__ import annotations

import torch

from repro_torch.optim.tree import tree_leaves, tree_map


def global_norm(tree) -> torch.Tensor:
    total = 0
    for x in tree_leaves(tree):
        total = total + torch.sum(torch.square(x.to(torch.float32)))
    return torch.sqrt(total)


def clip_by_global_norm(tree, max_norm: float):
    """(the tree scaled by min(1, max_norm / (norm + 1e-12)), each leaf in
    its own dtype; the norm)."""
    norm = global_norm(tree)
    scale = torch.clamp(max_norm / (norm + 1e-12), max=1.0)
    return tree_map(lambda x: (x.to(torch.float32) * scale).to(x.dtype),
                    tree), norm
