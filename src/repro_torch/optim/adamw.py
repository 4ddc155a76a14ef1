"""AdamW over a tree of tensors: the port's copy of the reference's
``optim/adamw.py``, its float32 arithmetic in its order.

Not ``torch.optim.AdamW``: that rounds its bias correction differently
and decays every leaf.  Here a leaf is decayed when ``p.ndim >= 2``,
judged on the reference's layout, so a stacked norm scale [L, d] is
decayed.  The state mirrors the parameter tree (``m``, ``v`` in
``state_dtype``) with a step ``count`` (int32).  :func:`update` writes the
new parameters and moments into the tensors it is given (the reference
returns new trees; the serving model views the parameter tensors), all or
nothing: every leaf's new values are computed before any is written.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    state_dtype: torch.dtype = torch.float32  # bf16 halves the state


def init(cfg: AdamWConfig, params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=cfg.state_dtype, device=p.device)

    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state, params, lr_scale=1.0):
    """One step: returns (params, state), the same tensors updated, with
    ``state["count"]`` one more.  Every leaf's new parameter and moments
    are computed first, in their own dtypes (one more copy of the
    parameters and the state while the step runs), and only then copied
    into place, so an error part-way (out of memory) leaves ``params`` and
    ``state`` as they were."""
    count = state["count"] + 1
    c = count.to(torch.float32)
    bc1 = 1.0 - cfg.b1 ** c
    bc2 = 1.0 - cfg.b2 ** c
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=c.device)

    def new(p, g, m, v):
        g32 = g.to(torch.float32)
        m32 = cfg.b1 * m.to(torch.float32) + (1 - cfg.b1) * g32
        v32 = cfg.b2 * v.to(torch.float32) + (1 - cfg.b2) * g32 * g32
        step = (m32 / bc1) / (torch.sqrt(v32 / bc2) + cfg.eps)
        if p.ndim >= 2:   # decay matrices only, in the reference's layout
            step = step + cfg.weight_decay * p.to(torch.float32)
        return ((p.to(torch.float32) - lr * step).to(p.dtype),
                m32.to(m.dtype), v32.to(v.dtype))

    dst = list(zip(tree_leaves(params), tree_leaves(state["m"]),
                   tree_leaves(state["v"])))
    staged = [new(p, g, m, v)
              for (p, m, v), g in zip(dst, tree_leaves(grads))]
    for targets, values in zip(dst, staged):
        for t, x in zip(targets, values):
            t.copy_(x)
    state["count"] = count
    return params, state
