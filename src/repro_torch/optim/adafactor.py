"""Adafactor with factored second moments (Shazeer & Stern, 2018): the
port's copy of the reference's ``optim/adafactor.py``.

For the trillion-parameter config (kimi-k2): factored second moments are
O(rows + cols) and momentum is optional, kept in ``momentum_dtype``.  A
leaf of two or more axes is factored over its last two; the update clip
(``_rms(u)``) and the step size (``_rms(p)``) are taken over the whole
leaf, in the reference's stacked layout (a per-layer leaf would step
differently).  :func:`update` writes into the tensors it is given, all or
nothing, as :func:`repro_torch.optim.adamw.update` does.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.optim.tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdafactorConfig:
    lr: float = 1e-3
    decay: float = 0.8  # beta2 hat via step^-decay schedule
    eps1: float = 1e-30
    eps2: float = 1e-3
    clip_threshold: float = 1.0
    weight_decay: float = 0.0
    momentum: float = 0.0  # 0 disables the first-moment buffer entirely
    momentum_dtype: torch.dtype = torch.bfloat16


def _factored(shape) -> bool:
    return len(shape) >= 2


def init(cfg: AdafactorConfig, params):
    def leaf(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        st = {}
        if _factored(p.shape):
            st["vr"] = torch.zeros(p.shape[:-1], **f32)  # row stats
            st["vc"] = torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)
        else:
            st["v"] = torch.zeros(p.shape, **f32)
        if cfg.momentum > 0:
            st["m"] = torch.zeros(p.shape, dtype=cfg.momentum_dtype,
                                  device=p.device)
        return st

    device = tree_leaves(params)[0].device
    return {"slots": tree_map(leaf, params),
            "count": torch.zeros((), dtype=torch.int32, device=device)}


def _rms(x):
    return torch.sqrt(torch.mean(torch.square(x)) + 1e-30)


@torch.no_grad()
def update(cfg: AdafactorConfig, grads, state, params, lr_scale=1.0):
    """One step: returns (params, state), the same tensors updated, with
    ``state["count"]`` one more.  Every leaf's new values are computed
    before any is written, so an error part-way leaves ``params`` and
    ``state`` as they were."""
    count = state["count"] + 1
    c = count.to(torch.float32)
    beta2 = 1.0 - c ** (-cfg.decay)
    lr = cfg.lr * torch.as_tensor(lr_scale, dtype=torch.float32,
                                  device=c.device)

    def new(p, g, st):
        """([(target, value)], ...) for the leaf ``p`` and its slots."""
        out = []
        g32 = g.to(torch.float32)
        g2 = g32 * g32 + cfg.eps1
        if _factored(p.shape):
            vr = beta2 * st["vr"] + (1 - beta2) * torch.mean(g2, dim=-1)
            vc = beta2 * st["vc"] + (1 - beta2) * torch.mean(g2, dim=-2)
            out += [(st["vr"], vr), (st["vc"], vc)]
            r = vr / torch.mean(vr, dim=-1, keepdim=True)
            u = g32 / (torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :])
        else:
            v = beta2 * st["v"] + (1 - beta2) * g2
            out.append((st["v"], v))
            u = g32 / torch.sqrt(v)
        u = u / torch.clamp(_rms(u) / cfg.clip_threshold, min=1.0)
        if cfg.momentum > 0:
            m = cfg.momentum * st["m"].to(torch.float32) \
                + (1 - cfg.momentum) * u
            out.append((st["m"], m.to(st["m"].dtype)))
            u = m
        p32 = p.to(torch.float32)
        step_size = lr * torch.clamp(_rms(p32), min=cfg.eps2)
        new_p = p32 - step_size * u
        if cfg.weight_decay > 0 and p.ndim >= 2:
            new_p = new_p - lr * cfg.weight_decay * p32
        out.append((p, new_p.to(p.dtype)))
        return out

    staged = []
    tree_map(lambda p, g, st: staged.append(new(p, g, st)),
             params, grads, state["slots"])
    for out in staged:
        for t, x in out:
            t.copy_(x)
    state["count"] = count
    return params, state
