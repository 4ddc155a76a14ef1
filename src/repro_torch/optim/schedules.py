"""LR schedules as functions of the step count, in float32: the port's
copy of the reference's ``optim/schedules.py``, the same float32
operations in the same order."""
from __future__ import annotations

import math

import torch


def _f32(step) -> torch.Tensor:
    return torch.as_tensor(step).to(torch.float32)


def constant(step, **_):
    return torch.ones_like(_f32(step))


def warmup_cosine(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.1):
    s = _f32(step)
    warm = s / max(1.0, warmup_steps)
    prog = (s - warmup_steps) / max(1.0, total_steps - warmup_steps)
    prog = torch.clamp(prog, 0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup_steps, warm, cos)


def warmup_linear(step, *, warmup_steps: int, total_steps: int,
                  min_ratio: float = 0.0):
    s = _f32(step)
    warm = s / max(1.0, warmup_steps)
    prog = (s - warmup_steps) / max(1.0, total_steps - warmup_steps)
    lin = 1.0 - (1.0 - min_ratio) * torch.clamp(prog, 0.0, 1.0)
    return torch.where(s < warmup_steps, warm, lin)


SCHEDULES = {
    "constant": constant,
    "warmup_cosine": warmup_cosine,
    "warmup_linear": warmup_linear,
}
