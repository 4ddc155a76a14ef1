"""Uniform optimizer facade used by the trainer: the port's copy of the
reference's ``optim/api.py``.  The schedule reads the step count before
the update, so step 0's scale is the schedule at 0 (0 under warmup), as
in the reference."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.optim import adafactor, adamw
from repro_torch.optim.schedules import SCHEDULES


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    name: str = "adamw"  # adamw | adafactor
    lr: float = 3e-4
    weight_decay: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    schedule: str = "warmup_cosine"
    warmup_steps: int = 100
    total_steps: int = 10_000
    max_grad_norm: float = 1.0
    state_dtype: str = "float32"  # bfloat16 halves AdamW's state
    momentum: float = 0.9  # adafactor only


class Optimizer:
    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg
        sd = torch.bfloat16 if cfg.state_dtype == "bfloat16" \
            else torch.float32
        if cfg.name == "adamw":
            self.impl = adamw
            self.icfg: Any = adamw.AdamWConfig(
                lr=cfg.lr, b1=cfg.b1, b2=cfg.b2,
                weight_decay=cfg.weight_decay, state_dtype=sd)
        elif cfg.name == "adafactor":
            self.impl = adafactor
            self.icfg = adafactor.AdafactorConfig(
                lr=cfg.lr, weight_decay=cfg.weight_decay,
                momentum=cfg.momentum)
        else:
            raise ValueError(f"unknown optimizer {cfg.name}")
        self._sched = SCHEDULES[cfg.schedule]

    def init(self, params):
        return self.impl.init(self.icfg, params)

    def lr_scale(self, step):
        kw = {}
        if self.cfg.schedule != "constant":
            kw = dict(warmup_steps=self.cfg.warmup_steps,
                      total_steps=self.cfg.total_steps)
        return self._sched(step, **kw)

    def update(self, grads, state, params):
        """One step in place (see :func:`adamw.update`)."""
        scale = self.lr_scale(state["count"])
        return self.impl.update(self.icfg, grads, state, params,
                                lr_scale=scale)


def make_optimizer(cfg: OptimizerConfig) -> Optimizer:
    return Optimizer(cfg)
