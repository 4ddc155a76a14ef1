"""The trainer: gradient accumulation, clipping, checkpoint and restart,
per-step retry: the port's copy of the reference's ``train/trainer.py``,
on one device.

A family provides ``loss_fn(params, batch) -> (loss, metrics)`` over its
parameter tree (the reference's layout) and a schema.  The parameters and
the optimizer state are nested dicts of tensors on the trainer's device
(the CUDA device unless the caller asks for the CPU); a step computes the
gradients and their norm first and then updates the parameters and the
state in place, all or nothing (the optimizer computes every leaf's new
values before it writes any), so a step that fails anywhere is retried
from unchanged parameters.  Sharding the parameters and the optimizer
state over a mesh (the reference's ``schema_pspecs`` / ``opt_pspecs``)
and the EF-int8 data-parallel reduction belong to the parallelism slice
(ROADMAP.md).
"""
from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Callable

import torch

from repro_torch.device import resolve_device
from repro_torch.models.module import batch_to, init_params
from repro_torch.optim.api import Optimizer, OptimizerConfig, make_optimizer
from repro_torch.optim.clip import clip_by_global_norm
from repro_torch.optim.tree import tree_leaves, tree_map
from repro_torch.train import checkpoint as ckpt


def _default_ckpt_dir() -> str:
    return os.path.join(tempfile.gettempdir(), "repro_ckpt")


@dataclasses.dataclass
class TrainConfig:
    steps: int = 100
    microbatches: int = 1          # grad-accumulation factor
    log_every: int = 10
    ckpt_every: int = 0            # 0 = disabled
    ckpt_dir: str = dataclasses.field(default_factory=_default_ckpt_dir)
    ckpt_async: bool = True
    max_retries: int = 2           # per-step retry (transient-fault hook)
    seed: int = 0


def _grads_of(loss_fn, params, batch):
    """(gradient tree, detached metrics) of ``loss_fn`` at ``params``; the
    gradients of leaves the loss does not reach are zeros."""
    flat = tree_leaves(params)
    live = [p.detach().requires_grad_() for p in flat]
    it = iter(live)
    tree = tree_map(lambda _: next(it), params)
    with torch.enable_grad():
        loss, metrics = loss_fn(tree, batch)
        grads = torch.autograd.grad(loss, live, allow_unused=True)
    it = iter(torch.zeros_like(p) if g is None else g
              for p, g in zip(flat, grads))
    return (tree_map(lambda _: next(it), params),
            {k: v.detach() for k, v in metrics.items()})


def make_train_step(loss_fn: Callable, optimizer: Optimizer,
                    max_grad_norm: float = 1.0, microbatches: int = 1):
    """Returns step(params, opt_state, batch) -> (params, opt_state,
    metrics), updating params and opt_state in place.

    With microbatches > 1, each of ``batch``'s arrays has a leading
    [microbatches, ...] axis; the float32 gradients are summed as the
    reference's scan sums them (zeros + g_0, then + g_i in order) and
    multiplied by 1 / microbatches, the metrics likewise from m_0.  Then
    the global-norm clip and the optimizer's update.
    """

    def step(params, opt_state, batch):
        if microbatches > 1:
            part = lambda i: {k: v[i] for k, v in batch.items()}  # noqa: E731
            g0, metrics = _grads_of(loss_fn, params, part(0))
            grads = tree_map(lambda p, g: torch.zeros(
                p.shape, dtype=torch.float32, device=p.device) + g,
                params, g0)
            del g0
            for i in range(1, microbatches):
                g, m = _grads_of(loss_fn, params, part(i))
                tree_map(lambda acc, x: acc.add_(x), grads, g)
                metrics = {k: metrics[k] + m[k] for k in metrics}
                del g
            inv = 1.0 / microbatches
            grads = tree_map(lambda g: g.mul_(inv), grads)
            metrics = {k: v * inv for k, v in metrics.items()}
        else:
            grads, metrics = _grads_of(loss_fn, params, batch)
        grads, gnorm = clip_by_global_norm(grads, max_grad_norm)
        params, opt_state = optimizer.update(grads, opt_state, params)
        metrics = dict(metrics)
        metrics["grad_norm"] = gnorm
        return params, opt_state, metrics

    return step


class Trainer:
    """Trains ``schema``'s parameters on ``device`` (None: the CUDA
    device, or a ``RuntimeError``).  ``run`` draws batches (numpy arrays)
    from an iterator and moves each to the device."""

    def __init__(self, *, schema, loss_fn, opt_cfg: OptimizerConfig,
                 train_cfg: TrainConfig, device=None):
        self.schema = schema
        self.loss_fn = loss_fn
        self.device = resolve_device(device)
        self.opt = make_optimizer(opt_cfg)
        self.cfg = train_cfg
        self.opt_cfg = opt_cfg
        self._step_fn = None

    # ---- state ------------------------------------------------------------

    def init_state(self):
        """Parameters from ``init_params`` with a generator seeded with
        ``cfg.seed`` on the device, and the optimizer's zero state."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(self.cfg.seed)
        params = init_params(self.schema, gen, self.device)
        return {"params": params, "opt_state": self.opt.init(params)}

    # ---- step -------------------------------------------------------------

    def compiled_step(self):
        """The train step (eager; the reference jits it)."""
        if self._step_fn is None:
            self._step_fn = make_train_step(self.loss_fn, self.opt,
                                            self.opt_cfg.max_grad_norm,
                                            self.cfg.microbatches)
        return self._step_fn

    def run(self, data_iter, *, resume: bool = False, state=None,
            on_metrics: Callable | None = None):
        """``cfg.steps`` steps.  With ``resume`` and a checkpoint under
        ``cfg.ckpt_dir``, the state is restored from the latest one and
        the steps count on from its step (the reference counts from 0
        again): metrics at global steps ``step % log_every == 0``, a
        checkpoint after global step ``s`` when ``s % ckpt_every == 0``.
        A step raising ``RuntimeError`` (a CUDA fault, out of memory) is
        retried up to ``max_retries`` times.  Returns (state, [(step,
        {metric: float})])."""
        start = 0
        if state is None:
            state = self.init_state()
            if resume and ckpt.latest_step(self.cfg.ckpt_dir) is not None:
                state, start = ckpt.restore(self.cfg.ckpt_dir, state)
                print(f"[trainer] resumed from step {start}")
        step_fn = self.compiled_step()
        params, opt_state = state["params"], state["opt_state"]
        history, saving = [], None
        for i in range(start, start + self.cfg.steps):
            batch = batch_to(next(data_iter), self.device)
            for attempt in range(self.cfg.max_retries + 1):
                try:
                    params, opt_state, metrics = step_fn(params, opt_state,
                                                         batch)
                    break
                except RuntimeError:
                    if attempt == self.cfg.max_retries:
                        raise
                    print(f"[trainer] step {i} retry {attempt + 1}")
            if self.cfg.log_every and i % self.cfg.log_every == 0:
                host = {k: float(v) for k, v in metrics.items()}
                history.append((i, host))
                if on_metrics:
                    on_metrics(i, host)
            if self.cfg.ckpt_every and (i + 1) % self.cfg.ckpt_every == 0:
                if saving is not None:
                    saving.join()
                saving = ckpt.save({"params": params, "opt_state": opt_state},
                                   i + 1, self.cfg.ckpt_dir,
                                   async_save=self.cfg.ckpt_async)
        if saving is not None:
            saving.join()
        return {"params": params, "opt_state": opt_state}, history
